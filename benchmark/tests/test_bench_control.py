"""The control of each cell: the plain reference computed in the nearest
precision below the configuration's (``control_precision``) put in the
program's place must come out not correct, at the cell's own size, on
three seeds.  Needs the card: run it there with

    python3 -m pytest -p no:cacheprovider benchmark/tests/test_bench_control.py -m gpu
"""

import json
import os

import pytest
import torch

import calibrate
import harness
from conftest import ROOT


def workloads():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", workloads())
def test_the_control_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's own size on a CUDA card")
    spec = harness.cell(harness.load_json(os.path.join(ROOT, "BENCHMARK.json")), workload)
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        ctx = harness.drive(workload, seed, 5.0, False, "cuda", 0.0, spec)
        readings = calibrate.control_readings(ctx, spec["c"]["control_precision"])
        control = harness.judge(readings, spec["limits"])
        print(workload, seed, readings, flush=True)
        assert not all(c["ok"] for c in control.values()), (seed, readings, spec["limits"])
