"""The port's ``MetricsLogger`` against the reference's
(``spatialrgpt_tpu/train/trainer.py::MetricsLogger``) for every
``report_to``: the same ``metrics.jsonl`` records (apart from ``time``),
and with a stub ``wandb`` module in ``sys.modules`` the same ``init`` and
``log`` calls; a ``wandb`` that does not import, or whose ``init`` raises,
leaves ``metrics.jsonl`` alone.  The port logs on rank 0 only."""

import json
import os
import sys
import types

import pytest

from spatialrgpt_tpu.train import trainer as jtrainer
from spatialrgpt_tpu_torch.train import trainer as ttrainer

RECORDS = [(1, {"loss": 2.5, "grad_norm": 0.75}), (2, {"loss": 2.25, "grad_norm": 0.5, "lr": 1e-4})]


def _stub_wandb(init_raises=False):
    """A ``wandb`` module that records its calls (``time`` dropped from
    the logged records, which differ by the clock)."""
    calls = []
    mod = types.ModuleType("wandb")

    def init(**kw):
        calls.append(("init", kw))
        if init_raises:
            raise RuntimeError("no wandb service")

    def log(rec, step=None):
        calls.append(("log", {k: v for k, v in rec.items() if k != "time"}, step))

    mod.init, mod.log = init, log
    return mod, calls


def _run(module, report_to, out):
    logger = module.MetricsLogger(module.TrainerConfig(output_dir=str(out), report_to=report_to))
    for step, metrics in RECORDS:
        logger.log(step, metrics)
    logger.close()
    path = os.path.join(out, "metrics.jsonl")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]


@pytest.mark.parametrize("report_to", ["jsonl", "wandb", "none"])
def test_logger_without_wandb_matches_reference(tmp_path, monkeypatch, report_to):
    monkeypatch.setitem(sys.modules, "wandb", None)  # ``import wandb`` raises ImportError
    want = _run(jtrainer, report_to, tmp_path / "jax")
    got = _run(ttrainer, report_to, tmp_path / "port")
    assert got == want
    assert (got is None) == (report_to == "none")
    if got is not None:
        assert got == [{"step": s, **m} for s, m in RECORDS]


@pytest.mark.parametrize("report_to", ["jsonl", "wandb", "none"])
def test_logger_with_wandb_stub_matches_reference(tmp_path, monkeypatch, report_to):
    monkeypatch.delenv("WANDB_PROJECT", raising=False)
    seen = {}
    for name, module in (("jax", jtrainer), ("port", ttrainer)):
        stub, calls = _stub_wandb()
        monkeypatch.setitem(sys.modules, "wandb", stub)
        seen[name] = (_run(module, report_to, tmp_path / name), calls)
    assert seen["port"] == seen["jax"]
    records, calls = seen["port"]
    if report_to == "wandb":
        assert calls[0] == ("init", {"project": "SpatialRGPT", "resume": "allow"})
        assert calls[1:] == [("log", {"step": s, **m}, s) for s, m in RECORDS]
        assert records == [{"step": s, **m} for s, m in RECORDS]
    else:
        assert calls == []


def test_logger_wandb_project_from_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("WANDB_PROJECT", "spatial-probe")
    stub, calls = _stub_wandb()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    _run(ttrainer, "wandb", tmp_path)
    assert calls[0] == ("init", {"project": "spatial-probe", "resume": "allow"})


def test_logger_wandb_init_raising_leaves_jsonl(tmp_path, monkeypatch):
    seen = {}
    for name, module in (("jax", jtrainer), ("port", ttrainer)):
        stub, calls = _stub_wandb(init_raises=True)
        monkeypatch.setitem(sys.modules, "wandb", stub)
        seen[name] = (_run(module, "wandb", tmp_path / name), calls)
    assert seen["port"] == seen["jax"]
    records, calls = seen["port"]
    assert [c[0] for c in calls] == ["init"]  # no log after a failed init
    assert records == [{"step": s, **m} for s, m in RECORDS]


@pytest.mark.parametrize("report_to", ["jsonl", "wandb"])
def test_logger_off_rank0_writes_and_calls_nothing(tmp_path, monkeypatch, report_to):
    stub, calls = _stub_wandb()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    monkeypatch.setattr(ttrainer, "_rank0", lambda: False)
    assert _run(ttrainer, report_to, tmp_path) is None
    assert calls == []
