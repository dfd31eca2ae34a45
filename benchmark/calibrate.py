"""Readings for setting a cell's limits: the program's and the control's
on many seeds in one process (the weights made anew from each seed).

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 [--seconds 5] [--control 1] [--faults 1]

Prints one JSON line per seed: the run's result, with the compared
readings of the program against the plain reference; with ``--control 1``
also ``control``, the readings of the reference computed in the
configuration's ``control_precision`` (the nearest precision below the
stated one) in the program's place, on what the run's check compared;
with ``--faults 1`` also ``faults``, those of the reference with a train
cell's fault planted (half of each batch left out).  The benchmark's own
runs never run these.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import checks  # noqa: E402
import harness  # noqa: E402
import seeded  # noqa: E402
from train_cell import free  # noqa: E402


def control_readings(ctx: dict, precision: str) -> dict:
    """The readings of the reference in ``precision`` against the
    reference, on the inputs of the run ``ctx``'s check."""
    from reference import serve as ref_serve
    from reference import train as ref_train

    c, dev, chk = ctx["c"], ctx["device"], ctx["check"]
    W = seeded.make_weights(c, ctx["seed"], dev, trained_dtype=chk.get("trained_dtype", torch.bfloat16))
    if "requests" in chk:
        got = checks.served_readings(ref_serve.gaps(c, W, chk["requests"], control=precision)["control"])
    else:
        got = checks.train_readings(
            ref_train.follow(c, W, chk["trained"], chk["batches"], ctx["t"]["step"], lowp=precision), chk["ref"])
    del W
    free(dev)
    return got


def fault_readings(ctx: dict) -> dict:
    """A train cell's readings with half of each checked batch left out of
    the reference put in the program's place."""
    from reference import train as ref_train

    c, dev, chk = ctx["c"], ctx["device"], ctx["check"]
    W = seeded.make_weights(c, ctx["seed"], dev, trained_dtype=chk["trained_dtype"])
    half = [dict(b, samples=b["samples"][: len(b["samples"]) // 2]) for b in chk["batches"]]
    got = {"half_batch": checks.train_readings(ref_train.follow(c, W, chk["trained"], half, ctx["t"]["step"]),
                                               chk["ref"])}
    del W
    free(dev)
    return got


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", type=int, default=1)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--faults", type=int, default=0, help="also the faults planted in the reference (train cells)")
    args = p.parse_args()
    spec = harness.cell(harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json")), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        ctx = harness.drive(args.workload, seed, args.seconds, bool(args.trace), "cuda", t, spec)
        result, notes = harness.report(ctx)
        extra = {}
        if args.control:
            extra["control"] = control_readings(ctx, spec["c"]["control_precision"])
        if args.faults:
            extra["faults"] = fault_readings(ctx)
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t, "notes": notes, **result, **extra}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
