"""The open-loop rate sweep that fixes a rate cell's ``rate_per_s``: the
cell's traffic at each rate, one run each in one process.

    python3 benchmark/sweep.py --workload <name> --rates 4,8,12 [--seconds 30] [--seed 1]

Prints per rate the run's notes (requests, queue at the window's end,
time to first token) and its end-to-end metrics.  The knee is the highest
rate whose queue does not grow through the window.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import harness  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args()
    spec = harness.cell(harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json")), args.workload)
    for rate in (float(r) for r in args.rates.split(",")):
        t = time.perf_counter()
        run_spec = dict(spec, t=dict(spec["t"], rate_per_s=rate))
        result, notes = harness.run(args.workload, args.seed, args.seconds, False, "cuda", t, spec=run_spec)
        print(json.dumps({"rate_per_s": rate, "notes": notes, **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
