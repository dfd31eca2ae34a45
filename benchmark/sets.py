"""Sets of runs of one cell, for setting its end-to-end bounds: each run a
process of its own (``run.py``), the same seeds in every set, then the
traced runs; per metric each set's spread, the mean of the sets' spreads
with each set's farthest run left out, the spread of all runs, each set's
median, and five times the widest spread (at least 1%).

    python3 benchmark/sets.py --workload <name> --seeds 11,12,13,14,15,16 [--sets 2] [--seconds 40]
        [--trace-seeds 21,22,23] [--out chiprun_out/sets]

Each run's standard output and error go to ``<out>/<workload>.<set>.<seed>.out`` / ``.err``,
its last line with the set, seed, exit code and wall to ``<out>/<workload>.jsonl``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import window

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def one(workload: str, seed: int, seconds: float, trace: int, out: str, tag: str) -> dict:
    cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t = time.perf_counter()
    try:  # a run may take 1200 s where it builds the kernels
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=1200)
        rc, stdout, stderr = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:  # the child is killed; keep what it printed
        rc = 124
        stdout, stderr = (x.decode() if isinstance(x, bytes) else (x or "") for x in (e.stdout, e.stderr))
    base = os.path.join(out, f"{workload}.{tag}.{seed}")
    for ext, text in (("out", stdout), ("err", stderr)):
        with open(f"{base}.{ext}", "w") as f:
            f.write(text)
    lines = stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if rc == 0 and lines else {}
    except ValueError:
        result = {}
    return {"set": tag, "seed": seed, "rc": rc, "wall": round(time.perf_counter() - t, 1), **result}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, default=None, help="default: BENCHMARK.json's run_seconds")
    p.add_argument("--trace-seeds", default="")
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "sets"))
    args = p.parse_args()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    os.makedirs(args.out, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = []
    with open(os.path.join(args.out, args.workload + ".jsonl"), "a") as log:
        plan = [(chr(ord("A") + k), s, 0) for k in range(args.sets) for s in seeds]
        plan += [("T", int(s), 1) for s in args.trace_seeds.split(",") if s]
        for tag, seed, trace in plan:
            runs.append(one(args.workload, seed, seconds, trace, args.out, tag))
            log.write(json.dumps(runs[-1]) + "\n")
            log.flush()
            r = runs[-1]
            print(tag, seed, r["rc"], r["wall"], r.get("correct"),
                  {k: v["value"] for k, v in r.get("metrics", {}).items()},
                  {k: v["value"] for k, v in r.get("checks", {}).items()},
                  r.get("device", {}).get("memory_peak_bytes"), flush=True)
    sets = sorted({r["set"] for r in runs} - {"T"})
    names = sorted({m for r in runs if r["set"] != "T" for m in r.get("metrics", {})})
    for m in names:
        by = {s: [r["metrics"][m]["value"] for r in runs if r["set"] == s and m in r.get("metrics", {})]
              for s in sets}
        if any(len(v) < 3 for v in by.values()):
            continue
        each = {s: window.quartile_spread(v) for s, v in by.items()}
        trimmed = statistics.mean(window.spread_without_farthest(v) for v in by.values())
        every = window.quartile_spread([x for v in by.values() for x in v])
        print(f"{m}: spreads {each}, without each set's farthest {trimmed:.4f}, all runs {every:.4f}, "
              f"medians { {s: statistics.median(v) for s, v in by.items()} }, "
              f"five times the widest {max(0.01, 5 * max(max(each.values()), every)):.4f}", flush=True)
    return 0 if all(r["rc"] == 0 and r.get("correct") for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
