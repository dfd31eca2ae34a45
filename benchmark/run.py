"""Run one cell of the benchmark of the PyTorch + CUDA port once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix, limits and metrics are found by
name from ``BENCHMARK.json`` (``harness.py``).  The run builds or loads the
port's kernels (``build/kernels/`` in the checkout), makes the weights on
the card from the seed, warms the cell's shapes up, measures for
``--seconds``, checks what the window produced against the plain
reference, and prints one JSON line as the last line of standard output.
With ``--trace 0`` it reports the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from a profiled slice of the window.

It exits with a code other than 0, printing no result, where there is no
CUDA device, or where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "spatialrgpt_tpu"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # a library the port may pull in must not load JAX; every cache lives in the checkout; one
    # host thread for CPU tensor work (the cells' host side is one Python thread launching kernels)
    os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    import torch

    torch.set_num_threads(1)
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    sys.path[:0] = [HERE, ROOT]
    import harness

    result, notes = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                                bench=bench)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}: the port's benchmark may not load JAX or the JAX package",
              file=sys.stderr)
        return 4
    for line in notes + harness.report_lines(result):
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
