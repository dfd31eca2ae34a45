"""Time K8 (``w8a8_gemm``) and K9 (``w8_gemm``) of the PyTorch port on one card.

    python3 scripts/bench_qgemm.py [--out FILE]

Rows (one JSON object each, also written to FILE when given):

- ``large``: K8's large form at the prefill's gate and SigLIP's fc1,
  beside ``torch._int_mm``'s int32 product alone;
- ``boundary``: K8's decode form (64-row tiles) against the large form at
  64, 96 and 128 rows on the decode's q / o, gate and lm_head shapes, the
  rows where the two forms meet;
- ``decode``: K8 and K9 at the decode's shapes at 8 and 64 rows, beside
  ``torch._int_mm`` and ``F.linear`` on a bf16 copy of the weight, timed
  twice: on one weight (``*_ms``: it stays in the 50 MB L2 when it fits, as
  in chip_smoke.py's rows) and cycling through copies of the weight that
  together exceed 100 MB (``*_cold_ms``: each call reads its weight from
  device memory, as a decode step does);
- ``k9_large``: K9's large form at training and admission rows (QLoRA's
  gate with the LoRA branch's f32 addend, its down and k / v with and
  without it, an lm_head chunk; an engine admission's down), beside
  ``F.linear`` on a bf16 copy of the weight made beforehand (no addend),
  and the decode form at QLoRA's gate;
- ``k9_boundary``: K9's decode form against its large form on the
  decode's k / v, q / o, gate, down and lm_head shapes at 64-384 rows, and
  on k / v and down up to 1536 rows; per row count, the K9 calls of one
  decoder layer as the callers between 385 and 2047 rows send them (the
  engine's W8A8 admissions: k, v and down, since q, o, gate and up take
  W8A8 at any row count) on each form: the rows where the forms meet
  (``W8_DECODE_MAX_M``);
- ``k11``: K11 (both launches) at the align step's gate / up and down dx and
  at an lm_head chunk's dx, its transpose alone, and ``torch._int_mm``'s
  int32 product on a column-major copy of q made beforehand;
- ``floor``: K8, K9 and ``F.linear`` at the k / v width (1024 x K, 64
  rows) as K grows from one 128-wide k tile: the time of a call that moves
  almost nothing is its fixed cost (launch, pipeline fill, the cluster's
  sum, the epilogue);
- ``host``: host microseconds per wrapper call (the enqueue: checks, the
  tensor maps, the launch) at the decode's k / v and q shapes, over 2000
  calls.  ``--tree DIR`` imports the port from another checkout (to compare
  the wrappers of two trees).

Device times: CUDA events around a CUDA graph of many calls (calls under a
millisecond) or around back-to-back calls, the median of 3.  Weights and
activations are random from a fixed seed, made on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLD_BYTES = 100 * 2**20  # twice the H100's 50 MB L2


def graph_ms(torch, fn, iters: int) -> float:
    """``fn(i)`` for i = 0 .. iters - 1 captured in one CUDA graph."""
    fn(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    runs = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(runs)


def event_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return statistics.median(runs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--phases", default="large,boundary,k9_large,k9_boundary,k11,decode,floor,host",
                    help="comma-separated phases to run")
    ap.add_argument("--tree", default=ROOT, help="the checkout whose port is timed")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from spatialrgpt_tpu_torch.ops import int8_linear as K
    from spatialrgpt_tpu_torch.ops._checks import bf16_err_over_bound

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    rows = [{"card": card}]

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)

    def case(M, N, Kd):
        return i8(M, Kd), torch.rand(M, generator=g, device=dev) * 0.05 + 1e-3, i8(N, Kd), \
            torch.full((N,), Kd**-0.5 * 3 / 127, device=dev)

    def k8(a, decode_max_m):
        def call(i=0):
            saved = K.DECODE_MAX_M
            K.DECODE_MAX_M = decode_max_m
            try:
                return K.w8a8_gemm(*a)
            finally:
                K.DECODE_MAX_M = saved
        return call

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for label, M, N, Kd in (("prefill gate", 20480, 14336, 4096), ("siglip fc1", 93312, 4304, 1152)):
        if "large" not in phases:
            break
        a = case(M, N, Kd)
        ref = K.w8a8_gemm_plain(*a)
        fn = k8(a, 64)
        qt = a[2].t()
        emit({"phase": "large", "shape": label, "M": M, "N": N, "K": Kd, "bound_ms": 2 * M * N * Kd / 1979e12 * 1e3,
              "bit_equal": bool(torch.equal(fn(), ref)), "ms": event_ms(torch, fn, 10),
              "int_mm_ms": event_ms(torch, lambda: torch._int_mm(a[0], qt), 10)})
        del ref, a, qt
        torch.cuda.empty_cache()

    for label, N, Kd in (("q / o", 4096, 4096), ("gate", 14336, 4096), ("lm_head", 128264, 4096)):
        for M in (64, 96, 128) if "boundary" in phases else ():
            a = case(M, N, Kd)
            ref = K.w8a8_gemm_plain(*a)
            row = {"phase": "boundary", "shape": label, "M": M, "N": N, "K": Kd,
                   "bound_ms": max(2 * M * N * Kd / 1979e12, (N * Kd + M * Kd + 2 * M * N) / 3.35e12) * 1e3}
            for name, decode_max_m in (("decode", 1 << 30), ("large", 0)):
                fn = k8(a, decode_max_m)
                row[f"bit_equal_{name}"] = bool(torch.equal(fn(), ref))
                row[f"ms_{name}"] = graph_ms(torch, fn, 20 if N > 100000 else 100)
            emit(row)

    def k9(x, q, s, add=None, decode_max_m=None):
        def call(i=0):
            saved = K.W8_DECODE_MAX_M
            if decode_max_m is not None:
                K.W8_DECODE_MAX_M = decode_max_m
            try:
                return K.w8_gemm(x, q, s, add=add)
            finally:
                K.W8_DECODE_MAX_M = saved
        return call

    def bf16_bound(M, N, Kd, extra_bytes=0):
        return max(2 * M * N * Kd / 989e12, (N * Kd + 2 * M * Kd + 2 * M * N + extra_bytes) / 3.35e12) * 1e3

    for label, M, N, Kd, with_add in (("qlora gate + LoRA addend", 16384, 14336, 4096, True),
                                      ("qlora down", 16384, 4096, 14336, False),
                                      ("qlora down + LoRA addend", 16384, 4096, 14336, True),
                                      ("qlora k / v", 16384, 1024, 4096, False),
                                      ("qlora k / v + LoRA addend", 16384, 1024, 4096, True),
                                      ("qlora lm_head chunk", 4096, 128264, 4096, False),
                                      ("engine admission down (4 x 384 rows)", 1536, 4096, 14336, False)):
        if "k9_large" not in phases:
            break
        x = torch.randn(M, Kd, generator=g, device=dev).to(torch.bfloat16)
        q = i8(N, Kd)
        s = torch.full((N,), Kd**-0.5 * 3 / 127, device=dev)
        add = torch.randn(M, N, generator=g, device=dev) * 0.25 if with_add else None
        w = q.to(torch.bfloat16) * s.to(torch.bfloat16)[:, None]
        fn = k9(x, q, s, add, 0)
        rows_ref = slice(0, min(M, 2048))  # the plain f32 product over the first rows
        ref = K.w8_gemm_plain(x[rows_ref], q, s, add=None if add is None else add[rows_ref])
        iters = 10 if M * N * Kd > 1e11 else 50
        row = {"phase": "k9_large", "shape": label, "M": M, "N": N, "K": Kd, "f32_addend": with_add,
               "bound_ms": bf16_bound(M, N, Kd, 0 if add is None else 4 * M * N),
               "err_over_bf16_bound": bf16_err_over_bound(fn()[rows_ref], ref),
               "ms": event_ms(torch, fn, iters), "f_linear_ms": event_ms(torch, lambda: F.linear(x, w), iters)}
        if label.startswith("qlora gate"):
            row["decode_form_ms"] = event_ms(torch, k9(x, q, s, add, 1 << 30), 3)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["f_linear_over_kernel"] = row["f_linear_ms"] / row["ms"]
        emit(row)
        del x, q, w, add, ref
        torch.cuda.empty_cache()

    k9_shapes = (("k / v", 1024, 4096), ("q / o", 4096, 4096), ("gate", 14336, 4096), ("down", 4096, 14336),
                 ("lm_head", 128264, 4096))
    # a W8A8 decoder layer's K9 calls below A8_MIN_ROWS: k, v and down (the
    # weight-only route, all seven projections, runs only at QLoRA's rows)
    per_layer = {"k / v": 2, "down": 1}
    for M in (64, 96, 128, 192, 256, 384, 448, 512, 576, 640, 704, 768, 1024, 1536) if "k9_boundary" in phases else ():
        layer = {"decode": 0.0, "large": 0.0}
        for label, N, Kd in k9_shapes:
            if M > 384 and label not in per_layer:
                continue
            x = torch.randn(M, Kd, generator=g, device=dev).to(torch.bfloat16)
            q = i8(N, Kd)
            s = torch.full((N,), Kd**-0.5 * 3 / 127, device=dev)
            ref = K.w8_gemm_plain(x, q, s)
            row = {"phase": "k9_boundary", "shape": label, "M": M, "N": N, "K": Kd, "bound_ms": bf16_bound(M, N, Kd)}
            for name, decode_max_m in (("decode", 1 << 30), ("large", 0)):
                fn = k9(x, q, s, None, decode_max_m)
                row[f"err_over_bf16_bound_{name}"] = bf16_err_over_bound(fn(), ref)
                row[f"ms_{name}"] = graph_ms(torch, fn, 20 if N > 100000 else 100)
                layer[name] += per_layer.get(label, 0) * row[f"ms_{name}"]
            emit(row)
            del x, q, ref
        emit({"phase": "k9_boundary", "shape": "one W8A8 decoder layer's K9 calls (k, v, down)", "M": M,
              "ms_decode": layer["decode"], "ms_large": layer["large"]})
        torch.cuda.empty_cache()

    for label, M, N, Kd in (("gate / up dx", 16384, 14336, 4096), ("down dx", 16384, 4096, 14336),
                            ("lm_head chunk dx", 1024, 128264, 4096)):
        if "k11" not in phases:
            break
        dyq, q = i8(M, N), i8(N, Kd)
        gs = torch.rand(M, generator=g, device=dev) * 1e-4 + 1e-6
        q_cm = q.t().contiguous().t()  # column-major copy, made outside the timing
        first = slice(0, 1024)  # the plain product over the first rows
        ref = K.int8_dx_gemm_plain(dyq[first], q, gs[first])
        emit({"phase": "k11", "shape": label, "M": M, "N": N, "K": Kd,
              "bound_ms": max(2 * M * N * Kd / 1979e12, (M * N + N * Kd + 4 * M + 2 * M * Kd) / 3.35e12) * 1e3,
              "transpose_bound_ms": (N * Kd + Kd * -(-N // 16) * 16) / 3.35e12 * 1e3,
              "bit_equal": bool(torch.equal(K.int8_dx_gemm(dyq, q, gs)[first], ref)),
              "ms": event_ms(torch, lambda: K.int8_dx_gemm(dyq, q, gs), 10),
              "transpose_ms": event_ms(torch, lambda: K.int8_transpose(q), 20),
              "int_mm_column_major_ms": event_ms(torch, lambda: torch._int_mm(dyq, q_cm), 10)})
        del dyq, q, q_cm, ref
        torch.cuda.empty_cache()

    for label, N, Kd in (("down", 4096, 14336), ("k / v", 1024, 4096), ("gate", 14336, 4096), ("q / o", 4096, 4096)):
        for M in (8, 64) if "decode" in phases else ():
            copies = -(-COLD_BYTES // (N * Kd))
            xq, ascale, _, _ = case(M, N, Kd)
            x = torch.randn(M, Kd, generator=g, device=dev).to(torch.bfloat16)
            qs = [i8(N, Kd) for _ in range(copies)]
            ws = [q.to(torch.bfloat16) for q in qs]
            s = torch.full((N,), Kd**-0.5 * 3 / 127, device=dev)
            calls = {
                "k8": lambda i: K.w8a8_gemm(xq, ascale, qs[i % copies], s),
                "int_mm": (lambda i: torch._int_mm(xq, qs[i % copies].t())) if M > 16 else None,
                "k9": lambda i: K.w8_gemm(x, qs[i % copies], s),
                "f_linear": lambda i: F.linear(x, ws[i % copies]),
            }
            row = {"phase": "decode", "shape": label, "M": M, "N": N, "K": Kd, "weight_copies_cold": copies,
                   "bound_ms": (N * Kd + M * Kd + 2 * M * N) / 3.35e12 * 1e3}
            for name, fn in calls.items():
                if fn is None:
                    continue
                row[f"{name}_ms"] = graph_ms(torch, lambda i, fn=fn: fn(0), 100)
                row[f"{name}_cold_ms"] = graph_ms(torch, fn, max(100, 4 * copies))
            emit(row)
            del qs, ws
            torch.cuda.empty_cache()

    for Kd in (128, 512, 1024, 2048, 4096) if "floor" in phases else ():
        M, N = 64, 1024
        xq, ascale, q, s = case(M, N, Kd)
        x = torch.randn(M, Kd, generator=g, device=dev).to(torch.bfloat16)
        w = q.to(torch.bfloat16)
        emit({"phase": "floor", "M": M, "N": N, "K": Kd,
              "k8_ms": graph_ms(torch, lambda i: K.w8a8_gemm(xq, ascale, q, s), 100),
              "k9_ms": graph_ms(torch, lambda i: K.w8_gemm(x, q, s), 100),
              "f_linear_ms": graph_ms(torch, lambda i: F.linear(x, w), 100)})

    # host cost of one call at the decode's k / v (K9) and q (K8) shapes
    x = torch.randn(64, 4096, generator=g, device=dev).to(torch.bfloat16)
    q9, s9 = i8(1024, 4096), torch.full((1024,), 0.001, device=dev)
    a8 = case(64, 4096, 4096)
    for name, fn in (("w8_gemm k/v", lambda: K.w8_gemm(x, q9, s9)), ("w8a8_gemm q", lambda: K.w8a8_gemm(*a8))):
        if "host" not in phases:
            break
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        host = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
        emit({"phase": "host", "call": name, "tree": os.path.abspath(args.tree), "host_us_per_call": host})

    if args.out:
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
