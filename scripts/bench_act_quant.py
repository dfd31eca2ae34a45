"""Time K7 (``act_quant_int8``) and K10 (``act_quant_dy_int8``) of the PyTorch port on one card.

    python3 scripts/bench_act_quant.py [--out FILE]

Rows (one JSON object each, also written to FILE when given):

- ``build``: registers, spilled bytes and static shared memory of each
  instantiation of ``csrc/act_quant.cu`` (ptxas -v);
- ``shape``: at each shape the paths give K7 and K10 (the W8A8 decode's 64
  and the engine's 32 rows, the prefill's 20,480 rows at 4096 and 14,336,
  SigLIP's 93,312 rows at 1152 and 4304, the align step's dy at 14,336,
  4096 and Mixtral's router's 8, Gemma-7B's 2560 prefill rows at
  24,576): the form ``act_quant_form`` picks, its
  time, the loop form's, the rows form's where a CTA holds the row, and
  ring-form launches of 1-16 warps a row, 1-8 rows a CTA and 2-3 stages,
  each held bit-equal to the plain version first; beside them the bound
  (bytes: each input read once, each output written once, at 3.35 TB/s)
  and an empty kernel's time; K7 at 4096 also at 128-2560 rows, where the
  rows form gives way;
- ``split``: K7's split form at a tp = 4 rank's prefill down slice (20,480
  x 3584) and decode wo slice (64 x 1024): the pair, pass 1 alone, pass 2
  alone, the loop form's pair, and the pair over chunks of rows (pass 1, a
  maximum with the other slices' row maxima standing in for the all-reduce
  MAX, pass 2, a chunk at a time) at chunks that fill 1/2, 1/4 and 1/8 of
  the 50 MB L2 (at tp > 1 each chunk would add an all-reduce of its rows'
  maxima).

Device times: CUDA events around a CUDA graph of many calls (calls that
move under 64 MB, and every split row: its chunks' launches outrun the
host) or around back-to-back calls, the median of 3.  Inputs are
random from a fixed seed, made on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_BYTES_S = 3.35e12  # the H100 SXM's memory rate (NVIDIA's data sheet)
L2_BYTES = 50 * 2**20  # the H100's L2
SHAPES = [  # (label, rows, width, K10's column scale)
    ("K7 decode (serve_w8a8)", 64, 4096, False),
    ("K7 decode (engine slots)", 32, 4096, False),
    ("K7 prefill q / wo / gate", 20480, 4096, False),
    ("K7 prefill down", 20480, 14336, False),
    ("K7 tower q / o / fc1", 93312, 1152, False),
    ("K7 tower fc2", 93312, 4304, False),
    ("K7 gemma-7b prefill down", 2560, 24576, False),
    ("K10 gate / up dy", 16384, 14336, True),
    ("K10 q / wo / down dy", 16384, 4096, True),
    ("K10 mixtral router dy", 16384, 8, True),
] + [(f"K7 rows at 4096 ({m})", m, 4096, False) for m in (128, 256, 512, 1024, 2560)]
SPLIT = [("tp=4 prefill down slice", 20480, 3584), ("tp=4 decode wo slice", 64, 1024)]


def emit(out, obj):
    line = json.dumps(obj)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def timed(torch, fn, small: bool, iters: int) -> float:
    """ms per call: a CUDA graph of ``iters`` calls replayed (``small``) or
    ``iters`` back-to-back calls, CUDA events around it, median of 3."""
    fn()
    torch.cuda.synchronize()
    graph = None
    if small:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
    runs = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        if graph is not None:
            graph.replay()
        else:
            for _ in range(iters):
                fn()
        b.record()
        torch.cuda.synchronize()
        runs.append(a.elapsed_time(b) / iters)
    return statistics.median(runs)


def other_forms(K789, K: int, dy: bool):
    """Rows-form launches of every vector count a thread that one CTA holds,
    and ring-form launches of 1-16 warps a row group and 2-3 stages that
    fit shared memory."""
    vecs = K // 8
    for vpt in K789.AQ_VPT:
        threads = -(-vecs // (32 * vpt)) * 32
        if 32 <= threads <= K789.AQ_ROW_THREADS:
            yield (K789.AQ_ROWS, 1, threads, vpt)
    for warps in (1, 2, 4, 8, 16):
        for groups in (1, 2, 4, 8):
            for stages in (2, 3):
                if 32 * warps * groups <= K789.AQ_RING_THREADS and K789._ring_smem(K, groups, stages) <= K789.AQ_SMEM:
                    yield (K789.AQ_RING, warps, groups, stages)


def ptxas_rows(log: str):
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and name and "act_quant" in name:
            yield {"kernel": name, "registers": int(m.group(1)), "smem_bytes": int(m.group(2))}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name and "act_quant" in name:
            yield {"kernel": name, "spill_store_bytes": int(m.group(1)), "spill_load_bytes": int(m.group(2))}


def bench(args):
    import torch

    sys.path.insert(0, ROOT)
    from spatialrgpt_tpu_torch.ops import _build
    from spatialrgpt_tpu_torch.ops import int8_linear as K789

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit(args.out, {"row": "device", "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    _build.lib()
    log = open(os.path.join(os.path.dirname(_build.build_info["path"]), "build.log")).read()
    for r in ptxas_rows(log):
        emit(args.out, {"row": "build", **r})
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    empty = lambda x: _build.check(_build.lib().srgpt_empty_kernel(_build.stream_ptr(x)), "empty")  # noqa: E731
    loop = K789.AQ_LOOP_FORM

    for label, M, K, dy in SHAPES:
        x = (torch.randn(M, K, generator=g, device=dev) * (1e-3 if dy else 1.0)).to(torch.bfloat16)
        scale = torch.full((K,), 4096**-0.5 * 3.0 / 127.0, device=dev) if dy else None
        ref_q, ref_s = K789.act_quant_dy_int8_plain(x, scale) if dy else K789.act_quant_int8_plain(x)
        xq = torch.empty((M, K789._pad16(K)), dtype=torch.int8, device=dev)
        s = torch.empty(M, device=dev)
        small = 3 * M * K < 64 * 2**20
        iters = 200 if small else 20
        picked = K789.act_quant_form(M, K, dy)
        forms = [picked] + [f for f in [loop, *other_forms(K789, K, dy)] if f != picked]
        times = {}
        for form in forms:
            K789.act_quant_launch(x, scale, xq, s, form=form)
            torch.cuda.synchronize()
            if not (torch.equal(xq[:, :K], ref_q) and torch.equal(s, ref_s)):
                raise SystemExit(f"{label}: form {form} is not bit-equal to the plain version")
            times[str(form)] = timed(torch, lambda f=form: K789.act_quant_launch(x, scale, xq, s, form=f), small, iters)
        nbytes = 3 * M * K + 4 * M + (4 * K if dy else 0)
        emit(args.out, {
            "row": "shape", "label": label, "M": M, "K": K, "picked": picked, "picked_ms": times[str(picked)],
            "loop_ms": times[str(loop)], "bound_ms": nbytes / PEAK_BYTES_S * 1e3,
            "share_of_bound": nbytes / PEAK_BYTES_S * 1e3 / times[str(picked)],
            "empty_kernel_ms": timed(torch, lambda: empty(x), True, 200) if small else None,
            "fastest": min(times, key=times.get), "ms_by_form": times,
            "timing": "graph of 200 calls" if small else "20 back-to-back calls", "card": smi,
        })
        del x, xq, ref_q

    for label, M, K in SPLIT:
        x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
        others = torch.rand(M, generator=g, device=dev) * 4.0  # the other slices' row maxima
        xq = torch.empty((M, K), dtype=torch.int8, device=dev)
        amax = torch.empty(M, device=dev)
        ref_q, ref_s = K789.act_quant_int8_plain(x, lambda a: torch.maximum(a, others, out=a))

        def split(form=None, rows=M):
            for r0 in range(0, M, rows):
                xs, a = x[r0 : r0 + rows], amax[r0 : r0 + rows]
                K789.act_quant_launch(xs, None, None, a, K789.AQ_MAX, form)
                torch.maximum(a, others[r0 : r0 + rows], out=a)
                K789.act_quant_launch(xs, None, xq[r0 : r0 + rows], a, K789.AQ_GIVEN_MAX, form)

        iters = 200 if 3 * M * K < 64 * 2**20 else 20  # in a graph: the chunks' launches outrun the host
        ms = {}
        chunks = {f"chunk_{f}": max(1, L2_BYTES // f // (2 * K)) for f in (2, 4, 8)} if M > 1024 else {}
        for key, fn in [("pair", lambda: split()), ("loop_pair", lambda: split(loop))] + [
                (key, lambda r=r: split(rows=r)) for key, r in chunks.items()]:
            fn()
            torch.cuda.synchronize()
            if not (torch.equal(xq, ref_q) and torch.equal(amax, ref_s)):
                raise SystemExit(f"{label}: {key} is not bit-equal to the plain version")
            ms[key] = timed(torch, fn, True, iters)
        ms["pass1"] = timed(torch, lambda: K789.act_quant_launch(x, None, None, amax, K789.AQ_MAX), True, iters)
        torch.maximum(amax, others, out=amax)  # the whole rows' maxima, for pass 2
        ms["pass2"] = timed(torch, lambda: K789.act_quant_launch(x, None, xq, amax, K789.AQ_GIVEN_MAX), True, iters)
        emit(args.out, {
            "row": "split", "label": label, "M": M, "K": K, "picked": K789.act_quant_form(M, K), "ms": ms,
            "chunk_rows": chunks, "bound_ms": (3 * M * K + 12 * M) / PEAK_BYTES_S * 1e3,
            "pass1_bound_ms": (2 * M * K + 4 * M) / PEAK_BYTES_S * 1e3,
            "pass2_bound_ms": (3 * M * K + 8 * M) / PEAK_BYTES_S * 1e3, "card": smi,
        })


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also append the rows to this file")
    bench(parser.parse_args())


if __name__ == "__main__":
    main()
