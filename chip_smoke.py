"""Smoke run of the PyTorch + CUDA port (``spatialrgpt_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py [--profile DIR]

Phases, each printed as one JSON line:

1. device  -- the card, its power limit, TF32 switched off for every
   comparison (float32 matmuls and cuDNN convolutions in full float32).
2. build   -- nvcc builds every kernel of ``spatialrgpt_tpu_torch/csrc``
   (one nvcc per source, all at once); ptxas's registers and spill bytes
   per kernel, from the build's log.
3. kernel  -- each kernel against its plain PyTorch version at its main
   path's shapes, in bf16, with the max abs error and its ratio to the
   per-element bound of ``ops/_checks.py::bf16_err_over_bound`` (4 bf16
   ulps of the element plus of its row's largest value; at most 1
   passes): K1-K3 at the serving shapes, K4's forward, dK/dV and dQ
   kernels at the align step's (B4 S4096 Hq32 Hk8 D128, 4 packed samples
   per row and a padded tail), K5 at SAM vit_h's global layers (B4 S4096
   on a 64 x 64 grid, H16 D80, f32 rel-pos bias) and K6 at SAM's and
   Depth-Anything's LayerNorm rows, K7-K9 (the quantized projections) at
   the W8A8 serve's shapes: K7 over the prefill's 20,480 rows, K8 at the
   prefill's gate and the decode's lm_head, K9 at the decode's down and
   k/v projections (K7 and K8 must equal their plain versions bit for
   bit).  K1, K2, K5 and K4's three kernels run
   on the TMA + wgmma loops of ``csrc/attention_sm90.cuh`` (K2 and K4's
   forward and dQ with G = 4 query heads x 32 positions per CTA and the
   causal x segment mask built in the kernel; K4 walks only the tiles of
   its rows' segments, dK/dV key-stationary: 128 keys per CTA, the G heads'
   dK and dV summed in registers); K3 is one launch of a thread-block
   cluster per (row, kv head); K6 is a streaming kernel that takes the
   models' bf16 weights as they are (one launch per LayerNorm).  Per row:
   the device time of the kernel (``ms``), of its plain version
   (``plain_ms``) and of one PyTorch call of the same function
   (``library_ms``, with ``library`` naming it and its pinned SDPA
   backend; null for K3 and K7, which no single call computes; for K8
   ``torch._int_mm``'s int32 product alone, for K9 ``F.linear`` on a bf16
   copy of the weight); for K4 also
   ``library_per_sample_ms``, SDPA's flash backend with ``is_causal`` over
   the per-sample view of the same q/k/v (4 equal samples per row, checked),
   which computes only the live pairs, as K4 does.  All by CUDA events:
   around one replay of a CUDA graph of
   many calls where a call is shorter than its launch on the host (K1-K3,
   K6, K7, K9, K8 at decode), around many back-to-back calls for the
   kernels of milliseconds (K4, K5, K8 at prefill); and ``bound_ms`` /
   ``bound_by``, the larger of the live work's operations over the peak of
   their type (bf16 989 TFLOP/s, int8 1,979 TOP/s, K7's elementwise f32
   67 TFLOP/s) and its bytes over 3.35 TB/s (causal and segment pairs only
   for K2 and K4, and q, k, v read at positions of a nonzero segment only;
   K3's live cache positions).
4. grad    -- gradients of q, k and v through the CUDA routes of K1 and K2
   against the plain path's, with the same bound.
5. main    -- region-QA ``generate`` at the full width of llama3-8b (bf16
   weights from a fixed seed, made on the card; int8 KV cache), 8 rows of
   RGB + depth + 2 masks and a 320-token prompt bucket, 32 greedy tokens:
   bench.py with SRGPT_BENCH_W8A8=0.  Checks the tokens, the first- and
   last-step logits against the plain path run on the same weights (the
   last step in the rows whose tokens all equal the plain path's), and
   the kernels' launch counts.
   serve_w8a8 -- bench.py's default: the same at 64 rows with the llm and
   the vision tower W8A8 (``init_random_quantized``) and the int8 KV
   cache.  Checks the launch counts of K1-K3 and K7-K9 (K9 exactly where
   a contracting projection runs below 2048 rows), first-token logits bit-
   equal to the same run on K7-K9's plain versions, and the attention
   kernels at 64 rows (``phase_serve_w8a8`` says why the plain route is
   held in two halves).
6. train   -- the stage-1 align step at the full width of llama3-8b and
   SigLIP-so400m (frozen decoder and tower, tuned projector and region
   extractor, lr 1e-3, remat, chunked CE over 1024 positions,
   ``attn_impl="pallas"``) on bench_train.py's batch (4 packed rows of
   4096 tokens, 4 samples per row, RGB + depth, 2 regions): the kernel
   path's loss and gradients against the plain path's on one row, then
   three ``Trainer`` steps with a checkpoint.  Checks the launch counts
   of every step, the first loss, that the frozen modules stay
   bit-unchanged and that the tuned ones move once the lr is above 0.
7. demo    -- bench_demo.py's pipeline (``demo/pipeline.py``) on 8
   synthetic photos of 768 x 1024: Depth-Anything ViT-L colorized depth,
   SAM-HQ vit_h masks for 2 boxes per image in chunks of 4, device
   preprocessing, region QA on llama3-8b (32 greedy tokens), all from
   fixed seeds on the card, with ``SRGPT_FUSED_LN``'s switch on and the
   VLM W8A8 as bench_demo.py builds it.  Checks the launch counts (K5 per
   SAM global layer and chunk, K6 at every LayerNorm that passes the gate,
   K1-K3 and K7-K9 as in phase serve_w8a8), then runs the same pipeline on
   K5's, K6's and K7-K9's plain versions and the VLM's xla route and holds
   depth and mask logits to it, and the VLM stage as serve_w8a8 does; also
   ``DemoEngine.set_image`` / ``add_regions`` on one photo through the
   adapters.

The times of phases 5-7 are smoke figures of this card, not a
benchmark.  Then the ``kernels`` line and, last, ``{"ok": true, "device":
{...}}``.  Any failure exits non-zero before that line; so does a machine
without a CUDA card, and a directory without the port's package.
``--profile DIR`` also profiles the W8A8 serve's first token and its
whole ``generate``, one align step and one demo pipeline run with
``torch.profiler`` and writes their operator tables to DIR.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
N_ROWS = 8
# bench.py's default serve (bench.py:123, :197-227): 64 rows, W8A8 llm and
# vision tower, int8 KV cache
SERVE_ROWS = 64
N_REGIONS = 2
PROMPT_TEXT_TOKENS = 96
PAD_BUCKET = 320
MAX_NEW = 32
# relative L2 distance allowed between the logits of the kernel path and of
# the plain path (first token, and last of the 32 steps): both run bf16
# through 26 ViT and 32 decoder layers, and each of the ~60 layers may round
# differently at bf16's 2^-8
LOGITS_REL_BOUND = 0.05
# the align step of bench_train.py: rows x tokens, samples per row
TRAIN_ROWS = 4
TRAIN_SEQ = 4096
TRAIN_SAMPLES_PER_ROW = 4
TRAIN_STEPS = 3
CE_CHUNK = 1024
# kernel path against plain path at the first align step, on one row: the
# loss (a mean over ~4000 targets) within 1% relative, and the projector's
# and region extractor's gradients within a relative L2 of 0.1 (both paths
# run bf16 forward and backward through 26 ViT and 32 decoder layers)
TRAIN_LOSS_REL_BOUND = 0.01
TRAIN_GRAD_REL_BOUND = 0.1
# the demo: bench_demo.py's batch of photos, their size, SAM's chunk
DEMO_IMAGES = 8
DEMO_HW = (768, 1024)
DEMO_SAM_CHUNK = 4
# kernel path against plain path over the whole demo pipeline, relative L2:
# the depth (only K6 differs; ViT-L in bf16), SAM's mask logits (K5 in 4 of
# 32 bf16 layers, K6) and, as in phase 5, the VLM's first-token logits.  On
# an H100 the sound K6 reads 0.0180 on the depth and a LayerNorm whose
# statistics leave out a row's last 8 columns reads 0.0214: the depth bound
# lies between them (PERF.md lists the faults it cannot see)
DEMO_DEPTH_REL_BOUND = 0.02
DEMO_MASK_REL_BOUND = 0.05
# the binary masks must agree wherever the plain path's logit is at least
# this share of the logits' RMS away from 0
DEMO_MASK_MARGIN = 0.5


# kernels held bit-equal to their plain versions (the others within
# bf16_err_over_bound)
BIT_EQUAL = {"act_quant_int8", "w8a8_gemm"}


class SmokeFailure(Exception):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def phase_device(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({
        "phase": "device", "ok": True, "nvidia_smi": smi,
        "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "tf32": "off (torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False)",
    })
    return smi


def ptxas_usage(log: str) -> dict:
    """Per compiled kernel (mangled name) in ptxas's -v output: [registers,
    spill store bytes, spill load bytes]."""
    import re

    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            usage[name] = [None, 0, 0]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            usage[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name][0] = int(m.group(1))
    return usage


def phase_build():
    from spatialrgpt_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.lib()
    log_path = os.path.join(os.path.dirname(_build.build_info["path"]), "build.log")
    emit({
        "phase": "build", "ok": True, "seconds": round(time.perf_counter() - t0, 3),
        "library": os.path.relpath(_build.build_info["path"], ROOT),
        "ptxas_registers_spill_store_load_bytes": ptxas_usage(open(log_path).read()) if os.path.exists(log_path) else {},
    })


def train_spliced(cfg, rng, rows: int):
    """bench_train.py::build_batch's token layout: ``rows`` packed rows of
    TRAIN_SEQ tokens, each packing 4 samples of bos + the image + 2 x
    (<mask>, <depth>) + text (labels on the text), and a padded tail."""
    import numpy as np

    from spatialrgpt_tpu_torch import IGNORE_INDEX, IMAGE_TOKEN_INDEX, NUM_TOKENS_PER_IMAGE, expand_rows, pack_rows

    text_len = TRAIN_SEQ // TRAIN_SAMPLES_PER_ROW - NUM_TOKENS_PER_IMAGE - 2 * N_REGIONS - 8
    singles = []
    for _ in range(rows * TRAIN_SAMPLES_PER_ROW):
        ids = [1, IMAGE_TOKEN_INDEX] + [cfg.mask_token_id, cfg.depth_token_id] * N_REGIONS
        ids += list(rng.integers(10, 1000, text_len))
        labs = [IGNORE_INDEX] * (2 + 2 * N_REGIONS) + ids[2 + 2 * N_REGIONS:]
        singles.append(expand_rows(
            [np.asarray(ids, np.int64)], [np.asarray(labs, np.int64)], max_len=TRAIN_SEQ,
            tokens_per_image=NUM_TOKENS_PER_IMAGE, mask_token_id=cfg.mask_token_id,
            depth_token_id=cfg.depth_token_id, regions_per_image=N_REGIONS,
        ))
    sb = pack_rows(singles, max_len=TRAIN_SEQ)
    check(sb.input_ids.shape[0] == rows, f"packing gave {sb.input_ids.shape[0]} rows, not {rows}")
    return sb


def train_batch(torch, cfg, rng, rows: int):
    """The spliced rows plus random pixels, depths and region masks at the
    tower resolution, one image per sample (bench_train.py draws them so)."""
    import numpy as np

    from spatialrgpt_tpu_torch.models.vlm import VLMInputs

    sb = train_spliced(cfg, rng, rows)
    n, size = rows * TRAIN_SAMPLES_PER_ROW, cfg.vision.image_size
    return VLMInputs.from_spliced(
        sb,
        rng.standard_normal((n, size, size, 3)).astype(np.float32),
        rng.standard_normal((n, size, size, 3)).astype(np.float32),
        (rng.random((n, N_REGIONS, size, size)) > 0.5).astype(np.float32),
        np.ones((n, N_REGIONS), bool),
        device=DEVICE, dtype=torch.bfloat16,
    )


def llama3_8b_cfg():
    from spatialrgpt_tpu_torch import preset

    cfg = preset("llama3-8b")
    return cfg.replace(
        mask_token_id=cfg.llm.vocab_size, depth_token_id=cfg.llm.vocab_size + 1, num_extra_tokens=8,
        model_max_length=max(TRAIN_SEQ, cfg.model_max_length),
    )


def per_row(torch, fn, *args):
    """``fn`` over one batch row at a time, outputs concatenated: the plain
    K4 versions hold (rows, 8, 4, S, S) f32 scores, 2.1 GB per row at S 4096."""
    outs = [fn(*(a[b : b + 1] for a in args)) for b in range(args[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def event_ms(torch, fn, iters: int, reps: int = 3) -> float:
    """Device time per call of a function that runs for milliseconds: CUDA
    events around ``iters`` back-to-back calls after a warm-up call, the
    median of ``reps`` such runs.  The host enqueues the next call while
    the device runs this one, so its launch cost stays hidden."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return statistics.median(runs)


def graph_ms(torch, fn, iters: int, reps: int = 3) -> float:
    """Device time per call of a function shorter than its own launch on
    the host (ctypes, the wrapper's checks, PyTorch's dispatch): ``iters``
    calls captured in one CUDA graph after a warm-up call, CUDA events
    around one replay, the median of ``reps`` replays."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(runs)


TIMERS = {
    "graph": (graph_ms, "a CUDA graph of {n} calls, CUDA events around its replay, median of 3 replays"),
    "events": (event_ms, "CUDA events around {n} back-to-back calls, median of 3 runs"),
}


# the H100 SXM's dense bf16 and int8 tensor-core peaks and its memory rate
# (NVIDIA's data sheet), for the least time a kernel's work can take on this card
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores: elementwise work
PEAK_BYTES_S = 3.35e12


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> dict:
    """The larger of operations over the peak of their type (bf16 unless
    given) and bytes (each input read once, each output written once) over
    the memory rate, in ms."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def live_bytes(seg, *tensors) -> int:
    """Bytes of per-position tensors (B * S positions in any layout) at the
    positions of a nonzero segment: a packed-segment kernel never reads
    the rest (its rows of segment 0 come out as zeros)."""
    live = int((seg != 0).sum())
    return sum(t.numel() // seg.numel() * t.element_size() * live for t in tensors)


def live_pairs(torch, seg) -> int:
    """(query, key) pairs a causal packed-segment kernel must compute: both
    in one nonzero segment, key <= query."""
    n = 0
    for row in seg:
        _, counts = torch.unique_consecutive(row[row != 0], return_counts=True)
        n += int((counts * (counts + 1) // 2).sum())
    return n


def per_sample_length(seg, samples: int) -> int:
    """L, after checking that every row of ``seg`` holds ``samples``
    segments of L positions each, contiguous from position 0 with distinct
    nonzero ids, then only padding (bench_train.py's packing of equal
    samples): then causal attention over each sample as a row of its own
    is K4's function on the live rows."""
    L = int((seg[0] != 0).sum()) // samples
    for row in seg.tolist():
        ids = [row[i * L] for i in range(samples)]
        runs = all(row[i * L : (i + 1) * L] == [ids[i]] * L for i in range(samples))
        check(L > 0 and runs and 0 not in ids and len(set(ids)) == samples and not any(row[samples * L :]),
              f"the packed rows are not {samples} equal contiguous samples of {L} positions")
    return L


def sdpa_library(torch, backend: str, q, k, v, mask=None, is_causal=False):
    """One call of F.scaled_dot_product_attention on (B, H, S, D) copies of
    (B, S, H, D) inputs (k and v expanded to q's heads), made here, outside
    any timed window; pinned to ``backend``."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    rep = q.shape[2] // k.shape[2]
    qt, kt, vt = (t.repeat_interleave(r, dim=2).transpose(1, 2).contiguous() for t, r in ((q, 1), (k, rep), (v, rep)))
    pinned = getattr(SDPBackend, backend)

    def call(*ins):
        with sdpa_kernel(pinned):
            return F.scaled_dot_product_attention(*ins, attn_mask=mask, is_causal=is_causal)

    return (qt, kt, vt), call


def int_mm_library(torch, xq, q):
    """K8's yardstick: ``torch._int_mm``'s int32 product alone (no scales,
    bias or bf16 cast), where it takes the shape (M > 16, K and N multiples
    of 8); q.t() is a view, made here."""
    label = "torch._int_mm(xq, q.t()): the int32 product alone, without K8's scales, bias and bf16 cast"
    qt = q.t()
    try:
        torch._int_mm(xq, qt)
        torch.cuda.synchronize()
    except RuntimeError as e:
        return f"{label}; refused at this shape: {e}"[:300], None
    return label, lambda: torch._int_mm(xq, qt)


def phase_kernels(torch):
    import numpy as np
    import torch.nn.functional as F

    from spatialrgpt_tpu_torch.ops import decode_attention as K3
    from spatialrgpt_tpu_torch.ops import flash_attention as K4
    from spatialrgpt_tpu_torch.ops import int8_linear as K789
    from spatialrgpt_tpu_torch.ops import layer_norm as K6
    from spatialrgpt_tpu_torch.ops import prefill_attention as K2
    from spatialrgpt_tpu_torch.ops import vit_attention as K1
    from spatialrgpt_tpu_torch.ops._checks import GRAD_FLOOR, bf16_err_over_bound
    from spatialrgpt_tpu_torch.ops.quant import dequantize, quantize_kv

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    def causal_segment_mask(seg):
        """(B, 1, S, S) additive bf16 mask of K2's and K4's function."""
        same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0)
        causal = torch.ones(seg.shape[1], seg.shape[1], dtype=torch.bool, device=dev).tril()
        live = (same & causal)[:, None]
        return torch.zeros(live.shape, dtype=torch.bfloat16, device=dev).masked_fill(~live, float("-inf"))

    # each case: name, source, replaces, shape, kernel, plain, iterations
    # timed (kernel, plain) and the timer of TIMERS (a graph where one call
    # is shorter than its launch on the host: K1-K3, K6), the work of
    # bound(), and the library call: (what it is, a function of no
    # arguments, or None and the reason)
    cases = []
    # K1: the SigLIP tower over [images; depths] of 8 rows
    B, S, H, D = 2 * N_ROWS, 729, 16, 72
    q, k, v = rn(B, S, H, D), rn(B, S, H, D), rn(B, S, H, D)
    lib_in, lib_call = sdpa_library(torch, "FLASH_ATTENTION", q, k, v)
    cases.append((
        "vit_attention", "spatialrgpt_tpu_torch/csrc/vit_attention.cu",
        "spatialrgpt_tpu/ops/vit_attention.py:196", {"B": B, "S": S, "H": H, "D": D},
        lambda: K1.vit_attention(q, k, v), lambda: K1.vit_attention_plain(q, k, v), (50, 5, "graph"),
        bound(4 * B * H * S * S * D, nbytes(q, k, v, q)),
        ("F.scaled_dot_product_attention, (B, H, S, D) copies, SDPBackend.FLASH_ATTENTION", lambda: lib_call(*lib_in)),
    ))
    # K2: llama3-8b prefill over the 320 bucket, right-padded rows; the
    # Hopper main loop at D 128 with G = 4 heads x 32 positions per CTA
    B, S, Hq, Hk, D = N_ROWS, PAD_BUCKET, 32, 8, 128
    q2, k2, v2 = rn(B, S, Hq, D), rn(B, S, Hk, D), rn(B, S, Hk, D)
    seg = torch.zeros(B, S, dtype=torch.int32, device=dev)
    for b in range(B):
        seg[b, : S - 3 * b - 15] = 1
    lib2_in, lib2_call = sdpa_library(torch, "EFFICIENT_ATTENTION", q2, k2, v2, causal_segment_mask(seg))
    cases.append((
        "onepass_attention", "spatialrgpt_tpu_torch/csrc/prefill_attention.cu",
        "spatialrgpt_tpu/ops/prefill_attention.py:228", {"B": B, "S": S, "Hq": Hq, "Hk": Hk, "D": D},
        lambda: K2.onepass_attention(q2, k2, v2, seg), lambda: K2.onepass_attention_plain(q2, k2, v2, seg),
        (50, 5, "graph"),
        bound(4 * D * Hq * live_pairs(torch, seg), live_bytes(seg, q2, k2, v2) + nbytes(seg, q2)),
        ("F.scaled_dot_product_attention, k/v expanded to Hq, (B, 1, S, S) causal x segment mask, "
         "SDPBackend.EFFICIENT_ATTENTION", lambda: lib2_call(*lib2_in)),
    ))
    # K3: one decode step against the int8 cache of 320 + 32 slots
    B, C, Hq, Hk, D = N_ROWS, PAD_BUCKET + MAX_NEW, 32, 8, 128
    q3 = rn(B, Hq, D)
    kq, ks = quantize_kv(rn(B, C, Hk, D))
    vq, vs = quantize_kv(rn(B, C, Hk, D))
    kq, vq = kq.reshape(B, C, Hk * D), vq.reshape(B, C, Hk * D)
    lengths = torch.tensor([0, C - 1, 5, 63, 64, 200, 305, 330], dtype=torch.int32, device=dev)
    live3 = int(torch.clamp(lengths + 1, max=C).sum())  # cache positions <= lengths[b]
    cases.append((
        "decode_attention_int8_flat", "spatialrgpt_tpu_torch/csrc/decode_attention.cu",
        "spatialrgpt_tpu/ops/decode_attention.py:174", {"B": B, "C": C, "Hq": Hq, "Hk": Hk, "D": D},
        lambda: K3.decode_attention_int8_flat(q3, kq, ks, vq, vs, lengths, Hk),
        lambda: K3.decode_attention_int8_flat_plain(q3, kq, ks, vq, vs, lengths, Hk), (200, 20, "graph"),
        bound(4 * Hq * D * live3, nbytes(q3, lengths, q3) + live3 * Hk * (2 * D + 2 * 4)),
        ("no single call dequantises an int8 cache", None),
    ))
    # K4: the align step's attention, segment ids of bench_train.py's packing
    B, S, Hq, Hk, D = TRAIN_ROWS, TRAIN_SEQ, 32, 8, 128
    seg4 = torch.as_tensor(train_spliced(llama3_8b_cfg(), np.random.default_rng(0), B).segment_ids, device=dev)
    L4 = per_sample_length(seg4, TRAIN_SAMPLES_PER_ROW)
    q4, k4, v4, do4 = rn(B, S, Hq, D), rn(B, S, Hk, D), rn(B, S, Hk, D), rn(B, S, Hq, D)
    out4, lse4 = K4.flash_attention_fwd(q4, k4, v4, seg4)
    delta4 = K4.attention_delta(out4, do4)
    bwd = (q4, k4, v4, seg4, lse4, delta4, do4)
    bwd_per_position = (q4, k4, v4, lse4, delta4, do4)
    shape4 = {"B": B, "S": S, "Hq": Hq, "Hk": Hk, "D": D, "samples_per_row": TRAIN_SAMPLES_PER_ROW,
              "padded_tail": int((seg4 == 0).sum(dim=1).min())}
    src4, fa = "spatialrgpt_tpu_torch/csrc/flash_attention_sm90.cu", "spatialrgpt_tpu/ops/flash_attention.py"
    pairs4 = live_pairs(torch, seg4)
    lib4_in, lib4_call = sdpa_library(torch, "EFFICIENT_ATTENTION", q4, k4, v4, causal_segment_mask(seg4))
    lib4_in = tuple(t.requires_grad_() for t in lib4_in)
    do4_t = do4.transpose(1, 2).contiguous()

    def lib4_fwd():
        with torch.no_grad():
            return lib4_call(*lib4_in)

    def lib4_fwd_bwd():
        return torch.autograd.grad(lib4_call(*lib4_in), lib4_in, do4_t)

    lib4_name = ("the backward of F.scaled_dot_product_attention (k/v expanded to Hq, (B, 1, S, S) causal x segment "
                 "mask, SDPBackend.EFFICIENT_ATTENTION): forward + backward minus forward, one figure for dK/dV + dQ")
    # the yardstick that computes only K4's live pairs: the samples of each
    # row as rows of their own, causal, SDPA's flash backend
    ps_in = tuple(t[:, : TRAIN_SAMPLES_PER_ROW * L4].reshape(B * TRAIN_SAMPLES_PER_ROW, L4, *t.shape[2:])
                  for t in (q4, k4, v4, do4))
    (psq, psk, psv), ps_call = sdpa_library(torch, "FLASH_ATTENTION", *ps_in[:3], is_causal=True)
    ps_grad_in = tuple(t.detach().clone().requires_grad_() for t in (psq, psk, psv))
    ps_do = ps_in[3].transpose(1, 2).contiguous()

    def ps_fwd():
        with torch.no_grad():
            return ps_call(psq, psk, psv)

    def ps_fwd_bwd():
        return torch.autograd.grad(ps_call(*ps_grad_in), ps_grad_in, ps_do)

    ps_name = (f"F.scaled_dot_product_attention over the per-sample view ({B * TRAIN_SAMPLES_PER_ROW}, Hq, {L4}, D), "
               "k/v expanded to Hq, is_causal, SDPBackend.FLASH_ATTENTION")
    per_sample = {
        "flash_attention_fwd": (ps_name, ps_fwd),
        "flash_attention_bwd_dkv": (f"the backward of {ps_name}: forward + backward minus forward, one figure for "
                                    "dK/dV + dQ", "backward"),
    }
    per_sample["flash_attention_bwd_dq"] = per_sample["flash_attention_bwd_dkv"]
    cases += [
        ("flash_attention_fwd", src4, f"{fa}:226", shape4,
         lambda: K4.flash_attention_fwd(q4, k4, v4, seg4),
         lambda: per_row(torch, K4.flash_attention_fwd_plain, q4, k4, v4, seg4), (10, 1, "events"),
         bound(4 * D * Hq * pairs4, live_bytes(seg4, q4, k4, v4) + nbytes(seg4, q4, lse4)),
         ("F.scaled_dot_product_attention, k/v expanded to Hq, (B, 1, S, S) causal x segment mask, "
          "SDPBackend.EFFICIENT_ATTENTION", lib4_fwd)),
        ("flash_attention_bwd_dkv", src4, f"{fa}:716", shape4,
         lambda: K4.flash_attention_bwd_dkv(*bwd),
         lambda: per_row(torch, K4.flash_attention_bwd_dkv_plain, *bwd), (10, 1, "events"),
         bound(8 * D * Hq * pairs4, live_bytes(seg4, *bwd_per_position) + nbytes(seg4, k4, v4)),
         (lib4_name, "backward")),
        ("flash_attention_bwd_dq", src4, f"{fa}:776", shape4,
         lambda: K4.flash_attention_bwd_dq(*bwd),
         lambda: per_row(torch, K4.flash_attention_bwd_dq_plain, *bwd), (10, 1, "events"),
         bound(6 * D * Hq * pairs4, live_bytes(seg4, *bwd_per_position) + nbytes(seg4, q4)),
         (lib4_name, "backward")),
    ]
    # K5: SAM vit_h's global layers, a chunk of 4 images: q/k/v as views into
    # the fused qkv projection, f32 rel-pos bias terms of the 64 x 64 grid
    B, gh, gw, H, D = DEMO_SAM_CHUNK, 64, 64, 16, 80
    S = gh * gw
    q5, k5, v5 = rn(B, S, 3, H, D).unbind(2)
    rel_h = torch.randn(B, H, S, gh, generator=g, device=dev)
    rel_w = torch.randn(B, H, S, gw, generator=g, device=dev)
    bias5 = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(B, H, S, S).to(torch.bfloat16)  # 2.1 GB
    lib5_in, lib5_call = sdpa_library(torch, "EFFICIENT_ATTENTION", q5, k5, v5, bias5)
    cases.append((
        "grid_bias_attention", "spatialrgpt_tpu_torch/csrc/grid_bias_attention.cu",
        "spatialrgpt_tpu/ops/flash_attention.py:397", {"B": B, "S": S, "grid": [gh, gw], "H": H, "D": D},
        lambda: K4.grid_bias_attention(q5, k5, v5, rel_h, rel_w, gw),
        lambda: per_row(torch, lambda *a: K4.grid_bias_attention_plain(*a, gw), q5, k5, v5, rel_h, rel_w),
        (20, 2, "events"),
        bound(4 * B * H * S * S * D, nbytes(q5, k5, v5, rel_h, rel_w, q5)),
        ("F.scaled_dot_product_attention, (B, H, S, S) bf16 bias materialised from rel_h / rel_w, "
         "SDPBackend.EFFICIENT_ATTENTION", lambda: lib5_call(*lib5_in)),
    ))
    # K6: SAM vit_h's encoder rows (a chunk of 4 images x 4096 tokens, C 1280)
    # and Depth-Anything ViT-L's (8 images x 1814 tokens, C 1024), bf16
    # weights as the models hold them (the streaming kernel takes them as
    # they are: one launch per call)
    for rows6, C in ((DEMO_SAM_CHUNK * 4096, 1280), (DEMO_IMAGES * 1814, 1024)):
        x6 = (torch.randn(rows6, C, generator=g, device=dev) * 3 + 1).to(torch.bfloat16)
        w6, b6 = rn(C), rn(C)
        cases.append((
            "fused_layer_norm", "spatialrgpt_tpu_torch/csrc/layer_norm.cu", "spatialrgpt_tpu/ops/layer_norm.py:36",
            {"rows": rows6, "C": C},
            lambda x=x6, w=w6, b=b6: K6.fused_layer_norm(x, w, b, 1e-6),
            lambda x=x6, w=w6, b=b6: K6.fused_layer_norm_plain(x, w, b, 1e-6), (200, 20, "graph"),
            bound(8 * rows6 * C, nbytes(x6, w6, b6, x6)),
            ("F.layer_norm", lambda x=x6, w=w6, b=b6, C=C: F.layer_norm(x, (C,), w, b, 1e-6)),
        ))
    # K7-K9: the quantized projections of bench.py's default serve (W8A8,
    # SERVE_ROWS rows): K7 over the prefill rows, K8 at the prefill's gate
    # projection and the decode's lm_head, K9 at the decode's contracting
    # down and k/v projections
    lcfg = llama3_8b_cfg()
    Hd, Id, Vd = lcfg.llm.hidden_size, lcfg.llm.intermediate_size, lcfg.llm.vocab_size + lcfg.num_extra_tokens
    kvd = lcfg.llm.num_key_value_heads * lcfg.llm.head_dim
    m_pf = SERVE_ROWS * PAD_BUCKET

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)

    def scales(n, k):  # fast_init_quantized's weight scale
        return torch.full((n,), k**-0.5 * 3.0 / 127.0, device=dev)

    x7 = rn(m_pf, Hd)
    cases.append((
        "act_quant_int8", "spatialrgpt_tpu_torch/csrc/act_quant.cu", "spatialrgpt_tpu/ops/layers.py:30 (XLA)",
        {"M": m_pf, "K": Hd}, lambda: K789.act_quant_int8(x7), lambda: K789.act_quant_int8_plain(x7),
        (50, 5, "graph"), bound(6 * m_pf * Hd, nbytes(x7) + m_pf * Hd + 4 * m_pf, PEAK_F32_FLOPS),
        ("no single call quantizes rows to int8 with a scale per row", None),
    ))
    for label, M, N, K, (iters, plain_iters, how) in (("prefill gate", m_pf, Id, Hd, (20, 2, "events")),
                                                     ("decode lm_head", SERVE_ROWS, Vd, Hd, (20, 2, "graph"))):
        xq8, q8 = i8(M, K), i8(N, K)
        as8 = torch.rand(M, generator=g, device=dev) * 0.05 + 1e-3
        s8 = scales(N, K)
        cases.append((
            "w8a8_gemm", "spatialrgpt_tpu_torch/csrc/int8_gemm.cu", "spatialrgpt_tpu/ops/layers.py:36 (XLA)",
            {"projection": label, "M": M, "N": N, "K": K},
            lambda a=xq8, s=as8, q=q8, w=s8: K789.w8a8_gemm(a, s, q, w),
            lambda a=xq8, s=as8, q=q8, w=s8: K789.w8a8_gemm_plain(a, s, q, w), (iters, plain_iters, how),
            bound(2 * M * N * K, nbytes(xq8, q8, as8, s8) + 2 * M * N, PEAK_INT8_OPS),
            int_mm_library(torch, xq8, q8),
        ))
    for label, M, N, K in (("decode down", SERVE_ROWS, Hd, Id), ("decode k / v", SERVE_ROWS, kvd, Hd)):
        x9, q9, s9 = rn(M, K), i8(N, K), scales(N, K)
        w9 = dequantize(q9, s9)  # bf16, made here for the library yardstick only
        cases.append((
            "w8_gemm", "spatialrgpt_tpu_torch/csrc/int8_gemm.cu", "spatialrgpt_tpu/ops/layers.py:123 (XLA)",
            {"projection": label, "M": M, "N": N, "K": K},
            lambda x=x9, q=q9, s=s9: K789.w8_gemm(x, q, s), lambda x=x9, q=q9, s=s9: K789.w8_gemm_plain(x, q, s),
            (100, 10, "graph"), bound(2 * M * N * K, nbytes(x9, q9, s9) + 2 * M * N),
            ("F.linear on the weight dequantized to bf16 beforehand", lambda x=x9, w=w9: F.linear(x, w)),
        ))

    rows = []
    library_bwd_ms = ps_bwd_ms = None
    for name, source, replaces, shape, kernel, plain, (iters, plain_iters, how), work, (library, lib_fn) in cases:
        out = kernel()
        torch.cuda.synchronize()
        ref = plain()
        outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
        bit_equal = all(o.dtype == r.dtype and torch.equal(o, r) for o, r in zip(outs, refs))
        if name == "flash_attention_fwd":  # lse: f32, compared where a key is live
            live = refs[1] > K4.NEG_INF / 2
            lse_err = float((outs[1] - refs[1])[live].abs().max())
            check(torch.equal(live, outs[1] > K4.NEG_INF / 2) and lse_err < 1e-3, f"{name}: lse off by {lse_err}")
            outs, refs = outs[:1], refs[:1]
        err = max(float((o.float() - r.float()).abs().max()) for o, r in zip(outs, refs))
        floor = GRAD_FLOOR if "_bwd_" in name else 0.0
        ratio = max(bf16_err_over_bound(o, r, floor) for o, r in zip(outs, refs))
        del out, ref, outs, refs
        timer, timing = TIMERS[how]
        plain_ms = timer(torch, plain, plain_iters)
        ms = timer(torch, kernel, iters)
        if lib_fn == "backward":  # K4's dK/dV and dQ share one figure
            if library_bwd_ms is None:
                library_bwd_ms = timer(torch, lib4_fwd_bwd, iters) - timer(torch, lib4_fwd, iters)
            library_ms = library_bwd_ms
        else:
            library_ms = timer(torch, lib_fn, iters) if lib_fn is not None else None
        ps_label, ps_fn = per_sample.get(name, (None, None))
        if ps_fn == "backward":
            if ps_bwd_ms is None:
                ps_bwd_ms = timer(torch, ps_fwd_bwd, iters) - timer(torch, ps_fwd, iters)
            ps_ms = ps_bwd_ms
        else:
            ps_ms = timer(torch, ps_fn, iters) if ps_fn is not None else None
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": err, "err_over_bound": ratio, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": work["bound_ms"], "bound_by": work["bound_by"], "library_ms": library_ms, "library": library,
            "share_of_bound": work["bound_ms"] / ms,
            "library_over_kernel": library_ms / ms if library_ms is not None else None,
            "library_per_sample_ms": ps_ms, "library_per_sample": ps_label,
            "per_sample_library_over_kernel": ps_ms / ms if ps_ms is not None else None,
            "flops": work["flops"], "bytes": work["bytes"],
            "timing": timing.format(n=iters) + f" ({plain_iters} calls for the plain version)",
        }
        ok = bit_equal if name in BIT_EQUAL else ratio <= 1.0
        row["bit_equal_to_plain"] = bit_equal
        emit({"phase": "kernel", "ok": ok, "shape": shape, **row})
        check(ok, f"{name}: error {ratio} x the per-element bound (max abs err {err}, bit-equal {bit_equal})")
        rows.append(row)
    del bias5, lib_in, lib2_in, lib4_in, lib5_in, ps_in, ps_grad_in, cases
    torch.cuda.empty_cache()
    # one row per kernel in the kernels line: K6's at its first (SAM) shape
    first = {}
    for row in rows:
        first.setdefault(row["name"], row)
    return list(first.values())


def phase_grads(torch):
    """K1 and K2 carry gradients on the CUDA route: dq, dk, dv through the
    kernel wrapper against autograd through the plain version."""
    from spatialrgpt_tpu_torch.ops import prefill_attention as K2
    from spatialrgpt_tpu_torch.ops import vit_attention as K1
    from spatialrgpt_tpu_torch.ops._checks import GRAD_FLOOR, bf16_err_over_bound

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(1)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    seg = torch.ones(N_ROWS, PAD_BUCKET, dtype=torch.int32, device=dev)
    seg[:, PAD_BUCKET - 15 :] = 0
    cases = [
        ("vit_attention", K1.vit_attention, K1.vit_attention_plain, (2 * N_ROWS, 729, 16, 72), (2 * N_ROWS, 729, 16, 72), ()),
        ("onepass_attention", K2.onepass_attention, K2.onepass_attention_plain,
         (N_ROWS, PAD_BUCKET, 32, 128), (N_ROWS, PAD_BUCKET, 8, 128), (seg,)),
    ]
    for name, kernel, plain, qshape, kshape, extra in cases:
        q, k, v, dout = rn(*qshape), rn(*kshape), rn(*kshape), rn(*qshape)
        grads = []
        for fn in (kernel, plain):
            ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            fn(*ins, *extra).backward(dout)
            grads.append([t.grad for t in ins])
        present = all(t is not None for t in grads[0])
        ratio = max(bf16_err_over_bound(a, b, GRAD_FLOOR) for a, b in zip(*grads)) if present else float("inf")
        emit({"phase": "grad", "ok": present and ratio <= 1.0, "name": name, "grads_present": present,
              "err_over_bound": ratio, "shape_q": list(qshape)})
        check(present and ratio <= 1.0, f"{name}: gradients missing or off ({ratio} x the bound)")


def build_batch(torch, cfg, rng, n_rows: int = N_ROWS):
    """bench.py::build_batch for the port: ``n_rows`` rows of bos + 8 text
    tokens + the image + 2 x (<mask>, <depth>) + the 96-token question,
    padded to the 320 bucket; random pixels, depths and region masks at the
    tower resolution, drawn as bench.py draws them."""
    import numpy as np

    from spatialrgpt_tpu_torch import IMAGE_TOKEN_INDEX, NUM_TOKENS_PER_IMAGE, expand_rows
    from spatialrgpt_tpu_torch.models.vlm import VLMInputs

    rows = []
    for _ in range(n_rows):
        ids = (
            [1] + list(rng.integers(10, 1000, 8)) + [IMAGE_TOKEN_INDEX]
            + [cfg.mask_token_id, cfg.depth_token_id] * N_REGIONS
            + list(rng.integers(10, 1000, PROMPT_TEXT_TOKENS))
        )
        rows.append(np.asarray(ids, np.int64))
    sb = expand_rows(
        rows, None, max_len=cfg.model_max_length, tokens_per_image=NUM_TOKENS_PER_IMAGE,
        mask_token_id=cfg.mask_token_id, depth_token_id=cfg.depth_token_id,
        regions_per_image=N_REGIONS, pad_to=PAD_BUCKET,
    )
    size = cfg.vision.image_size
    inputs = VLMInputs.from_spliced(
        sb,
        rng.standard_normal((n_rows, size, size, 3)).astype(np.float32),
        rng.standard_normal((n_rows, size, size, 3)).astype(np.float32),
        (rng.random((n_rows, N_REGIONS, size, size)) > 0.5).astype(np.float32),
        np.ones((n_rows, N_REGIONS), bool),
        device=DEVICE, dtype=torch.bfloat16,
    )
    return inputs, torch.as_tensor(sb.segment_ids.sum(axis=1), device=DEVICE)


def reset_counts():
    from spatialrgpt_tpu_torch.ops import decode_attention as K3
    from spatialrgpt_tpu_torch.ops import flash_attention as K4
    from spatialrgpt_tpu_torch.ops import int8_linear as K789
    from spatialrgpt_tpu_torch.ops import layer_norm as K6
    from spatialrgpt_tpu_torch.ops import prefill_attention as K2
    from spatialrgpt_tpu_torch.ops import vit_attention as K1

    for m in (K1, K2, K3, K6):
        m.launches = 0
    for counts in (K4.launches, K789.launches):
        for name in counts:
            counts[name] = 0
    K4.grid_bias_launches = 0


def read_counts() -> dict:
    from spatialrgpt_tpu_torch.ops import decode_attention as K3
    from spatialrgpt_tpu_torch.ops import flash_attention as K4
    from spatialrgpt_tpu_torch.ops import int8_linear as K789
    from spatialrgpt_tpu_torch.ops import layer_norm as K6
    from spatialrgpt_tpu_torch.ops import prefill_attention as K2
    from spatialrgpt_tpu_torch.ops import vit_attention as K1

    return {"vit_attention": K1.launches, "onepass_attention": K2.launches,
            "decode_attention_int8_flat": K3.launches, **K4.launches,
            "grid_bias_attention": K4.grid_bias_launches, "fused_layer_norm": K6.launches, **K789.launches}


# no projection is quantized: K7-K9 launch no time
NO_QUANT = {"act_quant_int8": 0, "w8a8_gemm": 0, "w8_gemm": 0}


def quant_expected_counts(cfg, rows: int, bucket: int, max_new: int) -> dict:
    """K7-K9 launches of one W8A8 ``generate`` (llm and vision tower
    quantized) from the config, by the reference's per-call-site rule
    (spatialrgpt_tpu/ops/layers.py:114-120): a weight takes int8
    activations when it expands (in <= out) or at 2048 rows and more, else
    the int8 weight-only product (K9).  Sibling projections that read one
    x (q/k/v; gate/up) quantize it once (K7)."""

    def group(m: int, *shapes) -> dict:
        a8 = [din <= dout or m >= 2048 for din, dout in shapes]
        return {"act_quant_int8": int(any(a8)), "w8a8_gemm": sum(a8), "w8_gemm": len(a8) - sum(a8)}

    def add(*parts) -> dict:
        return {k: sum(p[k] for p in parts) for k in NO_QUANT}

    def times(n: int, part: dict) -> dict:
        return {k: n * v for k, v in part.items()}

    v, lc = cfg.vision, cfg.llm
    C, Iv = v.hidden_size, v.intermediate_size
    tower_rows = 2 * rows * (v.image_size // v.patch_size) ** 2  # [images; depths]
    tower_layers = v.num_hidden_layers + 1 + v.select_layer
    H, I, q_out, kv_out = lc.hidden_size, lc.intermediate_size, lc.num_attention_heads * lc.head_dim, \
        lc.num_key_value_heads * lc.head_dim
    vocab = lc.vocab_size + cfg.num_extra_tokens

    def tower_layer(m):
        return add(group(m, (C, C), (C, C), (C, C)), group(m, (C, C)), group(m, (C, Iv)), group(m, (Iv, C)))

    def decoder_layer(m):
        return add(group(m, (H, q_out), (H, kv_out), (H, kv_out)), group(m, (q_out, H)),
                   group(m, (H, I), (H, I)), group(m, (I, H)))

    lm_head = group(rows, (H, vocab))  # the last position of every row
    step = add(times(lc.num_hidden_layers, decoder_layer(rows)), lm_head)
    return add(times(tower_layers, tower_layer(tower_rows)), times(lc.num_hidden_layers, decoder_layer(rows * bucket)),
               lm_head, times(max_new - 1, step))


@contextlib.contextmanager
def plain_projections():
    """The quantized branches of ``linear`` on K7-K9's plain versions (on
    the card too) inside the block: the projections' half of the plain
    route, whose attention half is ``attn_impl="xla"``."""
    from spatialrgpt_tpu_torch.ops import layers

    before = layers.QUANT_KERNELS
    layers.QUANT_KERNELS = False
    try:
        yield
    finally:
        layers.QUANT_KERNELS = before


def serve_runner(torch, cfg, model, n_rows: int):
    """``run(max_new, impl="onepass")``: region-QA ``generate`` of ``model``
    over ``n_rows`` rows of bench.py's batch, drawn from seed 0."""
    import numpy as np

    from spatialrgpt_tpu_torch.serving.generate import generate

    inputs, plens = build_batch(torch, cfg, np.random.default_rng(0), n_rows)

    def run(max_new, impl="onepass"):
        out = generate(model, cfg, inputs, plens, max_new_tokens=max_new, temperature=0.0,
                       eos_token_id=-1, attn_impl=impl)
        torch.cuda.synchronize()
        return out

    return run


def serve_run(torch, cfg, model, n_rows: int):
    """Region-QA ``generate`` over ``n_rows`` rows of bench.py's batch: a
    warm-up, then the timed run of MAX_NEW greedy tokens with the launch
    counts read around it, then three TTFT runs.  Returns the timed run's
    result, its counts, the smoke figures and a function ``run(max_new,
    impl)`` that runs ``generate`` on the same batch."""
    run = serve_runner(torch, cfg, model, n_rows)
    run(2)  # warm-up: cuBLAS handles, allocator, every op of the path once

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = run(MAX_NEW)
    e2e_s = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    ttfts = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(1)
        ttfts.append(time.perf_counter() - t0)
    ttft_s = statistics.median(ttfts)
    figures = {"ttft_s": ttft_s, "e2e_s": e2e_s, "tok_s": n_rows * MAX_NEW / e2e_s, "peak_mem_gb": peak_gb}
    return res, counts, figures, run


def logits_vs(torch, res, ref, vocab: int, min_equal_rows: int = 0) -> tuple:
    """Checks and fields of a serve run against another route's run of the
    same batch and weights.  The last step's logits hold K3 and the per-row
    cache scatter, 31 decode steps on.  Greedy decoding amplifies bf16
    near-ties, so a row may pick another token somewhere and then sees
    other inputs; only rows whose 32 tokens are all equal saw the same
    inputs at every step, and at least ``min_equal_rows`` (default half the
    rows) must be such."""
    tokens, first = res.tokens, res.first_logits
    n_rows = tokens.shape[0]
    rel = rel_l2(first, ref.first_logits)
    same = (tokens == ref.tokens).all(dim=1)
    n_same = int(same.sum())
    rel_last = rel_l2(res.last_logits[same], ref.last_logits[same]) if n_same else float("inf")
    min_equal_rows = min_equal_rows or -(-n_rows // 2)
    checks = {
        "tokens_shape": list(tokens.shape) == [n_rows, MAX_NEW],
        "tokens_in_vocab": bool(((tokens >= 0) & (tokens < vocab)).all()),
        "logits_finite": bool(torch.isfinite(first).all() and torch.isfinite(res.last_logits).all()),
        "first_logits_vs_plain": rel <= LOGITS_REL_BOUND,
        "last_logits_vs_plain": n_same >= min_equal_rows and rel_last <= LOGITS_REL_BOUND,
    }
    fields = {
        "first_logits_rel_l2_vs_plain": rel, "last_logits_rel_l2_vs_plain": rel_last,
        "rel_bound": LOGITS_REL_BOUND, "tokens_agreement_vs_plain": float((tokens == ref.tokens).float().mean()),
        "rows_with_all_tokens_equal": n_same, "rows_with_all_tokens_equal_needed": min_equal_rows,
        "last_logits_rel_l2_per_row": [rel_l2(res.last_logits[b], ref.last_logits[b]) for b in range(n_rows)],
    }
    return checks, fields


def phase_main(torch, nvidia_smi: str) -> dict:
    """bench.py's serve with SRGPT_BENCH_W8A8=0: bf16 weights, 8 rows;
    checked against the plain route (K1-K3's plain versions)."""
    from spatialrgpt_tpu_torch.utils.weights import init_random

    cfg = llama3_8b_cfg()
    t0 = time.perf_counter()
    model = init_random(cfg, torch.device(DEVICE), torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    L = cfg.llm.num_hidden_layers
    want = {
        "vit_attention": cfg.vision.num_hidden_layers + 1 + cfg.vision.select_layer,
        "onepass_attention": L,
        "decode_attention_int8_flat": L * (MAX_NEW - 1),
        "flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
        "grid_bias_attention": 0, "fused_layer_norm": 0, **NO_QUANT,
    }
    res, counts, figures, run = serve_run(torch, cfg, model, N_ROWS)
    checks, fields = logits_vs(torch, res, run(MAX_NEW, "xla"), cfg.llm.vocab_size + cfg.num_extra_tokens)
    checks["launch_counts"] = counts == want
    emit({"phase": "main", "ok": all(checks.values()), "checks": checks,
          "model": "llama3-8b (32 layers, full width) + siglip-so400m (26 of 27 layers), bf16 weights",
          "rows": N_ROWS, "prompt_bucket": PAD_BUCKET, "max_new_tokens": MAX_NEW,
          "launches": counts, "launches_expected": want, **fields,
          "smoke_figures_not_a_benchmark": {**figures, "init_s": init_s, "card": nvidia_smi},
          "first_tokens_row0": res.tokens[0, :8].tolist()})
    check(all(checks.values()), f"main path checks failed: {checks}")
    return counts


def decode_kernel_ratio(torch, cfg, prompt_lengths) -> float:
    """K3 against its plain version at the shape of a serve run's last
    decode step: one row per prompt, PAD_BUCKET + MAX_NEW cache slots, row
    b's slots live up to prompt_lengths[b] + MAX_NEW - 2; random q and
    int8 cache.  Returns the ratio of ``bf16_err_over_bound`` (at most 1
    passes)."""
    from spatialrgpt_tpu_torch.ops import decode_attention as K3
    from spatialrgpt_tpu_torch.ops._checks import bf16_err_over_bound
    from spatialrgpt_tpu_torch.ops.quant import quantize_kv

    g = torch.Generator(device=DEVICE).manual_seed(3)
    lc = cfg.llm
    B, C, D = prompt_lengths.shape[0], PAD_BUCKET + MAX_NEW, lc.head_dim
    Hq, Hk = lc.num_attention_heads, lc.num_key_value_heads
    q = torch.randn(B, Hq, D, generator=g, device=DEVICE).to(torch.bfloat16)
    kq, ks = quantize_kv(torch.randn(B, C, Hk, D, generator=g, device=DEVICE).to(torch.bfloat16))
    vq, vs = quantize_kv(torch.randn(B, C, Hk, D, generator=g, device=DEVICE).to(torch.bfloat16))
    args = (q, kq.reshape(B, C, Hk * D), ks, vq.reshape(B, C, Hk * D), vs,
            (prompt_lengths + MAX_NEW - 2).to(device=DEVICE, dtype=torch.int32), Hk)
    return bf16_err_over_bound(K3.decode_attention_int8_flat(*args), K3.decode_attention_int8_flat_plain(*args))


def phase_serve_w8a8(torch, nvidia_smi: str, profile_dir=None) -> dict:
    """bench.py's default serve: W8A8 llm and vision tower made directly in
    the int8 layout (``init_random_quantized``, the twin of
    ``fast_init_quantized``), int8 KV cache, the 320 bucket, SERVE_ROWS
    rows, with K7-K9's launch counts.

    The plain route is checked in its two halves.  Per-token int8
    activations round to steps of max|x| / 127: where two routes' inputs
    differ by a bf16 rounding, some activations land a step apart, and
    through the 58 quantized layers of random weights the two runs come
    apart by the size of the quantization error itself.  So: (1) the
    projections: the same W8A8 run with K7-K9's plain versions (the same
    K1-K3) gives first-token logits bit-equal to the kernels' (K7 and K8
    are exact; K9 runs only in decode); (2) the attention kernels at this
    phase's shapes: phase main's check at SERVE_ROWS rows, bf16 weights of
    ``init_random`` (fast_init_quantized's uniform int8 weights are ~1.7x
    wider and, even dequantized to bf16, amplify a rounding further), with
    at least one row whose 32 tokens all agree (at 64 rows more rows meet a
    near-tie in 32 greedy steps: 27 of 64 agreed on the H100, where phase
    main's half of 8 rows holds), and K3 itself, against its plain version,
    at this phase's last decode step.  Reported without a bound: the W8A8 decode steps against (1), the W8A8
    run against the whole plain route, and the W8A8 first-token logits
    against its own weights dequantized to bf16 (the float branch of
    ``linear``), on K1-K3 and on their plain versions."""
    import numpy as np

    from spatialrgpt_tpu_torch.ops.layers import dequantize_model
    from spatialrgpt_tpu_torch.utils.weights import init_random, init_random_quantized

    cfg = llama3_8b_cfg()
    vocab = cfg.llm.vocab_size + cfg.num_extra_tokens
    t0 = time.perf_counter()
    model = init_random_quantized(cfg, torch.device(DEVICE), w8a8=True, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    L = cfg.llm.num_hidden_layers
    want = {
        "vit_attention": cfg.vision.num_hidden_layers + 1 + cfg.vision.select_layer,
        "onepass_attention": L,
        "decode_attention_int8_flat": L * (MAX_NEW - 1),
        "flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
        "grid_bias_attention": 0, "fused_layer_norm": 0,
        **quant_expected_counts(cfg, SERVE_ROWS, PAD_BUCKET, MAX_NEW),
    }
    res, counts, figures, run = serve_run(torch, cfg, model, SERVE_ROWS)
    if profile_dir:
        profile_run(torch, lambda: run(1), profile_dir, "serve_w8a8_ttft")
        profile_run(torch, lambda: run(MAX_NEW), profile_dir, "serve_w8a8_generate")
    with plain_projections():
        proj_plain = run(MAX_NEW)
        all_plain = run(MAX_NEW, "xla")
    _, vs_proj_plain = logits_vs(torch, res, proj_plain, vocab)
    _, vs_all_plain = logits_vs(torch, res, all_plain, vocab)
    projections_bit_equal = torch.equal(res.first_logits, proj_plain.first_logits)
    del proj_plain, all_plain
    dequantize_model(model)
    deq, deq_plain = run(1), run(1, "xla")
    del model, run
    torch.cuda.empty_cache()
    bf16_run = serve_runner(torch, cfg, init_random(cfg, torch.device(DEVICE), torch.bfloat16, seed=0), SERVE_ROWS)
    attn_checks, vs_attn_plain = logits_vs(torch, bf16_run(MAX_NEW), bf16_run(MAX_NEW, "xla"), vocab, 1)
    del bf16_run
    torch.cuda.empty_cache()
    k3_ratio = decode_kernel_ratio(torch, cfg, build_batch(torch, cfg, np.random.default_rng(0), SERVE_ROWS)[1])
    checks = {
        "tokens_shape": list(res.tokens.shape) == [SERVE_ROWS, MAX_NEW],
        "tokens_in_vocab": bool(((res.tokens >= 0) & (res.tokens < vocab)).all()),
        "logits_finite": bool(torch.isfinite(res.first_logits).all() and torch.isfinite(res.last_logits).all()),
        "launch_counts": counts == want,
        "first_logits_bit_equal_to_plain_projections": projections_bit_equal,
        **{f"attention_bf16_{k}": v for k, v in attn_checks.items()},
        "decode_attention_kernel_at_serve_shape": k3_ratio <= 1.0,
    }
    emit({"phase": "serve_w8a8", "ok": all(checks.values()), "checks": checks,
          "model": "llama3-8b (32 layers, full width) + siglip-so400m (26 of 27 layers), W8A8 llm and vision "
                   "tower (int8 weights, int8 per-token activations), int8 KV, random from seed 0",
          "rows": SERVE_ROWS, "prompt_bucket": PAD_BUCKET, "max_new_tokens": MAX_NEW,
          "launches": counts, "launches_expected": want,
          "w8a8_vs_plain_projections_same_attention": vs_proj_plain,
          "w8a8_vs_whole_plain_route": vs_all_plain,
          "attention_bf16_init_random_kernel_vs_plain": vs_attn_plain,
          "decode_attention_err_over_bound_at_serve_shape": k3_ratio,
          "first_logits_rel_l2_w8a8_vs_dequantized_bf16": rel_l2(res.first_logits, deq.first_logits),
          "first_logits_rel_l2_dequantized_bf16_kernel_vs_plain_attention": rel_l2(deq.first_logits,
                                                                                   deq_plain.first_logits),
          "smoke_figures_not_a_benchmark": {**figures, "init_s": init_s, "card": nvidia_smi},
          "first_tokens_row0": res.tokens[0, :8].tolist()})
    check(all(checks.values()), f"serve_w8a8 checks failed: {checks}")
    return counts


def fingerprint(torch, module) -> list:
    """Per parameter, the int64 sum of its 16-bit patterns: any change of a
    single element changes it."""
    return [int(p.detach().reshape(-1).view(torch.int16).sum(dtype=torch.int64)) for p in module.parameters()]


def tuned_grads(torch, model):
    return torch.cat([p.grad.float().flatten() for m in (model.mm_projector, model.region_extractor)
                      for p in m.parameters()])


def phase_train(torch, profile_dir):
    import numpy as np

    from spatialrgpt_tpu_torch.models import vlm
    from spatialrgpt_tpu_torch.train.optimizer import OptimizerConfig, build_optimizer
    from spatialrgpt_tpu_torch.train.step import create_train_state, make_train_step
    from spatialrgpt_tpu_torch.train.trainer import Trainer, TrainerConfig
    from spatialrgpt_tpu_torch.utils.weights import init_random

    cfg = llama3_8b_cfg()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_random(cfg, torch.device(DEVICE), torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # stage-1 align (bench_train.py:178-185)
    ocfg = OptimizerConfig(learning_rate=1e-3, tune_language_model=False, tune_vision_tower=False,
                           tune_mm_projector=True, tune_region_extractor=True, total_steps=100)
    optimizer = build_optimizer(model, ocfg)
    rng = np.random.default_rng(0)
    batch = train_batch(torch, cfg, rng, TRAIN_ROWS)
    one_row = train_batch(torch, cfg, rng, 1)

    # kernel path against the plain path (K1's and K4's plain versions) on
    # one row: the plain attention holds (1, 8, 4, 4096, 4096) f32 scores
    # per layer, which for 4 rows would not fit beside the model
    compare = {}
    for impl in ("pallas", "xla"):
        model.zero_grad(set_to_none=True)
        loss, _ = vlm.loss_fn(model, cfg, one_row, attn_impl=impl, remat=True, ce_chunk=CE_CHUNK)
        loss.backward()
        compare[impl] = (float(loss.detach()), tuned_grads(torch, model))
    model.zero_grad(set_to_none=True)
    loss_rel = abs(compare["pallas"][0] - compare["xla"][0]) / abs(compare["xla"][0])
    grad_rel = rel_l2(compare["pallas"][1], compare["xla"][1])
    del compare
    torch.cuda.empty_cache()

    frozen_before = {name: fingerprint(torch, getattr(model, name)) for name in ("llm", "vision_tower")}
    tuned = lambda: fingerprint(torch, model.mm_projector) + fingerprint(torch, model.region_extractor)  # noqa: E731
    tuned_before = tuned()
    step_fn = make_train_step(cfg, optimizer, attn_impl="pallas", remat=True, frozen=("llm", "vision"),
                              ce_chunk=CE_CHUNK)
    record = []

    def observed_step(state, b):
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = read_counts()
        record.append({"seconds": seconds, "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                       "num_tokens": int(metrics["num_tokens"]), "tuned_changed": tuned() != tuned_before,
                       "launches": {n: after[n] - before[n] for n in after}})
        return state, metrics

    L, T = cfg.llm.num_hidden_layers, cfg.vision.num_hidden_layers + 1 + cfg.vision.select_layer
    want_step = {"vit_attention": T, "onepass_attention": 0, "decode_attention_int8_flat": 0,
                 "flash_attention_fwd": 2 * L, "flash_attention_bwd_dkv": L, "flash_attention_bwd_dq": L,
                 "grid_bias_attention": 0, "fused_layer_norm": 0, **NO_QUANT}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as out_dir:
        saved = []

        def save_tuned(root, state):  # the align stage's output: projector + region extractor
            for name in ("mm_projector", "region_extractor"):
                os.makedirs(os.path.join(root, name), exist_ok=True)
                torch.save(getattr(state.model, name).state_dict(), os.path.join(root, name, "pytorch_model.bin"))
                saved.append(name)

        tcfg = TrainerConfig(output_dir=out_dir, max_steps=TRAIN_STEPS, save_steps=2, log_steps=1)
        trainer = Trainer(cfg, tcfg, observed_step, create_train_state(model, optimizer),
                          (batch for _ in range(TRAIN_STEPS)), save_final_fn=save_tuned)
        reset_counts()
        result = trainer.train()
        counts = read_counts()
        ckpt = sorted(os.listdir(out_dir))
        ckpt_files = sorted(os.listdir(os.path.join(out_dir, "checkpoint-2"))) if "checkpoint-2" in ckpt else []
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            logged = [json.loads(line)["step"] for line in f]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    vocab = cfg.llm.vocab_size + cfg.num_extra_tokens
    first_loss = record[0]["loss"] if record else float("nan")
    checks = {
        "trainer_completed": result == {"status": "completed", "step": TRAIN_STEPS} and logged == [1, 2, 3],
        "checkpoint_saved": "checkpoint-2" in ckpt and ckpt_files == ["opt.pt", "state.pt", "trainer_state.json"]
        and saved == ["mm_projector", "region_extractor"],
        "launch_counts_every_step": len(record) == TRAIN_STEPS and all(r["launches"] == want_step for r in record),
        "first_loss_near_ln_vocab": math.isfinite(first_loss) and abs(first_loss - math.log(vocab)) < 1.0,
        "losses_finite": all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in record),
        "frozen_bit_unchanged": all(fingerprint(torch, getattr(model, n)) == f for n, f in frozen_before.items()),
        "tuned_unchanged_at_lr_0": bool(record) and not record[0]["tuned_changed"],
        "tuned_moved_after": len(record) == TRAIN_STEPS and record[-1]["tuned_changed"],
        "loss_vs_plain": loss_rel <= TRAIN_LOSS_REL_BOUND,
        "grads_vs_plain": grad_rel <= TRAIN_GRAD_REL_BOUND,
    }
    step_s = statistics.median(r["seconds"] for r in record[1:]) if len(record) > 1 else float("nan")
    emit({
        "phase": "train", "ok": all(checks.values()), "checks": checks,
        "model": "llama3-8b (32 layers, full width) + siglip-so400m (26 of 27 layers), bf16, random from seed 0",
        "stage": "align: frozen llm + vision tower, tuned mm_projector + region_extractor, lr 1e-3, remat, "
                 f"ce_chunk {CE_CHUNK}, attn_impl pallas",
        "batch": {"rows": TRAIN_ROWS, "seq": TRAIN_SEQ, "samples_per_row": TRAIN_SAMPLES_PER_ROW,
                  "regions": N_REGIONS, "images": TRAIN_ROWS * TRAIN_SAMPLES_PER_ROW, "rgb_and_depth": True},
        "launches": counts, "launches_expected_per_step": want_step, "steps": record,
        "first_loss": first_loss, "ln_vocab": math.log(vocab),
        "vs_plain_one_row": {"loss_rel": loss_rel, "loss_bound": TRAIN_LOSS_REL_BOUND,
                             "grad_rel_l2": grad_rel, "grad_bound": TRAIN_GRAD_REL_BOUND},
        "smoke_figures_not_a_benchmark": {
            "init_s": init_s, "step_s_median_after_first": step_s,
            "tokens_per_s": TRAIN_ROWS * TRAIN_SEQ / step_s, "peak_mem_gb": peak_gb,
        },
    })
    check(all(checks.values()), f"train checks failed: {checks}")
    if profile_dir:
        state = create_train_state(model, optimizer)
        profile_run(torch, lambda: step_fn(state, batch), profile_dir, "train_step")
    return counts


def demo_expected_counts(vlm_cfg, sam_cfg, da_cfg, n_images: int, chunk: int, hw):
    """The demo pipeline's launch counts, from its shapes, and K6's by stage.
    K6 is counted at every LayerNorm whose input passes
    ``ops/layers.py::layer_norm``'s gate (bf16, C % 128 == 0, at least 4096
    rows): per stage and site, the rows and width it normalizes."""
    from spatialrgpt_tpu_torch.models.depth_anything import resize_lower_bound_hw

    def gate(rows: int, c: int) -> int:
        return int(c % 128 == 0 and rows >= 4096)

    # Depth-Anything: norm1 + norm2 per layer over cls + patch tokens, and the
    # final norm at each selected layer
    oh, ow = resize_lower_bound_hw(*hw, 518, da_cfg.patch_size)
    da_rows = n_images * (1 + (oh // da_cfg.patch_size) * (ow // da_cfg.patch_size))
    depth = gate(da_rows, da_cfg.hidden_size) * (2 * da_cfg.num_hidden_layers + len(da_cfg.out_indices))
    # SAM-HQ per chunk of b images, 2 boxes (prompt rows) per image
    v, g, c = sam_cfg.vision, sam_cfg.image_embedding_size, sam_cfg.decoder_hidden_size
    chunks = [min(chunk, n_images - i) for i in range(0, n_images, chunk)]
    sam = 0
    for b in chunks:
        sam += gate(b * g * g, v.hidden_size) * 2 * v.num_hidden_layers  # ln1, ln2 (before windowing)
        sam += gate(b * g * g, v.output_channels) * 2  # neck
        # the mask decoder runs in f32 as the reference's does: the box
        # prompts' Fourier features are f32 and promote the tokens, and the
        # keys after the first image-to-token attention; only the HQ head's
        # norms over the bf16 image embedding and ViT features stay bf16
        sam += gate(2 * b * 4 * g * g, c // 4)  # HQ encoder norm
        sam += gate(2 * b * 4 * g * g, c)  # HQ compress-ViT norm
    # the VLM: SigLIP over [images; depths], the refinement's deconv norms,
    # the projector's norm (Llama's are RMSNorms)
    sv, r = vlm_cfg.vision, vlm_cfg.region
    side = sv.image_size // sv.patch_size
    layers_run = sv.num_hidden_layers + 1 + sv.select_layer
    vlm = gate(2 * n_images * side * side, sv.hidden_size) * 2 * layers_run
    vlm += sum(gate(n_images * (side * 2 ** (d + 1)) ** 2, r.mm_hidden_size) for d in range(r.deconv_depth - 1))
    vlm += gate(n_images * ((r.ada_pool_size + 1) // 2) ** 2, 4 * vlm_cfg.projector.mm_hidden_size)
    L = vlm_cfg.llm.num_hidden_layers
    counts = {
        "vit_attention": layers_run, "onepass_attention": L, "decode_attention_int8_flat": L * (MAX_NEW - 1),
        "flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
        "grid_bias_attention": len(v.global_attn_indexes) * len(chunks), "fused_layer_norm": depth + sam + vlm,
        **quant_expected_counts(vlm_cfg, n_images, PAD_BUCKET, MAX_NEW),  # the VLM is W8A8, as bench_demo.py's
    }
    return counts, {"depth": depth, "sam": sam, "vlm": vlm}


def phase_demo(torch, profile_dir=None) -> dict:
    import numpy as np

    from spatialrgpt_tpu_torch.demo import pipeline
    from spatialrgpt_tpu_torch.models import depth_anything as tda
    from spatialrgpt_tpu_torch.models.sam import SamConfig
    from spatialrgpt_tpu_torch.ops import layers
    from spatialrgpt_tpu_torch.utils.weights import (
        init_random,
        init_random_depth_anything,
        init_random_quantized,
        init_random_sam_hq,
    )

    dev = torch.device(DEVICE)
    cfg, scfg, dcfg = llama3_8b_cfg(), SamConfig(), tda.DepthAnythingConfig()  # llama3-8b, SAM-HQ vit_h, DA ViT-L
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    models = pipeline.DemoModels(
        depth=tda.DepthPredictor(init_random_depth_anything(dcfg, dev, torch.bfloat16, seed=2), dcfg),
        sam=init_random_sam_hq(scfg, dev, torch.bfloat16, seed=1), sam_cfg=scfg,
        vlm=init_random_quantized(cfg, dev, w8a8=True, seed=0), vlm_cfg=cfg,  # bench_demo.py:177
    )
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    h, w = DEMO_HW
    photos = np.stack([pipeline.synth_photo(rng, h, w) for _ in range(DEMO_IMAGES)])
    images = torch.as_tensor(photos, device=dev)
    boxes = torch.as_tensor(pipeline.demo_boxes(DEMO_IMAGES, h, w), device=dev)
    spliced = pipeline.demo_prompts(cfg, rng, DEMO_IMAGES)

    def run(impl):
        return pipeline.run_pipeline(models, images, boxes, spliced, MAX_NEW, attn_impl=impl, chunk=DEMO_SAM_CHUNK,
                                     sync=torch.cuda.synchronize)

    def depth_and_head():
        """Depth maps and the head's pre-relu output of the photos (all 8:
        Depth-Anything's rows pass K6's gate from 3 photos on)."""
        with torch.no_grad():
            px = models.depth.preprocess(images)
            return models.depth.depth(images), tda.head_logits(models.depth.model, px, dcfg)

    def vlm_stage(vlm, inputs, impl):
        return pipeline.stage_vlm(vlm, cfg, spliced, *inputs, MAX_NEW, attn_impl=impl)

    fused_before = layers.FUSED_LN
    try:
        layers.FUSED_LN = True
        run("onepass")  # warm-up: cuBLAS / cuDNN handles, allocator, every op of the path once
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out = run("onepass")
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        depth_k, head_k = depth_and_head()
        engine = pipeline.DemoEngine(pipeline.segment_boxes_fn(models.sam, scfg),
                                     pipeline.estimate_depth_fn(models.depth), generate=None)
        state = pipeline.DemoState()
        engine.set_image(state, photos[0])
        overlay = engine.add_regions(state, pipeline.demo_boxes(1, h, w)[0].tolist())
        # the W8A8 VLM as phase serve_w8a8 holds it: its projections against
        # their plain versions on the same inputs and attention kernels, bit
        # for bit at the first token; the VLM stage's attention kernels, on
        # each route's own depth and masks, as this phase held them before
        # the VLM was quantized: with init_random's bf16 weights
        with plain_projections():
            proj_plain = vlm_stage(models.vlm, out.vlm_inputs, "onepass")
        bf16_vlm = init_random(cfg, dev, torch.bfloat16, seed=0)
        vlm_k = vlm_stage(bf16_vlm, out.vlm_inputs, "onepass")
        layers.FUSED_LN = False
        with plain_projections():
            plain = run("xla")
        depth_p, head_p = depth_and_head()
        vlm_p = vlm_stage(bf16_vlm, plain.vlm_inputs, "xla")
        del bf16_vlm
        torch.cuda.empty_cache()
    finally:
        layers.FUSED_LN = fused_before

    want, by_stage = demo_expected_counts(cfg, scfg, dcfg, DEMO_IMAGES, DEMO_SAM_CHUNK, DEMO_HW)
    logits, ref = out.mask_logits, plain.mask_logits
    rms = float(ref.float().square().mean().sqrt())
    sure = ref.abs() > DEMO_MASK_MARGIN * rms
    mask_mismatch = int(((logits > 0) != (ref > 0))[sure].sum())
    depth_spread = float(depth_k.float().std())
    # a random relu head may output a constant map: then its input is compared
    depth_rel = rel_l2(depth_k, depth_p) if depth_spread > 0 else rel_l2(head_k, head_p)
    mask_rel = rel_l2(logits, ref)
    first_rel = rel_l2(vlm_k.first_logits, vlm_p.first_logits)
    vocab = cfg.llm.vocab_size + cfg.num_extra_tokens
    tokens, g = out.result.tokens, scfg.image_embedding_size * 4
    checks = {
        "colorized_shape": list(out.colorized.shape) == [DEMO_IMAGES, h, w, 3] and out.colorized.dtype == torch.uint8,
        "mask_logits_shape_finite": list(logits.shape) == [DEMO_IMAGES * 2, g, g] and bool(torch.isfinite(logits).all()),
        "tokens_shape_in_vocab": list(tokens.shape) == [DEMO_IMAGES, MAX_NEW] and bool(((tokens >= 0) & (tokens < vocab)).all()),
        "logits_finite": bool(torch.isfinite(out.result.first_logits).all()),
        "launch_counts": counts == want,
        "depth_vs_plain": depth_rel <= DEMO_DEPTH_REL_BOUND,
        "mask_logits_vs_plain": mask_rel <= DEMO_MASK_REL_BOUND,
        "masks_vs_plain_beyond_margin": mask_mismatch == 0,
        "first_logits_vs_plain": first_rel <= LOGITS_REL_BOUND,
        "vlm_first_logits_bit_equal_to_plain_projections": torch.equal(out.result.first_logits,
                                                                       proj_plain.first_logits),
        "engine_depth_and_masks": state.depth_colorized.shape == (h, w, 3) and len(state.region_masks) == 2
        and all(m.shape == (h, w) and m.dtype == np.uint8 for m in state.region_masks) and overlay.shape == (h, w, 3),
    }
    seconds = out.seconds
    emit({
        "phase": "demo", "ok": all(checks.values()), "checks": checks,
        "models": "Depth-Anything ViT-L (24 layers) + SAM-HQ vit_h (32 layers), bf16, + llama3-8b (32 layers) with "
                  "siglip-so400m (26 of 27 layers), W8A8, random from seeds 2 / 1 / 0; SRGPT_FUSED_LN on",
        "batch": {"images": DEMO_IMAGES, "hw": list(DEMO_HW), "boxes_per_image": 2, "sam_chunk": DEMO_SAM_CHUNK,
                  "prompt_bucket": PAD_BUCKET, "max_new_tokens": MAX_NEW},
        "launches": counts, "launches_expected": want, "fused_layer_norm_expected_by_stage": by_stage,
        "depth_spread_std": depth_spread, "depth_compared": "depth" if depth_spread > 0 else "head pre-relu",
        "depth_rel_l2_vs_plain": depth_rel, "depth_bound": DEMO_DEPTH_REL_BOUND,
        "mask_logits_rel_l2_vs_plain": mask_rel, "mask_bound": DEMO_MASK_REL_BOUND,
        "mask_margin_abs": DEMO_MASK_MARGIN * rms, "mask_pixels_beyond_margin": int(sure.sum()),
        "mask_mismatches_beyond_margin": mask_mismatch,
        "mask_pixels_positive_share": float((logits > 0).float().mean()),
        "first_logits_rel_l2_vs_plain": first_rel, "rel_bound": LOGITS_REL_BOUND,
        "first_logits_compared": "the VLM stage with init_random's bf16 weights, on each route's own depth and masks",
        "w8a8_first_logits_rel_l2_vs_whole_plain_route": rel_l2(out.result.first_logits, plain.result.first_logits),
        "tokens_agreement_vs_plain": float((tokens == plain.result.tokens).float().mean()),
        "smoke_figures_not_a_benchmark": {
            "init_s": init_s, "images_per_s": DEMO_IMAGES / sum(seconds.values()),
            # without the VLM, whose decode loop the host paces
            "vision_images_per_s": DEMO_IMAGES / (seconds["depth_s"] + seconds["sam_s"] + seconds["preprocess_s"]),
            **seconds,
            "plain_path_seconds": plain.seconds, "peak_mem_gb": peak_gb,
        },
    })
    check(all(checks.values()), f"demo checks failed: {checks}")
    if profile_dir:
        layers.FUSED_LN = True
        try:
            profile_run(torch, lambda: run("onepass"), profile_dir, "demo_pipeline")
        finally:
            layers.FUSED_LN = fused_before
    return counts


def profile_run(torch, fn, out_dir, name):
    """One warm call of ``fn`` under torch.profiler: device-busy share and
    the operator table by device time, written to ``out_dir/<name>_ops.txt``.
    Device time is summed over the device's own events (kernels, copies); an
    operator's "self device time" repeats the time of the kernels it
    launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the device's own events; a profiler range (a demo stage) also appears
    # on the device as a user annotation spanning its kernels
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in device)
    with open(os.path.join(out_dir, f"{name}_ops.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:25]
    emit({"phase": "profile", "ok": True, "run": name, "wall_s": wall, "device_busy_s": busy_us / 1e6,
          "device_idle_share": max(0.0, 1 - busy_us / 1e6 / wall),
          "top_kernels_ms_calls": {e.key[:120]: [e.self_device_time_total / 1e3, e.count] for e in top}})


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR", help="also profile a W8A8 serve TTFT and generate run, one align "
                        "step and one demo pipeline run; write their tables to DIR")
    args = parser.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "spatialrgpt_tpu_torch")):
        print("chip_smoke.py: run it from a checkout of the repository (spatialrgpt_tpu_torch/ is missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    phase = "device"
    try:
        smi = phase_device(torch)
        phase = "build"
        phase_build()
        phase = "kernels"
        rows = phase_kernels(torch)
        phase = "grads"
        phase_grads(torch)
        phase = "main"
        serve = phase_main(torch, smi)
        torch.cuda.empty_cache()
        phase = "serve_w8a8"
        serve_w8a8 = phase_serve_w8a8(torch, smi, args.profile)
        torch.cuda.empty_cache()
        phase = "train"
        train = phase_train(torch, args.profile)
        torch.cuda.empty_cache()
        phase = "demo"
        demo = phase_demo(torch, args.profile)
    except Exception as e:  # report which phase failed, then exit non-zero
        traceback.print_exc()
        emit({"phase": phase, "ok": False, "error": f"{type(e).__name__}: {e}"})
        return 1
    for row in rows:
        by_path = {"serve": serve[row["name"]], "serve_w8a8": serve_w8a8[row["name"]], "train": train[row["name"]],
                   "demo": demo[row["name"]]}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
