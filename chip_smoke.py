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
   prefill's gate and SigLIP's fc1 over the tower's 93,312 rows (ragged N
   4304 and K 1152; its large form) and at the decode's lm_head and gate
   (its decode form), K9 at the decode's down and k/v projections (its
   decode form) and on its large form at the QLoRA step's gate, down and
   k / v over 16,384 rows with the LoRA side branch's f32 addend, a
   4096-row chunk of its lm_head and an engine admission's down projection
   (1536 rows; each row names the form), K10 over the W8A8 align step's
   gate / up output gradient (16,384 x 14,336) and K11 at its gate / up
   and down dx (both launches; the transpose alone in ``transpose_ms``)
   (K7, K8, K10 and K11 must equal their plain versions bit for bit).  K1, K2, K5 and K4's three kernels run
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
   ``torch._int_mm``'s int32 product alone, for K11 the same in the
   faster of two layouts of the weight (as stored, and a column-major copy
   made beforehand; each layout's time in ``library_each_layout_ms``), for
   K9 ``F.linear`` on a bf16 copy of the weight); for K4 also
   ``library_per_sample_ms``, SDPA's flash backend with ``is_causal`` over
   the per-sample view of the same q/k/v (4 equal samples per row, checked),
   which computes only the live pairs, as K4 does.  All by CUDA events:
   around one replay of a CUDA graph of
   many calls where a call is shorter than its launch on the host (K1-K3,
   K6, K7, K9, K8 at decode), around many back-to-back calls for the
   kernels of milliseconds (K4, K5, K8 at prefill and tower rows); and ``bound_ms`` /
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
   engine -- the continuous-batching ``ServingEngine``: (a) on phase
   main's model, 16 requests through 8 slots in two waves of one
   admission each, every wave's greedy tokens equal to ``generate`` on its
   rows with the int8 cache (K3) and with the bf16 cache, the int8 run's
   first-token logits against the engine on the plain route; (b)
   bench_engine.py's configuration on serve_w8a8's W8A8 model: 32 slots,
   64 requests of 48-127 text tokens in the 384 bucket, 64 greedy tokens,
   windows of 8, admission width 8, all submitted at once after a warm-up;
   every request's 64 tokens, the launch counts of K1-K3 and K7-K9 worked
   out from the admissions and windows that ran (an admission of n
   requests prefills n x 384 rows: W8A8 throughout from n = 8, K9 for the
   contracting projections below), the cache's and the run's peak GB, and
   bench_engine.py's figures (tokens/s, wall, latency p50 / p95, scheduler
   syncs).
6. train   -- the stage-1 align step at the full width of llama3-8b and
   SigLIP-so400m (frozen decoder and tower, tuned projector and region
   extractor, lr 1e-3, remat, chunked CE over 1024 positions,
   ``attn_impl="pallas"``) on bench_train.py's batch (4 packed rows of
   4096 tokens, 4 samples per row, RGB + depth, 2 regions): the kernel
   path's loss and gradients against the plain path's on one row, then
   three ``Trainer`` steps with a checkpoint.  Checks the launch counts
   of every step, the first loss, that the frozen modules stay
   bit-unchanged and that the tuned ones move once the lr is above 0.
   align_w8a8 -- bench_train.py's SRGPT_TRAIN_BENCH_QUANT=1, then =2, on one
   model: the same align step over a W8A8 decoder and tower (quantized
   from init_random's bf16 weights), the bf16 straight-through dx, then
   the int8 dx on K10 + K11.  Per setting: the quantized route (K7, K8,
   K10, K11) against its plain versions on one row (loss bit-equal,
   gradients bit-equal where the route is deterministic), the cosine of
   the tuned gradients against the bf16 align step's (reported); under
   both, on the same W8A8 forward, the int8 dx against the bf16 STE's by
   depth (the cosine at the lm_head's input and at each decoder layer's
   input, with the int8 dx everywhere, in the decoder alone, in the
   lm_head alone; reported); three
   steps with the launch counts of K1, K4 and K7-K11 from the shapes, the
   frozen base bit-unchanged, the tuned modules moving; the median of
   steps 2-3, tokens/s and the steps' peak GB.
   qlora -- bench_train.py's qlora stage: int8 weight-only decoder and
   lm_head made in the int8 layout, bf16 tower, LoRA r 64 / alpha 16 on
   the seven projections (bf16 adapters, the side branch), projector and
   region extractor co-trained at lr 2e-5; the K9 route against its plain
   version on one row with every b drawn nonzero (so the side branch's
   addend is live), and two wrong routes (K9's sums in bf16, the addend
   dropped) that must fail the same comparison; three steps with the
   launch counts, the base
   bit-unchanged and the adapters, projector and region extractor moving;
   the same figures.
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
whole ``generate``, one wave of the engine's phase (b) (32 requests
through the 32 slots), one align step, one W8A8 align step under each
backward, one QLoRA step and one demo pipeline run with
``torch.profiler`` and writes their operator tables to DIR.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
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
# the engine phase: (b) is bench_engine.py's default configuration
# (bench_engine.py:31-38); (a) takes its windows of 8 and admission width 8
ENGINE_SLOTS, ENGINE_REQS, ENGINE_BUCKET, ENGINE_MAX_NEW, ENGINE_MULTI, ENGINE_ADMIT = 32, 64, 384, 64, 8, 8
ENGINE_TEXT_TOKENS = (48, 128)  # rng.integers' range of text tokens per request
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
BIT_EQUAL = {"act_quant_int8", "w8a8_gemm", "act_quant_dy_int8", "int8_dx_gemm"}


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


def per_rows(torch, fn, a, q, s, rows: int = 4096):
    """K11's plain version over slices of ``rows`` rows: its f32 product
    chunks stay a few hundred MB."""
    return torch.cat([fn(a[i:i + rows], q, s[i:i + rows]) for i in range(0, a.shape[0], rows)])


def dx_int_mm_library(torch, dyq, q):
    """K11's yardstick: ``torch._int_mm``'s int32 product dyq @ q alone (no
    gscale, no bf16 cast) in each layout of q that cuBLASLt takes: q as
    stored (row-major), and a column-major copy of q made here, outside the
    timing.  The loop times every layout and keeps the fastest."""
    label = "torch._int_mm(dyq, q): the int32 product alone, without K11's gscale and bf16 cast, the faster layout of q"
    layouts, refused = {}, []
    for name, b in (("q as stored", q), ("a column-major copy of q made beforehand", q.t().contiguous().t())):
        try:
            torch._int_mm(dyq, b)
            torch.cuda.synchronize()
        except RuntimeError as e:
            refused.append(f"{name}: {e}"[:150])
            continue
        layouts[name] = lambda b=b: torch._int_mm(dyq, b)
    if not layouts:
        return f"{label}; refused at this shape: {refused}"[:300], None
    return label, layouts


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

    # extra figures timed beside a case's kernel, by the case's index
    side_timings = {}
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
    vcfg = lcfg.vision
    m_tower = SERVE_ROWS * 2 * (vcfg.image_size // vcfg.patch_size) ** 2  # RGB + depth images of 729 patches
    for label, M, N, K, (iters, plain_iters, how) in (("prefill gate", m_pf, Id, Hd, (20, 2, "events")),
                                                     ("decode lm_head", SERVE_ROWS, Vd, Hd, (20, 2, "graph")),
                                                     ("decode gate", SERVE_ROWS, Id, Hd, (100, 10, "graph")),
                                                     ("siglip fc1", m_tower, vcfg.intermediate_size,
                                                      vcfg.hidden_size, (20, 2, "events"))):
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
    # K9 also on its large form: the QLoRA step's projections over 4 x 4096
    # rows (with the f32 addend that the LoRA side branch hands the epilogue
    # of each of them), a chunk of its lm_head's rows, and an engine
    # admission's down projection (4 x 384 rows)
    m_train = TRAIN_ROWS * TRAIN_SEQ
    for label, M, N, K, timing in (("decode down", SERVE_ROWS, Hd, Id, (100, 10, "graph")),
                                   ("decode k / v", SERVE_ROWS, kvd, Hd, (100, 10, "graph")),
                                   ("qlora train gate + LoRA addend", m_train, Id, Hd, (5, 1, "events")),
                                   ("qlora train down + LoRA addend", m_train, Hd, Id, (5, 1, "events")),
                                   ("qlora train k / v + LoRA addend", m_train, kvd, Hd, (20, 2, "events")),
                                   ("qlora lm_head chunk", 4 * 1024, Vd, Hd, (5, 1, "events")),
                                   ("engine admission down", 4 * 384, Hd, Id, (20, 2, "events"))):
        x9, q9, s9 = rn(M, K), i8(N, K), scales(N, K)
        add9 = torch.randn(M, N, generator=g, device=dev) * 0.25 if "LoRA addend" in label else None
        w9 = dequantize(q9, s9)  # bf16, made here for the library yardstick only
        form9 = "decode" if K789.w8_gemm_form(M) == K789.FORM_DECODE else "large"
        cases.append((
            "w8_gemm", "spatialrgpt_tpu_torch/csrc/int8_gemm.cu", "spatialrgpt_tpu/ops/layers.py:123 (XLA)",
            {"projection": label, "M": M, "N": N, "K": K, "f32_addend": add9 is not None, "form": form9},
            lambda x=x9, q=q9, s=s9, a=add9: K789.w8_gemm(x, q, s, add=a),
            lambda x=x9, q=q9, s=s9, a=add9: K789.w8_gemm_plain(x, q, s, add=a),
            timing, bound(2 * M * N * K, nbytes(x9, q9, s9) + 2 * M * N + (0 if add9 is None else nbytes(add9))),
            ("F.linear on the weight dequantized to bf16 beforehand" + ("" if add9 is None else ", without the addend"),
             lambda x=x9, w=w9: F.linear(x, w)),
        ))
    # K10-K11: the int8 backward of the W8A8 align step (bench_train.py's
    # SRGPT_TRAIN_BENCH_QUANT=2) over its 4 x 4096 rows: K10 over the gate /
    # up output gradient (the widest), K11 for gate / up (14,336 -> 4096) and
    # for down (4096 -> 14,336)
    dy10 = (torch.randn(m_train, Id, generator=g, device=dev) * 1e-3).to(torch.bfloat16)
    s10 = scales(Id, Hd)
    cases.append((
        "act_quant_dy_int8", "spatialrgpt_tpu_torch/csrc/act_quant.cu", "spatialrgpt_tpu/ops/layers.py:70 (XLA)",
        {"M": m_train, "N": Id}, lambda: K789.act_quant_dy_int8(dy10, s10),
        lambda: K789.act_quant_dy_int8_plain(dy10, s10), (20, 2, "events"),
        bound(8 * m_train * Id, nbytes(dy10, s10) + m_train * Id + 4 * m_train, PEAK_F32_FLOPS),
        ("no single call quantizes rows to int8 with a scale per row", None),
    ))
    for label, N, K in (("gate / up dx", Id, Hd), ("down dx", Hd, Id)):
        dyq11, q11 = i8(m_train, N), i8(N, K)
        gs11 = torch.rand(m_train, generator=g, device=dev) * 1e-4 + 1e-6
        # K11 is two launches: its row times both; its first alone beside them
        side_timings[len(cases)] = {"transpose_ms": lambda q=q11: K789.int8_transpose(q)}
        cases.append((
            "int8_dx_gemm", "spatialrgpt_tpu_torch/csrc/int8_dx_gemm.cu", "spatialrgpt_tpu/ops/layers.py:74 (XLA)",
            {"projection": label, "M": m_train, "N": N, "K": K},
            lambda a=dyq11, q=q11, s=gs11: K789.int8_dx_gemm(a, q, s),
            lambda a=dyq11, q=q11, s=gs11: per_rows(torch, K789.int8_dx_gemm_plain, a, q, s), (5, 1, "events"),
            bound(2 * m_train * N * K, nbytes(dyq11, q11, gs11) + 2 * m_train * K, PEAK_INT8_OPS),
            dx_int_mm_library(torch, dyq11, q11),
        ))

    rows = []
    library_bwd_ms = ps_bwd_ms = None
    for i_case, (name, source, replaces, shape, kernel, plain, (iters, plain_iters, how), work,
                 (library, lib_fn)) in enumerate(cases):
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
        library_each_ms = None
        plain_ms = timer(torch, plain, plain_iters)
        ms = timer(torch, kernel, iters)
        if lib_fn == "backward":  # K4's dK/dV and dQ share one figure
            if library_bwd_ms is None:
                library_bwd_ms = timer(torch, lib4_fwd_bwd, iters) - timer(torch, lib4_fwd, iters)
            library_ms = library_bwd_ms
        elif isinstance(lib_fn, dict):  # one call in several layouts: the fastest is the yardstick
            library_each_ms = {layout: timer(torch, fn, iters) for layout, fn in lib_fn.items()}
            library_ms = min(library_each_ms.values())
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
            "library_each_layout_ms": library_each_ms,
            "share_of_bound": work["bound_ms"] / ms,
            "library_over_kernel": library_ms / ms if library_ms is not None else None,
            "library_per_sample_ms": ps_ms, "library_per_sample": ps_label,
            "per_sample_library_over_kernel": ps_ms / ms if ps_ms is not None else None,
            "flops": work["flops"], "bytes": work["bytes"],
            "timing": timing.format(n=iters) + f" ({plain_iters} calls for the plain version)",
        }
        for key, fn in side_timings.get(i_case, {}).items():
            row[key] = timer(torch, fn, iters)
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


def draw_rows(cfg, rng, n_rows: int):
    """bench.py::build_batch's draws: ``n_rows`` prompts of bos + 8 text
    tokens + the image + 2 x (<mask>, <depth>) + the 96-token question, then
    random pixels, depths and region masks at the tower resolution."""
    import numpy as np

    from spatialrgpt_tpu_torch import IMAGE_TOKEN_INDEX

    rows = []
    for _ in range(n_rows):
        ids = (
            [1] + list(rng.integers(10, 1000, 8)) + [IMAGE_TOKEN_INDEX]
            + [cfg.mask_token_id, cfg.depth_token_id] * N_REGIONS
            + list(rng.integers(10, 1000, PROMPT_TEXT_TOKENS))
        )
        rows.append(np.asarray(ids, np.int64))
    size = cfg.vision.image_size
    pixels = (
        rng.standard_normal((n_rows, size, size, 3)).astype(np.float32),
        rng.standard_normal((n_rows, size, size, 3)).astype(np.float32),
        (rng.random((n_rows, N_REGIONS, size, size)) > 0.5).astype(np.float32),
        np.ones((n_rows, N_REGIONS), bool),
    )
    return rows, pixels


def splice(torch, cfg, rows, pixels, bucket: int = PAD_BUCKET, host_index_fields: bool = False):
    """Prompts spliced and padded to ``bucket`` with their pixels on the
    card in bf16: (VLMInputs, prompt lengths).  With ``host_index_fields``
    the token and index fields stay numpy arrays on the host, as a queued
    engine request holds them (bench_engine.py::make_request)."""
    from spatialrgpt_tpu_torch import NUM_TOKENS_PER_IMAGE, expand_rows
    from spatialrgpt_tpu_torch.models.vlm import VLMInputs

    sb = expand_rows(
        rows, None, max_len=cfg.model_max_length, tokens_per_image=NUM_TOKENS_PER_IMAGE,
        mask_token_id=cfg.mask_token_id, depth_token_id=cfg.depth_token_id,
        regions_per_image=N_REGIONS, pad_to=bucket,
    )
    inputs = VLMInputs.from_spliced(sb, *pixels, device=DEVICE, dtype=torch.bfloat16)
    if host_index_fields:
        inputs = inputs._replace(**{f: getattr(sb, f) for f in sb.__dataclass_fields__ if f != "labels"},
                                 labels=None, mask_valid=pixels[3])
    return inputs, torch.as_tensor(sb.segment_ids.sum(axis=1), device=DEVICE)


def build_batch(torch, cfg, rng, n_rows: int = N_ROWS):
    """bench.py::build_batch for the port: ``draw_rows`` padded to the 320
    bucket, pixels on the card."""
    return splice(torch, cfg, *draw_rows(cfg, rng, n_rows))


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


# no projection is quantized: K7-K11 launch no time
NO_QUANT = {"act_quant_int8": 0, "w8a8_gemm": 0, "w8_gemm": 0, "act_quant_dy_int8": 0, "int8_dx_gemm": 0}


def add_counts(*parts) -> dict:
    return {k: sum(p[k] for p in parts) for k in parts[0]}


def times(n: int, part: dict) -> dict:
    return {k: n * v for k, v in part.items()}


def quant_expected_counts(cfg, rows: int, bucket: int, max_new: int) -> dict:
    """K7-K9 launches of one W8A8 ``generate`` (llm and vision tower
    quantized): the prefill of ``rows`` rows, then ``max_new - 1`` decode
    steps of ``rows`` rows (``quant_phase_counts``)."""
    prefill, step = quant_phase_counts(cfg, rows, bucket, rows)
    return add_counts(prefill, times(max_new - 1, step))


def quant_group(m: int, *shapes) -> dict:
    """K7-K11 launches of the forward of sibling projections of (din, dout)
    ``shapes`` that read one x of ``m`` rows, by the reference's
    per-call-site rule (spatialrgpt_tpu/ops/layers.py:114-120): a weight
    takes int8 activations when it expands (in <= out) or at 2048 rows and
    more, else the int8 weight-only product (K9); the siblings that take
    W8A8 quantize x once (K7)."""
    a8 = [din <= dout or m >= 2048 for din, dout in shapes]
    return {**NO_QUANT, "act_quant_int8": int(any(a8)), "w8a8_gemm": sum(a8), "w8_gemm": len(a8) - sum(a8)}


def tower_layer_counts(cfg, m: int) -> dict:
    C, Iv = cfg.vision.hidden_size, cfg.vision.intermediate_size
    return add_counts(quant_group(m, (C, C), (C, C), (C, C)), quant_group(m, (C, C)), quant_group(m, (C, Iv)),
                      quant_group(m, (Iv, C)))


def decoder_layer_counts(cfg, m: int) -> dict:
    lc = cfg.llm
    H, I = lc.hidden_size, lc.intermediate_size
    q_out, kv_out = lc.num_attention_heads * lc.head_dim, lc.num_key_value_heads * lc.head_dim
    return add_counts(quant_group(m, (H, q_out), (H, kv_out), (H, kv_out)), quant_group(m, (q_out, H)),
                      quant_group(m, (H, I), (H, I)), quant_group(m, (I, H)))


def tower_layers(cfg) -> int:
    """The tower layers that run: up to the selected layer (-2: 26 of 27)."""
    return cfg.vision.num_hidden_layers + 1 + cfg.vision.select_layer


def quant_phase_counts(cfg, rows: int, bucket: int, decode_rows: int) -> tuple:
    """(K7-K11 launches of the prefill of ``rows`` rows of ``bucket``
    positions with their tower and lm_head, of one decode step of
    ``decode_rows`` rows), from the config (``quant_group``)."""
    v, lc = cfg.vision, cfg.llm
    tower_rows = 2 * rows * (v.image_size // v.patch_size) ** 2  # [images; depths]
    vocab = lc.vocab_size + cfg.num_extra_tokens
    lm_head = quant_group(rows, (lc.hidden_size, vocab))  # the last position of every row
    step = add_counts(times(lc.num_hidden_layers, decoder_layer_counts(cfg, decode_rows)),
                      quant_group(decode_rows, (lc.hidden_size, vocab)))
    prefill = add_counts(times(tower_layers(cfg), tower_layer_counts(cfg, tower_rows)),
                         times(lc.num_hidden_layers, decoder_layer_counts(cfg, rows * bucket)), lm_head)
    return prefill, step


def recomputed_layer_counts(cfg, m: int) -> dict:
    """A decoder layer's K7-K9 launches in remat's recompute: PyTorch's
    non-reentrant checkpoint stops once the backward's saved tensors are
    made again (its early stop), and the layer's tail, the down projection
    (whose backward keeps no tensor) and the residual add, is not run."""
    lc = cfg.llm
    down = quant_group(m, (lc.intermediate_size, lc.hidden_size))
    return {k: v - down[k] for k, v in decoder_layer_counts(cfg, m).items()}


def align_quant_counts(cfg, rows: int, int8_backward: bool) -> dict:
    """K7-K11 launches of one W8A8 align step (decoder and tower W8A8) over
    ``rows`` packed rows of TRAIN_SEQ tokens, remat, CE chunks of CE_CHUNK
    positions: the tower forward once; every decoder layer forward and
    recomputed (``recomputed_layer_counts``); the lm_head forward twice per
    chunk (the chunk's checkpoint); with ``int8_backward`` one K10 and one
    K11 per W8A8 projection's dx (each decoder projection, the lm_head per
    chunk)."""
    v, lc = cfg.vision, cfg.llm
    tower_rows = 2 * rows * TRAIN_SAMPLES_PER_ROW * (v.image_size // v.patch_size) ** 2
    m, chunks = rows * TRAIN_SEQ, TRAIN_SEQ // CE_CHUNK
    layer = decoder_layer_counts(cfg, m)
    lm_head = quant_group(rows * CE_CHUNK, (lc.hidden_size, lc.vocab_size + cfg.num_extra_tokens))
    fwd = add_counts(times(tower_layers(cfg), tower_layer_counts(cfg, tower_rows)),
                     times(lc.num_hidden_layers, add_counts(layer, recomputed_layer_counts(cfg, m))),
                     times(2 * chunks, lm_head))
    dx = lc.num_hidden_layers * layer["w8a8_gemm"] + chunks * lm_head["w8a8_gemm"] if int8_backward else 0
    return {**fwd, "act_quant_dy_int8": dx, "int8_dx_gemm": dx}


def qlora_quant_counts(cfg, rows: int) -> dict:
    """K7-K11 launches of one QLoRA step (int8 weight-only decoder and
    lm_head, bf16 tower): K9 for every decoder projection in the forward
    and all but the down projection in remat's recompute
    (``recomputed_layer_counts``), the lm_head twice per CE chunk; the
    weight-only dx is a plain product."""
    chunks = TRAIN_SEQ // CE_CHUNK
    return {**NO_QUANT, "w8_gemm": cfg.llm.num_hidden_layers * (7 + 6) + 2 * chunks}


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


# the running sum of K9_PLAIN_VARIANTS["bf16_sums"] is rounded to bf16 after
# every this many columns of k
BF16_SUM_COLUMNS = 128


@contextlib.contextmanager
def k9_plain_variant(torch, variant: str):
    """K9's plain version replaced inside the block by one of:
    ``regrouped``, the same function with its f32 sums in another order
    (the two halves of k summed apart, then added), as K9's own order
    differs from its plain version's; and two wrong routes, the controls
    that the QLoRA comparison must reject: ``bf16_sums``, the running sum
    held in bf16 (rounded after every ``BF16_SUM_COLUMNS`` columns of k),
    and ``no_addend``, the LoRA side branch's addend dropped from the
    forward."""
    from spatialrgpt_tpu_torch.ops import int8_linear

    before = int8_linear.w8_gemm_plain

    def regrouped(x, q, scale, bias=None, add=None):
        h = x.shape[1] // 2
        y = torch.matmul(x[:, :h].float(), q[:, :h].float().T) + torch.matmul(x[:, h:].float(), q[:, h:].float().T)
        return int8_linear.finish(y * scale, add, bias, x.dtype)

    def bf16_sums(x, q, scale, bias=None, add=None):
        y = torch.zeros(x.shape[0], q.shape[0], dtype=torch.bfloat16, device=x.device)
        for k0 in range(0, x.shape[1], BF16_SUM_COLUMNS):
            k = slice(k0, k0 + BF16_SUM_COLUMNS)
            y = (y.float() + torch.matmul(x[:, k].float(), q[:, k].float().T)).to(torch.bfloat16)
        return int8_linear.finish(y.float() * scale, add, bias, x.dtype)

    def no_addend(x, q, scale, bias=None, add=None):
        return before(x, q, scale, bias)

    int8_linear.w8_gemm_plain = {"regrouped": regrouped, "bf16_sums": bf16_sums, "no_addend": no_addend}[variant]
    try:
        yield
    finally:
        int8_linear.w8_gemm_plain = before


@contextlib.contextmanager
def dx_by_depth(torch, got: dict, lm_head_int8=None):
    """Inside the block, the gradient that reaches the decoder's final
    hidden states (``got["lm_head"]``, the lm_head's dx, chunks in order)
    and each decoder layer's input (``got[i]`` for layer i: the dx after
    L - i layers) is kept in ``got``.  With ``lm_head_int8`` set, the
    lm_head's forward reads it as the int8-backward switch, so that its dx
    alone takes that route.  Both checkpoints (llama.py's per layer,
    vlm.py's per CE chunk) are wrapped: a hook on each one's input."""
    from spatialrgpt_tpu_torch.models import llama, vlm
    from spatialrgpt_tpu_torch.ops import layers

    real_layer, real_chunk = llama.checkpoint, vlm.checkpoint
    chunks, n_layers = [], [0]

    def layer_checkpoint(fn, x, *args, **kw):
        x.register_hook(lambda g, i=n_layers[0]: got.__setitem__(i, g))
        n_layers[0] += 1
        return real_layer(fn, x, *args, **kw)

    def chunk_checkpoint(fn, h, *args, **kw):
        chunks.append(None)
        h.register_hook(lambda g, i=len(chunks) - 1: chunks.__setitem__(i, g))
        before = layers.INT8_BACKWARD
        layers.INT8_BACKWARD = before if lm_head_int8 is None else lm_head_int8
        try:
            return real_chunk(fn, h, *args, **kw)
        finally:
            layers.INT8_BACKWARD = before

    llama.checkpoint, vlm.checkpoint = layer_checkpoint, chunk_checkpoint
    try:
        yield
    finally:
        llama.checkpoint, vlm.checkpoint = real_layer, real_chunk
        got["lm_head"] = torch.cat(chunks, dim=1) if chunks and all(c is not None for c in chunks) else None


def dx_depth_witness(torch, cfg, model, batch, params) -> dict:
    """Where the int8 dx leaves the bf16 STE's direction, on the same W8A8
    forward (one row): per depth, the cosine and the norm ratio of the
    gradient at the lm_head's input and at each decoder layer's input,
    int8 route against the STE's, for the int8 dx everywhere, in the
    decoder with the lm_head's dx on the STE, and in the lm_head alone;
    and the tuned gradients' cosine for each."""
    from spatialrgpt_tpu_torch.ops import layers

    L = cfg.llm.num_hidden_layers

    def run(int8: bool, lm_head_int8=None):
        got = {}
        layers.enable_int8_backward(int8)
        try:
            with dx_by_depth(torch, got, lm_head_int8):
                _, g = loss_and_grads(torch, cfg, model, batch, params)
        finally:
            layers.enable_int8_backward(False)
        check(len(got) == L + 1 and got["lm_head"] is not None, "dx_by_depth: a hook did not fire")
        return [got["lm_head"]] + [got[i] for i in reversed(range(L))], g

    ref, g_ref = run(False)
    out = {"depths": ["lm_head dx"] + [f"after {n} layers" for n in range(1, L + 1)]}
    for name, route in (("int8_dx_everywhere", (True, None)), ("int8_dx_decoder_lm_head_ste", (True, False)),
                        ("int8_dx_lm_head_only", (False, True))):
        got, g = run(*route)
        out[name] = {
            "cosine_by_depth": [cosine(a.flatten(), b.flatten()) for a, b in zip(got, ref)],
            "norm_ratio_by_depth": [float(a.float().norm() / b.float().norm()) for a, b in zip(got, ref)],
            "tuned_grads_cosine": cosine(g, g_ref),
        }
        del got, g
    return out


def serve_runner(torch, cfg, model, n_rows: int):
    """``run(max_new, impl="onepass")``: region-QA ``generate`` of ``model``
    over ``n_rows`` rows of bench.py's batch, drawn from seed 0."""
    import numpy as np

    from spatialrgpt_tpu_torch.serving.generate import generate

    inputs, plens = build_batch(torch, cfg, np.random.default_rng(0), n_rows)

    def run(max_new, impl="onepass"):
        out = generate(model, cfg, inputs, plens, max_new_tokens=max_new, temperature=0.0,
                       eos_token_id=-1, attn_impl=impl, kv_quant=True)  # bench.py's SRGPT_BENCH_KV_INT8=1
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


def engine_request(torch, cfg, rng, n_text: int):
    """bench_engine.py::make_request for the port: bos + the image + 2 x
    (<mask>, <depth>) + ``n_text`` text tokens padded to the 384 bucket,
    pixels drawn as it draws them and staged on the card in bf16, the
    token and index fields on the host.  Returns (inputs, prompt length)."""
    import numpy as np

    from spatialrgpt_tpu_torch import IMAGE_TOKEN_INDEX

    ids = [1, IMAGE_TOKEN_INDEX] + [cfg.mask_token_id, cfg.depth_token_id] * N_REGIONS
    ids += list(rng.integers(10, 1000, n_text))
    size = cfg.vision.image_size
    pixels = (rng.standard_normal((1, size, size, 3)).astype(np.float32),
              rng.standard_normal((1, size, size, 3)).astype(np.float32),
              (rng.random((1, N_REGIONS, size, size)) > 0.5).astype(np.float32), np.ones((1, N_REGIONS), bool))
    inputs, plens = splice(torch, cfg, [np.asarray(ids, np.int64)], pixels, ENGINE_BUCKET, host_index_fields=True)
    return inputs, int(plens[0])


def record_engine(eng) -> dict:
    """Wrap an engine's admission prefill and decode window to record each
    admission's width and first-token logits and each window's steps."""
    log = {"admissions": [], "windows": [], "first_logits": []}
    prefill, window = eng._prefill_batch, eng._decode_window

    def prefill_recorded(inputs, *args):
        kv, toks, logits = prefill(inputs, *args)
        log["admissions"].append(int(inputs.input_ids.shape[0]))
        log["first_logits"].append(logits)
        return kv, toks, logits

    def window_recorded(k, *args):
        log["windows"].append(k)
        return window(k, *args)

    eng._prefill_batch, eng._decode_window = prefill_recorded, window_recorded
    return log


def engine_counts(cfg, log: dict, slots: int, bucket: int, quantized: bool, kv_quant: bool = True) -> dict:
    """The launches of an engine run from the admissions and windows it ran:
    K1 per tower layer and K2 per decoder layer at each admission, K3 per
    decoder layer and decode step, K7-K9 per admission prefill (its width x
    bucket rows) and per decode step of all the slots."""
    L, T = cfg.llm.num_hidden_layers, cfg.vision.num_hidden_layers + 1 + cfg.vision.select_layer
    n_adm, steps = len(log["admissions"]), sum(log["windows"])
    quant = NO_QUANT
    if quantized:
        step = quant_phase_counts(cfg, 1, bucket, slots)[1]
        prefills = [quant_phase_counts(cfg, n, bucket, slots)[0] for n in log["admissions"]]
        quant = add_counts(*prefills, times(steps, step))
    return {"vit_attention": T * n_adm, "onepass_attention": L * n_adm,
            "decode_attention_int8_flat": L * steps if kv_quant else 0,
            "flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
            "grid_bias_attention": 0, "fused_layer_norm": 0, **quant}


def engine_vs_lockstep(torch, cfg) -> dict:
    """(a) The engine against lockstep ``generate`` on phase main's model
    (bf16 weights, seed 0): 16 requests, phase main's rows of seeds 0 and 1,
    through N_ROWS slots (bucket 320, MAX_NEW tokens, windows of 8,
    admission width 8), all submitted at once: each wave of 8 is one
    admission and decodes in lockstep, the second in recycled slots.  Each
    wave's greedy tokens must equal ``generate`` on its 8 rows with the same
    kernels and capacity, with the int8 cache (K3) and with the bf16 cache
    (plain decode attention); the int8 run's first-token logits must lie
    within LOGITS_REL_BOUND of the same engine on K1-K3's plain versions."""
    import numpy as np

    from spatialrgpt_tpu_torch.serving.engine import ServingEngine
    from spatialrgpt_tpu_torch.serving.generate import generate
    from spatialrgpt_tpu_torch.utils.weights import init_random

    model = init_random(cfg, torch.device(DEVICE), torch.bfloat16, seed=0)
    waves = [draw_rows(cfg, np.random.default_rng(seed), N_ROWS) for seed in (0, 1)]
    requests = [splice(torch, cfg, [rows[i]], tuple(a[i : i + 1] for a in pixels), host_index_fields=True)
                for rows, pixels in waves for i in range(N_ROWS)]

    def engine_run(kv_quant: bool, impl: str):
        eng = ServingEngine(model, cfg, num_slots=N_ROWS, prompt_bucket=PAD_BUCKET, max_new_tokens=MAX_NEW,
                            attn_impl=impl, kv_quant=kv_quant, admit_width=N_ROWS)
        log = record_engine(eng)
        reset_counts()
        ids = [eng.submit(x, int(p[0]), max_new_tokens=MAX_NEW) for x, p in requests]
        done = {r.request_id: r.tokens for r in eng.run_until_drained(num_steps=ENGINE_MULTI)}
        torch.cuda.synchronize()
        counts = read_counts()
        return [done.get(i) for i in ids], log, counts, eng.capacity

    out, checks, logs = {}, {}, {}
    for kv_quant in (True, False):
        toks, log, counts, capacity = engine_run(kv_quant, "onepass")
        logs[kv_quant] = log
        want = engine_counts(cfg, log, N_ROWS, PAD_BUCKET, quantized=False, kv_quant=kv_quant)
        cache = "int8" if kv_quant else "bf16"
        equal_rows = 0
        for w, (rows, pixels) in enumerate(waves):
            inputs, plens = splice(torch, cfg, rows, pixels)
            ref = generate(model, cfg, inputs, plens, max_new_tokens=MAX_NEW, eos_token_id=-1, kv_quant=kv_quant)
            ref_toks = ref.tokens.tolist()
            equal_rows += sum(toks[w * N_ROWS + b] == ref_toks[b] for b in range(N_ROWS))
        checks[f"{cache}_tokens_equal_lockstep"] = equal_rows == 2 * N_ROWS
        checks[f"{cache}_one_admission_per_wave"] = log["admissions"] == [N_ROWS, N_ROWS]
        checks[f"{cache}_launch_counts"] = counts == want
        out[cache] = {"rows_equal_to_lockstep": equal_rows, "admissions": log["admissions"],
                      "windows": log["windows"], "capacity": capacity, "launches": counts,
                      "launches_expected": want, "first_tokens_request0": toks[0][:8] if toks[0] else None}
    _, plain_log, _, _ = engine_run(True, "xla")
    first = torch.cat(logs[True]["first_logits"])
    rel = rel_l2(first, torch.cat(plain_log["first_logits"]))
    checks["int8_first_logits_vs_plain"] = rel <= LOGITS_REL_BOUND
    out["int8_first_logits_rel_l2_vs_plain"] = rel
    out["int8_first_logits_finite"] = bool(torch.isfinite(first).all())
    checks["int8_first_logits_finite"] = out["int8_first_logits_finite"]
    del model
    torch.cuda.empty_cache()
    return checks, out


def engine_bench(torch, cfg, nvidia_smi: str, profile_dir=None) -> tuple:
    """(b) bench_engine.py's configuration on the main path's model:
    llama3-8b W8A8 llm and tower (``init_random_quantized``, as
    serve_w8a8), int8 KV, ``attn_impl="onepass"``; 32 slots, 64 requests
    of ``make_request``'s recipe (48-127 text tokens, ``default_rng(0)``),
    bucket 384, 64 greedy tokens, windows of 8, admission width 8, inputs
    staged on the card; one warm-up pass (bench_engine.py's: 15 requests of
    4 tokens, which admits at widths 8, 4, 2 and 1), then all 64 submitted
    at t0 and ``step(8)`` until they are done."""
    import numpy as np

    from spatialrgpt_tpu_torch.serving.engine import ServingEngine
    from spatialrgpt_tpu_torch.utils.weights import init_random_quantized

    t0 = time.perf_counter()
    model = init_random_quantized(cfg, torch.device(DEVICE), w8a8=True, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    reqs = [engine_request(torch, cfg, rng, int(rng.integers(*ENGINE_TEXT_TOKENS))) for _ in range(ENGINE_REQS)]
    eng = ServingEngine(model, cfg, num_slots=ENGINE_SLOTS, prompt_bucket=ENGINE_BUCKET, max_new_tokens=ENGINE_MAX_NEW,
                        kv_quant=True, admit_width=ENGINE_ADMIT, attn_impl="onepass")
    warm_reqs = reqs[: min(15, ENGINE_REQS)]
    for i, (x, plen) in enumerate(warm_reqs):
        eng.submit(x, plen, max_new_tokens=4, seed=i)
    warm = eng.run_until_drained(num_steps=ENGINE_MULTI)
    torch.cuda.synchronize()
    log = record_engine(eng)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    submit_t, finish_t = {}, {}
    for i, (x, plen) in enumerate(reqs):
        submit_t[eng.submit(x, plen, max_new_tokens=ENGINE_MAX_NEW, seed=i)] = time.perf_counter()
    done, n_syncs = [], 0
    while len(done) < ENGINE_REQS and n_syncs < 10 * ENGINE_REQS:
        fin = eng.step(ENGINE_MULTI)
        n_syncs += 1
        now = time.perf_counter()
        for r in fin:
            finish_t[r.request_id] = now
        done.extend(fin)
        if not eng.queue and not eng.active.any():
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cache_gb = sum(t.numel() * t.element_size() for t in eng.cache) / 1e9
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    want = engine_counts(cfg, log, ENGINE_SLOTS, ENGINE_BUCKET, quantized=True)
    vocab = cfg.llm.vocab_size + cfg.num_extra_tokens
    lat = sorted(finish_t[r.request_id] - submit_t[r.request_id] for r in done)
    total_tokens = sum(len(r.tokens) for r in done)
    checks = {
        "warm_up_drained": len(warm) == len(warm_reqs) and all(len(r.tokens) == 4 for r in warm),
        "all_requests_64_tokens": len(done) == ENGINE_REQS and all(len(r.tokens) == ENGINE_MAX_NEW for r in done),
        "tokens_in_vocab": all(0 <= t < vocab for r in done for t in r.tokens),
        "launch_counts": counts == want,
        "cache_fits": peak_gb < total_gb,
    }
    out = {
        "model": "llama3-8b (32 layers, full width) + siglip-so400m (26 of 27 layers), W8A8 llm and vision tower, "
                 "int8 KV, random from seed 0",
        "config": {"slots": ENGINE_SLOTS, "requests": ENGINE_REQS, "prompt_bucket": ENGINE_BUCKET,
                   "max_new_tokens": ENGINE_MAX_NEW, "num_steps": ENGINE_MULTI, "admit_width": ENGINE_ADMIT,
                   "text_tokens": [ENGINE_TEXT_TOKENS[0], ENGINE_TEXT_TOKENS[1] - 1], "capacity": eng.capacity,
                   "greedy": True, "prestaged_inputs": True},
        "admissions": log["admissions"], "windows": log["windows"], "launches": counts, "launches_expected": want,
        "cache_gb": cache_gb, "peak_mem_gb": peak_gb, "device_mem_gb": total_gb,
        "smoke_figures_not_a_benchmark": {
            "tok_s": total_tokens / wall, "wall_s": wall, "latency_p50_s": lat[len(lat) // 2] if lat else None,
            "latency_p95_s": lat[int(len(lat) * 0.95)] if lat else None,
            "n_scheduler_syncs": n_syncs + len(log["admissions"]), "total_tokens": total_tokens,
            "init_s": init_s, "card": nvidia_smi,
        },
    }
    if profile_dir:  # one wave: the first 32 requests through the 32 slots

        def wave():
            for i, (x, plen) in enumerate(reqs[:ENGINE_SLOTS]):
                eng.submit(x, plen, max_new_tokens=ENGINE_MAX_NEW, seed=i)
            eng.run_until_drained(num_steps=ENGINE_MULTI)
            torch.cuda.synchronize()

        profile_run(torch, wave, profile_dir, "engine_w8a8_wave")
    return checks, out, counts


def phase_engine(torch, nvidia_smi: str, profile_dir=None) -> dict:
    """The continuous-batching ``ServingEngine`` at the full width of
    llama3-8b: (a) ``engine_vs_lockstep``, (b) ``engine_bench``; eos at -1,
    so every request runs its full budget.  Returns (b)'s launch counts."""
    import dataclasses

    cfg = llama3_8b_cfg()
    cfg = cfg.replace(llm=dataclasses.replace(cfg.llm, eos_token_id=-1))
    checks_a, out_a = engine_vs_lockstep(torch, cfg)
    checks_b, out_b, counts = engine_bench(torch, cfg, nvidia_smi, profile_dir)
    checks = {**{f"a_{k}": v for k, v in checks_a.items()}, **{f"b_{k}": v for k, v in checks_b.items()}}
    emit({"phase": "engine", "ok": all(checks.values()), "checks": checks,
          "a_engine_vs_lockstep": {"model": "llama3-8b + siglip-so400m, bf16 weights from seed 0 (phase main's)",
                                   "slots": N_ROWS, "requests": 2 * N_ROWS, "prompt_bucket": PAD_BUCKET,
                                   "max_new_tokens": MAX_NEW, "num_steps": ENGINE_MULTI, **out_a},
          "b_bench_engine_config": out_b})
    check(all(checks.values()), f"engine checks failed: {checks}")
    return counts


def state_fingerprint(torch, module) -> list:
    """Per tensor of the module's state (parameters and buffers: int8
    weights and their scales too), the int64 sum of its bytes."""
    return [int(t.detach().reshape(-1).view(torch.uint8).sum(dtype=torch.int64)) for t in module.state_dict().values()]


def loss_and_grads(torch, cfg, model, batch, params, attn_impl: str = "pallas"):
    """The align-style loss on ``batch`` (remat, chunked CE) and the
    gradients of ``params`` concatenated in f32."""
    from spatialrgpt_tpu_torch.models import vlm

    for p in params:
        p.grad = None
    loss, _ = vlm.loss_fn(model, cfg, batch, attn_impl=attn_impl, remat=True, ce_chunk=CE_CHUNK)
    loss.backward()
    grads = torch.cat([p.grad.float().flatten() for p in params])
    for p in params:
        p.grad = None
    return loss.detach(), grads


def attention_train_counts(cfg) -> dict:
    """K1-K6 launches of one align-style step (remat): the frozen tower's
    forward, K4's forward twice per decoder layer and its backward once."""
    L = cfg.llm.num_hidden_layers
    return {"vit_attention": tower_layers(cfg), "onepass_attention": 0, "decode_attention_int8_flat": 0,
            "flash_attention_fwd": 2 * L, "flash_attention_bwd_dkv": L, "flash_attention_bwd_dq": L,
            "grid_bias_attention": 0, "fused_layer_norm": 0}


def phase_train(torch, profile_dir):
    import numpy as np

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
    tuned_params = [p for m in (model.mm_projector, model.region_extractor) for p in m.parameters()]
    compare = {impl: loss_and_grads(torch, cfg, model, one_row, tuned_params, impl) for impl in ("pallas", "xla")}
    loss_rel = abs(float(compare["pallas"][0]) - float(compare["xla"][0])) / abs(float(compare["xla"][0]))
    grad_rel = rel_l2(compare["pallas"][1], compare["xla"][1])
    del compare
    torch.cuda.empty_cache()

    frozen_before = {name: state_fingerprint(torch, getattr(model, name)) for name in ("llm", "vision_tower")}
    tuned = lambda: state_fingerprint(torch, model.mm_projector) + state_fingerprint(torch, model.region_extractor)  # noqa: E731
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

    want_step = {**attention_train_counts(cfg), **NO_QUANT}
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
        "frozen_bit_unchanged": all(state_fingerprint(torch, getattr(model, n)) == f for n, f in frozen_before.items()),
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


def cosine(a, b) -> float:
    return float((a.double() @ b.double()) / (a.double().norm() * b.double().norm()))


def run_steps(torch, step_fn, state, batch, moved, want_step):
    """TRAIN_STEPS steps of ``step_fn`` on ``batch``: per step the seconds
    (host clock around a synchronised step), loss, grad norm, whether the
    tuned modules have moved (``moved()``) and the kernels' launches."""
    record = []
    for _ in range(TRAIN_STEPS):
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = read_counts()
        launches = {n: after[n] - before[n] for n in after}
        record.append({"seconds": seconds, "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                       "num_tokens": int(metrics["num_tokens"]), "tuned_moved": moved(),
                       "launches_as_expected": launches == want_step, "launches": launches})
    return state, record


def step_figures(record, peak_gb) -> dict:
    """The median of steps 2-3 (the first carries the first calls' set-up),
    tokens/s at TRAIN_ROWS x TRAIN_SEQ tokens a step, the steps' peak."""
    step_s = statistics.median(r["seconds"] for r in record[1:])
    return {"step_s_median_of_steps_2_3": step_s, "tokens_per_s": TRAIN_ROWS * TRAIN_SEQ / step_s,
            "peak_mem_gb_steps": peak_gb}


# the int8 route's gradients against the plain route's on one row: the
# forward is deterministic (K7, K8 exact), so the loss must be bit-equal;
# the gradients too where the kernel route equals itself run twice, and
# otherwise within this many times its own run-to-run distance
RUN_TO_RUN_FACTOR = 2.0
# QLoRA's K9 route against its plain route: at most this many times the
# plain route's distance from itself with K9's sums regrouped
SUM_ORDER_FACTOR = 2.0


def phase_align_w8a8(torch, nvidia_smi: str, profile_dir=None) -> dict:
    """bench_train.py with SRGPT_TRAIN_BENCH_QUANT=1, then =2, on one model:
    the stage-1 align step over a W8A8 decoder and tower (``quantize_model``
    of ``init_random``'s bf16 weights, as bench_train.py quantizes its
    params), projector and region extractor trained at lr 1e-3, remat,
    CE chunks of 1024, pallas attention, on phase train's batch.  Each
    setting starts from the same projector and region extractor, as each
    is a run of its own of bench_train.py.  For each:
    (i) the quantized route (K7, K8; K10, K11 under =2) against its plain
    versions, attention kernels on in both, on one row: the loss bit-equal
    and the tuned gradients as ``RUN_TO_RUN_FACTOR`` says; (ii) reported
    without a bound: the cosine of the tuned gradients against the bf16
    align step's on the same row (the reference gates > 0.95 on
    trained-scale weights, tests/test_misc.py:278-320; random weights may
    be chaotic); (iii) reported without a bound: ``dx_depth_witness``, the
    int8 dx against the bf16 STE's by depth on the same forward; then
    three ``make_frozen_base_train_step`` steps with
    their launch counts worked out from the shapes, the frozen base
    bit-unchanged, the tuned modules moving once the lr is above 0."""
    import numpy as np

    from spatialrgpt_tpu_torch.ops import layers
    from spatialrgpt_tpu_torch.train.optimizer import OptimizerConfig, build_optimizer
    from spatialrgpt_tpu_torch.train.step import create_train_state, make_frozen_base_train_step
    from spatialrgpt_tpu_torch.utils.weights import init_random

    cfg = llama3_8b_cfg()
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    model = init_random(cfg, dev, torch.bfloat16, seed=0)
    ocfg = OptimizerConfig(learning_rate=1e-3, tune_language_model=False, tune_vision_tower=False,
                           tune_mm_projector=True, tune_region_extractor=True, total_steps=100)
    build_optimizer(model, ocfg)  # requires_grad on the tuned modules only
    tuned = [p for m in (model.mm_projector, model.region_extractor) for p in m.parameters()]
    n_proj = sum(p.numel() for p in model.mm_projector.parameters())
    rng = np.random.default_rng(0)
    batch = train_batch(torch, cfg, rng, TRAIN_ROWS)
    one_row = train_batch(torch, cfg, rng, 1)
    _, g_bf16 = loss_and_grads(torch, cfg, model, one_row, tuned)
    layers.quantize_model(model, bits=8, act_quant=True, vision=True)  # bench_train.py:199-204
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    frozen_before = {name: state_fingerprint(torch, getattr(model, name)) for name in ("llm", "vision_tower")}
    witness = dx_depth_witness(torch, cfg, model, one_row, tuned)
    torch.cuda.empty_cache()
    tuned_init = {name: {k: v.detach().clone() for k, v in getattr(model, name).state_dict().items()}
                  for name in ("mm_projector", "region_extractor")}
    results, counts_all, checks = {}, None, {}
    for quant in (1, 2):
        for name, state in tuned_init.items():  # each setting from the same start, as its own bench_train.py run
            getattr(model, name).load_state_dict(state)
        layers.enable_int8_backward(quant == 2)
        try:
            loss_k, g_k = loss_and_grads(torch, cfg, model, one_row, tuned)
            _, g_k2 = loss_and_grads(torch, cfg, model, one_row, tuned)
            with plain_projections():
                loss_p, g_p = loss_and_grads(torch, cfg, model, one_row, tuned)
            run_to_run = rel_l2(g_k2, g_k)
            vs_plain = rel_l2(g_k, g_p)
            optimizer = build_optimizer(model, ocfg)
            state = create_train_state(model, optimizer)
            step_fn = make_frozen_base_train_step(cfg, optimizer, attn_impl="pallas", remat=True, ce_chunk=CE_CHUNK)
            tuned_before = state_fingerprint(torch, model.mm_projector) + state_fingerprint(torch, model.region_extractor)
            moved = lambda: (state_fingerprint(torch, model.mm_projector)  # noqa: E731
                             + state_fingerprint(torch, model.region_extractor)) != tuned_before
            want_step = {**attention_train_counts(cfg), **align_quant_counts(cfg, TRAIN_ROWS, quant == 2)}
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            state, record = run_steps(torch, step_fn, state, batch, moved, want_step)
            counts = read_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            if profile_dir:
                profile_run(torch, lambda: step_fn(state, batch), profile_dir, f"align_w8a8_quant{quant}_step")
        finally:
            layers.enable_int8_backward(False)
        counts_all = counts if counts_all is None else add_counts(counts_all, counts)
        q_checks = {
            "loss_bit_equal_to_plain_route": torch.equal(loss_k, loss_p),
            "grads_vs_plain_route": vs_plain <= RUN_TO_RUN_FACTOR * run_to_run,
            "launch_counts_every_step": all(r["launches_as_expected"] for r in record),
            "int8_backward_kernels": all((r["launches"]["int8_dx_gemm"] > 0) == (quant == 2) for r in record),
            "losses_finite": all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in record),
            "tuned_unchanged_at_lr_0": not record[0]["tuned_moved"],
            "tuned_moved_after": record[-1]["tuned_moved"],
            "frozen_base_bit_unchanged": all(state_fingerprint(torch, getattr(model, n)) == f
                                             for n, f in frozen_before.items()),
        }
        checks.update({f"quant{quant}_{k}": v for k, v in q_checks.items()})
        results[f"SRGPT_TRAIN_BENCH_QUANT={quant}"] = {
            "checks": q_checks, "launches_expected_per_step": want_step, "steps": record,
            "vs_plain_route_one_row": {"loss_kernel": float(loss_k), "loss_plain": float(loss_p),
                                       "grad_rel_l2": vs_plain, "grad_rel_l2_kernel_route_run_to_run": run_to_run},
            "grad_cosine_vs_bf16_align_one_row_no_bound": {
                "all": cosine(g_k, g_bf16), "mm_projector": cosine(g_k[:n_proj], g_bf16[:n_proj]),
                "region_extractor": cosine(g_k[n_proj:], g_bf16[n_proj:])},
            "smoke_figures_not_a_benchmark": {**step_figures(record, peak_gb), "card": nvidia_smi},
        }
        del g_k, g_k2, g_p
        torch.cuda.empty_cache()
    emit({"phase": "align_w8a8", "ok": all(checks.values()), "checks": checks,
          "model": "llama3-8b (32 layers, full width) + siglip-so400m (26 of 27 layers), W8A8 llm and vision "
                   "tower quantized from init_random's bf16 weights (seed 0)",
          "stage": "align over a frozen W8A8 base: tuned mm_projector + region_extractor, lr 1e-3, remat, "
                   f"ce_chunk {CE_CHUNK}, attn_impl pallas (bench_train.py SRGPT_TRAIN_BENCH_QUANT=1, then =2)",
          "batch": {"rows": TRAIN_ROWS, "seq": TRAIN_SEQ, "samples_per_row": TRAIN_SAMPLES_PER_ROW,
                    "regions": N_REGIONS, "rgb_and_depth": True},
          "init_and_quantize_s": init_s, **results,
          "int8_dx_vs_bf16_ste_by_depth_one_row_no_bound": witness})
    check(all(checks.values()), f"align_w8a8 checks failed: {checks}")
    return counts_all


def phase_qlora(torch, nvidia_smi: str, profile_dir=None) -> dict:
    """bench_train.py's qlora stage at llama3-8b: an int8 weight-only
    decoder with its lm_head made straight into the int8 layout
    (``init_random_quantized(w8a8=False, vision_quant=False)``, no bf16
    copy of the decoder on the card), bf16 tower, LoRA r 64, alpha 16 on the
    seven projections, bf16 adapters, projector and region extractor
    co-trained, the default ``OptimizerConfig`` (lr 2e-5, total 100), remat,
    CE chunks of 1024, pallas attention, on phase train's batch.  The
    kernel route (K9) against the plain route (K9's plain version) on one
    row, with every b drawn nonzero for the comparison (b = 0 at init would
    make the side branch's addend zero), then set back to 0: the loss
    within phase train's 1%, and the trained gradients no farther from the
    plain route's than ``SUM_ORDER_FACTOR`` times the plain route's own
    distance when its K9 sums are regrouped (``k9_plain_variant``): K9 sums
    f32 in another order than its plain version, and through 32 layers of
    random uniform int8 weights a difference of summation order alone moves
    the gradients by a share that only a run can say (0.118 relative L2 in
    a first H100 run).  Two wrong routes run through the same comparison
    and must fail it: K9's sums held in bf16, and the addend dropped.  Then
    three ``make_lora_train_step`` steps with their launch counts, the base
    bit-unchanged, and only the adapters, projector and region extractor
    moving."""
    import numpy as np
    from torch import nn

    from spatialrgpt_tpu_torch.train.lora import LoraConfig, apply_lora, init_lora, replace_modules
    from spatialrgpt_tpu_torch.train.optimizer import OptimizerConfig, build_optimizer
    from spatialrgpt_tpu_torch.train.step import create_train_state, make_lora_train_step
    from spatialrgpt_tpu_torch.utils.weights import init_random_quantized

    cfg = llama3_8b_cfg()
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    model = init_random_quantized(cfg, dev, w8a8=False, seed=0, vision_quant=False)
    lcfg = LoraConfig(r=64, alpha=16.0)  # bench_train.py:152-157, the 8B row's bf16 adapters
    model.adapters = init_lora(model.llm, lcfg, torch.Generator(device=dev).manual_seed(1), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    trainable = nn.ModuleDict({"adapters": model.adapters, "mm_projector": model.mm_projector,
                               "region_extractor": model.region_extractor})
    optimizer = build_optimizer(trainable, OptimizerConfig(learning_rate=2e-5, total_steps=100))
    params = list(trainable.parameters())
    rng = np.random.default_rng(0)
    batch = train_batch(torch, cfg, rng, TRAIN_ROWS)
    one_row = train_batch(torch, cfg, rng, 1)
    view = replace_modules(model, {"llm": apply_lora(model.llm, model.adapters, lcfg, merge=False)})
    g_b = torch.Generator(device=dev).manual_seed(2)
    with torch.no_grad():  # b ~ N(0, 1 / r): the side branch ~ 15% of a projection's output
        for _, pair in model.adapters.items():
            pair.b.copy_(torch.randn(pair.b.shape, generator=g_b, device=dev) * lcfg.r**-0.5)
    loss_k, g_k = loss_and_grads(torch, cfg, view, one_row, params)
    routes = {}
    with plain_projections():
        loss_p, g_p = loss_and_grads(torch, cfg, view, one_row, params)
        for variant in ("regrouped", "bf16_sums", "no_addend"):
            with k9_plain_variant(torch, variant):
                loss_v, g_v = loss_and_grads(torch, cfg, view, one_row, params)
            routes[variant] = {"loss_rel": abs(float(loss_v) - float(loss_p)) / abs(float(loss_p)),
                               "grad_rel_l2": rel_l2(g_v, g_p)}
            del g_v
    with torch.no_grad():
        for _, pair in model.adapters.items():
            pair.b.zero_()
    del view
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    grad_rel, grad_bound = rel_l2(g_k, g_p), SUM_ORDER_FACTOR * routes["regrouped"]["grad_rel_l2"]
    del g_k, g_p
    torch.cuda.empty_cache()
    base_before = {name: state_fingerprint(torch, getattr(model, name)) for name in ("llm", "vision_tower")}
    parts_before = {name: state_fingerprint(torch, module) for name, module in trainable.items()}
    tuned_before = state_fingerprint(torch, trainable)
    state = create_train_state(model, optimizer)
    step_fn = make_lora_train_step(cfg, optimizer, lcfg, attn_impl="pallas", remat=True, ce_chunk=CE_CHUNK)
    want_step = {**attention_train_counts(cfg), **qlora_quant_counts(cfg, TRAIN_ROWS)}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state, record = run_steps(torch, step_fn, state, batch, lambda: state_fingerprint(torch, trainable) != tuned_before,
                              want_step)
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    checks = {
        "loss_vs_plain_route": loss_rel <= TRAIN_LOSS_REL_BOUND,
        "grads_vs_plain_route": grad_rel <= grad_bound,
        "control_bf16_sums_fails_the_comparison": routes["bf16_sums"]["grad_rel_l2"] > grad_bound,
        "control_no_addend_fails_the_comparison": routes["no_addend"]["grad_rel_l2"] > grad_bound,
        "launch_counts_every_step": all(r["launches_as_expected"] for r in record),
        "losses_finite": all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in record),
        "trained_unchanged_at_lr_0": not record[0]["tuned_moved"],
        "trained_moved_after": record[-1]["tuned_moved"],
        "adapters_projector_region_each_moved": all(state_fingerprint(torch, trainable[name]) != f
                                                    for name, f in parts_before.items()),
        "base_bit_unchanged": all(state_fingerprint(torch, getattr(model, n)) == f for n, f in base_before.items()),
        "no_float_decoder_weight": not any(isinstance(m, nn.Linear) for m in model.llm.modules()),
    }
    emit({"phase": "qlora", "ok": all(checks.values()), "checks": checks,
          "model": "llama3-8b (32 layers, full width): int8 weight-only decoder and lm_head made in the int8 layout "
                   "(init_random_quantized, seed 0) + siglip-so400m (26 of 27 layers) bf16",
          "stage": f"QLoRA: LoRA r {lcfg.r} alpha {lcfg.alpha} on {list(lcfg.targets)}, bf16 adapters "
                   f"({sum(p.numel() for p in model.adapters.parameters())} parameters), mm_projector + "
                   f"region_extractor co-trained, lr 2e-5, remat, ce_chunk {CE_CHUNK}, attn_impl pallas",
          "batch": {"rows": TRAIN_ROWS, "seq": TRAIN_SEQ, "samples_per_row": TRAIN_SAMPLES_PER_ROW,
                    "regions": N_REGIONS, "rgb_and_depth": True},
          "launches": counts, "launches_expected_per_step": want_step, "steps": record,
          "vs_plain_route_one_row": {"b": "drawn N(0, 1/r) for the comparison, then set back to 0",
                                     "loss_rel": loss_rel, "loss_bound": TRAIN_LOSS_REL_BOUND,
                                     "grad_rel_l2": grad_rel, "grad_bound": grad_bound,
                                     "plain_route_variants": routes,
                                     "bf16_sums_rounded_every_k_columns": BF16_SUM_COLUMNS},
          "smoke_figures_not_a_benchmark": {**step_figures(record, peak_gb), "init_s": init_s, "card": nvidia_smi}})
    check(all(checks.values()), f"qlora checks failed: {checks}")
    if profile_dir:
        profile_run(torch, lambda: step_fn(state, batch), profile_dir, "qlora_step")
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


def release(torch) -> None:
    """Between phases: free what the last phase left (its model may sit in
    a reference cycle until the collector runs), so that the next phase's
    peak memory counts only its own tensors."""
    gc.collect()
    torch.cuda.empty_cache()


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
    parser.add_argument("--profile", metavar="DIR", help="also profile a W8A8 serve TTFT and generate run, one wave "
                        "of the W8A8 engine, one align step, one W8A8 align step of each backward, one QLoRA step "
                        "and one demo pipeline run; write their tables to DIR")
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
        release(torch)
        phase = "serve_w8a8"
        serve_w8a8 = phase_serve_w8a8(torch, smi, args.profile)
        release(torch)
        phase = "engine"
        engine = phase_engine(torch, smi, args.profile)
        release(torch)
        phase = "train"
        train = phase_train(torch, args.profile)
        release(torch)
        phase = "align_w8a8"
        align_w8a8 = phase_align_w8a8(torch, smi, args.profile)
        release(torch)
        phase = "qlora"
        qlora = phase_qlora(torch, smi, args.profile)
        release(torch)
        phase = "demo"
        demo = phase_demo(torch, args.profile)
    except Exception as e:  # report which phase failed, then exit non-zero
        traceback.print_exc()
        emit({"phase": phase, "ok": False, "error": f"{type(e).__name__}: {e}"})
        return 1
    for row in rows:
        by_path = {"serve": serve[row["name"]], "serve_w8a8": serve_w8a8[row["name"]], "engine": engine[row["name"]],
                   "train": train[row["name"]], "align_w8a8": align_w8a8[row["name"]], "qlora": qlora[row["name"]],
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
