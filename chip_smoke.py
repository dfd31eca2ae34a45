"""Smoke run of the PyTorch + CUDA port (``spatialrgpt_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device  -- the card, its power limit, TF32 switched off for every
   comparison (float32 matmuls and cuDNN convolutions in full float32).
2. build   -- nvcc builds every kernel of ``spatialrgpt_tpu_torch/csrc``.
3. kernels -- each kernel against its plain PyTorch version at the main
   path's shapes, in bf16, with the max abs error, its ratio to the
   per-element bound of ``ops/_checks.py::bf16_err_over_bound`` (4 bf16
   ulps of the element plus of its row's largest value; at most 1
   passes), and the median time of both.
4. main    -- region-QA ``generate`` at the full width of llama3-8b (bf16
   weights from a fixed seed, made on the card; int8 KV cache), 8 rows of
   RGB + depth + 2 masks and a 320-token prompt bucket, 32 greedy tokens.
   Checks the tokens, the first- and last-step logits against the plain
   path run on the same weights (the last step in the rows whose tokens
   all equal the plain path's), and that each kernel's launch counter rose
   by what the path implies.  Its
   times are smoke figures of this card, not a benchmark.

Then the ``kernels`` line and, last, ``{"ok": true, "device": {...}}``.
Any failure exits non-zero before that line; so does a machine without a
CUDA card, and a directory without the port's package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
N_ROWS = 8
N_REGIONS = 2
PROMPT_TEXT_TOKENS = 96
PAD_BUCKET = 320
MAX_NEW = 32
# relative L2 distance allowed between the logits of the kernel path and of
# the plain path (first token, and last of the 32 steps): both run bf16
# through 26 ViT and 32 decoder layers, and each of the ~60 layers may round
# differently at bf16's 2^-8
LOGITS_REL_BOUND = 0.05


class SmokeFailure(Exception):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(torch, fn, reps: int = 5, iters: int = 10) -> float:
    """Median over ``reps`` timed runs of ``iters`` calls each, ms per call."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3 / iters)
    return statistics.median(runs)


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


def phase_build():
    from spatialrgpt_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.lib()
    emit({
        "phase": "build", "ok": True, "seconds": round(time.perf_counter() - t0, 3),
        "library": os.path.relpath(_build.build_info["path"], ROOT),
    })


def phase_kernels(torch):
    from spatialrgpt_tpu_torch.ops import decode_attention as K3
    from spatialrgpt_tpu_torch.ops import prefill_attention as K2
    from spatialrgpt_tpu_torch.ops import vit_attention as K1
    from spatialrgpt_tpu_torch.ops._checks import bf16_err_over_bound
    from spatialrgpt_tpu_torch.ops.quant import quantize_kv

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    cases = []
    # K1: the SigLIP tower over [images; depths] of 8 rows
    B, S, H, D = 2 * N_ROWS, 729, 16, 72
    q, k, v = rn(B, S, H, D), rn(B, S, H, D), rn(B, S, H, D)
    cases.append((
        "vit_attention", "spatialrgpt_tpu_torch/csrc/vit_attention.cu",
        "spatialrgpt_tpu/ops/vit_attention.py:196", {"B": B, "S": S, "H": H, "D": D},
        lambda: K1.vit_attention(q, k, v), lambda: K1.vit_attention_plain(q, k, v),
    ))
    # K2: llama3-8b prefill over the 320 bucket, right-padded rows
    B, S, Hq, Hk, D = N_ROWS, PAD_BUCKET, 32, 8, 128
    q2, k2, v2 = rn(B, S, Hq, D), rn(B, S, Hk, D), rn(B, S, Hk, D)
    seg = torch.zeros(B, S, dtype=torch.int32, device=dev)
    for b in range(B):
        seg[b, : S - 3 * b - 15] = 1
    cases.append((
        "onepass_attention", "spatialrgpt_tpu_torch/csrc/prefill_attention.cu",
        "spatialrgpt_tpu/ops/prefill_attention.py:228", {"B": B, "S": S, "Hq": Hq, "Hk": Hk, "D": D},
        lambda: K2.onepass_attention(q2, k2, v2, seg), lambda: K2.onepass_attention_plain(q2, k2, v2, seg),
    ))
    # K3: one decode step against the int8 cache of 320 + 32 slots
    B, C, Hq, Hk, D = N_ROWS, PAD_BUCKET + MAX_NEW, 32, 8, 128
    q3 = rn(B, Hq, D)
    kq, ks = quantize_kv(rn(B, C, Hk, D))
    vq, vs = quantize_kv(rn(B, C, Hk, D))
    kq, vq = kq.reshape(B, C, Hk * D), vq.reshape(B, C, Hk * D)
    lengths = torch.tensor([0, C - 1, 5, 63, 64, 200, 305, 330], dtype=torch.int32, device=dev)
    cases.append((
        "decode_attention_int8_flat", "spatialrgpt_tpu_torch/csrc/decode_attention.cu",
        "spatialrgpt_tpu/ops/decode_attention.py:174", {"B": B, "C": C, "Hq": Hq, "Hk": Hk, "D": D},
        lambda: K3.decode_attention_int8_flat(q3, kq, ks, vq, vs, lengths, Hk),
        lambda: K3.decode_attention_int8_flat_plain(q3, kq, ks, vq, vs, lengths, Hk),
    ))

    rows = []
    for name, source, replaces, shape, kernel, plain in cases:
        out = kernel()
        torch.cuda.synchronize()
        ref = plain()
        err = float((out.float() - ref.float()).abs().max())
        ratio = bf16_err_over_bound(out, ref)
        plain_ms = time_ms(torch, plain)
        ms = time_ms(torch, kernel)
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": err, "err_over_bound": ratio, "ms": ms, "plain_ms": plain_ms,
        }
        emit({"phase": "kernel", "ok": ratio <= 1.0, "shape": shape, **row})
        check(ratio <= 1.0, f"{name}: error {ratio} x the per-element bound (max abs err {err})")
        rows.append(row)
    return rows


def build_batch(torch, cfg, rng):
    """bench.py::build_batch for the port: bos + 8 text tokens + the image
    + 2 x (<mask>, <depth>) + the 96-token question, padded to the 320
    bucket; random pixels, depths and region masks at the tower
    resolution, drawn as bench.py draws them."""
    import numpy as np

    from spatialrgpt_tpu_torch import IMAGE_TOKEN_INDEX, NUM_TOKENS_PER_IMAGE, expand_rows
    from spatialrgpt_tpu_torch.models.vlm import VLMInputs

    rows = []
    for _ in range(N_ROWS):
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
        rng.standard_normal((N_ROWS, size, size, 3)).astype(np.float32),
        rng.standard_normal((N_ROWS, size, size, 3)).astype(np.float32),
        (rng.random((N_ROWS, N_REGIONS, size, size)) > 0.5).astype(np.float32),
        np.ones((N_ROWS, N_REGIONS), bool),
        device="cuda", dtype=torch.bfloat16,
    )
    return inputs, torch.as_tensor(sb.segment_ids.sum(axis=1), device="cuda")


def phase_main(torch, rows):
    import numpy as np

    from spatialrgpt_tpu_torch import preset
    from spatialrgpt_tpu_torch.ops import decode_attention as K3
    from spatialrgpt_tpu_torch.ops import prefill_attention as K2
    from spatialrgpt_tpu_torch.ops import vit_attention as K1
    from spatialrgpt_tpu_torch.serving.generate import generate
    from spatialrgpt_tpu_torch.utils.weights import init_random

    cfg = preset("llama3-8b")
    cfg = cfg.replace(
        mask_token_id=cfg.llm.vocab_size, depth_token_id=cfg.llm.vocab_size + 1, num_extra_tokens=8
    )
    t0 = time.perf_counter()
    model = init_random(cfg, torch.device("cuda"), torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    inputs, plens = build_batch(torch, cfg, np.random.default_rng(0))

    def run(max_new, impl="onepass"):
        out = generate(model, cfg, inputs, plens, max_new_tokens=max_new, temperature=0.0,
                       eos_token_id=-1, attn_impl=impl)
        torch.cuda.synchronize()
        return out

    run(2)  # warm-up: cuBLAS handles, allocator, every op of the path once

    mods = {"vit_attention": K1, "onepass_attention": K2, "decode_attention_int8_flat": K3}
    for m in mods.values():
        m.launches = 0
    t0 = time.perf_counter()
    res = run(MAX_NEW)
    e2e_s = time.perf_counter() - t0
    counts = {name: m.launches for name, m in mods.items()}

    ttfts = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(1)
        ttfts.append(time.perf_counter() - t0)
    ttft_s = statistics.median(ttfts)
    plain = run(MAX_NEW, impl="xla")

    L = cfg.llm.num_hidden_layers
    want = {
        "vit_attention": cfg.vision.num_hidden_layers + 1 + cfg.vision.select_layer,
        "onepass_attention": L,
        "decode_attention_int8_flat": L * (MAX_NEW - 1),
    }
    vocab = cfg.llm.vocab_size + cfg.num_extra_tokens
    tokens, first = res.tokens, res.first_logits

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm())

    rel = rel_l2(first, plain.first_logits)
    # the last step's logits hold K3 and the per-row cache scatter of the
    # timed run against the plain path, 31 decode steps on.  Greedy decoding
    # amplifies bf16 near-ties, so a row may pick another token somewhere
    # and then sees other inputs; only rows whose 32 tokens are all equal
    # saw the same inputs at every step, and at least half must be such
    same = (tokens == plain.tokens).all(dim=1)
    n_same = int(same.sum())
    rel_last = rel_l2(res.last_logits[same], plain.last_logits[same]) if n_same else float("inf")
    tokens_agree = float((tokens == plain.tokens).float().mean())
    checks = {
        "tokens_shape": list(tokens.shape) == [N_ROWS, MAX_NEW],
        "tokens_in_vocab": bool(((tokens >= 0) & (tokens < vocab)).all()),
        "logits_finite": bool(torch.isfinite(first).all() and torch.isfinite(res.last_logits).all()),
        "launch_counts": counts == want,
        "first_logits_vs_plain": rel <= LOGITS_REL_BOUND,
        "last_logits_vs_plain": 2 * n_same >= N_ROWS and rel_last <= LOGITS_REL_BOUND,
    }
    emit({
        "phase": "main", "ok": all(checks.values()), "checks": checks,
        "model": "llama3-8b (32 layers, full width) + siglip-so400m (26 of 27 layers)",
        "rows": N_ROWS, "prompt_bucket": PAD_BUCKET, "max_new_tokens": MAX_NEW,
        "launches": counts, "launches_expected": want,
        "first_logits_rel_l2_vs_plain": rel, "last_logits_rel_l2_vs_plain": rel_last,
        "rel_bound": LOGITS_REL_BOUND, "tokens_agreement_vs_plain": tokens_agree,
        "rows_with_all_tokens_equal": n_same,
        "last_logits_rel_l2_per_row": [rel_l2(res.last_logits[b], plain.last_logits[b]) for b in range(N_ROWS)],
        "smoke_figures_not_a_benchmark": {
            "init_s": init_s, "ttft_s": ttft_s, "e2e_s": e2e_s, "tok_s": N_ROWS * MAX_NEW / e2e_s,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        },
        "first_tokens_row0": tokens[0, :8].tolist(),
    })
    check(all(checks.values()), f"main path checks failed: {checks}")
    for row in rows:
        row["launches"] = counts[row["name"]]


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "spatialrgpt_tpu_torch")):
        print("chip_smoke.py: run it from a checkout of the repository (spatialrgpt_tpu_torch/ is missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    phase = "device"
    try:
        phase_device(torch)
        phase = "build"
        phase_build()
        phase = "kernels"
        rows = phase_kernels(torch)
        phase = "main"
        phase_main(torch, rows)
    except Exception as e:  # report which phase failed, then exit non-zero
        traceback.print_exc()
        emit({"phase": phase, "ok": False, "error": f"{type(e).__name__}: {e}"})
        return 1
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
