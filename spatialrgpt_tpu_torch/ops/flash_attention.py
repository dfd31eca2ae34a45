"""K4: FlashAttention-2 forward and backward for packed-segment causal GQA
with an optional sliding window (the training step's attention), and K5:
SAM's grid-bias attention (end of the file).

Port of the Pallas kernels of
``spatialrgpt_tpu/ops/flash_attention.py::flash_attention`` (``_fwd`` and
the two backward kernels of ``_flash_bwd``); the CUDA kernels are launched
from ``csrc/flash_attention_sm90.cu``: the forward on the Hopper main loop
of ``csrc/attention_sm90.cuh``, dQ and dK/dV on its query- and
key-stationary loops.  Layout (B, S, H, D), causal within packed segments
(``segment_ids`` (B, S), 0 = padding), GQA, scale D^-0.5; with ``window``,
key j is live for query i only if i - j < window (the reference's meaning).

``flash_attention`` is differentiable through ``FlashAttention``, an
``autograd.Function`` whose forward saves ``(q, k, v, out, lse)`` as
``_flash_fwd`` does and whose backward runs the dK/dV and dQ kernels.  Each
kernel wrapper (``flash_attention_fwd``, ``flash_attention_bwd_dkv``,
``flash_attention_bwd_dq``) launches its kernel for CUDA tensors and takes
its plain version only for CPU tensors.  ``launches`` counts kernel
launches per kernel.  ``delta = rowsum(dO * O)`` is a plain reduction on
both routes, as the reference computes it in XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from spatialrgpt_tpu_torch.ops import _build
from spatialrgpt_tpu_torch.ops._checks import FOLD_ROWS, SM90_MAX_HEAD_DIM, check_bshd, check_dtype

NEG_INF = -1e30
# each of K4's CTAs lists at most 1024 tiles of 64 positions (key tiles for
# the forward and dQ, query tiles for dK/dV: csrc/attention_sm90.cuh::
# MAX_TILES, DQ_BN, DKV_BQ)
MAX_SEQ = 1024 * 64

# kernel launches since the last reset (plain-path calls do not count)
launches = {"flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0}


# ---------------------------------------------------------------------------
# plain versions: the FlashAttention-2 formulas of the Pallas kernels
# ---------------------------------------------------------------------------


def _check_window(name: str, window: Optional[int]) -> None:
    if window is not None and window < 1:
        raise ValueError(f"{name}: window {window} < 1")


def _live(segment_ids: torch.Tensor, window: Optional[int] = None) -> torch.Tensor:
    """(B, 1, 1, S, S) bool: key j is live for query i iff both lie in the
    same nonzero segment, j <= i and (no window or i - j < window)."""
    _check_window("flash_attention", window)
    s = segment_ids.shape[1]
    same = (segment_ids[:, :, None] == segment_ids[:, None, :]) & (segment_ids[:, :, None] != 0)
    i = torch.arange(s, device=segment_ids.device)
    ok = i[:, None] >= i[None, :]
    if window is not None:
        ok &= (i[:, None] - i[None, :]) < window
    return (same & ok)[:, None, None]


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """f32 scaled scores (B, Hk, G, S, S); query head h = hk * G + g."""
    b, s, hq, d = q.shape
    hk = k.shape[2]
    return torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(b, s, hk, hq // hk, d).float(), k.float()) * d**-0.5


def flash_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, segment_ids: torch.Tensor, window: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, S, Hq, D) in q's dtype, lse (B, Hq, S) f32): softmax over the
    live keys with P rounded to the value dtype before PV; a row with no
    live key gives zeros and lse = NEG_INF (flash_attention.py:216-223)."""
    b, s, hq, d = q.shape
    live = _live(segment_ids, window)
    scores = torch.where(live, _scores(q, k), NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    lse = torch.where(l > 0, m + torch.log(l), NEG_INF)
    probs = (p / torch.where(l > 0, l, 1.0)).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v.float()).reshape(b, s, hq, d)
    return out.to(q.dtype), lse[..., 0].reshape(b, hq, s)


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, (B, S, Hq) (flash_attention.py:675)."""
    return (dout.float() * out.float()).sum(dim=-1)


def _probs_and_ds(q, k, v, segment_ids, lse, delta, dout, window=None):
    """P = exp(S - lse) on live pairs and dS = P (dP - delta) scale, both
    f32 (B, Hk, G, S, S)."""
    b, s, hq, d = q.shape
    hk = k.shape[2]
    g = hq // hk
    live = _live(segment_ids, window)
    lse_g = lse.reshape(b, hk, g, s)[..., None]
    p = torch.exp(torch.where(live, _scores(q, k) - lse_g, -torch.inf))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dout.reshape(b, s, hk, g, d).float(), v.float())
    delta_g = delta.reshape(b, s, hk, g).permute(0, 2, 3, 1)[..., None]
    return p, p * (dp - delta_g) * d**-0.5


def _group_sum(per_head: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, S, Hk, G, D) f32 per query head -> (B, S, Hk, D): each head
    rounded to ``dtype`` before the group sum, as the reference sums its
    per-head kernel outputs (flash_attention.py:738-741)."""
    return per_head.to(dtype).float().sum(dim=3).to(dtype)


def flash_attention_bwd_dkv_plain(
    q, k, v, segment_ids, lse, delta, dout, window: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) (B, S, Hk, D): dV = P^T dO and dK = dS^T Q per query head,
    P and dS rounded to the input dtype first, summed over the group."""
    b, s, hq, d = q.shape
    hk = k.shape[2]
    p, ds = _probs_and_ds(q, k, v, segment_ids, lse, delta, dout, window)
    dv = torch.einsum("bhgqk,bqhgd->bkhgd", p.to(q.dtype).float(), dout.reshape(b, s, hk, hq // hk, d).float())
    dk = torch.einsum("bhgqk,bqhgd->bkhgd", ds.to(q.dtype).float(), q.reshape(b, s, hk, hq // hk, d).float())
    return _group_sum(dk, k.dtype), _group_sum(dv, v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, segment_ids, lse, delta, dout, window: Optional[int] = None) -> torch.Tensor:
    """dQ (B, S, Hq, D) = dS K, dS rounded to the input dtype first."""
    b, s, hq, d = q.shape
    _, ds = _probs_and_ds(q, k, v, segment_ids, lse, delta, dout, window)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds.to(q.dtype).float(), k.float())
    return dq.reshape(b, s, hq, d).to(q.dtype)


def flash_attention_bwd_plain(q, k, v, segment_ids, out, lse, dout, window: Optional[int] = None):
    """(dq, dk, dv): the two backward kernels' plain versions."""
    delta = attention_delta(out, dout)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, segment_ids, lse, delta, dout, window)
    return flash_attention_bwd_dq_plain(q, k, v, segment_ids, lse, delta, dout, window), dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, q, k, v, segment_ids, window, extra=(), fold: bool = False) -> None:
    """What the kernels take: bf16 (B, S, H, D) q/k/v read through strides,
    Hk dividing Hq (and, for the forward's and dQ's head fold, Hq/Hk
    dividing 128), S <= MAX_SEQ, D <= 128, a window >= 1 or none; int32
    (B, S) segment ids and the f32 side tensors contiguous; all on one CUDA
    card (checked last)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)} / k {tuple(k.shape)}: Hk must divide Hq")
    if fold and FOLD_ROWS % (q.shape[2] // k.shape[2]):
        raise ValueError(f"{name}: Hq/Hk = {q.shape[2] // k.shape[2]} must divide {FOLD_ROWS}")
    if q.shape[1] > MAX_SEQ:
        raise ValueError(f"{name}: S = {q.shape[1]} > {MAX_SEQ}, the most tiles a CTA lists")
    _check_window(name, window)
    check_dtype(name, torch.int32, segment_ids)
    B, S, Hq, _ = q.shape
    if segment_ids.shape != (B, S) or not segment_ids.is_contiguous():
        raise ValueError(f"{name}: segment_ids must be a contiguous (B, S) = {(B, S)}, got {tuple(segment_ids.shape)}")
    for t, dtype, shape in extra:
        check_dtype(name, dtype, t)
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {shape} {dtype}, got {tuple(t.shape)}")
    check_bshd(name, q, k, v)
    if any(t.device != q.device for t in (segment_ids, *(e[0] for e in extra))):
        raise ValueError(f"{name}: all tensors must be on {q.device}")


def _window_arg(window: Optional[int]) -> int:
    return 0 if window is None else int(window)


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, segment_ids: torch.Tensor, window: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, S, Hq, D), lse (B, Hq, S) f32); K4's forward kernel on the card."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, segment_ids, window)
    _check("flash_attention_fwd", q, k, v, segment_ids, window, fold=True)
    B, S, Hq, D = q.shape
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    err = _build.lib().srgpt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, S, Hq, k.shape[2], D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        _window_arg(window), D**-0.5, _build.stream_ptr(q),
    )
    _build.check(err, "flash_attention_fwd")
    launches["flash_attention_fwd"] += 1
    return out, lse


def _bwd_args(name, q, k, v, segment_ids, lse, delta, dout, window, fold):
    B, S, Hq, D = q.shape
    if dout.stride(3) != 1 or any(s % 8 for s in dout.stride()[:3]):
        dout = dout.contiguous()
    check_dtype(name, q.dtype, dout)
    if dout.shape != q.shape:
        raise ValueError(f"{name}: dout {tuple(dout.shape)} must match q {tuple(q.shape)}")
    _check(name, q, k, v, segment_ids, window, fold=fold,
           extra=((lse, torch.float32, (B, Hq, S)), (delta, torch.float32, (B, S, Hq))))
    if dout.device != q.device or dout.data_ptr() % 16:
        raise ValueError(f"{name}: dout must lie 16-byte aligned on {q.device}")
    ptrs = [t.data_ptr() for t in (q, k, v, dout, lse, delta, segment_ids)]
    dims = [B, S, Hq, k.shape[2], D]
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *dout.stride()[:3]]
    return ptrs, dims, strides + [_window_arg(window), D**-0.5, _build.stream_ptr(q)]


def flash_attention_bwd_dkv(
    q, k, v, segment_ids, lse, delta, dout, window: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) (B, S, Hk, D); K4's dK/dV kernel on the card."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, segment_ids, lse, delta, dout, window)
    name = "flash_attention_bwd_dkv"
    ptrs, dims, rest = _bwd_args(name, q, k, v, segment_ids, lse, delta, dout, window, fold=False)
    dk, dv = torch.empty_like(k, memory_format=torch.contiguous_format), torch.empty_like(v, memory_format=torch.contiguous_format)
    err = _build.lib().srgpt_flash_bwd_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), *dims, *rest)
    _build.check(err, name)
    launches[name] += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, segment_ids, lse, delta, dout, window: Optional[int] = None) -> torch.Tensor:
    """dQ (B, S, Hq, D); K4's dQ kernel on the card."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, segment_ids, lse, delta, dout, window)
    name = "flash_attention_bwd_dq"
    ptrs, dims, rest = _bwd_args(name, q, k, v, segment_ids, lse, delta, dout, window, fold=True)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    err = _build.lib().srgpt_flash_bwd_dq(*ptrs, dq.data_ptr(), *dims, *rest)
    _build.check(err, name)
    launches[name] += 1
    return dq


class FlashAttention(torch.autograd.Function):
    """Forward saves (q, k, v, out, lse) as the reference's ``_flash_fwd``;
    backward runs delta, then the dK/dV and the dQ kernels."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, window):
        out, lse = flash_attention_fwd(q, k, v, segment_ids, window)
        ctx.save_for_backward(q, k, v, segment_ids, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, segment_ids, out, lse = ctx.saved_tensors
        delta = attention_delta(out, dout)
        dk, dv = flash_attention_bwd_dkv(q, k, v, segment_ids, lse, delta, dout, ctx.window)
        dq = flash_attention_bwd_dq(q, k, v, segment_ids, lse, delta, dout, ctx.window)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, S, Hk, D)
    v: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,  # (B, S); 0 = padding
    window: Optional[int] = None,  # sliding window: key j is live for query i only if i - j < window
) -> torch.Tensor:
    """Causal flash attention within packed segments; differentiable.
    Padding rows (segment id 0) return zeros."""
    if segment_ids is None:
        segment_ids = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    out = FlashAttention.apply(q, k, v, segment_ids.to(torch.int32).contiguous(), window)
    return out * (segment_ids != 0)[:, :, None, None].to(out.dtype)


# ---------------------------------------------------------------------------
# K5: attention with SAM ViT-det's decomposed 2-D rel-pos bias, forward only
# (grid_bias_attention, csrc/grid_bias_attention.cu on the Hopper main loop of
# csrc/attention_sm90.cuh: head dims up to 80, grids up to 64 x 64)
# ---------------------------------------------------------------------------

grid_bias_launches = 0  # K5 kernel launches since the last reset
GRID_BIAS_MAX_GRID = 64  # csrc/attention_sm90.cuh::BIAS_LD: rel_h / rel_w rows in shared memory


def grid_bias_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor, grid_w: int
) -> torch.Tensor:
    """The Pallas kernel's function in plain PyTorch, as XLA runs it in the
    reference: dense f32 scores ``q.k * D^-0.5 + rel_h[q, k // gw] +
    rel_w[q, k % gw]`` (the bias added after the scaling, as HF builds it
    from the unscaled q), one f32 softmax, the probabilities cast to the
    value dtype, then PV.  (B, S, H, D) -> (B, S, H, D)."""
    B, S, H, D = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * D**-0.5
    s = (s.view(B, H, S, S // grid_w, grid_w) + rel_h.float()[..., None] + rel_w.float()[..., None, :]).view(B, H, S, S)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1).to(v.dtype), v)


def grid_bias_attention(
    q: torch.Tensor,  # (B, S, H, D) over a flattened gh x gw token grid
    k: torch.Tensor,
    v: torch.Tensor,
    rel_h: torch.Tensor,  # (B, H, S, gh) f32: query x key-row bias
    rel_w: torch.Tensor,  # (B, H, S, gw) f32: query x key-column bias
    grid_w: int,  # gw: keys per grid row (k = kh * gw + kw)
) -> torch.Tensor:
    """SAM's global-layer attention with the decomposed rel-pos bias; K5 on
    the card.  Forward only, as the reference (which SAM's demo never
    differentiates): an input that requires grad raises rather than losing
    its gradient."""
    name = "grid_bias_attention"
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, rel_h, rel_w)):
        raise RuntimeError(f"{name} is forward only: run it under torch.no_grad() or on detached inputs")
    if q.device.type == "cpu":
        return grid_bias_attention_plain(q, k, v, rel_h, rel_w, grid_w)
    if k.shape != q.shape:
        raise ValueError(f"{name}: k/v shape {tuple(k.shape)} != q shape {tuple(q.shape)}")
    B, S, H, D = q.shape
    if grid_w <= 0 or S % grid_w:
        raise ValueError(f"{name}: grid_w {grid_w} must divide S {S}")
    gh = S // grid_w
    if gh > GRID_BIAS_MAX_GRID or grid_w > GRID_BIAS_MAX_GRID:
        raise ValueError(f"{name}: grid {gh} x {grid_w}: the kernel takes at most {GRID_BIAS_MAX_GRID} per side")
    if D > SM90_MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {D} > {SM90_MAX_HEAD_DIM}, the kernel's widest")
    for t, shape in ((rel_h, (B, H, S, gh)), (rel_w, (B, H, S, grid_w))):
        check_dtype(name, torch.float32, t)
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {shape} float32 bias, got {tuple(t.shape)}")
    check_bshd(name, q, k, v)
    if rel_h.device != q.device or rel_w.device != q.device:
        raise ValueError(f"{name}: all tensors must be on {q.device}")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    err = _build.lib().srgpt_grid_bias_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(), out.data_ptr(),
        B, S, H, D, gh, grid_w,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        D**-0.5, _build.stream_ptr(q),
    )
    _build.check(err, name)
    global grid_bias_launches
    grid_bias_launches += 1
    return out
