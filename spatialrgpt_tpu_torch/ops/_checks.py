"""Argument checks shared by the kernel wrappers: what the CUDA kernels
take, checked before a pointer crosses into C.  Dtype and shape come
first and the device last, so every rule can be exercised without a card
(on ``meta`` tensors).  Also the error bound that holds each kernel
against its plain version on the card."""

from __future__ import annotations

import torch

# ``bf16_err_over_bound``'s floor for attention gradients: 1/256 of one
# bf16 ulp of the tensor's largest value
GRAD_FLOOR = 2.0**-16
# the widest head dim of K1 and K5 on the Hopper main loop
# (csrc/attention_sm90.cuh::NARROW; K2 and K4 run it at WIDE = 128)
SM90_MAX_HEAD_DIM = 80
# query rows of one CTA of the main loop (csrc/attention_sm90.cuh::BM): K2
# and K4's forward and dQ fold G = Hq / Hk heads x FOLD_ROWS / G positions
# into them, so G must divide it
FOLD_ROWS = 128


def check_dtype(name: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")


def check_on_cuda(name: str, *tensors: torch.Tensor) -> None:
    device = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name}: all tensors must be on one CUDA device, got {t.device}")


def check_bshd(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """(B, S, H, D) bf16 tensors read through strides: the head dim must be
    contiguous, a multiple of 8 and at most 128 (the kernels are built for
    padded widths 80 and 128); the other strides and the base pointers must
    keep 16-byte rows aligned."""
    check_dtype(name, torch.bfloat16, q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: expected (B, S, H, D) tensors")
    B, S, _, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"{name}: q {tuple(q.shape)} / k {tuple(k.shape)} / v {tuple(v.shape)} mismatch")
    if D % 8 != 0 or D > 128:
        raise ValueError(f"{name}: head dim {D} must be a multiple of 8 and <= 128")
    for t in (q, k, v):
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"{name}: head dim must be contiguous with 16-byte aligned rows, strides {t.stride()}")
    check_on_cuda(name, q, k, v)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: base pointers must be 16-byte aligned")


def bf16_err_over_bound(out: torch.Tensor, ref: torch.Tensor, floor: float = 0.0) -> float:
    """Largest ratio of |out - ref| to the per-element bound for a bf16
    attention output against its plain version; at most 1 passes.

    The bound is 4 bf16 ulps (2^-8 each) of |ref| plus of the largest |ref|
    in the element's row (the last axis: one head's output vector).  The
    kernels round P to bf16 at other running maxima than the plain versions
    and sum in another order, so a sound error scales
    with the row it is in; a bound at the tensor's largest value would let
    a wrong row of small outputs through.

    ``floor`` adds ``floor * max|ref|`` to every element's bound.  The
    attention gradients need it: a query whose only live key is itself
    (the first token of every segment) has P = 1 and dS = dP - delta, two
    f32 dot products of the same vectors that cancel to exactly 0 in one
    summation order and to ~1e-7 of |dP| in another, so its dQ row is all
    rounding noise around 0 (``GRAD_FLOOR``)."""
    r = ref.float().abs()
    bound = 4 * 2.0**-8 * (r + r.amax(dim=-1, keepdim=True)) + floor * r.max()
    diff = (out.float() - ref.float()).abs()
    if not bool(torch.isfinite(out).all()):
        return float("inf")
    return float(torch.where(diff == 0, torch.zeros_like(diff), diff / bound).max())
