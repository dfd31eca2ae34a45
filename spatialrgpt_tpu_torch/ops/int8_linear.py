"""K7-K9: the kernels of the quantized projections (``ops/layers.py::linear``).

The reference computes these with XLA, not Pallas
(``spatialrgpt_tpu/ops/layers.py::_w8a8_dot`` and ``linear``'s int8
weight-only branch); the port writes them by hand because PyTorch on CUDA
has no integer matrix product of its own, and because an eager
``F.linear(x, q.to(bf16))`` would write and re-read a bf16 copy of every
weight at every call.

- K7 ``act_quant_int8`` (``csrc/act_quant.cu``): per-token int8
  quantization of the activations, ``_w8a8_dot``'s prologue.
- K8 ``w8a8_gemm`` (``csrc/int8_gemm.cu``): int8 x int8 -> int32, then
  ``f32(acc) * (ascale * scale)``, the f32 bias and one cast.  At most
  ``DECODE_MAX_M`` rows it runs the decode form (the weight as wgmma's A,
  k split over a thread-block cluster where the weight has few channel
  tiles), above it the large form (a persistent TMA + wgmma main loop).
- K9 ``w8_gemm`` (``csrc/int8_gemm.cu``): bf16 activations x int8 weights
  converted to bf16 in registers, f32 sums, then ``* scale``, the f32 bias
  and one cast; always the decode form (in 64-row tiles past 64 rows).

Each wrapper launches its kernel for CUDA tensors and takes its plain
version only for tensors on the CPU.  ``launches`` counts kernel launches
per kernel.  Weights are the port's (out, in) layout: q (N, K) int8 and
its per-output-channel f32 scale (N,).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from spatialrgpt_tpu_torch.ops import _build
from spatialrgpt_tpu_torch.ops._checks import check_dtype, check_on_cuda

# kernel launches since the last reset (plain-path calls do not count)
launches = {"act_quant_int8": 0, "w8a8_gemm": 0, "w8_gemm": 0}

# the plain int8 product sums chunks of this many k in f32: each partial sum
# is an integer of at most 1024 * 127^2 < 2^24, so f32 holds it exactly
EXACT_K_CHUNK = 1024
# K8's forms (csrc/int8_gemm.cu::Form): the decode form up to DECODE_MAX_M
# rows (two 64-row tiles past 64: measured faster than the large form over a
# decode step's projections at 96 and 128 rows, csrc/int8_gemm.cu's note),
# the large form above
FORM_DECODE, FORM_LARGE = 0, 1
DECODE_MAX_M = 128
# the decode form's grid: 128-channel tiles in y and 64-row tiles in z, at
# most 65,535 of each
DECODE_MAX_N, DECODE_MAX_ROWS = 65535 * 128, 65535 * 64


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def act_quant_int8_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_w8a8_dot``'s activation quantizer over the rows of x (M, K), as
    the reference runs it (under jit): ``ascale = max(max|x| * f32(1 / 127),
    1e-12)`` -- XLA folds the division by the constant 127 into a multiply
    by its f32 reciprocal -- and ``xq = clip(round(x / ascale), -127, 127)``
    in f32 with an IEEE division, rounded half to even, clipped before the
    cast."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    ascale = torch.clamp(amax * (1.0 / 127.0), min=1e-12)
    xq = torch.round(xf / ascale).clamp(-127, 127).to(torch.int8)
    return xq, ascale[..., 0]


def int8_matmul_plain(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``xq @ q.T`` for int8 xq (M, K) and q (N, K) on any
    device: f32 products over chunks of ``EXACT_K_CHUNK`` k (exact, also
    under TF32, whose 10-bit mantissa holds any int8), summed in int32."""
    acc = None
    for k0 in range(0, xq.shape[-1], EXACT_K_CHUNK):
        k = slice(k0, k0 + EXACT_K_CHUNK)
        part = torch.matmul(xq[:, k].float(), q[:, k].float().T).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def w8a8_gemm_plain(
    xq: torch.Tensor, ascale: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """``f32(xq @ q.T) * (ascale[m] * scale[n])``, then the f32 bias, then
    one cast to ``out_dtype`` (``layers.py:36-41`` and ``:144-146``)."""
    y = int8_matmul_plain(xq, q).float() * (ascale[:, None] * scale[None, :])
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def w8_gemm_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(x @ q.T in f32) * scale``, then the f32 bias, then one cast to x's
    dtype (``layers.py:123-125``): q in x's dtype is exact, and x's values
    are exact in f32, so the f32 product is the reference's."""
    y = torch.matmul(x.float(), q.float().T) * scale
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _check_2d(name: str, **tensors) -> None:
    for label, t in tensors.items():
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous 2-D tensor, got shape {tuple(t.shape)}")


def _check_aligned(name: str, *tensors: torch.Tensor) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: the rows must start 16-byte aligned")


def _bias_kind(name: str, bias: Optional[torch.Tensor], N: int) -> int:
    """0 none, 1 bf16, 2 f32: the kernels read the bias as the model holds it."""
    if bias is None:
        return 0
    if bias.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: bias must be bf16 or float32, got {bias.dtype}")
    if bias.shape != (N,) or not bias.is_contiguous():
        raise ValueError(f"{name}: bias must be contiguous of shape ({N},), got {tuple(bias.shape)}")
    return 1 if bias.dtype == torch.bfloat16 else 2


def act_quant_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: bf16 x (M, K) on the card -> (int8 xq (M, K), f32 ascale (M,)),
    bit-equal to ``act_quant_int8_plain``.  K % 8 == 0."""
    if x.device.type == "cpu":
        return act_quant_int8_plain(x)
    name = "act_quant_int8"
    check_dtype(name, torch.bfloat16, x)
    _check_2d(name, x=x)
    M, K = x.shape
    if K == 0 or K % 8:
        raise ValueError(f"{name}: K = {K} must be a positive multiple of 8")
    check_on_cuda(name, x)
    _check_aligned(name, x)
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    ascale = torch.empty((M,), dtype=torch.float32, device=x.device)
    err = _build.lib().srgpt_act_quant(x.data_ptr(), xq.data_ptr(), ascale.data_ptr(), M, K, _build.stream_ptr(x))
    _build.check(err, name)
    launches[name] += 1
    return xq, ascale


def _check_gemm(name: str, a: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> Tuple[int, int, int]:
    check_dtype(name, torch.int8, q)
    check_dtype(name, torch.float32, scale)
    _check_2d(name, x=a, q=q)
    (M, K), N = a.shape, q.shape[0]
    if q.shape[1] != K or scale.shape != (N,) or not scale.is_contiguous():
        raise ValueError(f"{name}: x {tuple(a.shape)}, q {tuple(q.shape)} and scale {tuple(scale.shape)} do not fit")
    if K == 0 or K % 16:
        raise ValueError(f"{name}: K = {K} must be a positive multiple of 16")
    if max(M, N) >= 2**31:
        raise ValueError(f"{name}: M = {M} and N = {N} must be below 2^31")
    return M, N, K


def _check_decode(name: str, M: int, N: int) -> None:
    if N > DECODE_MAX_N or M > DECODE_MAX_ROWS:
        raise ValueError(f"{name}: the decode form takes at most {DECODE_MAX_N} columns and {DECODE_MAX_ROWS} rows, "
                         f"got N = {N}, M = {M}")


def w8a8_gemm(
    xq: torch.Tensor, ascale: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """K8: int8 xq (M, K) with f32 ascale (M,) against int8 q (N, K) with
    f32 scale (N,) on the card -> bf16 (M, N), bit-equal to
    ``w8a8_gemm_plain``.  K % 16 == 0; the decode form (M <=
    ``DECODE_MAX_M``) takes N <= ``DECODE_MAX_N``."""
    if xq.device.type == "cpu":
        return w8a8_gemm_plain(xq, ascale, q, scale, bias, out_dtype)
    name = "w8a8_gemm"
    check_dtype(name, torch.int8, xq)
    check_dtype(name, torch.float32, ascale)
    if out_dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel writes bf16, not {out_dtype}")
    M, N, K = _check_gemm(name, xq, q, scale)
    if ascale.shape != (M,) or not ascale.is_contiguous():
        raise ValueError(f"{name}: ascale must be contiguous of shape ({M},), got {tuple(ascale.shape)}")
    form = FORM_DECODE if M <= DECODE_MAX_M else FORM_LARGE
    if form == FORM_DECODE:
        _check_decode(name, M, N)
    kind = _bias_kind(name, bias, N)
    check_on_cuda(name, xq, ascale, q, scale, *(() if bias is None else (bias,)))
    _check_aligned(name, xq, q)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=xq.device)
    err = _build.lib().srgpt_w8a8_gemm(
        xq.data_ptr(), q.data_ptr(), ascale.data_ptr(), scale.data_ptr(), _ptr(bias), kind, out.data_ptr(),
        M, N, K, form, _build.stream_ptr(xq),
    )
    _build.check(err, name)
    launches[name] += 1
    return out


def w8_gemm(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K9: bf16 x (M, K) against int8 q (N, K) with f32 scale (N,) on the
    card -> bf16 (M, N), within bf16 rounding of ``w8_gemm_plain`` (the f32
    sums run in another order, the same in every run).  K % 16 == 0,
    N <= ``DECODE_MAX_N``, M <= ``DECODE_MAX_ROWS``."""
    if x.device.type == "cpu":
        return w8_gemm_plain(x, q, scale, bias)
    name = "w8_gemm"
    check_dtype(name, torch.bfloat16, x)
    M, N, K = _check_gemm(name, x, q, scale)
    _check_decode(name, M, N)
    kind = _bias_kind(name, bias, N)
    check_on_cuda(name, x, q, scale, *(() if bias is None else (bias,)))
    _check_aligned(name, x, q)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    err = _build.lib().srgpt_w8_gemm(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), _ptr(bias), kind, out.data_ptr(), M, N, K,
        _build.stream_ptr(x),
    )
    _build.check(err, name)
    launches[name] += 1
    return out
