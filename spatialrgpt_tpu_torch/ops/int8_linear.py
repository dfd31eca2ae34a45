"""K7-K11: the kernels of the quantized projections (``ops/layers.py::linear``)
and of the W8A8 projection's int8 backward.

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
  and one cast.  At most ``W8_DECODE_MAX_M`` rows it runs the decode form
  (K8's decode form with bf16 activations), above it the large form (the
  same swap-AB product on K8's persistent loop, 128 channels x 256 rows a
  tile); ``w8_gemm_form`` is the rule.  K8 and K9 take an optional f32
  (M, N) ``add`` (the LoRA side branch), added after the scale and before
  the bias.
- K10 ``act_quant_dy_int8`` (``csrc/act_quant.cu``): the SwitchBack
  prologue of ``_w8a8_dot_bwd``'s int8 route (``layers.py:70-73``): dy times
  the weight's per-channel scale, quantized per row to int8.
- K11 ``int8_dx_gemm`` (``csrc/int8_dx_gemm.cu``): K10's int8 rows x the
  stored weight, contracted over its output axis, int32 sums, then
  ``* gscale`` and one cast to bf16 (``layers.py:74-78``).  Two launches a
  call: q transposed into a workspace of this call alone, then K8's large
  form on the transposed copy (TN).

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
launches = {"act_quant_int8": 0, "w8a8_gemm": 0, "w8_gemm": 0, "act_quant_dy_int8": 0, "int8_dx_gemm": 0}

# the plain int8 product sums chunks of this many k in f32: each partial sum
# is an integer of at most 1024 * 127^2 < 2^24, so f32 holds it exactly
EXACT_K_CHUNK = 1024
# K8's forms (csrc/int8_gemm.cu::Form): the decode form up to DECODE_MAX_M
# rows (two 64-row tiles past 64: measured faster than the large form over a
# decode step's projections at 96 and 128 rows, csrc/int8_gemm.cu's note),
# the large form above
FORM_DECODE, FORM_LARGE = 0, 1
DECODE_MAX_M = 128
# K9's forms: the decode form up to W8_DECODE_MAX_M rows, the large form
# above.  Between 385 and 2047 rows K9 gets only the W8A8 engine
# admissions' k, v and down (q, o, gate and up take W8A8 at any row count;
# the weight-only route runs at QLoRA's 16,384 rows); scripts/bench_qgemm.py's
# k9_boundary phase (H100) times those three on both forms: 0.2232 ms on the
# decode form against 0.2698 on the large at 512 rows, 0.3199 against
# 0.2720 at 576 (the large form has no k split: at k / v's 8 channel tiles
# its CTAs walk all of K alone)
W8_DECODE_MAX_M = 512
# the decode form's grid: 128-channel tiles in y and 64-row tiles in z, at
# most 65,535 of each
DECODE_MAX_N, DECODE_MAX_ROWS = 65535 * 128, 65535 * 64


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def w8_gemm_form(M: int) -> int:
    """K9's form at M rows: ``FORM_DECODE`` up to ``W8_DECODE_MAX_M``,
    ``FORM_LARGE`` above."""
    return FORM_DECODE if M <= W8_DECODE_MAX_M else FORM_LARGE


def _pad16(n: int) -> int:
    """n rounded up to a multiple of 16: a row stride that TMA takes."""
    return -(-n // 16) * 16


def _quant_rows(xf: torch.Tensor, floor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 of the f32 rows xf: ``s = max(max|xf| * f32(1 / 127),
    floor)``, ``clip(round(xf / s), -127, 127)``; returns (int8, s (M,))."""
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp(amax * (1.0 / 127.0), min=floor)
    return torch.round(xf / s).clamp(-127, 127).to(torch.int8), s[..., 0]


def act_quant_int8_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_w8a8_dot``'s activation quantizer over the rows of x (M, K), as
    the reference runs it (under jit): ``ascale = max(max|x| * f32(1 / 127),
    1e-12)`` -- XLA folds the division by the constant 127 into a multiply
    by its f32 reciprocal -- and ``xq = clip(round(x / ascale), -127, 127)``
    in f32 with an IEEE division, rounded half to even, clipped before the
    cast."""
    return _quant_rows(x.float(), 1e-12)


def act_quant_dy_int8_plain(dy: torch.Tensor, scale: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_w8a8_dot_bwd``'s int8 prologue over the rows of dy (M, N) with the
    weight's f32 scale (N,): ``dyf = f32(dy) * scale``, ``gscale =
    max(max|dyf| * f32(1 / 127), 1e-30)`` (the division folded as XLA folds
    it: the compiled HLO multiplies), ``dyq = clip(round(dyf / gscale),
    -127, 127)``; returns (int8 dyq (M, N), f32 gscale (M,))."""
    return _quant_rows(dy.float() * scale, 1e-30)


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


def finish(y: torch.Tensor, add: Optional[torch.Tensor], bias: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """The f32 addend, then the f32 bias, then one cast (``layers.py:132-146``)."""
    if add is not None:
        y = y + add
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def w8a8_gemm_plain(
    xq: torch.Tensor, ascale: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.bfloat16, add: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``f32(xq @ q.T) * (ascale[m] * scale[n])``, then the f32 ``add`` and
    the f32 bias, then one cast to ``out_dtype`` (``layers.py:36-41`` and
    ``:132-146``)."""
    return finish(int8_matmul_plain(xq, q).float() * (ascale[:, None] * scale[None, :]), add, bias, out_dtype)


def w8_gemm_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(x @ q.T in f32) * scale``, then the f32 ``add`` and the f32 bias,
    then one cast to x's dtype (``layers.py:123-125``): q in x's dtype is
    exact, and x's values are exact in f32, so the f32 product is the
    reference's."""
    return finish(torch.matmul(x.float(), q.float().T) * scale, add, bias, x.dtype)


def int8_dx_gemm_plain(dyq: torch.Tensor, q: torch.Tensor, gscale: torch.Tensor,
                       out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``bf16(f32(dyq @ q) * gscale[m])`` for int8 dyq (M, N) and the stored
    int8 q (N, K): the exact int32 product contracted over q's rows, one
    rounded multiply, one cast (``layers.py:74-78``)."""
    return (int8_matmul_plain(dyq, q.t()).float() * gscale[:, None]).to(out_dtype)


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


def _check_add(name: str, add: Optional[torch.Tensor], M: int, N: int) -> None:
    if add is None:
        return
    check_dtype(name, torch.float32, add)
    if add.shape != (M, N) or not add.is_contiguous():
        raise ValueError(f"{name}: add must be contiguous of shape ({M}, {N}), got {tuple(add.shape)}")


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


def act_quant_dy_int8(dy: torch.Tensor, scale: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10: bf16 dy (M, N) and the weight's f32 scale (N,) on the card ->
    (int8 dyq (M, N), f32 gscale (M,)), bit-equal to
    ``act_quant_dy_int8_plain``.  N % 8 == 0.  On the card dyq's rows lie
    N rounded up to 16 bytes apart (a view of an (M, N16) buffer where N %
    16 != 0), the row stride that K11's tensor map needs; on the CPU dyq is
    contiguous."""
    if dy.device.type == "cpu":
        return act_quant_dy_int8_plain(dy, scale)
    name = "act_quant_dy_int8"
    check_dtype(name, torch.bfloat16, dy)
    check_dtype(name, torch.float32, scale)
    _check_2d(name, dy=dy)
    M, N = dy.shape
    if N == 0 or N % 8:
        raise ValueError(f"{name}: N = {N} must be a positive multiple of 8")
    if scale.shape != (N,) or not scale.is_contiguous():
        raise ValueError(f"{name}: scale must be contiguous of shape ({N},), got {tuple(scale.shape)}")
    check_on_cuda(name, dy, scale)
    _check_aligned(name, dy, scale)
    rows = torch.empty((M, _pad16(N)), dtype=torch.int8, device=dy.device)
    gscale = torch.empty((M,), dtype=torch.float32, device=dy.device)
    err = _build.lib().srgpt_act_quant_dy(dy.data_ptr(), scale.data_ptr(), rows.data_ptr(), gscale.data_ptr(), M, N,
                                          rows.shape[1], _build.stream_ptr(dy))
    _build.check(err, name)
    launches[name] += 1
    return rows[:, :N], gscale


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
    bias: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.bfloat16, add: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K8: int8 xq (M, K) with f32 ascale (M,) against int8 q (N, K) with
    f32 scale (N,) on the card -> bf16 (M, N), bit-equal to
    ``w8a8_gemm_plain``.  K % 16 == 0; the decode form (M <=
    ``DECODE_MAX_M``) takes N <= ``DECODE_MAX_N``."""
    if xq.device.type == "cpu":
        return w8a8_gemm_plain(xq, ascale, q, scale, bias, out_dtype, add)
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
    _check_add(name, add, M, N)
    check_on_cuda(name, xq, ascale, q, scale, *(t for t in (bias, add) if t is not None))
    _check_aligned(name, xq, q)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=xq.device)
    err = _build.lib().srgpt_w8a8_gemm(
        xq.data_ptr(), q.data_ptr(), ascale.data_ptr(), scale.data_ptr(), _ptr(bias), kind, _ptr(add), out.data_ptr(),
        M, N, K, form, _build.stream_ptr(xq),
    )
    _build.check(err, name)
    launches[name] += 1
    return out


def w8_gemm(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
            add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K9: bf16 x (M, K) against int8 q (N, K) with f32 scale (N,) on the
    card -> bf16 (M, N), within bf16 rounding of ``w8_gemm_plain`` (the f32
    sums run in another order, the same in every run).  K % 16 == 0; the
    form of ``w8_gemm_form(M)``; the decode form takes N <= ``DECODE_MAX_N``
    and M <= ``DECODE_MAX_ROWS``."""
    if x.device.type == "cpu":
        return w8_gemm_plain(x, q, scale, bias, add)
    name = "w8_gemm"
    check_dtype(name, torch.bfloat16, x)
    M, N, K = _check_gemm(name, x, q, scale)
    form = w8_gemm_form(M)
    if form == FORM_DECODE:
        _check_decode(name, M, N)
    kind = _bias_kind(name, bias, N)
    _check_add(name, add, M, N)
    check_on_cuda(name, x, q, scale, *(t for t in (bias, add) if t is not None))
    _check_aligned(name, x, q)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    err = _build.lib().srgpt_w8_gemm(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), _ptr(bias), kind, _ptr(add), out.data_ptr(), M, N, K, form,
        _build.stream_ptr(x),
    )
    _build.check(err, name)
    launches[name] += 1
    return out


def int8_dx_gemm(dyq: torch.Tensor, q: torch.Tensor, gscale: torch.Tensor) -> torch.Tensor:
    """K11: int8 dyq (M, N) with f32 gscale (M,) against the stored int8 q
    (N, K), contracted over N, on the card -> bf16 dx (M, K), bit-equal to
    ``int8_dx_gemm_plain``.  N % 8 == 0, K % 16 == 0.

    Two launches a call (``launches`` counts the call once): q transposed
    into a (K, N16) workspace, N16 = N rounded up to 16, allocated here and
    dropped on return, then K8's large form over dyq and the transposed
    copy.  dyq's rows must lie a multiple of 16 bytes apart, as K10 writes
    them; a dyq whose rows do not (a contiguous one with N % 16 != 0) is
    copied into such rows first."""
    if dyq.device.type == "cpu":
        return int8_dx_gemm_plain(dyq, q, gscale)
    name = "int8_dx_gemm"
    check_dtype(name, torch.int8, dyq, q)
    check_dtype(name, torch.float32, gscale)
    _check_2d(name, q=q)
    if dyq.dim() != 2 or dyq.stride(1) != 1 or dyq.stride(0) < dyq.shape[1]:
        raise ValueError(f"{name}: dyq must be a 2-D tensor of contiguous rows, got shape {tuple(dyq.shape)} "
                         f"and strides {tuple(dyq.stride())}")
    (M, N), K = dyq.shape, q.shape[1]
    if q.shape[0] != N or gscale.shape != (M,) or not gscale.is_contiguous():
        raise ValueError(f"{name}: dyq {tuple(dyq.shape)}, q {tuple(q.shape)} and gscale {tuple(gscale.shape)} "
                         "do not fit")
    if N == 0 or N % 8 or K == 0 or K % 16:
        raise ValueError(f"{name}: N = {N} must be a positive multiple of 8 and K = {K} of 16")
    if max(M, N, K) >= 2**31:
        raise ValueError(f"{name}: M = {M}, N = {N} and K = {K} must be below 2^31")
    check_on_cuda(name, dyq, q, gscale)
    if dyq.stride(0) % 16:
        rows = torch.empty((M, _pad16(N)), dtype=torch.int8, device=dyq.device)
        rows[:, :N].copy_(dyq)
        dyq = rows[:, :N]
    _check_aligned(name, dyq, q)
    qt = torch.empty((K, _pad16(N)), dtype=torch.int8, device=dyq.device)  # the call's workspace
    dx = torch.empty((M, K), dtype=torch.bfloat16, device=dyq.device)
    err = _build.lib().srgpt_int8_dx_gemm(dyq.data_ptr(), dyq.stride(0), q.data_ptr(), gscale.data_ptr(),
                                          qt.data_ptr(), dx.data_ptr(), M, N, K, _build.stream_ptr(dyq))
    _build.check(err, name)
    launches[name] += 1
    return dx


def int8_transpose(q: torch.Tensor) -> torch.Tensor:
    """K11's first launch alone, for tests and timing: int8 q (N, K) on the
    card -> q^T as (K, N16) int8 rows, N16 = N rounded up to 16 (columns N
    .. N16 - 1 zero).  Not counted in ``launches``: ``int8_dx_gemm`` runs
    it inside each call."""
    name = "int8_transpose"
    check_dtype(name, torch.int8, q)
    _check_2d(name, q=q)
    N, K = q.shape
    if K == 0 or K % 16:
        raise ValueError(f"{name}: K = {K} must be a positive multiple of 16")
    check_on_cuda(name, q)
    _check_aligned(name, q)
    qt = torch.empty((K, _pad16(N)), dtype=torch.int8, device=q.device)
    _build.check(_build.lib().srgpt_int8_transpose(q.data_ptr(), qt.data_ptr(), N, K, _build.stream_ptr(q)), name)
    return qt
