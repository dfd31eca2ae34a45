"""K7-K11: the kernels of the quantized projections (``ops/layers.py::linear``)
and of the W8A8 projection's int8 backward.

The reference computes these with XLA, not Pallas
(``spatialrgpt_tpu/ops/layers.py::_w8a8_dot`` and ``linear``'s int8
weight-only branch); the port writes them by hand because PyTorch on CUDA
has no integer matrix product of its own, and because an eager
``F.linear(x, q.to(bf16))`` would write and re-read a bf16 copy of every
weight at every call.

- K7 ``act_quant_int8`` (``csrc/act_quant.cu``): per-token int8
  quantization of the activations, ``_w8a8_dot``'s prologue.  Its split
  form (``reduce_max``) quantizes a tensor-parallel fan-in slice by the
  whole rows' scales: two launches, one count.  K7 and K10 take the form
  of ``act_quant_form``: each row read once, held in registers (a CTA a
  row) or in a ring of shared-memory stages filled by TMA; rows of a few
  vectors several to a warp; the two-pass loop where neither holds a row.
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

Under a running ``torch.profiler`` each K8 / K9 launch sits in a host span
named by its launched shape, ``k8.<form>:<M>x<N>x<K>`` or
``k9.<form>:<M>x<N>x<K>`` (``<form>`` ``decode`` or ``large``), with
``+add`` where it reads the f32 addend and ``+bias`` where it reads a bias
(``gemm_span_name``): one span a ``srgpt::qgemm::`` kernel, in launch
order, so a trace reader can count each kernel's operations and bytes.
A CUDA graph's replay launches its K8 / K9 nodes with no call of these
wrappers: ``record_spans`` collects the span names of the launches made
while the graph is captured, and the replay's owner opens one span of
each of them after launching the graph (``open_spans``).  There a span
marks the replay of the node, not a Python call; ``launches`` counts the
wrappers' calls, so the captured launches once and the replays never.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Iterable, List, Optional, Tuple

import torch

from spatialrgpt_tpu_torch.ops import _build
from spatialrgpt_tpu_torch.ops._checks import check_dtype, check_on_cuda
from spatialrgpt_tpu_torch.utils import profiling

# kernel launches since the last reset (plain-path calls do not count)
launches = {"act_quant_int8": 0, "w8a8_gemm": 0, "w8_gemm": 0, "act_quant_dy_int8": 0, "int8_dx_gemm": 0}
# the span names of the K8 / K9 launches made inside ``record_spans``, in launch order
_recorded: Optional[List[str]] = None

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
# K7's and K10's forms (csrc/act_quant.cu::AqForm) and passes (AqPass)
AQ_NARROW, AQ_ROWS, AQ_LOOP, AQ_RING = 0, 1, 2, 3
AQ_BOTH, AQ_MAX, AQ_GIVEN_MAX = 0, 1, 2
AQ_LOOP_FORM = (AQ_LOOP, 1, 128, 1)
# the narrow form takes rows of at most AQ_NARROW_VECS 16-byte vectors; the
# rows form rows that one CTA of at most AQ_ROW_THREADS threads holds, each
# thread one of AQ_VPT vector counts; the ring form rows of which two
# stages fit the H100's 227 KB of shared memory, in row groups of warps
# that give each thread at most about AQ_RING_VECS vectors (K10's scales
# double a vector's loads), at most AQ_RING_THREADS threads and
# AQ_RING_GROUPS groups a CTA
AQ_NARROW_VECS, AQ_ROW_THREADS, AQ_VPT = 32, 256, (1, 2, 4, 8)
AQ_RING_VECS = {False: 14, True: 4}
AQ_RING_THREADS, AQ_RING_GROUPS, AQ_RING_STAGES, AQ_SMEM = 512, 8, 2, 232448
# K7 over more than AQ_FEW_ROWS rows of more than AQ_K7_ROWS_VECS vectors
# takes the ring form, every other call the rows form, where both hold a
# row; K7 over more than AQ_MANY_ROWS rows takes rows-form CTAs of at most
# AQ_MANY_THREADS threads where 4 vectors a thread or fewer do (more rows
# in flight on an SM).  scripts/bench_act_quant.py on the H100: the ring
# 0.3093 ms against the rows form's 0.3166 at the prefill's 20,480 x
# 14,336, but for K10 0.3352 against 0.2886 at 16,384 x 14,336; at
# 20,480 x 4096 128 threads of 4 vectors 0.0875 against 256 of 2's 0.0929,
# at SigLIP's 93,312 x 1152 96 of 2 0.1230 against the ring's 0.1353; at
# 1024 rows 256 of 2 0.0057 against 128 of 4's 0.0062, at the families'
# 2560 rows 0.0115 against 0.0116 (0.0113 against 0.0133 in another run)
AQ_FEW_ROWS, AQ_K7_ROWS_VECS, AQ_MANY_ROWS, AQ_MANY_THREADS = 256, 1024, 4096, 128


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def w8_gemm_form(M: int) -> int:
    """K9's form at M rows: ``FORM_DECODE`` up to ``W8_DECODE_MAX_M``,
    ``FORM_LARGE`` above."""
    return FORM_DECODE if M <= W8_DECODE_MAX_M else FORM_LARGE


def _ring_smem(K: int, groups: int, stages: int) -> int:
    """csrc/act_quant.cu::aq_ring_smem: the stages' rows (each rounded up
    to 128 bytes) and their mbarriers, and 16 floats a group."""
    return groups * stages * (-(-2 * K // 128) * 128 + 8) + groups * 16 * 4


def act_quant_ring(K: int, dy: bool = False) -> Optional[Tuple[int, int, int, int]]:
    """The ring form's launch for rows of K values: (AQ_RING, warps a row
    group, row groups a CTA, stages), or None where two stages of one row
    do not fit shared memory."""
    warps = min(16, 1 << (-(-(K // 8) // (32 * AQ_RING_VECS[dy])) - 1).bit_length())
    groups = min(AQ_RING_GROUPS, AQ_RING_THREADS // (32 * warps))
    while groups > 1 and _ring_smem(K, groups, AQ_RING_STAGES) > AQ_SMEM:
        groups //= 2
    if _ring_smem(K, groups, AQ_RING_STAGES) > AQ_SMEM:
        return None
    return AQ_RING, warps, groups, AQ_RING_STAGES


def act_quant_rows(K: int, threads: int = AQ_ROW_THREADS) -> Optional[Tuple[int, int, int, int]]:
    """The rows form's launch for rows of K values: (AQ_ROWS, 1, threads,
    vectors a thread), the fewest vectors a thread that a CTA of at most
    ``threads`` threads holds, or None where none does."""
    vecs = K // 8
    vpt = next((v for v in AQ_VPT if vecs <= threads * v), None)
    return None if vpt is None else (AQ_ROWS, 1, -(-vecs // (32 * vpt)) * 32, vpt)


def act_quant_form(M: int, K: int, dy: bool = False) -> Tuple[int, int, int, int]:
    """K7's (``dy``: K10's) launch over M rows of K values: (form, warps,
    count, each), csrc/act_quant.cu::srgpt_act_quant's.  Rows of at most
    ``AQ_NARROW_VECS`` 16-byte vectors: the narrow form (each: lanes a
    row).  K7 over more than ``AQ_FEW_ROWS`` rows of more than
    ``AQ_K7_ROWS_VECS`` vectors: the ring form (``act_quant_ring``) where
    it holds the row; every other call the rows form (``act_quant_rows``;
    K7 over more than ``AQ_MANY_ROWS`` rows in CTAs of at most
    ``AQ_MANY_THREADS`` where 4 vectors a thread do), then the ring form
    where one CTA does not hold the row; the loop form where neither
    does."""
    vecs = K // 8
    if vecs <= AQ_NARROW_VECS:
        return AQ_NARROW, 1, AQ_ROW_THREADS, 1 << (vecs - 1).bit_length()
    if not dy and M > AQ_FEW_ROWS and vecs > AQ_K7_ROWS_VECS:
        return act_quant_ring(K) or act_quant_rows(K) or AQ_LOOP_FORM
    rows = act_quant_rows(K)
    if not dy and M > AQ_MANY_ROWS:
        narrow_ctas = act_quant_rows(K, AQ_MANY_THREADS)
        if narrow_ctas is not None and narrow_ctas[3] <= 4:
            rows = narrow_ctas
    return rows or act_quant_ring(K, dy) or AQ_LOOP_FORM


def _pad16(n: int) -> int:
    """n rounded up to a multiple of 16: a row stride that TMA takes."""
    return -(-n // 16) * 16


def _quant_rows(xf: torch.Tensor, floor: float, reduce_max=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 of the f32 rows xf: ``s = max(max|xf| * f32(1 / 127),
    floor)``, ``clip(round(xf / s), -127, 127)``; returns (int8, s (M,)).
    ``reduce_max`` first reduces the rows' maxima (M,) in place."""
    amax = xf.abs().amax(dim=-1)
    if reduce_max is not None:
        reduce_max(amax)
    s = torch.clamp(amax[..., None] * (1.0 / 127.0), min=floor)
    return torch.round(xf / s).clamp(-127, 127).to(torch.int8), s[..., 0]


def act_quant_int8_plain(x: torch.Tensor, reduce_max=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_w8a8_dot``'s activation quantizer over the rows of x (M, K), as
    the reference runs it (under jit): ``ascale = max(max|x| * f32(1 / 127),
    1e-12)`` -- XLA folds the division by the constant 127 into a multiply
    by its f32 reciprocal -- and ``xq = clip(round(x / ascale), -127, 127)``
    in f32 with an IEEE division, rounded half to even, clipped before the
    cast.  ``reduce_max``, as ``act_quant_int8``'s."""
    return _quant_rows(x.float(), 1e-12, reduce_max)


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


def act_quant_launch(x: torch.Tensor, col_scale: Optional[torch.Tensor], xq: Optional[torch.Tensor],
                     ascale: torch.Tensor, pass_: int = AQ_BOTH, form: Optional[Tuple[int, int, int, int]] = None) -> None:
    """One launch of K7 (``col_scale`` None) or K10 over the checked rows of
    x into xq (rows ``xq.stride(0)`` bytes apart) and ascale, in the form
    of ``act_quant_form`` unless ``form`` is given; not counted in
    ``launches`` (the wrappers count their calls)."""
    M, K = x.shape
    form = act_quant_form(M, K, col_scale is not None) if form is None else form
    ld = K if xq is None else xq.stride(0)
    err = _build.lib().srgpt_act_quant(x.data_ptr(), _ptr(col_scale), _ptr(xq), ascale.data_ptr(), M, K, ld, pass_,
                                       *form, _build.stream_ptr(x))
    _build.check(err, "act_quant_dy_int8" if col_scale is not None else "act_quant_int8")


def act_quant_int8(x: torch.Tensor, reduce_max=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: bf16 x (M, K) on the card -> (int8 xq (M, K), f32 ascale (M,)),
    bit-equal to ``act_quant_int8_plain``.  K % 8 == 0.

    ``reduce_max``: x holds some columns of longer rows (a tensor-parallel
    fan-in slice), and ``reduce_max(amax)`` reduces an f32 (M,) vector of
    the rows' max |x| over these columns in place to the whole rows' maxima
    (an all-reduce MAX over the ranks that hold the other columns).  Pass 1
    runs alone first, then pass 2 quantizes these columns by the whole
    rows' scales: bit-equal to K7 over the whole rows, sliced.  Two
    launches, counted as one."""
    if x.device.type == "cpu":
        return act_quant_int8_plain(x, reduce_max)
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
    if reduce_max is None:
        act_quant_launch(x, None, xq, ascale)
    else:  # ascale holds the rows' maxima until pass 2 writes the scales over them
        act_quant_launch(x, None, None, ascale, AQ_MAX)
        reduce_max(ascale)
        act_quant_launch(x, None, xq, ascale, AQ_GIVEN_MAX)
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
    act_quant_launch(dy, scale, rows, gscale)
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


@functools.lru_cache(maxsize=4096)
def gemm_span_name(kernel: str, form: int, M: int, N: int, K: int, add: bool, bias: bool) -> str:
    """The profiler's span of one K8 (``kernel`` "k8") or K9 ("k9") launch
    of ``form`` over (M, N, K), e.g. ``k8.decode:64x14336x4096+bias``;
    built only under a profiler (``profiling.annotate``), once a shape."""
    return (f"{kernel}.{'decode' if form == FORM_DECODE else 'large'}:{M}x{N}x{K}" + "+add" * add
            + "+bias" * bias)


@contextlib.contextmanager
def record_spans():
    """Yield a list that collects the span name (``gemm_span_name``) of
    every K8 / K9 launch made inside the block, in launch order, whether or
    not a profiler runs: the launches of a CUDA graph's capture."""
    global _recorded
    outer, _recorded = _recorded, []
    try:
        yield _recorded
    finally:
        _recorded = outer


def open_spans(names: Iterable[str]) -> None:
    """One profiler span of each name, in order, each closed at once: the
    spans of the K8 / K9 launches that a CUDA graph's replay has just
    made (``record_spans``), so a trace reader pairs each with its kernel
    as it pairs an eager launch's span.  Call only while a profiler runs."""
    for name in names:
        with torch.profiler.record_function(name):
            pass


def _span(kernel: str, form: int, M: int, N: int, K: int, add, bias):
    """The launch's profiler span (``profiling.annotate``), its name first
    recorded where ``record_spans`` collects."""
    if _recorded is not None:
        _recorded.append(gemm_span_name(kernel, form, M, N, K, add is not None, bias is not None))
    return profiling.annotate(gemm_span_name, kernel, form, M, N, K, add is not None, bias is not None)


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
    with _span("k8", form, M, N, K, add, bias):
        err = _build.lib().srgpt_w8a8_gemm(
            xq.data_ptr(), q.data_ptr(), ascale.data_ptr(), scale.data_ptr(), _ptr(bias), kind, _ptr(add),
            out.data_ptr(), M, N, K, form, _build.stream_ptr(xq),
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
    with _span("k9", form, M, N, K, add, bias):
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
