"""Readers of the spans that the port opens inside the traced slice
(``spatialrgpt_tpu_torch/utils/profiling.py::annotate``, only while a
profiler runs): the serving engine's phases and the int8 GEMM launches.
They are host ranges on the profiler's clock, the clock of the card's
kernels, so the card's idle time can be split by the phase that held the
host.  Each reader reads ``ctx["timeline"]`` alone and returns None where
the trace holds none of its spans (a program that opens none).

- ``engine.admit``: one ``step``'s admission (``serving/engine.py``);
- ``engine.prefill[n]``: one admission prefill of n requests inside it;
- ``engine.decode``: one ``step``'s decode window and token read;
- ``k8.<form>:<M>x<N>x<K>[+add][+bias]`` and ``k9....``: one K8 / K9
  launch of its launched shape (``ops/int8_linear.py::gemm_span_name``).
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Tuple

import flops

ADMIT, DECODE = "engine.admit", "engine.decode"
PREFILL = re.compile(r"engine\.prefill\[(\d+)\]")
GEMM = re.compile(r"(k8|k9)\.(decode|large):(\d+)x(\d+)x(\d+)(\+add)?(\+bias)?")
# the kernel that each (kernel, form) launches (csrc/int8_gemm.cu)
QGEMM = "srgpt::qgemm::"
GEMM_KERNELS = {("k8", "decode"): QGEMM + "decode_kernel<true", ("k9", "decode"): QGEMM + "decode_kernel<false",
                ("k8", "large"): QGEMM + "large_kernel<", ("k9", "large"): QGEMM + "w8_large_kernel<"}

Span = Tuple[float, float, str]


def spans(tl, keep: Callable[[str], bool]) -> List[Span]:
    """The host spans whose name ``keep`` takes, clipped to the slice
    (``Timeline.host`` holds the spans that cross its edges whole), in
    start order; us."""
    out = [(max(a, tl.t0), min(b, tl.t1), n) for a, b, n in tl.host if keep(n)]
    return sorted(s for s in out if s[1] > s[0])


def parse_gemm(name: str) -> Optional[tuple]:
    """(kernel, form, M, N, K, add, bias) of a K8 / K9 span's name, or None."""
    m = GEMM.fullmatch(name)
    if m is None:
        return None
    return m[1], m[2], int(m[3]), int(m[4]), int(m[5]), bool(m[6]), bool(m[7])


def gemm_bound_s(kernel: str, M: int, N: int, K: int, add: bool, bias: bool) -> float:
    """The least time of one launch at the card's peaks: 2 M N K operations
    (K8 int8, K9 bf16) or the bytes it reads and writes once, whichever
    takes longer.  K8: int8 x and q, f32 row and channel scales, bf16 out;
    K9: bf16 x, int8 q, f32 channel scales, bf16 out; both: the f32 (M, N)
    addend and a bias of 2 bytes a channel (bf16, the least a bias takes)."""
    if kernel == "k8":
        x, peak = M * K + 4 * M, flops.PEAK["int8"]
    else:
        x, peak = 2 * M * K, flops.PEAK["bf16"]
    nbytes = x + N * K + 4 * N + 2 * M * N + 4 * M * N * add + 2 * N * bias
    return flops.bound_s(2 * M * N * K, nbytes, peak)


def admit_share(ctx) -> Optional[float]:
    """The host's wall inside ``engine.admit`` over the slice's wall, in percent."""
    tl = ctx.get("timeline")
    s = [] if tl is None else spans(tl, ADMIT.__eq__)
    return 100.0 * sum(b - a for a, b, _ in s) / (tl.t1 - tl.t0) if s else None


def _idle_inside(tl, s: List[Span]) -> Optional[float]:
    """The time with no kernel, copy or memset on the card inside the spans
    ``s`` (disjoint) over their summed length, in percent."""
    if not s or not tl.kernels:
        return None
    busy, i, covered = tl.busy_intervals(), 0, 0.0
    for a, b, _ in s:
        while i < len(busy) and busy[i][1] <= a:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < b:
            covered += min(b, busy[j][1]) - max(a, busy[j][0])
            j += 1
    return 100.0 * (1.0 - covered / sum(b - a for a, b, _ in s))


def admit_idle_share(ctx) -> Optional[float]:
    """The card's idle share inside the ``engine.admit`` spans, in percent."""
    tl = ctx.get("timeline")
    return None if tl is None else _idle_inside(tl, spans(tl, ADMIT.__eq__))


def decode_idle_share(ctx) -> Optional[float]:
    """The card's idle share inside the ``engine.decode`` spans, in percent:
    the launch-bound share of the decode windows."""
    tl = ctx.get("timeline")
    return None if tl is None else _idle_inside(tl, spans(tl, DECODE.__eq__))


def admit_width(ctx) -> Optional[float]:
    """Requests per admission prefill: the mean n of the slice's
    ``engine.prefill[n]`` spans."""
    tl = ctx.get("timeline")
    widths = [] if tl is None else [int(PREFILL.fullmatch(n)[1]) for _, _, n in spans(tl, PREFILL.fullmatch)]
    return sum(widths) / len(widths) if widths else None


# how far past an unpaired span or kernel the pairing looks, and how many pairs in a row it then wants
LOOK, RUN = 64, 8


def _gemm_kernel(g: tuple) -> str:
    """The part of the kernel's name that a K8 / K9 span's launch runs:
    the form's kernel and, for the decode form, its row tile
    (``csrc/int8_gemm.cu::dispatch_decode``)."""
    kernel, form, M = g[:3]
    name = GEMM_KERNELS[kernel, form]
    return name + f", {8 if M <= 8 else 16 if M <= 16 else 32 if M <= 32 else 64}>" if form == "decode" else name


def gemm_pairs(gemms: List[tuple], kernels: List[str]) -> List[Tuple[int, int]]:
    """(span, kernel) index pairs of the parsed K8 / K9 span names and the
    ``srgpt::qgemm::`` kernels' names, both in start order.  One stream:
    the i-th launch is the i-th kernel, so the pairs are i with i where the
    trace holds every record.  Where it lacks one (one traced backlog run on
    the card read no roofline when the two were paired strictly in order;
    reruns of its seed did not repeat it), the pairing walks back from the slice's end, where the stop's synchronize
    leaves nothing in flight, and steps over a span or kernel with no
    partner: to the nearest place, within ``LOOK``, from which ``RUN`` pairs
    in a row fit, or past one of each where there is none.  A span and a
    kernel fit where the kernel is the one that the span's form and rows
    launch."""
    want = [_gemm_kernel(g) for g in gemms]

    def fits(i: int, j: int) -> bool:
        return want[i] in kernels[j]

    def resync(i: int, j: int) -> Optional[Tuple[int, int]]:
        for d in range(1, LOOK + 1):
            for a in range(d + 1):
                i2, j2 = i - a, j - d + a
                if i2 >= 0 and j2 >= 0 and all(fits(i2 - t, j2 - t) for t in range(min(RUN, i2 + 1, j2 + 1))):
                    return i2, j2
        return None

    pairs, i, j = [], len(gemms) - 1, len(kernels) - 1
    while i >= 0 and j >= 0:
        if fits(i, j):
            pairs.append((i, j))
            i, j = i - 1, j - 1
        else:
            i, j = resync(i, j) or (i - 1, j - 1)
    return pairs[::-1]


def int8_gemm_roofline(ctx) -> Optional[float]:
    """K8 and K9 in the slice: the summed least times of the launches the
    ``k8.*`` / ``k9.*`` spans name (``gemm_bound_s``, the launched shapes,
    padding included) over the summed device time of the ``srgpt::qgemm::``
    kernels they pair with (``gemm_pairs``), in percent; None where no span
    pairs with a kernel."""
    tl = ctx.get("timeline")
    if tl is None:
        return None
    gemms = [parse_gemm(n) for _, _, n in spans(tl, GEMM.fullmatch)]
    kernels = [(a, b, n) for a, b, n in tl.kernels if QGEMM in n]
    bound = spent = 0.0
    for i, j in gemm_pairs(gemms, [n for _, _, n in kernels]):
        kernel, _, M, N, K, add, bias = gemms[i]
        bound += gemm_bound_s(kernel, M, N, K, add, bias)
        spent += (kernels[j][1] - kernels[j][0]) * 1e-6
    return 100.0 * bound / spent if spent > 0 else None
