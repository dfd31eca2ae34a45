"""K3: one-token decode attention against the flat token-major int8 cache.

Port of the Pallas kernel
``spatialrgpt_tpu/ops/decode_attention.py::decode_attention_int8_flat``; the
CUDA kernel is ``csrc/decode_attention.cu``: one launch, a thread-block
cluster of ``decode_cluster_size(C)`` CTAs per (row, kv head) that share the
row's softmax max and sum their partials through distributed shared memory.
``decode_attention_int8_flat`` launches it for CUDA tensors and takes the
plain version ``decode_attention_int8_flat_plain`` only for CPU tensors.
``launches`` counts wrapper calls that launched the kernel.

Cache layout: ``k_q, v_q`` (B, C, Hk*D) int8 and ``k_s, v_s`` (B, C, Hk)
f32; positions ``<= lengths[b]`` are live.

The packed-int4 form (``decode_attention_int4_flat``, the same kernel
instantiated for ``ops/quant.py::quantize_kv4``'s nibbles): ``k_q, v_q``
(B, C, Hk*D/2), the scales as above; the reference's ``generate(kv_bits=4)``
decode (``serving/generate.py:341-393``).  Its plain version
``decode_attention_int4_flat_plain`` unpacks and runs the int8 form's plain
arithmetic; ``launches_int4`` counts its launches.
"""

from __future__ import annotations

import torch

from spatialrgpt_tpu_torch.ops import _build
from spatialrgpt_tpu_torch.ops._checks import check_dtype, check_on_cuda
from spatialrgpt_tpu_torch.ops.quant import unpack_kv4

NEG_INF = -1e30

launches = 0  # kernel launches since the last reset (plain-path calls do not count)
launches_int4 = 0  # the same for the packed-int4 form

# csrc/decode_attention.cu: at most 8 CTAs per cluster (the portable size),
# ~256 cache positions a CTA, and each CTA's f32 scores (its positions x
# n_rep) within 16384 entries of shared memory
DECODE_MAX_CLUSTER = 8
DECODE_POSITIONS_PER_CTA = 256
DECODE_MAX_SCORES = 16384


def decode_cluster_size(C: int) -> int:
    """CTAs per (row, kv head) for a cache of C positions: enough that each
    takes ~256 (at the serve cache's 352, 2 x 8 kv heads x 8 rows = 128
    CTAs on 132 SMs), at most 8."""
    return min(DECODE_MAX_CLUSTER, max(1, -(-C // DECODE_POSITIONS_PER_CTA)))


def check_shape(C: int, Hq: int, Hk: int, D: int, kv_bits: int = 8) -> None:
    """Raise ``ValueError`` where the kernel does not take a cache of C
    positions at these heads: Hq a multiple of Hk by at most 8, D a
    multiple of 4 up to 256 (of 8 for the packed-int4 form, whose head rows
    of D / 2 bytes are copied 4 bytes at a time), and each CTA's scores
    within shared memory."""
    if Hq % Hk or Hq // Hk > 8 or D % (8 if kv_bits == 4 else 4) or D > 256:
        raise ValueError(f"decode_attention_int{kv_bits}_flat: Hq={Hq} Hk={Hk} D={D} not supported")
    cluster = decode_cluster_size(C)
    if -(-C // cluster) * (Hq // Hk) > DECODE_MAX_SCORES:
        raise ValueError(
            f"decode_attention_int8_flat: C={C} over {cluster} CTAs with {Hq // Hk} query heads per kv head "
            f"needs more than the {DECODE_MAX_SCORES} scores a CTA holds in shared memory"
        )


def decode_attention_int8_flat_plain(
    q: torch.Tensor,  # (B, Hq, D)
    k_q: torch.Tensor,  # (B, C, Hk*D) int8
    k_s: torch.Tensor,  # (B, C, Hk) f32
    v_q: torch.Tensor,
    v_s: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int32
    n_heads: int,  # Hk
) -> torch.Tensor:
    """The Pallas kernel's function in plain PyTorch: scores from the int8
    keys in the query dtype times the K scale and D^-0.5, positions past
    lengths[b] masked, V scales folded into P relative to the row's max and
    rounded to the query dtype (decode_attention.py:124), f32 PV, divided by
    the f32 sum of the unrounded P."""
    B, Hq, D = q.shape
    C = k_q.shape[1]
    Hk = n_heads
    g = Hq // Hk
    kf = k_q.reshape(B, C, Hk, D).to(q.dtype).float()
    vf = v_q.reshape(B, C, Hk, D).to(q.dtype).float()
    qg = q.reshape(B, Hk, g, D).float()
    s = torch.einsum("bhgd,bchd->bhgc", qg, kf)
    s = s * (k_s.float().permute(0, 2, 1)[:, :, None, :] * D**-0.5)
    pos = torch.arange(C, device=q.device)
    live = pos[None, :] <= lengths.to(q.device)[:, None]  # (B, C)
    s = torch.where(live[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = (p * v_s.float().permute(0, 2, 1)[:, :, None, :]).to(q.dtype).float()
    o = torch.einsum("bhgc,bchd->bhgd", pv, vf) / l
    return o.reshape(B, Hq, D).to(q.dtype)


def decode_attention_int4_flat_plain(
    q: torch.Tensor,  # (B, Hq, D)
    k_q: torch.Tensor,  # (B, C, Hk*D/2) int8: two int4 nibbles a byte
    k_s: torch.Tensor,  # (B, C, Hk) f32
    v_q: torch.Tensor,
    v_s: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int32
    n_heads: int,  # Hk
) -> torch.Tensor:
    """The int4 form's function: ``unpack_kv4``, then the int8 form's plain
    arithmetic (every int4 value is an int8 one)."""
    return decode_attention_int8_flat_plain(q, unpack_kv4(k_q), k_s, unpack_kv4(v_q), v_s, lengths, n_heads)


def _launch(name: str, entry: str, bits: int, q, k_q, k_s, v_q, v_s, lengths, n_heads: int) -> torch.Tensor:
    """Check the inputs of a form of the kernel and launch it."""
    check_dtype(name, torch.bfloat16, q)
    check_dtype(name, torch.int8, k_q, v_q)
    check_dtype(name, torch.float32, k_s, v_s)
    check_dtype(name, torch.int32, lengths)
    if q.dim() != 3 or k_q.dim() != 3:
        raise ValueError(f"{name}: expected q (B, Hq, D) and k_q (B, C, F), got {tuple(q.shape)} / {tuple(k_q.shape)}")
    B, Hq, D = q.shape
    Hk = n_heads
    C = k_q.shape[1]
    if (
        k_q.shape != (B, C, Hk * D * bits // 8) or v_q.shape != k_q.shape
        or k_s.shape != (B, C, Hk) or v_s.shape != k_s.shape or lengths.shape != (B,)
    ):
        raise ValueError(
            f"{name}: q {tuple(q.shape)} k_q {tuple(k_q.shape)} k_s {tuple(k_s.shape)} lengths "
            f"{tuple(lengths.shape)} with Hk={Hk}"
        )
    check_shape(C, Hq, Hk, D, bits)
    cluster = decode_cluster_size(C)
    for t in (q, k_q, k_s, v_q, v_s, lengths):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    check_on_cuda(name, q, k_q, k_s, v_q, v_s, lengths)
    if q.data_ptr() % 8 or k_q.data_ptr() % 4 or v_q.data_ptr() % 4:
        raise ValueError(f"{name}: q must be 8-byte aligned and the caches 4-byte aligned")
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    err = getattr(_build.lib(), entry)(
        q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, C, Hq, Hk, D, cluster, D**-0.5, _build.stream_ptr(q),
    )
    _build.check(err, name)
    return out


def decode_attention_int8_flat(
    q: torch.Tensor,  # (B, Hq, D) bf16 on the card
    k_q: torch.Tensor,
    k_s: torch.Tensor,
    v_q: torch.Tensor,
    v_s: torch.Tensor,
    lengths: torch.Tensor,
    n_heads: int,
) -> torch.Tensor:
    """(B, Hq, D) attention output of one new token per row; positions
    <= lengths[b] (>= 0) are live."""
    if q.device.type == "cpu":
        return decode_attention_int8_flat_plain(q, k_q, k_s, v_q, v_s, lengths, n_heads)
    out = _launch("decode_attention_int8_flat", "srgpt_decode_attention", 8, q, k_q, k_s, v_q, v_s, lengths, n_heads)
    global launches
    launches += 1
    return out


def decode_attention_int4_flat(
    q: torch.Tensor,  # (B, Hq, D) bf16 on the card
    k_q: torch.Tensor,  # (B, C, Hk*D/2) int8: packed nibbles
    k_s: torch.Tensor,
    v_q: torch.Tensor,
    v_s: torch.Tensor,
    lengths: torch.Tensor,
    n_heads: int,
) -> torch.Tensor:
    """The packed-int4 form: (B, Hq, D) attention output of one new token
    per row over ``quantize_kv4``'s cache; positions <= lengths[b] are
    live."""
    if q.device.type == "cpu":
        return decode_attention_int4_flat_plain(q, k_q, k_s, v_q, v_s, lengths, n_heads)
    out = _launch("decode_attention_int4_flat", "srgpt_decode_attention_int4", 4, q, k_q, k_s, v_q, v_s, lengths,
                  n_heads)
    global launches_int4
    launches_int4 += 1
    return out
