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
"""

from __future__ import annotations

import torch

from spatialrgpt_tpu_torch.ops import _build
from spatialrgpt_tpu_torch.ops._checks import check_dtype, check_on_cuda

NEG_INF = -1e30

launches = 0  # kernel launches since the last reset (plain-path calls do not count)

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
    name = "decode_attention_int8_flat"
    check_dtype(name, torch.bfloat16, q)
    check_dtype(name, torch.int8, k_q, v_q)
    check_dtype(name, torch.float32, k_s, v_s)
    check_dtype(name, torch.int32, lengths)
    if q.dim() != 3 or k_q.dim() != 3:
        raise ValueError(f"{name}: expected q (B, Hq, D) and k_q (B, C, Hk*D), got {tuple(q.shape)} / {tuple(k_q.shape)}")
    B, Hq, D = q.shape
    Hk = n_heads
    C = k_q.shape[1]
    if (
        k_q.shape != (B, C, Hk * D) or v_q.shape != k_q.shape
        or k_s.shape != (B, C, Hk) or v_s.shape != k_s.shape or lengths.shape != (B,)
    ):
        raise ValueError(
            f"decode_attention_int8_flat: q {tuple(q.shape)} k_q {tuple(k_q.shape)} "
            f"k_s {tuple(k_s.shape)} lengths {tuple(lengths.shape)} with Hk={Hk}"
        )
    if Hq % Hk or Hq // Hk > 8 or D % 4 or D > 256:
        raise ValueError(f"decode_attention_int8_flat: Hq={Hq} Hk={Hk} D={D} not supported")
    cluster = decode_cluster_size(C)
    if -(-C // cluster) * (Hq // Hk) > DECODE_MAX_SCORES:
        raise ValueError(
            f"decode_attention_int8_flat: C={C} over {cluster} CTAs with {Hq // Hk} query heads per kv head "
            f"needs more than the {DECODE_MAX_SCORES} scores a CTA holds in shared memory"
        )
    for t in (q, k_q, k_s, v_q, v_s, lengths):
        if not t.is_contiguous():
            raise ValueError("decode_attention_int8_flat: inputs must be contiguous")
    check_on_cuda(name, q, k_q, k_s, v_q, v_s, lengths)
    if q.data_ptr() % 8 or k_q.data_ptr() % 4 or v_q.data_ptr() % 4:
        raise ValueError(f"{name}: q must be 8-byte aligned and the int8 caches 4-byte aligned")
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    err = _build.lib().srgpt_decode_attention(
        q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, C, Hq, Hk, D, cluster, D**-0.5, _build.stream_ptr(q),
    )
    _build.check(err, "decode_attention_int8_flat")
    global launches
    launches += 1
    return out
