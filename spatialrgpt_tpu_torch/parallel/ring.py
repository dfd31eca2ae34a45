"""Ring sequence-parallel attention: blockwise KV rotation around the ring
group (port of ``spatialrgpt_tpu/parallel/ring.py``).

K/V chunks travel to the next rank of the ring with ``batch_isend_irecv``
(``parallel/comm.py::ring_exchange``, the reference's NCCL scheme,
ring/utils.py:71-109); partial outputs merge with the online-softmax rule

    m_new = max(m_a, m_b)
    o_new = o_a * exp(m_a - m_new) + o_b * exp(m_b - m_new)
    l_new = l_a * exp(m_a - m_new) + l_b * exp(m_b - m_new)

A block's mode comes from the global chunk ids of its q and kv chunks:
0 skip, 1 causal (diagonal), 2 full, 3 strict causal (the striped
layout's off-diagonal).  A rank knows its own chunk ids, so a skipped
block is not computed (merging an empty block changes nothing).

The cores are ``autograd.Function``s with the reference's fused backward:
the forward keeps only (out, lse); the backward rotates K/V around the
ring again, recomputes each block's probabilities from lse and
accumulates dK/dV on buffers that travel with their chunks, so that after
sp rotations each returns to its owner (ring_flash_attn_backward,
ring/ring_flash_attn.py:62-100).  Blocks are plain PyTorch: scores and
sums in f32, the probabilities cast to the inputs' dtype for the PV
product (the values are those of the reference's XLA blocks; on f32
inputs every cast is a no-op).

Layouts: ``ring_attention`` takes contiguous chunks (rank r holds
positions [r S_l, (r + 1) S_l)), ``stripe_ring_attention`` the round-robin
stripes of ``stripe_permutation``, ``zigzag_ring_attention`` the chunk
pairs (r, 2 sp - 1 - r) of ``zigzag_permutation``.  The caller lays the
sequence out and slices it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from spatialrgpt_tpu_torch.parallel import comm

NEG_INF = -1e30


def _f32_mm(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with f32 sums of the products of a and b (exact products of
    bf16 values in f32)."""
    return torch.einsum(eq, a.float(), b.float())


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    return x.repeat_interleave(n_rep, dim=2) if n_rep > 1 else x


def _block_mask(mode: int, sq: int, sk: int, q_seg, kv_seg, device) -> torch.Tensor:
    """(B or 1, 1, Sq, Sk) bool: the block's causal rule and the segment
    rule (same segment, query not padding)."""
    qi = torch.arange(sq, device=device)[:, None]
    ki = torch.arange(sk, device=device)[None, :]
    if mode == 1:
        mask = qi >= ki
    elif mode == 3:
        mask = qi > ki
    else:
        mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    mask = mask[None, None]
    if q_seg is not None:
        seg = (q_seg[:, :, None] == kv_seg[:, None, :]) & (q_seg != 0)[:, :, None]
        mask = mask & seg[:, None]
    return mask


def _block_attn(q, k, v, mode: int, q_seg, kv_seg) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One q-chunk x kv-chunk block: (m (B,H,Sq,1), l (B,H,Sq,1),
    o (B,Sq,H,D) = sum exp(s - m) v), all f32."""
    d = q.shape[3]
    n_rep = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    s = _f32_mm("bqhd,bkhd->bhqk", q, k) * (d**-0.5)
    mask = _block_mask(mode, q.shape[1], k.shape[1], q_seg, kv_seg, q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - torch.where(m == NEG_INF, 0.0, m)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = _f32_mm("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return m, l, o


def _merge(m_a, l_a, o_a, m_b, l_b, o_b):
    """Online-softmax merge of two (m, l, o) partials (o in (B,S,H,D))."""
    m_new = torch.maximum(m_a, m_b)
    m_safe = torch.where(m_new == NEG_INF, 0.0, m_new)
    s_a = torch.where(m_a == NEG_INF, 0.0, torch.exp(m_a - m_safe))
    s_b = torch.where(m_b == NEG_INF, 0.0, torch.exp(m_b - m_safe))
    l_new = l_a * s_a + l_b * s_b
    o_new = o_a * s_a.transpose(1, 2) + o_b * s_b.transpose(1, 2)
    return m_new, l_new, o_new


def _contig_mode(src: int, my: int) -> int:
    """Contiguous layout: diagonal causal, below full, above skipped."""
    return 1 if src == my else (2 if src < my else 0)


def _stripe_mode(src: int, my: int) -> int:
    """Striped layout (rank r holds global tokens r, r + sp, ...): local q
    index a against kv index b are globals a sp + my and b sp + src, so
    the rule is a >= b when my >= src and a > b otherwise (the reference's
    stripe_flash_attn schedule, ring/stripe_flash_attn.py)."""
    return 1 if src <= my else 3


def _pair_mode(k_id: int, q_id: int) -> int:
    return 1 if k_id == q_id else (2 if k_id < q_id else 0)


def _finish(o_acc, l_acc, m_acc, segment_ids, dtype):
    l_safe = torch.where(l_acc == 0.0, 1.0, l_acc)
    out = o_acc / l_safe.transpose(1, 2)
    if segment_ids is not None:
        out = out * (segment_ids != 0)[:, :, None, None].to(out.dtype)
    lse = torch.where(l_acc > 0.0, m_acc + torch.log(l_safe), NEG_INF)
    return out.to(dtype), lse


def _accumulators(b: int, s: int, hq: int, d: int, device):
    return (torch.full((b, hq, s, 1), NEG_INF, device=device), torch.zeros((b, hq, s, 1), device=device),
            torch.zeros((b, s, hq, d), device=device))


def _ring_forward(q, k, v, segment_ids, group, mode_fn):
    """The ring loop; returns (out, lse (B,Hq,S,1) f32)."""
    sp, my = comm.group_size(group), comm.group_rank(group)
    b, s, hq, d = q.shape
    m_acc, l_acc, o_acc = _accumulators(b, s, hq, d, q.device)
    kc, vc, seg_c = k, v, segment_ids
    for t in range(sp):
        src = (my - t) % sp  # owner of the kv chunk held now
        mode = mode_fn(src, my)
        if mode:
            m_acc, l_acc, o_acc = _merge(m_acc, l_acc, o_acc, *_block_attn(q, kc, vc, mode, segment_ids, seg_c))
        if t < sp - 1:
            kc, vc, seg_c = _rotate(group, kc, vc, seg_c)
    return _finish(o_acc, l_acc, m_acc, segment_ids, q.dtype)


def _rotate(group, *tensors):
    """Each tensor (None passes through) to the next rank of the ring."""
    live = [t for t in tensors if t is not None]
    moved = iter(comm.ring_exchange(live, group))
    return tuple(None if t is None else next(moved) for t in tensors)


def _block_bwd(q, kc, vc, g32, lse, delta, mode: int, q_seg, kv_seg):
    """Recompute one block's probabilities from lse; partial (dq, dk_chunk,
    dv_chunk), all f32: p = exp(s - lse); ds = p (g v^T - delta);
    dq = ds k; dk = ds^T q; dv = p^T g."""
    b, sq, hq, d = q.shape
    hk = kc.shape[2]
    n_rep = hq // hk
    k, v = _repeat_kv(kc, n_rep), _repeat_kv(vc, n_rep)
    scale = d**-0.5
    s = _f32_mm("bqhd,bkhd->bhqk", q, k) * scale
    mask = _block_mask(mode, sq, k.shape[1], q_seg, kv_seg, q.device)
    lse_safe = torch.where(lse == NEG_INF, 0.0, lse)
    p = torch.where(mask, torch.exp(s - lse_safe), 0.0)
    # inputs of the products in the inputs' dtype, f32 sums (the
    # flash-attention-2 scheme of the reference; no-op on f32 inputs)
    g_in = g32.to(q.dtype)
    dv = _f32_mm("bhqk,bqhd->bkhd", p.to(q.dtype), g_in)
    dp = _f32_mm("bqhd,bkhd->bhqk", g_in, v)
    ds = p * (dp - delta)
    dq = _f32_mm("bhqk,bkhd->bqhd", ds.to(k.dtype), k) * scale
    dk = _f32_mm("bhqk,bqhd->bkhd", ds.to(q.dtype), q) * scale
    if n_rep > 1:
        sk = kc.shape[1]
        dk = dk.reshape(b, sk, hk, n_rep, d).sum(dim=3)
        dv = dv.reshape(b, sk, hk, n_rep, d).sum(dim=3)
    return dq, dk, dv


def _delta(g32, out):
    """rowsum(g * out) as (B, H, S, 1)."""
    return torch.einsum("bshd,bshd->bsh", g32, out.float()).transpose(1, 2)[..., None]


class _RingCore(torch.autograd.Function):
    """Ring attention over contiguous or striped chunks (``mode_fn``)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, group, mode_fn):
        out, lse = _ring_forward(q, k, v, segment_ids, group, mode_fn)
        ctx.save_for_backward(q, k, v, segment_ids, out, lse)
        ctx.group, ctx.mode_fn = group, mode_fn
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, segment_ids, out, lse = ctx.saved_tensors
        group, mode_fn = ctx.group, ctx.mode_fn
        sp, my = comm.group_size(group), comm.group_rank(group)
        g32 = g.float()
        delta = _delta(g32, out)
        dq = torch.zeros(q.shape, device=q.device)
        # dk / dv travel WITH their kv chunks: after sp rotations each is
        # home, holding every rank's contribution
        kc, vc, seg_c = k, v, segment_ids
        dk = torch.zeros(k.shape, device=k.device)
        dv = torch.zeros(v.shape, device=v.device)
        for t in range(sp):
            mode = mode_fn((my - t) % sp, my)
            if mode:
                dq_p, dk_p, dv_p = _block_bwd(q, kc, vc, g32, lse, delta, mode, segment_ids, seg_c)
                dq, dk, dv = dq + dq_p, dk + dk_p, dv + dv_p
            kc, vc, dk, dv, seg_c = _rotate(group, kc, vc, dk, dv, seg_c)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def _local(q, k, v, segment_ids):
    from spatialrgpt_tpu_torch.ops.attention import causal_attention

    return causal_attention(q, k, v, segment_ids=segment_ids)


def ring_attention(
    q: torch.Tensor,  # (B, S_local, Hq, D): contiguous chunk r on ring rank r
    k: torch.Tensor,  # (B, S_local, Hk, D)
    v: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,  # (B, S_local)
    group=None,
) -> torch.Tensor:
    """Causal ring attention over the ring ``group`` (the reference's
    default contiguous layout); see ``zigzag_ring_attention`` for the
    load-balanced variant."""
    if comm.group_size(group) == 1:
        return _local(q, k, v, segment_ids)
    return _RingCore.apply(q, k, v, segment_ids, group, _contig_mode)


# ---------------------------------------------------------------------------
# Striped layout (round-robin load-balanced causal ring)
# ---------------------------------------------------------------------------


def stripe_permutation(seq_len: int, sp: int):
    """Global permutation for the striped layout: rank i holds tokens i,
    i + sp, i + 2 sp, ... (round-robin).  Returns (perm, inv_perm):
    ``x[:, perm]`` cut into sp contiguous chunks gives each rank its
    stripe; ``y[:, inv]`` restores global order."""
    assert seq_len % sp == 0
    perm = np.concatenate([np.arange(i, seq_len, sp) for i in range(sp)])
    return perm, np.argsort(perm)


def stripe_ring_attention(
    q: torch.Tensor,  # (B, S_local, Hq, D): stripe r of the global sequence
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,  # (B, S_local), striped too
    group=None,
) -> torch.Tensor:
    """Causal ring attention over the striped (round-robin) layout (the
    reference's stripe_flash_attn variant,
    llava/train/sequence_parallel/ring/stripe_flash_attn.py): every block is
    a triangle, inclusive when the kv stripe id <= the q stripe id, strict
    otherwise, so no ring step is skipped or full.  Lay inputs out with
    ``stripe_permutation``."""
    if comm.group_size(group) == 1:
        return _local(q, k, v, segment_ids)
    return _RingCore.apply(q, k, v, segment_ids, group, _stripe_mode)


# ---------------------------------------------------------------------------
# Zigzag layout (load-balanced causal ring)
# ---------------------------------------------------------------------------


def zigzag_permutation(seq_len: int, sp: int):
    """Global permutation for the zigzag layout: the sequence in 2 sp chunks,
    rank i holding chunks (i, 2 sp - 1 - i) (the reference's
    zigzag_ring_flash_attn schedule, ring/zigzag_ring_flash_attn.py:23-30).
    Returns (perm, inv_perm)."""
    assert seq_len % (2 * sp) == 0
    chunk = seq_len // (2 * sp)
    order = []
    for i in range(sp):
        order += [i, 2 * sp - 1 - i]
    perm = np.concatenate([np.arange(c * chunk, (c + 1) * chunk) for c in order])
    return perm, np.argsort(perm)


def _halves(x):
    if x is None:
        return None, None
    half = x.shape[1] // 2
    return x[:, :half], x[:, half:]


def _zigzag_forward(q, k, v, segment_ids, group):
    sp, my = comm.group_size(group), comm.group_rank(group)
    b, s, hq, d = q.shape
    half = s // 2
    q_ids = (my, 2 * sp - 1 - my)
    acc = [list(_accumulators(b, half, hq, d, q.device)) for _ in range(2)]
    q_halves, qseg_halves = _halves(q), _halves(segment_ids)
    kc, vc, seg_c = k, v, segment_ids
    for t in range(sp):
        src = (my - t) % sp
        k_ids = (src, 2 * sp - 1 - src)
        k_halves, v_halves, seg_halves = _halves(kc), _halves(vc), _halves(seg_c)
        for qh in range(2):
            for kh in range(2):
                mode = _pair_mode(k_ids[kh], q_ids[qh])
                if mode:
                    blk = _block_attn(q_halves[qh], k_halves[kh], v_halves[kh], mode, qseg_halves[qh], seg_halves[kh])
                    acc[qh] = list(_merge(*acc[qh], *blk))
        if t < sp - 1:
            kc, vc, seg_c = _rotate(group, kc, vc, seg_c)
    m_acc = torch.cat([acc[0][0], acc[1][0]], dim=2)
    l_acc = torch.cat([acc[0][1], acc[1][1]], dim=2)
    o_acc = torch.cat([acc[0][2], acc[1][2]], dim=1)
    return _finish(o_acc, l_acc, m_acc, segment_ids, q.dtype)


class _ZigzagCore(torch.autograd.Function):
    """Zigzag ring attention (the same rotating-accumulator backward as
    ``_RingCore``, over the four half pairs of each step)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, group):
        out, lse = _zigzag_forward(q, k, v, segment_ids, group)
        ctx.save_for_backward(q, k, v, segment_ids, out, lse)
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, segment_ids, out, lse = ctx.saved_tensors
        group = ctx.group
        sp, my = comm.group_size(group), comm.group_rank(group)
        half = q.shape[1] // 2
        q_ids = (my, 2 * sp - 1 - my)
        g32 = g.float()
        delta = _delta(g32, out)
        dq = torch.zeros(q.shape, device=q.device)
        kc, vc, seg_c = k, v, segment_ids
        dk = torch.zeros(k.shape, device=k.device)
        dv = torch.zeros(v.shape, device=v.device)
        q_halves, qseg_halves, g_halves = _halves(q), _halves(segment_ids), _halves(g32)
        for t in range(sp):
            src = (my - t) % sp
            k_ids = (src, 2 * sp - 1 - src)
            k_halves, v_halves, seg_halves = _halves(kc), _halves(vc), _halves(seg_c)
            for qh in range(2):
                qsl = slice(qh * half, (qh + 1) * half)
                for kh in range(2):
                    mode = _pair_mode(k_ids[kh], q_ids[qh])
                    if not mode:
                        continue
                    dq_p, dk_p, dv_p = _block_bwd(
                        q_halves[qh], k_halves[kh], v_halves[kh], g_halves[qh], lse[:, :, qsl], delta[:, :, qsl],
                        mode, qseg_halves[qh], seg_halves[kh])
                    ksl = slice(kh * half, (kh + 1) * half)
                    dq[:, qsl] += dq_p
                    dk[:, ksl] += dk_p
                    dv[:, ksl] += dv_p
            # rotate every step (sp in all): dk / dv return to their owners
            kc, vc, dk, dv, seg_c = _rotate(group, kc, vc, dk, dv, seg_c)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def zigzag_ring_attention(
    q: torch.Tensor,  # (B, S_local, Hq, D): the local zigzag pair (chunks i, 2P-1-i)
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,
    group=None,
) -> torch.Tensor:
    """Causal ring attention with zigzag load balancing: every rank owns
    one early and one late chunk, so the causal triangle's work is even
    across the ring.  Each step decomposes into the four (q-half, kv-half)
    chunk pairs, whose modes come from the global chunk ids."""
    if comm.group_size(group) == 1:
        return _local(q, k, v, segment_ids)
    return _ZigzagCore.apply(q, k, v, segment_ids, group)
