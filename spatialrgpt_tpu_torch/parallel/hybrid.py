"""Hybrid 2D sequence parallelism: Ulysses (head all-to-all) x Ring (KV
rotation), the port of ``spatialrgpt_tpu/parallel/hybrid.py`` (the
reference's HybridAttention, llava/train/sequence_parallel/hybrid_attn.py):
the sp degree factors as ulysses x ring; the all-to-all reshards heads over
the ulysses group and ring attention runs over the ring group on the
head-sharded, sequence-longer view.
"""

from __future__ import annotations

from typing import Optional

import torch

from spatialrgpt_tpu_torch.parallel import comm
from spatialrgpt_tpu_torch.parallel.ring import ring_attention


def hybrid_attention(
    q: torch.Tensor,  # (B, S_local, Hq, D); S_local = S / (ulysses * ring)
    k: torch.Tensor,
    v: torch.Tensor,
    segment_ids: Optional[torch.Tensor],
    ulysses_group,
    ring_group,
) -> torch.Tensor:
    """IMPORTANT: the sequence is laid out ring-major: rank (u, r) holds
    global chunk r U + u (``SPContext.seq_chunk``).  The ulysses all-to-all
    then concatenates the U chunks {r U + u} into the contiguous range
    [r S/R, (r + 1) S/R), exactly the contiguous ring chunk that ring
    attention's causal step-skipping assumes.  After the all-to-all each
    rank holds (B, S / ring, H / ulysses, D) and ring attention completes
    the job."""
    u = comm.group_size(ulysses_group)
    if u > 1:
        q, k, v = (comm.ScatterHeads.apply(t.contiguous(), ulysses_group) for t in (q, k, v))
        if segment_ids is not None:
            segment_ids = comm.all_gather_cat(segment_ids, ulysses_group, dim=1)
    out = ring_attention(q, k, v, segment_ids=segment_ids, group=ring_group)
    return comm.GatherHeads.apply(out.contiguous(), ulysses_group) if u > 1 else out
