"""Ulysses sequence parallelism: head-scatter / sequence-gather all-to-all
(port of ``spatialrgpt_tpu/parallel/ulysses.py``).

Each rank of the ulysses group holds a sequence slice (B, S/P, H, D); one
``all_to_all_single`` reshards to the full sequence and a head slice (B, S,
H/P, D), the local attention runs on the full sequence, and the inverse
all-to-all restores the sequence slice.  Both all-to-alls are
``autograd.Function``s whose backward is the inverse all-to-all
(``parallel/comm.py``).  Shards are equal by construction: the caller
slices the sequence into P equal chunks, chunk r on rank r.
"""

from __future__ import annotations

from typing import Optional

import torch

from spatialrgpt_tpu_torch.parallel import comm


def ulysses_attention(
    q: torch.Tensor,  # (B, S_local, Hq, D) - this rank's sequence slice
    k: torch.Tensor,  # (B, S_local, Hk, D)
    v: torch.Tensor,  # (B, S_local, Hk, D)
    segment_ids: Optional[torch.Tensor],  # (B, S_local) or None
    group,
    impl: str = "xla",
) -> torch.Tensor:
    """Causal attention over the ulysses ``group``'s whole sequence; the
    local attention is ``causal_attention(..., impl=impl)`` at (B, S, Hq/P,
    D) with Hk/P kv heads (K4 with ``impl="pallas"`` on the card).

    The degree must divide both head counts (the reference asserts the
    same, hybrid_attn.py:291-294); with GQA that is Hk % P == 0."""
    from spatialrgpt_tpu_torch.ops.attention import causal_attention

    sp = comm.group_size(group)
    if sp == 1:
        return causal_attention(q, k, v, segment_ids=segment_ids, impl=impl)
    if q.shape[2] % sp != 0 or k.shape[2] % sp != 0:
        raise ValueError(
            f"Ulysses degree {sp} must divide both head counts "
            f"(Hq={q.shape[2]}, Hk={k.shape[2]}); repeat KV heads or lower "
            f"the ulysses degree (reference asserts the same, "
            f"hybrid_attn.py:291-294)"
        )
    qg, kg, vg = (comm.ScatterHeads.apply(t.contiguous(), group) for t in (q, k, v))
    seg_full = None
    if segment_ids is not None:
        # the full-sequence segment ids (the reference all-reduces the
        # global attention mask, ulysses_attn.py:125-164)
        seg_full = comm.all_gather_cat(segment_ids, group, dim=1)
    out = causal_attention(qg, kg, vg, segment_ids=seg_full, impl=impl)
    return comm.GatherHeads.apply(out.contiguous(), group)
