"""The collectives of the parallel stack, as differentiable functions where
autograd must carry gradients through them.

Each function takes the process group of one mesh dim
(``DeviceMesh.get_group(name)``); a rank's index in that group is its
coordinate along the dim.  Point-to-point peers are given as global ranks
(``dist.get_global_rank``), which every version of ``batch_isend_irecv``
takes.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def group_rank(group) -> int:
    return dist.get_rank(group)


def group_size(group) -> int:
    return dist.get_world_size(group)


def ring_exchange(tensors: Sequence[torch.Tensor], group, reverse: bool = False) -> List[torch.Tensor]:
    """Send each tensor to the next rank of the ring (``rank + 1``, or
    ``rank - 1`` with ``reverse``) and return what the previous rank sent:
    one ``batch_isend_irecv`` (the reference's NCCL ring step,
    ring/utils.py:71-109 in SURVEY)."""
    n, me = group_size(group), group_rank(group)
    step = -1 if reverse else 1
    nxt = dist.get_global_rank(group, (me + step) % n)
    prv = dist.get_global_rank(group, (me - step) % n)
    outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in tensors]  # contiguous
    ops = []
    for t, o in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, o, prv, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class RingShift(torch.autograd.Function):
    """``ring_exchange`` of one tensor with its gradient sent the other way
    (the transpose of a ring permutation is the reverse permutation)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ring_exchange([x], group)[0]

    @staticmethod
    def backward(ctx, g):
        return ring_exchange([g.contiguous()], ctx.group, reverse=True)[0], None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x (P, ...) contiguous: chunk j goes to rank j; chunk j of the result
    came from rank j."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _scatter_heads(x: torch.Tensor, group) -> torch.Tensor:
    # (B, S/P, H, D) -> (B, S, H/P, D): head chunk j to rank j, sequence
    # chunks concatenated in rank order
    P = group_size(group)
    B, S, H, D = x.shape
    y = x.reshape(B, S, P, H // P, D).permute(2, 0, 1, 3, 4).contiguous()
    y = _all_to_all(y, group)  # (P, B, S/P, H/P, D): y[j] = rank j's sequence chunk
    return y.permute(1, 0, 2, 3, 4).reshape(B, P * S, H // P, D)


def _gather_heads(x: torch.Tensor, group) -> torch.Tensor:
    # (B, S, H/P, D) -> (B, S/P, H, D): the inverse of _scatter_heads
    P = group_size(group)
    B, S, H, D = x.shape
    y = x.reshape(B, P, S // P, H, D).permute(1, 0, 2, 3, 4).contiguous()
    y = _all_to_all(y, group)  # y[j] = rank j's head chunk of my sequence
    return y.permute(1, 2, 0, 3, 4).reshape(B, S // P, P * H, D)


class ScatterHeads(torch.autograd.Function):
    """Ulysses' first all-to-all: sequence-sharded (B, S/P, H, D) ->
    head-sharded (B, S, H/P, D); backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _scatter_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_heads(g.contiguous(), ctx.group), None


class GatherHeads(torch.autograd.Function):
    """Ulysses' second all-to-all: head-sharded (B, S, H/P, D) ->
    sequence-sharded (B, S/P, H, D); backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_heads(g.contiguous(), ctx.group), None


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's x concatenated along ``dim`` in rank order (no
    gradient)."""
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class AllReduceSum(torch.autograd.Function):
    """Sum over the group in the forward; the backward passes the gradient
    through unchanged.  For a sum whose result every rank then uses
    identically (a row-parallel projection's partial sums, the pipeline's
    masked broadcast): each rank's gradient of the replicated result is
    already the whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class GatherLastDim(torch.autograd.Function):
    """All ranks' x concatenated along the last dim (the vocab-sharded
    logits); the backward keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return all_gather_cat(x, group, dim=-1)

    @staticmethod
    def backward(ctx, g):
        r = group_rank(ctx.group)
        return g[..., r * ctx.width : (r + 1) * ctx.width].contiguous(), None
