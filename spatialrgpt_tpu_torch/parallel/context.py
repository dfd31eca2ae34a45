"""Sequence-parallel execution context (port of
``spatialrgpt_tpu/parallel/context.py``).

A module-level context names the mesh dims the attention ops use and
holds their process groups; model code reads it only when ``attn_impl``
selects a sequence-parallel implementation.  ``inner_impl`` is the local
attention after the Ulysses all-to-all: ``"pallas"`` (K4) on the card,
``"xla"`` (K4's plain version) on the CPU.

The context also says which slice of a row's sequence this rank holds
(``seq_chunk``): with a Ulysses degree U and a ring degree R, rank
(u, r) holds chunk ``r * U + u`` of ``U * R`` equal chunks, the
ring-major layout of ``parallel/hybrid.py``; with one of the two degrees
at 1 this is the plain contiguous layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from spatialrgpt_tpu_torch.parallel import comm

SP_IMPLS = ("ulysses", "ring", "hybrid")


@dataclass
class SPContext:
    mesh: object  # torch.distributed.device_mesh.DeviceMesh
    ulysses_axis: Optional[str] = None  # e.g. "sp" or "sp_u"
    ring_axis: Optional[str] = None  # e.g. "sp_r"
    inner_impl: str = "xla"

    def _size(self, axis: Optional[str]) -> int:
        return 1 if axis is None else self.mesh.size(self.mesh.mesh_dim_names.index(axis))

    def _rank(self, axis: Optional[str]) -> int:
        return 0 if axis is None else self.mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of one of the context's mesh dims."""
        return self.mesh.get_group(axis)

    @property
    def ulysses_degree(self) -> int:
        return self._size(self.ulysses_axis)

    @property
    def ring_degree(self) -> int:
        return self._size(self.ring_axis)

    @property
    def sp_degree(self) -> int:
        return self.ulysses_degree * self.ring_degree

    @property
    def seq_chunk(self) -> int:
        """The chunk of the sequence this rank holds (ring-major)."""
        return self._rank(self.ring_axis) * self.ulysses_degree + self._rank(self.ulysses_axis)


_CONTEXT: Optional[SPContext] = None


def set_sp_context(ctx: Optional[SPContext]) -> None:
    global _CONTEXT
    _CONTEXT = ctx


def get_sp_context() -> Optional[SPContext]:
    return _CONTEXT


def sp_context(impl: str) -> SPContext:
    """The ambient context, which an sp ``impl`` needs."""
    if _CONTEXT is None:
        raise RuntimeError(f"attn impl '{impl}' requires set_sp_context(...)")
    return _CONTEXT


def seq_shard(x: torch.Tensor, ctx: SPContext, dim: int = 1) -> torch.Tensor:
    """This rank's chunk of a sequence axis (``seq_chunk`` of ``sp_degree``
    equal chunks)."""
    n, S = ctx.sp_degree, x.shape[dim]
    if S % n:
        raise ValueError(f"sequence length {S} does not split into {n} sequence-parallel chunks")
    return x.narrow(dim, ctx.seq_chunk * (S // n), S // n)


def gather_sequence(x: torch.Tensor, ctx: SPContext, dim: int = 1) -> torch.Tensor:
    """The inverse of ``seq_shard`` (no gradient): gathered over the
    ulysses group, then the ring group; the ring-major layout makes the
    result the sequence in order."""
    for axis in (ctx.ulysses_axis, ctx.ring_axis):
        if axis is not None and ctx._size(axis) > 1:
            x = comm.all_gather_cat(x, ctx.group(axis), dim=dim)
    return x


def sp_sum(x: torch.Tensor, ctx: SPContext) -> torch.Tensor:
    """x summed over every sp rank of the group (each rank's sum over its
    sequence chunk -> the whole row's); the gradient passes through."""
    for axis in (ctx.ulysses_axis, ctx.ring_axis):
        if axis is not None and ctx._size(axis) > 1:
            x = comm.AllReduceSum.apply(x, ctx.group(axis))
    return x


def default_inner_impl(device) -> str:
    """The local attention of the Ulysses route: K4 on a CUDA device, its
    plain version elsewhere (the reference's ``pallas`` on a TPU, ``xla``
    otherwise)."""
    return "pallas" if torch.device(device).type == "cuda" else "xla"
