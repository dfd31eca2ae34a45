"""Pipeline parallelism for the decoder stack, the GPipe schedule (port of
``spatialrgpt_tpu/parallel/pipeline.py``).

Stages are contiguous blocks of decoder layers, one stage a rank of the
``pp`` mesh dim; activations travel from stage to stage over the ring of
that dim (``parallel/comm.py::RingShift``, whose backward sends the
gradient the other way), and the schedule is a loop over ticks, so
autograd through it is the backward pipeline (GPipe: the forward ticks'
activations are kept; ``remat=True`` recomputes each layer instead).

Layout contract:
  - ``pp_shard_params`` keeps a rank's stage of the (homogeneous) layers
    in ``llm.model.layers``; everything else (embeddings, final norm, head)
    stays whole on every rank.
  - the batch splits into M microbatches along the batch axis; at tick t
    stage s runs microbatch t - s (bubble fraction (pp - 1) / (M + pp - 1)).
  - position and segment ids travel with their microbatch, so each stage
    masks attention for the tokens it holds.
  - every rank runs every tick, the bubble ticks on a stale or zero
    microbatch whose result nothing keeps (as the reference's SPMD scan):
    each rank's graph is the same, so the ring exchanges of the backward
    pair up.

The last stage's outputs reach every rank through a masked all-reduce (the
reference's ``psum``), whose backward hands each rank the gradient of the
replicated result unchanged.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from spatialrgpt_tpu_torch.config import LlamaConfig
from spatialrgpt_tpu_torch.parallel import comm
from spatialrgpt_tpu_torch.parallel.mesh import mesh_rank, mesh_size


def make_pp_mesh(pp: int):
    """A 1-D ``pp`` mesh over every rank of the process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if dist.get_world_size() != pp:
        raise ValueError(f"a pp={pp} mesh needs {pp} ranks, the process group has {dist.get_world_size()}")
    return init_device_mesh("cuda" if dist.get_backend() == "nccl" else "cpu", (pp,), mesh_dim_names=("pp",))


def stack_layer_params(llm: nn.Module) -> List[nn.Module]:
    """The decoder's layers, checked to be homogeneous (every layer holds
    the same parameter names and shapes: the dense families, or the sparse
    MoE with stacked experts), as the reference's stacking requires."""
    layers = list(llm.model.layers)
    shapes = [[(n, tuple(p.shape)) for n, p in layer.named_parameters()] for layer in layers]
    if any(s != shapes[0] for s in shapes):
        raise ValueError("pipeline stages need homogeneous decoder layers")
    return layers


def pp_shard_params(llm: nn.Module, mesh, axis_name: str = "pp") -> nn.Module:
    """In place: ``llm`` keeps only its stage's layers, stage s holding
    layers [s L / pp, (s + 1) L / pp); returns it."""
    layers = stack_layer_params(llm)
    pp, stage = mesh_size(mesh, axis_name), mesh_rank(mesh, axis_name)
    if len(layers) % pp:
        raise ValueError(f"{len(layers)} layers do not split into {pp} stages")
    n = len(layers) // pp
    llm.model.layers = nn.ModuleList(layers[stage * n : (stage + 1) * n])
    return llm


def _stage_apply(layers, x, pos, seg, cfg: LlamaConfig, remat: bool):
    """This rank's block of layers."""
    from spatialrgpt_tpu_torch.models.llama import _layer_checkpointed

    for layer in layers:
        if remat:
            x = checkpoint(_layer_checkpointed, x, layer, cfg, pos, seg, "xla", None, use_reentrant=False)[0]
        else:
            x = layer(x, cfg, pos, seg, "xla")[0]
    return x


def pipeline_forward(
    llm: nn.Module,
    cfg: LlamaConfig,
    *,
    inputs_embeds: torch.Tensor,  # (B, S, H), the same on every rank
    position_ids: torch.Tensor,  # (B, S)
    segment_ids: Optional[torch.Tensor],  # (B, S)
    mesh,
    axis_name: str = "pp",
    num_microbatches: int = 0,  # 0 -> one per stage
    remat: bool = False,
) -> torch.Tensor:
    """Decoder hidden states through the pipelined stack (the layers before
    the final norm; the caller applies the norm and the head), on every
    rank.  Differentiable end to end."""
    group = mesh.get_group(axis_name)
    pp, stage = mesh_size(mesh, axis_name), mesh_rank(mesh, axis_name)
    B, S, H = inputs_embeds.shape
    M = num_microbatches or pp
    if B % M:
        raise ValueError(f"batch {B} must divide into {M} microbatches")
    Bm = B // M
    if segment_ids is None:
        segment_ids = torch.ones((B, S), dtype=torch.int32, device=inputs_embeds.device)
    mb_x = inputs_embeds.reshape(M, Bm, S, H)
    mb_pos = position_ids.reshape(M, Bm, S)
    mb_seg = segment_ids.reshape(M, Bm, S)
    dev = inputs_embeds.device
    first = torch.tensor(stage == 0, device=dev)
    T = M + pp - 1

    x = inputs_embeds.new_zeros((Bm, S, H))
    pos, seg = mb_pos.new_zeros((Bm, S)), mb_seg.new_zeros((Bm, S))
    outs = [inputs_embeds.new_zeros((Bm, S, H)) for _ in range(M)]
    for t in range(T):
        # stage 0 injects microbatch t (clamped; the extra ticks' results are dropped)
        inject = min(t, M - 1)
        x = torch.where(first, mb_x[inject], x)
        pos = torch.where(first, mb_pos[inject], pos)
        seg = torch.where(first, mb_seg[inject], seg)
        y = _stage_apply(llm.model.layers, x, pos, seg, cfg, remat)
        # the last stage collects microbatch t - (pp - 1) when in range
        slot = min(max(t - (pp - 1), 0), M - 1)
        valid = torch.tensor(stage == pp - 1 and t >= pp - 1, device=dev)
        outs[slot] = torch.where(valid, y, outs[slot])
        if t < T - 1:  # activations (and their ids) to the next stage
            x = comm.RingShift.apply(y, group)
            pos, seg = comm.ring_exchange([pos, seg], group)
    last = torch.tensor(stage == pp - 1, device=dev)
    out = torch.where(last, torch.stack(outs), torch.zeros((), dtype=inputs_embeds.dtype, device=dev))
    return comm.AllReduceSum.apply(out, group).reshape(B, S, H)


def pipeline_logits(
    llm: nn.Module,
    cfg: LlamaConfig,
    *,
    input_ids: torch.Tensor,
    position_ids: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,
    mesh,
    axis_name: str = "pp",
    num_microbatches: int = 0,
    remat: bool = False,
) -> torch.Tensor:
    """ids -> f32 logits through the pipelined decoder (embedding, pipeline,
    final norm, head; the embedding and the head are whole on every
    rank)."""
    from spatialrgpt_tpu_torch.models import llama

    x = llama.embed_tokens(llm, input_ids)
    h = pipeline_forward(llm, cfg, inputs_embeds=x, position_ids=position_ids, segment_ids=segment_ids, mesh=mesh,
                         axis_name=axis_name, num_microbatches=num_microbatches, remat=remat)
    return llama.logits(llm, llama.norm(h, llm.model.norm))
