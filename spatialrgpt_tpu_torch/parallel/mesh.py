"""Device mesh construction and sharding rules (port of
``spatialrgpt_tpu/parallel/mesh.py``) on ``torch.distributed``.

One ``DeviceMesh`` (``init_device_mesh``) with dims

  dp    data parallel
  fsdp  parameter / optimizer-state sharding (ZeRO-3; FSDP2 ``fully_shard``)
  sp    sequence parallel (Ulysses / ring)
  tp    tensor parallel (Megatron-style serving)

or, for 2D sequence parallelism, ``("dp", "fsdp", "sp_u", "sp_r")``.  A
process is one rank; the mesh's size is the world size.

The rules are the reference's, as plain functions of a path and a shape:
``param_spec`` (FSDP), ``tp_param_spec`` (tensor parallel) and
``_path_name_tokens`` are verbatim copies, ``P`` standing for JAX's
``PartitionSpec`` (a tuple of mesh dims per tensor dim).  The port's
parameters keep PyTorch's layouts ((out, in) linears, (C_out, C_in, kh, kw)
convolutions), so ``jax_view`` gives each parameter the path and shape of
its twin in the reference's tree and the map from the twin's dims back to
its own.

- ``shard_model`` is ``shard_params``: FSDP2's ``fully_shard`` on each
  decoder layer, the tower and the projector, then on the whole model (the
  embeddings, the final norm, the head and the region extractor), each
  parameter on the dim ``param_spec`` chooses.  A parameter that
  ``param_spec`` replicates stays a plain replicated tensor (FSDP ignores
  it) and its gradient is summed by ``sync_replicated_grads``.  Parameters
  are replicated over dp and sp, as in the reference: FSDP2's replicate x
  shard (HSDP) form over the flattened (dp, sp) x fsdp dims.  The
  gradients are sums (FSDP's divide factor is 1): the loss is already
  normalised by the global number of targets (``models/vlm.py::loss_fn``).
- ``tp_shard_model`` is ``tp_shard_params``: each rank keeps its slice of
  every decoder projection (fan-out of wq / wk / wv / gate / up, fan-in of
  wo / down, the vocab of lm_head, the stacked experts likewise) and
  ``models/llama.py`` adds the collectives that GSPMD inserts in the
  reference.  Everything outside ``llm`` replicates.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import warnings
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

AXES = ("dp", "fsdp", "sp", "tp")
HYBRID_AXES = ("dp", "fsdp", "sp_u", "sp_r")
# every process group the stack makes waits this long for a peer
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def P(*axes):
    """JAX's ``PartitionSpec`` as a tuple: one mesh dim (or None) per
    tensor dim, trailing dims replicated."""
    return tuple(axes)


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _check_world(need: int, what: str) -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"{what} needs a process group of {need} ranks; none is initialised "
                           "(parallel/mesh.py::init_distributed)")
    world = dist.get_world_size()
    if need != world:
        raise ValueError(f"{what} needs {need} ranks, the process group has {world}")


def make_mesh(dp: int = 1, fsdp: int = 1, sp: int = 1, tp: int = 1):
    """(dp, fsdp, sp, tp) mesh over every rank of the process group."""
    from torch.distributed.device_mesh import init_device_mesh

    _check_world(dp * fsdp * sp * tp, f"mesh {dp}x{fsdp}x{sp}x{tp}")
    return init_device_mesh(_device_type(), (dp, fsdp, sp, tp), mesh_dim_names=AXES)


def make_hybrid_mesh(dp: int = 1, fsdp: int = 1, sp_ulysses: int = 1, sp_ring: int = 1):
    """Mesh for 2D hybrid sequence parallelism: the sp factor splits into
    separate ulysses and ring dims (the reference's --seq_parallel_size x
    --seq_parallel_ring_size, globals.py:62-115).  Sequences are laid out
    ring-major (``SPContext.seq_chunk``)."""
    from torch.distributed.device_mesh import init_device_mesh

    _check_world(dp * fsdp * sp_ulysses * sp_ring, "hybrid mesh")
    return init_device_mesh(_device_type(), (dp, fsdp, sp_ulysses, sp_ring), mesh_dim_names=HYBRID_AXES)


def single_device_mesh():
    return make_mesh(1, 1, 1, 1)


def mesh_size(mesh, name: str) -> int:
    """The size of dim ``name`` (1 when the mesh has no such dim)."""
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def mesh_rank(mesh, name: str) -> int:
    if mesh is None or name not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(name)


# ---------------------------------------------------------------------------
# Parameter sharding rules (ZeRO-equivalent); the reference's functions
# ---------------------------------------------------------------------------


def param_spec(path: str, shape: tuple) -> P:
    """FSDP rule: shard the largest dim of every big matrix over 'fsdp',
    prefer the embedding/vocab dim and MLP fan-out so all-gathers ride ICI
    with contiguous layouts.  Small vectors (norms, biases) replicate."""
    if len(shape) < 2 or max(shape) < 1024:
        return P()
    # shard the last dim for kernels (fan-out), first for embeddings
    if "embed_tokens" in path or "pos_embed" in path:
        return P("fsdp", None)
    if shape[-1] >= shape[0]:
        return P(*([None] * (len(shape) - 1) + ["fsdp"]))
    return P(*(["fsdp"] + [None] * (len(shape) - 1)))


def _path_name_tokens(path: str) -> set:
    import re

    return set(t for t in re.split(r"[^A-Za-z0-9_]+", path) if t)


def tp_param_spec(path: str, shape: tuple) -> P:
    """Megatron-style tensor-parallel rule for the decoder (serving).

    QKV and MLP gate/up kernels shard their fan-out (head/neuron) dim over
    'tp'; wo and down shard fan-in, so each block's output is a partial sum
    and GSPMD inserts exactly one all-reduce per attention/MLP block — the
    textbook 2-collectives-per-layer TP schedule, over ICI.  lm_head
    shards the vocab (logits all-gather per step is small).  Embeddings,
    norms, and biases replicate.  The reference has only vestigial TP
    (SURVEY.md §2.7: HF pretraining_tp slicing, no comm groups); this is
    the real thing, natively on the mesh.
    """
    toks = _path_name_tokens(path)
    if "experts_stacked" in toks and len(shape) == 3:
        # stacked MoE experts (E, fi, fo): shard each expert's neurons over
        # tp (partial-sum + one all-reduce, same as the dense MLP rule) —
        # validated to match the replicated sparse path under GSPMD
        if toks & {"gate", "up"}:
            return P(None, None, "tp")
        return P(None, "tp", None)
    if len(shape) != 2:
        return P()
    if toks & {"wq", "wk", "wv", "gate", "up"}:
        return P(None, "tp")
    if toks & {"wo", "down"}:
        return P("tp", None)
    if "lm_head" in toks:
        return P(None, "tp")
    return P()


def batch_spec(mesh=None) -> P:
    """Activations: batch over (dp, fsdp) combined, sequence over the sp
    dim(s) of the mesh (ring-major for hybrid)."""
    if mesh is not None and "sp_u" in mesh.mesh_dim_names:
        return P(("dp", "fsdp"), ("sp_r", "sp_u"))
    return P(("dp", "fsdp"), "sp")


# ---------------------------------------------------------------------------
# The port's parameters seen as the reference's
# ---------------------------------------------------------------------------

# the port's decoder module names -> the reference's projection keys
_TP_KEYS = {"q_proj": "wq", "k_proj": "wk", "v_proj": "wv", "o_proj": "wo", "gate_proj": "gate",
            "up_proj": "up", "down_proj": "down", "w1": "gate", "w3": "up", "w2": "down"}


class JaxView(NamedTuple):
    path: str  # a path holding the reference's name tokens
    shape: tuple  # the twin's shape
    dims: tuple  # dims[j]: the port's dim that is the twin's dim j


def _jax_path(name: str) -> str:
    """A port parameter's name with the reference's tokens: the projection
    keys, ``router`` for a MoE layer's gate, ``pos_embed`` for SigLIP's
    position table."""
    toks = name.split(".")
    if len(toks) >= 2 and toks[-2] == "gate" and "block_sparse_moe" in toks:
        toks[-2] = "router"
    toks = [_TP_KEYS.get(t, t) if i == len(toks) - 2 else t for i, t in enumerate(toks)]
    return "/".join(toks).replace("position_embedding", "pos_embed")


def jax_view(name: str, module: nn.Module, param: torch.Tensor) -> JaxView:
    """The reference twin of parameter ``name`` of ``module`` (its owner):
    a linear's (out, in) weight is the twin's (in, out) kernel, a
    convolution's (C_out, C_in, kh, kw) its (kh, kw, C_in, C_out), a
    transposed convolution's (C_in, C_out, k, k) its (k, k, C_in, C_out);
    embedding tables and vectors keep their layout.  The path carries the
    tokens the rules read (``_jax_path``): ``embed_tokens``, ``pos_embed``,
    the projection keys, ``router`` and ``lm_head``."""
    path = _jax_path(name)
    shape = tuple(param.shape)
    if param.dim() == 2 and not isinstance(module, nn.Embedding):
        return JaxView(path, shape[::-1], (1, 0))
    if param.dim() == 4 and isinstance(module, nn.ConvTranspose2d):
        return JaxView(path, (shape[2], shape[3], shape[0], shape[1]), (2, 3, 0, 1))
    if param.dim() == 4:
        return JaxView(path, (shape[2], shape[3], shape[1], shape[0]), (2, 3, 1, 0))
    return JaxView(path, shape, tuple(range(param.dim())))


def _sharded_dim(spec: tuple, axis: str) -> Optional[int]:
    for j, a in enumerate(spec):
        if a == axis or (isinstance(a, tuple) and axis in a):
            return j
    return None


def fsdp_shard_dim(name: str, module: nn.Module, param: torch.Tensor) -> Optional[int]:
    """The port's dim that ``param_spec`` shards over fsdp, or None where
    it replicates the parameter."""
    view = jax_view(name, module, param)
    j = _sharded_dim(param_spec(view.path, view.shape), "fsdp")
    return None if j is None else view.dims[j]


def _owners(model: nn.Module):
    """name -> (owning module, parameter) for every parameter."""
    out = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            out[f"{mname}.{pname}" if mname else pname] = (mod, p)
    return out


# ---------------------------------------------------------------------------
# FSDP
# ---------------------------------------------------------------------------


def fsdp_mesh(mesh):
    """The FSDP mesh of ``mesh``: 1-D over fsdp when dp and sp are 1, else
    the 2-D replicate x shard (HSDP) mesh over the flattened (dp, sp...)
    ranks x fsdp.  Every rank makes the same groups."""
    from torch.distributed.device_mesh import DeviceMesh

    names = mesh.mesh_dim_names
    if mesh_size(mesh, "tp") > 1:
        raise ValueError("FSDP with a tp dim above 1 is not supported: tensor parallelism is for serving")
    ranks = mesh.mesh  # (dp, fsdp, sp...) tensor of global ranks
    fs = names.index("fsdp")
    order = [d for d in range(ranks.dim()) if d != fs] + [fs]
    rep = ranks.permute(*order).reshape(-1, ranks.shape[fs])
    if rep.shape[0] == 1:
        return DeviceMesh(mesh.device_type, rep[0], mesh_dim_names=("fsdp",))
    return DeviceMesh(mesh.device_type, rep, mesh_dim_names=("replicate", "fsdp"))


def _sharded_modules(model: nn.Module):
    """The FSDP units below the root: each decoder layer, the tower and the
    projector."""
    units = []
    llm = getattr(model, "llm", None)
    if llm is not None:
        units += list(llm.model.layers)
    for name in ("vision_tower", "mm_projector"):
        if getattr(model, name, None) is not None:
            units.append(getattr(model, name))
    return units


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """FSDP2 over ``mesh`` in place (see the module docstring); returns the
    model.  Its parameters become DTensors except the replicated ones."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    # the units' outputs (a decoder layer's K/V views, the projector's
    # reshape) are never updated in place, which is what FSDP warns about
    warnings.filterwarnings("ignore", message="FSDP2-wrapped module .* returned a view tensor")
    fmesh = fsdp_mesh(mesh)
    owners = _owners(model)
    dims = {id(p): fsdp_shard_dim(name, mod, p) for name, (mod, p) in owners.items()}
    replicated = [p for _, p in owners.values() if dims[id(p)] is None]

    def placement(p):
        return Shard(dims[id(p)])

    for unit in _sharded_modules(model) + [model]:
        fully_shard(unit, mesh=fmesh, shard_placement_fn=placement, ignored_params=set(replicated),
                    reshard_after_forward=unit is not model)
    for unit in _sharded_modules(model) + [model]:
        # gradients are sums: a divide factor of 1, reduced with a plain SUM
        # (the factor's PREMUL_SUM is NCCL's; gloo has none)
        unit.set_gradient_divide_factor(1.0)
        unit.set_force_sum_reduction_for_comms(True)
    model.replicated_params = replicated
    return model


def is_sharded(model: nn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def sync_replicated_grads(model: nn.Module) -> None:
    """Sum over every rank the gradients of the parameters that are
    replicated: those FSDP leaves whole, or every parameter of a model that
    is not sharded (the LoRA routes' replicated base and adapters) in a
    process group of several ranks.  Their reference twins are replicated,
    so their gradients are the global sums; on one process nothing
    changes."""
    if world_size() == 1:
        return
    params = model.replicated_params if is_sharded(model) else model.parameters()
    for p in params:
        if p.grad is not None:
            dist.all_reduce(p.grad)


@contextlib.contextmanager
def gathered(model: nn.Module):
    """Every FSDP unit of ``model`` unsharded for the duration (serving on
    FSDP-sharded parameters: each rank then runs the whole model, as the
    reference's GSPMD program does with gathered weights).  No-op on a
    model that is not sharded."""
    from torch.distributed.fsdp import FSDPModule

    units = [m for m in model.modules() if isinstance(m, FSDPModule)]
    for u in units:  # a unit's own calls inside must not reshard it
        u.set_reshard_after_forward(False, recurse=False)
        u.unshard()
    try:
        yield model
    finally:
        for u in units:
            u.reshard()
            u.set_reshard_after_forward(u is not model, recurse=False)  # shard_model's setting


def world_size() -> int:
    """The process group's size, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def world_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over every rank (no gradient; ``t`` itself on one
    process)."""
    if world_size() == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------


class TPGroup(NamedTuple):
    group: object
    rank: int
    size: int


def tp_group(mesh) -> Optional[TPGroup]:
    """The tp dim's group (of one rank too: the tensor-parallel code path
    then runs with collectives over itself), or None when the mesh has no
    tp dim."""
    if mesh is None or "tp" not in mesh.mesh_dim_names:
        return None
    return TPGroup(mesh.get_group("tp"), mesh.get_local_rank("tp"), mesh_size(mesh, "tp"))


def _slice_rows(t: torch.Tensor, tp: TPGroup, dim: int, pad: bool = False) -> torch.Tensor:
    n = t.shape[dim]
    per = -(-n // tp.size) if pad else n // tp.size
    if not pad and n % tp.size:
        raise ValueError(f"tp={tp.size} must divide a sharded dim of {n}")
    part = t.narrow(dim, min(tp.rank * per, n), max(0, min(per, n - tp.rank * per)))
    if part.shape[dim] < per:  # the vocab's last shards: zero rows past its end
        shape = list(part.shape)
        shape[dim] = per - part.shape[dim]
        part = torch.cat([part, part.new_zeros(shape)], dim=dim)
    return part.contiguous()


def _shard_linear(mod: nn.Module, tp: TPGroup, spec: tuple, pad: bool = False) -> None:
    """Keep this rank's slice of a linear (float or quantized) per its
    reference twin's ``spec``: the twin's fan-out dim 1 is the port's row
    dim 0 (with the bias and a quantized weight's per-row scale), its
    fan-in dim 0 the port's column dim 1 (a packed int4 weight is sliced
    on whole bytes, so its fan-in slices must be even)."""
    from spatialrgpt_tpu_torch.ops.layers import QuantLinear

    axis = _sharded_dim(spec, "tp")
    if axis is None:
        return
    dim = 1 - axis
    with torch.no_grad():
        if isinstance(mod, QuantLinear):
            mod.a8_rule = (mod.in_features, mod.out_features)  # the call-site rule reads the whole shape
            if dim == 0:
                mod.q = _slice_rows(mod.q, tp, 0, pad)
                mod.scale = _slice_rows(mod.scale, tp, 0, pad)
                mod.out_features = mod.q.shape[0]
            else:
                if mod.bits == 4 and (mod.in_features // tp.size) % 2:
                    raise ValueError("tp slices of a packed int4 weight's fan-in must be even")
                mod.q = _slice_rows(mod.q, tp, 1)
                mod.in_features //= tp.size
                mod.tp_fan_in = tp
        else:
            mod.weight = nn.Parameter(_slice_rows(mod.weight, tp, dim, pad), requires_grad=False)
            if dim == 1:
                mod.in_features //= tp.size
            else:
                mod.out_features = mod.weight.shape[0]
        if getattr(mod, "bias", None) is not None:
            # a fan-out slice keeps its rows' bias; of the fan-in slices'
            # partial sums one carries the bias
            bias = _slice_rows(mod.bias, tp, 0, pad) if dim == 0 else mod.bias * (tp.rank == 0)
            mod.bias = nn.Parameter(bias, requires_grad=False)


def tp_shard_model(model: nn.Module, mesh) -> nn.Module:
    """Tensor-parallel placement in place (``tp_shard_params``): every
    decoder projection of ``model.llm`` (or of ``model``, a bare decoder)
    keeps this rank's slice per ``tp_param_spec``, stacked experts too;
    the tower, projector and region extractor stay whole.  The decoder
    records the tp group (``llm.tp``; ``llama.rank_cfg`` gives the widths
    of its slice); ``models/llama.py`` then adds one all-reduce after
    wo and after down (or the experts' sum) and one all-gather of the
    logits.  Returns the model; a mesh without a tp dim changes nothing (one
    of one rank keeps every slice whole and runs the collectives over that
    rank)."""
    from spatialrgpt_tpu_torch.ops.layers import QuantLinear, is_fused

    if mesh is not None and "tp" in mesh.mesh_dim_names and is_fused(model):
        raise ValueError("tp_shard_model: the model's projections are fused (fuse_serving_kernels); its tp rules "
                         "shard q/k/v and gate/up apart, so fuse only single-card serving models")
    tp = tp_group(mesh)
    llm = getattr(model, "llm", model)
    if tp is None or getattr(llm, "tp", None) is not None:
        return model

    from spatialrgpt_tpu_torch.models.llama import tp_slice_cfg

    tp_slice_cfg(llm.cfg, tp.size)  # raises where tp does not divide the heads or neurons
    for name, mod in llm.named_modules():
        if isinstance(mod, (nn.Linear, QuantLinear)):  # the twin's kernel is (in, out)
            spec = tp_param_spec(_jax_path(name + ".weight"), (mod.in_features, mod.out_features))
            _shard_linear(mod, tp, spec, pad="lm_head" in name)
        stacked = getattr(mod, "stacked", None)
        if stacked is not None:
            # (E, out, in): w1 / w3 keep their neurons' rows, w2 its columns
            mod.stacked = (_slice_rows(stacked[0], tp, 1), _slice_rows(stacked[1], tp, 1),
                           _slice_rows(stacked[2], tp, 2))
    llm.tp = tp
    return model


# ---------------------------------------------------------------------------
# Processes
# ---------------------------------------------------------------------------


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> torch.device:
    """``torch.distributed.init_process_group`` (the torchrun + NCCL
    rendezvous of the reference's launch scripts, 1_mm_align.sh:3-22 +
    globals.py:138).  The rank and world size come from the arguments,
    else torchrun's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
    ``MASTER_PORT``, else SLURM's ``SLURM_PROCID`` / ``SLURM_NTASKS`` with
    ``COORDINATOR_ADDRESS`` (host:port).  NCCL on the card, each rank on
    ``LOCAL_RANK`` (else rank modulo the cards); gloo only when ``device``
    is the CPU.  Returns the rank's device."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", env.get("SLURM_NTASKS", "1")))
    if process_id is None:
        process_id = int(env.get("RANK", env.get("SLURM_PROCID", "0")))
    cpu = device is not None and torch.device(device).type == "cpu"
    if cpu:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA card; pass device='cpu' for gloo on the CPU")
        local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if "MASTER_ADDR" in env:
        init_method = "env://"
    elif coordinator_address:
        init_method = f"tcp://{coordinator_address}"
    else:
        init_method = f"tcp://localhost:{_free_port()}"
        if num_processes > 1:
            raise ValueError("init_distributed: several processes need MASTER_ADDR or COORDINATOR_ADDRESS")
    dist.init_process_group("gloo" if cpu else "nccl", init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=timeout)
    return dev


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def data_parallel_rank(mesh) -> int:
    """This rank's data-parallel rank for the sampler: its (dp, fsdp)
    coordinate, so every sp (and tp) rank of one group loads the same
    rows."""
    return mesh_rank(mesh, "dp") * mesh_size(mesh, "fsdp") + mesh_rank(mesh, "fsdp")


def data_parallel_world(mesh) -> int:
    return mesh_size(mesh, "dp") * mesh_size(mesh, "fsdp")


def local_rows(n: int, mesh) -> slice:
    """The rows of an n-row global batch this rank holds: contiguous blocks
    over (dp, fsdp) (``batch_spec``'s leading dim)."""
    world = data_parallel_world(mesh)
    if n % world:
        raise ValueError(f"batch of {n} rows does not split over {world} data-parallel ranks")
    per = n // world
    r = data_parallel_rank(mesh)
    return slice(r * per, (r + 1) * per)
