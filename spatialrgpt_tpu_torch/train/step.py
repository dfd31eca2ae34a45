"""The training steps (port of ``spatialrgpt_tpu/train/step.py``).

``train_step(state, batch) -> (state, metrics)``: the loss of
``models/vlm.py::loss_fn``, its gradients, and one ``AdamW`` update.
Metrics: ``loss``, ``num_tokens`` and ``grad_norm``, the global norm of
the trained parameters' gradients.

- ``make_train_step``: modules named in ``frozen`` get
  ``requires_grad=False``, the twin of the reference's ``stop_gradient``:
  autograd then builds no weight gradients for them, and the backward only
  carries activations through them (all 32 decoder layers in the align
  stage, to reach the projector and the region extractor).
- ``make_frozen_base_train_step``: the align step over a frozen base that
  may be quantized (W8A8 decoder and tower, ``bench_train.py``'s
  ``SRGPT_TRAIN_BENCH_QUANT=1/2``): every parameter the optimizer does not
  hold is frozen; the W8A8 projections run K7 + K8 forward (and again in
  remat's recompute) and carry dx by the straight-through backward
  (``ops/layers.py``; int8 on K10 + K11 after ``enable_int8_backward``).
- ``make_lora_train_step``: LoRA / QLoRA: the model carries its adapters as
  ``model.adapters`` (``train/lora.py::LoraAdapters``); each step runs the
  loss on ``apply_lora``'s view of the decoder, the side branch (merged
  under DoRA), so gradients reach the adapters and the co-trained modules
  the optimizer holds, and the base stays on its own (int8) route.

The reference passes the frozen base as a second argument because its
integer leaves cannot sit in ``value_and_grad``'s tree; here the model
holds every module and ``requires_grad`` decides, so the steps take
``(state, batch)``.  ``donate`` has no counterpart: PyTorch updates the
parameters and the optimizer state in place, so no second copy of either
exists to give back.

Meshes (``step.py:49`` and ``:221``): ``shard_state`` wraps the model in
FSDP2 over a mesh (``parallel/mesh.py::shard_model``) and points the
optimizer at the sharded parameters, whose moments then follow their
sharding; ``batch_shardings`` gives a rank its rows of a global batch over
(dp, fsdp) with the images they use.  The sequence stays whole there: the
model cuts this rank's chunk after the splice (``models/vlm.py``), so the
images of a row stay whole on every sp rank of that row.  Every step runs
the loss as a module call of the model (``SpatialRGPT.forward``), so FSDP
gathers and reduce-scatters around it, and then sums the gradients of the
parameters FSDP leaves replicated.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from spatialrgpt_tpu_torch.config import SpatialRGPTConfig
from spatialrgpt_tpu_torch.models import vlm
from spatialrgpt_tpu_torch.ops.layers import QuantLinear
from spatialrgpt_tpu_torch.parallel import mesh as mesh_lib
from spatialrgpt_tpu_torch.train.lora import LoraConfig, apply_lora, replace_modules
from spatialrgpt_tpu_torch.train.optimizer import MODULES, AdamW, MultiSteps, sq_sum


class TrainState(NamedTuple):
    step: int
    model: vlm.SpatialRGPT
    optimizer: AdamW


def _trained(optimizer: AdamW) -> set:
    return {id(p) for group in optimizer.param_groups for p in group["params"]}


def create_train_state(model: vlm.SpatialRGPT, optimizer: AdamW) -> TrainState:
    """A quantized model trains only with its quantized modules frozen: the
    optimizer may hold no parameter of a ``QuantLinear`` (its float bias)."""
    trained = _trained(optimizer)
    for name, mod in model.named_modules():
        if isinstance(mod, QuantLinear) and any(id(p) in trained for p in mod.parameters()):
            raise ValueError(f"{name} is quantized: its parameters cannot be trained, freeze its module")
    return TrainState(step=0, model=model, optimizer=optimizer)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (over every
    shard of a sharded gradient)."""
    return torch.sqrt(sum((sq_sum(t) for t in tensors), torch.zeros(())))


def shard_state(state, mesh):
    """``state`` (a ``TrainState`` or ``DPOState`` before its first step)
    with its model under FSDP2 over ``mesh`` (``parallel/mesh.py::
    shard_model``) and its optimizer's parameter groups pointing at the
    sharded parameters, by name (a ``MultiSteps`` accumulator is made
    anew).  A DPO state's frozen reference copy is sharded the same way."""
    model, optimizer = state.model, state.optimizer
    inner = optimizer.inner if isinstance(optimizer, MultiSteps) else optimizer
    if inner.state:
        raise ValueError("shard_state takes a state before its first step (its optimizer holds no moments)")
    names = {id(p): n for n, p in model.named_parameters()}
    held = [[names[id(p)] for p in group["params"]] for group in inner.param_groups]
    mesh_lib.shard_model(model, mesh)
    params = dict(model.named_parameters())
    for group, group_names in zip(inner.param_groups, held):
        group["params"] = [params[n] for n in group_names]
    if isinstance(optimizer, MultiSteps):
        optimizer.acc = [torch.zeros_like(p) for p in optimizer._params()]
    ref = getattr(state, "ref_model", None)
    if ref is not None:
        mesh_lib.shard_model(ref, mesh)
    return state


def batch_shardings(mesh, inputs: vlm.VLMInputs, tokens_per_image: int) -> vlm.VLMInputs:
    """This rank's rows of a global batch (``batch_spec``'s (dp, fsdp)
    dim: contiguous blocks of rows) and the images, depths and masks they
    use, their indices rebased.  The images a row uses are a contiguous
    run (the collator's order); ``tokens_per_image`` is the width of an
    image's run of tokens in ``image_gather_idx``."""
    rows = mesh_lib.local_rows(inputs.input_ids.shape[0], mesh)
    picked = {f: v[rows] if f not in ("images", "depths", "masks", "mask_valid") and v is not None else v
              for f, v in inputs._asdict().items()}
    R = inputs.masks.shape[1] if inputs.masks is not None else 1
    used = [picked["image_gather_idx"][picked["is_image"]] // tokens_per_image,
            picked["mask_slot"][picked["is_mask"]] // R, picked["depth_slot"][picked["is_depth"]] // R]
    used = torch.cat(used)
    if used.numel() == 0:
        raise ValueError(f"rows {rows.start}:{rows.stop} use no image")
    lo, hi = int(used.min()), int(used.max()) + 1
    for f in ("images", "depths", "masks", "mask_valid"):
        if picked[f] is not None:
            picked[f] = picked[f][lo:hi]
    picked["image_gather_idx"] = picked["image_gather_idx"] - lo * tokens_per_image
    picked["mask_slot"] = picked["mask_slot"] - lo * R
    picked["depth_slot"] = picked["depth_slot"] - lo * R
    return vlm.VLMInputs(**picked)


def _run(state: TrainState, batch: vlm.VLMInputs, optimizer: AdamW,
         loss_fn: Callable) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """``loss_fn(model, batch)``'s gradients, then one update of the
    optimizer; ``grad_norm`` over the gradients that exist (a frozen
    parameter's is zero in the reference's norm)."""
    model = state.model
    model.zero_grad(set_to_none=True)
    loss, metrics = model(loss_fn, batch)
    loss.backward()
    mesh_lib.sync_replicated_grads(model)
    grad_norm = global_norm(p.grad for p in model.parameters() if p.grad is not None)
    optimizer.step()
    metrics = {k: v.detach() for k, v in metrics.items()}
    return state._replace(step=state.step + 1), {**metrics, "grad_norm": grad_norm}


def _freeze_untrained(model: torch.nn.Module, optimizer: AdamW) -> None:
    """``requires_grad`` on exactly for the optimizer's parameters: the
    reference's ``stop_gradient(frozen)``."""
    trained = _trained(optimizer)
    for p in model.parameters():
        p.requires_grad_(id(p) in trained)


def make_train_step(
    cfg: SpatialRGPTConfig,
    optimizer: AdamW,
    attn_impl: str = "xla",
    remat: bool = False,
    frozen: Tuple[str, ...] = (),
    ce_chunk: int = 0,
):
    """Build ``train_step``.  ``remat`` checkpoints every decoder layer;
    ``frozen`` holds reference labels (llm / vision / projector / region)."""
    unknown = set(frozen) - set(MODULES)
    if unknown:
        raise ValueError(f"unknown frozen modules {sorted(unknown)}; expected some of {sorted(MODULES)}")

    def loss_fn(model, batch):
        for label in frozen:
            module = getattr(model, MODULES[label], None)
            if module is not None:
                module.requires_grad_(False)
        return vlm.loss_fn(model, cfg, batch, attn_impl=attn_impl, remat=remat, ce_chunk=ce_chunk)

    return lambda state, batch: _run(state, batch, optimizer, loss_fn)


def make_frozen_base_train_step(
    cfg: SpatialRGPTConfig,
    optimizer: AdamW,
    attn_impl: str = "xla",
    remat: bool = False,
    ce_chunk: int = 0,
):
    """Build the align-style step over a frozen, possibly quantized base
    (``step.py:177-218``): the optimizer holds the trainable modules
    (projector and region extractor in the stage-1 align), everything else
    is frozen."""

    def loss_fn(model, batch):
        _freeze_untrained(model, optimizer)
        return vlm.loss_fn(model, cfg, batch, attn_impl=attn_impl, remat=remat, ce_chunk=ce_chunk)

    return lambda state, batch: _run(state, batch, optimizer, loss_fn)


def make_lora_train_step(
    cfg: SpatialRGPTConfig,
    optimizer: AdamW,
    lcfg: LoraConfig,
    attn_impl: str = "xla",
    remat: bool = False,
    ce_chunk: int = 0,
):
    """Build the LoRA / QLoRA step (``step.py:127-174``): the model's
    ``adapters`` applied to its decoder as the side branch (merged under
    DoRA), every parameter but the optimizer's frozen."""

    def loss_fn(model, batch):
        _freeze_untrained(model, optimizer)
        llm = apply_lora(model.llm, model.adapters, lcfg, merge=lcfg.use_dora)
        return vlm.loss_fn(replace_modules(model, {"llm": llm}), cfg, batch, attn_impl=attn_impl, remat=remat,
                           ce_chunk=ce_chunk)

    return lambda state, batch: _run(state, batch, optimizer, loss_fn)
