"""The training step (port of ``spatialrgpt_tpu/train/step.py::make_train_step``).

``train_step(state, batch) -> (state, metrics)``: the loss of
``models/vlm.py::loss_fn``, its gradients, and one ``AdamW`` update of the
tuned modules.  Modules named in ``frozen`` get ``requires_grad=False``,
the twin of the reference's ``stop_gradient``: autograd then builds no
weight gradients for them, and the backward only carries activations
through them (all 32 decoder layers in the align stage, to reach the
projector and the region extractor).

``donate`` has no counterpart: PyTorch updates the parameters and the
optimizer state in place, so no second copy of either exists to give
back.  The LoRA and frozen-base steps (``make_lora_train_step``,
``make_frozen_base_train_step``) wait for the LoRA branch and the W8A8
straight-through backward of ``ops/layers.py::linear``: a quantized model
raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from spatialrgpt_tpu_torch.config import SpatialRGPTConfig
from spatialrgpt_tpu_torch.models import vlm
from spatialrgpt_tpu_torch.ops.layers import is_quantized
from spatialrgpt_tpu_torch.train.optimizer import MODULES, AdamW


class TrainState(NamedTuple):
    step: int
    model: vlm.SpatialRGPT
    optimizer: AdamW


def create_train_state(model: vlm.SpatialRGPT, optimizer: AdamW) -> TrainState:
    if is_quantized(model):
        raise NotImplementedError("training a quantized model (the frozen-base W8A8 align step) is not ported yet")
    return TrainState(step=0, model=model, optimizer=optimizer)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.sqrt(sum((t.float().square().sum() for t in tensors), torch.zeros(())))


def make_train_step(
    cfg: SpatialRGPTConfig,
    optimizer: AdamW,
    attn_impl: str = "xla",
    remat: bool = False,
    frozen: Tuple[str, ...] = (),
    ce_chunk: int = 0,
):
    """Build ``train_step``.  ``remat`` checkpoints every decoder layer;
    ``frozen`` holds reference labels (llm / vision / projector / region).
    Metrics: ``loss``, ``num_tokens`` and ``grad_norm``, the global norm of
    every gradient (a frozen module's count as zeros)."""
    unknown = set(frozen) - set(MODULES)
    if unknown:
        raise ValueError(f"unknown frozen modules {sorted(unknown)}; expected some of {sorted(MODULES)}")

    def train_step(state: TrainState, batch: vlm.VLMInputs) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model = state.model
        for label in frozen:
            module = getattr(model, MODULES[label], None)
            if module is not None:
                module.requires_grad_(False)
        model.zero_grad(set_to_none=True)
        loss, metrics = vlm.loss_fn(model, cfg, batch, attn_impl=attn_impl, remat=remat, ce_chunk=ce_chunk)
        loss.backward()
        grad_norm = global_norm(p.grad for p in model.parameters() if p.grad is not None)
        optimizer.step()
        metrics = {k: v.detach() for k, v in metrics.items()}
        return state._replace(step=state.step + 1), {**metrics, "grad_norm": grad_norm}

    return train_step
