"""Weights for the port's modules.

``load_from_jax`` carries a JAX parameter pytree (numpy arrays) across
through the HF-named state dicts that
``spatialrgpt_tpu/utils/export.py`` writes, so the port loads exactly the
tensor names of the reference checkpoint layout.  ``init_random`` makes a
model directly on the device from a seeded ``torch.Generator``, with the
standard deviations of the JAX package's ``init_params``.
``save_composite`` writes a model back in the reference's split layout.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from spatialrgpt_tpu.config import SpatialRGPTConfig
from spatialrgpt_tpu.utils import export
from spatialrgpt_tpu_torch.models.vlm import SpatialRGPT


def _empty_model(cfg: SpatialRGPTConfig, device, dtype) -> SpatialRGPT:
    """Module tree with uninitialised storage on ``device`` (nothing is
    initialised twice)."""
    with torch.device("meta"):
        model = SpatialRGPT(cfg, dtype)
    return model.to_empty(device=device).requires_grad_(False).eval()


def load_from_jax(np_params, cfg: SpatialRGPTConfig, device, dtype=torch.float32) -> SpatialRGPT:
    """JAX ``vlm.init_params``-layout pytree -> ``SpatialRGPT`` on ``device``."""
    parts = {
        "vision_tower.": export.export_siglip(np_params["vision"]),
        "mm_projector.": export.export_projector(np_params["projector"], cfg.projector.projector_type),
        "llm.": export.export_llama(np_params["llm"]),
    }
    if cfg.enable_region:
        parts["region_extractor."] = export.export_region_extractor(np_params["region"])
    state = {
        prefix + name: torch.tensor(np.asarray(a)).to(device=device, dtype=dtype)
        for prefix, sd in parts.items()
        for name, a in sd.items()
    }
    model = _empty_model(cfg, device, dtype)
    model.load_state_dict(state, strict=True)
    return model


@torch.no_grad()
def init_random(cfg: SpatialRGPTConfig, device, dtype=torch.bfloat16, seed: int = 0) -> SpatialRGPT:
    """Random weights made on ``device`` from ``seed``: dense and deconv
    kernels N(0, fan_in^-1/2), patch kernel and embedding tables N(0, 0.02),
    norm scales 1, biases 0 (the JAX ``init_params`` recipe)."""
    g = torch.Generator(device=device).manual_seed(seed)
    model = _empty_model(cfg, device, dtype)
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            mod.weight.normal_(0.0, mod.weight.shape[1] ** -0.5, generator=g)
        elif isinstance(mod, nn.ConvTranspose2d):  # (C_in, C_out, 2, 2)
            mod.weight.normal_(0.0, mod.weight.shape[0] ** -0.5, generator=g)
        elif isinstance(mod, (nn.Conv2d, nn.Embedding)):
            mod.weight.normal_(0.0, 0.02, generator=g)
        elif isinstance(mod, (nn.LayerNorm, nn.RMSNorm)):
            mod.weight.fill_(1.0)
        if getattr(mod, "bias", None) is not None:
            mod.bias.zero_()
    return model


# split checkpoint directory of each sub-module (utils/export.py::save_composite)
SPLIT_DIRS = ("vision_tower", "mm_projector", "region_extractor", "llm")


def save_composite(root: str, model: SpatialRGPT, cfg: SpatialRGPTConfig) -> None:
    """The reference's split composite checkpoint: ``config.json`` at
    ``root`` and one directory per sub-module holding its HF-named state
    dict (the names ``utils/export.py`` writes) as ``pytorch_model.bin``."""
    os.makedirs(root, exist_ok=True)
    cfg.save(root)
    for name in SPLIT_DIRS:
        module = getattr(model, name, None)
        if module is None:
            continue
        os.makedirs(os.path.join(root, name), exist_ok=True)
        state = {k: v.detach().contiguous() for k, v in module.state_dict().items()}
        torch.save(state, os.path.join(root, name, "pytorch_model.bin"))
