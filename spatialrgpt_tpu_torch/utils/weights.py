"""Weights for the port's modules.

``load_from_jax`` carries a JAX parameter pytree (numpy arrays) across
through the HF-named state dicts of ``utils/export.py`` (the port's copy
of the JAX package's name maps), so the port loads exactly the tensor
names of the reference checkpoint layout; a tree quantized by
``quantize_llm`` loads into ``QuantLinear``s.  ``init_random`` makes a
model directly on the device from a seeded ``torch.Generator``, with the
standard deviations of the JAX package's ``init_params``, and
``init_random_quantized`` (the twin of ``utils/fast_init.py::
fast_init_quantized``) makes its projections directly in the int8
layout.
``save_composite`` writes a model back in the reference's split layout.
The demo's models: ``init_random_sam_hq`` and ``init_random_depth_anything``
on the device, and ``load_depth_anything_from_jax`` through the HF names
(SAM has no JAX ``init_params``; its bridge runs the other way, the port's
HF-named ``state_dict()`` through the JAX ``convert_sam_hq``).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from spatialrgpt_tpu_torch.config import SpatialRGPTConfig
from spatialrgpt_tpu_torch.utils import export
from spatialrgpt_tpu_torch.models.depth_anything import DepthAnythingConfig, DepthAnythingModel, LayerScale
from spatialrgpt_tpu_torch.models.sam import SamConfig, SamHQModel
from spatialrgpt_tpu_torch.models.vlm import SpatialRGPT
from spatialrgpt_tpu_torch.ops.layers import QuantLinear

# a linear's module name -> (bits, a8) where the model holds it quantized, else None
QuantLayout = Callable[[str], Optional[Tuple[int, bool]]]


def _empty_model(cls, cfg, device, dtype, quant: Optional[QuantLayout] = None):
    """``cls(cfg, dtype)`` with uninitialised storage on ``device`` (nothing
    is initialised twice); the linears that ``quant`` names become
    ``QuantLinear``s first, so no float copy of their weights is ever
    allocated."""
    with torch.device("meta"):
        model = cls(cfg, dtype)
        for name, lin in list(model.named_modules()):
            layout = quant(name) if quant is not None and isinstance(lin, nn.Linear) else None
            if layout is not None:
                parent, _, attr = name.rpartition(".")
                setattr(model.get_submodule(parent), attr, QuantLinear(
                    lin.in_features, lin.out_features, *layout, bias=lin.bias is not None, dtype=dtype))
    return model.to_empty(device=device).requires_grad_(False).eval()


def load_from_jax(np_params, cfg: SpatialRGPTConfig, device, dtype=torch.float32) -> SpatialRGPT:
    """JAX ``vlm.init_params``-layout pytree -> ``SpatialRGPT`` on ``device``.
    Entries quantized by ``quantize_llm`` (``kernel_q``) load into
    ``QuantLinear``s: int8 (or packed int4) ``q`` and f32 ``scale`` as they
    are, the W8A8 marker as ``a8``."""
    parts = {
        "vision_tower.": export.export_siglip(np_params["vision"]),
        "mm_projector.": export.export_projector(np_params["projector"], cfg.projector.projector_type),
        "llm.": export.export_llama(np_params["llm"]),
    }
    if cfg.enable_region:
        parts["region_extractor."] = export.export_region_extractor(np_params["region"])
    flat = {prefix + name: a for prefix, sd in parts.items() for name, a in sd.items()}
    quant = {name[: -len(".q")]: None for name in flat if name.endswith(".q")}
    for mod in quant:
        quant[mod] = (4 if f"{mod}.orig_dim0" in flat else 8, f"{mod}.a8" in flat)
    state = {}
    for name, a in flat.items():
        mod, _, leaf = name.rpartition(".")
        if mod in quant and leaf in export.QUANT_MARKERS:
            continue
        t = torch.tensor(np.asarray(a))
        if mod in quant and leaf == "q":
            state[name] = t.to(device=device, dtype=torch.int8)
        elif mod in quant and leaf == "scale":
            state[name] = t.to(device=device, dtype=torch.float32)
        else:
            state[name] = t.to(device=device, dtype=dtype)
    model = _empty_model(SpatialRGPT, cfg, device, dtype, quant.get)
    model.load_state_dict(state, strict=True)
    return model


def _init_random_modules(model: nn.Module, g: torch.Generator) -> None:
    """``init_random``'s recipe over ``model``'s modules, in order; a
    ``QuantLinear`` draws its int8 ``q`` uniformly from [-127, 127] and
    takes ``scale`` = in^-1/2 * 3 / 127 (``fast_init.py:57-64``)."""
    for mod in model.modules():
        if isinstance(mod, QuantLinear):
            mod.q.random_(-127, 128, generator=g)
            mod.scale.fill_(mod.in_features**-0.5 * 3.0 / 127.0)
        elif isinstance(mod, nn.Linear):
            mod.weight.normal_(0.0, mod.weight.shape[1] ** -0.5, generator=g)
        elif isinstance(mod, nn.ConvTranspose2d):  # (C_in, C_out, 2, 2)
            mod.weight.normal_(0.0, mod.weight.shape[0] ** -0.5, generator=g)
        elif isinstance(mod, (nn.Conv2d, nn.Embedding)):
            mod.weight.normal_(0.0, 0.02, generator=g)
        elif isinstance(mod, (nn.LayerNorm, nn.RMSNorm)):
            mod.weight.fill_(1.0)
        if getattr(mod, "bias", None) is not None:
            mod.bias.zero_()


@torch.no_grad()
def init_random(cfg: SpatialRGPTConfig, device, dtype=torch.bfloat16, seed: int = 0) -> SpatialRGPT:
    """Random weights made on ``device`` from ``seed``: dense and deconv
    kernels N(0, fan_in^-1/2), patch kernel and embedding tables N(0, 0.02),
    norm scales 1, biases 0 (the JAX ``init_params`` recipe)."""
    g = torch.Generator(device=device).manual_seed(seed)
    model = _empty_model(SpatialRGPT, cfg, device, dtype)
    _init_random_modules(model, g)
    return model


@torch.no_grad()
def init_random_quantized(cfg: SpatialRGPTConfig, device, w8a8: bool, seed: int = 0,
                          vision_quant: Optional[bool] = None, dtype=torch.bfloat16) -> SpatialRGPT:
    """The twin of ``utils/fast_init.py::fast_init_quantized``: every linear
    of the llm (``lm_head`` included) and, with ``vision_quant`` (default:
    ``w8a8``), of the vision tower is a ``QuantLinear`` made directly in the
    int8 layout on ``device`` (marked W8A8 with ``w8a8``); everything else
    follows ``init_random``.  No float copy of a quantized weight is ever
    allocated."""
    vq = w8a8 if vision_quant is None else vision_quant
    roots = ("llm.",) + (("vision_tower.",) if vq else ())
    g = torch.Generator(device=device).manual_seed(seed)
    model = _empty_model(SpatialRGPT, cfg, device, dtype, lambda name: (8, w8a8) if name.startswith(roots) else None)
    _init_random_modules(model, g)
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


# ---------------------------------------------------------------------------
# the demo's models: SAM-HQ and Depth-Anything
# ---------------------------------------------------------------------------


def _fan_in(weight: torch.Tensor) -> int:
    """Conv2d (C_out, C_in, kh, kw): C_in kh kw; Linear (out, in): in."""
    return int(np.prod(weight.shape[1:]))


@torch.no_grad()
def init_random_sam_hq(cfg: SamConfig, device, dtype=torch.bfloat16, seed: int = 0) -> SamHQModel:
    """Random SAM-HQ made on ``device`` from ``seed``, with the JAX
    ``init_params`` recipe: dense and conv kernels N(0, fan_in^-1/2) (a
    stride-2 deconv's fan-in is its C_in: each output pixel sees one input
    pixel), patch kernel, tokens, prompt embeddings, position and rel-pos
    tables N(0, 0.02), norm scales 1, biases 0.  The two Fourier frequency
    matrices are N(0, 1), SAM's ``PositionEmbeddingRandom(scale=1)``: at
    0.02 every box would embed alike."""
    g = torch.Generator(device=device).manual_seed(seed)
    model = _empty_model(SamHQModel, cfg, device, dtype)
    patch = model.vision_encoder.patch_embed.projection
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            mod.weight.normal_(0.0, _fan_in(mod.weight) ** -0.5, generator=g)
        elif isinstance(mod, nn.ConvTranspose2d):
            mod.weight.normal_(0.0, mod.weight.shape[0] ** -0.5, generator=g)
        elif isinstance(mod, nn.Conv2d):
            mod.weight.normal_(0.0, 0.02 if mod is patch else _fan_in(mod.weight) ** -0.5, generator=g)
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 0.02, generator=g)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
        if getattr(mod, "bias", None) is not None:
            mod.bias.zero_()
    enc = model.vision_encoder
    for table in [enc.pos_embed] + [t for layer in enc.layers for t in (layer.attn.rel_pos_h, layer.attn.rel_pos_w)]:
        table.normal_(0.0, 0.02, generator=g)
    for fourier in (model.shared_image_embedding, model.prompt_encoder.shared_embedding):
        fourier.positional_embedding.normal_(0.0, 1.0, generator=g)
    return model


@torch.no_grad()
def init_random_depth_anything(cfg: DepthAnythingConfig, device, dtype=torch.bfloat16, seed: int = 0) -> DepthAnythingModel:
    """Random Depth-Anything made on ``device`` from ``seed``, with
    ``depth_anything.init_params``' recipe: dense and conv kernels (patch
    kernel included) N(0, fan_in^-1/2), a k x k deconv's fan-in k k C_in as
    that recipe counts it, cls token and position table N(0, 0.02), norm
    scales and layer scales 1, biases 0.  One departure: the head's last
    conv is drawn like the others, where ``init_params`` zeroes it (for
    fitting the metric head), which would make every relative depth 0."""
    g = torch.Generator(device=device).manual_seed(seed)
    model = _empty_model(DepthAnythingModel, cfg, device, dtype)
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            mod.weight.normal_(0.0, _fan_in(mod.weight) ** -0.5, generator=g)
        elif isinstance(mod, nn.ConvTranspose2d):  # (C_in, C_out, k, k)
            w = mod.weight
            mod.weight.normal_(0.0, (w.shape[0] * w.shape[2] * w.shape[3]) ** -0.5, generator=g)
        elif isinstance(mod, nn.Conv2d):
            mod.weight.normal_(0.0, _fan_in(mod.weight) ** -0.5, generator=g)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
        elif isinstance(mod, LayerScale):
            mod.lambda1.fill_(1.0)
        if getattr(mod, "bias", None) is not None:
            mod.bias.zero_()
    emb = model.backbone.embeddings
    emb.cls_token.normal_(0.0, 0.02, generator=g)
    emb.position_embeddings.normal_(0.0, 0.02, generator=g)
    return model


def export_depth_anything(p, cfg: DepthAnythingConfig) -> dict:
    """``depth_anything.init_params``-layout pytree (numpy) -> the HF state
    dict names that ``convert_depth_anything`` reads (its inverse)."""
    sd = {}

    def dense(name, q):
        sd[name + ".weight"] = np.asarray(q["kernel"]).T
        sd[name + ".bias"] = np.asarray(q["bias"])

    def norm(name, q):
        sd[name + ".weight"], sd[name + ".bias"] = np.asarray(q["scale"]), np.asarray(q["bias"])

    def conv(name, q, transpose=False, bias=True):
        # HWIO -> conv (C_out, C_in, kh, kw), or deconv (C_in, C_out, kh, kw)
        sd[name + ".weight"] = np.asarray(q["kernel"]).transpose((2, 3, 0, 1) if transpose else (3, 2, 0, 1))
        if bias:
            sd[name + ".bias"] = np.asarray(q["bias"])
        elif np.any(np.asarray(q.get("bias", 0.0)) != 0):
            raise ValueError(f"{name}: the HF layout has no bias here, and this one is not zero")

    sd["backbone.embeddings.cls_token"] = np.asarray(p["cls_token"])[None, None]
    sd["backbone.embeddings.position_embeddings"] = np.asarray(p["pos_embed"])[None]
    conv("backbone.embeddings.patch_embeddings.projection", p["patch_embed"])
    for i, lp in enumerate(p["layers"]):
        pre = f"backbone.encoder.layer.{i}."
        norm(pre + "norm1", lp["norm1"])
        norm(pre + "norm2", lp["norm2"])
        for ours, theirs in (("wq", "attention.attention.query"), ("wk", "attention.attention.key"),
                             ("wv", "attention.attention.value"), ("wo", "attention.output.dense")):
            dense(pre + theirs, lp["attn"][ours])
        dense(pre + "mlp.fc1", lp["mlp"]["fc1"])
        dense(pre + "mlp.fc2", lp["mlp"]["fc2"])
        sd[pre + "layer_scale1.lambda1"] = np.asarray(lp["ls1"])
        sd[pre + "layer_scale2.lambda1"] = np.asarray(lp["ls2"])
    norm("backbone.layernorm", p["final_ln"])
    for i, entry in enumerate(p["reassemble"]):
        pre = f"neck.reassemble_stage.layers.{i}."
        conv(pre + "projection", entry["proj"])
        if "resize" in entry:
            conv(pre + "resize", entry["resize"], transpose=cfg.reassemble_factors[i] > 1)
    for i, c in enumerate(p["neck_convs"]):
        conv(f"neck.convs.{i}", c, bias=False)
    for i, fp in enumerate(p["fusion"]):
        pre = f"neck.fusion_stage.layers.{i}."
        conv(pre + "projection", fp["proj"])
        for r in (1, 2):
            for c in (1, 2):
                conv(f"{pre}residual_layer{r}.convolution{c}", fp[f"res{r}"][f"conv{c}"])
    for k in ("conv1", "conv2", "conv3"):
        conv("head." + k, p["head"][k])
    return sd


def load_depth_anything_from_jax(np_params, cfg: DepthAnythingConfig, device, dtype=torch.float32) -> DepthAnythingModel:
    """``depth_anything.init_params``-layout pytree -> ``DepthAnythingModel``
    on ``device`` through the HF names."""
    state = {k: torch.tensor(np.asarray(a, np.float32)).to(device=device, dtype=dtype)
             for k, a in export_depth_anything(np_params, cfg).items()}
    model = _empty_model(DepthAnythingModel, cfg, device, dtype)
    model.load_state_dict(state, strict=True)
    return model
