"""Weights for the port's modules.

``load_from_jax`` carries a JAX parameter pytree (numpy arrays) across
through the HF-named state dicts of ``utils/export.py`` (the port's copy
of the JAX package's name maps; the decoder's through
``export_llama_families``, which adds the Mixtral, Gemma and q/k/v-bias
names that map does not know), so the port loads exactly the tensor
names of the reference checkpoint layout; a tree quantized by
``quantize_llm`` loads into ``QuantLinear``s.  ``init_random`` makes a
model directly on the device from a seeded ``torch.Generator``, with the
standard deviations of the JAX package's ``init_params``, and
``init_random_quantized`` (the twin of ``utils/fast_init.py::
fast_init_quantized``) makes its projections directly in the int8
layout.
``save_composite`` writes a model back in the reference's split layout,
``save_composite_hf`` as the directory the PyTorch reference loads (float32
tensors and the HF config files).
``load_adapters_from_jax`` carries the reference's LoRA adapter tree across.
The demo's models: ``init_random_sam_hq`` and ``init_random_depth_anything``
on the device, and ``load_depth_anything_from_jax`` through the HF names
(SAM has no JAX ``init_params``; its bridge runs the other way, the port's
HF-named ``state_dict()`` through the JAX ``convert_sam_hq``).
The synth pipeline's models: ``init_random_{ram,owl_vit,camera_net}`` on the
device and ``load_{ram,owl_vit,camera_net}_from_jax``, which carry the JAX
package's parameter trees (numpy) across by the names of the port's modules.
The other vision towers and MPT: ``init_random_{clip,intern_vit,radio,mpt}``
on the device and ``load_{clip,intern_vit,radio,mpt}_from_jax``, each through
the HF / timm names of its converter (``export_*`` writes them from the JAX
tree, the model module's ``convert_*`` reads them); ``load_from_jax`` and
``init_random`` build a composite whose decoder is an MPT when given
``mpt_cfg``.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from spatialrgpt_tpu_torch.config import SpatialRGPTConfig
from spatialrgpt_tpu_torch.utils import export
from spatialrgpt_tpu_torch.models.clip import CLIPVisionConfig, ClipVisionModel, convert_clip
from spatialrgpt_tpu_torch.models.depth_anything import DepthAnythingConfig, DepthAnythingModel, LayerScale
from spatialrgpt_tpu_torch.models.intern_vit import InternVisionConfig, InternVisionModel, convert_intern_vit
from spatialrgpt_tpu_torch.models.llama import LlamaForCausalLM
from spatialrgpt_tpu_torch.models.mpt import MPTConfig, MptForCausalLM, convert_mpt
from spatialrgpt_tpu_torch.models.owl_vit import OwlViTConfig, OwlViTModel
from spatialrgpt_tpu_torch.models.radio import RadioBackboneConfig, RadioModel, convert_radio_state_dict
from spatialrgpt_tpu_torch.models.ram import RamConfig, RamModel
from spatialrgpt_tpu_torch.models.sam import SamConfig, SamHQModel
from spatialrgpt_tpu_torch.models.vlm import SpatialRGPT
from spatialrgpt_tpu_torch.ops.layers import QuantLinear, is_quantized
from spatialrgpt_tpu_torch.synth.calibration import CameraNet, CameraNetConfig
from spatialrgpt_tpu_torch.train.lora import LoraAdapters, LoraPair

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


# a reference MoE layer's expert keys -> HF Mixtral's names of the same projections
MOE_PROJECTIONS = {"gate": "w1", "up": "w3", "down": "w2"}


def export_llama_families(params) -> dict:
    """``export.export_llama``'s names (the same, in its order, for a plain
    Llama tree) and what that copy of the reference's map does not know:
    q/k/v biases, a MoE layer's router (``block_sparse_moe.gate``) and
    experts (``block_sparse_moe.experts.{e}.w1/w3/w2``), a tied head (no
    ``lm_head``)."""
    sd = {"model.embed_tokens.weight": export._np32(params["embed_tokens"])}
    for i, lp in enumerate(params["layers"]):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = export._np32(lp["input_ln"])
        sd[p + "post_attention_layernorm.weight"] = export._np32(lp["post_ln"])
        for key, (group, name) in export.LLAMA_PROJECTIONS.items():
            if group in lp:  # a MoE layer has no "mlp"
                export._dense(sd, p + name, lp[group][key], bias="bias" in lp[group][key])
        moe = p + "block_sparse_moe."
        if "router" in lp:
            export._dense(sd, moe + "gate", lp["router"])
        for e, ep in enumerate(lp.get("experts", ())):
            for key, name in MOE_PROJECTIONS.items():
                export._dense(sd, f"{moe}experts.{e}.{name}", ep[key])
    sd["model.norm.weight"] = export._np32(params["final_ln"])
    if "lm_head" in params:
        export._dense(sd, "lm_head", params["lm_head"])
    return sd


def load_from_jax(np_params, cfg: SpatialRGPTConfig, device, dtype=torch.float32,
                  mpt_cfg: Optional[MPTConfig] = None) -> SpatialRGPT:
    """JAX ``vlm.init_params``-layout pytree -> ``SpatialRGPT`` on ``device``.
    Entries quantized by ``quantize_llm`` (``kernel_q``) load into
    ``QuantLinear``s: int8 (or packed int4) ``q`` and f32 ``scale`` as they
    are, the W8A8 marker as ``a8``.  With ``mpt_cfg`` the tree's ``llm`` is
    an ``mpt.init_params`` tree and the decoder an MPT."""
    parts = {
        "vision_tower.": export.export_siglip(np_params["vision"]),
        "mm_projector.": export.export_projector(np_params["projector"], cfg.projector.projector_type),
        "llm.": export_llama_families(np_params["llm"]) if mpt_cfg is None else export_mpt(np_params["llm"]),
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
    model = _empty_model(functools.partial(SpatialRGPT, mpt_cfg=mpt_cfg), cfg, device, dtype, quant.get)
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
def init_random(cfg: SpatialRGPTConfig, device, dtype=torch.bfloat16, seed: int = 0,
                mpt_cfg: Optional[MPTConfig] = None) -> SpatialRGPT:
    """Random weights made on ``device`` from ``seed``: dense and deconv
    kernels N(0, fan_in^-1/2), patch kernel and embedding tables N(0, 0.02),
    norm scales 1, biases 0 (the JAX ``init_params`` recipe); an MPT
    decoder in ``cfg.llm``'s place with ``mpt_cfg``."""
    g = torch.Generator(device=device).manual_seed(seed)
    model = _empty_model(functools.partial(SpatialRGPT, mpt_cfg=mpt_cfg), cfg, device, dtype)
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


def llama_module_name(kernel_path: str) -> str:
    """A reference adapter key (``layers/3/attn/wq/kernel``, ``lm_head/kernel``,
    ``layers/3/router/kernel``, ``layers/3/experts/2/gate/kernel``) -> the
    port's module name under the decoder (``model.layers.3.self_attn.q_proj``,
    ``lm_head``, ``model.layers.3.block_sparse_moe.gate``,
    ``model.layers.3.block_sparse_moe.experts.2.w1``)."""
    parts = kernel_path.split("/")
    if parts[-1] != "kernel":
        raise ValueError(f"{kernel_path}: not a kernel path")
    if parts[:-1] == ["lm_head"]:
        return "lm_head"
    if len(parts) >= 4 and parts[0] == "layers" and parts[1].isdigit():
        layer = f"model.layers.{int(parts[1])}."
        if len(parts) == 5 and export.LLAMA_PROJECTIONS.get(parts[3], ("",))[0] == parts[2]:
            return layer + export.LLAMA_PROJECTIONS[parts[3]][1]
        if parts[2:] == ["router", "kernel"]:
            return layer + "block_sparse_moe.gate"
        if len(parts) == 6 and parts[2] == "experts" and parts[3].isdigit() and parts[4] in MOE_PROJECTIONS:
            return f"{layer}block_sparse_moe.experts.{int(parts[3])}.{MOE_PROJECTIONS[parts[4]]}"
    raise ValueError(f"{kernel_path}: no llama projection of the port has this path")


def load_adapters_from_jax(np_adapters, device, dtype=None) -> LoraAdapters:
    """The reference's adapter tree (``init_lora``'s: ``{kernel path: {a (fi,
    r), b (r, fo)[, m (fo,)]}}`` as numpy) -> ``LoraAdapters`` on ``device``
    under the port's module names; a and b keep their layout (the port's
    adapters are (in, r) and (r, out) too), in ``dtype`` (default: as
    given; numpy's bfloat16 comes across through f32, exactly)."""

    def tensor(v):
        a = np.asarray(v)
        given = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
        return torch.tensor(a.astype(np.float32)).to(device=device, dtype=dtype or given)

    pairs = {}
    for path, node in np_adapters.items():
        t = {k: tensor(v) for k, v in node.items()}
        pairs[llama_module_name(path)] = LoraPair(t["a"], t["b"], t.get("m"))
    return LoraAdapters(pairs)


# split checkpoint directory of each sub-module (utils/export.py::save_composite)
SPLIT_DIRS = ("vision_tower", "mm_projector", "region_extractor", "llm")


def _split_parts(model: SpatialRGPT, state: Optional[dict]):
    """(split directory, its HF-named state dict) for each sub-module the
    model holds; from ``state`` where given."""
    for name in SPLIT_DIRS:
        module = getattr(model, name, None)
        if module is None:
            continue
        if state is None:
            yield name, {k: v.detach() for k, v in module.state_dict().items()}
        else:
            yield name, {k[len(name) + 1 :]: v for k, v in state.items() if k.startswith(name + ".")}


def save_composite(root: str, model: SpatialRGPT, cfg: SpatialRGPTConfig, state: Optional[dict] = None) -> None:
    """The reference's split composite checkpoint: ``config.json`` at
    ``root`` and one directory per sub-module holding its HF-named state
    dict (the names ``utils/export.py`` writes) as ``pytorch_model.bin``.
    ``state``: the model's whole state dict where the model's own is
    sharded (``train/trainer.py`` gathers it)."""
    os.makedirs(root, exist_ok=True)
    cfg.save(root)
    for name, part in _split_parts(model, state):
        os.makedirs(os.path.join(root, name), exist_ok=True)
        torch.save({k: v.contiguous() for k, v in part.items()}, os.path.join(root, name, "pytorch_model.bin"))


def save_composite_hf(root: str, model: SpatialRGPT, cfg: SpatialRGPTConfig, tokenizer=None,
                      state: Optional[dict] = None) -> None:
    """The twin of the reference's ``utils/export.py::save_composite_hf``: a
    composite directory the PyTorch reference loads directly.  The split
    directories of ``save_composite`` with every tensor in float32 (as the
    reference writes them; bf16 to f32 is exact), the HF config files of
    ``export.hf_config_files`` (the top-level LlavaConfig ``config.json``
    in place of the port's own) and, given ``tokenizer``, its
    ``save_pretrained`` files in ``llm/``.  ``SpatialRGPTConfig.load`` and
    ``utils/checkpoint.py::load_reference_checkpoint`` read it back.
    ``state`` as for ``save_composite``.

    What the reference's export cannot write raises ``ValueError`` before
    anything is written: a decoder other than a dense Llama-family one
    (MoE experts, MPT), a quantized projection, a model without a region
    extractor, a projector other than ``mlp_downsample``."""
    if not isinstance(model.llm, LlamaForCausalLM):
        raise ValueError("save_composite_hf writes a Llama-family decoder; this model's is "
                         f"{type(model.llm).__name__}")
    if cfg.llm.is_moe:
        raise ValueError("save_composite_hf cannot write an MoE decoder: the reference's export_llama "
                         "reads each layer's dense mlp")
    if is_quantized(model):
        raise ValueError("save_composite_hf cannot write quantized projections (QuantLinear): the reference's "
                         "export reads float kernels")
    if model.region_extractor is None:
        raise ValueError("save_composite_hf writes a region extractor; this model has none (enable_region=False)")
    if cfg.projector.projector_type != "mlp_downsample":
        raise ValueError(f"save_composite_hf writes the mlp_downsample projector, not {cfg.projector.projector_type}")
    os.makedirs(root, exist_ok=True)
    for name, part in _split_parts(model, state):
        os.makedirs(os.path.join(root, name), exist_ok=True)
        torch.save({k: v.to("cpu", torch.float32 if v.is_floating_point() else v.dtype).contiguous()
                    for k, v in part.items()}, os.path.join(root, name, "pytorch_model.bin"))
    for path, d in export.hf_config_files(cfg, model.llm.model.embed_tokens.num_embeddings, root).items():
        with open(os.path.join(root, path), "w") as f:
            json.dump(d, f, indent=2)
    if tokenizer is not None:
        tokenizer.save_pretrained(os.path.join(root, "llm"))


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


def _numpy_state(model: nn.Module) -> dict:
    return {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}


def depth_anything_tree(model: DepthAnythingModel, cfg: DepthAnythingConfig) -> dict:
    """``export_depth_anything``'s inverse: the model's weights as a
    ``depth_anything.init_params``-layout pytree of f32 numpy arrays (the
    neck convs, which have no bias here, get the reference's zero bias)."""
    sd = _numpy_state(model)

    def dense(name):
        return {"kernel": sd[name + ".weight"].T, "bias": sd[name + ".bias"]}

    def norm(name):
        return {"scale": sd[name + ".weight"], "bias": sd[name + ".bias"]}

    def conv(name, transpose=False):
        # conv (C_out, C_in, kh, kw) or deconv (C_in, C_out, kh, kw) -> HWIO
        w = sd[name + ".weight"]
        bias = sd.get(name + ".bias")
        out_ch = w.shape[1] if transpose else w.shape[0]
        return {"kernel": w.transpose((2, 3, 0, 1) if transpose else (2, 3, 1, 0)),
                "bias": np.zeros(out_ch, np.float32) if bias is None else bias}

    layers = []
    for i in range(cfg.num_hidden_layers):
        pre = f"backbone.encoder.layer.{i}."
        layers.append({
            "norm1": norm(pre + "norm1"), "norm2": norm(pre + "norm2"),
            "attn": {ours: dense(pre + theirs) for ours, theirs in (
                ("wq", "attention.attention.query"), ("wk", "attention.attention.key"),
                ("wv", "attention.attention.value"), ("wo", "attention.output.dense"))},
            "mlp": {"fc1": dense(pre + "mlp.fc1"), "fc2": dense(pre + "mlp.fc2")},
            "ls1": sd[pre + "layer_scale1.lambda1"], "ls2": sd[pre + "layer_scale2.lambda1"],
        })
    reassemble = []
    for i, factor in enumerate(cfg.reassemble_factors):
        pre = f"neck.reassemble_stage.layers.{i}."
        entry = {"proj": conv(pre + "projection")}
        if factor != 1:
            entry["resize"] = conv(pre + "resize", transpose=factor > 1)
        reassemble.append(entry)
    fusion = []
    for i in range(len(cfg.neck_hidden_sizes)):
        pre = f"neck.fusion_stage.layers.{i}."
        fusion.append({"proj": conv(pre + "projection"), **{
            f"res{r}": {f"conv{c}": conv(f"{pre}residual_layer{r}.convolution{c}") for c in (1, 2)} for r in (1, 2)}})
    return {
        "cls_token": sd["backbone.embeddings.cls_token"][0, 0],
        "pos_embed": sd["backbone.embeddings.position_embeddings"][0],
        "patch_embed": conv("backbone.embeddings.patch_embeddings.projection"),
        "layers": layers,
        "final_ln": norm("backbone.layernorm"),
        "reassemble": reassemble,
        "neck_convs": [conv(f"neck.convs.{i}") for i in range(len(cfg.neck_hidden_sizes))],
        "fusion": fusion,
        "head": {k: conv("head." + k) for k in ("conv1", "conv2", "conv3")},
    }


def load_depth_anything_from_jax(np_params, cfg: DepthAnythingConfig, device, dtype=torch.float32) -> DepthAnythingModel:
    """``depth_anything.init_params``-layout pytree -> ``DepthAnythingModel``
    on ``device`` through the HF names."""
    state = {k: torch.tensor(np.asarray(a, np.float32)).to(device=device, dtype=dtype)
             for k, a in export_depth_anything(np_params, cfg).items()}
    model = _empty_model(DepthAnythingModel, cfg, device, dtype)
    model.load_state_dict(state, strict=True)
    return model


# ---------------------------------------------------------------------------
# the synth pipeline's models: RAM (Swin-L), OWL-ViT, CameraNet
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_random_ram(cfg: RamConfig, device, dtype=torch.bfloat16, seed: int = 0) -> RamModel:
    """Random RAM tagger made on ``device`` from ``seed``, with the JAX
    ``ram.init_params`` / ``swin.init_params`` recipe: dense kernels
    N(0, fan_in^-1/2), patch kernel, rel-pos tables and tag embeddings
    N(0, 0.02), the group-wise fc N(0, D^-1/2), norm scales 1, biases 0."""
    g = torch.Generator(device=device).manual_seed(seed)
    model = _empty_model(RamModel, cfg, device, dtype)
    _init_random_modules(model, g)
    tables = [blk.attention.self.relative_position_bias_table
              for stage in model.swin.encoder.layers for blk in stage.blocks]
    for t in tables + [model.tag_embed]:
        t.normal_(0.0, 0.02, generator=g)
    model.fc_w.normal_(0.0, cfg.hidden_size**-0.5, generator=g)
    model.fc_b.zero_()
    return model


@torch.no_grad()
def init_random_owl_vit(cfg: OwlViTConfig, device, dtype=torch.bfloat16, seed: int = 0) -> OwlViTModel:
    """Random OWL-ViT made on ``device`` from ``seed``, with the JAX
    ``owl_vit.init_params`` recipe: dense kernels N(0, fan_in^-1/2), patch
    kernel, class embedding, token and position tables N(0, 0.02), norm
    scales 1, biases 0."""
    g = torch.Generator(device=device).manual_seed(seed)
    model = _empty_model(OwlViTModel, cfg, device, dtype)
    _init_random_modules(model, g)
    model.owlvit.vision_model.embeddings.class_embedding.normal_(0.0, 0.02, generator=g)
    return model


@torch.no_grad()
def init_random_camera_net(cfg: CameraNetConfig, device, dtype=torch.bfloat16, seed: int = 0) -> CameraNet:
    """Random CameraNet made on ``device`` from ``seed``, with the JAX
    ``calibration.init_params`` recipe: dense kernels (the patch embedding
    is one) N(0, fan_in^-1/2), position table N(0, 0.02), norm scales 1,
    biases 0."""
    g = torch.Generator(device=device).manual_seed(seed)
    model = _empty_model(CameraNet, cfg, device, dtype)
    _init_random_modules(model, g)
    model.pos_embed.normal_(0.0, 0.02, generator=g)
    return model


def _dense(sd: dict, name: str, q) -> None:
    sd[name + ".weight"] = np.asarray(q["kernel"]).T
    if "bias" in q:
        sd[name + ".bias"] = np.asarray(q["bias"])


def _norm(sd: dict, name: str, q) -> None:
    sd[name + ".weight"], sd[name + ".bias"] = np.asarray(q["scale"]), np.asarray(q["bias"])


def _export_tree(sd: dict, tree, prefix: str) -> None:
    """A JAX parameter tree whose paths are the port's module names: a
    ``kernel`` entry is a linear's (in, out) kernel, a ``scale`` entry a
    LayerNorm's, anything else an array of the module as it is."""
    for key, v in tree.items() if isinstance(tree, dict) else enumerate(tree):
        name = f"{prefix}{key}"
        if isinstance(v, dict) and "kernel" in v:
            _dense(sd, name, v)
        elif isinstance(v, dict) and "scale" in v:
            _norm(sd, name, v)
        elif isinstance(v, (dict, list)):
            _export_tree(sd, v, name + ".")
        else:
            sd[name] = np.asarray(v)


def export_swin(p, prefix: str = "") -> dict:
    """``swin.init_params``-layout pytree (numpy) -> the HF ``SwinModel``
    names that ``swin.convert_swin`` reads (its inverse)."""
    sd = {}
    emb = prefix + "embeddings."
    sd[emb + "patch_embeddings.projection.weight"] = np.asarray(p["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)
    sd[emb + "patch_embeddings.projection.bias"] = np.asarray(p["patch_embed"]["bias"])
    _norm(sd, emb + "norm", p["embed_norm"])
    for si, stage in enumerate(p["stages"]):
        st = f"{prefix}encoder.layers.{si}."
        for bi, bp in enumerate(stage["blocks"]):
            b = st + f"blocks.{bi}."
            _norm(sd, b + "layernorm_before", bp["ln1"])
            _norm(sd, b + "layernorm_after", bp["ln2"])
            for ours, theirs in (("q", "self.query"), ("k", "self.key"), ("v", "self.value"), ("proj", "output.dense")):
                _dense(sd, b + "attention." + theirs, bp["attn"][ours])
            sd[b + "attention.self.relative_position_bias_table"] = np.asarray(bp["attn"]["rel_pos_table"])
            _dense(sd, b + "intermediate.dense", bp["mlp"]["fc1"])
            _dense(sd, b + "output.dense", bp["mlp"]["fc2"])
        if "downsample" in stage:
            _norm(sd, st + "downsample.norm", stage["downsample"]["norm"])
            _dense(sd, st + "downsample.reduction", stage["downsample"]["reduction"])
    _norm(sd, prefix + "layernorm", p["final_norm"])
    return sd


def export_owlvit(p) -> dict:
    """``owl_vit.init_params``-layout pytree (numpy) -> the HF
    ``OwlViTForObjectDetection`` names that ``convert_owlvit`` reads (its
    inverse)."""
    sd = {}

    def clip_layers(prefix, layers):
        for i, lp in enumerate(layers):
            b = f"{prefix}.layers.{i}."
            _norm(sd, b + "layer_norm1", lp["ln1"])
            _norm(sd, b + "layer_norm2", lp["ln2"])
            for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("proj", "out_proj")):
                _dense(sd, b + "self_attn." + theirs, lp["attn"][ours])
            _dense(sd, b + "mlp.fc1", lp["mlp"]["fc1"])
            _dense(sd, b + "mlp.fc2", lp["mlp"]["fc2"])

    vm, tm = "owlvit.vision_model.", "owlvit.text_model."
    v, t = p["vision"], p["text"]
    sd[vm + "embeddings.patch_embedding.weight"] = np.asarray(v["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)
    sd[vm + "embeddings.class_embedding"] = np.asarray(v["class_embed"])
    sd[vm + "embeddings.position_embedding.weight"] = np.asarray(v["pos_embed"])
    _norm(sd, vm + "pre_layernorm", v["pre_ln"])
    clip_layers(vm + "encoder", v["layers"])
    _norm(sd, vm + "post_layernorm", v["post_ln"])
    sd[tm + "embeddings.token_embedding.weight"] = np.asarray(t["token_embed"])
    sd[tm + "embeddings.position_embedding.weight"] = np.asarray(t["pos_embed"])
    clip_layers(tm + "encoder", t["layers"])
    _norm(sd, tm + "final_layer_norm", t["final_ln"])
    _dense(sd, "owlvit.text_projection", p["text_projection"])
    _norm(sd, "layer_norm", p["merged_ln"])
    _export_tree(sd, {"class_head": p["class_head"], "box_head": p["box_head"]}, "")
    return sd


def _load_state(cls, cfg, sd: dict, device, dtype):
    state = {k: torch.tensor(np.asarray(a, np.float32)).to(device=device, dtype=dtype) for k, a in sd.items()}
    model = _empty_model(cls, cfg, device, dtype)
    model.load_state_dict(state, strict=True)
    return model


def load_ram_from_jax(np_params, cfg: RamConfig, device, dtype=torch.float32) -> RamModel:
    """``ram.init_params``-layout pytree (numpy) -> ``RamModel`` on ``device``:
    the backbone through the HF Swin names, the head by its own."""
    sd = export_swin(np_params["swin"], "swin.")
    _export_tree(sd, {k: v for k, v in np_params.items() if k != "swin"}, "")
    return _load_state(RamModel, cfg, sd, device, dtype)


def load_owl_vit_from_jax(np_params, cfg: OwlViTConfig, device, dtype=torch.float32) -> OwlViTModel:
    """``owl_vit.init_params``-layout pytree (numpy) -> ``OwlViTModel`` on
    ``device`` through the HF names."""
    return _load_state(OwlViTModel, cfg, export_owlvit(np_params), device, dtype)


def camera_net_tree(model: CameraNet) -> dict:
    """``load_camera_net_from_jax``'s inverse: the model's weights as a
    ``calibration.init_params``-layout pytree of f32 numpy arrays (its
    module names are the tree's: a linear is ``{kernel, bias}``, a LayerNorm
    ``{scale, bias}``)."""

    def tree(module: nn.Module):
        if isinstance(module, nn.Linear):
            out = {"kernel": module.weight.detach().float().cpu().numpy().T}
            if module.bias is not None:
                out["bias"] = module.bias.detach().float().cpu().numpy()
            return out
        if isinstance(module, nn.LayerNorm):
            return {"scale": module.weight.detach().float().cpu().numpy(),
                    "bias": module.bias.detach().float().cpu().numpy()}
        out = {name: p.detach().float().cpu().numpy() for name, p in module.named_parameters(recurse=False)}
        out.update((name, tree(child)) for name, child in module.named_children())
        if isinstance(module, nn.ModuleList):
            return [out[str(i)] for i in range(len(module))]
        return out

    return tree(model)


def load_camera_net_from_jax(np_params, cfg: CameraNetConfig, device, dtype=torch.float32) -> CameraNet:
    """``calibration.init_params``-layout pytree (numpy) -> ``CameraNet`` on
    ``device`` (the module holds the tree's own names)."""
    sd = {}
    _export_tree(sd, np_params, "")
    return _load_state(CameraNet, cfg, sd, device, dtype)


# ---------------------------------------------------------------------------
# the other vision towers (CLIP, InternViT, RADIO) and the MPT decoder
# ---------------------------------------------------------------------------


def export_clip(p) -> dict:
    """``clip.init_params``-layout pytree (numpy) -> the HF ``CLIPVisionModel``
    names that ``convert_clip`` reads (its inverse)."""
    vm = "vision_model."
    sd = {
        vm + "embeddings.class_embedding": np.asarray(p["class_embed"]),
        vm + "embeddings.patch_embedding.weight": np.asarray(p["patch_embed"]["kernel"]).transpose(3, 2, 0, 1),
        vm + "embeddings.position_embedding.weight": np.asarray(p["pos_embed"]),
    }
    _norm(sd, vm + "pre_layrnorm", p["pre_ln"])
    for i, lp in enumerate(p["layers"]):
        b = f"{vm}encoder.layers.{i}."
        _norm(sd, b + "layer_norm1", lp["ln1"])
        _norm(sd, b + "layer_norm2", lp["ln2"])
        for ours, theirs in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"), ("wo", "out_proj")):
            _dense(sd, b + "self_attn." + theirs, lp["attn"][ours])
        _dense(sd, b + "mlp.fc1", lp["mlp"]["fc1"])
        _dense(sd, b + "mlp.fc2", lp["mlp"]["fc2"])
    _norm(sd, vm + "post_layernorm", p["post_ln"])
    return sd


def export_intern_vit(p) -> dict:
    """``intern_vit.init_params``-layout pytree (numpy) -> HF
    ``InternVLVisionModel`` names, its qkv kept fused as ``attention.qkv``
    (rows [q | k | v]), which ``convert_intern_vit`` splits."""
    sd = {
        "embeddings.cls_token": np.asarray(p["class_embed"])[None, None],
        "embeddings.patch_embeddings.projection.weight": np.asarray(p["patch_embed"]["kernel"]).transpose(3, 2, 0, 1),
        "embeddings.patch_embeddings.projection.bias": np.asarray(p["patch_embed"]["bias"]),
        "embeddings.position_embeddings": np.asarray(p["pos_embed"])[None],
    }
    for i, lp in enumerate(p["layers"]):
        b = f"encoder.layer.{i}."
        sd[b + "layernorm_before.weight"] = np.asarray(lp["norm1"])
        sd[b + "layernorm_after.weight"] = np.asarray(lp["norm2"])
        _dense(sd, b + "attention.qkv", lp["qkv"])
        _dense(sd, b + "attention.projection_layer", lp["proj"])
        _dense(sd, b + "mlp.fc1", lp["mlp"]["fc1"])
        _dense(sd, b + "mlp.fc2", lp["mlp"]["fc2"])
        sd[b + "lambda_1"], sd[b + "lambda_2"] = np.asarray(lp["ls1"]), np.asarray(lp["ls2"])
        for n in ("q_norm", "k_norm"):
            if n in lp:
                sd[b + f"attention.{n}.weight"] = np.asarray(lp[n])
    return sd


def export_radio(p) -> dict:
    """``radio.init_radio_params``-layout pytree (numpy) -> the released
    checkpoints' timm names that ``convert_radio_state_dict`` reads: the
    patch kernel ((py, px, channel) rows) as timm's (H, channel * P * P)
    linear."""
    kernel = np.asarray(p["patch_embed"]["kernel"])
    H = kernel.shape[1]
    P = int(round((kernel.shape[0] // 3) ** 0.5))
    pg = "model.patch_generator."
    sd = {
        pg + "embedder.weight": kernel.reshape(P, P, 3, H).transpose(3, 2, 0, 1).reshape(H, -1),
        pg + "embedder.bias": np.asarray(p["patch_embed"]["bias"]),
        pg + "cls_token.token": np.asarray(p["cls_tokens"]),
        pg + "pos_embed": np.asarray(p["pos_embed"])[None],
    }
    for i, lp in enumerate(p["layers"]):
        b = f"model.blocks.{i}."
        _norm(sd, b + "norm1", lp["ln1"])
        _norm(sd, b + "norm2", lp["ln2"])
        _dense(sd, b + "attn.qkv", lp["attn"]["qkv"])
        _dense(sd, b + "attn.proj", lp["attn"]["proj"])
        _dense(sd, b + "mlp.fc1", lp["mlp"]["fc1"])
        _dense(sd, b + "mlp.fc2", lp["mlp"]["fc2"])
    _norm(sd, "model.norm", p["norm"])
    return sd


def export_mpt(p) -> dict:
    """``mpt.init_params``-layout pytree (numpy) -> the HF ``MptForCausalLM``
    names that ``convert_mpt`` reads (its inverse)."""
    sd = {"transformer.wte.weight": np.asarray(p["wte"]), "transformer.norm_f.weight": np.asarray(p["norm_f"])}
    for i, lp in enumerate(p["layers"]):
        b = f"transformer.blocks.{i}."
        sd[b + "norm_1.weight"], sd[b + "norm_2.weight"] = np.asarray(lp["norm1"]), np.asarray(lp["norm2"])
        for ours, theirs in (("wqkv", "attn.Wqkv"), ("out_proj", "attn.out_proj"), ("up", "ffn.up_proj"),
                             ("down", "ffn.down_proj")):
            _dense(sd, b + theirs, lp[ours])
    return sd


def load_clip_from_jax(np_params, cfg: CLIPVisionConfig, device, dtype=torch.float32) -> ClipVisionModel:
    """``clip.init_params``-layout pytree (numpy) -> ``ClipVisionModel`` on
    ``device`` through the HF names."""
    return _load_state(ClipVisionModel, cfg, convert_clip(export_clip(np_params), cfg.num_hidden_layers), device,
                       dtype)


def load_intern_vit_from_jax(np_params, cfg: InternVisionConfig, device, dtype=torch.float32) -> InternVisionModel:
    """``intern_vit.init_params``-layout pytree (numpy) -> ``InternVisionModel``
    on ``device`` through the HF names (the fused qkv split by the
    converter)."""
    return _load_state(InternVisionModel, cfg, convert_intern_vit(export_intern_vit(np_params), cfg), device, dtype)


def load_radio_from_jax(np_params, cfg: RadioBackboneConfig, device, dtype=torch.float32) -> RadioModel:
    """``radio.init_radio_params``-layout pytree (numpy) -> ``RadioModel`` on
    ``device`` through the timm names."""
    return _load_state(RadioModel, cfg, convert_radio_state_dict(export_radio(np_params), cfg), device, dtype)


def load_mpt_from_jax(np_params, cfg: MPTConfig, device, dtype=torch.float32) -> MptForCausalLM:
    """``mpt.init_params``-layout pytree (numpy) -> ``MptForCausalLM`` on
    ``device`` through the HF names."""
    return _load_state(MptForCausalLM, cfg, convert_mpt(export_mpt(np_params), cfg), device, dtype)


@torch.no_grad()
def init_random_clip(cfg: CLIPVisionConfig, device, dtype=torch.bfloat16, seed: int = 0) -> ClipVisionModel:
    """Random CLIP tower made on ``device`` from ``seed``, with the JAX
    ``clip.init_params`` recipe: dense kernels N(0, fan_in^-1/2), patch
    kernel, class embedding and position table N(0, 0.02), norm scales 1,
    biases 0."""
    g = torch.Generator(device=device).manual_seed(seed)
    model = _empty_model(ClipVisionModel, cfg, device, dtype)
    _init_random_modules(model, g)
    model.vision_model.embeddings.class_embedding.normal_(0.0, 0.02, generator=g)
    return model


@torch.no_grad()
def init_random_intern_vit(cfg: InternVisionConfig, device, dtype=torch.bfloat16, seed: int = 0) -> InternVisionModel:
    """Random InternViT made on ``device`` from ``seed``, with the JAX
    ``intern_vit.init_params`` recipe: dense kernels N(0, fan_in^-1/2),
    patch kernel, class token and position table N(0, 0.02), RMSNorm
    scales and layer scales 1, biases 0."""
    g = torch.Generator(device=device).manual_seed(seed)
    model = _empty_model(InternVisionModel, cfg, device, dtype)
    _init_random_modules(model, g)
    emb = model.embeddings
    for t in (emb.cls_token, emb.position_embeddings):
        t.normal_(0.0, 0.02, generator=g)
    for layer in model.encoder.layer:
        layer.lambda_1.fill_(1.0)
        layer.lambda_2.fill_(1.0)
    return model


@torch.no_grad()
def init_random_radio(cfg: RadioBackboneConfig, device, dtype=torch.bfloat16, seed: int = 0) -> RadioModel:
    """Random RADIO backbone made on ``device`` from ``seed``, with the JAX
    ``init_radio_params`` recipe: dense kernels (the patch embedder is one)
    N(0, fan_in^-1/2), summary tokens and the CPE table N(0, 0.02), norm
    scales 1, biases 0."""
    g = torch.Generator(device=device).manual_seed(seed)
    model = _empty_model(RadioModel, cfg, device, dtype)
    _init_random_modules(model, g)
    pg = model.model.patch_generator
    for t in (pg.cls_token.token, pg.pos_embed):
        t.normal_(0.0, 0.02, generator=g)
    return model


@torch.no_grad()
def init_random_mpt(cfg: MPTConfig, device, dtype=torch.bfloat16, seed: int = 0) -> MptForCausalLM:
    """Random MPT made on ``device`` from ``seed``, with the JAX
    ``mpt.init_params`` recipe: dense kernels N(0, fan_in^-1/2), the
    embedding table N(0, 0.02), norm scales 1."""
    g = torch.Generator(device=device).manual_seed(seed)
    model = _empty_model(MptForCausalLM, cfg, device, dtype)
    _init_random_modules(model, g)
    return model
