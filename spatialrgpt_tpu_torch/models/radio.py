"""RADIO vision tower (port of ``spatialrgpt_tpu/models/radio.py``): the
``radio:<resolution>:<checkpoint>:<k=v,...>`` spec string, the
longest-edge-resize + bottom/right-pad processor (both copies of the
reference's code), and the backbone of the released checkpoints: a
timm-layout ViT-H/16 whose patch generator carries RADIO's Cropped
Positional Embedding (CPE), a position table at the largest training grid
(64 x 64) resampled bilinearly to each input's patch grid by JAX's
``jax.image.resize`` weight matrices (``models/depth_anything.py::
image_resize``).

Parameters live in ``RadioModel`` under the timm names
(``model.patch_generator.embedder.weight``, ``model.blocks.{i}.attn.qkv``,
...).  Feature selects, as the reference's:
  - ``patch``  -> (B, T, 1280) patch tokens (default)
  - ``cls``    -> (B, 1, 5120) the 4 summary tokens concatenated
  - ``cls4``   -> (B, 4, 1280) the summary tokens as 4 tokens
  - ``dense``  -> (B, T, 5120): the three quarter-depth block-group
                  averages concatenated with the final normed features

Attention stays plain, as it is plain XLA in the reference: f32 scores,
softmax, P cast to the value dtype before P V.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image
from torch import nn

from spatialrgpt_tpu_torch.models.depth_anything import image_resize
from spatialrgpt_tpu_torch.ops.layers import layer_norm, linear
from spatialrgpt_tpu_torch.utils.device import card_device


# ---------------------------------------------------------------------------
# Spec string (radio_encoder.py parses "radio:<res>:<name>:<extra,k=v>")
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RadioSpec:
    resolution: int
    checkpoint: str
    options: Tuple[Tuple[str, str], ...] = ()

    @property
    def options_dict(self) -> Dict[str, str]:
        return dict(self.options)


def parse_radio_spec(spec: str) -> RadioSpec:
    parts = spec.split(":")
    if parts[0] != "radio" or len(parts) < 3:
        raise ValueError(f"not a radio spec: {spec}")
    res = int(parts[1])
    ckpt = parts[2]
    opts = []
    if len(parts) > 3 and parts[3]:
        for kv in parts[3].split(","):
            if "=" in kv:
                k, v = kv.split("=", 1)
                opts.append((k, v))
            else:
                opts.append((kv, "true"))
    return RadioSpec(resolution=res, checkpoint=ckpt, options=tuple(opts))


# ---------------------------------------------------------------------------
# Processor: longest-edge resize (round-half-up) + bottom/right pad
# ---------------------------------------------------------------------------


@dataclass
class RadioImageProcessor:
    longest_edge: int = 768
    pad_multiple: int = 16
    pad_value: float = 0.0
    do_normalize: bool = True
    image_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    image_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)

    def get_preprocess_shape(self, h: int, w: int) -> Tuple[int, int]:
        """(image_processor.py:219-227: scale longest edge, round +0.5)."""
        scale = self.longest_edge / max(h, w)
        return int(h * scale + 0.5), int(w * scale + 0.5)

    def __call__(self, image) -> Dict[str, np.ndarray]:
        if isinstance(image, Image.Image):
            arr = np.asarray(image.convert("RGB"))
        else:
            arr = np.asarray(image)
        h, w = arr.shape[:2]
        nh, nw = self.get_preprocess_shape(h, w)
        img = np.asarray(
            Image.fromarray(arr.astype(np.uint8)).resize((nw, nh), Image.BICUBIC),
            np.float32,
        ) / 255.0
        if self.do_normalize:
            img = (img - np.asarray(self.image_mean)) / np.asarray(self.image_std)
        ph = -(-nh // self.pad_multiple) * self.pad_multiple
        pw = -(-nw // self.pad_multiple) * self.pad_multiple
        out = np.full((ph, pw, 3), self.pad_value, np.float32)
        out[:nh, :nw] = img  # bottom/right pad (image_processor.py:181-217)
        return {"pixel_values": out, "unpadded_size": (nh, nw)}


# ---------------------------------------------------------------------------
# Backbone: timm-layout ViT + CPE patch generator
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RadioBackboneConfig:
    hidden_size: int = 1280  # ViT-H
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    intermediate_size: int = 5120
    patch_size: int = 16
    num_cls_tokens: int = 4  # summary tokens (get_hidden_size: cls = 5120)
    num_registers: int = 0  # extra skip tokens (patch_gen.num_skip = cls + reg)
    cpe_grid: int = 64  # CPE table stored at (cpe_grid)^2 patches (1024 px / 16)
    layer_norm_eps: float = 1e-6
    summary_idxs: Optional[Tuple[int, ...]] = None  # radio_model.summary_idxs
    skip_layer_norm: bool = False  # spec option skip_layer_norm=True

    @property
    def num_skip(self) -> int:
        return self.num_cls_tokens + self.num_registers


class ClsToken(nn.Module):
    def __init__(self, cfg: RadioBackboneConfig, dtype=None):
        super().__init__()
        self.token = nn.Parameter(torch.empty(cfg.num_skip, cfg.hidden_size, dtype=dtype))


class PatchGenerator(nn.Module):
    def __init__(self, cfg: RadioBackboneConfig, dtype=None):
        super().__init__()
        p, h = cfg.patch_size, cfg.hidden_size
        # timm's ViTPatchLinear: patches flattened in (channel, row, column) order
        self.embedder = nn.Linear(3 * p * p, h, dtype=dtype)
        self.cls_token = ClsToken(cfg, dtype)
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.cpe_grid * cfg.cpe_grid, h, dtype=dtype))


class RadioAttention(nn.Module):
    def __init__(self, h: int, dtype=None):
        super().__init__()
        self.qkv = nn.Linear(h, 3 * h, dtype=dtype)
        self.proj = nn.Linear(h, h, dtype=dtype)


class RadioMlp(nn.Module):
    def __init__(self, h: int, inter: int, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(h, inter, dtype=dtype)
        self.fc2 = nn.Linear(inter, h, dtype=dtype)


class RadioBlock(nn.Module):
    def __init__(self, cfg: RadioBackboneConfig, dtype=None):
        super().__init__()
        h = cfg.hidden_size
        self.norm1 = nn.LayerNorm(h, eps=cfg.layer_norm_eps, dtype=dtype)
        self.attn = RadioAttention(h, dtype)
        self.norm2 = nn.LayerNorm(h, eps=cfg.layer_norm_eps, dtype=dtype)
        self.mlp = RadioMlp(h, cfg.intermediate_size, dtype)


class RadioBackbone(nn.Module):
    def __init__(self, cfg: RadioBackboneConfig, dtype=None):
        super().__init__()
        self.patch_generator = PatchGenerator(cfg, dtype)
        self.blocks = nn.ModuleList(RadioBlock(cfg, dtype) for _ in range(cfg.num_hidden_layers))
        self.norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, dtype=dtype)


class RadioModel(nn.Module):
    def __init__(self, cfg: RadioBackboneConfig, dtype=None):
        super().__init__()
        self.model = RadioBackbone(cfg, dtype)


def cpe_position_embed(pos_embed: torch.Tensor, cpe_grid: int, gh: int, gw: int) -> torch.Tensor:
    """CPE at inference: the (cpe_grid, cpe_grid) position table resampled
    in f32 to the input's (gh, gw) patch grid as ``jax.image.resize(...,
    "bilinear")`` resamples it (antialiased when it shrinks)."""
    H = pos_embed.shape[-1]
    table = pos_embed.reshape(cpe_grid, cpe_grid, H).float()
    if (gh, gw) != (cpe_grid, cpe_grid):
        table = image_resize(table[None], (gh, gw), "bilinear", antialias=True)[0]
    return table.reshape(gh * gw, H).to(pos_embed.dtype)


def _radio_attention(x: torch.Tensor, attn: RadioAttention, nh: int) -> torch.Tensor:
    B, T, H = x.shape
    d = H // nh
    qkv = linear(x, attn.qkv).reshape(B, T, 3, nh, d)
    q, k, v = qkv.unbind(2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d**-0.5
    probs = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, H)
    return linear(out, attn.proj)


def _radio_block(x: torch.Tensor, blk: RadioBlock, cfg: RadioBackboneConfig) -> torch.Tensor:
    eps = cfg.layer_norm_eps
    h = layer_norm(x, blk.norm1.weight, blk.norm1.bias, eps)
    x = x + _radio_attention(h, blk.attn, cfg.num_attention_heads)
    h = layer_norm(x, blk.norm2.weight, blk.norm2.bias, eps)
    h = F.gelu(linear(h, blk.mlp.fc1))
    return x + linear(h, blk.mlp.fc2)


def _embed_tokens(model: RadioModel, cfg: RadioBackboneConfig, pixels: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, num_skip + gh*gw, hidden): patchify + CPE +
    the summary / register tokens in front (RADIO's ViTPatchGenerator)."""
    pg = model.model.patch_generator
    B, Hpx, Wpx, _ = pixels.shape
    P = cfg.patch_size
    if Hpx % P or Wpx % P:
        raise ValueError(f"input {Hpx}x{Wpx} not a multiple of patch {P}")
    gh, gw = Hpx // P, Wpx // P
    patches = pixels.reshape(B, gh, P, gw, P, 3).permute(0, 1, 3, 5, 2, 4).reshape(B, gh * gw, 3 * P * P)
    x = linear(patches.to(pg.embedder.weight.dtype), pg.embedder)
    x = x + cpe_position_embed(pg.pos_embed, cfg.cpe_grid, gh, gw)[None]
    cls = pg.cls_token.token.to(x.dtype).expand(B, -1, -1)
    return torch.cat([cls, x], dim=1)


def _split_summary(x: torch.Tensor, cfg: RadioBackboneConfig):
    """tokens -> (summary, patch features), the reference's
    ``_split_summary`` (the CPE patch-generator branch)."""
    all_summary = x[:, : cfg.num_cls_tokens]
    summary = all_summary[:, list(cfg.summary_idxs)] if cfg.summary_idxs is not None else all_summary
    return summary, x[:, cfg.num_skip :]


def _final_norm(model: RadioModel, cfg: RadioBackboneConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.skip_layer_norm:
        return x
    norm = model.model.norm
    return layer_norm(x, norm.weight, norm.bias, cfg.layer_norm_eps)


def radio_forward(model: RadioModel, cfg: RadioBackboneConfig, pixels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full backbone forward: (summary (B, n_cls, H), features (B, T, H))."""
    x = _embed_tokens(model, cfg, pixels)
    for blk in model.model.blocks:
        x = _radio_block(x, blk, cfg)
    return _split_summary(_final_norm(model, cfg, x), cfg)


def radio_forward_dense(
    model: RadioModel, cfg: RadioBackboneConfig, pixels: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The "dense" select: the patch features averaged over each
    quarter-depth block group, the three quarter averages concatenated
    with the final normed features -> 4x hidden."""
    L = cfg.num_hidden_layers
    multilayers = {L // 4 - 1, L // 2 - 1, L // 4 * 3 - 1}
    x = _embed_tokens(model, cfg, pixels)
    groups, acc = [], []
    for i, blk in enumerate(model.model.blocks):
        x = _radio_block(x, blk, cfg)
        acc.append(_split_summary(x, cfg)[1])
        if i in multilayers:
            groups.append(sum(acc) / len(acc))
            acc = []
    summary, last = _split_summary(_final_norm(model, cfg, x), cfg)
    groups.append(last)
    return summary, torch.cat(groups, dim=-1)


def convert_radio_state_dict(sd: Dict[str, np.ndarray], cfg: RadioBackboneConfig) -> Dict[str, torch.Tensor]:
    """The released RADIO checkpoints' timm key layout -> ``RadioModel``'s
    state dict, shape-checked against it (``ValueError`` on a missing or
    misshapen entry).  The keys are the model's own; what changes:

      model.patch_generator.embedder.weight  (H, 3, P, P) conv -> (H, 3*P*P)
                                              linear; a missing bias is 0
      model.patch_generator.cls_token.token  (1, n_cls, H) -> (n_cls, H)
      model.patch_generator.pos_embed        (G*G, H) or (1, G*G, H) -> (1, G*G, H)
    """
    H = cfg.hidden_size
    out = {name: a if isinstance(a, torch.Tensor) else torch.tensor(np.asarray(a)) for name, a in sd.items()}
    pg = "model.patch_generator."
    emb = out.get(pg + "embedder.weight")
    if emb is not None:
        out[pg + "embedder.weight"] = emb.reshape(H, -1)
        out.setdefault(pg + "embedder.bias", torch.zeros(H, dtype=emb.dtype))
    for name, shape in ((pg + "cls_token.token", (-1, H)), (pg + "pos_embed", (1, -1, H))):
        if name in out:
            out[name] = out[name].reshape(shape)
    with torch.device("meta"):
        want = RadioModel(cfg).state_dict()
    for name, t in want.items():
        if name not in out:
            raise ValueError(f"missing param {name}")
        if tuple(out[name].shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch at {name}: {tuple(out[name].shape)} != {tuple(t.shape)}")
    return {name: out[name] for name in want}


# ---------------------------------------------------------------------------
# Tower
# ---------------------------------------------------------------------------


class RadioVisionTower:
    """The reference tower interface over the backbone above: spec
    parsing, processor, feature select, hidden-size contract (cls / dense
    -> 4x hidden).  Without ``model`` it makes a random backbone from
    ``seed`` on ``device`` (the card unless given; feed
    ``convert_radio_state_dict``'s output to a ``RadioModel`` for the
    released weights).  ``backbone=`` still accepts an injected callable."""

    def __init__(
        self,
        spec: str,
        backbone=None,
        model: Optional[RadioModel] = None,
        backbone_cfg: Optional[RadioBackboneConfig] = None,
        select_feature: str = "patch",
        device=None,
        dtype=torch.float32,
        seed: int = 0,
    ):
        self.spec = parse_radio_spec(spec)
        self.processor = RadioImageProcessor(longest_edge=self.spec.resolution)
        opts = self.spec.options_dict
        skip_ln = opts.get("skip_layer_norm", "False").lower() in ("true", "1")
        self.cfg = backbone_cfg or RadioBackboneConfig(skip_layer_norm=skip_ln)
        self.select_feature = select_feature
        self._injected = backbone
        self.model = model
        if backbone is None and model is None:
            from spatialrgpt_tpu_torch.utils.weights import init_random_radio

            self.model = init_random_radio(self.cfg, card_device(device, "RadioVisionTower"), dtype, seed)

    @property
    def hidden_size(self) -> int:
        if self.select_feature in ("cls", "dense"):
            return 4 * self.cfg.hidden_size
        return self.cfg.hidden_size

    def __call__(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> features per select_feature (see the module doc)."""
        if self._injected is not None:
            return self._injected(pixel_values)
        fwd = radio_forward_dense if self.select_feature == "dense" else radio_forward
        summary, features = fwd(self.model, self.cfg, pixel_values)
        B = pixel_values.shape[0]
        if self.select_feature == "cls":
            return summary.reshape(B, 1, -1)
        if self.select_feature == "cls4":
            return summary.reshape(B, self.cfg.num_cls_tokens, -1)
        if self.select_feature in ("patch", "dense"):
            return features
        raise ValueError(f"unknown select_feature {self.select_feature}")
