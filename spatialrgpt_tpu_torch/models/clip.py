"""CLIP vision tower (port of ``spatialrgpt_tpu/models/clip.py``).

The reference's CLIPVisionTower over HF ``CLIPVisionModel``: a class-token
ViT with a pre-layernorm (``pre_layrnorm``, HF's spelling), quick-GELU
MLPs and the same ``select_layer`` / ``select_feature`` contract as SigLIP
(``"patch"``, CLIP's default, drops the class token).  Parameters live in
``ClipVisionModel`` under the HF names; its encoder layers are SigLIP's
modules, whose names HF's CLIP shares.  Attention goes through kernel K1
(``ops/vit_attention.py``) with ``attn_impl="onepass"`` and its plain
version with ``"xla"``; a CPU tensor takes the plain version either way.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from spatialrgpt_tpu_torch.config import SiglipVisionConfig as CLIPVisionConfig
from spatialrgpt_tpu_torch.models.siglip import SiglipEncoder, _attention
from spatialrgpt_tpu_torch.ops.layers import layer_norm, linear


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class ClipEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, dtype=None):
        super().__init__()
        c, p = cfg.hidden_size, cfg.patch_size
        self.class_embedding = nn.Parameter(torch.empty(c, dtype=dtype))
        # parameter storage only (no bias: CLIP's conv has none); the forward is unfold + matmul
        self.patch_embedding = nn.Conv2d(3, c, p, stride=p, bias=False, dtype=dtype)
        self.position_embedding = nn.Embedding(cfg.num_patches + 1, c, dtype=dtype)


class ClipVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, dtype=None):
        super().__init__()
        c = cfg.hidden_size
        self.embeddings = ClipEmbeddings(cfg, dtype)
        self.pre_layrnorm = nn.LayerNorm(c, eps=cfg.layer_norm_eps, dtype=dtype)
        self.encoder = SiglipEncoder(cfg, dtype)
        self.post_layernorm = nn.LayerNorm(c, eps=cfg.layer_norm_eps, dtype=dtype)


class ClipVisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, dtype=None):
        super().__init__()
        self.vision_model = ClipVisionTransformer(cfg, dtype)


def encoder_layer(x: torch.Tensor, layer: nn.Module, cfg: CLIPVisionConfig, attn_impl: str = "onepass") -> torch.Tensor:
    eps = cfg.layer_norm_eps
    h = layer_norm(x, layer.layer_norm1.weight, layer.layer_norm1.bias, eps)
    x = x + _attention(h, layer.self_attn, cfg.num_attention_heads, attn_impl)
    h = layer_norm(x, layer.layer_norm2.weight, layer.layer_norm2.bias, eps)
    h = quick_gelu(linear(h, layer.mlp.fc1))
    return x + linear(h, layer.mlp.fc2)


def embed(model: ClipVisionModel, pixel_values: torch.Tensor, cfg: CLIPVisionConfig) -> torch.Tensor:
    """(B, H, W, 3) NHWC -> (B, 1 + num_patches, hidden): patches (a stride-P
    convolution as a matmul of the unfolded patches), the class token
    first, then the position table."""
    emb = model.vision_model.embeddings
    w = emb.patch_embedding.weight  # (C, 3, P, P)
    C, P = w.shape[0], cfg.patch_size
    B, H, W, _ = pixel_values.shape
    gh, gw = H // P, W // P
    x = pixel_values[:, : gh * P, : gw * P].to(w.dtype)
    x = x.reshape(B, gh, P, gw, P, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gw, P * P * 3)
    x = torch.matmul(x, w.permute(2, 3, 1, 0).reshape(P * P * 3, C))
    cls = emb.class_embedding.to(x.dtype).expand(B, 1, C)
    x = torch.cat([cls, x], dim=1)
    return x + emb.position_embedding.weight[None].to(x.dtype)


def forward_features(
    model: ClipVisionModel, pixel_values: torch.Tensor, cfg: CLIPVisionConfig, attn_impl: str = "onepass"
) -> torch.Tensor:
    """Tower features with the reference's feature_select applied:
    (B, H, W, 3) normalized pixels -> (B, num_patches, hidden) for
    ``"patch"``, (B, 1 + num_patches, hidden) for ``"cls_patch"``."""
    vm = model.vision_model
    x = embed(model, pixel_values, cfg)
    x = layer_norm(x, vm.pre_layrnorm.weight, vm.pre_layrnorm.bias, cfg.layer_norm_eps)
    sel = cfg.select_layer
    if sel < 0:
        sel = cfg.num_hidden_layers + 1 + sel
    for li in range(sel):
        x = encoder_layer(x, vm.encoder.layers[li], cfg, attn_impl)
    if cfg.select_feature == "patch":
        x = x[:, 1:]
    elif cfg.select_feature != "cls_patch":
        raise ValueError(f"Unexpected select feature: {cfg.select_feature}")
    return x


def convert_clip(sd, num_layers: int) -> Dict[str, torch.Tensor]:
    """HF ``CLIPVisionModel`` state dict (with or without the
    ``vision_model.`` prefix) -> ``ClipVisionModel``'s state dict for
    ``num_layers`` layers: the names the reference's ``convert_clip``
    reads, under the prefix; the rest (HF's ``position_ids``, deeper
    layers) is left out."""
    pref = "vision_model." if any(k.startswith("vision_model.") for k in sd) else ""
    keep = ("embeddings.", "pre_layrnorm.", "post_layernorm.") + tuple(
        f"encoder.layers.{i}." for i in range(num_layers))
    out = {}
    for name, t in sd.items():
        local = name[len(pref):]
        if name.startswith(pref) and local.startswith(keep) and not local.endswith("position_ids"):
            out["vision_model." + local] = t if isinstance(t, torch.Tensor) else torch.tensor(np.asarray(t))
    return out
