"""InternViT vision tower, InternViT-6B (port of
``spatialrgpt_tpu/models/intern_vit.py``).

A class-token ViT with RMSNorm pre-norms, the q/k RMSNorm taken over the
flattened H*D axis before the head split, LayerScale (``lambda_1`` /
``lambda_2``) residual scales, an exact-GELU MLP and the towers'
``select_layer`` / ``select_feature`` contract.  Parameters live in
``InternVisionModel`` under HF ``InternVLVisionModel``'s names (the
released checkpoints' layout: separate q/k/v projections).  Attention goes
through kernel K1 with ``attn_impl="onepass"``: InternViT-6B's head dim is
128, K1's wide form; ``"xla"`` takes K1's plain version, and so does a CPU
tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
from torch import nn

from spatialrgpt_tpu_torch.ops.layers import gelu_erf, linear
from spatialrgpt_tpu_torch.ops.vit_attention import vit_attention, vit_attention_plain


@dataclass(frozen=True)
class InternVisionConfig:
    hidden_size: int = 3200  # InternViT-6B
    intermediate_size: int = 12800
    num_hidden_layers: int = 48
    num_attention_heads: int = 25
    image_size: int = 448
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    qk_normalization: bool = True
    select_layer: int = -1
    select_feature: str = "patch"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class InternPatchEmbeddings(nn.Module):
    def __init__(self, cfg: InternVisionConfig, dtype=None):
        super().__init__()
        p = cfg.patch_size
        # parameter storage only: the forward is unfold + matmul
        self.projection = nn.Conv2d(3, cfg.hidden_size, p, stride=p, dtype=dtype)


class InternVisionEmbeddings(nn.Module):
    def __init__(self, cfg: InternVisionConfig, dtype=None):
        super().__init__()
        c = cfg.hidden_size
        self.cls_token = nn.Parameter(torch.empty(1, 1, c, dtype=dtype))
        self.patch_embeddings = InternPatchEmbeddings(cfg, dtype)
        self.position_embeddings = nn.Parameter(torch.empty(1, cfg.num_patches + 1, c, dtype=dtype))


class InternVisionAttention(nn.Module):
    def __init__(self, cfg: InternVisionConfig, dtype=None):
        super().__init__()
        c = cfg.hidden_size
        self.q_proj = nn.Linear(c, c, dtype=dtype)
        self.k_proj = nn.Linear(c, c, dtype=dtype)
        self.v_proj = nn.Linear(c, c, dtype=dtype)
        self.projection_layer = nn.Linear(c, c, dtype=dtype)
        if cfg.qk_normalization:
            self.q_norm = nn.RMSNorm(c, eps=cfg.layer_norm_eps, dtype=dtype)
            self.k_norm = nn.RMSNorm(c, eps=cfg.layer_norm_eps, dtype=dtype)


class InternVisionMLP(nn.Module):
    def __init__(self, cfg: InternVisionConfig, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size, dtype=dtype)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size, dtype=dtype)


class InternVisionLayer(nn.Module):
    def __init__(self, cfg: InternVisionConfig, dtype=None):
        super().__init__()
        c = cfg.hidden_size
        self.attention = InternVisionAttention(cfg, dtype)
        self.mlp = InternVisionMLP(cfg, dtype)
        self.layernorm_before = nn.RMSNorm(c, eps=cfg.layer_norm_eps, dtype=dtype)
        self.layernorm_after = nn.RMSNorm(c, eps=cfg.layer_norm_eps, dtype=dtype)
        self.lambda_1 = nn.Parameter(torch.empty(c, dtype=dtype))
        self.lambda_2 = nn.Parameter(torch.empty(c, dtype=dtype))


class InternVisionEncoder(nn.Module):
    def __init__(self, cfg: InternVisionConfig, dtype=None):
        super().__init__()
        self.layer = nn.ModuleList(InternVisionLayer(cfg, dtype) for _ in range(cfg.num_hidden_layers))


class InternVisionModel(nn.Module):
    def __init__(self, cfg: InternVisionConfig, dtype=None):
        super().__init__()
        self.embeddings = InternVisionEmbeddings(cfg, dtype)
        self.encoder = InternVisionEncoder(cfg, dtype)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with the variance, the normalization and the scale in f32,
    cast once (the reference's ``_rms``)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def _attention(x: torch.Tensor, attn: InternVisionAttention, cfg: InternVisionConfig, attn_impl: str) -> torch.Tensor:
    B, N, C = x.shape
    H = cfg.num_attention_heads
    D = C // H
    q, k, v = linear(x, attn.q_proj), linear(x, attn.k_proj), linear(x, attn.v_proj)
    if cfg.qk_normalization:
        # qk-norm over the flattened (H*D) axis, then the head split
        q = _rms(q, attn.q_norm.weight, cfg.layer_norm_eps)
        k = _rms(k, attn.k_norm.weight, cfg.layer_norm_eps)
    q, k, v = (t.view(B, N, H, D) for t in (q, k, v))
    if attn_impl == "onepass":
        o = vit_attention(q, k, v)
    elif attn_impl == "xla":
        o = vit_attention_plain(q, k, v)
    else:
        raise ValueError(f"unknown attention impl: {attn_impl}")
    return linear(o.reshape(B, N, C), attn.projection_layer)


def embed(model: InternVisionModel, pixel_values: torch.Tensor, cfg: InternVisionConfig) -> torch.Tensor:
    """(B, H, W, 3) NHWC -> (B, 1 + num_patches, hidden): the stride-P
    convolution with its bias as a matmul of the unfolded patches, the
    class token first, then the position table."""
    emb = model.embeddings
    conv = emb.patch_embeddings.projection
    w = conv.weight  # (C, 3, P, P)
    C, P = w.shape[0], cfg.patch_size
    B, Hp, Wp, _ = pixel_values.shape
    gh, gw = Hp // P, Wp // P
    x = pixel_values[:, : gh * P, : gw * P].to(w.dtype)
    x = x.reshape(B, gh, P, gw, P, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gw, P * P * 3)
    x = torch.matmul(x, w.permute(2, 3, 1, 0).reshape(P * P * 3, C)) + conv.bias
    x = torch.cat([emb.cls_token.to(x.dtype).expand(B, 1, C), x], dim=1)
    return x + emb.position_embeddings.to(x.dtype)


def encoder_layer(x: torch.Tensor, layer: InternVisionLayer, cfg: InternVisionConfig,
                  attn_impl: str = "onepass") -> torch.Tensor:
    eps = cfg.layer_norm_eps
    x = x + _attention(_rms(x, layer.layernorm_before.weight, eps), layer.attention, cfg, attn_impl) * (
        layer.lambda_1.to(x.dtype))
    h = _rms(x, layer.layernorm_after.weight, eps)
    h = linear(gelu_erf(linear(h, layer.mlp.fc1)), layer.mlp.fc2)
    return x + h * layer.lambda_2.to(x.dtype)


def forward_features(
    model: InternVisionModel, pixel_values: torch.Tensor, cfg: InternVisionConfig, attn_impl: str = "onepass"
) -> torch.Tensor:
    """(B, H, W, 3) normalized pixels -> (B, num_patches, hidden) for
    ``"patch"`` (the class token dropped), else every token, after
    ``select_layer``'s layers."""
    x = embed(model, pixel_values, cfg)
    sel = cfg.select_layer
    if sel < 0:
        sel = cfg.num_hidden_layers + 1 + sel
    for layer in model.encoder.layer[:sel]:
        x = encoder_layer(x, layer, cfg, attn_impl)
    if cfg.select_feature == "patch":
        x = x[:, 1:]
    return x


def _tensor(t) -> torch.Tensor:
    return t if isinstance(t, torch.Tensor) else torch.tensor(np.asarray(t))


def convert_intern_vit(sd, cfg: InternVisionConfig) -> Dict[str, torch.Tensor]:
    """HF ``InternVLVisionModel`` state dict -> ``InternVisionModel``'s.

    The released checkpoints hold separate q/k/v projections under these
    very names; a fused ``attention.qkv`` (rows [q | k | v], the JAX tree's
    layout) is split into them.  A projection saved without a bias
    (``attention_bias=False``) gets a zero bias, which adds nothing."""
    c = cfg.hidden_size
    out = {}

    def take(name: str, size: int = c) -> None:
        out[name + ".weight"] = _tensor(sd[name + ".weight"])
        bias = sd.get(name + ".bias")
        out[name + ".bias"] = _tensor(bias) if bias is not None else torch.zeros(size, dtype=out[name + ".weight"].dtype)

    for i in range(cfg.num_hidden_layers):
        b = f"encoder.layer.{i}."
        a = b + "attention."
        if a + "qkv.weight" in sd:
            w = _tensor(sd[a + "qkv.weight"])
            bias = sd.get(a + "qkv.bias")
            bias = _tensor(bias) if bias is not None else torch.zeros(3 * c, dtype=w.dtype)
            for j, n in enumerate("qkv"):
                out[a + f"{n}_proj.weight"] = w[j * c : (j + 1) * c]
                out[a + f"{n}_proj.bias"] = bias[j * c : (j + 1) * c]
        else:
            for n in "qkv":
                take(a + f"{n}_proj")
        take(a + "projection_layer")
        take(b + "mlp.fc1", cfg.intermediate_size)
        take(b + "mlp.fc2")
        for name in ("layernorm_before.weight", "layernorm_after.weight", "lambda_1", "lambda_2"):
            out[b + name] = _tensor(sd[b + name])
        if cfg.qk_normalization:
            for n in ("q_norm", "k_norm"):
                out[a + n + ".weight"] = _tensor(sd[a + n + ".weight"])
    for name in ("embeddings.cls_token", "embeddings.patch_embeddings.projection.weight",
                 "embeddings.patch_embeddings.projection.bias", "embeddings.position_embeddings"):
        out[name] = _tensor(sd[name])
    return out
