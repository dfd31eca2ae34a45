"""SigLIP vision tower (port of ``spatialrgpt_tpu/models/siglip.py``).

Parameters live in ``SiglipVisionModel`` under the HF names
(``vision_model.embeddings.patch_embedding.weight``, ...).  The forward
functions are plain functions over that module, with the reference's
``select_layer`` / ``select_feature`` contract: hidden_states index 0 is
the embedding output and index k the output of layer k; ``select_layer=-2``
runs all but the last layer, and ``'patch'`` drops token 0.

Attention goes through kernel K1 (``ops/vit_attention.py``) with the
default ``attn_impl="onepass"`` (the name the whole serving path uses for
its kernel route); ``attn_impl="xla"`` takes K1's plain version instead.
The reference's
pad-once path and VIT_KNOBS are not ported: they work around TPU layout
rules, and K1 masks the ragged sequence itself.
"""

from __future__ import annotations

import torch
from torch import nn

from spatialrgpt_tpu_torch.config import SiglipVisionConfig
from spatialrgpt_tpu_torch.ops.layers import gelu_tanh, layer_norm, linear, qkv_proj
from spatialrgpt_tpu_torch.ops.vit_attention import vit_attention, vit_attention_plain


class SiglipAttention(nn.Module):
    def __init__(self, c: int, dtype=None):
        super().__init__()
        self.q_proj = nn.Linear(c, c, dtype=dtype)
        self.k_proj = nn.Linear(c, c, dtype=dtype)
        self.v_proj = nn.Linear(c, c, dtype=dtype)
        self.out_proj = nn.Linear(c, c, dtype=dtype)


class SiglipMLP(nn.Module):
    def __init__(self, c: int, inter: int, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(c, inter, dtype=dtype)
        self.fc2 = nn.Linear(inter, c, dtype=dtype)


class SiglipEncoderLayer(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, dtype=None):
        super().__init__()
        c = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(c, eps=cfg.layer_norm_eps, dtype=dtype)
        self.self_attn = SiglipAttention(c, dtype)
        self.layer_norm2 = nn.LayerNorm(c, eps=cfg.layer_norm_eps, dtype=dtype)
        self.mlp = SiglipMLP(c, cfg.intermediate_size, dtype)


class SiglipEncoder(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList(SiglipEncoderLayer(cfg, dtype) for _ in range(cfg.num_hidden_layers))


class SiglipEmbeddings(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, dtype=None):
        super().__init__()
        p = cfg.patch_size
        # parameter storage only: the forward is unfold + matmul (embed below)
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, p, stride=p, dtype=dtype)
        self.position_embedding = nn.Embedding(cfg.num_patches, cfg.hidden_size, dtype=dtype)


class SiglipVisionTransformer(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, dtype=None):
        super().__init__()
        self.embeddings = SiglipEmbeddings(cfg, dtype)
        self.encoder = SiglipEncoder(cfg, dtype)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, dtype=dtype)


class SiglipVisionModel(nn.Module):
    def __init__(self, cfg: SiglipVisionConfig, dtype=None):
        super().__init__()
        self.vision_model = SiglipVisionTransformer(cfg, dtype)


def _attention(x: torch.Tensor, attn: SiglipAttention, num_heads: int, attn_impl: str) -> torch.Tensor:
    B, S, C = x.shape
    D = C // num_heads
    q, k, v = qkv_proj(x, attn, num_heads, num_heads, D)
    if attn_impl == "onepass":
        out = vit_attention(q, k, v)
    elif attn_impl == "xla":
        out = vit_attention_plain(q, k, v)
    else:
        raise ValueError(f"unknown attention impl: {attn_impl}")
    return linear(out.reshape(B, S, C), attn.out_proj)


def _encoder_layer(x: torch.Tensor, layer: SiglipEncoderLayer, cfg: SiglipVisionConfig, attn_impl: str = "onepass") -> torch.Tensor:
    eps = cfg.layer_norm_eps
    h = layer_norm(x, layer.layer_norm1.weight, layer.layer_norm1.bias, eps)
    x = x + _attention(h, layer.self_attn, cfg.num_attention_heads, attn_impl)
    h = layer_norm(x, layer.layer_norm2.weight, layer.layer_norm2.bias, eps)
    h = linear(h, layer.mlp.fc1)
    h = gelu_tanh(h)
    h = linear(h, layer.mlp.fc2)
    return x + h


def embed(model: SiglipVisionModel, pixel_values: torch.Tensor, cfg: SiglipVisionConfig) -> torch.Tensor:
    """Patchify + positional embedding.  pixel_values: (B, H, W, 3) NHWC.

    The stride equals the kernel, so the convolution is exactly a matmul of
    the unfolded patches (and avoids cuDNN's TF32 default for fp32)."""
    emb = model.vision_model.embeddings
    w = emb.patch_embedding.weight  # (C, 3, P, P)
    C, P = w.shape[0], cfg.patch_size
    B, H, W, _ = pixel_values.shape
    gh, gw = H // P, W // P
    x = pixel_values[:, : gh * P, : gw * P].to(w.dtype)
    x = x.reshape(B, gh, P, gw, P, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gw, P * P * 3)
    wm = w.permute(2, 3, 1, 0).reshape(P * P * 3, C)  # (kh, kw, cin) x C
    x = torch.matmul(x, wm) + emb.patch_embedding.bias
    return x + emb.position_embedding.weight[None].to(x.dtype)


def forward_features(
    model: SiglipVisionModel, pixel_values: torch.Tensor, cfg: SiglipVisionConfig, attn_impl: str = "onepass"
) -> torch.Tensor:
    """Tower features with the reference's feature_select applied:
    (B, H, W, 3) normalized pixels -> (B, num_patches[-1], hidden)."""
    x = embed(model, pixel_values, cfg)
    sel = cfg.select_layer
    if sel < 0:
        sel = cfg.num_hidden_layers + 1 + sel
    for li in range(sel):
        x = _encoder_layer(x, model.vision_model.encoder.layers[li], cfg, attn_impl)
    if cfg.select_feature == "patch":
        x = x[:, 1:]
    elif cfg.select_feature != "cls_patch":
        raise ValueError(f"Unexpected select feature: {cfg.select_feature}")
    return x


def forward_full(
    model: SiglipVisionModel, pixel_values: torch.Tensor, cfg: SiglipVisionConfig, attn_impl: str = "onepass"
) -> torch.Tensor:
    """All layers + post layernorm (checkpoint validation)."""
    x = embed(model, pixel_values, cfg)
    for layer in model.vision_model.encoder.layers:
        x = _encoder_layer(x, layer, cfg, attn_impl)
    post = model.vision_model.post_layernorm
    return layer_norm(x, post.weight, post.bias, cfg.layer_norm_eps)
