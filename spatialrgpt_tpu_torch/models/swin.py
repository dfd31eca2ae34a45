"""Swin Transformer backbone (the RAM tagger's Swin-L), port of
``spatialrgpt_tpu/models/swin.py``: hierarchical windows (W-MSA and shifted
SW-MSA), the relative-position bias gathered from its table, the shifted
windows' additive mask and the 2 x 2 patch merge.

Parameters live in ``SwinModel`` under the HF ``SwinModel`` names that
``convert_swin`` reads, so an HF state dict loads as it is
(``convert_swin`` here).  The forward functions are plain functions over
that module in the reference's NHWC layout and dtype flow.  Attention is
plain PyTorch: the reference computes it in XLA, with no Pallas kernel.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from spatialrgpt_tpu_torch.ops.layers import gelu_erf, layer_norm, linear


@dataclass(frozen=True)
class SwinConfig:
    image_size: int = 224
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-5

    @property
    def num_features(self) -> int:
        return self.embed_dim * 2 ** (len(self.depths) - 1)


SWIN_L_384 = SwinConfig(
    image_size=384,
    patch_size=4,
    embed_dim=192,
    depths=(2, 2, 18, 2),
    num_heads=(6, 12, 24, 48),
    window_size=12,
)


def _rel_pos_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) index into the (2ws-1)^2 relative-position table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, T, T)
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


def _shift_attn_mask(hw: int, ws: int, shift: int) -> np.ndarray:
    """(nW, T, T) additive mask (0 / -100) for shifted-window attention."""
    img = np.zeros((hw, hw), np.int32)
    cnt = 0
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for hs in slices:
        for wsl in slices:
            img[hs, wsl] = cnt
            cnt += 1
    wins = img.reshape(hw // ws, ws, hw // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rel_pos_index_on(ws: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_rel_pos_index(ws).reshape(-1), device=device)


@functools.lru_cache(maxsize=None)
def _shift_attn_mask_on(hw: int, ws: int, shift: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_shift_attn_mask(hw, ws, shift), device=device)


# ---------------------------------------------------------------------------
# module tree (parameter storage under the HF SwinModel names)
# ---------------------------------------------------------------------------


class _PatchEmbeddings(nn.Module):
    def __init__(self, cfg: SwinConfig, dtype=None):
        super().__init__()
        # parameter storage only: the forward is unfold + matmul (``forward``)
        self.projection = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size, dtype=dtype)


class _Embeddings(nn.Module):
    def __init__(self, cfg: SwinConfig, dtype=None):
        super().__init__()
        self.patch_embeddings = _PatchEmbeddings(cfg, dtype)
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=cfg.layer_norm_eps, dtype=dtype)


class _SelfAttention(nn.Module):
    def __init__(self, c: int, num_heads: int, window: int, dtype=None):
        super().__init__()
        self.query = nn.Linear(c, c, dtype=dtype)
        self.key = nn.Linear(c, c, dtype=dtype)
        self.value = nn.Linear(c, c, dtype=dtype)
        self.relative_position_bias_table = nn.Parameter(torch.empty((2 * window - 1) ** 2, num_heads, dtype=dtype))


class _Dense(nn.Module):
    def __init__(self, din: int, dout: int, dtype=None):
        super().__init__()
        self.dense = nn.Linear(din, dout, dtype=dtype)


class _Attention(nn.Module):
    def __init__(self, c: int, num_heads: int, window: int, dtype=None):
        super().__init__()
        self.self = _SelfAttention(c, num_heads, window, dtype)
        self.output = _Dense(c, c, dtype)


class _Block(nn.Module):
    def __init__(self, cfg: SwinConfig, c: int, num_heads: int, dtype=None):
        super().__init__()
        self.layernorm_before = nn.LayerNorm(c, eps=cfg.layer_norm_eps, dtype=dtype)
        self.attention = _Attention(c, num_heads, cfg.window_size, dtype)
        self.layernorm_after = nn.LayerNorm(c, eps=cfg.layer_norm_eps, dtype=dtype)
        self.intermediate = _Dense(c, int(c * cfg.mlp_ratio), dtype)
        self.output = _Dense(int(c * cfg.mlp_ratio), c, dtype)


class _PatchMerging(nn.Module):
    def __init__(self, cfg: SwinConfig, c: int, dtype=None):
        super().__init__()
        self.norm = nn.LayerNorm(4 * c, eps=cfg.layer_norm_eps, dtype=dtype)
        self.reduction = nn.Linear(4 * c, 2 * c, bias=False, dtype=dtype)


class _Stage(nn.Module):
    def __init__(self, cfg: SwinConfig, si: int, dtype=None):
        super().__init__()
        c = cfg.embed_dim * 2**si
        self.blocks = nn.ModuleList(_Block(cfg, c, cfg.num_heads[si], dtype) for _ in range(cfg.depths[si]))
        if si < len(cfg.depths) - 1:
            self.downsample = _PatchMerging(cfg, c, dtype)


class _Encoder(nn.Module):
    def __init__(self, cfg: SwinConfig, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList(_Stage(cfg, si, dtype) for si in range(len(cfg.depths)))


class SwinModel(nn.Module):
    def __init__(self, cfg: SwinConfig, dtype=None):
        super().__init__()
        self.embeddings = _Embeddings(cfg, dtype)
        self.encoder = _Encoder(cfg, dtype)
        self.layernorm = nn.LayerNorm(cfg.num_features, eps=cfg.layer_norm_eps, dtype=dtype)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _ln(x: torch.Tensor, norm: nn.LayerNorm, eps: float) -> torch.Tensor:
    return layer_norm(x, norm.weight, norm.bias, eps)


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, ws*ws, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def _window_merge(wins: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    C = wins.shape[-1]
    x = wins.reshape(-1, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, H, W, C)


def _window_attention(x: torch.Tensor, attn: _Attention, num_heads: int, ws: int,
                      attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """x: (BnW, T, C); f32 scores plus the rel-pos bias (and the shift
    mask), probabilities cast to the value dtype, as the reference."""
    Bn, T, C = x.shape
    d = C // num_heads
    sa = attn.self
    q = linear(x, sa.query).view(Bn, T, num_heads, d).transpose(1, 2)
    k = linear(x, sa.key).view(Bn, T, num_heads, d).transpose(1, 2)
    v = linear(x, sa.value).view(Bn, T, num_heads, d).transpose(1, 2)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d**-0.5)
    bias = sa.relative_position_bias_table.float()[_rel_pos_index_on(ws, x.device)]  # (T*T, nh)
    scores = scores + bias.view(T, T, num_heads).permute(2, 0, 1)[None]
    if attn_mask is not None:
        nW = attn_mask.shape[0]
        scores = (scores.view(-1, nW, num_heads, T, T) + attn_mask[None, :, None]).view(Bn, num_heads, T, T)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(Bn, T, C)
    return linear(out, attn.output.dense)


def _block(x: torch.Tensor, blk: _Block, cfg: SwinConfig, num_heads: int, H: int, shift: int) -> torch.Tensor:
    """One Swin layer at square resolution H. x: (B, H*H, C)."""
    B, L, C = x.shape
    ws = min(cfg.window_size, H)
    if H <= cfg.window_size:
        shift = 0
    if H % ws:
        raise ValueError(f"resolution {H} not divisible by window {ws}")
    eps = cfg.layer_norm_eps
    h = _ln(x, blk.layernorm_before, eps).view(B, H, H, C)
    if shift:
        h = torch.roll(h, (-shift, -shift), dims=(1, 2))
    mask = _shift_attn_mask_on(H, ws, shift, x.device) if shift else None
    wins = _window_attention(_window_partition(h, ws), blk.attention, num_heads, ws, mask)
    h = _window_merge(wins, ws, H, H)
    if shift:
        h = torch.roll(h, (shift, shift), dims=(1, 2))
    x = x + h.reshape(B, L, C)
    h = _ln(x, blk.layernorm_after, eps)
    h = linear(gelu_erf(linear(h, blk.intermediate.dense)), blk.output.dense)
    return x + h


def _patch_merge(x: torch.Tensor, pm: _PatchMerging, H: int, eps: float) -> torch.Tensor:
    """(B, H*H, C) -> (B, (H/2)^2, 2C): 2x2 neighborhood concat + reduce."""
    B, L, C = x.shape
    g = x.view(B, H, H, C)
    cat = torch.cat([g[:, 0::2, 0::2], g[:, 1::2, 0::2], g[:, 0::2, 1::2], g[:, 1::2, 1::2]], dim=-1)
    return linear(_ln(cat.reshape(B, (H // 2) ** 2, 4 * C), pm.norm, eps), pm.reduction)


def forward(model: SwinModel, pixel_values: torch.Tensor, cfg: SwinConfig) -> torch.Tensor:
    """pixel_values: (B, H, W, 3) NHWC -> (B, (H/32)^2, num_features)."""
    proj = model.embeddings.patch_embeddings.projection
    w = proj.weight  # (C, 3, P, P)
    C, P = w.shape[0], cfg.patch_size
    B, Hi, Wi, _ = pixel_values.shape
    Hp, Wp = Hi // P, Wi // P
    # the stride equals the kernel ("VALID"): the patch conv is a matmul of the patches
    x = pixel_values[:, : Hp * P, : Wp * P].to(w.dtype).reshape(B, Hp, P, Wp, P, 3).permute(0, 1, 3, 2, 4, 5)
    x = torch.matmul(x.reshape(B, Hp * Wp, P * P * 3), w.permute(2, 3, 1, 0).reshape(P * P * 3, C)) + proj.bias
    eps = cfg.layer_norm_eps
    x = _ln(x, model.embeddings.norm, eps)
    H = Hp
    for si, stage in enumerate(model.encoder.layers):
        for bi, blk in enumerate(stage.blocks):
            x = _block(x, blk, cfg, cfg.num_heads[si], H, 0 if bi % 2 == 0 else cfg.window_size // 2)
        if hasattr(stage, "downsample"):
            x = _patch_merge(x, stage.downsample, H, eps)
            H //= 2
    return _ln(x, model.layernorm, eps)


def convert_swin(sd, cfg: SwinConfig, device, dtype=torch.float32, prefix: str = "") -> SwinModel:
    """HF ``SwinModel`` state dict (tensors; ``prefix`` e.g. 'swin.') ->
    ``SwinModel`` on ``device``: the names are HF's, so each tensor loads
    as it is; HF's buffers (``relative_position_index``) are not read."""
    with torch.device("meta"):
        model = SwinModel(cfg, dtype)
    state = {name: torch.as_tensor(sd[prefix + name]).to(device=device, dtype=dtype) for name in model.state_dict()}
    model = model.to_empty(device=device).requires_grad_(False).eval()
    model.load_state_dict(state, strict=True)
    return model
