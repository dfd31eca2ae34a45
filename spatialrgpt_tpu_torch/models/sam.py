"""Segment-Anything with the HQ head (SAM-HQ), port of
``spatialrgpt_tpu/models/sam.py``: the ViT-det image encoder (windowed
attention + decomposed relative positions), the Fourier prompt encoder
(boxes) and the two-way-transformer mask decoder with SAM-HQ's refinement.

Parameters live in ``SamHQModel`` under exactly the HF ``SamHQModel`` names
that ``convert_sam`` and ``convert_sam_hq`` read (HF's mask-prompt
``prompt_encoder.mask_embed.*`` is not among them: no port function takes a
mask prompt).  The forward functions are plain functions over that module
with the reference's NHWC layouts and dtype flow.

Attention: the global layers (the 64 x 64 = 4096-token grid at vit_h) go
through kernel K5 (``ops/flash_attention.py::grid_bias_attention``) when
S >= ``FLASH_MIN`` (1024, the reference's ``SRGPT_SAM_FLASH_MIN`` default);
the windowed layers, and every layer under ``attn_impl="xla"``, take its
plain version, the dense route XLA runs in the reference.  LayerNorms take K6
under ``SRGPT_FUSED_LN=1`` (``ops/layers.py::layer_norm``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from spatialrgpt_tpu_torch.ops.flash_attention import grid_bias_attention, grid_bias_attention_plain
from spatialrgpt_tpu_torch.ops.layers import conv2d_same, deconv, gelu_erf, layer_norm, linear

# grids of at least this many tokens (SAM's global layers) take K5
FLASH_MIN = 1024
# HF SamMaskDecoderConfig.attention_downsample_rate: the cross attentions
# project to hidden / 2
ATTENTION_DOWNSAMPLE_RATE = 2


@dataclass(frozen=True)
class SamVisionConfig:
    hidden_size: int = 1280  # vit_h
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    intermediate_size: int = 5120
    image_size: int = 1024
    patch_size: int = 16
    output_channels: int = 256
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    layer_norm_eps: float = 1e-6


@dataclass(frozen=True)
class SamConfig:
    vision: SamVisionConfig = SamVisionConfig()
    prompt_hidden_size: int = 256
    image_embedding_size: int = 64
    decoder_hidden_size: int = 256
    decoder_num_heads: int = 8
    decoder_mlp_dim: int = 2048
    decoder_layers: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden: int = 256


# ---------------------------------------------------------------------------
# module tree (parameter storage under the HF names)
# ---------------------------------------------------------------------------


class _FourierTable(nn.Module):
    def __init__(self, feats: int, dtype=None):
        super().__init__()
        self.positional_embedding = nn.Parameter(torch.empty(2, feats, dtype=dtype))


class _PatchEmbed(nn.Module):
    def __init__(self, v: SamVisionConfig, dtype=None):
        super().__init__()
        # parameter storage only: the forward is unfold + matmul (encode_image)
        self.projection = nn.Conv2d(3, v.hidden_size, v.patch_size, stride=v.patch_size, dtype=dtype)


class _VisionAttention(nn.Module):
    def __init__(self, v: SamVisionConfig, size: int, dtype=None):
        super().__init__()
        c, d = v.hidden_size, v.hidden_size // v.num_attention_heads
        self.qkv = nn.Linear(c, 3 * c, dtype=dtype)
        self.proj = nn.Linear(c, c, dtype=dtype)
        self.rel_pos_h = nn.Parameter(torch.empty(2 * size - 1, d, dtype=dtype))
        self.rel_pos_w = nn.Parameter(torch.empty(2 * size - 1, d, dtype=dtype))


class _MLP(nn.Module):
    def __init__(self, c: int, inter: int, dtype=None):
        super().__init__()
        self.lin1 = nn.Linear(c, inter, dtype=dtype)
        self.lin2 = nn.Linear(inter, c, dtype=dtype)


class _VisionLayer(nn.Module):
    def __init__(self, v: SamVisionConfig, window: int, dtype=None):
        super().__init__()
        c = v.hidden_size
        self.layer_norm1 = nn.LayerNorm(c, eps=v.layer_norm_eps, dtype=dtype)
        self.attn = _VisionAttention(v, window if window else v.image_size // v.patch_size, dtype)
        self.layer_norm2 = nn.LayerNorm(c, eps=v.layer_norm_eps, dtype=dtype)
        self.mlp = _MLP(c, v.intermediate_size, dtype)


class _Neck(nn.Module):
    def __init__(self, v: SamVisionConfig, dtype=None):
        super().__init__()
        c, o = v.hidden_size, v.output_channels
        self.conv1 = nn.Conv2d(c, o, 1, bias=False, dtype=dtype)
        self.layer_norm1 = nn.LayerNorm(o, eps=1e-6, dtype=dtype)
        self.conv2 = nn.Conv2d(o, o, 3, padding=1, bias=False, dtype=dtype)
        self.layer_norm2 = nn.LayerNorm(o, eps=1e-6, dtype=dtype)


class SamVisionEncoder(nn.Module):
    def __init__(self, v: SamVisionConfig, dtype=None):
        super().__init__()
        g = v.image_size // v.patch_size
        self.patch_embed = _PatchEmbed(v, dtype)
        self.pos_embed = nn.Parameter(torch.empty(1, g, g, v.hidden_size, dtype=dtype))
        self.layers = nn.ModuleList(
            _VisionLayer(v, 0 if i in v.global_attn_indexes else v.window_size, dtype)
            for i in range(v.num_hidden_layers)
        )
        self.neck = _Neck(v, dtype)


class _PromptEncoder(nn.Module):
    def __init__(self, cfg: SamConfig, dtype=None):
        super().__init__()
        c = cfg.prompt_hidden_size
        self.shared_embedding = _FourierTable(c // 2, dtype)
        self.no_mask_embed = nn.Embedding(1, c, dtype=dtype)
        self.point_embed = nn.ModuleList(nn.Embedding(1, c, dtype=dtype) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, c, dtype=dtype)


class _Attention(nn.Module):
    """SamAttention: q/k/v project to hidden / downsample, out back."""

    def __init__(self, c: int, downsample: int, dtype=None):
        super().__init__()
        inner = c // downsample
        self.q_proj = nn.Linear(c, inner, dtype=dtype)
        self.k_proj = nn.Linear(c, inner, dtype=dtype)
        self.v_proj = nn.Linear(c, inner, dtype=dtype)
        self.out_proj = nn.Linear(inner, c, dtype=dtype)


class _TwoWayBlock(nn.Module):
    def __init__(self, cfg: SamConfig, dtype=None):
        super().__init__()
        c, ds = cfg.decoder_hidden_size, ATTENTION_DOWNSAMPLE_RATE
        self.self_attn = _Attention(c, 1, dtype)
        self.layer_norm1 = nn.LayerNorm(c, dtype=dtype)
        self.cross_attn_token_to_image = _Attention(c, ds, dtype)
        self.layer_norm2 = nn.LayerNorm(c, dtype=dtype)
        self.mlp = _MLP(c, cfg.decoder_mlp_dim, dtype)
        self.layer_norm3 = nn.LayerNorm(c, dtype=dtype)
        self.layer_norm4 = nn.LayerNorm(c, dtype=dtype)
        self.cross_attn_image_to_token = _Attention(c, ds, dtype)


class _TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SamConfig, dtype=None):
        super().__init__()
        c = cfg.decoder_hidden_size
        self.layers = nn.ModuleList(_TwoWayBlock(cfg, dtype) for _ in range(cfg.decoder_layers))
        self.final_attn_token_to_image = _Attention(c, ATTENTION_DOWNSAMPLE_RATE, dtype)
        self.layer_norm_final_attn = nn.LayerNorm(c, dtype=dtype)


class _FFN(nn.Module):
    """SamFeedForward: proj_in, (depth - 2) hidden layers, proj_out."""

    def __init__(self, din: int, hidden: int, dout: int, depth: int, dtype=None):
        super().__init__()
        self.proj_in = nn.Linear(din, hidden, dtype=dtype)
        self.proj_out = nn.Linear(hidden, dout, dtype=dtype)
        self.layers = nn.ModuleList(nn.Linear(hidden, hidden, dtype=dtype) for _ in range(depth - 2))


class SamHQMaskDecoder(nn.Module):
    def __init__(self, cfg: SamConfig, dtype=None):
        super().__init__()
        c, vit = cfg.decoder_hidden_size, cfg.vision.hidden_size
        m = cfg.num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, c, dtype=dtype)
        self.mask_tokens = nn.Embedding(m, c, dtype=dtype)
        self.transformer = _TwoWayTransformer(cfg, dtype)
        # parameter storage only (weight (C_in, C_out, 2, 2)); see ops/layers.py::deconv
        self.upscale_conv1 = nn.ConvTranspose2d(c, c // 4, 2, stride=2, dtype=dtype)
        self.upscale_conv2 = nn.ConvTranspose2d(c // 4, c // 8, 2, stride=2, dtype=dtype)
        self.upscale_layer_norm = nn.LayerNorm(c // 4, eps=1e-6, dtype=dtype)
        self.output_hypernetworks_mlps = nn.ModuleList(_FFN(c, c, c // 8, 3, dtype) for _ in range(m))
        self.iou_prediction_head = _FFN(c, cfg.iou_head_hidden, m, cfg.iou_head_depth, dtype)
        # the HQ head
        self.hq_token = nn.Embedding(1, c, dtype=dtype)
        self.hq_mask_mlp = _FFN(c, c, c // 8, 3, dtype)
        self.compress_vit_conv1 = nn.ConvTranspose2d(vit, c, 2, stride=2, dtype=dtype)
        self.compress_vit_norm = nn.LayerNorm(c, eps=1e-6, dtype=dtype)
        self.compress_vit_conv2 = nn.ConvTranspose2d(c, c // 8, 2, stride=2, dtype=dtype)
        self.encoder_conv1 = nn.ConvTranspose2d(c, c // 4, 2, stride=2, dtype=dtype)
        self.encoder_norm = nn.LayerNorm(c // 4, eps=1e-6, dtype=dtype)
        self.encoder_conv2 = nn.ConvTranspose2d(c // 4, c // 8, 2, stride=2, dtype=dtype)
        self.mask_conv1 = nn.Conv2d(c // 8, c // 4, 3, padding=1, dtype=dtype)
        self.mask_norm = nn.LayerNorm(c // 4, eps=1e-6, dtype=dtype)
        self.mask_conv2 = nn.Conv2d(c // 4, c // 8, 3, padding=1, dtype=dtype)


class SamHQModel(nn.Module):
    def __init__(self, cfg: SamConfig, dtype=None):
        super().__init__()
        self.shared_image_embedding = _FourierTable(cfg.decoder_hidden_size // 2, dtype)
        self.vision_encoder = SamVisionEncoder(cfg.vision, dtype)
        self.prompt_encoder = _PromptEncoder(cfg, dtype)
        self.mask_decoder = SamHQMaskDecoder(cfg, dtype)


# ---------------------------------------------------------------------------
# vision encoder
# ---------------------------------------------------------------------------


def _get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Relative position table lookup (modeling_sam.get_rel_pos); the table
    is pre-sized to 2 * size - 1 (always true at a fixed resolution)."""
    q = torch.arange(q_size, dtype=torch.float64)[:, None] * max(k_size / q_size, 1.0)
    k = torch.arange(k_size, dtype=torch.float64)[None, :] * max(q_size / k_size, 1.0)
    rel = (q - k) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.to(torch.int64).to(rel_pos.device)]


def _vision_attention(x: torch.Tensor, attn: _VisionAttention, cfg: SamVisionConfig, attn_impl: str = "onepass") -> torch.Tensor:
    """x: (B, H, W, C), a window or the global grid.  Scores
    q.k * d^-0.5 + rel_h[q, k // W] + rel_w[q, k % W], where the bias is
    built from the unscaled q (HF's order).  A grid of at least
    ``FLASH_MIN`` tokens (the global layers) takes K5; a window, or any grid
    under ``attn_impl="xla"``, takes K5's plain version (the reference's
    XLA route)."""
    if attn_impl not in ("onepass", "xla"):
        raise ValueError(f"unknown attention impl: {attn_impl}")
    B, H, W, C = x.shape
    nh = cfg.num_attention_heads
    d = C // nh
    qkv = linear(x.reshape(B, H * W, C), attn.qkv.weight, attn.qkv.bias).view(B, H * W, 3, nh, d)
    q, k, v = qkv.unbind(2)  # (B, HW, nh, d) views: the kernel reads through strides

    rh = _get_rel_pos(H, H, attn.rel_pos_h.float())  # (H, H, d)
    rw = _get_rel_pos(W, W, attn.rel_pos_w.float())
    qg = q.reshape(B, H, W, nh, d).float()
    S = H * W
    rel_h = torch.einsum("bhwnc,hkc->bnhwk", qg, rh).reshape(B, nh, S, H).contiguous()
    rel_w = torch.einsum("bhwnc,wkc->bnhwk", qg, rw).reshape(B, nh, S, W).contiguous()
    if S >= FLASH_MIN and attn_impl == "onepass":
        out = grid_bias_attention(q, k, v, rel_h, rel_w, W)
    else:
        out = grid_bias_attention_plain(q, k, v, rel_h, rel_w, W)
    return linear(out.reshape(B, S, C), attn.proj.weight, attn.proj.bias).reshape(B, H, W, C)


def _window_partition(x: torch.Tensor, w: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Zero-pad the grid to a multiple of w (the padded tokens then take part
    in the windowed attention unmasked, as in the reference) and cut it into
    (B * nW, w, w, C) windows."""
    B, H, W, C = x.shape
    pad_h, pad_w = (w - H % w) % w, (w - W % w) % w
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // w, w, Wp // w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, w, w, C)
    return x, (Hp, Wp)


def _window_unpartition(wins: torch.Tensor, w: int, pad_hw, hw) -> torch.Tensor:
    Hp, Wp = pad_hw
    H, W = hw
    B = wins.shape[0] // (Hp * Wp // w // w)
    x = wins.reshape(B, Hp // w, Wp // w, w, w, -1).permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


def _vision_layer(x: torch.Tensor, layer: _VisionLayer, cfg: SamVisionConfig, window_size: int, attn_impl: str) -> torch.Tensor:
    eps = cfg.layer_norm_eps
    h = layer_norm(x, layer.layer_norm1.weight, layer.layer_norm1.bias, eps)
    if window_size > 0:
        H, W = h.shape[1], h.shape[2]
        h, pad_hw = _window_partition(h, window_size)
        h = _vision_attention(h, layer.attn, cfg, attn_impl)
        h = _window_unpartition(h, window_size, pad_hw, (H, W))
    else:
        h = _vision_attention(h, layer.attn, cfg, attn_impl)
    x = x + h
    h = layer_norm(x, layer.layer_norm2.weight, layer.layer_norm2.bias, eps)
    h = gelu_erf(linear(h, layer.mlp.lin1.weight, layer.mlp.lin1.bias))
    return x + linear(h, layer.mlp.lin2.weight, layer.mlp.lin2.bias)


def encode_image(
    enc: SamVisionEncoder, pixel_values: torch.Tensor, cfg: SamVisionConfig, return_interm: bool = False,
    attn_impl: str = "onepass",
):
    """(B, H, W, 3) normalized pixels -> (B, g, g, output_channels) image
    embedding; with ``return_interm`` also the hidden states after the first
    global-attention layer (SAM-HQ's ``vit_features``)."""
    w = enc.patch_embed.projection.weight  # (C, 3, P, P)
    C, P = w.shape[0], cfg.patch_size
    B, H, W, _ = pixel_values.shape
    gh, gw = H // P, W // P
    # the stride equals the kernel: the patch conv is a matmul of the patches
    x = pixel_values[:, : gh * P, : gw * P].to(w.dtype).reshape(B, gh, P, gw, P, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, gh, gw, P * P * 3)
    x = torch.matmul(x, w.permute(2, 3, 1, 0).reshape(P * P * 3, C)) + enc.patch_embed.projection.bias
    x = x + enc.pos_embed.to(x.dtype)
    interm = None
    for li, layer in enumerate(enc.layers):
        win = 0 if li in cfg.global_attn_indexes else cfg.window_size
        x = _vision_layer(x, layer, cfg, win, attn_impl)
        if interm is None and win == 0:
            interm = x
    # neck: 1x1 conv -> LN -> 3x3 conv -> LN (no bias convs)
    neck = enc.neck
    x = torch.matmul(x, neck.conv1.weight[:, :, 0, 0].t().to(x.dtype))
    x = layer_norm(x, neck.layer_norm1.weight, neck.layer_norm1.bias, 1e-6)
    x = conv2d_same(x, neck.conv2.weight)
    x = layer_norm(x, neck.layer_norm2.weight, neck.layer_norm2.bias, 1e-6)
    return (x, interm) if return_interm else x


# ---------------------------------------------------------------------------
# prompt encoder
# ---------------------------------------------------------------------------


def _fourier_embed(coords: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """coords in [0, 1] -> sin/cos Fourier features (SamPositionalEmbedding)."""
    c = (2.0 * coords - 1.0) @ table.to(coords.dtype)
    c = 2.0 * math.pi * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def image_positional_embedding(model: SamHQModel, cfg: SamConfig) -> torch.Tensor:
    """(1, g, g, C) dense positional encoding of the embedding grid."""
    size = cfg.image_embedding_size
    dev = model.shared_image_embedding.positional_embedding.device
    grid = torch.ones((size, size), dtype=torch.float32, device=dev)
    y = (torch.cumsum(grid, dim=0) - 0.5) / size
    x = (torch.cumsum(grid, dim=1) - 0.5) / size
    return _fourier_embed(torch.stack([x, y], dim=-1), model.shared_image_embedding.positional_embedding)[None]


def embed_boxes(model: SamHQModel, boxes: torch.Tensor, cfg: SamConfig) -> torch.Tensor:
    """boxes (B, N, 4) xyxy in input-image pixels -> (B, N, 2, C)."""
    pe = model.prompt_encoder
    corners = (boxes + 0.5).reshape(*boxes.shape[:-1], 2, 2) / float(cfg.vision.image_size)
    emb = _fourier_embed(corners, pe.shared_embedding.positional_embedding)
    corner_emb = torch.stack([pe.point_embed[2].weight[0], pe.point_embed[3].weight[0]]).to(emb.dtype)
    return emb + corner_emb


def no_mask_dense_embedding(model: SamHQModel, cfg: SamConfig, batch: int) -> torch.Tensor:
    g = cfg.image_embedding_size
    e = model.prompt_encoder.no_mask_embed.weight[0]
    return e[None, None, None, :].expand(batch, g, g, e.shape[0])


# ---------------------------------------------------------------------------
# mask decoder (two-way transformer)
# ---------------------------------------------------------------------------


def _lin(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    return linear(x, layer.weight, layer.bias)


def _ln(x: torch.Tensor, norm: nn.LayerNorm, eps: float = 1e-6) -> torch.Tensor:
    return layer_norm(x, norm.weight, norm.bias, eps)


def _attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p: _Attention, num_heads: int) -> torch.Tensor:
    """SamAttention over (B, N, C) inputs: f32 scores, probabilities cast to
    the value dtype, as the reference."""
    qq, kk, vv = _lin(q, p.q_proj), _lin(k, p.k_proj), _lin(v, p.v_proj)
    B, Nq, Ci = qq.shape
    d = Ci // num_heads
    qq = qq.reshape(B, Nq, num_heads, d)
    kk = kk.reshape(B, kk.shape[1], num_heads, d)
    vv = vv.reshape(B, vv.shape[1], num_heads, d)
    s = torch.einsum("bqhd,bkhd->bhqk", qq.float(), kk.float()) * d**-0.5
    pr = torch.softmax(s, dim=-1).to(vv.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", pr, vv).reshape(B, Nq, Ci)
    return _lin(o, p.out_proj)


def _two_way_block(queries, keys, qpe, kpe, p: _TwoWayBlock, cfg: SamConfig, skip_first_pe: bool):
    nh = cfg.decoder_num_heads
    if skip_first_pe:
        # the first layer REPLACES the queries with the self-attention output
        queries = _attn(queries, queries, queries, p.self_attn, nh)
    else:
        q = queries + qpe
        queries = queries + _attn(q, q, queries, p.self_attn, nh)
    queries = _ln(queries, p.layer_norm1)
    q, k = queries + qpe, keys + kpe
    queries = queries + _attn(q, k, keys, p.cross_attn_token_to_image, nh)
    queries = _ln(queries, p.layer_norm2)
    h = torch.relu(_lin(queries, p.mlp.lin1))
    queries = queries + _lin(h, p.mlp.lin2)
    queries = _ln(queries, p.layer_norm3)
    q, k = queries + qpe, keys + kpe
    keys = keys + _attn(k, q, queries, p.cross_attn_image_to_token, nh)
    keys = _ln(keys, p.layer_norm4)
    return queries, keys


def _ffn(x: torch.Tensor, p: _FFN) -> torch.Tensor:
    h = torch.relu(_lin(x, p.proj_in))
    for layer in p.layers:
        h = torch.relu(_lin(h, layer))
    return _lin(h, p.proj_out)


def _deconv(x: torch.Tensor, conv: nn.ConvTranspose2d) -> torch.Tensor:
    return deconv(x, conv.weight, conv.bias)


def _conv3(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """3x3 SAME conv + bias, NHWC."""
    return conv2d_same(x, conv.weight, conv.bias)


def _run_transformer(model: SamHQModel, cfg: SamConfig, image_embeddings, dense_prompts, out_tokens, sparse_prompts):
    """Tokens (output tokens + prompts) and image keys through the two-way
    transformer and the final token-to-image attention; returns
    (queries, keys (B, g*g, C))."""
    B, g, _, C = image_embeddings.shape
    tr = model.mask_decoder.transformer
    tokens = torch.cat([out_tokens[None].expand(B, -1, -1), sparse_prompts], dim=1)
    img = image_embeddings if dense_prompts is None else image_embeddings + dense_prompts
    keys = img.reshape(B, g * g, C)
    kpe = image_positional_embedding(model, cfg).reshape(1, g * g, C).expand(B, -1, -1).to(keys.dtype)
    queries = tokens
    for i, block in enumerate(tr.layers):
        queries, keys = _two_way_block(queries, keys, tokens, kpe, block, cfg, skip_first_pe=(i == 0))
    q, k = queries + tokens, keys + kpe
    queries = queries + _attn(q, k, keys, tr.final_attn_token_to_image, cfg.decoder_num_heads)
    # HF's layer_norm_final_attn is a default nn.LayerNorm: eps 1e-5
    return _ln(queries, tr.layer_norm_final_attn, 1e-5), keys


def _upscaled(model: SamHQModel, keys: torch.Tensor, g: int) -> torch.Tensor:
    """Image keys 4x upscaled: two stride-2 deconvs with LN + GELU between."""
    dp = model.mask_decoder
    up = _deconv(keys.reshape(keys.shape[0], g, g, -1), dp.upscale_conv1)
    up = gelu_erf(_ln(up, dp.upscale_layer_norm))
    return gelu_erf(_deconv(up, dp.upscale_conv2))  # (B, 4g, 4g, C/8)


def _mask_logits(hyper: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """(B, M, C/8) hypernetwork outputs x (B, 4g, 4g, C/8) -> f32 (B, M, 4g, 4g)."""
    return torch.einsum("bmc,bhwc->bmhw", hyper.float(), up.float())


def decode_masks(
    model: SamHQModel,
    cfg: SamConfig,
    image_embeddings: torch.Tensor,  # (B, g, g, C)
    sparse_prompts: torch.Tensor,  # (B, N, C)
    dense_prompts: Optional[torch.Tensor] = None,  # (B, g, g, C)
    multimask: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SAM mask decode: (masks (B, M, 4g, 4g), iou_pred (B, M))."""
    dp = model.mask_decoder
    g = image_embeddings.shape[1]
    n_mask = cfg.num_multimask_outputs + 1
    out_tokens = torch.cat([dp.iou_token.weight, dp.mask_tokens.weight], dim=0)
    queries, keys = _run_transformer(model, cfg, image_embeddings, dense_prompts, out_tokens, sparse_prompts)
    up = _upscaled(model, keys, g)
    hyper = torch.stack([_ffn(queries[:, 1 + i], dp.output_hypernetworks_mlps[i]) for i in range(n_mask)], dim=1)
    masks = _mask_logits(hyper, up)
    iou_pred = _ffn(queries[:, 0], dp.iou_prediction_head)
    if multimask:
        return masks[:, 1:], iou_pred[:, 1:]
    return masks[:, :1], iou_pred[:, :1]


def decode_masks_hq(
    model: SamHQModel,
    cfg: SamConfig,
    image_embeddings: torch.Tensor,  # (B, g, g, C)
    sparse_prompts: torch.Tensor,  # (B, N, C)
    dense_prompts: Optional[torch.Tensor],
    vit_features: torch.Tensor,  # (B, g, g, vit_dim) output of the first global layer
    multimask: bool = True,
    hq_token_only: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SAM-HQ mask decode (modeling_sam_hq SamHQMaskDecoder.forward): an
    extra HQ output token whose hypernetwork reads a high-frequency feature
    map (the 4x-upscaled image embedding + compressed early ViT features).
    Multimask output is sorted by predicted IoU, descending; the HQ mask is
    added to the SAM masks unless ``hq_token_only``."""
    dp = model.mask_decoder
    g = image_embeddings.shape[1]
    n_sam = cfg.num_multimask_outputs + 1

    enc = _deconv(image_embeddings, dp.encoder_conv1)
    enc = _deconv(gelu_erf(_ln(enc, dp.encoder_norm)), dp.encoder_conv2)  # (B, 4g, 4g, C/8)
    cv = _deconv(vit_features, dp.compress_vit_conv1)
    cv = _deconv(gelu_erf(_ln(cv, dp.compress_vit_norm)), dp.compress_vit_conv2)
    hq_features = enc + cv

    out_tokens = torch.cat([dp.iou_token.weight, dp.mask_tokens.weight, dp.hq_token.weight], dim=0)
    queries, keys = _run_transformer(model, cfg, image_embeddings, dense_prompts, out_tokens, sparse_prompts)
    up = _upscaled(model, keys, g)
    up_hq = gelu_erf(_ln(_conv3(up, dp.mask_conv1), dp.mask_norm))
    up_hq = _conv3(up_hq, dp.mask_conv2) + hq_features

    hyper_sam = torch.stack([_ffn(queries[:, 1 + i], dp.output_hypernetworks_mlps[i]) for i in range(n_sam)], dim=1)
    hyper_hq = _ffn(queries[:, 1 + n_sam], dp.hq_mask_mlp)[:, None]
    masks_sam = _mask_logits(hyper_sam, up)
    masks_hq = _mask_logits(hyper_hq, up_hq)
    iou_pred = _ffn(queries[:, 0], dp.iou_prediction_head)

    if multimask:
        iou_sel = iou_pred[:, 1:n_sam]
        order = torch.argsort(-iou_sel, dim=1, stable=True)
        iou_sel = torch.take_along_dim(iou_sel, order, dim=1)
        m = torch.take_along_dim(masks_sam[:, 1:n_sam], order[..., None, None], dim=1)
    else:
        iou_sel, m = iou_pred[:, :1], masks_sam[:, :1]
    return (masks_hq if hq_token_only else m + masks_hq), iou_sel


def _box_prompts(model: SamHQModel, cfg: SamConfig, emb: torch.Tensor, boxes: torch.Tensor):
    """One prompt batch entry per box: (sparse (B*N, 2, C), dense (B*N, g, g, C))."""
    B, N = boxes.shape[0], boxes.shape[1]
    sparse = embed_boxes(model, boxes, cfg).reshape(B * N, 2, -1)
    dense = no_mask_dense_embedding(model, cfg, B * N).to(emb.dtype)
    return sparse, dense


@torch.no_grad()
def predict_boxes(
    model: SamHQModel, cfg: SamConfig, pixel_values: torch.Tensor, boxes: torch.Tensor, attn_impl: str = "onepass"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Image + (B, N, 4) boxes -> the best mask per box: ((B*N, 4g, 4g)
    logits, (B*N,) iou)."""
    emb = encode_image(model.vision_encoder, pixel_values, cfg.vision, attn_impl=attn_impl)
    sparse, dense = _box_prompts(model, cfg, emb, boxes)
    masks, iou = decode_masks(model, cfg, emb.repeat_interleave(boxes.shape[1], dim=0), sparse, dense, multimask=False)
    return masks[:, 0], iou[:, 0]


@torch.no_grad()
def predict_boxes_hq(
    model: SamHQModel, cfg: SamConfig, pixel_values: torch.Tensor, boxes: torch.Tensor,
    hq_token_only: bool = False, attn_impl: str = "onepass",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SAM-HQ box-prompted prediction: image + (B, N, 4) boxes -> one
    HQ-refined mask per box ((B*N, 4g, 4g) logits, (B*N,) iou)."""
    emb, interm = encode_image(model.vision_encoder, pixel_values, cfg.vision, return_interm=True, attn_impl=attn_impl)
    n = boxes.shape[1]
    sparse, dense = _box_prompts(model, cfg, emb, boxes)
    masks, iou = decode_masks_hq(
        model, cfg, emb.repeat_interleave(n, dim=0), sparse, dense, interm.repeat_interleave(n, dim=0),
        multimask=False, hq_token_only=hq_token_only,
    )
    return masks[:, 0], iou[:, 0]
