"""Depth-Anything (DINOv2 backbone + DPT head), port of
``spatialrgpt_tpu/models/depth_anything.py``.

Parameters live in ``DepthAnythingModel`` under the HF
``DepthAnythingForDepthEstimation`` names that ``convert_depth_anything``
reads.  The forward functions are plain functions over that module in the
reference's NHWC layout; the backbone's attention is plain torch, as the
reference's is XLA, and its LayerNorms take K6 under ``SRGPT_FUSED_LN=1``.

Resizes follow ``jax.image.resize``, not ``F.interpolate``: JAX's cubic is
Keys a = -0.5 with its weights renormalized over the in-bounds taps (torch's
bicubic is a = -0.75 with clamped borders), and its downsampling
antialiases by default.  ``resize_weights`` builds the weight matrices the
way ``jax.image.scale_and_translate`` does and applies them as matmuls, as
``resize_align_corners`` does for DPT's align-corners bilinear.

``DepthPredictor`` is the reference's eval-time depth path on the device.
The reference resizes its input with OpenCV's INTER_CUBIC where cv2 is
importable and with Pillow's float bicubic where it is not; the port
always takes the cv2 branch, the reference's own flow (eval_spatial.py's
transform, which tests/test_depth_anything.py replays), as the weight
matrices of ``cv2_cubic_weights`` on the device, so it needs no cv2.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from spatialrgpt_tpu_torch.ops.layers import conv2d_same, deconv, gelu_erf, layer_norm, linear


@dataclass(frozen=True)
class DepthAnythingConfig:
    hidden_size: int = 1024  # ViT-L
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 14
    image_size: int = 518  # nominal square input (the pos-embed grid)
    layer_norm_eps: float = 1e-6
    out_indices: Tuple[int, ...] = (5, 12, 18, 24)  # 1-based layer outputs
    neck_hidden_sizes: Tuple[int, ...] = (256, 512, 1024, 1024)
    reassemble_factors: Tuple[float, ...] = (4, 2, 1, 0.5)
    fusion_hidden_size: int = 256
    head_hidden_size: int = 32
    max_depth: float = 1.0  # relative depth
    metric: bool = False  # sigmoid * max_depth head instead of relu


# ---------------------------------------------------------------------------
# module tree (parameter storage under the HF names)
# ---------------------------------------------------------------------------


class _Holder(nn.Module):
    """A named level of the HF tree that only groups its children."""

    def __init__(self, **children):
        super().__init__()
        for name, child in children.items():
            setattr(self, name, child)


class LayerScale(nn.Module):
    def __init__(self, c: int, dtype=None):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.empty(c, dtype=dtype))


class _DinoLayer(nn.Module):
    def __init__(self, cfg: DepthAnythingConfig, dtype=None):
        super().__init__()
        c, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.norm1 = nn.LayerNorm(c, eps=eps, dtype=dtype)
        self.attention = _Holder(
            attention=_Holder(**{n: nn.Linear(c, c, dtype=dtype) for n in ("query", "key", "value")}),
            output=_Holder(dense=nn.Linear(c, c, dtype=dtype)),
        )
        self.layer_scale1 = LayerScale(c, dtype)
        self.norm2 = nn.LayerNorm(c, eps=eps, dtype=dtype)
        self.mlp = _Holder(fc1=nn.Linear(c, cfg.intermediate_size, dtype=dtype),
                           fc2=nn.Linear(cfg.intermediate_size, c, dtype=dtype))
        self.layer_scale2 = LayerScale(c, dtype)


class _Backbone(nn.Module):
    def __init__(self, cfg: DepthAnythingConfig, dtype=None):
        super().__init__()
        c, p = cfg.hidden_size, cfg.patch_size
        t0 = (cfg.image_size // p) ** 2
        self.embeddings = _Holder(
            patch_embeddings=_Holder(projection=nn.Conv2d(3, c, p, stride=p, dtype=dtype)),
        )
        self.embeddings.cls_token = nn.Parameter(torch.empty(1, 1, c, dtype=dtype))
        self.embeddings.position_embeddings = nn.Parameter(torch.empty(1, 1 + t0, c, dtype=dtype))
        self.encoder = _Holder(layer=nn.ModuleList(_DinoLayer(cfg, dtype) for _ in range(cfg.num_hidden_layers)))
        self.layernorm = nn.LayerNorm(c, eps=cfg.layer_norm_eps, dtype=dtype)


def _conv(cin: int, cout: int, k: int, bias: bool = True, stride: int = 1, dtype=None) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, bias=bias, dtype=dtype)


class _Neck(nn.Module):
    def __init__(self, cfg: DepthAnythingConfig, dtype=None):
        super().__init__()
        c, f = cfg.hidden_size, cfg.fusion_hidden_size
        stages = []
        for nh, factor in zip(cfg.neck_hidden_sizes, cfg.reassemble_factors):
            stage = _Holder(projection=_conv(c, nh, 1, dtype=dtype))
            if factor > 1:
                stage.resize = nn.ConvTranspose2d(nh, nh, int(factor), stride=int(factor), dtype=dtype)
            elif factor < 1:
                stage.resize = _conv(nh, nh, 3, stride=int(1 / factor), dtype=dtype)
            stages.append(stage)
        self.reassemble_stage = _Holder(layers=nn.ModuleList(stages))
        self.convs = nn.ModuleList(_conv(nh, f, 3, bias=False, dtype=dtype) for nh in cfg.neck_hidden_sizes)

        def residual():
            return _Holder(convolution1=_conv(f, f, 3, dtype=dtype), convolution2=_conv(f, f, 3, dtype=dtype))

        self.fusion_stage = _Holder(layers=nn.ModuleList(
            _Holder(projection=_conv(f, f, 1, dtype=dtype), residual_layer1=residual(), residual_layer2=residual())
            for _ in cfg.neck_hidden_sizes
        ))


class DepthAnythingModel(nn.Module):
    def __init__(self, cfg: DepthAnythingConfig, dtype=None):
        super().__init__()
        f = cfg.fusion_hidden_size
        self.backbone = _Backbone(cfg, dtype)
        self.neck = _Neck(cfg, dtype)
        self.head = _Holder(
            conv1=_conv(f, f // 2, 3, dtype=dtype),
            conv2=_conv(f // 2, cfg.head_hidden_size, 3, dtype=dtype),
            conv3=_conv(cfg.head_hidden_size, 1, 1, dtype=dtype),
        )


# ---------------------------------------------------------------------------
# resizes as interpolation matrices
# ---------------------------------------------------------------------------


def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear weights with align_corners=True sampling."""
    m = np.zeros((n_out, n_in), np.float32)
    if n_out == 1 or n_in == 1:
        m[:, 0] = 1.0
        return m
    coords = np.linspace(0, n_in - 1, n_out)
    lo = np.floor(coords).astype(int)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = coords - lo
    for i in range(n_out):
        m[i, lo[i]] += 1 - frac[i]
        m[i, hi[i]] += frac[i]
    return m


def _apply_hw(x: torch.Tensor, mh: np.ndarray, mw: np.ndarray) -> torch.Tensor:
    """Contract the (out, in) matrices with axes 1 and 2 of x (B, H, W, ...),
    each product rounded to x's dtype (the reference's two einsums)."""
    if mh is not None:
        x = torch.einsum("oh,bh...->bo...", torch.from_numpy(mh).to(x.device, x.dtype), x)
    if mw is not None:
        x = torch.einsum("pw,bow...->bop...", torch.from_numpy(mw).to(x.device, x.dtype), x)
    return x


def resize_align_corners(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize with align_corners=True (DPT's upsampling)."""
    return _apply_hw(x, _interp_matrix(x.shape[1], out_hw[0]), _interp_matrix(x.shape[2], out_hw[1]))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


_KERNELS = {"bicubic": _keys_cubic, "bilinear": lambda x: np.maximum(0.0, 1.0 - np.abs(x))}


@functools.lru_cache(maxsize=64)
def resize_weights(n_in: int, n_out: int, method: str, antialias: bool) -> np.ndarray:
    """(n_out, n_in) f32 weights of ``jax.image.resize`` along one axis
    (``jax._src.image.scale.compute_weight_mat`` at translation 0, in f32):
    the kernel widens by in/out when downsampling with antialias, the taps
    are renormalized to sum to 1, and a sample outside the input gets 0."""
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))
    kscale = max(inv, f32(1.0)) if antialias else f32(1.0)
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kscale
    w = _KERNELS[method](x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps), w / np.where(total != 0, total, 1), 0)
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0)
    return np.ascontiguousarray(w.T, dtype=f32)


@functools.lru_cache(maxsize=64)
def cv2_cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) f32 weights of OpenCV's INTER_CUBIC resize along one
    axis: Keys a = -0.75 on the 4 taps around the half-pixel source position
    (coefficients in f32, as cv2 computes them), the border replicated, no
    antialiasing when downsampling."""
    a = np.float32(-0.75)
    fx = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    sx = np.floor(fx).astype(np.int64)
    t = (fx - sx).astype(np.float32)
    c0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    c1 = ((a + 2) * t - (a + 3)) * t * t + 1
    c2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
    c3 = 1 - c0 - c1 - c2
    m = np.zeros((n_out, n_in), np.float32)
    for k, c in enumerate((c0, c1, c2, c3)):
        np.add.at(m, (np.arange(n_out), np.clip(sx - 1 + k, 0, n_in - 1)), c)
    return m


def image_resize(x: torch.Tensor, out_hw: Tuple[int, int], method: str, antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize`` over axes 1 and 2 of x (B, H, W, ...); an axis
    whose size does not change is left as it is, as JAX skips it."""
    (h, w), (oh, ow) = x.shape[1:3], out_hw
    return _apply_hw(
        x,
        resize_weights(h, oh, method, antialias) if h != oh else None,
        resize_weights(w, ow, method, antialias) if w != ow else None,
    )


# ---------------------------------------------------------------------------
# DINOv2 backbone
# ---------------------------------------------------------------------------


def _lin(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    return linear(x, layer.weight, layer.bias)


def _attention(x: torch.Tensor, attn, num_heads: int) -> torch.Tensor:
    B, S, C = x.shape
    D = C // num_heads
    q = _lin(x, attn.attention.query).reshape(B, S, num_heads, D)
    k = _lin(x, attn.attention.key).reshape(B, S, num_heads, D)
    v = _lin(x, attn.attention.value).reshape(B, S, num_heads, D)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(scores * D**-0.5, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return _lin(out.reshape(B, S, C), attn.output.dense)


def _dino_layer(x: torch.Tensor, layer: _DinoLayer, cfg: DepthAnythingConfig) -> torch.Tensor:
    eps = cfg.layer_norm_eps
    h = layer_norm(x, layer.norm1.weight, layer.norm1.bias, eps)
    x = x + _attention(h, layer.attention, cfg.num_attention_heads) * layer.layer_scale1.lambda1.to(x.dtype)
    h = layer_norm(x, layer.norm2.weight, layer.norm2.bias, eps)
    h = _lin(gelu_erf(_lin(h, layer.mlp.fc1)), layer.mlp.fc2)
    return x + h * layer.layer_scale2.lambda1.to(x.dtype)


def _interpolate_pos(pos_embed: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """(1 + T0, C) learned positions, bicubically resized (``jax.image.resize``)
    to the actual grid when the resolution differs (DINOv2
    interpolate_pos_encoding).  Returns (1, 1 + ph * pw, C)."""
    n = pos_embed.shape[0] - 1
    side = int(round(n**0.5))
    if side * side == n and (ph, pw) == (side, side):
        return pos_embed[None]
    grid = image_resize(pos_embed[1:].reshape(1, side, side, -1), (ph, pw), "bicubic")
    return torch.cat([pos_embed[None, :1], grid.reshape(1, ph * pw, -1)], dim=1)


def backbone_features(model: DepthAnythingModel, pixel_values: torch.Tensor, cfg: DepthAnythingConfig):
    """([selected hidden states (B, 1 + T, C)], ph, pw); each selected state
    passes the backbone's shared final LayerNorm."""
    emb = model.backbone.embeddings
    w = emb.patch_embeddings.projection.weight  # (C, 3, P, P)
    C, P = w.shape[0], cfg.patch_size
    B, H, W, _ = pixel_values.shape
    ph, pw = H // P, W // P
    # the stride equals the kernel ("VALID"): the patch conv is a matmul
    x = pixel_values[:, : ph * P, : pw * P].to(w.dtype).reshape(B, ph, P, pw, P, 3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, ph * pw, P * P * 3)
    x = torch.matmul(x, w.permute(2, 3, 1, 0).reshape(P * P * 3, C)) + emb.patch_embeddings.projection.bias
    x = torch.cat([emb.cls_token.to(x.dtype).expand(B, 1, C), x], dim=1)
    x = x + _interpolate_pos(emb.position_embeddings[0], ph, pw).to(x.dtype)
    want = set(cfg.out_indices)
    final = model.backbone.layernorm
    feats = []
    for li, layer in enumerate(model.backbone.encoder.layer):
        x = _dino_layer(x, layer, cfg)
        if li + 1 in want:
            feats.append(layer_norm(x, final.weight, final.bias, cfg.layer_norm_eps))
    return feats, ph, pw


# ---------------------------------------------------------------------------
# DPT neck + head
# ---------------------------------------------------------------------------


def _c(x: torch.Tensor, conv: nn.Conv2d, stride: int = 1) -> torch.Tensor:
    return conv2d_same(x, conv.weight, conv.bias, stride)


def _residual_unit(x: torch.Tensor, p) -> torch.Tensor:
    h = _c(torch.relu(x), p.convolution1)
    return x + _c(torch.relu(h), p.convolution2)


def _fusion_layer(x: torch.Tensor, p, residual, out_size) -> torch.Tensor:
    if residual is not None:
        if residual.shape[1:3] != x.shape[1:3]:
            residual = image_resize(residual, tuple(x.shape[1:3]), "bilinear", antialias=False)
        x = x + _residual_unit(residual, p.residual_layer1)
    x = _residual_unit(x, p.residual_layer2)
    return _c(resize_align_corners(x, out_size), p.projection)


def head_logits(model: DepthAnythingModel, pixel_values: torch.Tensor, cfg: DepthAnythingConfig) -> torch.Tensor:
    """(B, H, W, 3) normalized pixels -> (B, H', W') output of the head's last
    conv, before its relu (or sigmoid)."""
    feats, ph, pw = backbone_features(model, pixel_values, cfg)
    neck = model.neck
    maps = []
    for i, f in enumerate(feats):
        stage = neck.reassemble_stage.layers[i]
        grid = _c(f[:, 1:].reshape(f.shape[0], ph, pw, -1), stage.projection)
        factor = cfg.reassemble_factors[i]
        if factor > 1:
            grid = deconv(grid, stage.resize.weight, stage.resize.bias)
        elif factor < 1:
            grid = _c(grid, stage.resize, stride=int(1 / factor))
        maps.append(_c(grid, neck.convs[i]))
    rev = maps[::-1]  # top-down fusion, deepest first
    fused = None
    for idx, (f, p) in enumerate(zip(rev, neck.fusion_stage.layers)):
        out_size = tuple(rev[idx + 1].shape[1:3]) if idx != len(rev) - 1 else (f.shape[1] * 2, f.shape[2] * 2)
        fused = _fusion_layer(f if fused is None else fused, p, None if fused is None else f, out_size)
    head = model.head
    x = resize_align_corners(_c(fused, head.conv1), (ph * cfg.patch_size, pw * cfg.patch_size))
    x = _c(torch.relu(_c(x, head.conv2)), head.conv3)
    return x[..., 0]


def forward_depth(model: DepthAnythingModel, pixel_values: torch.Tensor, cfg: DepthAnythingConfig) -> torch.Tensor:
    """(B, H, W, 3) normalized pixels -> (B, H', W') relative depth."""
    x = head_logits(model, pixel_values, cfg)
    return torch.sigmoid(x) * cfg.max_depth if cfg.metric else torch.relu(x) * cfg.max_depth


def colorize_depth(depth: torch.Tensor) -> torch.Tensor:
    """Min-max normalize (per map over the last two axes) to uint8 x 3."""
    d = depth.float()
    lo = d.amin(dim=(-1, -2), keepdim=True)
    hi = d.amax(dim=(-1, -2), keepdim=True)
    u8 = ((d - lo) / torch.clamp(hi - lo, min=1e-8) * 255.0).to(torch.uint8)
    return torch.stack([u8, u8, u8], dim=-1)


# ---------------------------------------------------------------------------
# eval-time depth predictor, on the device
# ---------------------------------------------------------------------------

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _constrain_to_multiple_of(x: float, multiple: int, min_val: int) -> int:
    y = int(round(x / multiple) * multiple)
    if y < min_val:
        y = int(np.ceil(x / multiple) * multiple)
    return y


def resize_lower_bound_hw(h: int, w: int, target: int = 518, multiple: int = 14) -> Tuple[int, int]:
    """Keep-aspect 'lower_bound' size: the short side reaches >= target,
    each side snapped to a multiple of the patch size."""
    scale = max(target / h, target / w)
    return _constrain_to_multiple_of(scale * h, multiple, target), _constrain_to_multiple_of(scale * w, multiple, target)


class DepthPredictor:
    """The reference's eval-time depth path on the device: rescale 1/255 ->
    keep-aspect lower-bound resize to a multiple of 14 (OpenCV's
    INTER_CUBIC) -> ImageNet normalize -> forward -> bilinear (half-pixel,
    antialiased) resize back to the input size -> min-max colorize to
    uint8 x 3."""

    def __init__(self, model: DepthAnythingModel, cfg: DepthAnythingConfig, target: int = 518):
        self.model = model
        self.cfg = cfg
        self.target = target
        self._cache: Dict[str, np.ndarray] = {}

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, h', w', 3) normalized f32."""
        img = images.float() / 255.0
        h, w = images.shape[1:3]
        oh, ow = resize_lower_bound_hw(h, w, self.target, self.cfg.patch_size)
        img = _apply_hw(img, cv2_cubic_weights(h, oh) if oh != h else None, cv2_cubic_weights(w, ow) if ow != w else None)
        mean = torch.tensor(_IMAGENET_MEAN, dtype=torch.float32, device=img.device)
        std = torch.tensor(_IMAGENET_STD, dtype=torch.float32, device=img.device)
        return (img - mean) / std

    @torch.no_grad()
    def depth(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 on the model's device -> (B, H, W) depth."""
        d = forward_depth(self.model, self.preprocess(images), self.cfg)
        return image_resize(d, tuple(images.shape[1:3]), "bilinear")

    def colorized(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, H, W, 3) uint8 colorized depth."""
        return colorize_depth(self.depth(images))

    def predict_colorized(self, raw_images: Sequence[np.ndarray], keys: Sequence[str] = ()) -> List[np.ndarray]:
        """(H, W, 3) uint8 arrays -> colorized uint8 x 3 depth maps at their
        sizes; images of one shape run as one batch, ``keys`` memoize."""
        keys = list(keys) if keys else [None] * len(raw_images)
        out: List[np.ndarray] = [None] * len(raw_images)
        groups: Dict[tuple, list] = {}
        for i, (img, key) in enumerate(zip(raw_images, keys)):
            if key is not None and key in self._cache:
                out[i] = self._cache[key]
            else:
                groups.setdefault(np.asarray(img).shape, []).append(i)
        dev = next(self.model.parameters()).device
        for idx in groups.values():
            batch = torch.as_tensor(np.stack([np.asarray(raw_images[i]) for i in idx]), device=dev)
            for i, col in zip(idx, self.colorized(batch).cpu().numpy()):
                out[i] = col
                if keys[i] is not None:
                    self._cache[keys[i]] = col
        return out
