"""Region extractor (port of ``spatialrgpt_tpu/models/region_extractor.py``):
deconv feature refinement, mask pooling and the RGB / depth projectors.

Parameters live in ``RegionExtractor`` under the reference's names
(``feature_refinement_module.{i}.*``, ``rgb_projector.*``,
``depth_projector.*``).  The stride-2 kernel-2 transposed conv is a
matmul + pixel interleave as in the reference, not ``ConvTranspose2d``;
adaptive pooling is two pooling-matrix products.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spatialrgpt_tpu_torch.config import RegionExtractorConfig
from spatialrgpt_tpu_torch.ops.layers import deconv, gelu_erf, layer_norm, linear


class RegionExtractor(nn.Module):
    """deconvNx: (N-1) x [ConvT(k2, s2) + LayerNorm2d + GELU] + ConvT + GELU."""

    def __init__(self, cfg: RegionExtractorConfig, dtype=None):
        super().__init__()
        c, h = cfg.mm_hidden_size, cfg.hidden_size
        mods = []
        for d in range(cfg.deconv_depth):
            # parameter storage only (weight (C_in, C_out, 2, 2)); see ops/layers.py::deconv
            mods.append(nn.ConvTranspose2d(c, c, 2, stride=2, dtype=dtype))
            if d < cfg.deconv_depth - 1:
                mods.append(nn.LayerNorm(c, eps=1e-6, dtype=dtype))
            mods.append(nn.GELU())
        self.feature_refinement_module = nn.ModuleList(mods)
        self.rgb_projector = nn.Linear(c, h, dtype=dtype)
        self.depth_projector = nn.Linear(c, h, dtype=dtype)

    def deconvs(self):
        return [m for m in self.feature_refinement_module if isinstance(m, nn.ConvTranspose2d)]

    def lns(self):
        return [m for m in self.feature_refinement_module if isinstance(m, nn.LayerNorm)]


def _adaptive_pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Row-stochastic (out, in) matrix of AdaptiveAvgPool1d's windows
    [floor(i*in/out), ceil((i+1)*in/out))."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        s = (i * in_size) // out_size
        e = -((-(i + 1) * in_size) // out_size)
        m[i, s:e] = 1.0 / (e - s)
    return m


def adaptive_avg_pool_2d(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, out, out, C) via two pooling matmuls."""
    n, h, w, c = x.shape
    a = torch.from_numpy(_adaptive_pool_matrix(h, out_size)).to(device=x.device, dtype=x.dtype)
    b = torch.from_numpy(_adaptive_pool_matrix(w, out_size)).to(device=x.device, dtype=x.dtype)
    y = torch.einsum("oh,nhwc->nowc", a, x)
    return torch.einsum("pw,nowc->nopc", b, y)


def feature_refinement(
    module: RegionExtractor, tower_features: torch.Tensor, cfg: RegionExtractorConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, HW, C) tower features -> (hres (N, H'W', C), lres (N, ada^2, C))."""
    n, hw, c = tower_features.shape
    side = int(round(hw**0.5))
    x = tower_features.reshape(n, side, side, c)
    deconvs, lns = module.deconvs(), module.lns()
    for d, dc in enumerate(deconvs):
        x = deconv(x, dc.weight, dc.bias)
        if d < len(deconvs) - 1:
            x = layer_norm(x, lns[d].weight, lns[d].bias, eps=1e-6)
        x = gelu_erf(x)
    hres = x.reshape(n, -1, c)
    lres = adaptive_avg_pool_2d(x, cfg.ada_pool_size).reshape(n, -1, c)
    return hres, lres


def resize_masks_to_grid(masks: torch.Tensor, grid_side: int) -> torch.Tensor:
    """Bilinear resize of (B, R, H, W) masks to (B, R, g, g) in fp32
    (half-pixel centres, no antialias)."""
    return F.interpolate(
        masks.float(), size=(grid_side, grid_side), mode="bilinear", align_corners=False, antialias=False
    )


def mask_pool(features: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Soft mask pooling: (B, HW, C) features, (B, R, IH, IW) masks -> (B, R, C).
    The resized mask is cast to the feature dtype and normalized by its sum
    + 1e-8."""
    b, hw, c = features.shape
    side = int(round(hw**0.5))
    m = resize_masks_to_grid(masks, side).to(features.dtype)
    denorm = m.sum(dim=(-1, -2), keepdim=True) + 1e-8
    weights = (m / denorm).reshape(b, -1, hw)
    pooled = torch.einsum("blc,brl->brc", features.float(), weights.float())
    return pooled.to(features.dtype)


def extract_regions(
    module: RegionExtractor,
    hres_features: torch.Tensor,  # (B, H'W', C) refined RGB features
    depth_features: Optional[torch.Tensor],  # (B, HW, C) raw depth tower features
    masks: torch.Tensor,  # (B, R, IH, IW)
    cfg: RegionExtractorConfig,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(mask_embeds (B, R, hidden), depth_embeds or None).  RGB pooling uses
    the refined high-res grid; depth pooling the *raw* tower features."""
    rgb = mask_pool(hres_features, masks)
    mask_embeds = linear(rgb, module.rgb_projector.weight, module.rgb_projector.bias)
    depth_embeds = None
    if depth_features is not None:
        dp = mask_pool(depth_features, masks)
        depth_embeds = linear(dp, module.depth_projector.weight, module.depth_projector.bias)
    return mask_embeds, depth_embeds
