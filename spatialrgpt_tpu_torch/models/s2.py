"""S² multi-scale vision wrapper (port of ``spatialrgpt_tpu/models/s2.py``).

The reference's VisionTowerS2 (``s2wrapper.multiscale_forward``): run the
tower at several image scales, split each scale larger than the base into
base-size crops, pool each scale's token grid back to the base grid and
concatenate along channels, so the hidden size becomes base_hidden x
len(scales).  Every crop of every scale is stacked on the batch axis and
the tower runs once over all of them.  The resize is JAX's
``jax.image.resize(..., "bilinear", antialias=False)`` from the largest
scale down, by its own weight matrices
(``models/depth_anything.py::image_resize``); ``F.interpolate`` samples
otherwise.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from spatialrgpt_tpu_torch.models.depth_anything import image_resize


def _split_crops(x: torch.Tensor, num_split: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*n*n, H/n, W/n, C) raster-order crops."""
    b, h, w, c = x.shape
    hs, ws = h // num_split, w // num_split
    x = x.reshape(b, num_split, hs, num_split, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * num_split * num_split, hs, ws, c)


def _merge_crops(feats: torch.Tensor, num_split: int) -> torch.Tensor:
    """(B*n*n, s, s, C) -> (B, n*s, n*s, C)."""
    bnn, s, _, c = feats.shape
    b = bnn // (num_split * num_split)
    x = feats.reshape(b, num_split, num_split, s, s, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, num_split * s, num_split * s, c)


def multiscale_forward(
    tower_fn: Callable[[torch.Tensor], torch.Tensor],
    images: torch.Tensor,  # (B, H, W, C) at the LARGEST scale
    scales: Sequence[int],  # e.g. (336, 672, 1008)
    base_size: int,
) -> torch.Tensor:
    """Returns (B, (base/patch)^2, hidden * len(scales)): each scale resized
    from the input, split into base-size crops, encoded (all scales in one
    ``tower_fn`` call), re-assembled, average-pooled to the base token grid
    and channel-concatenated in scale order."""
    b = images.shape[0]
    splits, crops = [], []
    for scale in scales:
        num_split = scale // base_size
        img = image_resize(images, (scale, scale), "bilinear", antialias=False)
        crops.append(_split_crops(img, num_split) if num_split > 1 else img)
        splits.append(num_split)
    feats_all = tower_fn(torch.cat(crops, dim=0))  # (sum of B*n*n, T, C)
    outs, start = [], 0
    for num_split, c in zip(splits, crops):
        feats = feats_all[start : start + c.shape[0]]
        start += c.shape[0]
        side = int(round(feats.shape[1] ** 0.5))
        grid = feats.reshape(feats.shape[0], side, side, feats.shape[-1])
        merged = _merge_crops(grid, num_split) if num_split > 1 else grid
        if num_split > 1:
            # average-pool back to the base grid
            ms = merged.shape[1] // side
            merged = merged.reshape(b, side, ms, side, ms, merged.shape[-1]).mean((2, 4))
        outs.append(merged.reshape(b, side * side, -1))
    return torch.cat(outs, dim=-1)
