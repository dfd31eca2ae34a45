"""Feature-map visualization for tower debugging (a copy of
``spatialrgpt_tpu/utils/visualize_features.py``): project per-patch
features to 3 channels by PCA and render an RGB map.  Pure numpy PCA; pass
a tower's features as ``tensor.float().cpu().numpy()``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def pca_project(features: np.ndarray, n_components: int = 3) -> np.ndarray:
    """(N, C) -> (N, k) principal components (numpy SVD)."""
    x = np.asarray(features, np.float64)
    x = x - x.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return (x @ vt[:n_components].T).astype(np.float32)


def feature_map_rgb(
    tokens: np.ndarray,  # (T, C) or (B, T, C)
    grid_side: Optional[int] = None,
) -> np.ndarray:
    """Patch tokens -> (H, W, 3) uint8 PCA visualization (per image when
    batched, sharing the PCA basis across the batch)."""
    batched = tokens.ndim == 3
    flat = tokens.reshape(-1, tokens.shape[-1])
    proj = pca_project(flat, 3)
    lo = proj.min(axis=0, keepdims=True)
    hi = proj.max(axis=0, keepdims=True)
    rgb = ((proj - lo) / np.maximum(hi - lo, 1e-8) * 255).astype(np.uint8)
    if batched:
        b, t, _ = tokens.shape
        side = grid_side or int(round(t**0.5))
        return rgb.reshape(b, side, side, 3)
    side = grid_side or int(round(tokens.shape[0] ** 0.5))
    return rgb.reshape(side, side, 3)
