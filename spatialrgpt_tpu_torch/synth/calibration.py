"""Camera calibration for the synthesis pipeline, port of
``spatialrgpt_tpu/synth/calibration.py``: ``CameraNet``, one compact ViT
regressor of (roll_deg, pitch_deg, vfov_deg) from an RGB image, and the
``LiftStage`` adapters built on it, ``make_gravity_model`` (the
PerspectiveFields / GeoCalib slot) and ``make_intrinsics_model`` (the
WildCamera slot).  ``calib_loss`` is its training objective.

Parameters live in ``CameraNet`` under the names of the reference's
parameter tree.  ``intrinsics_from_vfov`` and ``_prep`` are copies of the
reference's framework-free helpers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch
from torch import nn

from spatialrgpt_tpu_torch.ops.layers import gelu_tanh, layer_norm, linear
from spatialrgpt_tpu_torch.utils.device import card_device


@dataclass(frozen=True)
class CameraNetConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 256
    num_hidden_layers: int = 6
    num_attention_heads: int = 4
    intermediate_size: int = 1024
    layer_norm_eps: float = 1e-6
    # output ranges: angles are regressed directly in degrees; vfov is
    # squashed to (vfov_min, vfov_max) via sigmoid
    vfov_min_deg: float = 20.0
    vfov_max_deg: float = 120.0


class _Attention(nn.Module):
    def __init__(self, h: int, dtype=None):
        super().__init__()
        self.wq = nn.Linear(h, h, dtype=dtype)
        self.wk = nn.Linear(h, h, dtype=dtype)
        self.wv = nn.Linear(h, h, dtype=dtype)
        self.wo = nn.Linear(h, h, dtype=dtype)


class _MLP(nn.Module):
    def __init__(self, h: int, inter: int, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(h, inter, dtype=dtype)
        self.fc2 = nn.Linear(inter, h, dtype=dtype)


class _Layer(nn.Module):
    def __init__(self, cfg: CameraNetConfig, dtype=None):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.ln1 = nn.LayerNorm(h, eps=eps, dtype=dtype)
        self.ln2 = nn.LayerNorm(h, eps=eps, dtype=dtype)
        self.attn = _Attention(h, dtype)
        self.mlp = _MLP(h, cfg.intermediate_size, dtype)


class CameraNet(nn.Module):
    def __init__(self, cfg: CameraNetConfig, dtype=None):
        super().__init__()
        h = cfg.hidden_size
        self.patch_embed = nn.Linear(cfg.patch_size * cfg.patch_size * 3, h, dtype=dtype)
        self.pos_embed = nn.Parameter(torch.empty((cfg.image_size // cfg.patch_size) ** 2, h, dtype=dtype))
        self.layers = nn.ModuleList(_Layer(cfg, dtype) for _ in range(cfg.num_hidden_layers))
        self.final_ln = nn.LayerNorm(h, eps=cfg.layer_norm_eps, dtype=dtype)
        self.head = nn.Linear(h, 3, dtype=dtype)  # (roll, pitch, vfov_logit)


def _attention(x: torch.Tensor, p: _Attention, num_heads: int) -> torch.Tensor:
    B, S, H = x.shape
    D = H // num_heads
    q = linear(x, p.wq).view(B, S, num_heads, D).transpose(1, 2)
    k = linear(x, p.wk).view(B, S, num_heads, D).transpose(1, 2)
    v = linear(x, p.wv).view(B, S, num_heads, D).transpose(1, 2)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(scores * D**-0.5, dim=-1).to(v.dtype)
    return linear(torch.matmul(probs, v).transpose(1, 2).reshape(B, S, H), p.wo)


def forward(model: CameraNet, pixel_values: torch.Tensor, cfg: CameraNetConfig) -> torch.Tensor:
    """(B, S, S, 3) normalized pixels -> (B, 3) f32 = (roll_deg, pitch_deg, vfov_deg)."""
    B = pixel_values.shape[0]
    P = cfg.patch_size
    n = cfg.image_size // P
    eps = cfg.layer_norm_eps
    # patchify: (B, n, P, n, P, 3) -> (B, n*n, P*P*3)
    x = pixel_values.reshape(B, n, P, n, P, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, n * n, P * P * 3)
    x = linear(x, model.patch_embed) + model.pos_embed[None]
    for lp in model.layers:
        x = x + _attention(layer_norm(x, lp.ln1.weight, lp.ln1.bias, eps), lp.attn, cfg.num_attention_heads)
        h = linear(layer_norm(x, lp.ln2.weight, lp.ln2.bias, eps), lp.mlp.fc1)
        x = x + linear(gelu_tanh(h), lp.mlp.fc2)
    x = layer_norm(x.mean(dim=1, keepdim=True), model.final_ln.weight, model.final_ln.bias, eps)[:, 0]
    out = linear(x, model.head).float()
    roll, pitch, fov_logit = out[:, 0], out[:, 1], out[:, 2]
    vfov = cfg.vfov_min_deg + (cfg.vfov_max_deg - cfg.vfov_min_deg) * torch.sigmoid(fov_logit)
    return torch.stack([roll, pitch, vfov], dim=-1)


def calib_loss(model: CameraNet, cfg: CameraNetConfig, pixel_values: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Smooth-L1 on (roll, pitch, vfov) degrees: the training objective for
    fitting the regressor."""
    err = forward(model, pixel_values, cfg) - targets.float()
    ae = err.abs()
    return torch.where(ae < 1.0, 0.5 * err * err, ae - 0.5).mean()


# ---------------------------------------------------------------------------
# Pipeline adapters (LiftStage slots)
# ---------------------------------------------------------------------------


def _prep(image: np.ndarray, size: int) -> np.ndarray:
    from PIL import Image

    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img * (255.0 if img.max() <= 1.5 else 1.0), 0, 255).astype(np.uint8)
    x = np.asarray(Image.fromarray(img).resize((size, size), Image.BILINEAR), np.float32)
    return (x / 255.0 - 0.5) / 0.5


def intrinsics_from_vfov(width: int, height: int, vfov_deg: float) -> np.ndarray:
    """Pinhole K from a vertical field of view (square pixels)."""
    f = 0.5 * height / math.tan(math.radians(vfov_deg) / 2)
    return np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]])


def _predictor(model: CameraNet, cfg: CameraNetConfig, device, what: str) -> Callable[[np.ndarray], np.ndarray]:
    """image -> the (3,) forward of one image on ``device`` (default: the
    card; without one the call raises)."""
    dev = card_device(device, what)
    model.to(dev)

    def predict(image: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return forward(model, torch.as_tensor(_prep(image, cfg.image_size), device=dev)[None], cfg)[0].cpu().numpy()

    return predict


def make_gravity_model(model: CameraNet, cfg: CameraNetConfig, device=None) -> Callable:
    """image -> (roll_deg, pitch_deg): the PerspectiveFields / GeoCalib slot
    (reference pointcloud.py:57-76)."""
    predict = _predictor(model, cfg, device, "make_gravity_model")

    def gravity_model(image: np.ndarray) -> Tuple[float, float]:
        out = predict(image)
        return float(out[0]), float(out[1])

    return gravity_model


def make_intrinsics_model(model: CameraNet, cfg: CameraNetConfig, device=None) -> Callable:
    """image -> (3, 3) K: the WildCamera slot (reference pointcloud.py:85)."""
    predict = _predictor(model, cfg, device, "make_intrinsics_model")

    def intrinsics_model(image: np.ndarray) -> np.ndarray:
        H, W = np.asarray(image).shape[:2]
        return intrinsics_from_vfov(W, H, float(predict(image)[2]))

    return intrinsics_model
