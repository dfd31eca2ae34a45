"""The image front-end on the device, port of
``spatialrgpt_tpu/data/device_preprocess.py``: uint8 pixels cross to the
card and are resized and normalized there.

- ``device_resize_uint8``: Pillow's uint8 bicubic, exactly.  Pillow's path
  is integer: per axis a fixed-point matmul (coefficients scaled by 2^22,
  rounded half away from zero), + 2^21, >> 22, clamp to uint8; horizontal
  pass first, uint8 intermediate, then vertical.  The accumulator reaches
  ~2^34, so the reference splits each coefficient into two f32-exact halves
  (a TPU workaround); here one float64 matmul holds every partial sum as an
  exact integer (< 2^53), whatever the summation order.
- ``device_siglip_normalize``: SiglipProcessor's rescale + normalize in the
  same f32 operation order.
- ``device_mask_resize_nearest``: cv2 INTER_NEAREST's index map as a gather.

The coefficients are the host path's own: ``_resample_matrix`` of
``data/preprocess.py``, the port's copy of the reference's host
preprocessing.
"""

from __future__ import annotations

import functools
import numpy as np
import torch

from spatialrgpt_tpu_torch.data.preprocess import _PIL_PRECISION_BITS, _resample_matrix


@functools.lru_cache(maxsize=64)
def _fixed_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's fixed-point (2^22) bicubic coefficients, (out_size, in_size)."""
    return _resample_matrix(in_size, out_size)[1]


def _fixed_pass(x: torch.Tensor, in_size: int, out_size: int, axis: int) -> torch.Tensor:
    """One Pillow fixed-point pass along ``axis`` (1: rows, 2: columns) of a
    float64 (B, H, W, C) tensor of integers: clip8((m @ x + 2^21) >> 22)."""
    m = torch.from_numpy(_fixed_matrix(in_size, out_size)).to(device=x.device, dtype=torch.float64)
    s = torch.einsum("vh,bhwc->bvwc" if axis == 1 else "vw,bhwc->bhvc", m, x) + float(1 << (_PIL_PRECISION_BITS - 1))
    return torch.floor(s / float(1 << _PIL_PRECISION_BITS)).clamp(0.0, 255.0)


def device_resize_uint8(images: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, out_h, out_w, C) uint8, Pillow's bicubic
    bit for bit (horizontal pass first, uint8 intermediate)."""
    B, H, W, C = images.shape
    x = images.to(torch.float64)
    if W != out_w:
        x = _fixed_pass(x, W, out_w, 2)
    if H != out_h:
        x = _fixed_pass(x, H, out_h, 1)
    return x.to(torch.uint8)


# SiglipProcessor's rescale, mean and std (0.5 for each channel)
_RESCALE = float(np.float32(1.0 / 255.0))
_MEAN_STD = 0.5


def device_siglip_normalize(images_u8: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, S, S, C) uint8 at the processor size -> ``dtype``: SiglipProcessor's
    rescale + normalize in the same f32 order, x * rescale, then
    (x - mean) / std, cast once."""
    return ((images_u8.to(torch.float32) * _RESCALE - _MEAN_STD) / _MEAN_STD).to(dtype)


def device_preprocess_uint8(images: torch.Tensor, out_size: int) -> torch.Tensor:
    """(B, H, W, C) uint8 of any size -> (B, out, out, C) f32: resize
    (Pillow-exact) + rescale + normalize, SiglipProcessor's uint8 path on
    the device."""
    return device_siglip_normalize(device_resize_uint8(images, out_size, out_size))


@functools.lru_cache(maxsize=64)
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """cv2 INTER_NEAREST's source index per output position
    (floor(dx * in / out), clamped): what ``process_masks`` uses."""
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


def device_mask_resize_nearest(masks: torch.Tensor, out_size: int) -> torch.Tensor:
    """Binary region masks (B, R, H, W) -> (B, R, out, out) f32, as
    ``process_masks`` (cv2 nearest, then the un-normalized processor)."""
    iy = torch.from_numpy(_nearest_index(masks.shape[2], out_size)).to(masks.device)
    ix = torch.from_numpy(_nearest_index(masks.shape[3], out_size)).to(masks.device)
    return masks[:, :, iy][:, :, :, ix].to(torch.float32)
