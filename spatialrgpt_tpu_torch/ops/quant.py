"""Weight and KV-cache quantization (port of ``spatialrgpt_tpu/ops/quant.py``).

Weights: per-output-channel symmetric int8 (``quantize_int8``) and packed
int4 (``quantize_int4``), with ``dequantize``.  The port keeps PyTorch's
(out, in) layout: the scale is (out,) f32 and reduces over the in dim,
and int4 packs two nibbles along the in dim, as the reference packs along
its axis 0 (din).  The reference's ``quantize_llm`` / ``dequantize_llm``
over a pytree are ``ops/layers.py::quantize_model`` /
``dequantize_model`` over a module.

KV cache: per-position-per-head symmetric int8 over the head dim
(``quantize_kv`` / ``dequantize_kv``), or int4 with two nibbles a byte
along it (``quantize_kv4`` / ``unpack_kv4``).  The serving transform
``fuse_serving_kernels`` works on modules and lives in ``ops/layers.py``.

``torch.round`` rounds half to even, as ``jnp.round`` does; values are
clipped before the cast, never truncated by it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _absmax_over(wf: torch.Tensor, levels: float) -> torch.Tensor:
    """max |w| / levels per output channel, floor 1e-12; divided by a tensor
    so that the card, too, makes an IEEE division and not a multiply by the
    reciprocal of a Python number."""
    amax = wf.abs().amax(dim=1)
    return torch.clamp(amax / torch.full_like(amax, levels), min=1e-12)


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) -> (int8 (out, in), f32 scale (out,)): scale = absmax / 127
    per output channel, floor 1e-12."""
    wf = w.float()
    scale = _absmax_over(wf, 127.0)
    q = torch.clamp(torch.round(wf / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_int4(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) -> (int8 (out, ceil(in / 2)) of two packed nibbles, f32
    scale (out,)): values in [-7, 7] at scale absmax / 7; column j holds in
    features 2j (low nibble) and 2j + 1 (high), an odd in dim padded by a 0."""
    wf = w.float()
    scale = _absmax_over(wf, 7.0)
    q = torch.clamp(torch.round(wf / scale[:, None]), -7, 7).to(torch.int16)
    if q.shape[1] % 2:
        q = torch.nn.functional.pad(q, (0, 1))
    packed = (q[:, 0::2] & 0x0F) | ((q[:, 1::2] & 0x0F) << 4)  # 0..255
    return torch.where(packed > 127, packed - 256, packed).to(torch.int8), scale


def unpack_int4(packed: torch.Tensor, in_features: int) -> torch.Tensor:
    """Inverse of ``quantize_int4``'s packing: (out, ceil(in / 2)) -> the
    int4 values (out, in) as int8, sign-extended."""
    p = packed.to(torch.int32)
    lo = ((p & 0x0F) ^ 8) - 8
    hi = p >> 4  # arithmetic shift of the sign-extended byte
    return torch.stack([lo, hi], dim=-1).reshape(p.shape[0], -1)[:, :in_features].to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor, in_features: Optional[int] = None, dtype=torch.bfloat16) -> torch.Tensor:
    """int8 q (out, in), or packed int4 q with its ``in_features`` -> the
    (out, in) weight ``q * scale`` in f32, cast once to ``dtype``."""
    if in_features is not None:
        q = unpack_int4(q, in_features)
    return (q.float() * scale[:, None]).to(dtype)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) -> (int8 (..., D), f32 scale (...)); scale floor 1e-8."""
    xf = x.float()
    s = xf.abs().amax(dim=-1) / 127.0
    s = torch.clamp(s, min=1e-8)
    q = torch.round(xf / s.unsqueeze(-1)).to(torch.int8)
    return q, s


def dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * s.unsqueeze(-1)).to(dtype)


def quantize_kv4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-position-per-head symmetric int4 over the head dim, two nibbles
    a byte: (..., D) -> (int8 (..., D / 2), f32 scale (...)); scale =
    max(max |x| / 7, 1e-8), values clipped to [-7, 7].  Byte j holds
    ``x[..., 2j]`` in its low nibble and ``x[..., 2j + 1]`` in its high one.
    The division by 7 is a multiply by f32(1 / 7), as XLA compiles the
    reference's under jit (its ``generate`` and engine), so payload and
    scales are bit-equal to the jitted reference's."""
    if x.shape[-1] % 2:
        raise ValueError(f"quantize_kv4: the head dim must be even, got {x.shape[-1]}")
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1) * (1.0 / 7.0), min=1e-8)
    q = torch.clamp(torch.round(xf / s.unsqueeze(-1)), -7, 7).to(torch.int16)
    packed = (q[..., 0::2] & 0x0F) | ((q[..., 1::2] & 0x0F) << 4)  # 0..255
    return torch.where(packed > 127, packed - 256, packed).to(torch.int8), s


def unpack_kv4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_kv4``'s packing: (..., D / 2) -> the int4
    values (..., D) as int8, sign-extended, low nibble first."""
    p = packed.to(torch.int32)
    lo = ((p & 0x0F) ^ 8) - 8
    hi = p >> 4  # arithmetic shift of the sign-extended byte
    return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1], -1).to(torch.int8)
