"""int8 KV-cache quantization (port of ``spatialrgpt_tpu/ops/quant.py``
``quantize_kv`` / ``dequantize_kv``).

Per-position-per-head symmetric int8 over the head dim.  ``torch.round``
rounds half to even, as ``jnp.round`` does; the value is rounded before
the cast, never truncated by it.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) -> (int8 (..., D), f32 scale (...)); scale floor 1e-8."""
    xf = x.float()
    s = xf.abs().amax(dim=-1) / 127.0
    s = torch.clamp(s, min=1e-8)
    q = torch.round(xf / s.unsqueeze(-1)).to(torch.int8)
    return q, s


def dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * s.unsqueeze(-1)).to(dtype)
