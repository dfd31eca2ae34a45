"""Shared primitive layers as plain functions on tensors.

Port of ``spatialrgpt_tpu/ops/layers.py`` (float-kernel branch only; the
int8 / int4 / W8A8 / LoRA branches of ``linear`` are not ported yet).
Weights use PyTorch's (out, in) layout, as the HF names hold them.
Numerics follow the reference: LayerNorm statistics and affine in fp32,
RMSNorm variance in fp32 with the scale applied in the input dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ weight.T + bias in x's dtype (cuBLAS accumulates bf16 in fp32)."""
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    return F.linear(x, w, b)


def qkv_proj(x: torch.Tensor, attn, hq: int, hk: int, d: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q/k/v projections over (B, S, C) from a module holding ``q_proj``,
    ``k_proj`` and ``v_proj`` linears.  Returns (B,S,hq,d), (B,S,hk,d),
    (B,S,hk,d)."""
    B, S = x.shape[0], x.shape[1]
    q = linear(x, attn.q_proj.weight, attn.q_proj.bias)
    k = linear(x, attn.k_proj.weight, attn.k_proj.bias)
    v = linear(x, attn.v_proj.weight, attn.v_proj.bias)
    return q.view(B, S, hq, d), k.view(B, S, hk, d), v.view(B, S, hk, d)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis: fp32 statistics and fp32 affine."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Llama RMSNorm: fp32 variance, scale applied in the input dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale.to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """gelu_pytorch_tanh (SigLIP MLP activation)."""
    return F.gelu(x, approximate="tanh")


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU, used by the projector and the region extractor."""
    return F.gelu(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)
