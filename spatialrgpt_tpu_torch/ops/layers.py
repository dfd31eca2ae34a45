"""Shared primitive layers as plain functions on tensors.

Port of ``spatialrgpt_tpu/ops/layers.py`` (float-kernel branch only; the
int8 / int4 / W8A8 / LoRA branches of ``linear`` are not ported yet).
Weights use PyTorch's (out, in) layout, as the HF names hold them.
Numerics follow the reference: LayerNorm statistics and affine in fp32,
RMSNorm variance in fp32 with the scale applied in the input dtype.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from spatialrgpt_tpu_torch.ops.layer_norm import fused_layer_norm, fused_layer_norm_plain


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


# the reference's opt-in switch for the fused LayerNorm kernel (K6), read once
# at import as the reference reads it (ops/layers.py:176)
FUSED_LN = os.environ.get("SRGPT_FUSED_LN", "0") == "1"


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis: fp32 statistics and fp32 affine.  With
    ``FUSED_LN`` a bf16 (..., C) tensor on the card with C % 128 == 0 and at
    least 4096 rows goes to K6 (the reference's gate, ``layers.py:189-195``)."""
    if (
        FUSED_LN
        and x.is_cuda
        and x.dtype == torch.bfloat16
        and x.dim() >= 2
        and x.shape[-1] % 128 == 0
        and x.numel() // x.shape[-1] >= 4096
    ):
        return fused_layer_norm(x, weight, bias, eps)
    return fused_layer_norm_plain(x, weight, bias, eps)


def deconv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Transposed conv whose stride equals its kernel k: every input pixel
    (i, j) makes the output block (k i.., k j..) as ``x[i, j] @ W[:, :, di, dj]``.

    x: (N, H, W, C_in) NHWC; weight: (C_in, C_out, k, k) -> (N, kH, kW, C_out).
    The product is cast to the input dtype before the bias add, as in the
    reference (a matmul, so float32 never goes through cuDNN's TF32)."""
    n, h, w, ci = x.shape
    co, f = weight.shape[1], weight.shape[2]
    kmat = weight.to(x.dtype).permute(0, 2, 3, 1).reshape(ci, f * f * co)  # (Ci, (p, q, Co))
    y = torch.matmul(x.reshape(-1, ci), kmat).reshape(n, h, w, f, f, co)
    y = y + bias.to(x.dtype)
    # interleave: (N, H, f, W, f, Co) -> (N, fH, fW, Co)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(n, f * h, f * w, co)


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None, stride: int = 1) -> torch.Tensor:
    """NHWC convolution with JAX's "SAME" padding: per spatial axis the
    output is ceil(in / stride) and the total padding
    max((out - 1) * stride + k - in, 0) puts its smaller half first (torch's
    ``padding="same"`` refuses stride > 1).  weight: (C_out, C_in, kh, kw)."""
    pads = []
    for size, k in ((x.shape[2], weight.shape[3]), (x.shape[1], weight.shape[2])):  # F.pad order: W then H
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    y = F.pad(x.permute(0, 3, 1, 2), pads)
    y = F.conv2d(y, weight.to(x.dtype), None if bias is None else bias.to(x.dtype), stride=stride)
    return y.permute(0, 2, 3, 1)


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
