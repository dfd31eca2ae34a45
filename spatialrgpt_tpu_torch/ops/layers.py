"""Shared primitive layers as plain functions on tensors.

Port of ``spatialrgpt_tpu/ops/layers.py``.  Weights use PyTorch's (out,
in) layout, as the HF names hold them.  ``linear`` takes a float weight
(or an ``nn.Linear``) or a quantized ``QuantLinear`` and runs the
reference's branches: float, W8A8 (K7 + K8), int8 weight-only (K9) and
packed int4 (plain).  The LoRA side branch and the W8A8 straight-through
backward are not ported yet.
Numerics follow the reference: LayerNorm statistics and affine in fp32,
RMSNorm variance in fp32 with the scale applied in the input dtype.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from spatialrgpt_tpu_torch.ops import int8_linear
from spatialrgpt_tpu_torch.ops.layer_norm import fused_layer_norm, fused_layer_norm_plain
from spatialrgpt_tpu_torch.ops.quant import dequantize, quantize_int4, quantize_int8

# the quantized branches of ``linear`` launch K7-K9 on CUDA tensors; False
# takes their plain versions on the card too (the comparison route that
# ``attn_impl="xla"`` is for the attention kernels)
QUANT_KERNELS = True
# the reference's W8A8 gate for a contracting weight (din > dout): int8
# activations only from this many rows on (layers.py:114-120)
A8_MIN_ROWS = 2048


class QuantLinear(nn.Module):
    """A projection with a quantized weight: the twin of the reference's
    ``kernel_q`` entry.  Buffers ``q`` (int8 (out, in), or two int4 nibbles
    packed per byte along in: (out, ceil(in / 2))) and ``scale`` (f32
    (out,)); ``a8`` is the reference's W8A8 marker; ``bias`` stays float."""

    def __init__(self, in_features: int, out_features: int, bits: int = 8, a8: bool = False, bias: bool = False,
                 dtype=None, device=None):
        super().__init__()
        if bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {bits}")
        self.in_features, self.out_features, self.bits, self.a8 = in_features, out_features, bits, a8
        cols = in_features if bits == 8 else (in_features + 1) // 2
        self.register_buffer("q", torch.empty((out_features, cols), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.empty((out_features,), dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, dtype=dtype, device=device)) if bias else None

    @classmethod
    def from_linear(cls, lin: nn.Linear, bits: int = 8, act_quant: bool = False) -> "QuantLinear":
        """Quantize ``lin``'s weight as ``quantize_llm`` quantizes a kernel
        (``act_quant`` sets the W8A8 marker, int8 only)."""
        w = lin.weight.detach()
        out = cls(lin.in_features, lin.out_features, bits, act_quant and bits == 8, lin.bias is not None,
                  dtype=w.dtype, device=w.device)
        out.q, out.scale = quantize_int8(w) if bits == 8 else quantize_int4(w)
        if lin.bias is not None:
            out.bias = nn.Parameter(lin.bias.detach().clone(), requires_grad=lin.bias.requires_grad)
        return out

    def takes_a8(self, rows: int) -> bool:
        """The reference's per-call-site rule (``layers.py:114-120``): int8
        activations for an int8 W8A8 weight when it expands (in <= out) or
        at ``A8_MIN_ROWS`` rows and more."""
        return self.a8 and self.bits == 8 and (self.in_features <= self.out_features or rows >= A8_MIN_ROWS)

    def dequantized(self, dtype=torch.bfloat16) -> torch.Tensor:
        """The dequantized (out, in) weight."""
        return dequantize(self.q, self.scale, None if self.bits == 8 else self.in_features, dtype)


def quantized_input(x: torch.Tensor, *mods: nn.Module) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """x's int8 rows and their scales, (xq (M, K), ascale (M,)), made once
    for sibling projections that read the same x when any of them takes
    W8A8 at x's shape; else None.  The reference gets this sharing from
    XLA's common-subexpression elimination (``layers.py:32-33``)."""
    if any(isinstance(m, QuantLinear) and m.takes_a8(math.prod(x.shape[:-1])) for m in mods):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        return int8_linear.act_quant_int8(x2) if QUANT_KERNELS else int8_linear.act_quant_int8_plain(x2)
    return None


def _quant_linear(x: torch.Tensor, p: QuantLinear, xq) -> torch.Tensor:
    K = x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    bias = None if p.bias is None else p.bias.detach()
    if p.takes_a8(x2.shape[0]):  # W8A8: K7 (unless the siblings' xq is given) + K8
        xq, ascale = quantized_input(x, p) if xq is None else xq
        gemm = int8_linear.w8a8_gemm if QUANT_KERNELS else int8_linear.w8a8_gemm_plain
        y = gemm(xq, ascale, p.q, p.scale, bias, out_dtype=x.dtype)
    elif p.bits == 8:  # int8 weight-only: the scale folds into the f32 sums (K9)
        gemm = int8_linear.w8_gemm if QUANT_KERNELS else int8_linear.w8_gemm_plain
        y = gemm(x2, p.q, p.scale, bias)
    else:  # packed int4: dequantize, then the product (plain, as the reference leaves it to XLA)
        y = torch.matmul(x2.float(), p.dequantized(x.dtype).float().T)
        if bias is not None:
            y = y + bias.float()
        y = y.to(x.dtype)
    return y.reshape(*x.shape[:-1], p.out_features)


def linear(
    x: torch.Tensor,
    p: Union[torch.Tensor, nn.Linear, QuantLinear],
    bias: Optional[torch.Tensor] = None,
    xq: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """y = x @ W.T + bias in x's dtype.  ``p`` is a float weight (with
    ``bias``), an ``nn.Linear`` or a ``QuantLinear``.

    Float: ``F.linear`` with the weight and bias cast to x's dtype (cuBLAS
    accumulates bf16 in f32).  Quantized, as the reference's branches
    (``layers.py:97-146``): W8A8 where ``takes_a8`` (K7's int8 rows, or the
    siblings' ``xq``, and K8), else int8 weight-only (K9), or packed int4
    dequantized; each sums in f32, scales, adds the bias in f32 and casts
    once."""
    if isinstance(p, QuantLinear):
        return _quant_linear(x, p, xq)
    if isinstance(p, nn.Linear):
        p, bias = p.weight, p.bias
    w = p.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    return F.linear(x, w, b)


def qkv_proj(x: torch.Tensor, attn, hq: int, hk: int, d: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q/k/v projections over (B, S, C) from a module holding ``q_proj``,
    ``k_proj`` and ``v_proj`` linears (float or quantized; x is quantized
    once for those that take W8A8).  Returns (B,S,hq,d), (B,S,hk,d),
    (B,S,hk,d)."""
    B, S = x.shape[0], x.shape[1]
    xq = quantized_input(x, attn.q_proj, attn.k_proj, attn.v_proj)
    q = linear(x, attn.q_proj, xq=xq)
    k = linear(x, attn.k_proj, xq=xq)
    v = linear(x, attn.v_proj, xq=xq)
    return q.view(B, S, hq, d), k.view(B, S, hk, d), v.view(B, S, hk, d)


def _swap_linears(root: nn.Module, make) -> None:
    """Replace every ``nn.Linear`` under ``root`` by ``make(linear)``."""
    for name, child in list(root.named_children()):
        if isinstance(child, nn.Linear):
            setattr(root, name, make(child))
        else:
            _swap_linears(child, make)


def quantize_model(model: nn.Module, bits: int = 8, act_quant: bool = False, vision: bool = False) -> nn.Module:
    """In place, every ``nn.Linear`` under ``model.llm`` (``lm_head``
    included; the embedding table is no linear) and, with ``vision``, under
    ``model.vision_tower`` becomes a ``QuantLinear``: what
    ``quantize_llm(params["llm"])`` and ``quantize_llm(params["vision"])``
    do to every 2-D kernel.  ``mm_projector`` and ``region_extractor``
    stay float, and so does SigLIP's patch kernel (a convolution)."""
    roots = [model.llm] + ([model.vision_tower] if vision else [])
    for root in roots:
        _swap_linears(root, lambda lin: QuantLinear.from_linear(lin, bits, act_quant))
    return model


def dequantize_model(model: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """In place, every ``QuantLinear`` becomes an ``nn.Linear`` holding its
    dequantized weight in ``dtype`` (``dequantize_llm``)."""
    for name, child in list(model.named_children()):
        if isinstance(child, QuantLinear):
            lin = nn.Linear(child.in_features, child.out_features, bias=child.bias is not None, dtype=dtype,
                            device=child.q.device)
            with torch.no_grad():
                lin.weight.copy_(child.dequantized(dtype))
                if child.bias is not None:
                    lin.bias.copy_(child.bias)
            setattr(model, name, lin.requires_grad_(False))
        else:
            dequantize_model(child, dtype)
    return model


def is_quantized(model: nn.Module) -> bool:
    return any(isinstance(m, QuantLinear) for m in model.modules())


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
