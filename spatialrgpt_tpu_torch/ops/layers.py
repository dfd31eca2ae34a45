"""Shared primitive layers as plain functions on tensors.

Port of ``spatialrgpt_tpu/ops/layers.py``.  Weights use PyTorch's (out,
in) layout, as the HF names hold them.  ``linear`` takes a float weight
(or an ``nn.Linear``) or a quantized ``QuantLinear`` and runs the
reference's branches: float, W8A8 (K7 + K8), int8 weight-only (K9) and
packed int4 (plain), each with the reference's gradient into x (the W8A8
straight-through estimator, its int8 route on K10 + K11 under
``enable_int8_backward``, and autodiff's dx of the weight-only product) and
the unmerged LoRA side branch of ``train/lora.py``.
Numerics follow the reference: LayerNorm statistics and affine in fp32,
RMSNorm variance in fp32 with the scale applied in the input dtype.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional, Tuple, Union

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
# the W8A8 backward's dx on K10 + K11 (``enable_int8_backward``)
INT8_BACKWARD = False


def enable_int8_backward(on: bool = True) -> None:
    """Run the W8A8 straight-through backward's dx as an int8 product
    (SwitchBack, the reference's ``enable_int8_backward``,
    ``layers.py:49-60``): dy times the weight's per-channel scale, quantized
    per row (K10), against the stored int8 weight (K11).  Each forward reads
    the switch, so a flip acts on the steps that run after it, as the
    reference's acts on the steps traced after it."""
    global INT8_BACKWARD
    INT8_BACKWARD = on


class LoraBranch(NamedTuple):
    """The unmerged LoRA factors a (in, r) and b (r, out) of a projection and
    their scale alpha / r (``train/lora.py::apply_lora(merge=False)`` sets
    one as the module's ``lora``)."""

    a: torch.Tensor
    b: torch.Tensor
    scale: float


class MergedLinear(nn.Module):
    """A float projection whose (out, in) weight is computed, not trained:
    ``train/lora.py::apply_lora``'s merged W + a b * scale (a buffer, so it
    may carry the adapters' gradients)."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor]):
        super().__init__()
        self.register_buffer("weight", weight)
        self.bias = bias


class QuantLinear(nn.Module):
    """A projection with a quantized weight: the twin of the reference's
    ``kernel_q`` entry.  Buffers ``q`` (int8 (out, in), or two int4 nibbles
    packed per byte along in: (out, ceil(in / 2))) and ``scale`` (f32
    (out,)); ``a8`` is the reference's W8A8 marker; ``bias`` stays float.

    A tensor-parallel slice (``parallel/mesh.py::tp_shard_model``) keeps the
    whole weight's (in, out) as ``a8_rule`` for the call-site rule, and a
    slice of the fan-in its group as ``tp_fan_in``."""

    a8_rule = None
    tp_fan_in = None

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
        fan_in, fan_out = self.a8_rule or (self.in_features, self.out_features)
        return self.a8 and self.bits == 8 and (fan_in <= fan_out or rows >= A8_MIN_ROWS)

    def dequantized(self, dtype=torch.bfloat16) -> torch.Tensor:
        """The dequantized (out, in) weight."""
        return dequantize(self.q, self.scale, None if self.bits == 8 else self.in_features, dtype)


def quantized_input(x: torch.Tensor, *mods: nn.Module) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """x's int8 rows and their scales, (xq (M, K), ascale (M,)), made once
    for sibling projections that read the same x when any of them takes
    W8A8 at x's shape; else None.  The reference gets this sharing from
    XLA's common-subexpression elimination (``layers.py:32-33``)."""
    if any(isinstance(m, QuantLinear) and m.takes_a8(math.prod(x.shape[:-1])) for m in mods):
        with torch.no_grad():  # int8 rows carry no gradient (the STE's dx goes to x itself)
            x2 = x.reshape(-1, x.shape[-1]).contiguous()
            return int8_linear.act_quant_int8(x2) if _on_kernels(x2) else int8_linear.act_quant_int8_plain(x2)
    return None


def _on_kernels(t: torch.Tensor) -> bool:
    return QUANT_KERNELS and t.is_cuda


def _ste_dx(dy: torch.Tensor, p: "QuantLinear", dtype: torch.dtype, int8: bool, kernels: bool) -> torch.Tensor:
    """dx of a W8A8 projection by the straight-through estimator
    (``_w8a8_dot_bwd``, ``layers.py:66-86``), dy (M, N) -> (M, K).

    int8: ``dyq, gscale = K10(dy, scale)`` and ``dx = K11(dyq, q, gscale)``
    (their plain versions on the CPU, or with ``kernels`` off).  Else
    ``bf16(dy) @ bf16(q * scale)`` with f32 sums, cast to x's dtype: a
    plain product (``torch.matmul``, as the reference leaves it to XLA)
    against the dequantized weight, one layer's transient made here."""
    if int8:
        if kernels:
            dyq, gscale = int8_linear.act_quant_dy_int8(dy.contiguous(), p.scale)
            return int8_linear.int8_dx_gemm(dyq, p.q, gscale).to(dtype)
        dyq, gscale = int8_linear.act_quant_dy_int8_plain(dy, p.scale)
        return int8_linear.int8_dx_gemm_plain(dyq, p.q, gscale, dtype)
    w = (p.q * p.scale[:, None]).to(torch.bfloat16)
    if dy.is_cuda:  # cuBLAS sums the bf16 product in f32 and rounds once
        return torch.matmul(dy.to(torch.bfloat16), w).to(dtype)
    return torch.matmul(dy.to(torch.bfloat16).float(), w.float()).to(dtype)


def _weight_only_dx(dy: torch.Tensor, p: "QuantLinear", dtype: torch.dtype) -> torch.Tensor:
    """dx of the int8 weight-only product, as the reference's autodiff of
    ``linear`` computes it: ``(f32(dy) * scale) @ q`` cast to x's dtype.  The
    reference's jaxpr holds f32 operands; on the CPU the plain product keeps
    them, and on the card ``dy * scale`` is rounded to bf16 once and the
    product runs in bf16 with f32 sums (the one bf16 pass that the f32 dot
    takes on a TPU at default precision), against a bf16 copy of q made
    here."""
    g = dy.float() * p.scale
    if dy.is_cuda:
        return torch.matmul(g.to(torch.bfloat16), p.q.to(torch.bfloat16)).to(dtype)
    return torch.matmul(g, p.q.float()).to(dtype)


class _W8A8Linear(torch.autograd.Function):
    """``apply(x2, add, xq, p, kernels)``: K8 over x2's int8 rows ``xq``
    (K7's, or the siblings' shared ones), the f32 ``add`` (or None) and the
    bias, in x2's dtype; backward: the straight-through dx of ``_ste_dx``
    (int8 when ``INT8_BACKWARD`` was on at the forward) and ``add``'s
    gradient f32(dy).  x2 is an input even when ``xq`` is given, so that
    every sibling's dx reaches x; q, scale and the bias get none."""

    @staticmethod
    def forward(ctx, x2, add, xq, p, kernels):
        ctx.p, ctx.dtype, ctx.int8, ctx.kernels = p, x2.dtype, INT8_BACKWARD, kernels
        gemm = int8_linear.w8a8_gemm if kernels else int8_linear.w8a8_gemm_plain
        bias = None if p.bias is None else p.bias.detach()
        return gemm(xq[0], xq[1], p.q, p.scale, bias, out_dtype=x2.dtype, add=add)

    @staticmethod
    def backward(ctx, dy):
        dx = _ste_dx(dy, ctx.p, ctx.dtype, ctx.int8, ctx.kernels) if ctx.needs_input_grad[0] else None
        return dx, dy.float() if ctx.needs_input_grad[1] else None, None, None, None


class _W8Linear(torch.autograd.Function):
    """``apply(x2, add, p, kernels)``: K9 with the f32 ``add`` (or None) and
    the bias, in x2's dtype; backward: ``_weight_only_dx`` and ``add``'s
    gradient f32(dy)."""

    @staticmethod
    def forward(ctx, x2, add, p, kernels):
        ctx.p, ctx.dtype = p, x2.dtype
        gemm = int8_linear.w8_gemm if kernels else int8_linear.w8_gemm_plain
        return gemm(x2, p.q, p.scale, None if p.bias is None else p.bias.detach(), add=add)

    @staticmethod
    def backward(ctx, dy):
        dx = _weight_only_dx(dy, ctx.p, ctx.dtype) if ctx.needs_input_grad[0] else None
        return dx, dy.float() if ctx.needs_input_grad[1] else None, None, None


def _lora_add(x2: torch.Tensor, lora: LoraBranch) -> torch.Tensor:
    """The side branch ``((x a) b) * scale`` as the reference sums it
    (``layers.py:132-143``): x a in x's dtype, then an f32 product, f32
    (M, N)."""
    h = torch.matmul(x2, lora.a.to(x2.dtype))
    return torch.matmul(h.float(), lora.b.to(x2.dtype).float()) * lora.scale


def _fan_in_quantized(x2: torch.Tensor, p: QuantLinear) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 rows of a fan-in slice x2 (M, K / tp) with the whole rows'
    scales, as the reference's GSPMD program quantizes the unsharded rows:
    K7's split form finds each row's max |x| over this rank's columns, an
    all-reduce MAX over the tp group makes them the whole rows' maxima
    (M floats a rank cross the group, not the rows), and this rank's
    columns are quantized by the whole rows' scales."""
    import torch.distributed as dist

    def reduce_max(amax):
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=p.tp_fan_in.group)

    quant = int8_linear.act_quant_int8 if _on_kernels(x2) else int8_linear.act_quant_int8_plain
    with torch.no_grad():
        return quant(x2.contiguous(), reduce_max)


def _quant_linear(x: torch.Tensor, p: QuantLinear, xq, add: Optional[torch.Tensor]) -> torch.Tensor:
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    if p.takes_a8(x2.shape[0]):  # W8A8: K7 (unless the siblings' xq is given) + K8
        if xq is None:
            xq = quantized_input(x, p) if p.tp_fan_in is None else _fan_in_quantized(x2, p)
        y = _W8A8Linear.apply(x2, add, xq, p, _on_kernels(x2))
    elif p.bits == 8:  # int8 weight-only: the scale folds into the f32 sums (K9)
        y = _W8Linear.apply(x2.contiguous(), add, p, _on_kernels(x2))
    else:  # packed int4: dequantize, then the product (plain, as the reference leaves it to XLA)
        y = torch.matmul(x2.float(), p.dequantized(x.dtype).float().T)
        y = int8_linear.finish(y, add, None if p.bias is None else p.bias.detach(), x.dtype)
    return y.reshape(*x.shape[:-1], p.out_features)


def linear(
    x: torch.Tensor,
    p: Union[torch.Tensor, nn.Module],
    bias: Optional[torch.Tensor] = None,
    xq: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """y = x @ W.T + bias in x's dtype.  ``p`` is a float weight (with
    ``bias``), an ``nn.Linear``, a ``MergedLinear`` or a ``QuantLinear``.

    Float: ``F.linear`` with the weight and bias cast to x's dtype (cuBLAS
    accumulates bf16 in f32).  Quantized, as the reference's branches
    (``layers.py:97-146``): W8A8 where ``takes_a8`` (K7's int8 rows, or the
    siblings' ``xq``, and K8), else int8 weight-only (K9), or packed int4
    dequantized; each sums in f32, scales, adds the bias in f32 and casts
    once.  A module carrying a ``LoraBranch`` as ``lora`` adds the side
    branch's f32 sum to the f32 y before the bias (then the float branch,
    too, sums in f32)."""
    lora = getattr(p, "lora", None)
    if isinstance(p, QuantLinear):
        add = None if lora is None else _lora_add(x.reshape(-1, x.shape[-1]), lora)
        return _quant_linear(x, p, xq, add)
    if isinstance(p, nn.Module):
        p, bias = p.weight, p.bias
    w = p.to(x.dtype)
    if lora is None:
        return F.linear(x, w, None if bias is None else bias.to(x.dtype))
    y = torch.matmul(x.float(), w.float().T) + _lora_add(x.reshape(-1, x.shape[-1]), lora).view(*x.shape[:-1], -1)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


# rows of w (N, K) widened to f32 at a time in ``MatmulF32``'s backward
MATMUL_F32_BWD_ROWS = 16384


class MatmulF32(torch.autograd.Function):
    """``matmul_f32`` with JAX's VJP of ``jnp.dot(x, w.T,
    preferred_element_type=f32)``: for the f32 cotangent g (M, N), dx = g w
    and dw = g^T x, each an f32 product of g with the other operand widened
    to f32, rounded once to its operand's dtype.  w is widened
    ``MATMUL_F32_BWD_ROWS`` rows at a time (the reference's tied head is
    Gemma's 256,000-row table: no f32 copy of it exists), and dw is computed
    only where w needs a gradient."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
            return torch.mm(x, w.t(), out_dtype=torch.float32)
        return torch.matmul(x.float(), w.float().t())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        n = MATMUL_F32_BWD_ROWS
        if ctx.needs_input_grad[0]:
            acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            for r0 in range(0, w.shape[0], n):
                acc += g[:, r0 : r0 + n] @ w[r0 : r0 + n].float()
            dx = acc.to(x.dtype)
        if ctx.needs_input_grad[1]:
            xf = x.float()
            dw = torch.empty_like(w)
            for r0 in range(0, w.shape[0], n):
                dw[r0 : r0 + n] = (g[:, r0 : r0 + n].t() @ xf).to(w.dtype)
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w.T for w (N, K) of x's dtype, f32 (M, N): f32 sums of the
    products, never rounded to x's dtype (``jnp.dot(...,
    preferred_element_type=f32)``).  On the card one cuBLAS GEMM with an f32
    output; on the CPU an f32 product (exact for the products of bf16
    values).  Differentiable through ``MatmulF32`` (the card's f32-output
    GEMM has no derivative of its own)."""
    return MatmulF32.apply(x, w)


def qkv_proj(x: torch.Tensor, attn, hq: int, hk: int, d: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q/k/v projections over (B, S, C) from a module holding ``q_proj``,
    ``k_proj`` and ``v_proj`` linears (float or quantized; x is quantized
    once for those that take W8A8), or their fusion ``wqkv``
    (``fuse_serving_kernels``): one product, its columns split (the
    reference's ``layers.py:158-162``).  Returns (B,S,hq,d), (B,S,hk,d),
    (B,S,hk,d), contiguous."""
    B, S = x.shape[0], x.shape[1]
    if hasattr(attn, "wqkv"):
        q, k, v = linear(x, attn.wqkv).split([hq * d, hk * d, hk * d], dim=-1)
        return (q.reshape(B, S, hq, d).contiguous(), k.reshape(B, S, hk, d).contiguous(),
                v.reshape(B, S, hk, d).contiguous())
    xq = quantized_input(x, attn.q_proj, attn.k_proj, attn.v_proj)
    q = linear(x, attn.q_proj, xq=xq)
    k = linear(x, attn.k_proj, xq=xq)
    v = linear(x, attn.v_proj, xq=xq)
    return q.view(B, S, hq, d), k.view(B, S, hk, d), v.view(B, S, hk, d)


def _fused_linear(mods) -> Optional[nn.Module]:
    """Sibling projections of one input concatenated along their outputs
    (the reference's ``_try_fuse``, ``quant.py:116-152``): float
    ``nn.Linear``s into one, int8 ``QuantLinear``s with their per-channel
    scales (W8A8 where all of them are).  None where they do not fuse: a
    packed int4 weight, mixed kinds, a bias on some but not all, or a LoRA
    branch on any of them (the reference's ``_try_fuse`` would drop a
    ``lora`` entry; the port leaves such projections as they are)."""
    if any(getattr(m, "lora", None) is not None for m in mods):
        return None
    has_bias = [m.bias is not None for m in mods]
    if any(has_bias) != all(has_bias):
        return None
    bias = torch.cat([m.bias.detach() for m in mods]) if all(has_bias) else None
    out_features = sum(m.out_features for m in mods)
    if all(type(m) is nn.Linear for m in mods):
        w = mods[0].weight
        out = nn.Linear(w.shape[1], out_features, bias=bias is not None, dtype=w.dtype, device=w.device)
        with torch.no_grad():
            out.weight.copy_(torch.cat([m.weight.detach() for m in mods]))
            if bias is not None:
                out.bias.copy_(bias)
        return out.requires_grad_(False)
    if all(isinstance(m, QuantLinear) and m.bits == 8 and m.a8_rule is None for m in mods):
        q = mods[0].q
        out = QuantLinear(mods[0].in_features, out_features, 8, all(m.a8 for m in mods), bias is not None,
                          dtype=None if bias is None else bias.dtype, device=q.device)
        out.q = torch.cat([m.q for m in mods])
        out.scale = torch.cat([m.scale for m in mods])
        if bias is not None:
            out.bias = nn.Parameter(bias, requires_grad=False)
        return out
    return None


@torch.no_grad()
def fuse_serving_kernels(model: nn.Module) -> nn.Module:
    """Serving transform, in place (the reference's
    ``ops/quant.py::fuse_serving_kernels``): the q/k/v projections of every
    attention that ``qkv_proj`` serves (the decoder's and SigLIP's: classes
    marked ``qkv_fusable``) become one ``wqkv``, and a dense MLP's
    ``gate_proj`` / ``up_proj`` one ``gu``, each where ``_fused_linear``
    fuses them (MoE experts keep their own names and stay apart).  One
    product over x in place of two or three, and with W8A8 one K7 and one
    K8 launch.  Single-card serving only: ``tp_shard_model`` refuses a
    fused model, as the fused columns interleave the head groups that its
    rules shard (the reference's ``quant.py:165-167``)."""
    if getattr(getattr(model, "llm", model), "tp", None) is not None:
        raise ValueError("fuse_serving_kernels: the model is tensor-parallel; fuse only single-card models")
    for mod in list(model.modules()):
        if getattr(type(mod), "qkv_fusable", False) and all(hasattr(mod, n) for n in ("q_proj", "k_proj", "v_proj")):
            fused = _fused_linear([mod.q_proj, mod.k_proj, mod.v_proj])
            if fused is not None:
                del mod.q_proj, mod.k_proj, mod.v_proj
                mod.wqkv = fused
        if all(hasattr(mod, n) for n in ("gate_proj", "up_proj", "down_proj")):
            fused = _fused_linear([mod.gate_proj, mod.up_proj])
            if fused is not None:
                del mod.gate_proj, mod.up_proj
                mod.gu = fused
    return model


def is_fused(model: nn.Module) -> bool:
    """Whether ``fuse_serving_kernels`` fused any projections of ``model``."""
    return any(hasattr(m, "wqkv") or hasattr(m, "gu") for m in model.modules())


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
