"""MPT decoder with ALiBi attention (port of ``spatialrgpt_tpu/models/mpt.py``).

A pre-LN transformer with a fused Wqkv projection, ALiBi score biases (no
RoPE), bias-free LayerNorms, an exact-GELU FFN and the embedding table as
its f32 head.  Parameters live in ``MptForCausalLM`` under HF
``MptForCausalLM``'s names (``transformer.blocks.{i}.attn.Wqkv.weight``,
...).  The attention is plain PyTorch, as the reference's is XLA: f32
scores, the ALiBi bias ``slope * (j - (S - 1))`` over absolute key
positions (also where ``segment_ids`` pack several samples in a row: the
reference's quirk, kept), the causal x segment mask, softmax, P cast to
the value dtype before P V.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spatialrgpt_tpu_torch.ops.layers import gelu_erf, linear, matmul_f32

NEG_INF = -1e30


@dataclass(frozen=True)
class MPTConfig:
    d_model: int = 4096
    n_heads: int = 32
    n_layers: int = 32
    vocab_size: int = 50432
    max_seq_len: int = 2048
    expansion_ratio: int = 4
    layer_norm_eps: float = 1e-5
    alibi_bias_max: int = 8

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def alibi_slopes(num_heads: int, alibi_bias_max: int = 8) -> np.ndarray:
    """MPT's ALiBi slope schedule (build_mpt_alibi_tensor semantics)."""
    next_pow2 = 2 ** math.ceil(math.log2(num_heads))
    base = np.arange(1, next_pow2 + 1, dtype=np.float64)
    base = base * (alibi_bias_max / next_pow2)
    slopes = 1.0 / (2.0**base)
    if next_pow2 != num_heads:
        slopes = np.concatenate([slopes[1::2], slopes[0::2]])[:num_heads]
    return slopes.astype(np.float32)


def alibi_bias(num_heads: int, seq_len: int, alibi_bias_max: int = 8, device=None) -> torch.Tensor:
    """(1, H, 1, S) f32 bias added to the attention scores: slope * (j - (S-1))."""
    slopes = torch.as_tensor(alibi_slopes(num_heads, alibi_bias_max), device=device)
    pos = torch.arange(1 - seq_len, 1, dtype=torch.float32, device=device)  # -(S-1)..0
    return (slopes[:, None] * pos[None, :])[None, :, None, :]


class MptAttention(nn.Module):
    def __init__(self, cfg: MPTConfig, dtype=None):
        super().__init__()
        d = cfg.d_model
        self.Wqkv = nn.Linear(d, 3 * d, bias=False, dtype=dtype)
        self.out_proj = nn.Linear(d, d, bias=False, dtype=dtype)


class MptMLP(nn.Module):
    def __init__(self, cfg: MPTConfig, dtype=None):
        super().__init__()
        d, i = cfg.d_model, cfg.expansion_ratio * cfg.d_model
        self.up_proj = nn.Linear(d, i, bias=False, dtype=dtype)
        self.down_proj = nn.Linear(i, d, bias=False, dtype=dtype)


class MptBlock(nn.Module):
    def __init__(self, cfg: MPTConfig, dtype=None):
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.norm_1 = nn.LayerNorm(d, eps=eps, bias=False, dtype=dtype)
        self.attn = MptAttention(cfg, dtype)
        self.norm_2 = nn.LayerNorm(d, eps=eps, bias=False, dtype=dtype)
        self.ffn = MptMLP(cfg, dtype)


class MptModel(nn.Module):
    def __init__(self, cfg: MPTConfig, dtype=None):
        super().__init__()
        self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model, dtype=dtype)
        self.blocks = nn.ModuleList(MptBlock(cfg, dtype) for _ in range(cfg.n_layers))
        self.norm_f = nn.LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps, bias=False, dtype=dtype)


class MptForCausalLM(nn.Module):
    """The decoder; its head is ``transformer.wte`` (tied, no ``lm_head``)."""

    def __init__(self, cfg: MPTConfig, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.transformer = MptModel(cfg, dtype)


def _ln(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Bias-free LayerNorm, statistics and scale in f32, cast once."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def embed_tokens(model: MptForCausalLM, input_ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(input_ids, model.transformer.wte.weight)


def forward_embeds(
    model: MptForCausalLM,
    cfg: MPTConfig,
    inputs_embeds: torch.Tensor,  # (B, S, D)
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The decoder stack on built embeddings (the composite's entry: the
    spliced multimodal embeddings go straight in; ALiBi needs no position
    ids).  Returns the final hidden states, normed."""
    x = inputs_embeds
    B, S = x.shape[:2]
    H, D = cfg.n_heads, cfg.head_dim
    eps = cfg.layer_norm_eps
    bias = alibi_bias(H, S, cfg.alibi_bias_max, x.device)
    pos = torch.arange(S, device=x.device)
    live = (pos[:, None] >= pos[None, :])[None, None]
    if segment_ids is not None:
        seg = (segment_ids[:, :, None] == segment_ids[:, None, :]) & (segment_ids[:, :, None] != 0)
        live = live & seg[:, None]
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=x.device)
    for blk in model.transformer.blocks:
        h = _ln(x, blk.norm_1.weight, eps)
        q, k, v = linear(h, blk.attn.Wqkv).reshape(B, S, 3, H, D).unbind(2)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * D**-0.5 + bias
        p = torch.softmax(torch.where(live, s, neg), dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, H * D)
        x = x + linear(o, blk.attn.out_proj)
        h = _ln(x, blk.norm_2.weight, eps)
        x = x + linear(gelu_erf(linear(h, blk.ffn.up_proj)), blk.ffn.down_proj)
    return _ln(x, model.transformer.norm_f.weight, eps)


def logits(model: MptForCausalLM, h: torch.Tensor) -> torch.Tensor:
    """The tied head: h (..., D) against the embedding table, f32 sums, f32
    out (``jnp.dot(h, wte.T, preferred_element_type=f32)``)."""
    wte = model.transformer.wte.weight
    return matmul_f32(h.reshape(-1, h.shape[-1]), wte.to(h.dtype)).reshape(*h.shape[:-1], wte.shape[0])


def forward_logits(
    model: MptForCausalLM,
    cfg: MPTConfig,
    input_ids: torch.Tensor,  # (B, S)
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, S) token ids -> (B, S, vocab) f32 logits."""
    return logits(model, forward_embeds(model, cfg, embed_tokens(model, input_ids), segment_ids))


def convert_mpt(sd, cfg: MPTConfig) -> Dict[str, torch.Tensor]:
    """HF ``MptForCausalLM`` state dict -> ``MptForCausalLM``'s: the names
    the reference's ``convert_mpt`` reads for ``cfg.n_layers`` blocks (the
    tied ``lm_head.weight`` left out)."""
    names = ["transformer.wte.weight", "transformer.norm_f.weight"] + [
        f"transformer.blocks.{i}.{name}" for i in range(cfg.n_layers)
        for name in ("norm_1.weight", "attn.Wqkv.weight", "attn.out_proj.weight", "norm_2.weight",
                     "ffn.up_proj.weight", "ffn.down_proj.weight")]
    return {name: sd[name] if isinstance(sd[name], torch.Tensor) else torch.tensor(np.asarray(sd[name]))
            for name in names}
