"""Llama-family decoder (port of ``spatialrgpt_tpu/models/llama.py``) for
the plain Llama configs the serving slice runs (``llama3-8b``,
``sheared-3b``): GQA, rotate-half RoPE with linear scaling, SiLU MLP,
RMSNorm, untied LM head.

Parameters live in ``LlamaForCausalLM`` under the HF names that
``spatialrgpt_tpu/utils/export.py::export_llama`` writes
(``model.layers.{i}.self_attn.q_proj.weight``, ...).  The embedding table
includes the extra ``<mask>``/``<depth>`` rows past ``vocab_size``.

MoE, the sliding window, the Gemma knobs and MPT are not ported yet: a
config that asks for them raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from spatialrgpt_tpu.config import LlamaConfig
from spatialrgpt_tpu_torch.ops.attention import causal_attention
from spatialrgpt_tpu_torch.ops.layers import linear, qkv_proj, rms_norm, silu
from spatialrgpt_tpu_torch.ops.quant import quantize_kv


def check_supported(cfg: LlamaConfig) -> None:
    unported = {
        "num_experts (MoE)": cfg.is_moe,
        "sliding_window": cfg.sliding_window is not None,
        "hidden_act != silu": cfg.hidden_act != "silu",
        "norm_plus_one": cfg.norm_plus_one,
        "scale_embeddings": cfg.scale_embeddings,
        "explicit_head_dim": cfg.explicit_head_dim is not None,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "attention_bias": cfg.attention_bias,
    }
    asked = [k for k, v in unported.items() if v]
    if asked:
        raise NotImplementedError(f"llama config asks for what the port does not have yet: {asked}")


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=None):
        super().__init__()
        h, d = cfg.hidden_size, cfg.head_dim
        self.q_proj = nn.Linear(h, cfg.num_attention_heads * d, bias=False, dtype=dtype)
        self.k_proj = nn.Linear(h, cfg.num_key_value_heads * d, bias=False, dtype=dtype)
        self.v_proj = nn.Linear(h, cfg.num_key_value_heads * d, bias=False, dtype=dtype)
        self.o_proj = nn.Linear(cfg.num_attention_heads * d, h, bias=False, dtype=dtype)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=None):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(h, i, bias=False, dtype=dtype)
        self.up_proj = nn.Linear(h, i, bias=False, dtype=dtype)
        self.down_proj = nn.Linear(i, h, bias=False, dtype=dtype)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=None):
        super().__init__()
        self.self_attn = LlamaAttention(cfg, dtype)
        self.mlp = LlamaMLP(cfg, dtype)
        self.input_layernorm = nn.RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, dtype=dtype)
        self.post_attention_layernorm = nn.RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, dtype=dtype)


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, extra_vocab: int = 0, dtype=None):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size + extra_vocab, cfg.hidden_size, dtype=dtype)
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg, dtype) for _ in range(cfg.num_hidden_layers))
        self.norm = nn.RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, dtype=dtype)


class LlamaForCausalLM(nn.Module):
    def __init__(self, cfg: LlamaConfig, extra_vocab: int = 0, dtype=None):
        super().__init__()
        check_supported(cfg)
        self.model = LlamaModel(cfg, extra_vocab, dtype)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size + extra_vocab, bias=False, dtype=dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def apply_rope(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, S, Hk, D)
    position_ids: torch.Tensor,  # (B, S)
    cfg: LlamaConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF-layout rotary embedding (rotate_half), angles and rotation in fp32."""
    d = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=q.device) / d))
    pos = position_ids.float()
    if cfg.rope_scaling_factor:
        pos = pos / cfg.rope_scaling_factor
    freqs = pos[..., None] * inv_freq  # (B, S, D/2)
    emb = torch.cat([freqs, freqs], dim=-1)
    cos = emb.cos()[:, :, None, :]
    sin = emb.sin()[:, :, None, :]

    def rot(x):
        xf = x.float()
        d2 = x.shape[-1] // 2
        rotated = torch.cat([-xf[..., d2:], xf[..., :d2]], dim=-1)
        return (xf * cos + rotated * sin).to(x.dtype)

    return rot(q), rot(k)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def norm(x: torch.Tensor, module: nn.RMSNorm) -> torch.Tensor:
    return rms_norm(x, module.weight, module.eps)


def attention_block(
    x: torch.Tensor,
    attn: LlamaAttention,
    cfg: LlamaConfig,
    position_ids: torch.Tensor,
    segment_ids: Optional[torch.Tensor],
    impl: str,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Prefill attention over the whole (padded) prompt; returns the output
    and this layer's rotated K and V (B, S, Hk, D)."""
    B, S, _ = x.shape
    Hq, Hk, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    q, k, v = qkv_proj(x, attn, Hq, Hk, D)
    q, k = apply_rope(q, k, position_ids, cfg)
    out = causal_attention(q, k, v, segment_ids=segment_ids, impl=impl)
    return linear(out.reshape(B, S, Hq * D), attn.o_proj.weight), (k, v)


def mlp_block(x: torch.Tensor, mlp: LlamaMLP) -> torch.Tensor:
    gate = silu(linear(x, mlp.gate_proj.weight))
    return linear(gate * linear(x, mlp.up_proj.weight), mlp.down_proj.weight)


def embed_tokens(model: LlamaForCausalLM, input_ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(input_ids, model.model.embed_tokens.weight)


def forward(
    model: LlamaForCausalLM,
    cfg: LlamaConfig,
    *,
    inputs_embeds: torch.Tensor,  # (B, S, H)
    position_ids: torch.Tensor,  # (B, S)
    segment_ids: Optional[torch.Tensor] = None,  # (B, S); 0 = padding
    attn_impl: str = "xla",
    collect_kv: bool = False,
    kv_quant: bool = False,
) -> Tuple[torch.Tensor, Optional[List]]:
    """Run the decoder stack; returns (final-normed hidden states, kv).

    With ``collect_kv`` the per-layer K/V of this pass come back as a list
    of ``(k, v)``; with ``kv_quant`` too, each is quantized per layer as it
    is collected (``((k_q, k_s), (v_q, v_s))``), so the full-precision K/V
    of a layer die with it.
    """
    x = inputs_embeds
    kv = [] if collect_kv else None
    for layer in model.model.layers:
        h = norm(x, layer.input_layernorm)
        attn_out, (k, v) = attention_block(h, layer.self_attn, cfg, position_ids, segment_ids, attn_impl)
        x = x + attn_out
        x = x + mlp_block(norm(x, layer.post_attention_layernorm), layer.mlp)
        if collect_kv:
            kv.append((quantize_kv(k), quantize_kv(v)) if kv_quant else (k, v))
    return norm(x, model.model.norm), kv


def logits(model: LlamaForCausalLM, hidden: torch.Tensor) -> torch.Tensor:
    """LM head in the hidden dtype, returned as fp32 (as the reference)."""
    return linear(hidden, model.lm_head.weight).float()
