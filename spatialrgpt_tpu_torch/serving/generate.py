"""Autoregressive multimodal generation (port of
``spatialrgpt_tpu/serving/generate.py``): prefill over the right-padded
prompt batch, the first token, then a Python decode loop in lockstep
until every row stopped or ``max_new_tokens``.

The KV cache is int8 in one layout, flat token-major per layer
(``k_q, v_q`` (B, C, Hk*D) int8, ``k_s, v_s`` (B, C, Hk) f32, stored for
all layers as one (L, ...) tensor each) -- the layout of the reference's
serving engine and of kernel K3.  Prefill writes the padded prompt into
slots [0, S); row b's t-th new token writes its K/V at its own position
``prompt_lengths[b] + t - 1``, so the live keys of row b are exactly the
slots ``<= lengths[b]``, K3's mask.  That is the key set and the RoPE
positions of the reference's two-region mask.  The cache is updated in
place.  A full-precision cache (the reference's ``kv_quant=False``) is
not ported yet.

``attn_impl="onepass"`` runs the three kernels (K1 in the tower, K2 in
prefill, K3 in decode) on CUDA tensors; ``attn_impl="xla"`` runs their
plain versions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from spatialrgpt_tpu_torch.config import SpatialRGPTConfig
from spatialrgpt_tpu_torch.models import llama, vlm
from spatialrgpt_tpu_torch.ops.decode_attention import decode_attention_int8_flat, decode_attention_int8_flat_plain
from spatialrgpt_tpu_torch.ops.layers import linear, qkv_proj
from spatialrgpt_tpu_torch.ops.quant import quantize_kv


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # (B, max_new_tokens) int64, eos-padded
    num_generated: torch.Tensor  # (B,) int64
    first_logits: torch.Tensor  # (B, V) f32 logits of the first new token
    last_logits: torch.Tensor  # (B, V) f32 logits of the last step taken


class QuantKVCache(NamedTuple):
    """int8 KV cache, flat token-major, all layers stacked."""

    k_q: torch.Tensor  # (L, B, C, Hk*D) int8
    k_s: torch.Tensor  # (L, B, C, Hk) f32
    v_q: torch.Tensor
    v_s: torch.Tensor


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filter: keep tokens until the cumulative probability of the
    sorted distribution reaches ``top_p`` (always the top-1); the rest get
    -inf."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cumsum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    k = (cumsum < top_p).sum(dim=-1, keepdim=True)
    threshold = torch.gather(sorted_logits, -1, k)
    return torch.where(logits < threshold, torch.full_like(logits, -torch.inf), logits)


def _sample_token(
    logits: torch.Tensor,  # (B, V) fp32
    generator: Optional[torch.Generator],
    temperature: float,
    top_p: float,
) -> torch.Tensor:
    """Greedy if temperature == 0, else nucleus sampling from ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_p < 1.0:
        logits = top_p_filter(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _prefill(model, cfg: SpatialRGPTConfig, inputs: vlm.VLMInputs, prompt_lengths, capacity: int, attn_impl: str):
    """Spliced embeddings -> decoder over the padded prompt; returns the
    first-token logits (B, V) and the int8 cache with the prompt in slots
    [0, S)."""
    embeds = vlm.prepare_embeds(model, cfg, inputs, attn_impl)
    h, kv = llama.forward(
        model.llm, cfg.llm, inputs_embeds=embeds, position_ids=inputs.position_ids,
        segment_ids=inputs.segment_ids, attn_impl=attn_impl, collect_kv=True, kv_quant=True,
    )
    B, S = inputs.input_ids.shape
    L, Hk, D = cfg.llm.num_hidden_layers, cfg.llm.num_key_value_heads, cfg.llm.head_dim
    dev = h.device
    cache = QuantKVCache(
        torch.zeros((L, B, capacity, Hk * D), dtype=torch.int8, device=dev),
        torch.zeros((L, B, capacity, Hk), dtype=torch.float32, device=dev),
        torch.zeros((L, B, capacity, Hk * D), dtype=torch.int8, device=dev),
        torch.zeros((L, B, capacity, Hk), dtype=torch.float32, device=dev),
    )
    for li, ((kq, ks), (vq, vs)) in enumerate(kv):
        cache.k_q[li, :, :S] = kq.reshape(B, S, Hk * D)
        cache.k_s[li, :, :S] = ks
        cache.v_q[li, :, :S] = vq.reshape(B, S, Hk * D)
        cache.v_s[li, :, :S] = vs
    last = (prompt_lengths - 1).clamp(min=0)
    last_h = h[torch.arange(B, device=dev), last]
    return llama.logits(model.llm, last_h[:, None])[:, 0], cache


def _decode_step(model, cfg: SpatialRGPTConfig, x, lengths, cache: QuantKVCache, attn_impl: str):
    """One new token per row: x (B, 1, H) embeddings at positions
    ``lengths`` (B,) int64; writes each row's K/V at slot ``lengths[b]`` and
    attends to slots ``<= lengths[b]``.  Returns the final-normed hidden
    (B, 1, H)."""
    lc = cfg.llm
    Hq, Hk, D = lc.num_attention_heads, lc.num_key_value_heads, lc.head_dim
    B = x.shape[0]
    rows = torch.arange(B, device=x.device)
    lengths32 = lengths.to(torch.int32)
    attend = decode_attention_int8_flat if attn_impl == "onepass" else decode_attention_int8_flat_plain
    h = x
    for li, layer in enumerate(model.llm.model.layers):
        hn = llama.norm(h, layer.input_layernorm)
        q, k, v = qkv_proj(hn, layer.self_attn, Hq, Hk, D)
        q, k = llama.apply_rope(q, k, lengths[:, None], lc)
        nk_q, nk_s = quantize_kv(k[:, 0])  # (B, Hk, D), (B, Hk)
        nv_q, nv_s = quantize_kv(v[:, 0])
        cache.k_q[li, rows, lengths] = nk_q.reshape(B, Hk * D)
        cache.k_s[li, rows, lengths] = nk_s
        cache.v_q[li, rows, lengths] = nv_q.reshape(B, Hk * D)
        cache.v_s[li, rows, lengths] = nv_s
        out = attend(q[:, 0], cache.k_q[li], cache.k_s[li], cache.v_q[li], cache.v_s[li], lengths32, Hk)
        h = h + linear(out.reshape(B, 1, Hq * D), layer.self_attn.o_proj)
        h = h + llama.mlp_block(llama.norm(h, layer.post_attention_layernorm), layer.mlp)
    return llama.norm(h, model.llm.model.norm)


@torch.no_grad()
def generate(
    model: vlm.SpatialRGPT,
    cfg: SpatialRGPTConfig,
    inputs: vlm.VLMInputs,
    prompt_lengths: torch.Tensor,  # (B,) true prompt length per row
    *,
    max_new_tokens: int = 128,
    temperature: float = 0.0,
    top_p: float = 1.0,
    eos_token_id: Optional[int] = None,
    stop_token_ids: tuple = (),  # extra single-token stop ids
    stop_sequences: tuple = (),  # tuple of tuples: multi-token stop sequences
    generator: Optional[torch.Generator] = None,
    attn_impl: str = "onepass",
) -> GenerateResult:
    """Multimodal generate over a right-padded prompt batch.  A row stops
    after emitting eos, a stop id, or the last token of a stop sequence;
    it then emits eos padding."""
    if attn_impl not in ("onepass", "xla"):
        raise ValueError(f"unknown attention impl: {attn_impl}")
    B, S = inputs.input_ids.shape
    dev = inputs.input_ids.device
    eos = cfg.llm.eos_token_id if eos_token_id is None else eos_token_id
    stops = torch.tensor((eos,) + tuple(stop_token_ids), dtype=torch.int64, device=dev)
    if generator is None and temperature != 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)
    prompt_lengths = prompt_lengths.to(device=dev, dtype=torch.int64)

    def is_stop(tok):
        return (tok[:, None] == stops[None, :]).any(dim=-1)

    first_logits, cache = _prefill(model, cfg, inputs, prompt_lengths, S + max_new_tokens, attn_impl)
    logits = first_logits
    tok = _sample_token(logits, generator, temperature, top_p)
    tokens = torch.full((B, max_new_tokens), eos, dtype=torch.int64, device=dev)
    tokens[:, 0] = tok
    done = is_stop(tok)
    for seq in stop_sequences:
        if len(seq) == 1:
            done |= tok == seq[0]

    vocab = model.llm.model.embed_tokens.num_embeddings
    t = 1
    while t < max_new_tokens and not bool(done.all()):
        # a stopped row feeds back its eos padding, which may be a sentinel
        # such as -1; its outputs are discarded, so any in-range id will do
        x = llama.embed_tokens(model.llm, tokens[:, t - 1 : t].clamp(0, vocab - 1))
        lengths = prompt_lengths + t - 1  # this token's position and cache slot
        h = _decode_step(model, cfg, x, lengths, cache, attn_impl)
        logits = llama.logits(model.llm, h)[:, 0]
        tok = _sample_token(logits, generator, temperature, top_p)
        tok = torch.where(done, torch.full_like(tok, eos), tok)
        tokens[:, t] = tok
        done |= is_stop(tok)
        for seq in stop_sequences:
            L = len(seq)
            if L > max_new_tokens:
                continue
            if L == 1:
                done |= tok == seq[0]
            elif t >= L - 1:
                window = tokens[:, t - L + 1 : t + 1]
                done |= (window == torch.tensor(seq, dtype=torch.int64, device=dev)[None]).all(dim=1)
        t += 1

    is_eos = tokens == eos
    any_eos = is_eos.any(dim=-1)
    num = torch.clamp(torch.argmax(is_eos.to(torch.int32), dim=-1) + any_eos, max=max_new_tokens)
    num = torch.where(any_eos, num, torch.full_like(num, max_new_tokens))
    return GenerateResult(tokens=tokens, num_generated=num, first_logits=first_logits, last_logits=logits)
