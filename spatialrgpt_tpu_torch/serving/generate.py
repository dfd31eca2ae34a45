"""Autoregressive multimodal generation (port of
``spatialrgpt_tpu/serving/generate.py``): prefill over the right-padded
prompt batch, the first token, then a Python decode loop in lockstep
until every row stopped or ``max_new_tokens``.

Two KV caches, as the reference's ``kv_quant`` chooses:

- ``kv_quant=False`` (the default, as in the reference): ``llama.KVCache``
  in the activation dtype, (L, B, C, Hk, D); decode attends in plain
  PyTorch (``ops/attention.py::decode_attention`` with a length per row,
  the reference's ``_cached_attention``, which XLA runs there too);
- ``kv_quant=True``: int8, flat token-major per layer (``k_q, v_q`` (B, C,
  Hk*D) int8, ``k_s, v_s`` (B, C, Hk) f32, all layers stacked as one (L,
  ...) tensor each), the layout of the reference's serving engine and of
  kernel K3; with ``kv_bits=4`` the reference's opt-in int4 cache, the same
  with two nibbles a byte (``k_q, v_q`` (B, C, Hk*D/2), ``quantize_kv4``),
  read by K3's packed-int4 form.  The decode tells the two apart as the
  reference does: a payload row of Hk*D/2 bytes is packed.

Prefill writes the padded prompt into slots [0, S); row b's t-th new
token writes its K/V at its own position ``prompt_lengths[b] + t - 1``, so
the live keys of row b are exactly the slots ``<= lengths[b]``, K3's mask.
That is the key set and the RoPE positions of the reference's two-region
mask.  The cache is updated in place.  The per-row write and attention
(``_slot_attend``) are also the serving engine's decode step
(``serving/engine.py``), where each row is a slot.

``attn_impl="onepass"`` runs the three kernels (K1 in the tower, K2 in
prefill, K3 in int8-cache decode) on CUDA tensors; ``attn_impl="xla"``
runs their plain versions.

Parallel serving (``parallel/``):

- ``attn_impl`` "ring", "ulysses" or "hybrid" runs the prefill sequence
  parallel over the ambient ``SPContext``: every rank of the sp group
  holds the whole prompt batch, the decoder runs this rank's chunk of the
  sequence, and the hidden states and K/V are gathered back to the whole
  prompt, so decode runs on the replicated cached path (the kernels' route)
  as in the reference;
- a tensor-parallel model (``parallel/mesh.py::tp_shard_model``) runs its
  slice of the heads and neurons, both caches hold this rank's kv heads,
  and the decoder adds its partial sums up and gathers its logits
  (``models/llama.py``);
- an FSDP-sharded model (``parallel/mesh.py::shard_model``) is gathered
  whole for the call.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from spatialrgpt_tpu_torch.config import LlamaConfig, SpatialRGPTConfig
from spatialrgpt_tpu_torch.models import llama, vlm
from spatialrgpt_tpu_torch.ops.attention import decode_attention
from spatialrgpt_tpu_torch.ops.decode_attention import (
    decode_attention_int4_flat, decode_attention_int4_flat_plain, decode_attention_int8_flat,
    decode_attention_int8_flat_plain,
)
from spatialrgpt_tpu_torch.ops.layers import linear, qkv_proj
from spatialrgpt_tpu_torch.ops.quant import quantize_kv, quantize_kv4
from spatialrgpt_tpu_torch.parallel.context import SP_IMPLS, gather_sequence, seq_shard, sp_context
from spatialrgpt_tpu_torch.parallel.mesh import gathered


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # (B, max_new_tokens) int64, eos-padded
    num_generated: torch.Tensor  # (B,) int64
    first_logits: torch.Tensor  # (B, V) f32 logits of the first new token
    last_logits: torch.Tensor  # (B, V) f32 logits of the last step taken


class QuantKVCache(NamedTuple):
    """int8 (or packed int4) KV cache, flat token-major, all layers stacked."""

    k_q: torch.Tensor  # (L, B, C, Hk*D) int8, or (L, B, C, Hk*D/2) of packed int4
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


def new_quant_cache(llm: llama.LlamaForCausalLM, cfg: LlamaConfig, batch: int, capacity: int,
                    device, kv_bits: int = 8) -> QuantKVCache:
    """A zeroed int8 (``kv_bits=4``: packed int4) cache of ``batch`` rows and
    ``capacity`` positions for the decoder ``llm`` (whose whole config is
    ``cfg``): the kv heads of this rank's slice under tensor parallelism."""
    lc = llama.rank_cfg(llm, cfg)
    L, Hk, D = lc.num_hidden_layers, lc.num_key_value_heads, lc.head_dim
    F = Hk * D * kv_bits // 8
    return QuantKVCache(
        torch.zeros((L, batch, capacity, F), dtype=torch.int8, device=device),
        torch.zeros((L, batch, capacity, Hk), dtype=torch.float32, device=device),
        torch.zeros((L, batch, capacity, F), dtype=torch.int8, device=device),
        torch.zeros((L, batch, capacity, Hk), dtype=torch.float32, device=device),
    )


def _prefill(model, cfg: SpatialRGPTConfig, inputs: vlm.VLMInputs, prompt_lengths, capacity: int, attn_impl: str,
             kv_quant: bool, kv_bits: int = 8):
    """Spliced embeddings -> decoder over the padded prompt; returns the
    first-token logits (B, V) and the cache (int8, or packed int4 with
    ``kv_bits=4``, with ``kv_quant``, else in the activation dtype) with the
    prompt in slots [0, S).  A
    sequence-parallel ``attn_impl`` runs this rank's chunk and gathers the
    hidden states and the K/V of the whole prompt."""
    sp = attn_impl in SP_IMPLS
    embeds = vlm.prepare_embeds(model, cfg, inputs, "onepass" if sp else attn_impl)
    pos, seg = inputs.position_ids, inputs.segment_ids
    if sp:
        ctx = sp_context(attn_impl)
        embeds, pos, seg = (seq_shard(t, ctx) for t in (embeds, pos, seg))
    h, kv = llama.forward(
        model.llm, cfg.llm, inputs_embeds=embeds, position_ids=pos,
        segment_ids=seg, attn_impl=attn_impl, collect_kv=True, kv_quant=kv_quant and not sp, kv_bits=kv_bits,
    )
    if sp:
        h = gather_sequence(h, ctx)
        kv = [(gather_sequence(k, ctx), gather_sequence(v, ctx)) for k, v in kv]
        if kv_quant:
            qfn = quantize_kv4 if kv_bits == 4 else quantize_kv
            kv = [(qfn(k), qfn(v)) for k, v in kv]
    B, S = inputs.input_ids.shape
    dev = h.device
    if kv_quant:
        cache = new_quant_cache(model.llm, cfg.llm, B, capacity, dev, kv_bits)
        for li, ((kq, ks), (vq, vs)) in enumerate(kv):
            cache.k_q[li, :, :S] = kq.reshape(B, S, -1)
            cache.k_s[li, :, :S] = ks
            cache.v_q[li, :, :S] = vq.reshape(B, S, -1)
            cache.v_s[li, :, :S] = vs
    else:
        cache = llama.new_cache(model.llm, cfg.llm, B, capacity, kv[0][0].dtype, dev)
        for li, (k, v) in enumerate(kv):
            cache.k[li, :, :S] = k
            cache.v[li, :, :S] = v
    last = (prompt_lengths - 1).clamp(min=0)
    last_h = h[torch.arange(B, device=dev), last]
    return llama.logits(model.llm, last_h[:, None])[:, 0], cache


def _slot_attend(q, k, v, rows, pos, lengths32, cache: Union[QuantKVCache, llama.KVCache], li: int,
                 attn_impl: str) -> torch.Tensor:
    """Decode attention of one new token per row against layer ``li`` of
    either cache: q (B, Hq, D), k and v (B, Hk, D), all rotated, at
    positions ``pos`` (B,) int64 (``lengths32`` the same as int32, in [0,
    C)).  One K/V row is written per row b at ``pos[b]`` (an indexed store,
    not a pass over the cache; ``rows`` is ``arange(B)``), then the row
    attends to the positions ``<= pos[b]``; returns (B, Hq * D).

    The activation-dtype cache: ``decode_attention`` (plain PyTorch, the
    reference's ``_cached_attention``, which XLA runs there too).  The int8
    cache: K/V quantized per (row, head), then K3, the kernel with
    ``attn_impl="onepass"`` (its plain version on a CPU tensor), its plain
    version with ``"xla"``.  A packed-int4 cache (payload rows of Hk*D/2
    bytes, the reference's test at ``generate.py:349``) takes
    ``quantize_kv4`` and K3's int4 form."""
    B, Hq, D = q.shape
    Hk = k.shape[1]
    if not isinstance(cache, QuantKVCache):
        cache.k[li, rows, pos] = k.to(cache.k.dtype)
        cache.v[li, rows, pos] = v.to(cache.v.dtype)
        return decode_attention(q[:, None], cache.k[li], cache.v[li], pos + 1).reshape(B, Hq * D)
    packed4 = cache.k_q.shape[-1] * 2 == Hk * D
    qfn = quantize_kv4 if packed4 else quantize_kv
    nk_q, nk_s = qfn(k)  # (B, Hk, D or D/2), (B, Hk)
    nv_q, nv_s = qfn(v)
    cache.k_q[li, rows, pos] = nk_q.reshape(B, -1)
    cache.k_s[li, rows, pos] = nk_s
    cache.v_q[li, rows, pos] = nv_q.reshape(B, -1)
    cache.v_s[li, rows, pos] = nv_s
    if packed4:
        attend = decode_attention_int4_flat if attn_impl == "onepass" else decode_attention_int4_flat_plain
    else:
        attend = decode_attention_int8_flat if attn_impl == "onepass" else decode_attention_int8_flat_plain
    out = attend(q, cache.k_q[li], cache.k_s[li], cache.v_q[li], cache.v_s[li], lengths32, Hk)
    return out.reshape(B, Hq * D)


def _per_slot_attention(x, attn, lc, rows, pos, lengths32, cache: Union[QuantKVCache, llama.KVCache], li: int,
                        attn_impl: str) -> torch.Tensor:
    """A layer's decode attention of one new token per row, x (B, 1, H):
    q/k/v, RoPE at ``pos``, ``_slot_attend``, the output projection."""
    Hq, Hk, D = lc.num_attention_heads, lc.num_key_value_heads, lc.head_dim
    q, k, v = qkv_proj(x, attn, Hq, Hk, D)
    q, k = llama.apply_rope(q, k, pos[:, None], lc)
    out = _slot_attend(q[:, 0], k[:, 0], v[:, 0], rows, pos, lengths32, cache, li, attn_impl)
    return linear(out[:, None], attn.o_proj)


def _decode_step(model, cfg: SpatialRGPTConfig, x, lengths, cache: Union[QuantKVCache, llama.KVCache],
                 attn_impl: str):
    """One new token per row: x (B, 1, H) embeddings at positions
    ``lengths`` (B,); writes each row's K/V at slot ``lengths[b]`` and
    attends to slots ``<= lengths[b]`` (a sliding window is not applied
    here, as the reference's cached decode does not apply it).  Returns the
    final-normed hidden (B, 1, H).  A tensor-parallel decoder runs its
    slice and adds its partial sums up."""
    lc, tp = llama.rank_cfg(model.llm, cfg.llm), model.llm.tp
    rows = torch.arange(x.shape[0], device=x.device)
    pos = lengths.long()
    lengths32 = lengths.to(torch.int32)
    h = x
    for li, layer in enumerate(model.llm.model.layers):
        a = _per_slot_attention(llama.norm(h, layer.input_layernorm), layer.self_attn, lc, rows, pos, lengths32,
                                cache, li, attn_impl)
        h = h + llama.tp_sum(a, tp)
        h = h + llama.tp_sum(llama.ffn_block(llama.norm(h, layer.post_attention_layernorm), layer, lc)[0], tp)
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
    kv_quant: bool = False,  # the int8 KV cache (K3) instead of the activation-dtype cache
    kv_bits: int = 8,  # with kv_quant: 8, or 4 (packed nibbles, lossy; the reference's opt-in)
) -> GenerateResult:
    """Multimodal generate over a right-padded prompt batch.  A row stops
    after emitting eos, a stop id, or the last token of a stop sequence;
    it then emits eos padding.  ``attn_impl`` "ring" / "ulysses" /
    "hybrid": the sequence-parallel prefill, then the kernels' decode.
    ``kv_bits=4`` needs ``kv_quant`` and an even head dim (else
    ``ValueError``)."""
    if attn_impl not in ("onepass", "xla") + SP_IMPLS:
        raise ValueError(f"unknown attention impl: {attn_impl}")
    if kv_bits not in (8, 4):
        raise ValueError(f"kv_bits must be 8 or 4, got {kv_bits}")
    if kv_bits == 4 and not kv_quant:
        raise ValueError("kv_bits=4 is the quantized cache's form: pass kv_quant=True")
    if kv_bits == 4 and cfg.llm.head_dim % 2:
        raise ValueError(f"kv_bits=4 packs two values a byte along the head dim, which is odd ({cfg.llm.head_dim})")
    with gathered(model):
        return _generate(model, cfg, inputs, prompt_lengths, max_new_tokens, temperature, top_p, eos_token_id,
                         stop_token_ids, stop_sequences, generator, attn_impl, kv_quant, kv_bits)


def _generate(model, cfg, inputs, prompt_lengths, max_new_tokens, temperature, top_p, eos_token_id, stop_token_ids,
              stop_sequences, generator, attn_impl, kv_quant, kv_bits) -> GenerateResult:
    B, S = inputs.input_ids.shape
    dev = inputs.input_ids.device
    eos = cfg.llm.eos_token_id if eos_token_id is None else eos_token_id
    stops = torch.tensor((eos,) + tuple(stop_token_ids), dtype=torch.int64, device=dev)
    if generator is None and temperature != 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)
    prompt_lengths = prompt_lengths.to(device=dev, dtype=torch.int64)

    def is_stop(tok):
        return (tok[:, None] == stops[None, :]).any(dim=-1)

    first_logits, cache = _prefill(model, cfg, inputs, prompt_lengths, S + max_new_tokens, attn_impl, kv_quant,
                                   kv_bits)
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
        h = _decode_step(model, cfg, x, lengths, cache, "onepass" if attn_impl in SP_IMPLS else attn_impl)
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
