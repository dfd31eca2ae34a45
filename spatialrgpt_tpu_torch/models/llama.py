"""Llama-family decoder (port of ``spatialrgpt_tpu/models/llama.py``) for
every preset of ``config.py``: GQA, rotate-half RoPE with linear scaling,
RMSNorm and a SiLU MLP (Llama, Sheared-LLaMA), Mistral's sliding window,
Gemma's knobs (GeLU-tanh MLP, ``1 + w`` norms, embeddings scaled by
sqrt(hidden), an explicit head dim, the head tied to the embedding table)
and Mixtral's MoE FFN (a router and ``num_experts`` SiLU experts under HF
Mixtral's names, ``block_sparse_moe.gate`` and ``experts.{e}.w1/w3/w2``);
q/k/v may carry biases (``attention_bias``).

Parameters live in ``LlamaForCausalLM`` under the HF names that
``spatialrgpt_tpu/utils/export.py::export_llama`` writes
(``model.layers.{i}.self_attn.q_proj.weight``, ...).  The embedding table
includes the extra ``<mask>``/``<depth>`` rows past ``vocab_size``.  A
quantized model (``ops/layers.py::quantize_model``,
``utils/weights.py::init_random_quantized``) holds ``QuantLinear``s in
place of the projections and ``lm_head``; the blocks hand each module to
``linear`` as it is.

``KVCache`` is the bf16 (activation-dtype) cache of the reference
(``llama.py:135-147``), its layers stacked: k and v (L, B, C, Hk, D).
``forward(cache=...)`` runs the new tokens against it, written in place at
``[length, length + S)``: the reference's incremental prefill, which the
serving engine's prefix path uses.

The MoE block runs densely by default, as the reference's ``_moe_block``
(every expert on every token, gated by the top-k router weights; a tie at
the k-th probability keeps every tied expert), or, with ``moe_impl =
"sparse"`` and experts stacked by ``stack_experts``, top-k routed over
contiguous expert slices (``moe_block_sparse``).  Both return the
router's load-balancing aux loss; ``forward(..., with_aux=True)`` sums it,
over the whole step's tokens when the ranks of a process group share them
out (``router_aux``).

The sliding window binds in every prefill route (``causal_attention``);
attention against a cache (decode, incremental prefill) ignores it, as the
reference's ``decode_attention`` does.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from spatialrgpt_tpu_torch.config import LlamaConfig
from spatialrgpt_tpu_torch.ops.attention import causal_attention, decode_attention
from spatialrgpt_tpu_torch.ops.layers import (
    QuantLinear, gelu_tanh, linear, matmul_f32, qkv_proj, quantized_input, rms_norm, silu,
)
from spatialrgpt_tpu_torch.ops.quant import quantize_kv, quantize_kv4

ACTIVATIONS = {"silu": silu, "gelu_tanh": gelu_tanh}
MOE_IMPLS = ("dense", "sparse")


def check_supported(cfg: LlamaConfig) -> None:
    """Raise ``NotImplementedError`` for a knob of ``LlamaConfig`` that the
    port does not run."""
    if cfg.hidden_act not in ACTIVATIONS:
        raise NotImplementedError(f"llama hidden_act {cfg.hidden_act!r} is not ported (of {sorted(ACTIVATIONS)})")
    if cfg.is_moe and cfg.moe_impl not in MOE_IMPLS:
        raise NotImplementedError(f"llama moe_impl {cfg.moe_impl!r} is not ported (of {MOE_IMPLS})")


class RMSNorm(nn.RMSNorm):
    """``nn.RMSNorm``'s weight under its HF name; ``plus_one`` (Gemma)
    scales by ``1 + weight``."""

    def __init__(self, size: int, eps: float, plus_one: bool = False, dtype=None):
        super().__init__(size, eps=eps, dtype=dtype)
        self.plus_one = plus_one


class LlamaAttention(nn.Module):
    qkv_fusable = True  # served by qkv_proj: fuse_serving_kernels may fuse q/k/v into wqkv

    def __init__(self, cfg: LlamaConfig, dtype=None):
        super().__init__()
        h, d, bias = cfg.hidden_size, cfg.head_dim, cfg.attention_bias
        self.q_proj = nn.Linear(h, cfg.num_attention_heads * d, bias=bias, dtype=dtype)
        self.k_proj = nn.Linear(h, cfg.num_key_value_heads * d, bias=bias, dtype=dtype)
        self.v_proj = nn.Linear(h, cfg.num_key_value_heads * d, bias=bias, dtype=dtype)
        self.o_proj = nn.Linear(cfg.num_attention_heads * d, h, bias=False, dtype=dtype)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=None):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(h, i, bias=False, dtype=dtype)
        self.up_proj = nn.Linear(h, i, bias=False, dtype=dtype)
        self.down_proj = nn.Linear(i, h, bias=False, dtype=dtype)
        self.act = cfg.hidden_act


class MixtralExpert(nn.Module):
    """One SiLU expert under HF Mixtral's names: w1 gate, w3 up, w2 down."""

    def __init__(self, cfg: LlamaConfig, dtype=None):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.w1 = nn.Linear(h, i, bias=False, dtype=dtype)
        self.w3 = nn.Linear(h, i, bias=False, dtype=dtype)
        self.w2 = nn.Linear(i, h, bias=False, dtype=dtype)


class MixtralSparseMoe(nn.Module):
    """HF Mixtral's ``block_sparse_moe``: the router ``gate`` (hidden ->
    num_experts) and the experts.  ``stacked`` holds (w1, w3, w2) of all
    experts as (E, out, in) tensors once ``stack_experts`` ran (the experts'
    weights are then views of them), else None."""

    def __init__(self, cfg: LlamaConfig, dtype=None):
        super().__init__()
        self.gate = nn.Linear(cfg.hidden_size, cfg.num_experts, bias=False, dtype=dtype)
        self.experts = nn.ModuleList(MixtralExpert(cfg, dtype) for _ in range(cfg.num_experts))
        self.stacked: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=None):
        super().__init__()
        self.self_attn = LlamaAttention(cfg, dtype)
        if cfg.is_moe:
            self.block_sparse_moe = MixtralSparseMoe(cfg, dtype)
        else:
            self.mlp = LlamaMLP(cfg, dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.norm_plus_one, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.norm_plus_one, dtype)

    def forward(self, x, cfg, position_ids, segment_ids, attn_impl, cache=None, layer_idx=0, tp=None,
                aux_group=None):
        """``decoder_layer`` on this layer, as a module call (FSDP gathers a
        sharded layer's parameters around it)."""
        return decoder_layer(x, self, cfg, position_ids, segment_ids, attn_impl, cache, layer_idx, tp, aux_group)


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, extra_vocab: int = 0, dtype=None):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size + extra_vocab, cfg.hidden_size, dtype=dtype)
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg, dtype) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.norm_plus_one, dtype)


class LlamaForCausalLM(nn.Module):
    """The decoder and its head; ``lm_head`` is None where the head is tied
    to the embedding table (``tie_word_embeddings``, Gemma).  ``cfg`` is
    kept for ``embed_tokens`` and ``logits``.  A tensor-parallel decoder
    (``parallel/mesh.py::tp_shard_model``) holds its group as ``tp``; the
    config of its slice is ``rank_cfg``'s."""

    tp = None

    def __init__(self, cfg: LlamaConfig, extra_vocab: int = 0, dtype=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.model = LlamaModel(cfg, extra_vocab, dtype)
        self.lm_head = None if cfg.tie_word_embeddings else nn.Linear(
            cfg.hidden_size, cfg.vocab_size + extra_vocab, bias=False, dtype=dtype)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Static-shape KV cache in the activation dtype, all layers stacked,
    and the fill length its next tokens are written at."""

    k: torch.Tensor  # (L, B, C, Hk, D)
    v: torch.Tensor  # (L, B, C, Hk, D)
    length: int

    @staticmethod
    def init(cfg: LlamaConfig, batch: int, capacity: int, dtype=torch.bfloat16, device=None) -> "KVCache":
        shape = (cfg.num_hidden_layers, batch, capacity, cfg.num_key_value_heads, cfg.head_dim)
        zeros = torch.zeros(shape, dtype=dtype, device=device)
        return KVCache(zeros, torch.zeros_like(zeros), 0)


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


def norm(x: torch.Tensor, module: RMSNorm) -> torch.Tensor:
    """RMSNorm; Gemma's ``1 + w`` is formed in f32 and, like any scale, cast
    to x's dtype by ``rms_norm`` (the reference's ``_norm``)."""
    w = module.weight
    if module.plus_one:
        w = 1.0 + w.float()
    return rms_norm(x, w, module.eps)


def attention_block(
    x: torch.Tensor,
    attn: LlamaAttention,
    cfg: LlamaConfig,
    position_ids: torch.Tensor,
    segment_ids: Optional[torch.Tensor],
    impl: str,
    cache: Optional[KVCache] = None,
    layer_idx: int = 0,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Prefill attention over the whole (padded) prompt; returns the output
    and this layer's rotated K and V (B, S, Hk, D).  With ``cache`` the
    new K/V go into layer ``layer_idx`` of the cache at ``[length, length
    + S)`` and the tokens attend to the cache (``decode_attention``)."""
    B, S, _ = x.shape
    Hq, Hk, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    q, k, v = qkv_proj(x, attn, Hq, Hk, D)
    q, k = apply_rope(q, k, position_ids, cfg)
    if cache is not None:
        end = cache.length + S
        cache.k[layer_idx, :, cache.length : end] = k.to(cache.k.dtype)
        cache.v[layer_idx, :, cache.length : end] = v.to(cache.v.dtype)
        out = decode_attention(q, cache.k[layer_idx], cache.v[layer_idx], end)
    else:
        out = causal_attention(q, k, v, segment_ids=segment_ids, impl=impl, window=cfg.sliding_window)
    return linear(out.reshape(B, S, Hq * D), attn.o_proj), (k, v)


def _ffn(x: torch.Tensor, gate: nn.Module, up: nn.Module, down: nn.Module, act: str, xq=None) -> torch.Tensor:
    """down(act(gate(x)) * up(x)); ``xq``: x's int8 rows where gate and up
    (and their siblings) take W8A8."""
    h = ACTIVATIONS[act](linear(x, gate, xq=xq))
    return linear(h * linear(x, up, xq=xq), down)


def mlp_block(x: torch.Tensor, mlp: LlamaMLP) -> torch.Tensor:
    """The dense MLP (SiLU, or Gemma's GeLU-tanh); gate and up share x's
    int8 rows where they take W8A8, or are one product where
    ``fuse_serving_kernels`` fused them into ``gu`` (the reference's
    ``llama.py:190-193``)."""
    if hasattr(mlp, "gu"):
        gate, up = linear(x, mlp.gu).chunk(2, dim=-1)
        return linear(ACTIVATIONS[mlp.act](gate) * up, mlp.down_proj)
    return _ffn(x, mlp.gate_proj, mlp.up_proj, mlp.down_proj, mlp.act,
                quantized_input(x, mlp.gate_proj, mlp.up_proj))


def router_gates(x: torch.Tensor, moe: MixtralSparseMoe, cfg: LlamaConfig, xq=None):
    """(f32 softmax probabilities, f32 gates), each (..., E): the dense
    block's gate keeps every expert whose probability reaches the k-th
    largest (so a tie there keeps more than k), renormalised."""
    probs = torch.softmax(linear(x, moe.gate, xq=xq).float(), dim=-1)
    kth = torch.topk(probs, cfg.num_experts_per_tok, dim=-1).values[..., -1:]
    gates = torch.where(probs >= kth, probs, torch.zeros_like(probs))
    return probs, gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)


def router_aux(frac_tokens: torch.Tensor, mean_probs: torch.Tensor, cfg: LlamaConfig, group=None) -> torch.Tensor:
    """The switch-style aux loss E * sum_e f_e P_e of one MoE layer from
    its per-expert means over this rank's tokens: f, the share of tokens
    routed to each expert, and P, the mean router probability.  ``group``:
    the ranks that share out the step's tokens in equal parts (the data and
    sequence-parallel ranks of a train step), over which both means are
    averaged first, so that every rank holds the aux of the whole step, as
    the reference takes it over its global arrays.  The average's backward
    is the identity: a rank's P enters the global mean with weight 1 /
    world, and the ranks' gradients are summed."""
    stats = torch.stack([frac_tokens, mean_probs])
    if group is not None:
        from spatialrgpt_tpu_torch.parallel.comm import AllReduceSum, group_size

        stats = AllReduceSum.apply(stats, group) / group_size(group)
    return cfg.num_experts * (stats[0] * stats[1]).sum()


def moe_block(x: torch.Tensor, moe: MixtralSparseMoe, cfg: LlamaConfig, aux_group=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's dense ``_moe_block``: every expert on every token,
    weighted by ``router_gates``, the outputs added in expert order in x's
    dtype; returns (output, the switch-style aux loss, ``router_aux`` over
    ``aux_group``).  The router and every expert's gate and up read x's
    int8 rows once where any of them takes W8A8."""
    experts = moe.experts
    xq = quantized_input(x, moe.gate, *(e.w1 for e in experts), *(e.w3 for e in experts))
    probs, gates = router_gates(x, moe, cfg, xq)
    out = torch.zeros_like(x)
    for i, e in enumerate(experts):
        out = out + _ffn(x, e.w1, e.w3, e.w2, "silu", xq) * gates[..., i : i + 1].to(x.dtype)
    return out, router_aux((gates > 0).float().mean(dim=(0, 1)), probs.mean(dim=(0, 1)), cfg, aux_group)


@torch.no_grad()
def stack_experts(model: LlamaForCausalLM) -> LlamaForCausalLM:
    """In place: every MoE layer's expert weights into (E, out, in) tensors
    (``MixtralSparseMoe.stacked``, one copy), each expert's weight a view of
    them, so the dense block still runs; the sparse block's form of the
    reference's ``stack_experts``.  Float experts only (the reference stacks
    ``kernel`` entries, and ``quantize_llm`` leaves none)."""
    for layer in model.model.layers:
        moe = getattr(layer, "block_sparse_moe", None)
        if moe is None:
            continue
        if any(isinstance(m, QuantLinear) for m in moe.experts.modules()):
            raise NotImplementedError("stack_experts: the sparse MoE takes float experts (a quantized model's "
                                      "experts run on the dense block)")
        stacked = []
        for name in ("w1", "w3", "w2"):
            w = torch.stack([getattr(e, name).weight for e in moe.experts])
            for i, e in enumerate(moe.experts):
                getattr(e, name).weight = nn.Parameter(w[i], requires_grad=False)
            stacked.append(w)
        moe.stacked = tuple(stacked)
    return model


def _grouped_f32(xs: torch.Tensor, w: torch.Tensor, sizes: List[int]) -> torch.Tensor:
    """Rows of xs in contiguous expert groups of ``sizes`` times their
    expert's (out, in) slice of ``w`` (E, out, in): f32 sums of xs-dtype
    products, f32 (rows, out) (``lax.ragged_dot`` with f32 output)."""
    out = xs.new_empty((xs.shape[0], w.shape[1]), dtype=torch.float32)
    lo = 0
    for e, n in enumerate(sizes):
        if n:
            out[lo : lo + n] = matmul_f32(xs[lo : lo + n], w[e].to(xs.dtype))
        lo += n
    return out


def moe_block_sparse(x: torch.Tensor, moe: MixtralSparseMoe, cfg: LlamaConfig, aux_group=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_moe_block_sparse``: each token copied per top-k
    choice, the copies sorted stably by expert, every expert's contiguous
    slice through its (gate, up, down) with f32 sums, the outputs weighted
    and index-added in f32; the aux loss as the dense block's.  Without
    stacked experts it is the dense block."""
    if moe.stacked is None:
        return moe_block(x, moe, cfg, aux_group)
    B, S, H = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    probs = torch.softmax(linear(x, moe.gate).float().reshape(T, E), dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)
    gates = top_p / top_p.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    token_idx = order // K
    xs = x.reshape(T, H)[token_idx]
    sizes = torch.bincount(flat_e, minlength=E).tolist()
    w1, w3, w2 = moe.stacked
    mid = (F.silu(_grouped_f32(xs, w1, sizes)) * _grouped_f32(xs, w3, sizes)).to(x.dtype)
    outs = _grouped_f32(mid, w2, sizes) * gates.reshape(-1)[order][:, None]
    combined = torch.zeros((T, H), dtype=torch.float32, device=x.device).index_add_(0, token_idx, outs)
    sel = F.one_hot(top_e, E).float().sum(dim=1)
    return combined.to(x.dtype).reshape(B, S, H), router_aux(sel.mean(dim=0), probs.mean(dim=0), cfg, aux_group)


def ffn_block(x: torch.Tensor, layer: LlamaDecoderLayer, cfg: LlamaConfig, aux_group=None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A layer's FFN over its normed input: (output, MoE aux loss or None)."""
    if not cfg.is_moe:
        return mlp_block(x, layer.mlp), None
    block = moe_block_sparse if cfg.moe_impl == "sparse" else moe_block
    return block(x, layer.block_sparse_moe, cfg, aux_group)


def tp_sum(y: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel projection's partial sums added over the
    tensor-parallel group (the all-reduce GSPMD puts after wo and down in
    the reference); y itself without a group."""
    if tp is None:
        return y
    from spatialrgpt_tpu_torch.parallel.comm import AllReduceSum

    return AllReduceSum.apply(y, tp.group)


def tp_slice_cfg(cfg: LlamaConfig, n: int) -> LlamaConfig:
    """The config of one rank's slice of a decoder split over n
    tensor-parallel ranks: Hq / n and Hk / n heads of the same head dim and
    intermediate / n neurons (the vocab is kept: the head's slices are
    gathered to the whole vocab)."""
    for what, width in (("query heads", cfg.num_attention_heads), ("kv heads", cfg.num_key_value_heads),
                        ("the intermediate size", cfg.intermediate_size)):
        if width % n:
            raise ValueError(f"tp={n} must divide {what} ({width})")
    return dataclasses.replace(cfg, num_attention_heads=cfg.num_attention_heads // n,
                               num_key_value_heads=cfg.num_key_value_heads // n,
                               intermediate_size=cfg.intermediate_size // n, explicit_head_dim=cfg.head_dim)


def rank_cfg(model: LlamaForCausalLM, cfg: LlamaConfig) -> LlamaConfig:
    """The config this rank's slice of the decoder runs: ``tp_slice_cfg``
    under tensor parallelism, else ``cfg``.  Callers hand ``forward``, the
    cache builders (``new_cache``, ``serving/generate.py::new_quant_cache``)
    and the decode step the model's whole config; those read the rank's
    widths here, and nowhere else."""
    return cfg if model.tp is None else tp_slice_cfg(cfg, model.tp.size)


def new_cache(model: LlamaForCausalLM, cfg: LlamaConfig, batch: int, capacity: int, dtype=torch.bfloat16,
              device=None) -> KVCache:
    """A zeroed ``KVCache`` for ``model`` (whose whole config is ``cfg``):
    the kv heads of this rank's slice under tensor parallelism."""
    return KVCache.init(rank_cfg(model, cfg), batch, capacity, dtype, device)


def embed_tokens(model: LlamaForCausalLM, input_ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows; Gemma scales them by sqrt(hidden), the scalar rounded
    to the table's dtype first (the reference's ``embed_tokens``).  The
    scalar is filled on the device (no copy from the host), so a CUDA
    graph can capture the product."""
    x = F.embedding(input_ids, model.model.embed_tokens.weight)
    if model.cfg.scale_embeddings:
        x = x * torch.full((), model.cfg.hidden_size**0.5, dtype=x.dtype, device=x.device)
    return x


def decoder_layer(
    x: torch.Tensor,
    layer: LlamaDecoderLayer,
    cfg: LlamaConfig,
    position_ids: torch.Tensor,
    segment_ids: Optional[torch.Tensor],
    attn_impl: str,
    cache: Optional[KVCache] = None,
    layer_idx: int = 0,
    tp=None,
    aux_group=None,
):
    """One pre-norm decoder layer; returns (x, this layer's (k, v), its MoE
    aux loss or None).  ``tp``: the layer's tensor-parallel group, whose
    partial sums after wo and after the FFN are added up; ``aux_group``:
    the ranks the aux loss is taken over (``router_aux``)."""
    h = norm(x, layer.input_layernorm)
    attn_out, kv = attention_block(h, layer.self_attn, cfg, position_ids, segment_ids, attn_impl, cache, layer_idx)
    x = x + tp_sum(attn_out, tp)
    out, aux = ffn_block(norm(x, layer.post_attention_layernorm), layer, cfg, aux_group)
    return x + tp_sum(out, tp), kv, aux


def _layer_checkpointed(x, layer, cfg, position_ids, segment_ids, attn_impl, tp, aux_group=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decoder layer as ``torch.utils.checkpoint`` runs it: (x, the MoE
    aux loss, an f32 zero without MoE); the K/V are not kept."""
    x, _, aux = layer(x, cfg, position_ids, segment_ids, attn_impl, tp=tp, aux_group=aux_group)
    return x, aux if aux is not None else x.new_zeros((), dtype=torch.float32)


def _token_group():
    """Every rank of the process group when there are several, else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def forward(
    model: LlamaForCausalLM,
    cfg: LlamaConfig,
    *,
    inputs_embeds: torch.Tensor,  # (B, S, H)
    position_ids: torch.Tensor,  # (B, S)
    segment_ids: Optional[torch.Tensor] = None,  # (B, S); 0 = padding
    cache: Optional[KVCache] = None,
    attn_impl: str = "xla",
    collect_kv: bool = False,
    kv_quant: bool = False,
    kv_bits: int = 8,
    remat: bool = False,
    with_aux: bool = False,
):
    """Run the decoder stack; returns (final-normed hidden states, kv), and
    with ``with_aux`` the summed MoE router aux loss (f32, 0 without MoE)
    as a third value.  In a process group of several ranks each layer's aux
    is taken over every rank's tokens (``router_aux``): the ranks then hold
    equal shares of one step's tokens, as a train step's data and
    sequence-parallel ranks do.

    With ``cache`` the tokens are written into it in place and attend to
    it (segment ids and ``attn_impl`` are not used); the second value is
    then the cache with its length advanced by S.

    With ``collect_kv`` the per-layer K/V of this pass come back as a list
    of ``(k, v)``; with ``kv_quant`` too, each is quantized per layer as it
    is collected (``((k_q, k_s), (v_q, v_s))``: int8, or with ``kv_bits=4``
    two int4 nibbles a byte along D), so the full-precision K/V of a layer
    die with it.

    With ``remat`` (and no KV collection) each layer runs under
    ``torch.utils.checkpoint``: only its input is kept, and the backward
    runs the layer's forward again (the reference's per-layer
    ``jax.checkpoint``, llama.py:362-371).  The attention kernel's forward
    therefore launches twice per layer in a training step.  A checkpointed
    MoE layer returns its aux loss beside its output, so the sum is the
    one the unchecked layers give, and its gradient reaches the router
    through the recompute.

    Each layer runs as a module call (``LlamaDecoderLayer.forward``), so an
    FSDP-sharded layer is gathered around it; a tensor-parallel decoder
    runs its slice (``rank_cfg``) and adds its partial sums up.
    """
    x = inputs_embeds
    cfg, tp = rank_cfg(model, cfg), model.tp
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    aux_group = _token_group() if with_aux else None
    if cache is not None:
        for li, layer in enumerate(model.model.layers):
            x, _, aux = layer(x, cfg, position_ids, None, attn_impl, cache, li, tp, aux_group)
            aux_total = aux_total if aux is None else aux_total + aux
        out = norm(x, model.model.norm), cache._replace(length=cache.length + x.shape[1])
        return out + (aux_total,) if with_aux else out
    kv = [] if collect_kv else None
    qfn = quantize_kv4 if kv_bits == 4 else quantize_kv
    for layer in model.model.layers:
        if remat and not collect_kv:
            x, aux = checkpoint(_layer_checkpointed, x, layer, cfg, position_ids, segment_ids, attn_impl, tp,
                                aux_group, use_reentrant=False)
            aux_total = aux_total + aux
            continue
        x, (k, v), aux = layer(x, cfg, position_ids, segment_ids, attn_impl, tp=tp, aux_group=aux_group)
        aux_total = aux_total if aux is None else aux_total + aux
        if collect_kv:
            kv.append((qfn(k), qfn(v)) if kv_quant else (k, v))
    out = norm(x, model.model.norm), kv
    return out + (aux_total,) if with_aux else out


def logits(model: LlamaForCausalLM, hidden: torch.Tensor) -> torch.Tensor:
    """LM head in the hidden dtype, returned as fp32 (as the reference).  A
    tied head is the embedding table (its extra rows included) in the
    hidden dtype, with f32 sums and an f32 result, never rounded to the
    hidden dtype (the reference's ``logits``, a product outside any
    kernel).  A tensor-parallel head holds a slice of the vocab: the
    slices are gathered (the reference's logits all-gather)."""
    if model.lm_head is None:
        w = model.model.embed_tokens.weight.to(hidden.dtype)
        return matmul_f32(hidden.reshape(-1, hidden.shape[-1]), w).reshape(*hidden.shape[:-1], w.shape[0])
    y = linear(hidden, model.lm_head).float()
    if model.tp is None:
        return y
    from spatialrgpt_tpu_torch.parallel.comm import GatherLastDim

    return GatherLastDim.apply(y, model.tp.group)[..., : model.model.embed_tokens.num_embeddings]


def forward_logits(model: LlamaForCausalLM, cfg: LlamaConfig, *, input_ids: torch.Tensor, position_ids: torch.Tensor,
                   segment_ids: Optional[torch.Tensor] = None, attn_impl: str = "xla") -> torch.Tensor:
    """Token ids -> f32 logits (B, S, V), no cache (the reference's
    convenience of ``llama.py:401``)."""
    h, _ = forward(model, cfg, inputs_embeds=embed_tokens(model, input_ids), position_ids=position_ids,
                   segment_ids=segment_ids, attn_impl=attn_impl)
    return logits(model, h)
