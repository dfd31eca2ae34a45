"""Prefill attention with interchangeable implementations (port of
``spatialrgpt_tpu/ops/attention.py::causal_attention``).

``impl="xla"`` is the plain path: masked softmax in plain PyTorch, the
twin of the reference's XLA path (its function is exactly the plain
version of kernel K2).  ``impl="onepass"`` runs kernel K2
(``ops/prefill_attention.py``) on CUDA tensors and the plain path on CPU
tensors, as the reference runs its Pallas kernel on a TPU and XLA
elsewhere.  ``impl="pallas"`` (the training path, the name
``train/args.py`` uses) runs kernel K4 (``ops/flash_attention.py``,
differentiable) on CUDA tensors and K4's plain versions on CPU tensors.
``impl`` "ulysses", "ring" and "hybrid" are the sequence-parallel routes
of ``parallel/`` over the groups of the ambient ``SPContext``
(``_sp_attention``).  Any other ``impl`` raises.  ``window`` (key j is
live for query i only if i - j < window) goes to every single-device
route, as in the reference, whose sequence-parallel routes do not take it.

``decode_attention`` is the attention of new tokens against a KV cache in
the activation dtype (``models/llama.py::forward(cache=...)``, the
engine's prefix path; with one length per row, the decode step of
``serving/generate.py`` and of the engine): plain PyTorch, as the
reference runs it in XLA.  So is ``streamed_position_attention``, the
chunk side of the serving engine's fused mixed-batch chunked prefill.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from spatialrgpt_tpu_torch.ops.flash_attention import flash_attention
from spatialrgpt_tpu_torch.ops.prefill_attention import onepass_attention, onepass_attention_plain


def causal_attention(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, S, Hk, D)
    v: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,  # (B, S), 0 = padding
    impl: str = "xla",
    window: Optional[int] = None,  # sliding-window attention (mistral)
) -> torch.Tensor:
    if impl == "pallas":
        return flash_attention(q, k, v, segment_ids=segment_ids, window=window)
    if impl == "onepass":
        return onepass_attention(q, k, v, segment_ids=segment_ids, window=window)
    if impl == "xla":
        return onepass_attention_plain(q, k, v, segment_ids=segment_ids, window=window)
    if impl in ("ulysses", "ring", "hybrid"):
        return _sp_attention(q, k, v, segment_ids, impl)
    raise ValueError(f"unknown attention impl: {impl}")


def _sp_attention(q, k, v, segment_ids, impl: str) -> torch.Tensor:
    """Sequence-parallel attention over the groups of the ambient
    ``SPContext`` (``parallel/context.py``).  The inputs are this rank's
    chunk of the sequence: the caller slices it (``seq_shard``; the
    reference's ``shard_map`` over the global arrays does the slicing
    there), ring-major for ``hybrid``."""
    from spatialrgpt_tpu_torch.parallel.context import sp_context

    ctx = sp_context(impl)
    if impl == "hybrid":
        from spatialrgpt_tpu_torch.parallel.hybrid import hybrid_attention

        return hybrid_attention(q, k, v, segment_ids, ctx.group(ctx.ulysses_axis), ctx.group(ctx.ring_axis))
    if impl == "ulysses":
        from spatialrgpt_tpu_torch.parallel.ulysses import ulysses_attention

        return ulysses_attention(q, k, v, segment_ids, ctx.group(ctx.ulysses_axis), impl=ctx.inner_impl)
    from spatialrgpt_tpu_torch.parallel.ring import ring_attention

    return ring_attention(q, k, v, segment_ids, group=ctx.group(ctx.ring_axis))


NEG_INF = -1e30


def decode_attention(
    q: torch.Tensor,  # (B, S, Hq, D): S new tokens, usually 1
    k_cache: torch.Tensor,  # (B, C, Hk, D), already holding the new tokens' keys
    v_cache: torch.Tensor,  # (B, C, Hk, D)
    kv_length: Union[int, torch.Tensor],  # live cache length, the new tokens included: () or (B,)
) -> torch.Tensor:
    """New token i (global position ``kv_length - S + i``, per row where
    ``kv_length`` is (B,)) attends to the cache positions up to its own
    (the reference's ``ops/attention.py::decode_attention``; per row, its
    ``_cached_attention`` and engine ``_slot_attend``).  GQA in the grouped
    form: the cache is read at Hk heads.  Scores and softmax in f32, the
    probabilities cast to the cache dtype for the PV product."""
    B, S, Hq, D = q.shape
    C, Hk = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hk
    length = kv_length[..., None] if isinstance(kv_length, torch.Tensor) else kv_length
    q_pos = torch.arange(S, device=q.device) - S + length  # (S,), or (B, S) per row
    live = torch.arange(C, device=q.device) <= q_pos[..., None]  # (S, C), or (B, S, C)
    if live.dim() == 3:
        live = live[:, None, None]
    qg = q.reshape(B, S, Hk, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.float()) * D**-0.5
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache).reshape(B, S, Hq, D)


def streamed_position_attention(
    q: torch.Tensor,  # (R, c, Hq, D): one prompt chunk per row
    k_buf: torch.Tensor,  # (R, Sp, Hk, D): a row's staged prompt K (earlier chunks and this one)
    v_buf: torch.Tensor,  # (R, Sp, Hk, D)
    q_idx: torch.Tensor,  # (R, c) int: the buffer index of each query token
    block: int = 512,
    n_blocks: Optional[int] = None,
) -> torch.Tensor:
    """Chunked-prefill attention (the reference's
    ``ops/attention.py::streamed_position_attention``, XLA there, plain
    PyTorch here on either device): each row's chunk attends to its own
    staged buffer at the positions ``<=`` each token's buffer index.

    - ``Sp <= block``: one masked softmax in the op order of
      ``decode_attention`` (f32 scores, probabilities normalized and cast to
      the buffer's dtype before PV), so that a chunked admission equals an
      unchunked one at fp32.
    - else an online softmax over blocks of ``block`` keys (``block`` must
      divide ``Sp``): f32 running max, sum and PV of P in the buffer's
      dtype, divided at the end.  The loop stops after the block of the
      furthest attended key, ``max(q_idx) // block + 1`` blocks; a caller
      that knows that bound on the host passes ``n_blocks`` (on the card,
      reading it from ``q_idx`` waits for the device)."""
    R, c, hq, d = q.shape
    Sp, hk = k_buf.shape[1], k_buf.shape[2]
    g = hq // hk
    qg = q.reshape(R, c, hk, g, d).float()
    q_idx = q_idx.to(q.device)
    if Sp <= block:
        live = torch.arange(Sp, device=q.device)[None, None, :] <= q_idx[:, :, None]  # (R, c, Sp)
        s = torch.einsum("rchgd,rkhd->rhgck", qg, k_buf.float()) * d**-0.5
        s = torch.where(live[:, None, None], s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1).to(v_buf.dtype)
        return torch.einsum("rhgck,rkhd->rchgd", p, v_buf).reshape(R, c, hq, d)
    if Sp % block:
        raise ValueError(f"block {block} must divide the staging length {Sp}")
    if n_blocks is None:
        n_blocks = int(q_idx.max()) // block + 1
    m = torch.full((R, hk, g, c), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((R, hk, g, c), dtype=torch.float32, device=q.device)
    acc = torch.zeros((R, hk, g, c, d), dtype=torch.float32, device=q.device)
    for j in range(n_blocks):
        kb, vb = k_buf[:, j * block : (j + 1) * block], v_buf[:, j * block : (j + 1) * block]
        s = torch.einsum("rchgd,rkhd->rhgck", qg, kb.float()) * d**-0.5
        live = (j * block + torch.arange(block, device=q.device))[None, None, :] <= q_idx[:, :, None]
        s = torch.where(live[:, None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("rhgck,rkhd->rhgcd", p.to(vb.dtype).float(), vb.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(R, c, hq, d).to(v_buf.dtype)
