"""Slot-based continuous-batching serving engine: the port of
``spatialrgpt_tpu/serving/engine.py``'s default, single-device path.

A fixed pool of B decode slots over one shared KV cache.  Queued requests
are prefilled in power-of-2 batches of up to ``admit_width`` and inserted
into free slots while the other slots keep decoding:

  - cache: ``llama.KVCache`` (L, B, C, Hk, D) in ``dtype``, or with
    ``kv_quant`` the int8 ``QuantKVCache`` of ``serving/generate.py``, flat
    token-major (L, B, C, Hk*D) + f32 scales (L, B, C, Hk);
  - every decode step runs all B slots; per-slot ``lengths`` give the
    position a slot writes its new K/V at and the live keys (``<=
    lengths[b]``), inactive slots are masked out of the bookkeeping;
  - ``step(num_steps)`` runs ``num_steps`` decode steps per host round trip
    (multi-step windows): rows that finish mid-window keep decoding into
    their own slot and the host truncates their tokens at eos;
  - ``async_readback`` reads a window's tokens one ``step()`` late: they
    are copied into pinned host memory behind a CUDA event when the window
    is launched, and the pending entry holds that copy, not the device
    tensor the next window overwrites;
  - ``register_prefix`` prefills a shared prompt prefix once; a request
    with its ``prefix_id`` prefills only its suffix against the prefix's
    K/V (``llama.forward(cache=...)``);
  - ``sample_tokens``: greedy rows take the argmax; sampled rows draw from
    the nucleus within a top-k prefilter, keyed per request by (seed,
    position);
  - ``prefill_chunk > 0``: the fused mixed-batch chunked prefill (below).

The decode step is ``serving/generate.py::_decode_step``, the lockstep
``generate``'s own: its per-slot write and attention (``_slot_attend``:
plain PyTorch on the activation-dtype cache, as the reference runs it in
XLA; kernel K3 on the int8 cache for every CUDA decode with
``attn_impl="onepass"``).

The fused mixed-batch chunked prefill (``prefill_chunk`` = c > 0, the
reference's ``engine.py:81-96``, ``:595-946``, ``:1175-1222``,
``:1397-1475``): a plain request takes a free chunk row (at most
``chunk_rows`` in flight) and a reserved slot.  ``_start_row`` encodes its
images and splices the prompt once (K1), pads the embeddings and positions
to the staging length ``Sp`` (the prompt bucket rounded up to whole
chunks) and allocates the row's staging K/V, (L, Sp, Hk, D) in the
activation dtype (this rank's kv heads under tensor parallelism).  Each
decode step of a window then runs the B decode tokens and one chunk of c
prompt tokens of every row still prefilling as one flat token batch
through every projection and norm (``_fused_once``): the decode side
writes and attends as ``_decode_step`` does, the chunk side writes its
staging rows and attends to them through
``ops/attention.py::streamed_position_attention`` (plain PyTorch, XLA in
the reference).  At the window's end each row whose prompt completed
samples its first token from its hidden state at ``plen - 1`` (keyed at
that position, as an unchunked admission), its staged K/V are written
whole into its slot (quantized once with ``kv_quant``), and the slot is
armed (``lengths`` = plen, ``last_token``); the host then activates it
(``_complete_rows``; with ``async_readback`` optimistically, its first
token read one ``step()`` later from a ``"chunk"`` entry).  Prefix-cached
requests keep the immediate ``_admit_prefix_head`` path.
Where the reference's jits return a new cache (donating the old one),
this engine updates the cache, ``lengths`` and ``last_token`` in place; an
inserted slot row is written whole (the prompt, then zeros to the
capacity), so a recycled slot keeps no stale tail.

Where it differs from the reference:

  - The int8 cache has one layout, flat token-major, as the port's
    ``generate`` stores it.  The reference's head-major layout, its
    ``SRGPT_KV_FLAT`` switch, its ``DECODE_KERNEL_MIN_C`` gate and
    ``round_capacity`` are TPU rules (XLA's int8 tile padding of the
    head-major minor dims, the Pallas kernel's block size); K3 reads the
    flat rows at any capacity it takes.  Where K3 does not take the
    capacity at the model's heads (``decode_attention.check_shape``), the
    engine raises at construction: there is no plain fallback on CUDA.
  - A row that finished mid-window advances ``lengths`` only up to ``C -
    1``: JAX drops an out-of-range scatter, while a CUDA index past the
    cache would be a device-side assert.  Its tokens are truncated anyway.
  - The fused window's writes that the reference drops by an out-of-range
    index (``mode="drop"``) are not made out of range here: the decode side
    of an idle or reserved slot writes inside its own cache row, at its
    ``lengths`` (the row is written whole when a request lands in the
    slot), and a chunk row whose prompt completed earlier in the window
    leaves the flat batch (the host knows each row's chunks), so it writes
    no staging and adds no rows to the window's later steps.
  - Sampling draws Gumbel-max noise from a counter-based hash of (seed,
    position, token id) computed on the device, not from JAX's threefry
    bits: the port's sampled tokens are not JAX's sampled tokens (greedy
    tokens are equal).
  - The admission prefill also takes the greedy fast path when all its
    requests are greedy (the tokens are the argmax either way).
  - ``attn_impl`` defaults to ``"onepass"`` (the kernels), as the port's
    ``generate`` does; ``"xla"`` takes K1-K3's plain versions.

Tensor parallelism (``mesh`` with a tp dim above 1, the reference's
``engine.py:110-125``): the model is placed by
``parallel/mesh.py::tp_shard_model`` (its decoder keeps this rank's slice
of every projection and adds the collectives), and either cache holds this
rank's kv heads: the bf16 cache's (L, B, C, Hk / tp, D), the flat int8
cache's (L, B, C, Hk / tp * D) rows and (L, B, C, Hk / tp) scales.  tp must
divide the kv-head count.  Every rank runs the same scheduler on the same
requests and samples the same tokens from the gathered logits.

The engine runs on the device of the model it is given; pixel fields go
to that device in the dtype of the model's weights, once per admission
(or at ``submit(prefetch=True)``), and the token and index fields of
queued requests stay on the host until their admission.

The plain decode window (no chunk row in flight) runs as k replays of a
CUDA graph of one decode step on a CUDA device where the decoder has no
tensor-parallel group and takes the dense MoE route (the sparse route
reads its experts' sizes on the host; ``tp_sum`` runs NCCL).  There is
one graph for greedy windows and one for windows that sample, each
captured from ``_decode_once`` itself right after the first window of
its kind, which runs eagerly and so warms cuBLAS and the allocator: the
same kernels in the same order, the same tokens.  The graph reads and
writes state at fixed addresses: the cache, ``lengths`` and
``last_token`` (updated in place by every path), the four per-slot
sampling buffers (refreshed from pinned host memory by ``copy_``) and
the step's (B,) token output, which each replay's window copies into its
own (B, k) tokens.  Admissions write the same buffers in place between
replays.  The fused window, tensor-parallel serving and the CPU keep the
eager window.  ``graph_stats`` counts the captures, the replayed windows
and the eager windows.

Under a running ``torch.profiler`` each ``step`` opens host spans
(``utils/profiling.py::annotate``; nothing while no profiler runs):

  - ``engine.admit``: the step's whole admission (batch assembly, uploads,
    the tower, the prefills, the cache inserts, the first-token reads);
  - ``engine.prefill[n]`` inside it: one admission prefill of n requests
    with its cache insert (``[1]`` for a prefix-cached request, and for a
    fused chunk row's start: its tower and splice);
  - ``engine.decode``: the decode window (fused or not), the completed
    chunk rows' activation and, without ``async_readback``, the read of
    the window's tokens; with ``async_readback`` only the launches and
    the readback's start;
  - ``engine.replay[k]`` inside it: a window of k replays of the step's
    graph, each launch followed by one span of each K8 / K9 launch the
    graph replays, in launch order (``ops/int8_linear.py::open_spans``):
    those launches run no Python of their own;
  - ``engine.eager[k]`` inside it: a window of k steps run eagerly (the
    kernels' own spans open inside it as they launch).
"""

from __future__ import annotations

import collections
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from spatialrgpt_tpu_torch.config import SpatialRGPTConfig
from spatialrgpt_tpu_torch.models import llama, vlm
from spatialrgpt_tpu_torch.ops import decode_attention, int8_linear
from spatialrgpt_tpu_torch.ops.attention import streamed_position_attention
from spatialrgpt_tpu_torch.ops.layers import linear, qkv_proj
from spatialrgpt_tpu_torch.ops.quant import quantize_kv
from spatialrgpt_tpu_torch.parallel.mesh import mesh_size, tp_shard_model
from spatialrgpt_tpu_torch.serving.generate import _decode_step, _slot_attend, new_quant_cache
from spatialrgpt_tpu_torch.utils import profiling
from spatialrgpt_tpu_torch.utils.profiling import annotate


@dataclass
class Request:
    request_id: int
    inputs: vlm.VLMInputs  # batch-1 prompt (padded to the prompt bucket)
    prompt_length: int
    max_new_tokens: int = 128
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    prefix_id: Optional[int] = None  # shared-prefix KV (register_prefix)
    temperature: float = 0.0  # 0 = greedy; per request (slots mix freely)
    top_p: float = 1.0
    seed: int = 0  # sampling stream seed


# pixel-sized fields: prefetched and concatenated on the device
_HEAVY_FIELDS = ("images", "depths", "masks")
# the dtypes of VLMInputs.from_spliced for the token, index and flag fields
_FIELD_DTYPES = {
    "input_ids": torch.int64, "is_image": torch.bool, "image_gather_idx": torch.int64,
    "position_ids": torch.int64, "segment_ids": torch.int32, "labels": torch.int64, "mask_slot": torch.int64,
    "is_mask": torch.bool, "depth_slot": torch.int64, "is_depth": torch.bool, "mask_valid": torch.bool,
}


# the profiler's spans (built only under a profiler): one admission prefill
# of n requests, a decode window of k steps replayed as a graph or run eagerly
PREFILL_SPAN = "engine.prefill[{}]".format
REPLAY_SPAN = "engine.replay[{}]".format
EAGER_SPAN = "engine.eager[{}]".format


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class ServingEngine:
    def __init__(
        self,
        model: vlm.SpatialRGPT,
        cfg: SpatialRGPTConfig,
        num_slots: int = 8,
        prompt_bucket: int = 512,
        max_new_tokens: int = 128,
        attn_impl: str = "onepass",
        dtype: torch.dtype = torch.bfloat16,  # of the cache without kv_quant
        kv_quant: bool = False,  # the int8 KV cache (K3)
        prefix_bucket: int = 0,  # cache room for a shared prefix (register_prefix); 0 disables it
        admit_width: int = 8,  # most requests per batched admission prefill
        mesh=None,  # tensor-parallel serving over the mesh's tp dim
        prefill_chunk: int = 0,  # fused mixed-batch chunked prefill: prompt tokens a chunk; 0 = off
        chunk_rows: int = 4,  # most admissions in flight in the fused mode, each a staging row
        topk_sampling: int = 64,  # top-k prefilter of sampled decode; 0 = the exact full sort
        async_readback: bool = False,  # read each window's tokens one step() late
    ):
        if mesh is not None:
            tp = mesh_size(mesh, "tp")
            if cfg.llm.num_key_value_heads % tp:
                raise ValueError(f"tp={tp} must divide the kv-head count {cfg.llm.num_key_value_heads} (the KV "
                                 "cache shards its head axis)")
            tp_shard_model(model, mesh)
        self.mesh = mesh
        if attn_impl not in ("onepass", "xla"):
            raise ValueError(f"unknown attention impl: {attn_impl}")
        self.model, self.cfg = model, cfg
        self.device = model.llm.model.embed_tokens.weight.device
        self.act_dtype = model.llm.model.embed_tokens.weight.dtype
        self.B, self.S, self.P = num_slots, prompt_bucket, prefix_bucket
        self.capacity = prefix_bucket + prompt_bucket + max_new_tokens
        self.attn_impl, self.kv_quant = attn_impl, kv_quant
        self.admit_width, self.topk_sampling = admit_width, topk_sampling
        self.prefill_chunk = prefill_chunk
        self.chunk_rows = chunk_rows if prefill_chunk else 0
        # the staging length: the prompt bucket in whole chunks, so no chunk's slice is cut short
        self.Sp = -(-prompt_bucket // prefill_chunk) * prefill_chunk if prefill_chunk else 0
        # the chunk attention's block: the single-shot softmax up to 512 staged
        # positions, else the online softmax over blocks that divide Sp
        if self.Sp > 512:
            self._chunk_block = next(b for b in (512, 256, 128, 64, prefill_chunk, self.Sp) if self.Sp % b == 0)
        else:
            self._chunk_block = 512
        # per chunk row: the admission in flight (req, slot, off, rem, plen and
        # its device buffers), or None
        self._rows: List[Optional[dict]] = [None] * self.chunk_rows
        if kv_quant:
            self.cache = new_quant_cache(model.llm, cfg.llm, self.B, self.capacity, self.device)
        else:
            self.cache = llama.new_cache(model.llm, cfg.llm, self.B, self.capacity, dtype, self.device)
        if kv_quant and attn_impl == "onepass" and self.device.type == "cuda":
            hk = self.cache.k_s.shape[-1]  # this rank's kv heads; their query heads keep the model's ratio
            lc = cfg.llm
            decode_attention.check_shape(self.capacity, hk * (lc.num_attention_heads // lc.num_key_value_heads), hk,
                                         lc.head_dim)
        # per slot: the position its next token is written at (int32, in [0, C))
        self.lengths = torch.zeros(self.B, dtype=torch.int32, device=self.device)
        self.last_token = torch.zeros(self.B, dtype=torch.int64, device=self.device)
        self.prefixes: Dict[int, tuple] = {}
        self._prefix_ids = itertools.count()
        self.active = np.zeros((self.B,), bool)  # host-side slot occupancy
        self._reserved = np.zeros((self.B,), bool)  # held by a chunked admission in flight
        self.slot_req: List[Optional[Request]] = [None] * self.B
        # per-slot sampling state (host side; on the device while unchanged)
        self.slot_temp = np.zeros((self.B,), np.float32)
        self.slot_top_p = np.ones((self.B,), np.float32)
        self.slot_key = np.zeros((self.B, 2), np.int64)
        # the same on the device, at fixed addresses (a graph reads them):
        # occupancy, temperature, top-p, key; refreshed before a window once stale
        self._sched = (torch.zeros(self.B, dtype=torch.bool, device=self.device),
                       torch.zeros(self.B, dtype=torch.float32, device=self.device),
                       torch.ones(self.B, dtype=torch.float32, device=self.device),
                       torch.zeros((self.B, 2), dtype=torch.int64, device=self.device))
        self._sched_stale = True
        # the plain decode window's steps as the replays of a CUDA graph where
        # nothing in a step needs the host (no NCCL, no sparse MoE route):
        # all_greedy -> (the step's graph, its (B,) token output, the K8 / K9
        # span names of its launches)
        self._graph_window = (self.device.type == "cuda" and model.llm.tp is None
                              and not (cfg.llm.is_moe and cfg.llm.moe_impl == "sparse"))
        self._graphs: Dict[bool, tuple] = {}
        self._graph_pool = self._capture_stream = None
        self.graph_stats = {"captures": 0, "replays": 0, "eager": 0}
        self.queue: collections.deque = collections.deque()
        self._ids = itertools.count()
        # requests whose prefill token already ended them; returned by the next step()
        self._admit_finished: List[Request] = []
        self.async_readback = async_readback
        # launched, not yet read: admissions' first tokens ("prefill" or
        # "chunk", readback, [(index into the tokens, req, slot)], None) and
        # windows' ("decode", readback, active snapshot, slot_req snapshot)
        self._pending: collections.deque = collections.deque()

    # ------------------------------------------------------------------
    # host <-> device
    # ------------------------------------------------------------------

    def _upload(self, arr, dtype: torch.dtype) -> torch.Tensor:
        """Host values to the engine's device; from pinned memory without
        blocking on a CUDA device, so an upload does not wait for the
        decode window in flight."""
        if isinstance(arr, torch.Tensor) and arr.device == self.device:
            return arr.to(dtype)
        t = torch.as_tensor(_host(arr)).to(dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _device_inputs(self, x: vlm.VLMInputs) -> vlm.VLMInputs:
        return vlm.VLMInputs(**{
            f: None if v is None else self._upload(v, self.act_dtype if f in _HEAVY_FIELDS else _FIELD_DTYPES[f])
            for f, v in x._asdict().items()
        })

    def _readback(self, toks: torch.Tensor):
        """Start the copy of a launched token tensor to the host: into
        pinned memory behind an event on a CUDA device, a copy on the CPU.
        The entry owns its buffer, so later in-place updates of the
        engine's state cannot reach it."""
        if toks.device.type == "cuda":
            host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
            host.copy_(toks, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return host, done
        return toks.clone(), None

    @staticmethod
    def _read(entry) -> np.ndarray:
        host, done = entry
        if done is not None:
            done.synchronize()
        return host.numpy()

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------

    def _sample(self, logits, keys, positions, temps, top_ps, all_greedy):
        return sample_tokens(logits, keys, positions, temps, top_ps, all_greedy=all_greedy, topk=self.topk_sampling)

    def _prefill_batch(self, inputs: vlm.VLMInputs, prompt_lens, temps, top_ps, keys, all_greedy: bool):
        """Batched admission prefill of n requests of one prompt bucket:
        the per-layer K/V (int8 with ``kv_quant``), each row's first token,
        sampled at position ``prompt_len - 1``, and its logits (n, V)."""
        lc = self.cfg.llm
        embeds = vlm.prepare_embeds(self.model, self.cfg, inputs, self.attn_impl)
        h, kv = llama.forward(
            self.model.llm, lc, inputs_embeds=embeds, position_ids=inputs.position_ids,
            segment_ids=inputs.segment_ids, attn_impl=self.attn_impl, collect_kv=True, kv_quant=self.kv_quant,
        )
        last_idx = (prompt_lens - 1).clamp(min=0)
        last = h[torch.arange(h.shape[0], device=h.device), last_idx]
        logits = llama.logits(self.model.llm, last[:, None])[:, 0]
        return kv, self._sample(logits, keys, last_idx, temps, top_ps, all_greedy), logits

    def _insert_batch(self, kv, slots: torch.Tensor, plens: torch.Tensor, toks: torch.Tensor) -> None:
        """Write each prefilled row whole into its slot (prompt, then zeros
        to the capacity) and arm the slot: length = prompt length, last
        token = the first sampled token."""
        c, n = self.cache, slots.shape[0]
        if self.kv_quant:
            for li, ((kq, ks), (vq, vs)) in enumerate(kv):
                S = kq.shape[1]
                pairs = ((c.k_q, kq.reshape(n, S, -1)), (c.k_s, ks), (c.v_q, vq.reshape(n, S, -1)), (c.v_s, vs))
                for dst, src in pairs:
                    dst[li, slots, :S] = src
                    dst[li, slots, S:] = 0
        else:
            for li, (k, v) in enumerate(kv):
                S = k.shape[1]
                for dst, src in ((c.k, k), (c.v, v)):
                    dst[li, slots, :S] = src.to(dst.dtype)
                    dst[li, slots, S:] = 0
        self.lengths[slots] = plens.to(torch.int32)
        self.last_token[slots] = toks

    def _prefill_prefix(self, inputs: vlm.VLMInputs):
        """K/V of a shared prompt prefix in the activation dtype (quantized,
        with ``kv_quant``, only when a suffix lands in a slot), layers
        stacked: (L, 1, PB, Hk, D) each."""
        embeds = vlm.prepare_embeds(self.model, self.cfg, inputs, self.attn_impl)
        _, kv = llama.forward(
            self.model.llm, self.cfg.llm, inputs_embeds=embeds, position_ids=inputs.position_ids,
            segment_ids=inputs.segment_ids, attn_impl=self.attn_impl, collect_kv=True,
        )
        return torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])

    def _prefill_with_prefix(self, pk, pv, plen: int, inputs: vlm.VLMInputs, suffix_len: int, temps, top_ps, keys,
                             all_greedy: bool):
        """Prefill only a request's suffix against the cached prefix K/V:
        returns the capacity-long cache row (prefix + suffix) and the first
        token, sampled at position ``plen + suffix_len - 1``."""
        embeds = vlm.prepare_embeds(self.model, self.cfg, inputs, self.attn_impl)
        PB = pk.shape[2]
        cache = llama.new_cache(self.model.llm, self.cfg.llm, 1, self.capacity, pk.dtype, self.device)
        cache = cache._replace(length=plen)
        cache.k[:, :, :PB] = pk
        cache.v[:, :, :PB] = pv
        h, cache = llama.forward(
            self.model.llm, self.cfg.llm, inputs_embeds=embeds, position_ids=inputs.position_ids + plen, cache=cache,
        )
        logits = llama.logits(self.model.llm, h[:, suffix_len - 1 : suffix_len])[:, 0]
        pos = torch.full((1,), plen + suffix_len - 1, dtype=torch.int64, device=self.device)
        return cache, self._sample(logits, keys, pos, temps, top_ps, all_greedy)

    def _insert_full(self, row: llama.KVCache, slot: int, total_len: int, tok: torch.Tensor) -> None:
        """Write a capacity-long cache row (quantized with ``kv_quant``) into
        ``slot`` and arm it."""
        c = self.cache
        if self.kv_quant:
            kq, ks = quantize_kv(row.k[:, 0])  # (L, C, Hk, D), (L, C, Hk)
            vq, vs = quantize_kv(row.v[:, 0])
            c.k_q[:, slot] = kq.reshape(kq.shape[0], kq.shape[1], -1)
            c.k_s[:, slot] = ks
            c.v_q[:, slot] = vq.reshape(vq.shape[0], vq.shape[1], -1)
            c.v_s[:, slot] = vs
        else:
            c.k[:, slot] = row.k[:, 0].to(c.k.dtype)
            c.v[:, slot] = row.v[:, 0].to(c.v.dtype)
        self.lengths[slot] = total_len
        self.last_token[slot] = tok[0]

    def _advance(self, active, tok: torch.Tensor) -> torch.Tensor:
        """Advance the active slots in place: lengths + 1 (at most C - 1),
        last token ``tok``.  Returns the (B,) last tokens as a tensor of
        their own."""
        self.lengths.copy_(torch.where(active, (self.lengths + 1).clamp(max=self.capacity - 1), self.lengths))
        last = torch.where(active, tok, self.last_token)
        self.last_token.copy_(last)
        return last

    def _decode_once(self, active, temps, top_ps, keys, all_greedy: bool) -> torch.Tensor:
        """One decode step of every slot: advances the active slots'
        lengths (at most to C - 1) and last tokens in place, and returns the
        (B,) last tokens."""
        x = llama.embed_tokens(self.model.llm, self.last_token[:, None])
        h = _decode_step(self.model, self.cfg, x, self.lengths, self.cache, self.attn_impl)
        logits = llama.logits(self.model.llm, h)[:, 0]
        return self._advance(active, self._sample(logits, keys, self.lengths, temps, top_ps, all_greedy))

    def _decode_window(self, k: int, all_greedy: bool, active, temps, top_ps, keys) -> torch.Tensor:
        """``k`` decode steps with no host round trip between them (multi-step
        scheduling); returns the (B, k) tokens.  The step's graph for
        ``all_greedy`` replayed k times where the engine holds one; else
        the eager window, after which the step's graph is captured where
        the step can run as one."""
        out = torch.empty((self.B, k), dtype=torch.int64, device=self.device)
        entry = self._graphs.get(all_greedy)
        if entry is not None:
            graph, last, names = entry
            with annotate(REPLAY_SPAN, k):
                traced = profiling.enabled()
                for i in range(k):
                    graph.replay()
                    out[:, i] = last
                    if traced:
                        int8_linear.open_spans(names)
            self.graph_stats["replays"] += 1
            return out
        with annotate(EAGER_SPAN, k):
            for i in range(k):
                out[:, i] = self._decode_once(active, temps, top_ps, keys, all_greedy)
        self.graph_stats["eager"] += 1
        if self._graph_window:
            self._capture(all_greedy, active, temps, top_ps, keys)
        return out

    def _capture(self, all_greedy: bool, active, temps, top_ps, keys) -> None:
        """Capture one decode step (``_decode_once``) as a CUDA graph in the
        engine's memory pool, with its (B,) token output and the span names
        of the K8 / K9 launches it makes.  Nothing runs: the engine's state
        is as before, and the next window of ``all_greedy`` replays the
        graph.  The capture stream starts behind the current one, and
        nothing captured reads the host or synchronizes."""
        if self._graph_pool is None:
            self._graph_pool, self._capture_stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(self.device)
        graph = torch.cuda.CUDAGraph()
        self._capture_stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._capture_stream), int8_linear.record_spans() as names:
            graph.capture_begin(pool=self._graph_pool)
            try:
                last = self._decode_once(active, temps, top_ps, keys, all_greedy)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(self._capture_stream)
        self._graphs[all_greedy] = (graph, last, tuple(names))
        self.graph_stats["captures"] += 1

    def _fused_once(self, live, active, temps, top_ps, keys, all_greedy: bool) -> tuple:
        """One decode step of every slot fused with one prompt chunk of each
        row in ``live`` ((row state, offset) pairs): the B decode tokens
        and the chunks' tokens as one flat batch of B + n c rows through
        every projection and norm.  Writes the decode side's K/V into the
        cache and each chunk's into its row's staging, advances the
        decode state as ``_decode_once`` does, and returns the chunks'
        final-normed hidden states (n, c, H) and the (B,) last tokens."""
        llm = self.model.llm
        lc, tp = llama.rank_cfg(llm, self.cfg.llm), llm.tp
        B, c, n = self.B, self.prefill_chunk, len(live)
        Hq, Hk, D = lc.num_attention_heads, lc.num_key_value_heads, lc.head_dim
        x_d = llama.embed_tokens(llm, self.last_token[:, None])[:, 0]
        x_c = torch.cat([rs["embeds"][off : off + c] for rs, off in live])
        h = torch.cat([x_d.to(x_c.dtype), x_c])[None]  # (1, B + n c, H)
        pos = self.lengths.long()
        pos_all = torch.cat([pos] + [rs["pos"][off : off + c] for rs, off in live])[None]
        q_idx = [torch.arange(off, off + c, device=self.device)[None] for _, off in live]
        n_blocks = [(off + c - 1) // self._chunk_block + 1 for _, off in live]
        rows = torch.arange(B, device=self.device)
        for li, layer in enumerate(llm.model.layers):
            attn = layer.self_attn
            q, k, v = qkv_proj(llama.norm(h, layer.input_layernorm), attn, Hq, Hk, D)
            q, k = llama.apply_rope(q, k, pos_all, lc)
            q, k, v = q[0], k[0], v[0]
            parts = [_slot_attend(q[:B], k[:B], v[:B], rows, pos, self.lengths, self.cache, li, self.attn_impl)]
            for r, (rs, off) in enumerate(live):
                lo = B + r * c
                sk, sv = rs["stag_k"][li], rs["stag_v"][li]
                sk[off : off + c] = k[lo : lo + c]
                sv[off : off + c] = v[lo : lo + c]
                out = streamed_position_attention(q[lo : lo + c][None], sk[None], sv[None], q_idx[r],
                                                  self._chunk_block, n_blocks[r])
                parts.append(out.reshape(c, Hq * D).to(parts[0].dtype))
            h = h + llama.tp_sum(linear(torch.cat(parts)[None], attn.o_proj), tp)
            h = h + llama.tp_sum(llama.ffn_block(llama.norm(h, layer.post_attention_layernorm), layer, lc)[0], tp)
        h = llama.norm(h, llm.model.norm)[0]
        logits = llama.logits(llm, h[:B, None])[:, 0]
        last = self._advance(active, self._sample(logits, keys, self.lengths, temps, top_ps, all_greedy))
        return h[B:].reshape(n, c, -1), last

    def _insert_staged(self, rs: dict, tok: torch.Tensor) -> None:
        """Write a completed row's staged K/V whole into its slot (the
        prompt, then zeros to the capacity; quantized once with
        ``kv_quant``) and arm the slot."""
        c, slot = self.cache, rs["slot"]
        W = min(self.Sp, self.capacity)
        k, v = rs["stag_k"][:, :W], rs["stag_v"][:, :W]  # (L, W, Hk, D)
        if self.kv_quant:
            (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
            for dst, src in ((c.k_q, kq.flatten(2)), (c.k_s, ks), (c.v_q, vq.flatten(2)), (c.v_s, vs)):
                dst[:, slot, :W] = src
                dst[:, slot, W:] = 0
        else:
            for dst, src in ((c.k, k), (c.v, v)):
                dst[:, slot, :W] = src.to(dst.dtype)
                dst[:, slot, W:] = 0
        self.lengths[slot] = rs["plen"]
        self.last_token[slot] = tok

    def _run_fused_window(self, k: int, all_greedy: bool, active, temps, top_ps, keys):
        """``k`` decode steps, each fused with one chunk of every admission
        row still prefilling (a step with none is a plain decode step), no
        host round trip between them; each row's host state (``off``,
        ``rem``) advances by its chunks.  The rows whose prompt completes in
        the window get their first token, sampled from the hidden state at
        ``plen - 1``, and their slot (``_insert_staged``).  Returns the (B,
        k) decode tokens, the completing rows' indices, their first tokens
        and their first-token logits."""
        c = self.prefill_chunk
        act = [r for r, rs in enumerate(self._rows) if rs is not None]
        h_last, toks = {}, []
        for _ in range(k):
            live = [self._rows[r] for r in act if self._rows[r]["rem"] > 0]
            if not live:
                toks.append(self._decode_once(active, temps, top_ps, keys, all_greedy))
                continue
            h_c, step_toks = self._fused_once([(rs, rs["off"]) for rs in live], active, temps, top_ps, keys,
                                              all_greedy)
            toks.append(step_toks)
            for i, rs in enumerate(live):
                last = rs["plen"] - 1 - rs["off"]
                if 0 <= last < c:
                    h_last[rs["slot"]] = h_c[i, last]
                rs["off"] += c
                rs["rem"] -= 1
        toks = torch.stack(toks, dim=1)
        done = [r for r in act if self._rows[r]["rem"] == 0]
        chunk_tok = chunk_logits = None
        if done:
            reqs = [self._rows[r]["req"] for r in done]
            chunk_logits = llama.logits(self.model.llm, torch.stack([h_last[self._rows[r]["slot"]] for r in done])
                                        [:, None])[:, 0]
            temps_r, top_ps_r, keys_r = self._sampling_args(reqs)
            positions = self._upload(np.asarray([q.prompt_length - 1 for q in reqs]), torch.int64)
            chunk_tok = self._sample(chunk_logits, keys_r, positions, temps_r, top_ps_r, all_greedy)
            for i, r in enumerate(done):
                self._insert_staged(self._rows[r], chunk_tok[i])
        return toks, done, chunk_tok, chunk_logits

    # ------------------------------------------------------------------
    # host scheduler
    # ------------------------------------------------------------------

    @torch.no_grad()
    def register_prefix(self, inputs: vlm.VLMInputs, prompt_length: int) -> int:
        """Prefill a shared prompt prefix once (a system prompt, a template
        preamble); requests submitted with its id pay prefill only for their
        suffix."""
        if self.P <= 0:
            raise ValueError("construct the engine with prefix_bucket > 0")
        if inputs.input_ids.shape[1] > self.P:
            raise ValueError(f"prefix bucket {inputs.input_ids.shape[1]} exceeds the engine's prefix_bucket {self.P}")
        pk, pv = self._prefill_prefix(self._device_inputs(self._concat_inputs([inputs])))
        pid = next(self._prefix_ids)
        self.prefixes[pid] = (pk, pv, prompt_length)
        return pid

    def submit(
        self,
        inputs: vlm.VLMInputs,
        prompt_length: int,
        max_new_tokens: int = 128,
        prefix_id: Optional[int] = None,
        temperature: float = 0.0,
        top_p: float = 1.0,
        seed: int = 0,
        prefetch: bool = False,
    ) -> int:
        """Queue a request.  Raises ``ValueError`` when it cannot fit the
        cache: a slot must never need a position past the capacity.

        ``prefetch=True`` starts the copy of the pixel fields (images,
        depths, masks) to the device now, from pinned memory without
        blocking, so it overlaps the work in flight; they are concatenated
        on the device at admission.  The token and index fields stay on
        the host either way."""
        width = inputs.input_ids.shape[1]
        if width > self.S:
            raise ValueError(f"prompt bucket {width} exceeds engine prompt_bucket {self.S}")
        plen = 0
        if prefix_id is not None:
            if prefix_id not in self.prefixes:
                raise ValueError(f"unknown prefix_id {prefix_id}")
            plen = self.prefixes[prefix_id][2]
        total = plen + prompt_length + max_new_tokens
        if total > self.capacity:
            raise ValueError(
                f"request needs {total} cache positions (prefix {plen} + prompt {prompt_length} + max_new "
                f"{max_new_tokens}) but engine capacity is {self.capacity}"
            )
        if prefetch:
            inputs = inputs._replace(**{
                f: self._upload(getattr(inputs, f), self.act_dtype)
                for f in _HEAVY_FIELDS if getattr(inputs, f) is not None
            })
        rid = next(self._ids)
        self.queue.append(Request(rid, inputs, prompt_length, max_new_tokens, prefix_id=prefix_id,
                                  temperature=temperature, top_p=top_p, seed=seed))
        return rid

    @staticmethod
    def _modality_signature(x: vlm.VLMInputs) -> tuple:
        """Which fields are present, and their non-batch shapes.  Admission
        batches only requests of one signature: a text-only request
        (images None) concatenated with an image request would drop
        tensors or fail."""
        return tuple(None if v is None else tuple(v.shape[1:]) for v in x)

    @staticmethod
    def _concat_inputs(inputs_list) -> vlm.VLMInputs:
        """Stack per-request inputs into one batch: the token and index
        fields with numpy on the host, the pixel fields as tensors where any
        of them is one (prefetched or staged: on its device), else with
        numpy.

        The flat gather indices (``image_gather_idx`` into (N_images * T,),
        ``mask_slot`` / ``depth_slot`` into (N_images * R,)) are per
        request; each request's are offset by the images before it."""
        t_img = 0
        for x in inputs_list:
            n_img = x.images.shape[0] if x.images is not None else 0
            s = int(_host(x.is_image).sum())
            if n_img and s:
                t_img = s // n_img
                break
        r_slots = inputs_list[0].masks.shape[1] if inputs_list[0].masks is not None else 0
        cols = {f: [] for f in vlm.VLMInputs._fields}
        img_count = 0
        for x in inputs_list:
            for f in vlm.VLMInputs._fields:
                v = getattr(x, f)
                if v is not None and f not in _HEAVY_FIELDS:
                    v = _host(v)
                    if f == "image_gather_idx":
                        v = v + img_count * t_img
                    elif f in ("mask_slot", "depth_slot"):
                        v = v + img_count * r_slots
                cols[f].append(v)
            img_count += x.images.shape[0] if x.images is not None else 0

        def cat(f, vs):
            if vs[0] is None:
                return None
            tensors = [v for v in vs if isinstance(v, torch.Tensor)]
            if f in _HEAVY_FIELDS and tensors:
                return torch.cat([torch.as_tensor(v).to(tensors[0].device) for v in vs])
            return np.concatenate([_host(v) for v in vs], axis=0)

        return vlm.VLMInputs(**{f: cat(f, vs) for f, vs in cols.items()})

    @staticmethod
    def _key_data(req: Request) -> np.ndarray:
        """The request's sampling key: the two 32-bit halves of its seed."""
        return np.asarray([req.seed >> 32 & 0xFFFFFFFF, req.seed & 0xFFFFFFFF], np.int64)

    def _sampling_args(self, reqs: List[Request]):
        return (self._upload(np.asarray([r.temperature for r in reqs], np.float32), torch.float32),
                self._upload(np.asarray([r.top_p for r in reqs], np.float32), torch.float32),
                self._upload(np.stack([self._key_data(r) for r in reqs]), torch.int64))

    def _admit_prefix_head(self, slot: int) -> None:
        """Admit the queue head, a prefix-cached request, into ``slot``."""
        req = self.queue.popleft()
        pk, pv, plen = self.prefixes[req.prefix_id]
        inputs = self._device_inputs(self._concat_inputs([req.inputs]))
        with annotate(PREFILL_SPAN, 1):
            row, tok = self._prefill_with_prefix(pk, pv, plen, inputs, req.prompt_length, *self._sampling_args([req]),
                                                 req.temperature <= 0)
            self._insert_full(row, slot, plen + req.prompt_length, tok)
        req.tokens.append(int(tok[0]))
        self._activate_or_finish(slot, req)

    def _start_row(self, row: int, slot: int, req: Request) -> None:
        """Begin a fused chunked admission in chunk row ``row`` and reserve
        ``slot``: encode the images and splice the prompt once, pad the
        embeddings and positions to ``Sp``, allocate the row's staging K/V
        (L, Sp, Hk, D) in the activation dtype.  The decoder then takes the
        prompt a chunk per decode step."""
        inputs = self._device_inputs(self._concat_inputs([req.inputs]))
        embeds = vlm.prepare_embeds(self.model, self.cfg, inputs, self.attn_impl)[0]  # (w, H)
        w = embeds.shape[0]
        e_row = embeds.new_zeros((self.Sp, embeds.shape[1]))
        e_row[:w] = embeds
        pos = torch.zeros(self.Sp, dtype=torch.int64, device=self.device)
        pos[:w] = inputs.position_ids[0]
        lc = llama.rank_cfg(self.model.llm, self.cfg.llm)
        shape = (lc.num_hidden_layers, self.Sp, lc.num_key_value_heads, lc.head_dim)
        self._reserved[slot] = True
        self._rows[row] = {
            "req": req, "slot": slot, "off": 0, "rem": -(-req.prompt_length // self.prefill_chunk),
            "plen": req.prompt_length, "embeds": e_row, "pos": pos,
            "stag_k": embeds.new_zeros(shape), "stag_v": embeds.new_zeros(shape),
        }

    def _admit_fused(self) -> None:
        """The fused mode's admission: a plain request takes a free chunk
        row and a free slot, which it reserves; a prefix-cached request
        keeps the immediate prefill against its prefix."""
        while self.queue:
            free = np.flatnonzero(~self.active & ~self._reserved)
            if not len(free):
                return
            if self.queue[0].prefix_id is not None:
                self._admit_prefix_head(int(free[0]))
                continue
            row = next((i for i, rs in enumerate(self._rows) if rs is None), None)
            if row is None:
                return
            with annotate(PREFILL_SPAN, 1):
                self._start_row(row, int(free[0]), self.queue.popleft())

    def _admit(self) -> None:
        if self.prefill_chunk:
            self._admit_fused()
            return
        while self.queue and not self.active.all():
            free = np.flatnonzero(~self.active)
            # prefix-cached requests go one at a time (their prefill shape
            # differs); plain requests admit in power-of-2 batches
            if self.queue[0].prefix_id is not None:
                self._admit_prefix_head(int(free[0]))
                continue
            # batch only the front run of plain requests whose modality
            # signature matches the head's
            head_sig = self._modality_signature(self.queue[0].inputs)
            plain = 0
            for r in self.queue:
                if r.prefix_id is not None or self._modality_signature(r.inputs) != head_sig:
                    break
                plain += 1
            n = 1
            while n * 2 <= min(len(free), plain, self.admit_width):
                n *= 2
            reqs = [self.queue.popleft() for _ in range(n)]
            slots = free[:n]
            batched = self._device_inputs(self._concat_inputs([r.inputs for r in reqs]))
            plens = self._upload(np.asarray([r.prompt_length for r in reqs]), torch.int64)
            all_greedy = all(r.temperature <= 0 for r in reqs)
            with annotate(PREFILL_SPAN, n):
                kv, toks, _ = self._prefill_batch(batched, plens, *self._sampling_args(reqs), all_greedy)
                self._insert_batch(kv, self._upload(slots, torch.int64), plens, toks)
            del kv
            if self.async_readback:
                # optimistic activation: the first token is read one step()
                # later; a request it ends decodes one wasted window into
                # its own slot and is truncated then
                for req, slot in zip(reqs, slots):
                    self.active[slot] = True
                    self.slot_req[slot] = req
                    self._set_slot_sampling(int(slot), req)
                self._pending.append(("prefill", self._readback(toks),
                                      [(i, req, int(slot)) for i, (req, slot) in enumerate(zip(reqs, slots))], None))
            else:
                toks_host = toks.cpu().numpy()
                for i, req in enumerate(reqs):
                    req.tokens.append(int(toks_host[i]))
                    self._activate_or_finish(int(slots[i]), req)

    def _activate_or_finish(self, slot: int, req: Request) -> None:
        """Activate the freshly prefilled slot, unless the prefill token
        already ended the request (eos, or max_new_tokens == 1): ``generate``
        counts that token against max_new_tokens and stops on eos."""
        if req.tokens[-1] == self.cfg.llm.eos_token_id or len(req.tokens) >= req.max_new_tokens:
            req.done = True
            self._admit_finished.append(req)
            return
        self.active[slot] = True
        self.slot_req[slot] = req
        self._set_slot_sampling(slot, req)

    def _set_slot_sampling(self, slot: int, req: Request) -> None:
        self.slot_temp[slot] = req.temperature
        self.slot_top_p[slot] = req.top_p
        self.slot_key[slot] = self._key_data(req)
        self._sched_stale = True

    def _finish_and_free(self, slot: int, req: Request, out: List[Request]) -> None:
        req.done = True
        out.append(req)
        if self.slot_req[slot] is req:
            self.active[slot] = False
            self.slot_req[slot] = None
            self._sched_stale = True

    def _take_tokens(self, toks_host: np.ndarray, active_snap, req_snap, out: List[Request]) -> None:
        """Append a decode window's tokens (B, k) to the requests that held
        the slots at launch, truncating each at eos or its budget."""
        eos = self.cfg.llm.eos_token_id
        for slot in np.flatnonzero(active_snap):
            req = req_snap[slot]
            if req is None or req.done:
                continue
            for t in toks_host[slot]:
                req.tokens.append(int(t))
                if int(t) == eos or len(req.tokens) >= req.max_new_tokens:
                    self._finish_and_free(slot, req, out)
                    break

    def _process_pending(self, leave: int = 0) -> List[Request]:
        """Read back and apply launched token tensors, oldest first, leaving
        the newest ``leave`` in flight.  Each entry carries the slot ->
        request mapping at launch, so a slot recycled since never receives
        an older window's tokens."""
        finished: List[Request] = []
        eos = self.cfg.llm.eos_token_id
        while len(self._pending) > leave:
            kind, entry, a, b = self._pending.popleft()
            toks_host = self._read(entry)
            if kind in ("prefill", "chunk"):  # admissions' first tokens: (i, req, slot), i into the tokens
                for i, req, slot in a:
                    req.tokens.append(int(toks_host[i]))
                    if req.tokens[-1] == eos or len(req.tokens) >= req.max_new_tokens:
                        self._finish_and_free(slot, req, finished)
            else:
                self._take_tokens(toks_host.reshape(self.B, -1), a, b, finished)
        return finished

    @torch.no_grad()
    def step(self, num_steps: int = 1) -> List[Request]:
        """Admit queued requests, run ``num_steps`` decode steps (one host
        round trip), return the requests that finished.

        ``num_steps > 1`` is multi-step scheduling: rows finishing
        mid-window keep decoding into their own slot and the host truncates
        their tokens, the same tokens as ``num_steps=1``.  With
        ``async_readback`` this call first applies the earlier windows'
        tokens (while the device runs the last one), then admits, then
        launches the next window without waiting for it."""
        if self.async_readback:
            finished = self._process_pending(leave=1)
            if self.queue and (self.active | self._reserved).all():  # admission starved: find the completions
                finished += self._process_pending(leave=0)
        else:
            finished = []
        with annotate("engine.admit"):
            self._admit()
        finished += self._admit_finished
        self._admit_finished = []
        rows_active = any(rs is not None for rs in self._rows)
        if not self.active.any() and not rows_active:
            return finished + self._process_pending(leave=0)
        if self._sched_stale:
            for dst, src in zip(self._sched, (self.active, self.slot_temp, self.slot_top_p, self.slot_key)):
                src = torch.as_tensor(src).to(dst.dtype)
                dst.copy_(src.pin_memory() if dst.is_cuda else src, non_blocking=True)
            self._sched_stale = False
        # the greedy fast path when no active slot or admission samples: the same tokens
        all_greedy = not bool(np.any(self.slot_temp[self.active] > 0)) and not any(
            rs is not None and rs["req"].temperature > 0 for rs in self._rows)
        # the slots that decode in this window (rows completing in it are activated after it)
        active_launch = self.active.copy()
        req_snapshot = list(self.slot_req)
        with annotate("engine.decode"):
            if rows_active:
                with annotate(EAGER_SPAN, num_steps):
                    toks, done, chunk_tok, _ = self._run_fused_window(num_steps, all_greedy, *self._sched)
                self.graph_stats["eager"] += 1
                finished += self._complete_rows(done, chunk_tok)
            else:
                toks = self._decode_window(num_steps, all_greedy, *self._sched)
            if self.async_readback:
                self._pending.append(("decode", self._readback(toks), active_launch, req_snapshot))
            else:
                self._take_tokens(toks.cpu().numpy(), active_launch, req_snapshot, finished)
        return finished

    def _complete_rows(self, done: List[int], chunk_tok) -> List[Request]:
        """The chunk rows in ``done`` (their prompt completed in the window,
        their slot armed on the device) give up their row and staging and
        activate their slot, or finish at once on eos / ``max_new_tokens ==
        1`` as an unchunked admission does.  With ``async_readback`` the
        slots activate now and their first tokens are read one ``step()``
        later."""
        finished: List[Request] = []
        if not done:
            return finished
        meta = []
        for i, r in enumerate(done):
            slot, req = self._rows[r]["slot"], self._rows[r]["req"]
            self._rows[r] = None
            self._reserved[slot] = False
            meta.append((i, req, slot))
        if self.async_readback:
            for _, req, slot in meta:
                self.active[slot] = True
                self.slot_req[slot] = req
                self._set_slot_sampling(slot, req)
            self._pending.append(("chunk", self._readback(chunk_tok), meta, None))
            return finished
        toks_host = chunk_tok.cpu().numpy()
        for i, req, slot in meta:
            req.tokens.append(int(toks_host[i]))
            self._activate_or_finish(slot, req)
        finished += self._admit_finished
        self._admit_finished = []
        return finished

    def run_until_drained(self, max_steps: int = 100000, num_steps: int = 1) -> List[Request]:
        out = []
        for _ in range(max_steps):
            out.extend(self.step(num_steps))
            if (not self.queue and not self.active.any() and not self._pending
                    and all(rs is None for rs in self._rows)):
                break
        return out


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xor-shift-multiply rounds) of values in [0,
    2^32) held in int64; multipliers below 2^31, so no product overflows."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def gumbel_noise(keys: torch.Tensor, positions: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, V) f32 Gumbel noise, a pure function of each row's key (two
    32-bit halves of its seed), its position and the token id: a
    counter-based stream computed on the device, independent of which
    other rows are in the batch."""
    h = _mix32(keys[:, 0] & _M32)
    h = _mix32(h ^ (keys[:, 1] & _M32))
    h = _mix32(h ^ (positions.long() & _M32))
    tok = torch.arange(vocab, device=keys.device, dtype=torch.int64)
    h = _mix32(_mix32(h[:, None] ^ tok[None, :]) ^ 0x2545F491)
    u = ((h >> 9).float() + 0.5) * 2.0**-23  # 23 bits, in (0, 1) exactly in f32
    return -torch.log(-torch.log(u))


def nucleus_logits(scaled: torch.Tensor, top_ps: torch.Tensor, topk: int = 64) -> torch.Tensor:
    """The nucleus of each row of temperature-scaled logits, the rest -inf.
    With ``0 < topk < V`` the threshold comes from the top k under the
    true softmax mass over the full vocabulary (the kept set is the full
    sort's whenever that nucleus fits in k, else the top k); else the
    exact full sort, where ``top_p >= 1`` keeps everything."""
    V = scaled.shape[-1]
    neg = torch.full_like(scaled, -torch.inf)
    if topk and topk < V:
        topv = torch.topk(scaled, topk, dim=-1).values  # sorted descending
        z = torch.logsumexp(scaled, dim=-1, keepdim=True)
        cum = torch.cumsum(torch.exp(topv - z), dim=-1)
        k = (cum < top_ps[:, None]).sum(dim=-1, keepdim=True)
        threshold = torch.gather(topv, -1, k.clamp(max=topk - 1))
        return torch.where(scaled >= threshold, scaled, neg)
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    k = (cum < top_ps[:, None]).sum(dim=-1, keepdim=True)
    threshold = torch.gather(sorted_logits, -1, k.clamp(max=V - 1))
    return torch.where((scaled >= threshold) | (top_ps[:, None] >= 1.0), scaled, neg)


def sample_tokens(
    logits: torch.Tensor,  # (B, V) f32
    keys: torch.Tensor,  # (B, 2) int64: each request's seed as two 32-bit halves
    positions: torch.Tensor,  # (B,) the position each row's draw is keyed by
    temps: torch.Tensor,  # (B,) f32; 0 = greedy
    top_ps: torch.Tensor,  # (B,) f32
    all_greedy: bool = False,  # skip the sampling machinery
    topk: int = 64,  # top-k prefilter width; 0 = the exact full-vocab sort
) -> torch.Tensor:
    """Per-row nucleus sampling (the reference's ``sample_tokens``);
    ``temps == 0`` rows take the argmax.

    The draw is a Gumbel-max over the full-vocabulary masked logits
    (``nucleus_logits``), with noise keyed by (key, ``positions[b]``, token
    id): a slot's draws do not depend on slot churn elsewhere, and the
    top-k and full-sort paths draw the same token whenever their kept sets
    agree.  The stream is not JAX's threefry: the port's sampled tokens
    are not the JAX package's sampled tokens."""
    greedy = torch.argmax(logits, dim=-1)
    if all_greedy:
        return greedy
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))[:, None]
    masked = nucleus_logits(logits / safe_t, top_ps, topk)
    sampled = torch.argmax(masked + gumbel_noise(keys, positions, logits.shape[-1]), dim=-1)
    return torch.where(temps > 0, sampled, greedy)
