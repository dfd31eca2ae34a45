"""Port parity for the continuous-batching serving engine
(``spatialrgpt_tpu_torch/serving/engine.py``), its sampler, the bf16
(activation-dtype) KV cache of ``generate`` and ``llama.forward(cache=...)``.

The same weights (a JAX ``init_params`` tree through the HF-named bridge)
and the same numpy inputs go through the JAX package and the port in fp32
on the CPU, where the port's kernel wrappers take their plain versions.
Three tests construct the JAX ``ServingEngine`` (greedy tokens with the
bf16 and the int8 cache, and a prefix-cached request); the rest hold the
port engine to the port's ``generate``, which the tests of
``test_torch_models.py`` and this file hold to the JAX ``generate``, and
follow ``tests/test_serving_engine.py`` and ``tests/test_sampling.py`` case
by case.  Sampled tokens are compared only within the port: its Gumbel
stream is not JAX's threefry."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialrgpt_tpu import config as jconfig
from spatialrgpt_tpu.data.dataset import to_vlm_inputs
from spatialrgpt_tpu.models import llama as jllama
from spatialrgpt_tpu.models import vlm as jvlm
from spatialrgpt_tpu.ops import attention as jattn
from spatialrgpt_tpu.serving import engine as jengine
from spatialrgpt_tpu.serving import generate as jgen
from spatialrgpt_tpu_torch import config as tconfig
from spatialrgpt_tpu_torch.constants import IMAGE_TOKEN_INDEX
from spatialrgpt_tpu_torch.data.splice import expand_rows
from spatialrgpt_tpu_torch.models import llama as tllama
from spatialrgpt_tpu_torch.models import vlm as tvlm
from spatialrgpt_tpu_torch.ops import attention as tattn
from spatialrgpt_tpu_torch.serving import engine as tengine
from spatialrgpt_tpu_torch.serving import generate as tgen
from spatialrgpt_tpu_torch.serving.engine import ServingEngine
from spatialrgpt_tpu_torch.utils.weights import load_from_jax


def _tiny(c):
    """tests/test_serving_engine.py's config (``__graft_entry__._tiny_cfg``,
    the TINY of tests/test_generate.py), from each package's own config
    module."""
    return c.SpatialRGPTConfig(
        llm=c.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256, eos_token_id=63),
        vision=c.SiglipVisionConfig(hidden_size=16, intermediate_size=32, num_hidden_layers=2, num_attention_heads=2,
                                    image_size=56, patch_size=14),
        projector=c.ProjectorConfig(mm_hidden_size=16, hidden_size=32),
        region=c.RegionExtractorConfig(mm_hidden_size=16, hidden_size=32, ada_pool_size=4),
        mask_token_id=60, depth_token_id=61,
    )


TINY, TINY_T = _tiny(jconfig), _tiny(tconfig)
MASK, DEPTH = TINY.mask_token_id, TINY.depth_token_id
SIZE = TINY.vision.image_size


@pytest.fixture(scope="module")
def pair():
    """(JAX params, the same weights in the port), seed 3."""
    params = jax.jit(jvlm.init_params, static_argnums=1)(jax.random.PRNGKey(3), TINY)
    return params, load_from_jax(jax.tree.map(np.asarray, params), TINY_T, "cpu")


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


def _request(prompt_ids, seed, pad_to=32, zero_pixels=False):
    """tests/test_serving_engine.py::_make_request: one prompt with an image,
    its depth and 2 region masks drawn from ``seed``.  Returns (the port's
    inputs, the JAX package's, the prompt length)."""
    sb = expand_rows([np.asarray(prompt_ids, np.int64)], None, max_len=64, tokens_per_image=4, mask_token_id=MASK,
                     depth_token_id=DEPTH, regions_per_image=2, pad_to=pad_to)
    rng = np.random.default_rng(seed)
    pix = rng.standard_normal((1, SIZE, SIZE, 3)).astype(np.float32)
    dep = rng.standard_normal((1, SIZE, SIZE, 3)).astype(np.float32)
    masks = (rng.random((1, 2, SIZE, SIZE)) > 0.5).astype(np.float32)
    valid = np.ones((1, 2), bool)
    if zero_pixels:
        pix, dep, masks, valid = 0 * pix, 0 * dep, 0 * masks, ~valid
    return (tvlm.VLMInputs.from_spliced(sb, pix, dep, masks, valid, "cpu"), to_vlm_inputs(sb, pix, dep, masks, valid),
            int(sb.segment_ids.sum()))


def _engine(model, cfg=TINY_T, **kw):
    kw = {"num_slots": 2, "prompt_bucket": 32, "max_new_tokens": 5, **kw}
    return ServingEngine(model, cfg, **kw)


def _run(eng, reqs, max_new=5, num_steps=1, **submit_kw):
    """Submit (inputs, plen) pairs, drain, return the token lists in order."""
    ids = [eng.submit(inputs, plen, max_new_tokens=max_new, **submit_kw) for inputs, plen in reqs]
    done = {r.request_id: r.tokens for r in eng.run_until_drained(max_steps=200, num_steps=num_steps)}
    assert sorted(done) == sorted(ids)
    return [done[i] for i in ids]


def _lockstep(model, inputs, plen, max_new, kv_quant=False, eos=-1):
    out = tgen.generate(model, TINY_T, inputs, torch.as_tensor([plen]), max_new_tokens=max_new, eos_token_id=eos,
                        kv_quant=kv_quant)
    return out.tokens[0, : int(out.num_generated[0])].tolist()


PROMPTS = [[5, IMAGE_TOKEN_INDEX, MASK, 8], [9, IMAGE_TOKEN_INDEX, 11, 12, 13], [IMAGE_TOKEN_INDEX, 21, 22]]


# ---------------------------------------------------------------------------
# the repair: generate's bf16 cache at its defaults
# ---------------------------------------------------------------------------


def test_generate_defaults_match_jax(pair):
    """With default arguments both packages' ``generate`` run the
    activation-dtype cache (``kv_quant=False``): the same greedy tokens and
    num_generated, over two rows of different prompt lengths."""
    params, model = pair
    prompts = [np.array([5, IMAGE_TOKEN_INDEX, MASK, DEPTH, 8], np.int64),
               np.array([IMAGE_TOKEN_INDEX, 7, MASK], np.int64)]
    sb = expand_rows(prompts, None, max_len=64, tokens_per_image=4, mask_token_id=MASK, depth_token_id=DEPTH,
                     regions_per_image=2, pad_to=10)
    rng = np.random.default_rng(0)
    pix = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    dep = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    masks = (rng.random((2, 2, SIZE, SIZE)) > 0.5).astype(np.float32)
    valid = np.ones((2, 2), bool)
    plens = sb.segment_ids.sum(axis=1)
    want = jgen.generate(params, TINY, to_vlm_inputs(sb, pix, dep, masks, valid), jnp.asarray(plens, jnp.int32),
                         max_new_tokens=8, eos_token_id=-1)
    got = tgen.generate(model, TINY_T, tvlm.VLMInputs.from_spliced(sb, pix, dep, masks, valid, "cpu"),
                        torch.as_tensor(plens), max_new_tokens=8, eos_token_id=-1)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.num_generated.numpy(), np.asarray(want.num_generated))


def test_forward_with_cache_and_decode_attention_match_jax(pair):
    """``llama.forward(cache=...)``: a 7-token prompt prefilled into a
    16-position cache, then 5 more tokens against it (the engine's prefix
    path), hidden states and cache against the JAX incremental prefill; and
    ``decode_attention`` alone at two GQA widths and a multi-token query."""
    params, model = pair
    rng = np.random.default_rng(4)
    H = TINY.llm.hidden_size
    x = rng.standard_normal((2, 12, H)).astype(np.float32)
    pos = np.tile(np.arange(12), (2, 1))
    jcache = jllama.KVCache.init(TINY.llm, 2, 16, jnp.float32)
    tcache = tllama.KVCache.init(TINY_T.llm, 2, 16, torch.float32)
    for sl in (slice(0, 7), slice(7, 12)):
        jh, jcache = jllama.forward(params["llm"], TINY.llm, inputs_embeds=jnp.asarray(x[:, sl]),
                                    position_ids=jnp.asarray(pos[:, sl]), cache=jcache)
        th, tcache = tllama.forward(model.llm, TINY_T.llm, inputs_embeds=torch.tensor(x[:, sl]),
                                    position_ids=torch.tensor(pos[:, sl]), cache=tcache)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=2e-5, rtol=1e-4)
    assert tcache.length == int(jcache.length) == 12
    np.testing.assert_allclose(tcache.k.numpy(), np.stack([np.asarray(a) for a in jcache.k]), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(tcache.v.numpy(), np.stack([np.asarray(a) for a in jcache.v]), atol=2e-5, rtol=1e-4)
    for hq, hk, s, kv_len in ((4, 2, 1, 9), (8, 2, 3, 20), (2, 2, 2, 5)):
        q = rng.standard_normal((2, s, hq, 16)).astype(np.float32)
        k = rng.standard_normal((2, 24, hk, 16)).astype(np.float32)
        v = rng.standard_normal((2, 24, hk, 16)).astype(np.float32)
        want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len, jnp.int32))
        got = tattn.decode_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), kv_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the engine against the JAX ServingEngine (the three tests that build it)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", [False, True])
def test_engine_greedy_matches_jax(pair, kv_quant):
    """3 requests through 2 slots (the third in a recycled slot), greedy,
    with the bf16 cache (the reference's default dtype) and with the int8
    cache: the JAX engine's tokens."""
    params, model = pair
    reqs = [_request(p, seed=i) for i, p in enumerate(PROMPTS)]
    jeng = jengine.ServingEngine(params, TINY, num_slots=2, prompt_bucket=32, max_new_tokens=5, kv_quant=kv_quant)
    jids = [jeng.submit(j, plen, max_new_tokens=5) for _, j, plen in reqs]
    jdone = {r.request_id: r.tokens for r in jeng.run_until_drained(max_steps=50)}
    want = [jdone[i] for i in jids]
    got = _run(_engine(model, kv_quant=kv_quant), [(t, plen) for t, _, plen in reqs])
    assert got == want


def _prefix_setup(prefix_ids, suffix_ids, seed):
    """The prefix (zero pixels, 16 bucket) and the suffix request (16
    bucket, pixels from ``seed``), each package's."""
    prefix = _request(prefix_ids, 0, pad_to=16, zero_pixels=True)
    suffix = _request(suffix_ids, seed, pad_to=16)
    return prefix, suffix


def test_prefix_cached_request_matches_jax(pair):
    """A request submitted with a registered prefix (prefix K/V reused, only
    the suffix prefilled through ``llama.forward(cache=...)``) gives the JAX
    engine's tokens with both caches, and the tokens of the whole prompt
    prefilled at once (tests/test_serving_engine.py's check)."""
    params, model = pair
    prefix_ids = [1, 9, 8, 7, 6]
    suffix_ids = [IMAGE_TOKEN_INDEX, MASK, DEPTH, 17, 19]
    (tp, jp, _), (ts, js, slen) = _prefix_setup(prefix_ids, suffix_ids, 3)
    full_t, _, full_len = _request(prefix_ids + suffix_ids, 3)
    base = _run(_engine(model, num_slots=1), [(full_t, full_len)])[0]
    for kv_quant in (False, True):
        jeng = jengine.ServingEngine(params, TINY, num_slots=1, prompt_bucket=16, max_new_tokens=5, prefix_bucket=16,
                                     kv_quant=kv_quant)
        jpid = jeng.register_prefix(jp, len(prefix_ids))
        jeng.submit(js, slen, max_new_tokens=5, prefix_id=jpid)
        want = jeng.run_until_drained()[0].tokens
        eng = _engine(model, num_slots=1, prompt_bucket=16, prefix_bucket=16, kv_quant=kv_quant)
        pid = eng.register_prefix(tp, len(prefix_ids))
        got = _run(eng, [(ts, slen)], prefix_id=pid)[0]
        assert got == want == base, (kv_quant, got, want, base)


# ---------------------------------------------------------------------------
# the engine against the port's lockstep generate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", [False, True])
def test_continuous_batching_matches_lockstep(model, kv_quant):
    """3 requests through 2 slots: each request's tokens equal ``generate``
    on it alone (fp32 cache on both sides, so the same arithmetic)."""
    reqs = [_request(p, seed=i) for i, p in enumerate(PROMPTS)]
    got = _run(_engine(model, kv_quant=kv_quant, dtype=torch.float32), [(t, plen) for t, _, plen in reqs])
    assert got == [_lockstep(model, t, plen, 5, kv_quant) for t, _, plen in reqs]


@pytest.mark.parametrize("prefill_chunk", [0, 8], ids=["plain", "fused"])
def test_engine_state_keeps_its_storage(model, prefill_chunk):
    """The CPU runs every decode window eagerly, plain or fused
    (``graph_stats``: no capture, no replay, one eager window a decoding
    ``step``), updates ``lengths``, ``last_token`` and the four per-slot
    sampling buffers in place (the storage a CUDA graph's replays read and
    write), and its tokens still equal ``generate``'s."""
    reqs = [_request(p, seed=i) for i, p in enumerate(PROMPTS)]
    eng = _engine(model, kv_quant=True, dtype=torch.float32, prefill_chunk=prefill_chunk)
    state = (eng.lengths, eng.last_token, *eng._sched)
    ptrs = [t.data_ptr() for t in state]
    windows = []
    for name in ("_decode_window", "_run_fused_window"):
        setattr(eng, name, lambda *a, fn=getattr(eng, name): windows.append(a[0]) or fn(*a))
    got = _run(eng, [(t, plen) for t, _, plen in reqs], num_steps=2)
    after = (eng.lengths, eng.last_token, *eng._sched)
    assert all(a is b for a, b in zip(state, after)) and [t.data_ptr() for t in after] == ptrs
    assert got == [_lockstep(model, t, plen, 5, kv_quant=True) for t, _, plen in reqs]
    assert not eng._graph_window and not eng._graphs
    assert windows == [2] * len(windows) and eng.graph_stats == {"captures": 0, "replays": 0, "eager": len(windows)}


def _four_requests():
    prompts = [[1, IMAGE_TOKEN_INDEX, MASK, DEPTH, 7, 9], [1, IMAGE_TOKEN_INDEX, 11, 12, 13],
               [1, IMAGE_TOKEN_INDEX, MASK, 21], [1, IMAGE_TOKEN_INDEX, 31, 32]]
    return [(t, plen) for t, _, plen in (_request(p, i) for i, p in enumerate(prompts))]


def test_batched_admission_matches_sequential(model):
    """One 4-way batched prefill gives the tokens of four one-at-a-time
    admissions (one slot), for both caches."""
    reqs = _four_requests()
    for kv_quant in (False, True):
        assert _run(_engine(model, num_slots=4, kv_quant=kv_quant), reqs) == \
            _run(_engine(model, num_slots=1, kv_quant=kv_quant), reqs)


def test_wide_admission_matches_narrow(model):
    """16 requests through 16 slots prefill as one 16-way batch: the tokens
    of width-1 admission."""
    reqs = [(t, plen) for t, _, plen in (_request([1, IMAGE_TOKEN_INDEX, MASK, 5 + i], i) for i in range(16))]

    def run(width):
        return _run(_engine(model, num_slots=16, max_new_tokens=4, admit_width=width), reqs, max_new=4)

    assert run(16) == run(1)


def test_multistep_matches_single_step(model):
    """step(num_steps=3) windows: the tokens of one step per round trip."""
    reqs = _four_requests()[:3]
    for kv_quant in (False, True):
        def run(k):
            return _run(_engine(model, max_new_tokens=7, kv_quant=kv_quant), reqs, max_new=7, num_steps=k)

        assert run(3) == run(1)


def test_async_readback_matches_sync(model):
    """Readbacks one step() late, with slot churn (5 requests, 2 slots),
    budgets of 3-6 tokens and windows of 1 and 2 steps: the synchronous
    scheduler's tokens."""
    prompts = PROMPTS + [[7, IMAGE_TOKEN_INDEX, 23, 24], [IMAGE_TOKEN_INDEX, 25]]
    reqs = [(t, plen) for t, _, plen in (_request(p, i) for i, p in enumerate(prompts))]

    def run(async_mode, num_steps):
        eng = _engine(model, max_new_tokens=6, admit_width=2, async_readback=async_mode)
        ids = [eng.submit(t, plen, max_new_tokens=3 + (i % 4)) for i, (t, plen) in enumerate(reqs)]
        done = {r.request_id: r.tokens for r in eng.run_until_drained(max_steps=80, num_steps=num_steps)}
        assert not eng._pending and not eng.active.any()
        return [done[i] for i in ids]

    for num_steps in (1, 2):
        assert run(True, num_steps) == run(False, num_steps), num_steps


def test_async_readback_instant_finish_requests(model):
    """max_new_tokens=1 requests under async readback: activated
    optimistically, then truncated to their one token, slots recycled."""
    reqs = [(t, plen) for t, _, plen in (_request(p, i) for i, p in enumerate(PROMPTS))]
    eng = _engine(model, num_slots=1, max_new_tokens=4, async_readback=True)
    got = _run(eng, reqs, max_new=1)
    assert got == [_lockstep(model, t, plen, 1) for t, plen in reqs]
    assert not eng.active.any() and not eng._pending


def test_prefetch_submit_matches_host_submit(model):
    """submit(prefetch=True) (pixels moved at submit, concatenated as
    tensors) against numpy inputs concatenated on the host."""
    reqs = [(t, plen) for t, _, plen in (_request([1, IMAGE_TOKEN_INDEX, MASK, 5 + i], i) for i in range(3))]
    host = [(tvlm.VLMInputs(**{f: None if v is None else v.numpy() for f, v in t._asdict().items()}), plen)
            for t, plen in reqs]
    assert _run(_engine(model, max_new_tokens=4), reqs, max_new=4, prefetch=True) == \
        _run(_engine(model, max_new_tokens=4), host, max_new=4)


def test_mixed_prefix_and_plain_queue(model):
    """Plain, prefix-cached, plain: admission splits at the prefix request;
    each plain request gets its lockstep tokens, the prefixed one its
    whole-prompt tokens."""
    eng = _engine(model, num_slots=3, prompt_bucket=16, max_new_tokens=4, prefix_bucket=16)
    (tp, _, _), (suf, _, ps) = _prefix_setup([1, 9, 8], [IMAGE_TOKEN_INDEX, MASK, 17], 2)
    pid = eng.register_prefix(tp, 3)
    plain1, _, p1 = _request([1, IMAGE_TOKEN_INDEX, 11, 12], 1, pad_to=16)
    plain2, _, p2 = _request([1, IMAGE_TOKEN_INDEX, 21], 3, pad_to=16)
    ids = [eng.submit(plain1, p1, max_new_tokens=4), eng.submit(suf, ps, max_new_tokens=4, prefix_id=pid),
           eng.submit(plain2, p2, max_new_tokens=4)]
    done = {r.request_id: r.tokens for r in eng.run_until_drained()}
    full, _, full_len = _request([1, 9, 8, IMAGE_TOKEN_INDEX, MASK, 17], 2)
    assert done[ids[0]] == _lockstep(model, plain1, p1, 4)
    assert done[ids[1]] == _lockstep(model, full, full_len, 4)
    assert done[ids[2]] == _lockstep(model, plain2, p2, 4)


def test_mixed_modality_admission_batches_separately(model):
    """A request without depth and one with depth never share an admission
    batch; each gets its solo tokens."""
    with_depth, _, lw = _request([1, IMAGE_TOKEN_INDEX, MASK, DEPTH, 7], 0)
    base, _, ln = _request([9, IMAGE_TOKEN_INDEX, MASK, 11], 1)
    no_depth = base._replace(depths=None)
    eng = _engine(model, max_new_tokens=4)
    assert eng._modality_signature(no_depth) != eng._modality_signature(with_depth)
    got = _run(eng, [(no_depth, ln), (with_depth, lw)], max_new=4)
    assert got == [_run(_engine(model, max_new_tokens=4), [r], max_new=4)[0]
                   for r in ((no_depth, ln), (with_depth, lw))]


def test_submit_capacity_overflow_rejected(model):
    """A request that cannot fit the cache, or names an unknown prefix, is
    refused at submit(); one within budget runs."""
    eng = _engine(model, num_slots=1, max_new_tokens=4)
    inputs, _, plen = _request([1, IMAGE_TOKEN_INDEX, 5], 0)
    with pytest.raises(ValueError, match="capacity"):
        eng.submit(inputs, plen, max_new_tokens=eng.capacity)
    with pytest.raises(ValueError, match="prefix_id"):
        eng.submit(inputs, plen, max_new_tokens=2, prefix_id=123)
    assert [len(t) for t in _run(eng, [(inputs, plen)], max_new=4)] == [4]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_row_at_capacity_inside_a_window(model, kv_quant):
    """Request A fills the cache exactly (prompt + budget = capacity) and
    ends mid-window, so the window's later steps would write past the
    cache; B decodes on in the same windows.  Nothing raises, A's and B's
    tokens equal their lockstep tokens, every length stays below C."""
    a, _, pa = _request([1, IMAGE_TOKEN_INDEX, MASK, 9, 10, 11, 12, 13, 14, 15, 16], 1)
    b, _, pb = _request([5, IMAGE_TOKEN_INDEX, 8], 0)
    eng = _engine(model, max_new_tokens=8, kv_quant=kv_quant, dtype=torch.float32)
    C = eng.capacity
    na, nb = C - pa, C - pb
    # A's last window runs past its last token, and B decodes through it
    assert (na - 1) % 8 and nb - 1 >= -(-(na - 1) // 8) * 8
    ids = [eng.submit(a, pa, max_new_tokens=na), eng.submit(b, pb, max_new_tokens=nb)]
    done = {r.request_id: r.tokens for r in eng.run_until_drained(num_steps=8)}
    assert done[ids[0]] == _lockstep(model, a, pa, na, kv_quant)
    assert done[ids[1]] == _lockstep(model, b, pb, nb, kv_quant)
    assert int(eng.lengths.max()) <= C - 1 and eng.lengths.dtype == torch.int32


def test_output_lengths_match_generate_eos_counting(model):
    """The prefill token counts against max_new_tokens and stops on eos, as
    in ``generate``: max_new_tokens=1 returns the first token alone; an eos
    at the first token ends the request at admission; an eos mid-decode
    ends it with the eos, as ``generate``'s num_generated counts."""
    inputs, _, plen = _request([5, IMAGE_TOKEN_INDEX, MASK, 8], 0)
    eng = _engine(model, max_new_tokens=4)
    assert _run(eng, [(inputs, plen)], max_new=1) == [_lockstep(model, inputs, plen, 1)]
    assert not eng.active.any()
    toks = _lockstep(model, inputs, plen, 6)
    for eos in (toks[0], next(t for t in toks if t != toks[0])):
        cfg = dataclasses.replace(TINY_T, llm=dataclasses.replace(TINY_T.llm, eos_token_id=eos))
        for num_steps in (1, 4):
            eng = _engine(model, cfg, max_new_tokens=6)
            got = _run(eng, [(inputs, plen)], max_new=6, num_steps=num_steps)[0]
            assert got == _lockstep(model, inputs, plen, 6, eos=eos) == toks[: toks.index(eos) + 1]
            assert not eng.active.any()


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def _jax_kept(monkeypatch, logits, temps, top_ps, topk):
    """The JAX ``sample_tokens``' kept set per row (the logits its
    categorical draws over, finite) and its tokens, with ``jax.vmap`` as a
    loop so the categorical sees concrete rows."""
    seen = []

    def categorical(key, row):
        seen.append(np.isfinite(np.asarray(row)))
        return jnp.asarray(0, jnp.int32)

    def loop_vmap(f):
        return lambda *args: jnp.stack([f(*(a[i] for a in args)) for i in range(args[0].shape[0])])

    monkeypatch.setattr(jax, "vmap", loop_vmap)
    monkeypatch.setattr(jax.random, "categorical", categorical)
    B = logits.shape[0]
    toks = jengine.sample_tokens(jnp.asarray(logits), jnp.zeros((B, 2), jnp.uint32), jnp.arange(B, dtype=jnp.int32),
                                 jnp.asarray(temps), jnp.asarray(top_ps), topk=topk)
    monkeypatch.undo()
    return np.stack(seen), np.asarray(toks)


@pytest.mark.parametrize("topk", [64, 8, 0])
def test_sample_tokens_kept_set_and_greedy_rows_match_jax(monkeypatch, topk):
    """The nucleus the draw is made from (top-k prefilter or full sort)
    equals JAX's on the same logits, rows of several temperatures and
    top_p; temperature-0 rows equal JAX's argmax; sampled tokens lie in the
    kept set."""
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((6, 300)) * 3).astype(np.float32)
    temps = np.asarray([0.0, 1.0, 0.7, 0.0, 1.3, 0.5], np.float32)
    top_ps = np.asarray([0.9, 0.9, 0.5, 0.3, 1.0, 0.05], np.float32)
    want_kept, want_toks = _jax_kept(monkeypatch, logits, temps, top_ps, topk)
    safe_t = np.where(temps > 0, temps, 1.0)[:, None]
    kept = torch.isfinite(tengine.nucleus_logits(torch.tensor(logits / safe_t), torch.tensor(top_ps), topk)).numpy()
    np.testing.assert_array_equal(kept, want_kept)
    keys = torch.tensor(rng.integers(0, 2**32, (6, 2)), dtype=torch.int64)
    got = tengine.sample_tokens(torch.tensor(logits), keys, torch.arange(6), torch.tensor(temps), torch.tensor(top_ps),
                                topk=topk).numpy()
    greedy = temps == 0
    np.testing.assert_array_equal(got[greedy], want_toks[greedy])
    assert kept[np.arange(6), got].all()


def _draws(logits_row, top_p, topk, n=4000, temp=1.0):
    """n draws from one logits row: the same key, positions 0..n-1."""
    v = logits_row.shape[-1]
    return tengine.sample_tokens(
        torch.tensor(logits_row).expand(n, v), torch.tensor([[7, 1234]]).expand(n, 2), torch.arange(n),
        torch.full((n,), temp), torch.full((n,), top_p), topk=topk,
    ).numpy()


def test_topk_and_full_sort_draw_the_nucleus_distribution():
    """tests/test_sampling.py's check: peaked logits whose nucleus fits in
    k; both paths sample inside the nucleus with its renormalized
    probabilities (total variation < 0.05 over 4000 draws) and draw the
    same tokens (the noise is keyed by token id).  Flat logits at top_p 1
    truncate to the top k on the top-k path only."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(512) * 3.0).astype(np.float32)
    order = np.argsort(-x.astype(np.float64))
    probs = np.exp(x - x.max())
    probs /= probs.sum()
    keep = order[: int(np.sum(np.cumsum(probs[order]) < 0.9)) + 1]
    nucleus = dict(zip(keep.tolist(), (probs[keep] / probs[keep].sum()).tolist()))
    assert len(nucleus) < 64
    draws = {topk: _draws(x, 0.9, topk) for topk in (64, 0)}
    for topk, s in draws.items():
        assert set(s.tolist()) <= set(nucleus), topk
        tv = 0.5 * sum(abs(np.mean(s == t) - p) for t, p in nucleus.items())
        assert tv < 0.05, (topk, tv)
    assert (draws[64] == draws[0]).all()
    flat = (rng.standard_normal(512) * 0.01).astype(np.float32)
    assert set(_draws(flat, 1.0, 64, n=2000).tolist()) <= set(np.argsort(-flat)[:64].tolist())
    assert len(set(_draws(flat, 1.0, 0, n=2000).tolist())) > 64
    small = rng.standard_normal((6, 32)).astype(np.float32)  # topk >= V: the full sort
    keys = torch.tensor(rng.integers(0, 2**32, (6, 2)), dtype=torch.int64)
    args = (torch.tensor(small), keys, torch.arange(6), torch.full((6,), 0.8), torch.full((6,), 0.95))
    assert torch.equal(tengine.sample_tokens(*args, topk=64), tengine.sample_tokens(*args, topk=0))


def test_sampled_draws_invariant_to_slot_churn(model):
    """A sampled request emits the same tokens alone or admitted late into a
    busy pool (its stream is keyed by seed and position, not slot or
    step)."""
    target, _, tlen = _request([1, IMAGE_TOKEN_INDEX, MASK, 7], 5)
    kw = dict(max_new_tokens=6, temperature=0.8, top_p=0.9, seed=1234)
    eng = _engine(model, max_new_tokens=6)
    rid = eng.submit(target, tlen, **kw)
    solo = {r.request_id: r.tokens for r in eng.run_until_drained()}[rid]
    busy = _engine(model, max_new_tokens=6)
    f1, _, l1 = _request([9, IMAGE_TOKEN_INDEX, 11, 12], 0)
    f2, _, l2 = _request([IMAGE_TOKEN_INDEX, 21, 22], 1)
    busy.submit(f1, l1, max_new_tokens=6, temperature=0.5, seed=7)
    busy.submit(f2, l2, max_new_tokens=6)
    busy.step(2)
    rid = busy.submit(target, tlen, **kw)
    assert {r.request_id: r.tokens for r in busy.run_until_drained()}[rid] == solo
    other = _engine(model, max_new_tokens=6)
    rid = other.submit(target, tlen, **{**kw, "seed": 99})
    assert {r.request_id: r.tokens for r in other.run_until_drained()}[rid] != solo


def test_near_greedy_matches_greedy_in_mixed_pool(model):
    """temperature 1e-4 gives the greedy tokens, beside a greedy request in
    the same decode batch (per-slot temperatures)."""
    ra, _, la = _request([1, IMAGE_TOKEN_INDEX, 5, 8], 0)
    rb, _, lb = _request([9, IMAGE_TOKEN_INDEX, 11], 1)
    ref = _run(_engine(model), [(ra, la), (rb, lb)])
    eng = _engine(model)
    ja = eng.submit(ra, la, max_new_tokens=5, temperature=1e-4, top_p=1.0, seed=99)
    jb = eng.submit(rb, lb, max_new_tokens=5)
    mix = {r.request_id: r.tokens for r in eng.run_until_drained()}
    assert [mix[ja], mix[jb]] == ref


def test_unported_arguments_and_k3_shapes_raise(model):
    """A tensor-parallel mesh whose tp does not divide the kv heads raises
    the reference's ``ValueError`` (the mesh itself runs in
    tests/test_torch_tp.py); an unknown attention impl ``ValueError``; and
    the shape rule an engine checks at construction on the card refuses a
    capacity whose scores overflow K3's shared memory at llama3-8b's heads."""

    class TP3:  # the two DeviceMesh methods the engine reads, tp = 3
        mesh_dim_names = ("tp",)

        def size(self, dim):
            return 3

    with pytest.raises(ValueError, match="must divide the kv-head count"):
        _engine(model, mesh=TP3())
    with pytest.raises(ValueError, match="attention impl"):
        _engine(model, attn_impl="pallas")
    from spatialrgpt_tpu_torch.ops.decode_attention import check_shape

    check_shape(448, 32, 8, 128)  # bench_engine.py's cache: 384 + 64
    with pytest.raises(ValueError, match="shared memory"):
        check_shape(32768 + 8, 32, 8, 128)  # 4 query heads per kv head: C <= 32768
