"""Port parity for the serving engine's opt-in paths: the fused mixed-batch
chunked prefill (``serving/engine.py`` with ``prefill_chunk > 0``, its chunk
attention ``ops/attention.py::streamed_position_attention``), the int4 KV
cache of ``generate(kv_quant=True, kv_bits=4)`` (``ops/quant.py::
quantize_kv4`` / ``unpack_kv4``, K3's packed-int4 form's plain version) and
``ops/layers.py::fuse_serving_kernels``.

The same weights (a JAX ``init_params`` tree through the HF-named bridge)
and numpy inputs go through the JAX package and the port in fp32 on the
CPU, where the kernel wrappers take their plain versions.  Greedy tokens
are compared exactly; ``streamed_position_attention`` holds JAX's output at
rtol 1e-5, atol 1e-6 (f32 sums in another order); the int4 quantizer's
payload and scales are bit-equal.  The engine cases follow
``tests/test_serving_engine.py``'s chunked-prefill tests (:643-930) case by
case: several hold the port's chunked engine to the JAX chunked engine,
the rest to the port's unchunked engine, which ``test_torch_engine.py``
holds to the JAX engine.  The tensor-parallel case runs on gloo ranks in
``test_torch_tp.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialrgpt_tpu.data.dataset import to_vlm_inputs
from spatialrgpt_tpu.models import vlm as jvlm
from spatialrgpt_tpu.ops import attention as jattn
from spatialrgpt_tpu.ops import quant as jquant
from spatialrgpt_tpu.serving import engine as jengine
from spatialrgpt_tpu.serving import generate as jgen
from spatialrgpt_tpu_torch import config as tconfig
from spatialrgpt_tpu_torch.constants import IMAGE_TOKEN_INDEX
from spatialrgpt_tpu_torch.data.splice import expand_rows
from spatialrgpt_tpu_torch.models import llama as tllama
from spatialrgpt_tpu_torch.models import vlm as tvlm
from spatialrgpt_tpu_torch.ops import attention as tattn
from spatialrgpt_tpu_torch.ops import decode_attention as K3
from spatialrgpt_tpu_torch.ops import layers as tlayers
from spatialrgpt_tpu_torch.ops import quant as tquant
from spatialrgpt_tpu_torch.parallel.mesh import tp_shard_model
from spatialrgpt_tpu_torch.serving import generate as tgen
from spatialrgpt_tpu_torch.serving.engine import ServingEngine
from spatialrgpt_tpu_torch.utils.weights import load_from_jax
from test_torch_engine import MASK, PROMPTS, SIZE, TINY, TINY_T, _request

MORE_PROMPTS = PROMPTS + [[7, IMAGE_TOKEN_INDEX, 23, 24], [IMAGE_TOKEN_INDEX, 25, 26, 27], [3, IMAGE_TOKEN_INDEX, 28]]


@pytest.fixture(scope="module")
def pair():
    """(JAX params, the same weights in the port), seed 3 (the engine tests')."""
    params = jax.jit(jvlm.init_params, static_argnums=1)(jax.random.PRNGKey(3), TINY)
    return params, load_from_jax(jax.tree.map(np.asarray, params), TINY_T, "cpu")


@pytest.fixture(scope="module")
def reqs():
    """MORE_PROMPTS as (port inputs, JAX inputs, prompt length), seeds 0-5."""
    return [_request(p, i) for i, p in enumerate(MORE_PROMPTS)]


def _tokens(eng, reqs, max_new, num_steps=1, jax_side=False, **submit_kw):
    """Submit every request (``max_new(i)`` tokens each), drain, and return
    the token lists in submission order."""
    ids = [eng.submit(j if jax_side else x, plen, max_new_tokens=max_new(i), **submit_kw)
           for i, (x, j, plen) in enumerate(reqs)]
    done = {r.request_id: list(r.tokens) for r in eng.run_until_drained(max_steps=300, num_steps=num_steps)}
    assert sorted(done) == sorted(ids)
    return [done[i] for i in ids]


def _port(model, reqs, max_new, num_steps=1, **kw):
    kw = {"num_slots": 2, "prompt_bucket": 32, "max_new_tokens": 6, **kw}
    return _tokens(ServingEngine(model, TINY_T, **kw), reqs, max_new, num_steps)


def _jax(params, reqs, max_new, num_steps=1, **kw):
    kw = {"num_slots": 2, "prompt_bucket": 32, "max_new_tokens": 6, **kw}
    return _tokens(jengine.ServingEngine(params, TINY, **kw), reqs, max_new, num_steps, jax_side=True)


# ---------------------------------------------------------------------------
# streamed_position_attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Sp,block,top", [(24, 512, 23), (96, 32, 95), (96, 32, 40), (64, 16, 7)])
def test_streamed_position_attention_matches_jax(Sp, block, top):
    """Both branches against JAX's: the single-shot softmax (Sp <= block)
    and the online softmax over blocks that divide Sp, with the furthest
    attended key ``top`` in the last block or early (the loop stops
    there); GQA, two rows with different offsets."""
    rng = np.random.default_rng(Sp + top)
    R, c, Hq, Hk, D = 2, 8, 4, 2, 8
    q = rng.standard_normal((R, c, Hq, D)).astype(np.float32)
    k = rng.standard_normal((R, Sp, Hk, D)).astype(np.float32)
    v = rng.standard_normal((R, Sp, Hk, D)).astype(np.float32)
    q_idx = np.stack([np.arange(top - c + 1, top + 1), np.arange(c) + top // 3]).astype(np.int32)
    want = np.asarray(jattn.streamed_position_attention(*map(jnp.asarray, (q, k, v, q_idx)), block=block))
    got = tattn.streamed_position_attention(*map(torch.as_tensor, (q, k, v)), torch.as_tensor(q_idx).long(), block)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if Sp > block:  # the caller's bound on the host is the same loop
        hinted = tattn.streamed_position_attention(*map(torch.as_tensor, (q, k, v)), torch.as_tensor(q_idx).long(),
                                                   block, n_blocks=top // block + 1)
        np.testing.assert_array_equal(hinted.numpy(), got.numpy())


def test_streamed_position_attention_block_must_divide():
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="must divide"):
        tattn.streamed_position_attention(x, torch.zeros(1, 48, 2, 8), torch.zeros(1, 48, 2, 8),
                                          torch.zeros(1, 4, dtype=torch.long), 32)


# ---------------------------------------------------------------------------
# the int4 KV cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 5, 3, 8), (3, 40, 2, 128)])
def test_quantize_kv4_bit_equal_to_jax(shape):
    """Payload and scales bit-equal to the jitted JAX quantizer (the
    reference's ``generate`` and engine run it under jit, where XLA turns
    its division by 7 into a multiply) on f32 input, with rows of zeros, of
    one value and of .5 ties; ``unpack_kv4`` equal to JAX's."""
    rng = np.random.default_rng(shape[-1])
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 30, shape[:-1] + (1,))).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 1, 1] = 3.0
    x[1, 2, 1, :8] = np.array([7, 3.5, -3.5, 0.5, -0.5, 1.5, 2.5, -7], np.float32)
    wp, ws = map(np.asarray, jax.jit(jquant.quantize_kv4)(jnp.asarray(x)))
    gp, gs = tquant.quantize_kv4(torch.as_tensor(x))
    assert gp.dtype == torch.int8 and gp.shape == shape[:-1] + (shape[-1] // 2,)
    np.testing.assert_array_equal(gp.numpy(), wp)
    np.testing.assert_array_equal(gs.numpy(), ws)
    np.testing.assert_array_equal(tquant.unpack_kv4(gp).numpy(), np.asarray(jquant.unpack_kv4(jnp.asarray(wp))))
    with pytest.raises(ValueError, match="even"):
        tquant.quantize_kv4(torch.zeros(2, 7))


def test_int4_decode_plain_is_int8_plain_of_the_unpacked_cache():
    """K3's int4 form's plain version is ``unpack_kv4``, then the int8
    form's plain arithmetic; its wrapper takes D a multiple of 8 (the
    packed head rows are copied 4 bytes at a time) and refuses an int8
    payload's width."""
    rng = np.random.default_rng(1)
    B, C, Hq, Hk, D = 2, 12, 4, 2, 16
    q = torch.as_tensor(rng.standard_normal((B, Hq, D)).astype(np.float32))
    kq, ks = tquant.quantize_kv4(torch.as_tensor(rng.standard_normal((B, C, Hk, D)).astype(np.float32)))
    vq, vs = tquant.quantize_kv4(torch.as_tensor(rng.standard_normal((B, C, Hk, D)).astype(np.float32)))
    lengths = torch.tensor([3, 11], dtype=torch.int32)
    got = K3.decode_attention_int4_flat(q, kq.flatten(2), ks, vq.flatten(2), vs, lengths, Hk)
    want = K3.decode_attention_int8_flat_plain(q, tquant.unpack_kv4(kq).flatten(2), ks,
                                               tquant.unpack_kv4(vq).flatten(2), vs, lengths, Hk)
    np.testing.assert_array_equal(got.numpy(), want.numpy())

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    def call(D, F):
        return K3.decode_attention_int4_flat(
            meta(1, 4, D), meta(1, 16, F, dtype=torch.int8), meta(1, 16, 2, dtype=torch.float32),
            meta(1, 16, F, dtype=torch.int8), meta(1, 16, 2, dtype=torch.float32), meta(1, dtype=torch.int32), 2)

    with pytest.raises(ValueError, match="CUDA"):
        call(128, 128)
    with pytest.raises(ValueError, match="k_q"):
        call(128, 256)  # an int8 payload's width
    with pytest.raises(ValueError, match="not supported"):
        call(12, 12)  # D / 2 = 6 bytes a head row
    K3.check_shape(352, 32, 8, 128, kv_bits=4)


GENERATE_PROMPTS = ([1, 5, IMAGE_TOKEN_INDEX, MASK, 61, 7], [IMAGE_TOKEN_INDEX, 7, 9])
# tests/test_generate.py::test_fused_serving_kernels_match_unfused's prompts
FUSED_PROMPTS = ([5, IMAGE_TOKEN_INDEX, MASK, 61, 8], [IMAGE_TOKEN_INDEX, 7])


def _generate_inputs(n_rows=2, prompts=GENERATE_PROMPTS, pad_to=12):
    """tests/test_generate.py::_inputs_for: one image per row from
    ``default_rng(0)``; (port inputs, JAX inputs, prompt lengths)."""
    sb = expand_rows([np.asarray(p, np.int64) for p in prompts[:n_rows]], None, max_len=64, tokens_per_image=4,
                     mask_token_id=MASK, depth_token_id=61, regions_per_image=2, pad_to=pad_to)
    rng = np.random.default_rng(0)
    arrays = (rng.standard_normal((n_rows, SIZE, SIZE, 3)).astype(np.float32),
              rng.standard_normal((n_rows, SIZE, SIZE, 3)).astype(np.float32),
              (rng.random((n_rows, 2, SIZE, SIZE)) > 0.5).astype(np.float32), np.ones((n_rows, 2), bool))
    return (tvlm.VLMInputs.from_spliced(sb, *arrays, "cpu"), to_vlm_inputs(sb, *arrays),
            sb.segment_ids.sum(axis=1))


def test_int4_kv_generate_matches_jax(pair):
    """``generate(kv_quant=True, kv_bits=4)``: JAX's greedy tokens (the
    reference's ``test_generate.py:324`` case, two rows), with the packed
    cache's payload half the int8 one's."""
    params, model = pair
    tin, jin, plens = _generate_inputs()
    want = jgen.generate(params, TINY, jin, jnp.asarray(plens, jnp.int32), max_new_tokens=8, eos_token_id=-1,
                         kv_quant=True, kv_bits=4)
    got = tgen.generate(model, TINY_T, tin, torch.as_tensor(plens), max_new_tokens=8, eos_token_id=-1,
                        kv_quant=True, kv_bits=4)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    lc = TINY_T.llm
    cache = tgen.new_quant_cache(model.llm, lc, 2, 20, "cpu", kv_bits=4)
    assert cache.k_q.shape[-1] * 2 == lc.num_key_value_heads * lc.head_dim


def test_int4_kv_refusals(pair):
    """kv_bits other than 8 or 4, kv_bits=4 without kv_quant, and an odd
    head dim raise ``ValueError``."""
    _, model = pair
    tin, _, plens = _generate_inputs(1)
    for kw, match in ((dict(kv_quant=True, kv_bits=3), "8 or 4"), (dict(kv_bits=4), "kv_quant")):
        with pytest.raises(ValueError, match=match):
            tgen.generate(model, TINY_T, tin, torch.as_tensor(plens), max_new_tokens=2, **kw)
    odd = TINY_T.replace(llm=dataclasses.replace(TINY_T.llm, explicit_head_dim=7))
    with pytest.raises(ValueError, match="odd"):
        tgen.generate(model, odd, tin, torch.as_tensor(plens), max_new_tokens=2, kv_quant=True, kv_bits=4)


# ---------------------------------------------------------------------------
# fuse_serving_kernels
# ---------------------------------------------------------------------------


def _quantized(params):
    return dict(params, llm=jquant.quantize_llm(params["llm"], 8, True),
                vision=jquant.quantize_llm(params["vision"], 8, True))


@pytest.mark.parametrize("quantized", [False, True])
def test_fused_serving_kernels_generate(pair, quantized):
    """The reference's ``test_generate.py:251``: the fused model's greedy
    tokens equal the unfused model's and JAX's fused tree's, on float
    weights and on W8A8 int8 weights with the int8 cache; q/k/v fuse in the
    decoder and the SigLIP tower, gate/up in the MLP, int8 scales and the
    W8A8 flag carried.  The reference's weights (seed 7) and prompts: the
    fused q/k/v expand, so they take W8A8 at every row count where the
    unfused k and v (contracting) run weight-only below 2048 rows, in both
    packages; the tokens agree all the same on these inputs."""
    params = jax.jit(jvlm.init_params, static_argnums=1)(jax.random.PRNGKey(7), TINY)
    jp = _quantized(params) if quantized else params
    model = load_from_jax(jax.tree.map(np.asarray, jp), TINY_T, "cpu")
    tin, jin, plens = _generate_inputs(2, FUSED_PROMPTS, 10)
    kw = dict(max_new_tokens=8, eos_token_id=-1, kv_quant=quantized)
    base = tgen.generate(model, TINY_T, tin, torch.as_tensor(plens), **kw).tokens
    tlayers.fuse_serving_kernels(model)
    attn, mlp = model.llm.model.layers[0].self_attn, model.llm.model.layers[0].mlp
    assert hasattr(attn, "wqkv") and not hasattr(attn, "q_proj") and hasattr(mlp, "gu")
    assert hasattr(model.vision_tower.vision_model.encoder.layers[0].self_attn, "wqkv")
    if quantized:
        assert isinstance(attn.wqkv, tlayers.QuantLinear) and attn.wqkv.a8 and attn.wqkv.scale.shape == (64,)
    got = tgen.generate(model, TINY_T, tin, torch.as_tensor(plens), **kw).tokens
    want = jgen.generate(jquant.fuse_serving_kernels(jp), TINY, jin, jnp.asarray(plens, jnp.int32), **kw).tokens
    np.testing.assert_array_equal(got.numpy(), base.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_serving_kernels_engine(pair, reqs):
    """The reference's ``test_serving_engine.py:82``: the engine's decode
    and admission paths consume the fused model; the same tokens."""
    params, model = pair
    fused = load_from_jax(jax.tree.map(np.asarray, params), TINY_T, "cpu")
    tlayers.fuse_serving_kernels(fused)
    assert _port(fused, reqs[:2], lambda i: 5) == _port(model, reqs[:2], lambda i: 5)


def test_fusion_leaves_lora_int4_and_mixed_projections(pair):
    """What stays unfused: a projection carrying a LoRA side branch (the
    port's guard: the reference's ``_try_fuse`` would drop it), a packed
    int4 weight, and float siblings beside a quantized one; the logits are
    unchanged (1e-6) and MoE experts keep their names."""
    params, _ = pair
    model = load_from_jax(jax.tree.map(np.asarray, params), TINY_T, "cpu")
    layers = model.llm.model.layers
    g = torch.Generator().manual_seed(0)
    lora = tlayers.LoraBranch(torch.randn(32, 4, generator=g), torch.randn(4, 32, generator=g), 0.5)
    layers[0].self_attn.q_proj.lora = lora
    layers[1].mlp.gate_proj = tlayers.QuantLinear.from_linear(layers[1].mlp.gate_proj, bits=4)
    layers[1].self_attn.k_proj = tlayers.QuantLinear.from_linear(layers[1].self_attn.k_proj, bits=8)
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 60, (2, 9)))
    pos = torch.arange(9).expand(2, 9)
    with torch.no_grad():
        before = tllama.forward_logits(model.llm, TINY_T.llm, input_ids=ids, position_ids=pos)
        tlayers.fuse_serving_kernels(model)
        after = tllama.forward_logits(model.llm, TINY_T.llm, input_ids=ids, position_ids=pos)
    assert layers[0].self_attn.q_proj.lora is lora and not hasattr(layers[0].self_attn, "wqkv")
    assert hasattr(layers[0].mlp, "gu")
    assert not hasattr(layers[1].self_attn, "wqkv") and not hasattr(layers[1].mlp, "gu")
    np.testing.assert_allclose(after.numpy(), before.numpy(), rtol=1e-6, atol=1e-6)
    moe_cfg = tconfig.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                                  num_attention_heads=4, num_key_value_heads=2, num_experts=2, num_experts_per_tok=1)
    moe = tlayers.fuse_serving_kernels(tllama.LlamaForCausalLM(moe_cfg))
    assert hasattr(moe.model.layers[0].block_sparse_moe.experts[0], "w1")


def test_fused_model_refuses_tensor_parallelism(pair):
    """``tp_shard_model`` raises on a fused model (the reference fuses for
    single-card serving only), and a tensor-parallel model refuses the
    fusion."""

    class TP2:  # the mesh attributes read before the group
        mesh_dim_names = ("tp",)

    params, _ = pair
    model = tlayers.fuse_serving_kernels(load_from_jax(jax.tree.map(np.asarray, params), TINY_T, "cpu"))
    with pytest.raises(ValueError, match="fused"):
        tp_shard_model(model, TP2())
    plain = load_from_jax(jax.tree.map(np.asarray, params), TINY_T, "cpu")
    plain.llm.tp = object()
    with pytest.raises(ValueError, match="tensor-parallel"):
        tlayers.fuse_serving_kernels(plain)


# ---------------------------------------------------------------------------
# the fused mixed-batch chunked prefill
# ---------------------------------------------------------------------------


def _budget(i):
    return 3 + i % 4


@pytest.mark.parametrize("kv_quant,async_readback", [(False, False), (True, False), (False, True), (True, True)])
def test_chunked_engine_matches_jax(pair, reqs, kv_quant, async_readback):
    """The fused chunked engine (chunk 8, two rows in flight, windows of 2)
    gives the JAX chunked engine's greedy tokens with the bf16 and the int8
    cache, under the sync and the async scheduler, through slot churn and
    instant finishes (budgets of 3-6 tokens)."""
    params, model = pair
    kw = dict(prefill_chunk=8, chunk_rows=2, kv_quant=kv_quant, async_readback=async_readback)
    want = _jax(params, reqs[:4], _budget, 2, **kw)
    assert _port(model, reqs[:4], _budget, 2, **kw) == want


def test_chunked_matches_unchunked(pair, reqs):
    """``test_serving_engine.py:643``: chunked admission gives the unchunked
    engine's tokens, at chunk 8 and at chunk 16 with windows of 2, with both
    caches."""
    _, model = pair
    for kv_quant in (False, True):
        base = _port(model, reqs[:5], _budget, admit_width=2, kv_quant=kv_quant)
        assert _port(model, reqs[:5], _budget, admit_width=2, kv_quant=kv_quant, prefill_chunk=8) == base
        assert _port(model, reqs[:5], _budget, 2, admit_width=2, kv_quant=kv_quant, prefill_chunk=16) == base


def _long_request(seed, n_text, pad_to):
    rng = np.random.default_rng(seed)
    ids = [5, IMAGE_TOKEN_INDEX, MASK] + list(rng.integers(1, 59, n_text))
    sb = expand_rows([np.asarray(ids, np.int64)], None, max_len=256, tokens_per_image=4, mask_token_id=MASK,
                     depth_token_id=61, regions_per_image=2, pad_to=pad_to)
    arrays = (rng.standard_normal((1, SIZE, SIZE, 3)).astype(np.float32),
              rng.standard_normal((1, SIZE, SIZE, 3)).astype(np.float32),
              (rng.random((1, 2, SIZE, SIZE)) > 0.5).astype(np.float32), np.ones((1, 2), bool))
    return (tvlm.VLMInputs.from_spliced(sb, *arrays, "cpu"), to_vlm_inputs(sb, *arrays), int(sb.segment_ids.sum()))


def test_chunked_engine_streams_blocks_as_jax(pair):
    """A prompt bucket of 576 stages 576 positions, past the single-shot
    softmax's 512: the chunk attention streams blocks of 64 (the
    reference's choice), over prompts of 2-3 chunks; JAX's chunked tokens
    and the port's unchunked ones."""
    params, model = pair
    reqs = [_long_request(i, n, 160) for i, n in enumerate((80, 130, 100))]
    kw = dict(prompt_bucket=576, max_new_tokens=5)
    eng = ServingEngine(model, TINY_T, num_slots=2, prefill_chunk=64, chunk_rows=2, **kw)
    assert eng.Sp == 576 and eng._chunk_block == 64
    got = _tokens(eng, reqs, lambda i: 5)
    assert got == _jax(params, reqs, lambda i: 5, prefill_chunk=64, chunk_rows=2, **kw)
    assert got == _port(model, reqs, lambda i: 5, **kw)


def test_chunked_narrow_padded_requests(pair):
    """``test_serving_engine.py:741``: requests padded to 24 in a 48 bucket
    whose prompts exceed one chunk of 16."""
    _, model = pair
    reqs = [_long_request(i, n, 24) for i, n in enumerate((14, 12))]
    assert all(plen > 16 for _, _, plen in reqs)
    kw = dict(prompt_bucket=48, max_new_tokens=5)
    assert _port(model, reqs, lambda i: 5, prefill_chunk=16, **kw) == _port(model, reqs, lambda i: 5, **kw)


@pytest.mark.parametrize("chunk,rows,num_steps", [(8, 3, 1), (8, 1, 2), (16, 4, 3)])
def test_chunked_multiple_admissions_in_flight(pair, reqs, chunk, rows, num_steps):
    """``test_serving_engine.py:794``: several rows prefill at once beside
    the decoding slots (4 slots, 6 requests), a queue deeper than the rows
    backlogs, more rows than free slots; the unchunked tokens."""
    _, model = pair
    kw = dict(num_slots=4, admit_width=4)
    base = _port(model, reqs, _budget, **kw)
    assert _port(model, reqs, _budget, num_steps, prefill_chunk=chunk, chunk_rows=rows, **kw) == base


def test_chunked_admission_during_decode(pair, reqs):
    """``test_serving_engine.py:833``: requests arriving while slots decode;
    their chunks ride the decode windows and the decoding slots' tokens are
    unaffected."""
    _, model = pair

    def run(chunk):
        eng = ServingEngine(model, TINY_T, num_slots=3, prompt_bucket=32, max_new_tokens=8, prefill_chunk=chunk,
                            chunk_rows=2)
        ids = [eng.submit(reqs[0][0], reqs[0][2], max_new_tokens=8)]
        for _ in range(3):
            eng.step()
        ids.append(eng.submit(reqs[1][0], reqs[1][2], max_new_tokens=6))
        eng.step()
        ids.append(eng.submit(reqs[2][0], reqs[2][2], max_new_tokens=5))
        done = {r.request_id: r.tokens for r in eng.run_until_drained(max_steps=120)}
        return [done[i] for i in ids]

    assert run(8) == run(0)


def test_chunked_sampled_admissions(pair, reqs):
    """``test_serving_engine.py:864``: sampled requests beside greedy ones;
    a fused admission's first token is drawn at ``plen - 1`` as an
    unchunked one, so the port's sampled tokens are the same."""
    _, model = pair

    def run(chunk):
        eng = ServingEngine(model, TINY_T, num_slots=2, prompt_bucket=32, max_new_tokens=6, prefill_chunk=chunk,
                            chunk_rows=2)
        ids = [eng.submit(x, plen, max_new_tokens=5, temperature=0.8 if i % 2 else 0.0, top_p=0.9, seed=41 + i)
               for i, (x, _, plen) in enumerate(reqs[:3])]
        done = {r.request_id: r.tokens for r in eng.run_until_drained(max_steps=120, num_steps=2)}
        return [done[i] for i in ids]

    assert run(8) == run(0)


def test_chunked_engine_keeps_prefix_admissions(pair, reqs):
    """Prefix-cached requests keep the immediate prefill against their
    prefix beside chunked admissions; the unchunked engine's tokens."""
    _, model = pair
    prefix = _request([1, 9, 8], 0, pad_to=8, zero_pixels=True)[0]

    def run(chunk):
        eng = ServingEngine(model, TINY_T, num_slots=2, prompt_bucket=32, max_new_tokens=5, prefix_bucket=8,
                            prefill_chunk=chunk, chunk_rows=2)
        pid = eng.register_prefix(prefix, 3)
        ids = [eng.submit(x, p, max_new_tokens=4, prefix_id=pid if i == 1 else None)
               for i, (x, _, p) in enumerate(reqs[:3])]
        done = {r.request_id: r.tokens for r in eng.run_until_drained(max_steps=120)}
        return [done[i] for i in ids]

    assert run(8) == run(0)
