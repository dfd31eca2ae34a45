"""Port parity for the decoder families beside Llama: Mistral's sliding
window, Gemma (an explicit head dim, GeLU-tanh, ``1 + w`` norms, scaled
embeddings, the tied head) and Mixtral's MoE (the dense block, the sparse
block over stacked experts, the router aux loss), each through the serving
path: ``forward_logits``, greedy ``generate`` with the activation-dtype and
the int8 cache, W8A8 on ``quantize_llm(act_quant=True)`` trees, and the
``ServingEngine``.

The same weights (a JAX ``init_params`` tree through ``load_from_jax``) and
the same numpy inputs go through the JAX package and the port in fp32 on
the CPU, where the port's kernel wrappers take their plain versions.
Tiny widths: 2 layers, hidden 64, heads 4 / 2 (Gemma's explicit head dim
32), 4 experts top-2, a window of 8 over 20 tokens.  Logits are held to
1e-5 relative (fp32 summation-order drift through two layers); tokens and
the W8A8 runs exactly."""

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
from spatialrgpt_tpu.ops import quant as jquant
from spatialrgpt_tpu.serving import generate as jgen
from spatialrgpt_tpu.utils import export as jexport
from spatialrgpt_tpu_torch import config as tconfig
from spatialrgpt_tpu_torch.constants import IMAGE_TOKEN_INDEX
from spatialrgpt_tpu_torch.data.splice import expand_rows
from spatialrgpt_tpu_torch.models import llama as tllama
from spatialrgpt_tpu_torch.models import vlm as tvlm
from spatialrgpt_tpu_torch.ops import layers as tlayers
from spatialrgpt_tpu_torch.serving import generate as tgen
from spatialrgpt_tpu_torch.serving.engine import ServingEngine
from spatialrgpt_tpu_torch.utils import weights as tweights
from spatialrgpt_tpu_torch.utils.weights import init_random_quantized, load_from_jax

REL = 1e-5  # logits and hidden states: relative to the largest |value|
WINDOW, SEQ = 8, 20
FAMILIES = {
    "mistral": dict(sliding_window=WINDOW),
    "gemma": dict(hidden_act="gelu_tanh", norm_plus_one=True, scale_embeddings=True, explicit_head_dim=32,
                  tie_word_embeddings=True, rms_norm_eps=1e-6),
    "mixtral": dict(num_experts=4, num_experts_per_tok=2, rope_theta=1e6),
}


def _cfg(c, family: str, **llm_kw):
    """A tiny composite config of one family, from each package's own config
    module: 2 decoder layers of hidden 64, GQA 4 / 2, the family's knobs."""
    return c.SpatialRGPTConfig(
        llm=c.LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256, eos_token_id=63,
                          **{**FAMILIES[family], **llm_kw}),
        vision=c.SiglipVisionConfig(hidden_size=16, intermediate_size=32, num_hidden_layers=2, num_attention_heads=2,
                                    image_size=56, patch_size=14),
        projector=c.ProjectorConfig(mm_hidden_size=16, hidden_size=64),
        region=c.RegionExtractorConfig(mm_hidden_size=16, hidden_size=64, ada_pool_size=4),
        mask_token_id=60, depth_token_id=61, num_extra_tokens=2,
    )


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_close(got: torch.Tensor, want, rel: float = REL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rel, atol=rel * float(np.abs(want).max()))


_PAIRS = {}


def _pair(family: str):
    """(JAX config, port config, JAX params, the same weights in the port),
    seed 5, made once per family."""
    if family not in _PAIRS:
        jc, tc = _cfg(jconfig, family), _cfg(tconfig, family)
        params = jax.jit(jvlm.init_params, static_argnums=1)(jax.random.PRNGKey(5), jc)
        _PAIRS[family] = (jc, tc, params, load_from_jax(_np_tree(params), tc, "cpu"))
    return _PAIRS[family]


def _ids(rng, batch=2, seq=SEQ, pad=(0, 5)):
    ids = rng.integers(0, 64, (batch, seq)).astype(np.int32)
    pos = np.tile(np.arange(seq), (batch, 1)).astype(np.int32)
    seg = np.ones((batch, seq), np.int32)
    for b, p in enumerate(pad[:batch]):
        if p:
            seg[b, seq - p:] = 0
    return ids, pos, seg


# ---------------------------------------------------------------------------
# every preset builds; what stays unported raises
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(tconfig.LLAMA_PRESETS))
def test_every_preset_builds(name):
    """``LlamaForCausalLM`` builds every preset of ``config.py`` at its full
    shapes (on the meta device): the family's modules and no refusal."""
    cfg = tconfig.LLAMA_PRESETS[name]
    with torch.device("meta"):
        model = tllama.LlamaForCausalLM(cfg, extra_vocab=2, dtype=torch.bfloat16)
    layer = model.model.layers[0]
    assert (model.lm_head is None) == cfg.tie_word_embeddings
    assert layer.self_attn.q_proj.out_features == cfg.num_attention_heads * cfg.head_dim
    assert hasattr(layer, "block_sparse_moe") == cfg.is_moe
    if cfg.is_moe:
        assert len(layer.block_sparse_moe.experts) == cfg.num_experts
        assert layer.block_sparse_moe.gate.out_features == cfg.num_experts
    assert layer.input_layernorm.plus_one == cfg.norm_plus_one


def test_knobs_that_stay_unported_raise():
    for kw in ({"hidden_act": "relu"}, {"num_experts": 4, "moe_impl": "capacity"}):
        with pytest.raises(NotImplementedError):
            tllama.LlamaForCausalLM(tconfig.LlamaConfig(hidden_size=16, num_attention_heads=2, num_key_value_heads=2,
                                                        num_hidden_layers=1, intermediate_size=32, vocab_size=8, **kw))


# ---------------------------------------------------------------------------
# forward_logits, per family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_logits_matches_jax(family):
    """Token ids (a padded row and a full one) -> f32 logits, the JAX
    package's ``forward_logits`` against the port's, on the plain and the
    kernel route (the same plain versions on the CPU)."""
    jc, tc, params, model = _pair(family)
    ids, pos, seg = _ids(np.random.default_rng(1))
    want = jax.jit(lambda p, i, q, s: jllama.forward_logits(p, jc.llm, input_ids=i, position_ids=q, segment_ids=s))(
        params["llm"], *map(jnp.asarray, (ids, pos, seg)))
    for impl in ("xla", "onepass"):
        got = tllama.forward_logits(model.llm, tc.llm, input_ids=torch.tensor(ids, dtype=torch.int64),
                                    position_ids=torch.tensor(pos, dtype=torch.int64), segment_ids=torch.tensor(seg),
                                    attn_impl=impl)
        assert tuple(got.shape) == want.shape == (2, SEQ, 66) and got.dtype == torch.float32
        _rel_close(got, want)


def test_sliding_window_binds():
    """Over 20 tokens a window of 8 changes the logits from position 8 on and
    leaves the first 8 positions as they are without it."""
    jc, tc, params, model = _pair("mistral")
    ids, pos, _ = _ids(np.random.default_rng(2), pad=(0, 0))
    args = dict(input_ids=torch.tensor(ids, dtype=torch.int64), position_ids=torch.tensor(pos, dtype=torch.int64))
    windowed = tllama.forward_logits(model.llm, tc.llm, **args)
    full = tllama.forward_logits(model.llm, dataclasses.replace(tc.llm, sliding_window=None), **args)
    torch.testing.assert_close(windowed[:, :WINDOW], full[:, :WINDOW], rtol=0, atol=0)
    assert float((windowed[:, WINDOW:] - full[:, WINDOW:]).abs().min(dim=-1).values.max()) > 0


def test_gemma_knobs_match_the_reference():
    """Gemma's pieces against the JAX package's: embeddings scaled by
    sqrt(hidden) rounded to bf16 first, the ``1 + w`` norm formed in f32 and
    cast to the activation dtype, the tied head's f32 sums over the table's
    extra rows, never rounded to bf16."""
    jc, tc, params, model = _pair("gemma")
    lc, llm = tc.llm, model.llm
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 66, (2, 5))
    bf = llm.to(torch.bfloat16)
    try:
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params["llm"])
        want = jllama.embed_tokens(jp, jnp.asarray(ids), jc.llm)
        got = tllama.embed_tokens(bf, torch.tensor(ids))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
        x = rng.standard_normal((2, 5, 64)).astype(np.float32)
        scale = rng.standard_normal(64).astype(np.float32) * 0.1
        bf.model.norm.weight.data = torch.tensor(scale, dtype=torch.bfloat16)
        want = jllama._norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale, jnp.bfloat16), jc.llm)
        got = tllama.norm(torch.tensor(x, dtype=torch.bfloat16), bf.model.norm)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
        want = jllama.logits(jp, jnp.asarray(x, jnp.bfloat16), jc.llm)
        got = tllama.logits(bf, torch.tensor(x, dtype=torch.bfloat16))
        assert got.dtype == torch.float32 and tuple(got.shape) == (2, 5, 66)
        _rel_close(got, want)
        assert not torch.equal(got, got.to(torch.bfloat16).float())  # not rounded to bf16
    finally:
        llm.float()
        _PAIRS.pop("gemma")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_scaled_embeddings_fill_their_scalar_on_the_device(dtype):
    """Gemma's embedding scale is filled on the tensor's device (a CUDA
    graph can capture it) and is bit-equal to the scalar built on the host
    and rounded to the table's dtype first, at the families' widths."""
    from types import SimpleNamespace

    rng = np.random.default_rng(5)
    ids = torch.tensor(rng.integers(0, 32, (2, 7)))
    for hidden in (64, 2048, 2304, 3072, 3584, 4096, 8192):
        table = torch.tensor(rng.standard_normal((32, 8)), dtype=dtype)
        llm = SimpleNamespace(model=SimpleNamespace(embed_tokens=SimpleNamespace(weight=table)),
                              cfg=SimpleNamespace(scale_embeddings=True, hidden_size=hidden))
        want = torch.nn.functional.embedding(ids, table) * torch.tensor(hidden**0.5, dtype=dtype)
        got = tllama.embed_tokens(llm, ids)
        assert got.dtype == dtype and torch.equal(got, want), hidden


def test_attention_bias_matches_jax():
    """q/k/v with biases (``attention_bias``): the reference's ``linear`` adds
    a ``bias`` entry of its dense dict; the port's ``nn.Linear`` holds it."""
    jc = _cfg(jconfig, "mistral", attention_bias=True)
    tc = _cfg(tconfig, "mistral", attention_bias=True)
    params = jax.jit(jvlm.init_params, static_argnums=1)(jax.random.PRNGKey(6), jc)
    rng = np.random.default_rng(6)
    for lp in params["llm"]["layers"]:
        for key in ("wq", "wk", "wv"):
            lp["attn"][key]["bias"] = jnp.asarray(rng.standard_normal(lp["attn"][key]["kernel"].shape[1]) * 0.5,
                                                  jnp.float32)
    model = load_from_jax(_np_tree(params), tc, "cpu")
    assert model.llm.model.layers[1].self_attn.k_proj.bias is not None
    ids, pos, seg = _ids(rng)
    want = jax.jit(lambda p, i, q, s: jllama.forward_logits(p, jc.llm, input_ids=i, position_ids=q, segment_ids=s))(
        params["llm"], *map(jnp.asarray, (ids, pos, seg)))
    got = tllama.forward_logits(model.llm, tc.llm, input_ids=torch.tensor(ids, dtype=torch.int64),
                                position_ids=torch.tensor(pos, dtype=torch.int64), segment_ids=torch.tensor(seg))
    _rel_close(got, want)


# ---------------------------------------------------------------------------
# MoE: dense and sparse blocks, the router tie, the aux loss
# ---------------------------------------------------------------------------


def _moe_layer(seed: int):
    jc, tc, params, model = _pair("mixtral")
    lp = params["llm"]["layers"][0]
    x = np.random.default_rng(seed).standard_normal((2, 7, 64)).astype(np.float32)
    return jc, tc, lp, model.llm.model.layers[0].block_sparse_moe, x


def test_moe_blocks_match_jax_and_each_other():
    """The dense block and the sparse block over stacked experts against
    their JAX twins (``_moe_block``, ``_moe_block_sparse`` on
    ``stack_experts``' tree): outputs within fp32 drift, the aux losses
    equal; the sparse block equals the dense one.  Without stacked experts
    the sparse block is the dense block."""
    jc, tc, lp, moe, x = _moe_layer(7)
    jdense, jdense_aux = jllama._moe_block(jnp.asarray(x), lp, jc.llm)
    jstacked = jllama.stack_experts({"layers": [lp]})["layers"][0]
    jsparse, jsparse_aux = jllama._moe_block_sparse(jnp.asarray(x), jstacked, jc.llm)
    dense, dense_aux = tllama.moe_block(torch.tensor(x), moe, tc.llm)
    unstacked, _ = tllama.moe_block_sparse(torch.tensor(x), moe, tc.llm)
    torch.testing.assert_close(unstacked, dense, rtol=0, atol=0)
    _, _, params, model = _pair("mixtral")
    try:
        tllama.stack_experts(model.llm)
        assert moe.stacked[0].shape == (4, 128, 64) and moe.stacked[2].shape == (4, 64, 128)
        assert moe.experts[3].w2.weight.data_ptr() == moe.stacked[2][3].data_ptr()  # views, one copy
        sparse, sparse_aux = tllama.moe_block_sparse(torch.tensor(x), moe, tc.llm)
    finally:
        _PAIRS.pop("mixtral")
    _rel_close(dense, jdense)
    _rel_close(sparse, jsparse)
    _rel_close(sparse, np.asarray(dense))
    for got, want in ((dense_aux, jdense_aux), (sparse_aux, jsparse_aux), (sparse_aux, np.asarray(dense_aux))):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_router_tie_keeps_every_tied_expert():
    """Experts 1 and 2 with equal router columns tie wherever they hold the
    2nd-largest probability: the dense gate (``probs >= k-th``) then keeps 3
    experts, as the reference's does, and the outputs and aux loss agree."""
    jc, tc, lp, moe, x = _moe_layer(8)
    lp = dict(lp, router={"kernel": lp["router"]["kernel"].at[:, 2].set(lp["router"]["kernel"][:, 1])})
    w = moe.gate.weight.detach().clone()
    w[2] = w[1]
    tied = type(moe)(tc.llm).requires_grad_(False)
    tied.load_state_dict(dict(moe.state_dict(), **{"gate.weight": w}))
    probs, gates = tllama.router_gates(torch.tensor(x), tied, tc.llm)
    kept = (gates > 0).sum(dim=-1)
    assert int(kept.max()) == 3 and int(kept.min()) == 2
    assert torch.equal(probs[..., 1], probs[..., 2])
    want, want_aux = jllama._moe_block(jnp.asarray(x), lp, jc.llm)
    got, got_aux = tllama.moe_block(torch.tensor(x), tied, tc.llm)
    _rel_close(got, want)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)


def test_forward_with_aux_matches_jax():
    """``forward(with_aux=True)``: the summed router aux loss of both layers
    equal to the JAX package's, and the composite forward's and
    ``loss_fn``'s (the CE plus 0.02 x the aux) too."""
    jc, tc, params, model = _pair("mixtral")
    ids, pos, seg = _ids(np.random.default_rng(9))
    x = jllama.embed_tokens(params["llm"], jnp.asarray(ids), jc.llm)
    _, _, jaux = jllama.forward(params["llm"], jc.llm, inputs_embeds=x, position_ids=jnp.asarray(pos),
                                segment_ids=jnp.asarray(seg), with_aux=True)
    h, kv, aux = tllama.forward(model.llm, tc.llm, inputs_embeds=torch.tensor(np.asarray(x)),
                                position_ids=torch.tensor(pos, dtype=torch.int64), segment_ids=torch.tensor(seg),
                                with_aux=True)
    assert kv is None and aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    sb, inputs, jin = _batch(jc)
    jlogits, jaux = jax.jit(lambda p, i: jvlm.forward(p, jc, i, with_aux=True))(params, jin)
    logits, aux = tvlm.forward(model, tc, inputs, with_aux=True)
    _rel_close(logits, jlogits)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    # the loss of a MoE decoder carries the aux loss (the families' training)
    jloss, jm = jax.jit(lambda p, i: jvlm.loss_fn(p, jc, i))(params, jin._replace(labels=jin.input_ids))
    loss, m = tvlm.loss_fn(model, tc, inputs._replace(labels=inputs.input_ids))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["router_aux_loss"]), float(jm["router_aux_loss"]), rtol=1e-5)


# ---------------------------------------------------------------------------
# the serving slice: generate (both caches, W8A8) and the engine
# ---------------------------------------------------------------------------


def _batch(jc, pad_to=12):
    """Two region-QA prompts (RGB + depth + 2 regions) of different lengths."""
    prompts = [np.array([5, IMAGE_TOKEN_INDEX, 60, 61, 8, 9], np.int64),
               np.array([IMAGE_TOKEN_INDEX, 7, 60, 61], np.int64)]
    sb = expand_rows(prompts, None, max_len=64, tokens_per_image=4, mask_token_id=60, depth_token_id=61,
                     regions_per_image=2, pad_to=pad_to)
    rng = np.random.default_rng(0)
    n, size = len(prompts), jc.vision.image_size
    pix = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    dep = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    masks = (rng.random((n, 2, size, size)) > 0.5).astype(np.float32)
    valid = np.ones((n, 2), bool)
    return sb, tvlm.VLMInputs.from_spliced(sb, pix, dep, masks, valid, "cpu"), to_vlm_inputs(sb, pix, dep, masks, valid)


def test_gemma_splice_scales_text_rows_only():
    """``prepare_embeds`` at Gemma: text rows scaled by sqrt(hidden), then the
    image and region rows written over them unscaled, as the reference's."""
    jc, tc, params, model = _pair("gemma")
    sb, inputs, jin = _batch(jc)
    want = jax.jit(jvlm.prepare_embeds, static_argnums=1)(params, jc, jin)
    got = tvlm.prepare_embeds(model, tc, inputs)
    _rel_close(got, want)


def _generate_both(family, kv_quant: bool, max_new=8, quantized=False):
    jc, tc, params, model = _pair(family)
    if quantized:
        params = dict(params, llm=jquant.quantize_llm(params["llm"], 8, True),
                      vision=jquant.quantize_llm(params["vision"], 8, True))
        model = load_from_jax(_np_tree(params), tc, "cpu")
    sb, inputs, jin = _batch(jc)
    plens = sb.segment_ids.sum(axis=1)
    want = jgen.generate(params, jc, jin, jnp.asarray(plens, jnp.int32), max_new_tokens=max_new, temperature=0.0,
                         eos_token_id=-1, kv_quant=kv_quant, attn_impl="onepass")
    got = tgen.generate(model, tc, inputs, torch.as_tensor(plens), max_new_tokens=max_new, temperature=0.0,
                        eos_token_id=-1, attn_impl="onepass", kv_quant=kv_quant)

    @jax.jit
    def first_logits(params, jin):
        h, _ = jllama.forward(params["llm"], jc.llm, inputs_embeds=jvlm.prepare_embeds(params, jc, jin),
                              position_ids=jin.position_ids, segment_ids=jin.segment_ids)
        return jllama.logits(params["llm"], h[jnp.arange(2), jnp.asarray(plens - 1)][:, None], jc.llm)[:, 0]

    return want, got, model, first_logits(params, jin)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_generate_matches_jax(family, kv_quant):
    """Greedy region-QA ``generate`` (fp32 weights; the activation-dtype cache
    and the int8 cache): the same tokens, and first-token logits within
    fp32 drift."""
    want, got, _, first = _generate_both(family, kv_quant)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    _rel_close(got.first_logits, first)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_w8a8_generate_matches_jax(family):
    """W8A8 llm and tower (``quantize_llm(act_quant=True)``: every 2-D kernel,
    the router and each expert's included; Gemma's tied table stays float)
    with the int8 cache: the same greedy tokens as the JAX ``generate``."""
    want, got, model, first = _generate_both(family, True, quantized=True)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    _rel_close(got.first_logits, first, rel=1e-4)
    quant = {n for n, m in model.llm.named_modules() if isinstance(m, tlayers.QuantLinear)}
    if family == "mixtral":
        assert {"model.layers.0.block_sparse_moe.gate", "model.layers.1.block_sparse_moe.experts.3.w2"} <= quant
    assert ("lm_head" in quant) == (family != "gemma")


@pytest.mark.parametrize("family", ["gemma", "mixtral"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_engine_matches_lockstep(family, kv_quant):
    """3 requests through 2 ``ServingEngine`` slots (the third in a recycled
    slot): each request's greedy tokens equal ``generate`` on it alone (fp32
    cache on both sides)."""
    jc, tc, params, model = _pair(family)
    tc = tc.replace(llm=dataclasses.replace(tc.llm, eos_token_id=-1))
    prompts = [[5, IMAGE_TOKEN_INDEX, 60, 8], [9, IMAGE_TOKEN_INDEX, 11, 12, 13], [IMAGE_TOKEN_INDEX, 21, 61]]
    reqs = []
    for i, p in enumerate(prompts):
        sb = expand_rows([np.asarray(p, np.int64)], None, max_len=64, tokens_per_image=4, mask_token_id=60,
                         depth_token_id=61, regions_per_image=2, pad_to=16)
        rng = np.random.default_rng(i)
        size = jc.vision.image_size
        fields = (rng.standard_normal((1, size, size, 3)).astype(np.float32),
                  rng.standard_normal((1, size, size, 3)).astype(np.float32),
                  (rng.random((1, 2, size, size)) > 0.5).astype(np.float32), np.ones((1, 2), bool))
        reqs.append((tvlm.VLMInputs.from_spliced(sb, *fields, "cpu"), int(sb.segment_ids.sum())))
    eng = ServingEngine(model, tc, num_slots=2, prompt_bucket=16, max_new_tokens=5, kv_quant=kv_quant,
                        dtype=torch.float32)
    ids = [eng.submit(x, plen, max_new_tokens=5) for x, plen in reqs]
    done = {r.request_id: r.tokens for r in eng.run_until_drained(max_steps=200)}
    for rid, (x, plen) in zip(ids, reqs):
        out = tgen.generate(model, tc, x, torch.as_tensor([plen]), max_new_tokens=5, eos_token_id=-1,
                            kv_quant=kv_quant)
        assert done[rid] == out.tokens[0].tolist()


# ---------------------------------------------------------------------------
# weights: names, quantized init
# ---------------------------------------------------------------------------


def test_export_llama_families_names():
    """On a plain Llama tree the names and arrays of ``export.export_llama``
    (the JAX package's map); on Mixtral's the router and experts under HF
    Mixtral's names; on Gemma's no ``lm_head``."""
    plain = _cfg(jconfig, "mistral")
    p = _np_tree(jax.jit(jllama.init_params, static_argnums=(1, 2, 3))(jax.random.PRNGKey(0), plain.llm,
                                                                      jnp.float32, 2))
    want, got = jexport.export_llama(p), tweights.export_llama_families(p)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    moe = _np_tree(_pair("mixtral")[2]["llm"])
    names = tweights.export_llama_families(moe)
    np.testing.assert_array_equal(names["model.layers.0.block_sparse_moe.gate.weight"], moe["layers"][0]["router"]["kernel"].T)
    np.testing.assert_array_equal(names["model.layers.1.block_sparse_moe.experts.2.w3.weight"],
                                  moe["layers"][1]["experts"][2]["up"]["kernel"].T)
    assert "model.layers.0.mlp.gate_proj.weight" not in names
    assert "lm_head.weight" not in tweights.export_llama_families(_np_tree(_pair("gemma")[2]["llm"]))
    assert tweights.llama_module_name("layers/1/router/kernel") == "model.layers.1.block_sparse_moe.gate"
    assert tweights.llama_module_name("layers/0/experts/3/down/kernel") == "model.layers.0.block_sparse_moe.experts.3.w2"
    with pytest.raises(ValueError):
        tweights.llama_module_name("layers/0/experts/3/w9/kernel")


def test_init_random_quantized_mixtral_layout():
    """``init_random_quantized`` at Mixtral: the router and every expert
    projection are W8A8 ``QuantLinear``s made in the int8 layout (no float
    weight anywhere in them); the sparse route refuses quantized experts."""
    tc = _cfg(tconfig, "mixtral")
    model = init_random_quantized(tc, "cpu", w8a8=True, seed=1, dtype=torch.float32)
    moe = model.llm.model.layers[1].block_sparse_moe
    for m in [moe.gate] + [getattr(e, n) for e in moe.experts for n in ("w1", "w3", "w2")]:
        assert isinstance(m, tlayers.QuantLinear) and m.a8 and m.q.dtype == torch.int8
    assert not any(p.dim() == 2 for p in moe.parameters())
    with pytest.raises(NotImplementedError):
        tllama.stack_experts(model.llm)
