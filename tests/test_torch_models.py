"""Port parity for the models of the serving slice and for the slice as a
whole: the same weights (bridged from a JAX ``init_params`` pytree through
the HF-named export) and the same numpy inputs go through the JAX function
and its port counterpart, in fp32 on the CPU, where the port's kernel
wrappers take their plain versions and the JAX package routes SigLIP and
the onepass prefill to XLA.

Tolerances are fp32 accumulation-order drift through a few layers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialrgpt_tpu import config as jconfig
from spatialrgpt_tpu.data.dataset import to_vlm_inputs
from spatialrgpt_tpu.models import llama as jllama
from spatialrgpt_tpu.models import projector as jproj
from spatialrgpt_tpu.models import region_extractor as jre
from spatialrgpt_tpu.models import siglip as jsiglip
from spatialrgpt_tpu.models import vlm as jvlm
from spatialrgpt_tpu.serving import generate as jgen
from spatialrgpt_tpu_torch import config as tconfig
from spatialrgpt_tpu_torch.constants import IMAGE_TOKEN_INDEX
from spatialrgpt_tpu_torch.data.splice import expand_rows
from spatialrgpt_tpu_torch.models import llama as tllama
from spatialrgpt_tpu_torch.models import projector as tproj
from spatialrgpt_tpu_torch.models import region_extractor as tre
from spatialrgpt_tpu_torch.models import siglip as tsiglip
from spatialrgpt_tpu_torch.models import vlm as tvlm
from spatialrgpt_tpu_torch.serving import generate as tgen
from spatialrgpt_tpu_torch.utils.weights import init_random, load_from_jax


def _configs(c):
    """tests/test_generate.py's TINY (SigLIP 2 layers / 16 wide, Llama 2
    layers / 32 wide with GQA 4q/2kv, 2 regions per image) and PARITY.md's
    fixture widths for the single-module tests, built from one config
    module: each package's own."""
    tiny = c.SpatialRGPTConfig(
        llm=c.LlamaConfig(
            vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256, eos_token_id=63,
        ),
        vision=c.SiglipVisionConfig(
            hidden_size=16, intermediate_size=32, num_hidden_layers=2, num_attention_heads=2,
            image_size=56, patch_size=14,
        ),
        projector=c.ProjectorConfig(mm_hidden_size=16, hidden_size=32),
        region=c.RegionExtractorConfig(mm_hidden_size=16, hidden_size=32, ada_pool_size=4),
        mask_token_id=60,
        depth_token_id=61,
    )
    siglip = c.SiglipVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
        image_size=56, patch_size=14, select_layer=-2, select_feature="patch",
    )
    llama = c.LlamaConfig(
        vocab_size=96, hidden_size=48, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, rope_theta=500000.0, rope_scaling_factor=2.0,
    )
    return tiny, siglip, llama


# the JAX package's configs go to its functions, the port's to the port's
TINY, SIGLIP, LLAMA = _configs(jconfig)
TINY_T, SIGLIP_T, LLAMA_T = _configs(tconfig)
ATOL = 2e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, atol=ATOL, rtol=1e-4):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# single modules, weights through the bridge
# ---------------------------------------------------------------------------


def _init(cfg, seed):
    return jax.jit(jvlm.init_params, static_argnums=1)(jax.random.PRNGKey(seed), cfg)


@pytest.fixture(scope="module")
def tiny():
    params = _init(TINY, 7)
    return params, load_from_jax(_np_tree(params), TINY_T, "cpu")


def test_siglip_forward_features_and_full(tiny):
    params = dict(tiny[0], vision=jax.jit(jsiglip.init_params, static_argnums=1)(jax.random.PRNGKey(1), SIGLIP))
    model = load_from_jax(_np_tree(params), TINY_T.replace(vision=SIGLIP_T), "cpu")
    px = np.random.default_rng(0).standard_normal((3, 56, 56, 3)).astype(np.float32)
    want = jax.jit(jsiglip.forward_features, static_argnums=2)(params["vision"], jnp.asarray(px), SIGLIP)
    got = tsiglip.forward_features(model.vision_tower, torch.tensor(px), SIGLIP_T)
    assert tuple(got.shape) == want.shape == (3, 15, 32)  # 'patch' drops token 0
    _close(got, want)
    want = jax.jit(jsiglip.forward_full, static_argnums=2)(params["vision"], jnp.asarray(px), SIGLIP)
    got = tsiglip.forward_full(model.vision_tower, torch.tensor(px), SIGLIP_T)
    _close(got, want, atol=1e-4)  # post-LN renormalizes to unit scale


def test_projector_odd_grid(tiny):
    params, model = tiny
    x = np.random.default_rng(1).standard_normal((2, 25, 16)).astype(np.float32)  # 5x5 -> pad to 6x6 -> 9 tokens
    want = jproj.forward(params["projector"], jnp.asarray(x), TINY.projector)
    got = tproj.forward(model.mm_projector, torch.tensor(x), TINY_T.projector)
    assert tuple(got.shape) == want.shape == (2, 9, 32)
    _close(got, want)


def test_region_extractor(tiny):
    """Refinement (deconv x2, LN, GELU, adaptive pool), mask pooling with a
    mask size that is not a multiple of the grid, and the depth branch on
    the RAW tower features."""
    params, model = tiny
    cfg = TINY.region
    rng = np.random.default_rng(2)
    tower = rng.standard_normal((2, 9, 16)).astype(np.float32)  # 3x3 grid -> 12x12 refined
    depth = rng.standard_normal((2, 9, 16)).astype(np.float32)
    masks = (rng.random((2, 2, 30, 30)) > 0.4).astype(np.float32)

    @jax.jit
    def ref(p, tower, depth, masks):
        h, lres = jre.feature_refinement(p, tower, cfg)
        return h, lres, jre.mask_pool(h, masks), jre.extract_regions(p, h, depth, masks, cfg)

    jh, jlres, jpool, (jm, jd) = ref(params["region"], *map(jnp.asarray, (tower, depth, masks)))
    th, tlres = tre.feature_refinement(model.region_extractor, torch.tensor(tower), TINY_T.region)
    assert tuple(th.shape) == jh.shape == (2, 144, 16) and tuple(tlres.shape) == jlres.shape == (2, 16, 16)
    _close(th, jh)
    _close(tlres, jlres)
    _close(tre.mask_pool(th, torch.tensor(masks)), jpool)
    tm, td = tre.extract_regions(model.region_extractor, th, torch.tensor(depth), torch.tensor(masks), TINY_T.region)
    _close(tm, jm)
    _close(td, jd)


def test_llama_forward_collects_quantized_kv(tiny):
    params = jax.jit(jllama.init_params, static_argnums=(1, 2, 3))(jax.random.PRNGKey(3), LLAMA, jnp.float32, 2)
    cfg = TINY_T.replace(llm=LLAMA_T, num_extra_tokens=2)
    model = load_from_jax(_np_tree(dict(tiny[0], llm=params)), cfg, "cpu").llm
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 48)).astype(np.float32)
    pos = np.tile(np.arange(12), (2, 1)).astype(np.int32)
    seg = np.ones((2, 12), np.int32)
    seg[1, 9:] = 0

    @jax.jit
    def ref(p, x, pos, seg):
        h, kv = jllama.forward(p, LLAMA, inputs_embeds=x, position_ids=pos, segment_ids=seg,
                               attn_impl="onepass", collect_kv=True, kv_quant=True)
        return h, kv, jllama.logits(p, h, LLAMA)

    jh, jkv, jlogits = ref(params, *map(jnp.asarray, (x, pos, seg)))
    th, tkv = tllama.forward(model, LLAMA_T, inputs_embeds=torch.tensor(x), position_ids=torch.tensor(pos),
                             segment_ids=torch.tensor(seg), attn_impl="onepass", collect_kv=True, kv_quant=True)
    _close(th, jh)
    _close(tllama.logits(model, th), jlogits, atol=1e-4)
    for li, ((tkq, tks), (tvq, tvs)) in enumerate(tkv):
        (jkq, jks), (jvq, jvs) = jkv.k[li], jkv.v[li]
        assert tkq.dtype == torch.int8 and tuple(tkq.shape) == jkq.shape == (2, 12, 2, 12)
        # compare dequantized values: a value within rounding of a half step
        # may land one int8 level apart, so allow one quantization step
        for (q, s), (jq_, js) in (((tkq, tks), (jkq, jks)), ((tvq, tvs), (jvq, jvs))):
            deq = (q.float() * s[..., None]).numpy()
            jdeq = np.asarray(jq_, np.float32) * np.asarray(js)[..., None]
            assert np.abs(deq - jdeq).max() <= np.asarray(js).max() * 1.001
            _close(s, js)


def test_vlm_prepare_embeds_rgb_depth_regions(tiny):
    params, model = tiny
    sb, inputs, jin = _batch()
    want = jax.jit(jvlm.prepare_embeds, static_argnums=1)(params, TINY, jin)
    got = tvlm.prepare_embeds(model, TINY_T, inputs)
    assert tuple(got.shape) == want.shape == (2, 10, 32)
    _close(got, want)


def test_init_random_matches_the_jax_recipe(tiny):
    """Seeded on-device init: same parameter names and shapes as the bridge,
    reproducible from the seed, and the JAX init_params scales
    (fan_in^-1/2 kernels, 0.02 tables, unit norms, zero biases)."""
    model = init_random(TINY_T, "cpu", torch.float32, seed=0)
    again = init_random(TINY_T, "cpu", torch.float32, seed=0)
    sd, sd2, ref = model.state_dict(), again.state_dict(), tiny[1].state_dict()
    assert sd.keys() == ref.keys()
    for name, t in sd.items():
        torch.testing.assert_close(t, sd2[name], rtol=0, atol=0)
        assert t.shape == ref[name].shape, name
    w = sd["llm.model.layers.0.mlp.down_proj.weight"]  # fan_in 64
    assert abs(float(w.std()) - 64**-0.5) < 0.2 * 64**-0.5
    assert abs(float(sd["llm.model.embed_tokens.weight"].std()) - 0.02) < 0.004
    assert torch.all(sd["llm.model.norm.weight"] == 1)
    assert torch.all(sd["vision_tower.vision_model.encoder.layers.0.self_attn.q_proj.bias"] == 0)


def test_unported_llama_knobs_raise():
    for kw in ({"num_experts": 4}, {"sliding_window": 8}, {"hidden_act": "gelu_tanh"}, {"tie_word_embeddings": True}):
        with pytest.raises(NotImplementedError):
            tllama.LlamaForCausalLM(tconfig.LlamaConfig(**{**LLAMA_T.__dict__, **kw}))


# ---------------------------------------------------------------------------
# the slice: generate end to end
# ---------------------------------------------------------------------------


def _batch(prompts=None, pad_to=10):
    if prompts is None:
        prompts = [
            np.array([5, IMAGE_TOKEN_INDEX, 60, 61, 8], np.int64),  # expands to 8
            np.array([IMAGE_TOKEN_INDEX, 7, 60, 61], np.int64),  # expands to 7
        ]
    sb = expand_rows(prompts, None, max_len=64, tokens_per_image=4, mask_token_id=60,
                     depth_token_id=61, regions_per_image=2, pad_to=pad_to)
    rng = np.random.default_rng(0)
    n, size = len(prompts), TINY.vision.image_size
    pix = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    dep = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    masks = (rng.random((n, 2, size, size)) > 0.5).astype(np.float32)
    valid = np.ones((n, 2), bool)
    return sb, tvlm.VLMInputs.from_spliced(sb, pix, dep, masks, valid, "cpu"), to_vlm_inputs(sb, pix, dep, masks, valid)


@pytest.fixture(scope="module")
def slice_pair(tiny):
    params, model = tiny
    sb, inputs, jin = _batch()
    return params, model, inputs, jin, sb.segment_ids.sum(axis=1)


def _both(slice_pair, max_new=8, **kw):
    params, model, inputs, jin, plens = slice_pair
    j = jgen.generate(params, TINY, jin, jnp.asarray(plens, jnp.int32), max_new_tokens=max_new,
                      temperature=0.0, kv_quant=True, attn_impl="onepass", **kw)
    t = tgen.generate(model, TINY_T, inputs, torch.as_tensor(plens), max_new_tokens=max_new,
                      temperature=0.0, attn_impl="onepass", **kw)
    return j, t


def test_generate_greedy_matches_jax(slice_pair):
    """Rows of different prompt lengths (8 and 7) with RGB + depth + 2
    regions: same greedy tokens, same num_generated, and first-token logits
    equal to the JAX prefill's within fp32 drift."""
    params, model, inputs, jin, plens = slice_pair
    assert list(plens) == [8, 7]
    j, t = _both(slice_pair, eos_token_id=-1)
    np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(j.tokens))
    np.testing.assert_array_equal(t.num_generated.numpy(), np.asarray(j.num_generated))

    @jax.jit
    def first_logits(params, jin):
        h, _ = jllama.forward(params["llm"], TINY.llm, inputs_embeds=jvlm.prepare_embeds(params, TINY, jin),
                              position_ids=jin.position_ids, segment_ids=jin.segment_ids)
        return jllama.logits(params["llm"], h[jnp.arange(2), jnp.asarray(plens - 1)][:, None], TINY.llm)[:, 0]

    want = first_logits(params, jin)
    _close(t.first_logits, want, atol=1e-4)
    assert int(t.tokens[0, 0]) == int(np.argmax(np.asarray(want)[0]))


def test_generate_stop_id_and_stop_sequence_match_jax(slice_pair):
    j, t = _both(slice_pair, eos_token_id=-1)
    toks = t.tokens.numpy()
    # a stop id that first appears mid-row, and a two-token stop sequence
    stop_id = next(int(x) for x in toks[0] if x != toks[0, 0])
    seq = (int(toks[1, 1]), int(toks[1, 2]))
    for kw in ({"stop_token_ids": (stop_id,)}, {"stop_sequences": (seq,)}):
        j, t = _both(slice_pair, eos_token_id=-1, **kw)
        np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(j.tokens), err_msg=str(kw))
        np.testing.assert_array_equal(t.num_generated.numpy(), np.asarray(j.num_generated), err_msg=str(kw))
        assert (t.tokens.numpy() == -1).any(), f"{kw}: no row stopped early"


def test_generate_eos_counts_like_jax(slice_pair):
    """num_generated counts up to and including the first eos."""
    j0, t0 = _both(slice_pair, eos_token_id=-1)
    eos = int(t0.tokens[1, 3])
    j, t = _both(slice_pair, eos_token_id=eos)
    np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(j.tokens))
    np.testing.assert_array_equal(t.num_generated.numpy(), np.asarray(j.num_generated))


@pytest.mark.parametrize("top_p", [0.05, 0.5, 0.9])
def test_top_p_keep_mask_matches_jax(monkeypatch, top_p):
    """The nucleus filter keeps the same tokens in both (samples are never
    compared: torch.Generator and jax.random draw differently); the port's
    samples stay inside its keep-mask."""
    logits = np.random.default_rng(5).standard_normal((4, 64)).astype(np.float32) * 3
    seen = {}

    def capture(rng, filtered, axis=-1):
        seen["logits"] = np.asarray(filtered)
        return jnp.zeros(filtered.shape[0], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jgen._sample_token(jnp.asarray(logits), jax.random.PRNGKey(0), 0.7, top_p)
    want = np.isfinite(seen["logits"])
    got = torch.isfinite(tgen.top_p_filter(torch.tensor(logits) / 0.7, top_p)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.sum(axis=1).min() >= 1
    g = torch.Generator().manual_seed(0)
    for _ in range(8):
        tok = tgen._sample_token(torch.tensor(logits), g, 0.7, top_p).numpy()
        assert want[np.arange(4), tok].all()
