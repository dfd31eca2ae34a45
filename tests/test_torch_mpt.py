"""Port parity for the MPT decoder and the composite with an MPT decoder
(``models/mpt.py``, ``models/vlm.py::forward_mpt``).

Weights come from the JAX package's ``init_params`` trees through
``load_mpt_from_jax`` / ``load_from_jax(..., mpt_cfg=...)`` (the HF
``MptForCausalLM`` names), inputs from numpy seeds; fp32 on the CPU.
Tolerance: atol 2e-5 / rtol 2e-4 unless a test states its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialrgpt_tpu.data.dataset import to_vlm_inputs
from spatialrgpt_tpu.models import mpt as jmpt
from spatialrgpt_tpu.models import vlm as jvlm
from spatialrgpt_tpu_torch.constants import IMAGE_TOKEN_INDEX
from spatialrgpt_tpu_torch.data.splice import expand_rows, pack_rows
from spatialrgpt_tpu_torch.models import mpt as tmpt
from spatialrgpt_tpu_torch.models import vlm as tvlm
from spatialrgpt_tpu_torch.utils.weights import export_mpt, init_random, init_random_mpt, load_from_jax, load_mpt_from_jax
from test_torch_models import TINY, TINY_T

ATOL, RTOL = 2e-5, 2e-4
MPT = dict(d_model=64, n_heads=4, n_layers=2, vocab_size=128, max_seq_len=128)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=rtol)


def _mpt_params(cfg, seed):
    """``init_params`` with the unit norm scales redrawn, so that they count."""
    params = _np_tree(jmpt.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (1 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        if "norm" in jax.tree_util.keystr(path) else a, params)


@pytest.fixture(scope="module")
def mpt_pair():
    jcfg, tcfg = jmpt.MPTConfig(**MPT), tmpt.MPTConfig(**MPT)
    params = _mpt_params(jcfg, 2)
    return jcfg, tcfg, params, load_mpt_from_jax(params, tcfg, "cpu")


@pytest.mark.parametrize("heads", [4, 6, 32])
def test_alibi_slopes_equal_reference(heads):
    """The slope schedule at a power of two, between two (6: the
    interleaved second half) and MPT-7B's 32; the bias it makes."""
    np.testing.assert_array_equal(tmpt.alibi_slopes(heads), jmpt.alibi_slopes(heads))
    np.testing.assert_array_equal(tmpt.alibi_bias(heads, 13).numpy(), np.asarray(jmpt.alibi_bias(heads, 13)))


def _packed_segments(rng, B, S):
    """Rows of 2-3 packed samples and a padded tail (segment 0)."""
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(2, S - 3), size=2, replace=False))
        seg[b, : cuts[0]], seg[b, cuts[0] : cuts[1]], seg[b, cuts[1] : S - 2 - b] = 1, 2, 3
    return seg


@pytest.mark.parametrize("packed", [False, True])
def test_mpt_forward_logits(mpt_pair, packed):
    """``forward_logits`` against the reference's: bias-free LayerNorms,
    fused Wqkv, ALiBi over absolute key positions, the causal mask (and the
    segment mask of packed rows, whose padded rows attend to every key
    uniformly as the reference's do), exact GELU, the tied f32 head."""
    jcfg, tcfg, params, model = mpt_pair
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 128, (2, 17))
    seg = _packed_segments(rng, 2, 17) if packed else None
    want = jmpt.forward_logits(params, jcfg, jnp.asarray(ids, jnp.int32), None if seg is None else jnp.asarray(seg))
    got = tmpt.forward_logits(model, tcfg, torch.tensor(ids), None if seg is None else torch.tensor(seg))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 17, 128)
    _close(got, want)


def test_convert_mpt_reads_the_hf_names(mpt_pair):
    """An HF ``MptForCausalLM`` state dict (with its tied ``lm_head``)
    through both converters: the same logits."""
    jcfg, tcfg, params, _ = mpt_pair
    sd = {k: torch.tensor(v) for k, v in export_mpt(params).items()}
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    jp = jmpt.convert_mpt(sd, jcfg)
    model = tmpt.MptForCausalLM(tcfg)
    model.load_state_dict(tmpt.convert_mpt(sd, tcfg), strict=True)
    ids = np.random.default_rng(4).integers(0, 128, (1, 9))
    _close(tmpt.forward_logits(model, tcfg, torch.tensor(ids)), jmpt.forward_logits(jp, jcfg, jnp.asarray(ids)))


def test_init_random_mpt_follows_the_recipe():
    """Unit norm scales, N(0, 0.02) embeddings, N(0, fan_in^-1/2) kernels,
    from a seed; MPT-7B's layout builds on the meta device."""
    tcfg = tmpt.MPTConfig(**MPT)
    model = init_random_mpt(tcfg, "cpu", torch.float32, seed=1)
    assert abs(float(model.transformer.wte.weight.std()) - 0.02) < 0.002
    blk = model.transformer.blocks[1]
    assert abs(float(blk.ffn.down_proj.weight.std()) * 256**0.5 - 1) < 0.05
    assert blk.norm_1.bias is None and bool((blk.norm_2.weight == 1).all())
    with torch.device("meta"):
        big = tmpt.MptForCausalLM(tmpt.MPTConfig())
    n = sum(p.numel() for p in big.parameters())
    assert 6.6e9 < n < 6.7e9  # MPT-7B: 6.65 B parameters, ~13.3 GB in bf16


def _composite(packed):
    """TINY's composite (SigLIP, projector, region extractor) with an MPT
    decoder of 32 wide (TINY's llm width), on rows of RGB + depth + 2
    regions: two rows, or the same prompts packed into one row."""
    prompts = [np.array([5, IMAGE_TOKEN_INDEX, 60, 61, 8, 9], np.int64),
               np.array([IMAGE_TOKEN_INDEX, 7, 60, 61, 60, 61, 11], np.int64)]
    kw = dict(max_len=64, tokens_per_image=4, mask_token_id=60, depth_token_id=61, regions_per_image=2)
    if packed:
        sb = pack_rows([expand_rows([p], None, **kw) for p in prompts], max_len=32)
        assert sb.input_ids.shape[0] == 1 and len(set(sb.segment_ids[0]) - {0}) == 2
    else:
        sb = expand_rows(prompts, None, pad_to=16, **kw)
    rng = np.random.default_rng(5)
    n, size = 2, TINY.vision.image_size
    pix = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    dep = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    masks = (rng.random((n, 2, size, size)) > 0.5).astype(np.float32)
    valid = np.ones((n, 2), bool)
    return tvlm.VLMInputs.from_spliced(sb, pix, dep, masks, valid, "cpu"), to_vlm_inputs(sb, pix, dep, masks, valid)


@pytest.fixture(scope="module")
def composite_pair():
    jcfg = jmpt.MPTConfig(d_model=32, n_heads=4, n_layers=2, vocab_size=64, max_seq_len=128)
    tcfg = tmpt.MPTConfig(d_model=32, n_heads=4, n_layers=2, vocab_size=64, max_seq_len=128)
    params = jax.jit(jvlm.init_params, static_argnums=1)(jax.random.PRNGKey(11), TINY)
    params = dict(params, llm=_mpt_params(jcfg, 12))
    model = load_from_jax(_np_tree(params), TINY_T, "cpu", mpt_cfg=tcfg)
    assert isinstance(model.llm, tmpt.MptForCausalLM)
    return jcfg, tcfg, params, model


@pytest.mark.parametrize("packed", [False, True])
def test_forward_mpt_matches_reference(composite_pair, packed):
    """``forward_mpt`` on the composite (the tower, region extractor and
    projector, the splice with the MPT table, the ALiBi stack on the
    segment ids, the tied f32 head): logits within 1e-4 of the reference's
    and the same greedy argmax at every position."""
    jcfg, tcfg, params, model = composite_pair
    inputs, jin = _composite(packed)
    want = np.asarray(jvlm.forward_mpt(params, TINY, jcfg, jin))
    got = tvlm.forward_mpt(model, TINY_T, tcfg, inputs)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    torch.testing.assert_close(tvlm.forward_mpt(model, TINY_T, tcfg, inputs, attn_impl="xla"), got, rtol=0, atol=0)


def test_init_random_builds_an_mpt_composite():
    """``init_random(..., mpt_cfg=...)``: the composite's decoder is an MPT
    made from the seed, the tower as without it."""
    tcfg = tmpt.MPTConfig(d_model=32, n_heads=4, n_layers=2, vocab_size=64, max_seq_len=128)
    model = init_random(TINY_T, "cpu", torch.float32, seed=3, mpt_cfg=tcfg)
    plain = init_random(TINY_T, "cpu", torch.float32, seed=3)
    assert isinstance(model.llm, tmpt.MptForCausalLM) and not hasattr(plain.llm, "transformer")
    torch.testing.assert_close(model.vision_tower.state_dict(), plain.vision_tower.state_dict(), rtol=0, atol=0)
    inputs, _ = _composite(False)
    logits = tvlm.forward_mpt(model, TINY_T, tcfg, inputs)
    assert tuple(logits.shape) == (2, 16, 64) and bool(torch.isfinite(logits).all())
