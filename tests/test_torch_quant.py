"""Port parity for the quantized projections: the weight quantizers, the
branches of ``linear`` (W8A8, int8 weight-only, packed int4), the
quantized model transforms, the carry of a ``quantize_llm`` tree, the
quantized random init, and the tiny W8A8 + int8-KV ``generate``.

The same numpy inputs go through the JAX package and the port in fp32 on
the CPU, where the port's K7-K9 wrappers take their plain versions.  The
int32 product of the W8A8 branch is exact on both sides and the epilogue
runs in the same order, so its outputs agree to 1e-6 relative; the
weight-only and int4 branches sum in f32 in another order (1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from spatialrgpt_tpu import config as jconfig
from spatialrgpt_tpu.data.dataset import to_vlm_inputs
from spatialrgpt_tpu.models import siglip as jsiglip
from spatialrgpt_tpu.models import vlm as jvlm
from spatialrgpt_tpu.ops import layers as jlayers
from spatialrgpt_tpu.ops import quant as jquant
from spatialrgpt_tpu.serving import generate as jgen
from spatialrgpt_tpu_torch import config as tconfig
from spatialrgpt_tpu_torch.constants import IMAGE_TOKEN_INDEX
from spatialrgpt_tpu_torch.data.splice import expand_rows
from spatialrgpt_tpu_torch.models import siglip as tsiglip
from spatialrgpt_tpu_torch.models import vlm as tvlm
from spatialrgpt_tpu_torch.ops import int8_linear
from spatialrgpt_tpu_torch.ops import layers as tlayers
from spatialrgpt_tpu_torch.ops import quant as tquant
from spatialrgpt_tpu_torch.serving import generate as tgen
from spatialrgpt_tpu_torch.train import step as tstep
from spatialrgpt_tpu_torch.utils.weights import init_random_quantized, load_from_jax


def _tiny(c):
    """tests/test_generate.py's TINY, from each package's own config module."""
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


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def params():
    return jax.jit(jvlm.init_params, static_argnums=1)(jax.random.PRNGKey(7), TINY)


def _quantized_tree(params, bits=8, act_quant=True):
    return dict(params, llm=jquant.quantize_llm(params["llm"], bits, act_quant),
                vision=jquant.quantize_llm(params["vision"], bits, act_quant))


def _weight(rng, din, dout):
    """A JAX (din, dout) kernel; the port's weight is its transpose."""
    return rng.standard_normal((din, dout)).astype(np.float32)


# ---------------------------------------------------------------------------
# weight quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,din,dout", [(8, 33, 20), (8, 64, 48), (4, 33, 20), (4, 64, 48)])
def test_weight_quantizers_match_jax(bits, din, dout):
    """q and scale equal to the JAX quantizer's after the layout change
    ((din, dout) -> (out, in); int4's packed (ceil(din / 2), dout) bytes
    transposed), and ``dequantize`` equal to the JAX ``dequantize``."""
    w = _weight(np.random.default_rng(bits * 100 + din), din, dout)
    want = (jquant.quantize_int8 if bits == 8 else jquant.quantize_int4)(jnp.asarray(w))
    q, scale = (tquant.quantize_int8 if bits == 8 else tquant.quantize_int4)(torch.tensor(w.T))
    assert q.dtype == torch.int8 and tuple(q.shape) == (dout, din if bits == 8 else (din + 1) // 2)
    np.testing.assert_array_equal(q.numpy(), np.asarray(want["q"]).T)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want["scale"])[0])
    got = tquant.dequantize(q, scale, None if bits == 8 else din, torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jquant.dequantize(want, jnp.float32)).T)


def _reference_act_quant(x):
    """The reference's activation quantizer, ``_w8a8_dot``'s prologue
    (spatialrgpt_tpu/ops/layers.py:30-35), which the JAX package keeps
    inside ``_w8a8_dot``."""
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    ascale = jnp.maximum(amax / 127.0, 1e-12)
    xq = jnp.clip(jnp.round(xf / ascale), -127, 127).astype(jnp.int8)
    return xq, ascale[..., 0]


def test_act_quant_plain_equals_the_reference():
    """K7's plain version: xq and ascale equal to the reference's, on
    random rows, rows of exact .5 ties (ascale 1: 2.5 -> 2, -3.5 -> -4),
    a row of zeros (ascale 1e-12, xq 0) and rows of a large and a tiny
    scale."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 40)).astype(np.float32)
    x[1] = 0.0
    x[2, :8] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5]
    x[2, 8:] = rng.integers(-126, 127, 32) + 0.5
    x[3] *= 1e4
    x[4] *= 1e-6
    want_q, want_s = jax.jit(_reference_act_quant)(jnp.asarray(x))
    got_q, got_s = int8_linear.act_quant_int8(torch.tensor(x))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    assert float(got_s[2]) == 1.0 and got_q[2, :5].tolist() == [127, 2, -4, 0, 0]
    assert float(got_s[1]) == np.float32(1e-12) and not got_q[1].any()


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


_I8, _F32 = torch.int8, torch.float32


def _on_k9_decode_form(fn, *args):
    """``fn(*args)`` with K9's decode form at every M."""
    saved = int8_linear.W8_DECODE_MAX_M
    int8_linear.W8_DECODE_MAX_M = 1 << 62
    try:
        return fn(*args)
    finally:
        int8_linear.W8_DECODE_MAX_M = saved


# one wrapper call on meta tensors each, and what it must raise: dtype and
# shape are checked before the device, so every rule runs without a card
_REFUSALS = {
    "act_quant_f32": (lambda: int8_linear.act_quant_int8(_meta(4, 64, dtype=_F32)), TypeError, "bfloat16"),
    "act_quant_3d": (lambda: int8_linear.act_quant_int8(_meta(2, 4, 64)), ValueError, "2-D"),
    "act_quant_k12": (lambda: int8_linear.act_quant_int8(_meta(4, 12)), ValueError, "multiple of 8"),
    "act_quant_device": (lambda: int8_linear.act_quant_int8(_meta(4, 64)), ValueError, "CUDA device"),
    "w8a8_q_f32": (lambda: int8_linear.w8a8_gemm(_meta(4, 64, dtype=_I8), _meta(4, dtype=_F32), _meta(8, 64, dtype=_F32),
                                                 _meta(8, dtype=_F32)), TypeError, "int8"),
    "w8a8_out_f32": (lambda: int8_linear.w8a8_gemm(_meta(4, 64, dtype=_I8), _meta(4, dtype=_F32), _meta(8, 64, dtype=_I8),
                                                   _meta(8, dtype=_F32), out_dtype=_F32), TypeError, "writes bf16"),
    "w8a8_k24": (lambda: int8_linear.w8a8_gemm(_meta(4, 24, dtype=_I8), _meta(4, dtype=_F32), _meta(8, 24, dtype=_I8),
                                               _meta(8, dtype=_F32)), ValueError, "multiple of 16"),
    "w8a8_ascale_shape": (lambda: int8_linear.w8a8_gemm(_meta(4, 64, dtype=_I8), _meta(5, dtype=_F32),
                                                        _meta(8, 64, dtype=_I8), _meta(8, dtype=_F32)), ValueError, "ascale"),
    "w8a8_bias_f16": (lambda: int8_linear.w8a8_gemm(_meta(4, 64, dtype=_I8), _meta(4, dtype=_F32), _meta(8, 64, dtype=_I8),
                                                    _meta(8, dtype=_F32), _meta(8, dtype=torch.float16)), TypeError, "bias"),
    "w8a8_device": (lambda: int8_linear.w8a8_gemm(_meta(4, 64, dtype=_I8), _meta(4, dtype=_F32), _meta(8, 64, dtype=_I8),
                                                  _meta(8, dtype=_F32)), ValueError, "CUDA device"),
    "w8_x_f16": (lambda: int8_linear.w8_gemm(_meta(4, 64, dtype=torch.float16), _meta(8, 64, dtype=_I8),
                                             _meta(8, dtype=_F32)), TypeError, "bfloat16"),
    "w8_scale_shape": (lambda: int8_linear.w8_gemm(_meta(4, 64), _meta(8, 64, dtype=_I8), _meta(9, dtype=_F32)),
                       ValueError, "do not fit"),
    "w8_device": (lambda: int8_linear.w8_gemm(_meta(4, 64), _meta(8, 64, dtype=_I8), _meta(8, dtype=_F32)),
                  ValueError, "CUDA device"),
    # the decode form's grid: 128-channel tiles in y, 64-row tiles in z (K9
    # at these rows takes the large form unless the decode form is forced)
    "w8_rows_past_the_grid": (lambda: _on_k9_decode_form(int8_linear.w8_gemm, _meta(int8_linear.DECODE_MAX_ROWS + 1, 64),
                                                         _meta(8, 64, dtype=_I8), _meta(8, dtype=_F32)),
                              ValueError, "decode form"),
    "w8_columns_past_the_grid": (lambda: int8_linear.w8_gemm(_meta(4, 64), _meta(int8_linear.DECODE_MAX_N + 1, 64, dtype=_I8),
                                                             _meta(int8_linear.DECODE_MAX_N + 1, dtype=_F32)),
                                 ValueError, "decode form"),
    "w8a8_decode_columns_past_the_grid": (
        lambda: int8_linear.w8a8_gemm(_meta(4, 64, dtype=_I8), _meta(4, dtype=_F32),
                                      _meta(int8_linear.DECODE_MAX_N + 1, 64, dtype=_I8),
                                      _meta(int8_linear.DECODE_MAX_N + 1, dtype=_F32)), ValueError, "decode form"),
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_quant_wrappers_check_before_the_device(case):
    call, error, match = _REFUSALS[case]
    with pytest.raises(error, match=match):
        call()


# K9's form by the rows of its main-path callers: the demo's and the serve's
# decode (8 and 64 rows) and an engine admission of one 384-row prompt on the
# decode form; admissions of 2 and 4 prompts (768, 1536 rows) and QLoRA's 4 x
# 4096 training rows on the large form
@pytest.mark.parametrize("M,form", [(1, "decode"), (8, "decode"), (64, "decode"), (384, "decode"), (768, "large"),
                                    (1536, "large"), (16384, "large")])
def test_w8_gemm_form_by_caller(M, form):
    assert int8_linear.w8_gemm_form(M) == {"decode": int8_linear.FORM_DECODE, "large": int8_linear.FORM_LARGE}[form]


def test_w8_gemm_form_boundary(monkeypatch):
    """The decode form up to ``W8_DECODE_MAX_M`` rows, the large form above,
    read from the module at each call (so a measurement can force either)."""
    m = int8_linear.W8_DECODE_MAX_M
    assert int8_linear.w8_gemm_form(m) == int8_linear.FORM_DECODE
    assert int8_linear.w8_gemm_form(m + 1) == int8_linear.FORM_LARGE
    monkeypatch.setattr(int8_linear, "W8_DECODE_MAX_M", 0)
    assert int8_linear.w8_gemm_form(1) == int8_linear.FORM_LARGE


# ---------------------------------------------------------------------------
# linear's branches
# ---------------------------------------------------------------------------

# (x shape, din, dout, bits, act_quant, bias, W8A8 expected)
_LINEAR_CASES = {
    "w8a8_2d_bias": ((5, 32), 32, 48, 8, True, True, True),
    "w8a8_3d": ((2, 3, 32), 32, 48, 8, True, False, True),
    "w8a8_expanding_one_row": ((1, 32), 32, 48, 8, True, True, True),
    "w8a8_contracting_2047_rows_weight_only": ((2047, 48), 48, 32, 8, True, True, False),
    "w8a8_contracting_2048_rows": ((2, 1024, 48), 48, 32, 8, True, True, True),
    "int8_weight_only": ((4, 3, 32), 32, 48, 8, False, True, False),
    "int4_odd_din": ((3, 33), 33, 20, 4, False, True, False),
    # the main path's ragged widths, at the K tails the kernels' 128-wide k
    # tiles meet (4304 = 33 x 128 + 80): SigLIP's fc2 contracting at 2048
    # rows, its fc1 expanding at 8 rows, fc2 at 8 rows (weight-only)
    "w8a8_din_4304_contracting_2048_rows": ((2048, 4304), 4304, 24, 8, True, True, True),
    "w8a8_din_1152_to_4304_8_rows": ((8, 1152), 1152, 4304, 8, True, True, True),
    "w8a8_din_4304_to_1152_8_rows_weight_only": ((8, 4304), 4304, 1152, 8, True, True, False),
}


@pytest.mark.parametrize("case", sorted(_LINEAR_CASES))
def test_linear_branches_match_jax(case):
    shape, din, dout, bits, act_quant, with_bias, want_a8 = _LINEAR_CASES[case]
    rng = np.random.default_rng(len(case))
    w = _weight(rng, din, dout)
    x = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(dout).astype(np.float32) if with_bias else None
    kq = jquant.quantize_int8(jnp.asarray(w), act_quant=act_quant) if bits == 8 else jquant.quantize_int4(jnp.asarray(w))
    p = {"kernel_q": kq, **({"bias": jnp.asarray(b)} if with_bias else {})}
    want = np.asarray(jax.jit(jlayers.linear)(jnp.asarray(x), p))

    lin = nn.Linear(din, dout, bias=with_bias)
    with torch.no_grad():
        lin.weight.copy_(torch.tensor(w.T))
        if with_bias:
            lin.bias.copy_(torch.tensor(b))
    ql = tlayers.QuantLinear.from_linear(lin, bits, act_quant)
    m = int(np.prod(shape[:-1]))
    assert ql.takes_a8(m) == want_a8
    got = tlayers.linear(torch.tensor(x), ql)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    rtol = 1e-6 if want_a8 else 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max())
    if want_a8:  # the sibling route: K7's rows handed in give the same y
        xq = tlayers.quantized_input(torch.tensor(x), ql)
        torch.testing.assert_close(tlayers.linear(torch.tensor(x), ql, xq=xq), got, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# model transforms and the carry of quantized trees
# ---------------------------------------------------------------------------


def _count_kernel_q(node) -> int:
    if isinstance(node, dict):
        return int("kernel_q" in node) + sum(_count_kernel_q(v) for v in node.values())
    if isinstance(node, list):
        return sum(_count_kernel_q(v) for v in node)
    return 0


def _quantized_modules(model):
    return {name: m for name, m in model.named_modules() if isinstance(m, tlayers.QuantLinear)}


@pytest.mark.parametrize("bits,act_quant", [(8, False), (8, True), (4, False)])
def test_quantize_model_matches_quantize_llm(params, bits, act_quant):
    """``quantize_model`` quantizes exactly the linears whose JAX kernels
    ``quantize_llm`` turns into ``kernel_q`` (llm with lm_head, the vision
    tower; not the projector, the region extractor or the patch kernel),
    to the same bytes and scales, with ``a8`` where ``act_quant``; and
    ``load_from_jax`` of the quantized tree builds the same model."""
    model = tlayers.quantize_model(load_from_jax(_np_tree(params), TINY_T, "cpu"), bits, act_quant, vision=True)
    carried = load_from_jax(_np_tree(_quantized_tree(params, bits, act_quant)), TINY_T, "cpu")
    mods, want = _quantized_modules(model), _quantized_modules(carried)
    assert sorted(mods) == sorted(want)
    assert "llm.lm_head" in mods and any(n.startswith("vision_tower.") for n in mods)
    assert not any(n.startswith(("mm_projector", "region_extractor")) for n in mods)
    assert not any(isinstance(m, nn.Linear) for m in model.llm.modules())
    for part, prefix in (("llm", "llm."), ("vision", "vision_tower.")):
        n_jax = _count_kernel_q(_quantized_tree(params, bits, act_quant)[part])
        assert n_jax > 0 and sum(n.startswith(prefix) for n in mods) == n_jax, part
    for name, m in mods.items():
        c = want[name]
        assert (m.bits, m.a8, m.in_features) == (c.bits, c.a8, c.in_features) == (bits, act_quant, c.in_features), name
        torch.testing.assert_close(m.q, c.q, rtol=0, atol=0)
        torch.testing.assert_close(m.scale, c.scale, rtol=0, atol=0)


def test_load_from_jax_quantized_tower_matches_jax(params):
    """A ``quantize_llm`` tree (llm + vision, act_quant) carried across: the
    W8A8 SigLIP tower's features equal the JAX tower's on the same tree."""
    qtree = _quantized_tree(params)
    model = load_from_jax(_np_tree(qtree), TINY_T, "cpu")
    assert all(m.a8 for m in _quantized_modules(model).values())
    px = np.random.default_rng(1).standard_normal((3, 56, 56, 3)).astype(np.float32)
    want = jax.jit(jsiglip.forward_features, static_argnums=2)(qtree["vision"], jnp.asarray(px), TINY.vision)
    got = tsiglip.forward_features(model.vision_tower, torch.tensor(px), TINY_T.vision)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_dequantize_model_matches_dequantize_llm(params):
    qtree = _quantized_tree(params, 8, False)
    model = tlayers.dequantize_model(load_from_jax(_np_tree(qtree), TINY_T, "cpu"), torch.float32)
    dq = dict(qtree, llm=jquant.dequantize_llm(qtree["llm"], jnp.float32),
              vision=jquant.dequantize_llm(qtree["vision"], jnp.float32))
    want = load_from_jax(_np_tree(dq), TINY_T, "cpu").state_dict()
    got = model.state_dict()
    assert sorted(got) == sorted(want) and not tlayers.is_quantized(model)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the slice: tiny W8A8 + int8-KV generate
# ---------------------------------------------------------------------------


def _batch():
    """tests/test_generate.py::test_w8a8_generate_matches_bf16's prompts."""
    prompts = [np.array([5, IMAGE_TOKEN_INDEX, 60, 61, 8], np.int64), np.array([IMAGE_TOKEN_INDEX, 7], np.int64)]
    sb = expand_rows(prompts, None, max_len=64, tokens_per_image=4, mask_token_id=60, depth_token_id=61,
                     regions_per_image=2, pad_to=10)
    rng = np.random.default_rng(0)
    size = TINY.vision.image_size
    pix = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    dep = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    masks = (rng.random((2, 2, size, size)) > 0.5).astype(np.float32)
    valid = np.ones((2, 2), bool)
    return sb, tvlm.VLMInputs.from_spliced(sb, pix, dep, masks, valid, "cpu"), to_vlm_inputs(sb, pix, dep, masks, valid)


@pytest.mark.parametrize("bits,act_quant", [(8, True), (8, False), (4, False)])
def test_quantized_generate_matches_jax(params, bits, act_quant):
    """W8A8 (the serving default), int8 weight-only and int4 llm + vision
    trees with the int8 KV cache: the same greedy tokens as the JAX
    ``generate`` on the same quantized tree."""
    qtree = _quantized_tree(params, bits, act_quant)
    model = load_from_jax(_np_tree(qtree), TINY_T, "cpu")
    sb, inputs, jin = _batch()
    plens = sb.segment_ids.sum(axis=1)
    want = jgen.generate(qtree, TINY, jin, jnp.asarray(plens, jnp.int32), max_new_tokens=8, temperature=0.0,
                         eos_token_id=-1, kv_quant=True, attn_impl="onepass")
    got = tgen.generate(model, TINY_T, inputs, torch.as_tensor(plens), max_new_tokens=8, temperature=0.0,
                        eos_token_id=-1, attn_impl="onepass", kv_quant=True)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.num_generated.numpy(), np.asarray(want.num_generated))


# ---------------------------------------------------------------------------
# init_random_quantized
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w8a8,vision_quant", [(True, None), (False, None), (True, False)])
def test_init_random_quantized_layout(w8a8, vision_quant):
    """fast_init_quantized's layout: every llm linear (lm_head included)
    and, by default as ``w8a8`` says, every vision-tower linear is a
    ``QuantLinear`` with int8 ``q`` in [-127, 127], ``scale`` = in^-1/2 * 3
    / 127 and ``a8`` = ``w8a8``, holding no float weight; the rest is float,
    and the same seed gives the same model."""
    model = init_random_quantized(TINY_T, "cpu", w8a8, seed=3, vision_quant=vision_quant, dtype=torch.float32)
    again = init_random_quantized(TINY_T, "cpu", w8a8, seed=3, vision_quant=vision_quant, dtype=torch.float32)
    vq = w8a8 if vision_quant is None else vision_quant
    mods = _quantized_modules(model)
    want = {n for n, _ in tlayers.quantize_model(load_from_jax(_np_tree(jax.jit(jvlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), TINY)), TINY_T, "cpu"), 8, w8a8, vision=vq).named_modules()
        if isinstance(_, tlayers.QuantLinear)}
    assert set(mods) == want
    assert any(n.startswith("vision_tower.") for n in mods) == vq
    for name, m in mods.items():
        assert m.q.dtype == torch.int8 and m.scale.dtype == torch.float32 and m.a8 == w8a8, name
        assert int(m.q.min()) >= -127 and int(m.q.max()) <= 127
        assert torch.all(m.scale == np.float32(m.in_features**-0.5 * 3.0 / 127.0))
        assert not any(p.dtype.is_floating_point and p.dim() == 2 for p in m.parameters())
        assert m.bias is None or not m.bias.any()
    big = mods["llm.model.layers.0.mlp.gate_proj"].q.float()
    assert abs(float(big.mean())) < 3 and abs(float(big.std()) - 255 / 12**0.5) < 5  # uniform on [-127, 127]
    sd, sd2 = model.state_dict(), again.state_dict()
    for name in sd:
        torch.testing.assert_close(sd[name], sd2[name], rtol=0, atol=0)
    assert isinstance(model.mm_projector.layers[2], nn.Linear)


def test_training_a_quantized_model_raises():
    """A quantized model trains only with its quantized modules frozen (the
    frozen-base W8A8 align step): its loss runs and carries gradients to the
    tuned modules, and a train state whose optimizer would train a
    ``QuantLinear``'s parameters (the tower's biases) is refused."""
    from spatialrgpt_tpu_torch.train.optimizer import OptimizerConfig, build_optimizer

    model = init_random_quantized(TINY_T, "cpu", True, dtype=torch.float32)
    _, inputs, _ = _batch()
    model.mm_projector.requires_grad_(True)
    loss, _ = tvlm.loss_fn(model, TINY_T, inputs._replace(labels=inputs.input_ids))
    loss.backward()
    assert torch.isfinite(loss) and all(p.grad is not None for p in model.mm_projector.parameters())
    with pytest.raises(ValueError, match="quantized"):
        tstep.create_train_state(model, build_optimizer(model, OptimizerConfig(tune_vision_tower=True)))
