"""Port parity for SAM-HQ and its kernel K5 (grid-bias attention): K5's
plain version against the Pallas kernel in interpret mode, the port's
``_vision_attention`` routes against the JAX function, and the SAM-HQ
model (image encoder, box prompts, mask decoders) against the JAX package
on the same weights: the port's seeded HF-named ``state_dict()`` goes
through the JAX ``convert_sam_hq``.  fp32 on the CPU on the same numpy
inputs; tolerances: fp32 accumulation order, except where a test states
another.  The kernel itself is held to its plain version on the card by
tests/test_torch_gpu.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialrgpt_tpu.models import sam as jsam
from spatialrgpt_tpu.ops.flash_attention import grid_bias_attention as j_grid_bias
from spatialrgpt_tpu_torch.models import sam as tsam
from spatialrgpt_tpu_torch.ops import flash_attention as K5
from spatialrgpt_tpu_torch.ops._checks import bf16_err_over_bound
from spatialrgpt_tpu_torch.utils.weights import init_random_sam_hq

ATOL = 2e-5

# tests/test_sam.py's TINY, in both packages' config classes
_SAM_V = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4, intermediate_size=128, image_size=64,
              patch_size=16, output_channels=32, window_size=2, global_attn_indexes=(1, 3))
_SAM = dict(prompt_hidden_size=32, image_embedding_size=4, decoder_hidden_size=32, decoder_num_heads=2,
            decoder_mlp_dim=64, decoder_layers=2)
SAM_T = tsam.SamConfig(vision=tsam.SamVisionConfig(**_SAM_V), **_SAM)
SAM_J = jsam.SamConfig(vision=jsam.SamVisionConfig(**_SAM_V), **_SAM)


# the reference programs here run once each: XLA's CPU backend at optimisation
# level 0 compiles them in about half the time
QUICK_XLA = {"xla_backend_optimization_level": 0}

def _close(got, want, atol=ATOL, rtol=1e-4):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# K5: grid-bias attention
# ---------------------------------------------------------------------------


def test_grid_bias_plain_matches_pallas_multiblock():
    """test_sam.py::test_grid_bias_flash_multiblock's shape: a 16 x 16 grid
    (S 256) in 64 x 64 blocks, 2 heads of 32."""
    rng = np.random.default_rng(1)
    H = W = 16
    nh, d, S = 2, 32, 256
    q, k, v = (rng.standard_normal((1, nh, S, d)).astype(np.float32) for _ in range(3))
    rel_h = (rng.standard_normal((1, nh, S, H)) * 0.3).astype(np.float32)
    rel_w = (rng.standard_normal((1, nh, S, W)) * 0.3).astype(np.float32)
    want = j_grid_bias(*map(jnp.asarray, (q, k, v, rel_h, rel_w)), grid_w=W, block_q=64, block_k=64, interpret=True)
    t = [torch.tensor(a).transpose(1, 2) for a in (q, k, v)]  # (B, S, H, D)
    got = K5.grid_bias_attention_plain(*t, torch.tensor(rel_h), torch.tensor(rel_w), W).transpose(1, 2)
    _close(got, want)


def _attn_params(rng, C, d, size):
    return {
        "qkv": {"kernel": rng.standard_normal((C, 3 * C)).astype(np.float32) * 0.05, "bias": np.zeros(3 * C, np.float32)},
        "proj": {"kernel": rng.standard_normal((C, C)).astype(np.float32) * 0.05, "bias": np.zeros(C, np.float32)},
        "rel_pos_h": rng.standard_normal((2 * size - 1, d)).astype(np.float32) * 0.1,
        "rel_pos_w": rng.standard_normal((2 * size - 1, d)).astype(np.float32) * 0.1,
    }


@pytest.mark.parametrize("flash_min", [0, 10**9])
def test_vision_attention_routes_match_jax(monkeypatch, flash_min):
    """The port's global route (K5's wrapper; its plain version on a CPU
    tensor) and its dense route against the JAX ``_vision_attention`` with
    the same threshold (its ``SRGPT_SAM_FLASH_MIN``, the port's
    ``FLASH_MIN``; 0: the Pallas kernel in interpret mode), on a 16 x 16
    grid: 2 x 2 blocks of 128 in the reference."""
    rng = np.random.default_rng(0)
    H = W = 16
    nh, d = 4, 16
    C = nh * d
    cfg_j = jsam.SamVisionConfig(hidden_size=C, num_attention_heads=nh)
    cfg_t = tsam.SamVisionConfig(hidden_size=C, num_attention_heads=nh)
    x = rng.standard_normal((2, H, W, C)).astype(np.float32)
    p = _attn_params(rng, C, d, H)
    monkeypatch.setenv("SRGPT_SAM_FLASH_MIN", str(flash_min))
    monkeypatch.setattr(tsam, "FLASH_MIN", flash_min)
    want = jsam._vision_attention(jnp.asarray(x), jax.tree.map(jnp.asarray, p), cfg_j)
    attn = tsam._VisionAttention(cfg_t, H)
    attn.load_state_dict({
        "qkv.weight": torch.tensor(p["qkv"]["kernel"].T), "qkv.bias": torch.tensor(p["qkv"]["bias"]),
        "proj.weight": torch.tensor(p["proj"]["kernel"].T), "proj.bias": torch.tensor(p["proj"]["bias"]),
        "rel_pos_h": torch.tensor(p["rel_pos_h"]), "rel_pos_w": torch.tensor(p["rel_pos_w"]),
    })
    with torch.no_grad():
        for impl in ("onepass", "xla"):
            _close(tsam._vision_attention(torch.tensor(x), attn, cfg_t, impl), want)


def _bf16(rng, *shape, scale=1.0):
    return torch.tensor(rng.standard_normal(shape).astype(np.float32) * scale).to(torch.bfloat16)


def test_bound_rejects_a_grid_bias_kernel_that_skips_a_key_tile():
    """K5 at SAM vit_h's head dim and grid width (D 80, gw 64; 32 grid rows
    to keep the CPU short), bf16: a kernel that left out the key tile
    [320, 384), i.e. one grid row, would exceed ``bf16_err_over_bound``.
    Its output is the plain function with that row's bias at -inf."""
    rng = np.random.default_rng(5)
    gh, gw, H, D = 32, 64, 2, 80
    S = gh * gw
    q, k, v = (_bf16(rng, 1, S, H, D) for _ in range(3))
    rel_h = torch.tensor(rng.standard_normal((1, H, S, gh)).astype(np.float32))
    rel_w = torch.tensor(rng.standard_normal((1, H, S, gw)).astype(np.float32))
    ref = K5.grid_bias_attention_plain(q, k, v, rel_h, rel_w, gw)
    dropped = rel_h.clone()
    dropped[..., 5] = -torch.inf
    fault = K5.grid_bias_attention_plain(q, k, v, dropped, rel_w, gw)
    assert bf16_err_over_bound(ref, ref) == 0.0
    assert bf16_err_over_bound(fault, ref) > 1.0


# ---------------------------------------------------------------------------
# SAM-HQ
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sam_pair():
    model = init_random_sam_hq(SAM_T, "cpu", torch.float32, seed=0)
    return model, jsam.convert_sam_hq(model.state_dict(), SAM_J)


def test_sam_state_dict_keys_are_what_the_converters_read(sam_pair):
    """Every key of the port's ``state_dict()`` is read by ``convert_sam_hq``
    and every key it reads exists; the seeded init is reproducible and
    keeps the recipe's scales."""
    model, _ = sam_pair
    sd = model.state_dict()
    read = set()

    class Recording(dict):
        def __getitem__(self, key):
            read.add(key)
            return dict.__getitem__(self, key)

    jsam.convert_sam_hq(Recording(sd), SAM_J)
    assert read == set(sd)
    again = init_random_sam_hq(SAM_T, "cpu", torch.float32, seed=0).state_dict()
    assert all(torch.equal(t, again[n]) for n, t in sd.items())
    assert torch.all(sd["vision_encoder.layers.0.layer_norm1.weight"] == 1)
    assert abs(float(sd["vision_encoder.pos_embed"].std()) - 0.02) < 0.004
    w = sd["vision_encoder.layers.0.mlp.lin2.weight"]  # fan_in 128
    assert abs(float(w.std()) - 128**-0.5) < 0.2 * 128**-0.5


def _sam_inputs(seed):
    rng = np.random.default_rng(seed)
    pix = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    boxes = np.array([[[8.0, 8.0, 40.0, 48.0], [4.0, 16.0, 30.0, 30.0]], [[0.0, 0.0, 63.0, 63.0], [20.0, 4.0, 60.0, 26.0]]],
                     np.float32)
    return pix, boxes


def test_sam_encode_image_matches_jax(sam_pair):
    """The image embedding and SAM-HQ's ``vit_features`` (the first global
    layer's output), through windowed (2 x 2, padded 4 -> 4) and global
    layers and the neck."""
    model, params = sam_pair
    pix, _ = _sam_inputs(0)
    enc = jax.jit(functools.partial(jsam.encode_image, cfg=SAM_J.vision, return_interm=True),
                  compiler_options=QUICK_XLA)
    want, want_i = enc(params["vision"], jnp.asarray(pix))
    with torch.no_grad():
        got, got_i = tsam.encode_image(model.vision_encoder, torch.tensor(pix), SAM_T.vision, return_interm=True)
    _close(got, want, atol=1e-4)
    _close(got_i, want_i, atol=1e-4)


@pytest.fixture(scope="module")
def jax_box_masks(sam_pair):
    """The reference's masks and IoU for the three heads below, from one
    program (one compile; the image encoder is shared)."""
    model, params = sam_pair
    pix, boxes = map(jnp.asarray, _sam_inputs(3))

    def heads(p_hq, p_sam, x, b):
        return {
            (False, False): jsam.predict_boxes(p_sam, SAM_J, x, b),
            (True, False): jsam.predict_boxes_hq(p_hq, SAM_J, x, b, False),
            (True, True): jsam.predict_boxes_hq(p_hq, SAM_J, x, b, True),
        }

    return jax.jit(heads, compiler_options=QUICK_XLA)(params, jsam.convert_sam(model.state_dict(), SAM_J), pix, boxes)


@pytest.mark.parametrize("hq,hq_token_only", [(False, False), (True, False), (True, True)])
def test_sam_predict_boxes_matches_jax(sam_pair, jax_box_masks, hq, hq_token_only):
    """Box-prompted masks and IoU of ``predict_boxes`` (the SAM head, from
    ``convert_sam``) and ``predict_boxes_hq`` for both ``hq_token_only``;
    mask logits within 1e-3 absolute (they pass two decoders' worth of
    fp32 sums)."""
    model, _ = sam_pair
    pix, boxes = (torch.tensor(a) for a in _sam_inputs(3))
    want_m, want_iou = jax_box_masks[(hq, hq_token_only)]
    if hq:
        got_m, got_iou = tsam.predict_boxes_hq(model, SAM_T, pix, boxes, hq_token_only)
    else:
        got_m, got_iou = tsam.predict_boxes(model, SAM_T, pix, boxes)
    assert tuple(got_m.shape) == want_m.shape == (4, 16, 16)
    _close(got_m, want_m, atol=1e-3, rtol=1e-3)
    _close(got_iou, want_iou, atol=1e-4)
