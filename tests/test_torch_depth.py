"""Port parity for Depth-Anything (DINOv2 backbone + DPT head): the port's
``forward_depth``, its ``jax.image.resize`` weight matrices and the
device ``DepthPredictor`` against the JAX package, on ``init_params``
weights carried across by ``load_depth_anything_from_jax``.  fp32 on the
CPU on the same numpy inputs; tolerances: fp32 accumulation order, except
where a test states another."""

import dataclasses
import functools

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialrgpt_tpu.models import depth_anything as jda
from spatialrgpt_tpu_torch.models import depth_anything as tda
from spatialrgpt_tpu_torch.utils.weights import (
    export_depth_anything,
    init_random_depth_anything,
    load_depth_anything_from_jax,
)

# tests/test_depth_anything.py's TINY
DA_TINY = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4, intermediate_size=256, patch_size=14,
               out_indices=(1, 2, 3, 4), neck_hidden_sizes=(16, 24, 32, 40), reassemble_factors=(4, 2, 1, 0.5),
               fusion_hidden_size=32, head_hidden_size=16)


# the reference programs here run once each: XLA's CPU backend at optimisation
# level 0 compiles them in about half the time
QUICK_XLA = {"xla_backend_optimization_level": 0}

def _close(got, want, atol=2e-5, rtol=1e-4):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=rtol)


def da_cfgs(image_size):
    return tda.DepthAnythingConfig(image_size=image_size, **DA_TINY), jda.DepthAnythingConfig(image_size=image_size, **DA_TINY)


@functools.lru_cache(maxsize=None)
def _init_params():
    init = jax.jit(jda.init_params, static_argnums=1, compiler_options=QUICK_XLA)
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), da_cfgs(56)[1]))


def da_params(cfg_j, seed):
    """``init_params`` (drawn once, at the 56-pixel table) with the
    position table redrawn for ``cfg_j.image_size`` and the head's last conv
    drawn instead of zeroed, so the depth has spread."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.copy, _init_params())
    p["pos_embed"] = rng.standard_normal((1 + (cfg_j.image_size // 14) ** 2, 64)).astype(np.float32) * 0.02
    p["head"]["conv3"]["kernel"] = rng.standard_normal((1, 1, 16, 1)).astype(np.float32) * 0.25
    return p


@pytest.mark.parametrize("image_size,hw,metric", [(56, (56, 70), False), (98, (56, 84), False), (56, (56, 70), True)])
def test_depth_forward_matches_jax(image_size, hw, metric):
    """``forward_depth`` at a non-square input, so ``_interpolate_pos``
    really resizes: a 4 x 4 table to a 4 x 5 grid (upsampling one axis), and
    a 7 x 7 table to 4 x 6 (antialiased downsampling of both); and the
    metric head (sigmoid x max_depth)."""
    cfg_t, cfg_j = (dataclasses.replace(c, metric=metric, max_depth=20.0 if metric else 1.0) for c in da_cfgs(image_size))
    p = da_params(cfg_j, 1)
    model = load_depth_anything_from_jax(p, cfg_t, "cpu")
    pix = np.random.default_rng(2).standard_normal((2, *hw, 3)).astype(np.float32)
    fwd = jax.jit(functools.partial(jda.forward_depth, cfg=cfg_j), compiler_options=QUICK_XLA)
    want = fwd(jax.tree.map(jnp.asarray, p), jnp.asarray(pix))
    with torch.no_grad():
        got = tda.forward_depth(model, torch.tensor(pix), cfg_t)
    assert tuple(got.shape) == want.shape == (2, *hw) and float(got.std()) > 0
    _close(got, want, atol=1e-4, rtol=1e-3)


def test_depth_export_round_trips_through_the_converter():
    cfg_t, cfg_j = da_cfgs(56)
    p = da_params(cfg_j, 4)
    back = jda.convert_depth_anything(export_depth_anything(p, cfg_t), cfg_j)
    p["neck_convs"] = [{"kernel": c["kernel"]} for c in p["neck_convs"]]  # the HF layout has no bias there
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)), back, p)
    model = init_random_depth_anything(cfg_t, "cpu", torch.float32, seed=0)
    assert set(model.state_dict()) == set(export_depth_anything(p, cfg_t))


@pytest.mark.parametrize("method,antialias,n_in,n_out", [
    ("bicubic", True, 7, 11), ("bicubic", True, 9, 4), ("bilinear", True, 9, 5), ("bilinear", False, 9, 5),
])
def test_resize_weights_match_jax_image_resize(method, antialias, n_in, n_out):
    x = np.random.default_rng(n_out).standard_normal((2, n_in, n_in + 2, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, n_out, n_out + 1, 3), method, antialias=antialias)
    got = tda.image_resize(torch.tensor(x), (n_out, n_out + 1), method, antialias)
    _close(got, want, atol=1e-5)


@pytest.mark.parametrize("hw,out_hw", [((50, 70), (42, 56)), ((768, 1024), (518, 686)), ((20, 30), (50, 70))])
def test_cv2_cubic_weights_match_opencv(hw, out_hw):
    """``cv2_cubic_weights`` applied as matmuls against ``cv2.resize`` with
    INTER_CUBIC on float32 images: downscale (the demo's 768 x 1024 ->
    518 x 686 included) and upscale; cv2 sums in f32 in its own order."""
    img = np.random.default_rng(hw[0]).random((1, *hw, 3), np.float32)
    want = cv2.resize(img[0], out_hw[::-1], interpolation=cv2.INTER_CUBIC)
    got = tda._apply_hw(torch.tensor(img), tda.cv2_cubic_weights(hw[0], out_hw[0]), tda.cv2_cubic_weights(hw[1], out_hw[1]))
    np.testing.assert_allclose(got[0].numpy(), want, atol=4e-6, rtol=0)


def test_depth_predictor_matches_jax():
    """The device ``DepthPredictor`` against the reference's with cv2
    importable (the branch the port follows): OpenCV's INTER_CUBIC to a
    multiple of 14, forward, antialiased bilinear back to 50 x 70, min-max
    colorize.  The uint8 maps may differ by one level where a value sits on
    a rounding edge."""
    cfg_t, cfg_j = da_cfgs(56)
    p = da_params(cfg_j, 3)
    raw = np.random.default_rng(5).integers(0, 256, (2, 50, 70, 3), np.uint8)
    want = jda.DepthPredictor(jax.tree.map(jnp.asarray, p), cfg_j, target=42).predict_colorized(list(raw))
    pred = tda.DepthPredictor(load_depth_anything_from_jax(p, cfg_t, "cpu"), cfg_t, target=42)
    got = pred.predict_colorized(list(raw), keys=["a", "b"])
    for g, w in zip(got, want):
        assert g.shape == w.shape == (50, 70, 3) and g.dtype == np.uint8
        diff = np.abs(g.astype(int) - w.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    assert pred.predict_colorized([np.zeros_like(raw[0])], keys=["a"])[0] is got[0]  # memoized
