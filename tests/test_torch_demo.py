"""Port parity for the demo path (Depth-Anything -> SAM-HQ -> device
preprocess -> region QA): kernel K6 (fused LayerNorm) through its plain
version, the argument checks of K5's and K6's wrappers, the device
front-end, and the tiny pipeline as a whole against the JAX package on
the same numpy inputs, in fp32 on the CPU, plus ``DemoEngine`` on the
port's adapters.  Pallas kernels run in interpret mode, as the JAX
package's own tests run them.  SAM-HQ and K5 are held to the JAX package
in tests/test_torch_sam.py, Depth-Anything in tests/test_torch_depth.py.
Tolerances: fp32 accumulation order, except where a test states
another."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialrgpt_tpu import config as jconfig
from spatialrgpt_tpu.data import device_preprocess as jdp
from spatialrgpt_tpu.data.dataset import to_vlm_inputs
from spatialrgpt_tpu.models import depth_anything as jda
from spatialrgpt_tpu.models import sam as jsam
from spatialrgpt_tpu.models import vlm as jvlm
from spatialrgpt_tpu.ops.layer_norm import fused_layer_norm as j_fused_ln
from spatialrgpt_tpu.serving import generate as jgen
from spatialrgpt_tpu_torch import config as tconfig
from spatialrgpt_tpu_torch.data import device_preprocess as tdp
from spatialrgpt_tpu_torch.demo import pipeline
from spatialrgpt_tpu_torch.models import depth_anything as tda
from spatialrgpt_tpu_torch.models import sam as tsam
from spatialrgpt_tpu_torch.ops import flash_attention as K5
from spatialrgpt_tpu_torch.ops import layer_norm as K6
from spatialrgpt_tpu_torch.ops import layers
from spatialrgpt_tpu_torch.utils.weights import init_random_depth_anything, init_random_sam_hq, load_from_jax
from test_torch_gpu import layer_norm_rows



def _vlm_tiny(c):
    """tests/test_torch_models.py's TINY VLM (SigLIP 2 layers / 16 wide at
    56 px, 4 image tokens; Llama 2 layers / 32 wide; 2 regions) in the
    config classes of module ``c``."""
    return c.SpatialRGPTConfig(
        llm=c.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256, eos_token_id=63),
        vision=c.SiglipVisionConfig(hidden_size=16, intermediate_size=32, num_hidden_layers=2, num_attention_heads=2,
                                    image_size=56, patch_size=14),
        projector=c.ProjectorConfig(mm_hidden_size=16, hidden_size=32),
        region=c.RegionExtractorConfig(mm_hidden_size=16, hidden_size=32, ada_pool_size=4),
        mask_token_id=60,
        depth_token_id=61,
    )


VLM_TINY, VLM_TINY_T = _vlm_tiny(jconfig), _vlm_tiny(tconfig)

# tests/test_sam.py's TINY, in both packages' config classes
_SAM_V = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4, intermediate_size=128, image_size=64,
              patch_size=16, output_channels=32, window_size=2, global_attn_indexes=(1, 3))
_SAM = dict(prompt_hidden_size=32, image_embedding_size=4, decoder_hidden_size=32, decoder_num_heads=2,
            decoder_mlp_dim=64, decoder_layers=2)
SAM_T = tsam.SamConfig(vision=tsam.SamVisionConfig(**_SAM_V), **_SAM)
SAM_J = jsam.SamConfig(vision=jsam.SamVisionConfig(**_SAM_V), **_SAM)
# tests/test_depth_anything.py's TINY at a 56-pixel table (4 x 4 patches)
_DA = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4, intermediate_size=256, patch_size=14,
           out_indices=(1, 2, 3, 4), neck_hidden_sizes=(16, 24, 32, 40), reassemble_factors=(4, 2, 1, 0.5),
           fusion_hidden_size=32, head_hidden_size=16, image_size=56)
DA_T, DA_J = tda.DepthAnythingConfig(**_DA), jda.DepthAnythingConfig(**_DA)


# the reference programs here run once each: XLA's CPU backend at optimisation
# level 0 compiles them in about half the time
QUICK_XLA = {"xla_backend_optimization_level": 0}

def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_new_wrappers_reject_what_the_kernels_do_not_take(monkeypatch):
    """K5 and K6 check dtype and shape first and the device last (meta
    tensors reach every rule); K5 refuses an input that requires grad; CPU
    tensors take the plain versions without counting a launch."""
    B, S, H, D = 1, 64, 2, 80
    q, f32 = _meta(B, S, H, D), torch.float32
    rh, rw = _meta(B, H, S, 8, dtype=f32), _meta(B, H, S, 8, dtype=f32)
    with pytest.raises(TypeError):
        K5.grid_bias_attention(q, q, q, rh.to(torch.bfloat16), rw, 8)
    with pytest.raises(ValueError, match="bias"):
        K5.grid_bias_attention(q, q, q, _meta(B, H, S, 4, dtype=f32), rw, 8)
    with pytest.raises(ValueError, match="divide"):
        K5.grid_bias_attention(q, q, q, rh, rw, 7)
    with pytest.raises(ValueError, match="head dim"):
        K5.grid_bias_attention(*(_meta(B, S, H, 36),) * 3, rh, rw, 8)
    with pytest.raises(ValueError, match="CUDA"):
        K5.grid_bias_attention(q, q, q, rh, rw, 8)
    x = torch.randn(2, 64, 8, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        K5.grid_bias_attention(x, x, x, torch.zeros(2, 8, 64, 8), torch.zeros(2, 8, 64, 8), 8)
    with pytest.raises(TypeError):
        K6.fused_layer_norm(_meta(4096, 128, dtype=f32), _meta(128), _meta(128))
    with pytest.raises(ValueError, match="weight"):
        K6.fused_layer_norm(_meta(4096, 128), _meta(64), _meta(128))
    with pytest.raises(TypeError, match="bf16 or both float32"):
        K6.fused_layer_norm(_meta(4096, 128), _meta(128), _meta(128, dtype=f32))
    for wdtype in (torch.bfloat16, f32):  # the kernel takes the weights as the model holds them
        with pytest.raises(ValueError, match="CUDA"):
            K6.fused_layer_norm(_meta(4096, 128), _meta(128, dtype=wdtype), _meta(128, dtype=wdtype))
    monkeypatch.setattr(K5, "grid_bias_launches", 0)
    monkeypatch.setattr(K6, "launches", 0)
    monkeypatch.setattr(layers, "FUSED_LN", True)
    x = torch.randn(2, 4096, 128).to(torch.bfloat16)
    w, b = torch.randn(128), torch.randn(128)
    assert torch.equal(layers.layer_norm(x, w, b), K6.fused_layer_norm_plain(x, w, b))
    q, bias = torch.randn(1, 64, 2, 16), torch.randn(1, 2, 64, 8)
    torch.testing.assert_close(K5.grid_bias_attention(q, q, q, bias, bias, 8),
                               K5.grid_bias_attention_plain(q, q, q, bias, bias, 8), rtol=0, atol=0)
    assert (K5.grid_bias_launches, K6.launches) == (0, 0)


# ---------------------------------------------------------------------------
# K6: fused LayerNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,dtype", [((4, 96, 256), torch.bfloat16), ((512, 128), torch.float32), ((6, 7, 128), torch.float32)])
def test_fused_layer_norm_plain_matches_pallas(shape, dtype):
    """tests/test_layer_norm_kernel.py's shapes and tolerances (2e-2 for
    bf16, the rounding of one value; 1e-6 in fp32), ragged rows included."""
    rng = np.random.default_rng(shape[0])
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = j_fused_ln(jx, jnp.asarray(scale), jnp.asarray(bias), eps=1e-6, block_rows=64, interpret=True)
    got = K6.fused_layer_norm(torch.tensor(x).to(dtype), torch.tensor(scale), torch.tensor(bias), eps=1e-6)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-6
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


def _short_variance(x, w, b, eps):
    """A LayerNorm that computes the variance as E[x^2] - mean^2."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    return ((xf - mean) * torch.rsqrt(var + eps) * w.float() + b.float()).to(x.dtype)


def _no_eps(x, w, b, eps):
    """A LayerNorm that drops eps."""
    d = x.float() - x.float().mean(-1, keepdim=True)
    return (d * torch.rsqrt((d * d).mean(-1, keepdim=True)) * w.float() + b.float()).to(x.dtype)


def _cancelling_rows(kind, C):
    rng = np.random.default_rng(C)
    x = torch.tensor(layer_norm_rows(rng, kind, 512, C)).to(torch.bfloat16)
    w, b = (torch.tensor(rng.standard_normal(C).astype(np.float32)).to(torch.bfloat16) for _ in range(2))
    return x, w, b


@pytest.mark.parametrize("kind,C", [("large_mean", 1280), ("near_constant", 1024)])
def test_fused_layer_norm_plain_matches_pallas_on_cancelling_rows(kind, C):
    """On the rows where the short variance or a dropped eps show (see the
    next test), the plain version and the Pallas kernel in interpret mode
    agree within the per-element bf16 bound that the card's tests use."""
    from spatialrgpt_tpu_torch.ops._checks import bf16_err_over_bound

    x, w, b = _cancelling_rows(kind, C)
    want = j_fused_ln(jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(w.float().numpy()),
                      jnp.asarray(b.float().numpy()), eps=1e-6, block_rows=64, interpret=True)
    want = torch.tensor(np.asarray(want, np.float32)).to(torch.bfloat16)
    assert bf16_err_over_bound(K6.fused_layer_norm_plain(x, w, b, 1e-6), want) <= 1.0


@pytest.mark.parametrize(
    "kind,C,fault",
    [("large_mean", 1280, _short_variance), ("large_mean", 1024, _short_variance), ("near_constant", 1024, _no_eps),
     ("near_constant", 1280, _no_eps)],
)
def test_layer_norm_rows_separate_a_short_variance_and_a_dropped_eps(kind, C, fault):
    """tests/test_torch_gpu.py holds K6 to its plain version on these rows:
    at a large mean with a spread of one bf16 ulp in 2% of the entries,
    E[x^2] - mean^2 in f32 leaves the per-element bound; on near-constant
    rows (some exactly constant) so does a LayerNorm without eps."""
    from spatialrgpt_tpu_torch.ops._checks import bf16_err_over_bound

    x, w, b = _cancelling_rows(kind, C)
    ref = K6.fused_layer_norm_plain(x, w, b, 1e-6)
    assert bf16_err_over_bound(fault(x, w, b, 1e-6), ref) > 1.0


# ---------------------------------------------------------------------------
# device front-end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src_hw,out", [((768, 1024), 384), ((500, 333), 96), ((96, 96), 384), ((4032, 128), 64)])
def test_device_resize_is_bit_equal_to_jax(src_hw, out):
    """Pillow's uint8 bicubic on the device, downscale, mixed, upscale and a
    ~63x downscale, against the JAX function (which tests/test_device_preprocess.py
    holds to Pillow)."""
    imgs = np.random.default_rng(0).integers(0, 256, (2, *src_hw, 3), np.uint8)
    got = tdp.device_resize_uint8(torch.tensor(imgs), out, out).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdp.device_resize_uint8(jnp.asarray(imgs), out, out)))


def test_device_normalize_and_mask_resize_are_bit_equal_to_jax():
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (3, 40, 40, 3), np.uint8)
    np.testing.assert_array_equal(
        tdp.device_siglip_normalize(torch.tensor(imgs)).numpy(), np.asarray(jdp.device_siglip_normalize(jnp.asarray(imgs)))
    )
    np.testing.assert_array_equal(
        tdp.device_preprocess_uint8(torch.tensor(imgs), 24).numpy(),
        np.asarray(jdp.device_preprocess_uint8(jnp.asarray(imgs), 24)),
    )
    masks = (rng.random((2, 2, 120, 180)) > 0.6).astype(np.uint8)
    np.testing.assert_array_equal(
        tdp.device_mask_resize_nearest(torch.tensor(masks), 64).numpy(),
        np.asarray(jdp.device_mask_resize_nearest(jnp.asarray(masks), 64)),
    )


# ---------------------------------------------------------------------------
# the slice: the tiny demo pipeline in both packages
# ---------------------------------------------------------------------------


def test_tiny_demo_pipeline_matches_jax():
    """Tiny Depth-Anything -> tiny SAM-HQ (2 boxes per image, chunks of one
    image) -> device preprocess -> tiny VLM greedy ``generate``, in both
    packages on the same weights and 2 synthetic photos of 48 x 64: equal
    colorized depth (within one level at < 1% of pixels), equal binary masks
    wherever |logit| > 1e-3, equal greedy tokens.  The port runs its
    ``run_pipeline``; the reference, bench_demo.py's stages on its own
    functions."""
    rng = np.random.default_rng(0)
    B, h, w = 2, 48, 64
    images = np.stack([pipeline.synth_photo(rng, h, w) for _ in range(B)])
    boxes = pipeline.demo_boxes(B, h, w)
    sb = pipeline.demo_prompts(VLM_TINY_T, rng, B, text_tokens=8, pad_to=32, tokens_per_image=4)

    da_model = init_random_depth_anything(DA_T, "cpu", torch.float32, seed=6)
    da_p = jda.convert_depth_anything(da_model.state_dict(), DA_J)
    sam_model = init_random_sam_hq(SAM_T, "cpu", torch.float32, seed=1)
    sam_p = jsam.convert_sam_hq(sam_model.state_dict(), SAM_J)
    vlm_p = jax.jit(jvlm.init_params, static_argnums=1, compiler_options=QUICK_XLA)(jax.random.PRNGKey(2), VLM_TINY)
    models = pipeline.DemoModels(
        depth=tda.DepthPredictor(da_model, DA_T, target=42),
        sam=sam_model, sam_cfg=SAM_T, vlm=load_from_jax(jax.tree.map(np.asarray, vlm_p), VLM_TINY_T, "cpu"),
        vlm_cfg=VLM_TINY_T,
    )
    out = pipeline.run_pipeline(models, torch.tensor(images), torch.tensor(boxes), sb, max_new_tokens=6, chunk=1)

    # the reference: bench_demo.py's stages
    col = np.stack(jda.DepthPredictor(da_p, DA_J, target=42).predict_colorized(list(images)))
    px = np.asarray(jdp.device_resize_uint8(jnp.asarray(images), 64, 64), np.float32) / 255.0
    px = ((px - np.array(pipeline._SAM_MEAN, np.float32)) / np.array(pipeline._SAM_STD, np.float32)).astype(np.float32)
    scale = np.array([64 / w, 64 / h] * 2, np.float32)
    sam_fwd = jax.jit(functools.partial(jsam.predict_boxes_hq, cfg=SAM_J), compiler_options=QUICK_XLA)
    logits = np.concatenate([
        np.asarray(sam_fwd(sam_p, pixel_values=jnp.asarray(px[i : i + 1]), boxes=jnp.asarray(boxes[i : i + 1] * scale))[0])
        for i in range(B)
    ])
    diff = np.abs(out.colorized.numpy().astype(int) - col.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    sure = np.abs(logits) > 1e-3
    np.testing.assert_array_equal((out.mask_logits.numpy() > 0)[sure], (logits > 0)[sure])
    size = VLM_TINY.vision.image_size
    jin = to_vlm_inputs(
        sb,
        np.asarray(jdp.device_preprocess_uint8(jnp.asarray(images), size)),
        np.asarray(jdp.device_preprocess_uint8(jnp.asarray(col), size)),
        np.asarray(jdp.device_mask_resize_nearest(jnp.asarray((logits > 0).astype(np.uint8).reshape(B, 2, 16, 16)), size)),
        np.ones((B, 2), bool),
    )
    want = jgen.generate(vlm_p, VLM_TINY, jin, jnp.asarray(sb.segment_ids.sum(axis=1), jnp.int32), max_new_tokens=6,
                         temperature=0.0, eos_token_id=-1, kv_quant=True, attn_impl="onepass")
    np.testing.assert_array_equal(out.result.tokens.numpy(), np.asarray(want.tokens))
    assert set(out.seconds) == {"depth_s", "sam_s", "preprocess_s", "vlm_s"}


def test_demo_engine_runs_on_the_port_adapters():
    """``DemoEngine.set_image`` and ``add_regions`` (the port's copy of the
    JAX package's framework-free engine) on the port's models: a depth map
    colorized at the image size and one image-sized mask per box."""
    from spatialrgpt_tpu_torch.demo.engine import DemoEngine, DemoState

    predictor = tda.DepthPredictor(init_random_depth_anything(DA_T, "cpu", torch.float32, seed=7), DA_T, target=42)
    sam_model = init_random_sam_hq(SAM_T, "cpu", torch.float32, seed=2)
    engine = DemoEngine(pipeline.segment_boxes_fn(sam_model, SAM_T), pipeline.estimate_depth_fn(predictor),
                        generate=None)
    state = DemoState()
    image = pipeline.synth_photo(np.random.default_rng(3), 48, 64)
    engine.set_image(state, image)
    overlay = engine.add_regions(state, [[4, 20, 30, 46], [34, 24, 60, 44]])
    assert state.depth_colorized.shape == (48, 64, 3) and state.depth_colorized.std() > 0
    assert overlay.shape == image.shape and len(state.region_masks) == 2
    assert all(m.shape == (48, 64) and m.dtype == np.uint8 for m in state.region_masks)
