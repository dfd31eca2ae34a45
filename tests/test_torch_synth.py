"""Port parity for the synthesis pipeline's models: the Swin backbone, the
RAM tagger, the OWL-ViT detector and CameraNet against the JAX package on
the same weights (the JAX ``init_params`` trees carried across by
``load_*_from_jax``, biases drawn nonzero).  fp32 on the CPU on inputs
drawn with numpy; tolerance: max abs difference <= 1e-4 x the largest |JAX
output|, unless a test states another.  The stage models and the pipeline
itself are in tests/test_torch_synth_pipeline.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialrgpt_tpu.models import owl_vit as jowl
from spatialrgpt_tpu.models import ram as jram
from spatialrgpt_tpu.models import swin as jswin
from spatialrgpt_tpu.synth import calibration as jcal
from spatialrgpt_tpu_torch.demo.pipeline import synth_photo
from spatialrgpt_tpu_torch.models import owl_vit as towl
from spatialrgpt_tpu_torch.models import ram as tram
from spatialrgpt_tpu_torch.models import swin as tswin
from spatialrgpt_tpu_torch.synth import calibration as tcal
from spatialrgpt_tpu_torch.utils.weights import (
    load_camera_net_from_jax,
    load_owl_vit_from_jax,
    load_ram_from_jax,
)

# the reference programs here run once each: XLA's CPU backend at optimisation
# level 0 compiles them in about half the time
QUICK_XLA = {"xla_backend_optimization_level": 0}
REL = 1e-4

# tiny configurations, one definition for both packages' config classes: 2
# blocks a stage (so the shifted windows and their mask run), 2 patch merges,
# and a last stage no wider than its window (the clamp)
_SWIN = dict(image_size=64, patch_size=4, embed_dim=16, depths=(2, 2, 2), num_heads=(2, 2, 4), window_size=4)
_RAM = dict(num_tags=12, hidden_size=16, num_decoder_layers=2, num_heads=2)
_OWL_V = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64, image_size=64,
              patch_size=16)
_OWL_T = dict(vocab_size=64, hidden_size=16, num_hidden_layers=2, num_attention_heads=2, intermediate_size=32,
              max_position_embeddings=8)
_CAM = dict(image_size=32, patch_size=8, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64)

SWIN_J, SWIN_T = jswin.SwinConfig(**_SWIN), tswin.SwinConfig(**_SWIN)
RAM_J, RAM_T = jram.RamConfig(swin=SWIN_J, **_RAM), tram.RamConfig(swin=SWIN_T, **_RAM)
OWL_J = jowl.OwlViTConfig(vision=jowl.OwlViTVisionConfig(**_OWL_V), text=jowl.OwlViTTextConfig(**_OWL_T),
                          projection_dim=16)
OWL_T = towl.OwlViTConfig(vision=towl.OwlViTVisionConfig(**_OWL_V), text=towl.OwlViTTextConfig(**_OWL_T),
                          projection_dim=16)
CAM_J, CAM_T = jcal.CameraNetConfig(**_CAM), tcal.CameraNetConfig(**_CAM)
TAGS = ["chair", "table", "lamp", "rug", "sofa", "shelf", "plant", "door", "window", "bed", "desk", "sky"]


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _jit(fn, **static):
    return jax.jit(functools.partial(fn, **static), compiler_options=QUICK_XLA)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def jax_params(name: str):
    """The JAX ``init_params`` tree of a tiny model, as numpy."""
    init, cfg = {"swin": (jswin.init_params, SWIN_J), "ram": (jram.init_params, RAM_J),
                 "owl": (jowl.init_params, OWL_J), "cam": (jcal.init_params, CAM_J)}[name]
    return _np_tree(jax.jit(init, static_argnums=1, compiler_options=QUICK_XLA)(jax.random.PRNGKey(3), cfg))


def _randomize_biases(tree, seed):
    """Biases and norm offsets drawn nonzero (init_params zeroes them), so
    that the bias loads are checked too."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        leaf = path[-1].key if hasattr(path[-1], "key") else None
        return (rng.standard_normal(a.shape) * 0.1).astype(a.dtype) if leaf == "bias" else a

    return jax.tree_util.tree_map_with_path(draw, tree)


@functools.lru_cache(maxsize=None)
def params(name: str):
    return _randomize_biases(jax_params(name), 7)


def _pixels(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Swin and RAM
# ---------------------------------------------------------------------------


def _swin_model():
    from spatialrgpt_tpu_torch.utils.weights import export_swin

    sd = {k: torch.tensor(v) for k, v in export_swin(params("swin")).items()}
    return tswin.convert_swin(sd, SWIN_T, "cpu")


def test_swin_forward_matches_jax():
    x = _pixels(0, 2, 64, 64, 3)
    want = _jit(jswin.forward, cfg=SWIN_J)(params("swin"), jnp.asarray(x))
    with torch.no_grad():
        got = tswin.forward(_swin_model(), torch.tensor(x), SWIN_T)
    assert got.shape == (2, 16, 64)
    _close(got, want)


def test_swin_state_dict_is_what_convert_swin_reads():
    """The port's module holds the HF ``SwinModel`` names: its state dict
    through the JAX ``convert_swin`` gives back the tree it came from."""
    model = _swin_model()
    back = jswin.convert_swin(model.state_dict(), SWIN_J)
    flat_back, flat_want = jax.tree.leaves(back), jax.tree.leaves(params("swin"))
    assert len(flat_back) == len(flat_want)
    for a, b in zip(flat_back, flat_want):
        np.testing.assert_array_equal(np.asarray(a), b)


def _ram_model():
    return load_ram_from_jax(params("ram"), RAM_T, "cpu")


def test_ram_forward_matches_jax():
    x = _pixels(1, 2, 64, 64, 3)
    want = _jit(jram.forward, cfg=RAM_J)(params("ram"), jnp.asarray(x))
    with torch.no_grad():
        got = tram.forward(_ram_model(), torch.tensor(x), RAM_T)
    assert got.dtype == torch.float32 and got.shape == (2, 12)
    _close(got, want)


@pytest.mark.parametrize("kwargs", [
    dict(), dict(add_classes=("floor",), remove_classes=("lamp",), bg_classes=("sky",)),
], ids=["defaults", "add_remove_bg"])
def test_tagger_gives_the_same_tags(kwargs):
    """``make_tagger`` with per-tag thresholds at the median probability
    (so about half fire) and with the reference's add / remove / background
    post-processing."""
    rng = np.random.default_rng(2)
    img = synth_photo(rng, 48, 64)
    with torch.no_grad():
        logits = tram.forward(_ram_model(), torch.tensor(tram.preprocess_image(img, 64)[None]), RAM_T)[0].numpy()
    th = np.full(12, float(np.median(1 / (1 + np.exp(-logits)))), np.float32)
    want = jram.make_tagger(params("ram"), RAM_J, TAGS, thresholds=th, **kwargs)(img)
    got = tram.make_tagger(_ram_model(), RAM_T, TAGS, thresholds=th, device="cpu", **kwargs)(img)
    assert got == want and 0 < len(got) < 12


def test_convert_ram_raises_as_the_reference():
    with pytest.raises(NotImplementedError):
        jram.convert_ram({}, RAM_J)
    with pytest.raises(NotImplementedError):
        tram.convert_ram({}, RAM_T, "cpu")


# ---------------------------------------------------------------------------
# OWL-ViT
# ---------------------------------------------------------------------------


def _tokenize(prompts):
    """A character tokenizer stand-in (tests/test_synth_models.py's): bos 2,
    one id per byte, the end-of-text id 63 (the largest, as CLIP's) last."""
    ids = np.full((len(prompts), 8), 2, np.int64)
    for i, p in enumerate(prompts):
        for j, ch in enumerate(p.encode()[:6]):
            ids[i, 1 + j] = 2 + ch % 58
    ids[:, -1] = 63
    return ids, np.ones_like(ids)


def _owl_inputs():
    """Pixels and 4 text queries: 3 real (one shorter, padded past its end)
    and one padding query of zeros, as ``make_detector`` pads."""
    ids, mask = _tokenize(["a photo of a chair", "a photo of a lamp", "a rug"])
    ids[2, 4:], mask[2, 4:] = 0, 0
    ids[2, 3] = 63
    ids, mask = np.pad(ids, ((0, 1), (0, 0))), np.pad(mask, ((0, 1), (0, 0)))
    return _pixels(4, 2, 64, 64, 3), ids, mask


def _owl_model():
    return load_owl_vit_from_jax(params("owl"), OWL_T, "cpu")


def _owl_jax(what):
    p, (x, ids, mask) = params("owl"), _owl_inputs()
    feats = _jit(jowl.encode_image, cfg=OWL_J)(p, jnp.asarray(x))
    queries = _jit(jowl.encode_text, cfg=OWL_J)(p, jnp.asarray(ids), jnp.asarray(mask))
    return {
        "encode_image": lambda: feats,
        "encode_text": lambda: queries,
        "predict_boxes": lambda: _jit(jowl.predict_boxes, cfg=OWL_J)(p, feats),
        "predict_classes": lambda: _jit(jowl.predict_classes)(p, feats, queries, jnp.asarray(ids[:, 0] > 0)),
        "detect": lambda: _jit(jowl.detect, cfg=OWL_J)(p, pixel_values=x, input_ids=ids, attention_mask=mask),
    }[what]()


@pytest.mark.parametrize("what", ["encode_image", "encode_text", "predict_boxes", "predict_classes", "detect"])
def test_owl_vit_matches_jax(what):
    model, (x, ids, mask) = _owl_model(), _owl_inputs()
    x, ids, mask = torch.tensor(x), torch.tensor(ids), torch.tensor(mask)
    want = _owl_jax(what)
    with torch.no_grad():
        feats = towl.encode_image(model, x, OWL_T)
        queries = towl.encode_text(model, ids, mask, OWL_T)
        got = {
            "encode_image": lambda: feats,
            "encode_text": lambda: queries,
            "predict_boxes": lambda: towl.predict_boxes(model, feats, OWL_T),
            "predict_classes": lambda: towl.predict_classes(model, feats, queries, ids[:, 0] > 0),
            "detect": lambda: towl.detect(model, OWL_T, x, ids, mask),
        }[what]()
    for g, w in zip(got, want) if what == "detect" else [(got, want)]:
        w = np.asarray(w)
        live = w > np.finfo(np.float32).min  # the padding query's logits: the f32 minimum in both
        np.testing.assert_array_equal(g.numpy() > np.finfo(np.float32).min, live)
        _close(torch.where(torch.tensor(live), g, 0.0), np.where(live, w, 0.0))


def test_owl_vit_state_dict_is_what_convert_owlvit_reads():
    """The port's module holds the HF ``OwlViTForObjectDetection`` names:
    its state dict through the JAX ``convert_owlvit`` gives back the tree,
    and the port's ``convert_owlvit`` loads it back bit for bit, with HF's
    extra entries in the dict left unread."""
    model = _owl_model()
    sd = model.state_dict()
    back = jowl.convert_owlvit(sd, OWL_J)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params("owl"))):
        np.testing.assert_array_equal(np.asarray(a), b)
    extra = dict(sd, **{"owlvit.logit_scale": torch.ones(()), "owlvit.visual_projection.weight": torch.ones(2, 2)})
    again = towl.convert_owlvit(extra, OWL_T, "cpu")
    assert all(torch.equal(t, sd[k]) for k, t in again.state_dict().items())


def test_make_detector_gives_the_same_detections():
    """Labels and scores equal, boxes within 1e-3 px, at the reference's
    default threshold and with more classes than queries (cut to 32)."""
    img = synth_photo(np.random.default_rng(5), 48, 64)
    classes = [f"thing{i}" for i in range(40)]
    ids, mask = _tokenize(["a photo of a thing"])
    logits, _ = _jit(jowl.detect, cfg=OWL_J)(params("owl"), pixel_values=jowl.preprocess_image(img, 64)[None],
                                             input_ids=ids, attention_mask=mask)
    th = float(np.median(1 / (1 + np.exp(-np.asarray(logits)[0, :, 0]))))  # about half the patches pass
    want = jowl.make_detector(params("owl"), OWL_J, _tokenize, box_threshold=th)(img, classes)
    got = towl.make_detector(_owl_model(), OWL_T, _tokenize, box_threshold=th, device="cpu")(img, classes)
    assert len(want) > 0 and [d[0] for d in got] == [d[0] for d in want]
    np.testing.assert_allclose([d[2] for d in got], [d[2] for d in want], rtol=1e-5)
    np.testing.assert_allclose(np.stack([d[1] for d in got]), np.stack([d[1] for d in want]), atol=1e-3, rtol=0)
    assert towl.make_detector(_owl_model(), OWL_T, _tokenize, device="cpu")(img, []) == []


# ---------------------------------------------------------------------------
# CameraNet
# ---------------------------------------------------------------------------


def _cam_model():
    return load_camera_net_from_jax(params("cam"), CAM_T, "cpu")


@pytest.mark.parametrize("what", ["forward", "calib_loss", "gravity", "intrinsics"])
def test_camera_net_matches_jax(what):
    p, model = params("cam"), _cam_model()
    if what in ("forward", "calib_loss"):
        x = _pixels(6, 3, 32, 32, 3)
        targets = np.random.default_rng(7).standard_normal((3, 3)).astype(np.float32) * 20 + [0, 0, 60]
        if what == "forward":
            want = _jit(jcal.forward, cfg=CAM_J)(p, jnp.asarray(x))
            got = tcal.forward(model, torch.tensor(x), CAM_T)
        else:
            want = _jit(jcal.calib_loss, cfg=CAM_J)(p, pixel_values=jnp.asarray(x), targets=jnp.asarray(targets))
            got = tcal.calib_loss(model, CAM_T, torch.tensor(x), torch.tensor(targets))
        with torch.no_grad():
            _close(got, want)
        return
    img = synth_photo(np.random.default_rng(8), 48, 64)
    make_j = jcal.make_gravity_model if what == "gravity" else jcal.make_intrinsics_model
    make_t = tcal.make_gravity_model if what == "gravity" else tcal.make_intrinsics_model
    want, got = make_j(p, CAM_J)(img), make_t(model, CAM_T, device="cpu")(img)
    _close(np.asarray(got, np.float32), np.asarray(want, np.float32))
