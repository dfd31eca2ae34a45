"""Port parity for the synthesis pipeline itself: the stage models of
``synth/models.py`` (SAM's segmenter on the port's HF-named ``state_dict()``
through the JAX ``convert_sam``; the depth models on ``init_params`` weights
through ``load_depth_anything_from_jax``), then ``SynthPipeline.annotate``
and ``run_directory`` against the JAX pipeline record for record, and the
stage builders' device rule.  fp32 on the CPU, tiny widths (the models of
tests/test_torch_synth.py); tolerance: max abs difference <= 1e-4 x the
largest |JAX output|, unless a test states another."""

import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch

from spatialrgpt_tpu.models import depth_anything as jda
from spatialrgpt_tpu.models import sam as jsam
from spatialrgpt_tpu.synth import calibration as jcal
from spatialrgpt_tpu.synth import models as jmodels
from spatialrgpt_tpu.synth import pipeline as jpipe
from spatialrgpt_tpu_torch.demo.pipeline import synth_photo
from spatialrgpt_tpu_torch.models import depth_anything as tda
from spatialrgpt_tpu_torch.models import owl_vit as towl
from spatialrgpt_tpu_torch.models import ram as tram
from spatialrgpt_tpu_torch.models import sam as tsam
from spatialrgpt_tpu_torch.synth import calibration as tcal
from spatialrgpt_tpu_torch.synth import models as tmodels
from spatialrgpt_tpu_torch.synth import pipeline as tpipe
from spatialrgpt_tpu_torch.utils.weights import init_random_sam_hq, load_depth_anything_from_jax
from test_torch_synth import (
    CAM_J,
    CAM_T,
    OWL_J,
    OWL_T,
    QUICK_XLA,
    RAM_J,
    RAM_T,
    TAGS,
    _cam_model,
    _close,
    _np_tree,
    _owl_model,
    _ram_model,
    _tokenize,
    params,
)

# tests/test_torch_sam.py's and tests/test_torch_depth.py's tiny SAM and
# Depth-Anything, the latter with the metric head
_SAM_V = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4, intermediate_size=128, image_size=64,
              patch_size=16, output_channels=32, window_size=2, global_attn_indexes=(1, 3))
_SAM = dict(prompt_hidden_size=32, image_embedding_size=4, decoder_hidden_size=32, decoder_num_heads=2,
            decoder_mlp_dim=64, decoder_layers=2)
_DA = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4, intermediate_size=256, patch_size=14,
           out_indices=(1, 2, 3, 4), neck_hidden_sizes=(16, 24, 32, 40), reassemble_factors=(4, 2, 1, 0.5),
           fusion_hidden_size=32, head_hidden_size=16, image_size=56, metric=True, max_depth=20.0)
SAM_J = jsam.SamConfig(vision=jsam.SamVisionConfig(**_SAM_V), **_SAM)
SAM_T = tsam.SamConfig(vision=tsam.SamVisionConfig(**_SAM_V), **_SAM)
DA_J, DA_T = jda.DepthAnythingConfig(**_DA), tda.DepthAnythingConfig(**_DA)


@functools.lru_cache(maxsize=None)
def sam_pair():
    model = init_random_sam_hq(SAM_T, "cpu", torch.float32, seed=0)
    return model, _np_tree(jsam.convert_sam(model.state_dict(), SAM_J))


@functools.lru_cache(maxsize=None)
def depth_params():
    """``init_params`` with the head's last conv drawn instead of zeroed (so
    the depth has spread), as tests/test_torch_depth.py draws it."""
    p = _np_tree(jax.jit(jda.init_params, static_argnums=1, compiler_options=QUICK_XLA)(jax.random.PRNGKey(0), DA_J))
    p["head"]["conv3"]["kernel"] = np.random.default_rng(9).standard_normal((1, 1, 16, 1)).astype(np.float32) * 0.25
    return p


def test_sam_segmenter_gives_the_same_masks():
    """Equal masks except at pixels whose resized logit is within 1e-4 of 0
    (none expected)."""
    model, p = sam_pair()
    img = synth_photo(np.random.default_rng(10), 30, 50)
    boxes = [np.array([5, 5, 40, 25], np.float32), np.array([0, 0, 20, 20], np.float32)]
    want = jmodels.make_sam_segmenter(p, SAM_J)(img, boxes)
    got = tmodels.make_sam_segmenter(model, SAM_T, device="cpu")(img, boxes)
    x, b = tmodels.sam_inputs(img, boxes, SAM_T)
    logits, _ = tsam.predict_boxes(model, SAM_T, torch.tensor(x), torch.tensor(b))
    from PIL import Image

    for g, w, lg in zip(got, want, logits.numpy()):
        near = np.abs(np.asarray(Image.fromarray(lg).resize((50, 30), Image.BILINEAR))) < 1e-4
        assert g.shape == (30, 50) and g.dtype == bool and 0 < w.sum() < w.size
        np.testing.assert_array_equal(g[~near], w[~near])
    assert tmodels.make_sam_segmenter(model, SAM_T, device="cpu")(img, []) == []


@pytest.mark.parametrize("which", ["relative", "metric", "metric_no_intrinsics"])
def test_depth_models_match_jax(which):
    p = depth_params()
    img = synth_photo(np.random.default_rng(11), 48, 64)
    if which == "relative":
        cfg_j, cfg_t = (dataclasses.replace(c, metric=False, max_depth=1.0) for c in (DA_J, DA_T))
        want = jmodels.make_depth_model(p, cfg_j)(img)
        got = tmodels.make_depth_model(load_depth_anything_from_jax(p, cfg_t, "cpu"), cfg_t, device="cpu")(img)
    else:
        K = jcal.intrinsics_from_vfov(64, 48, 55.0) if which == "metric" else None
        want = jmodels.make_metric_depth_model(p, DA_J)(img, K)
        got = tmodels.make_metric_depth_model(load_depth_anything_from_jax(p, DA_T, "cpu"), DA_T, device="cpu")(img, K)
    assert got.shape == (48, 64) and float(np.std(want)) > 0
    _close(got, want)


# ---------------------------------------------------------------------------
# the whole pipeline
# ---------------------------------------------------------------------------

# random weights: every tag fires and every patch proposal is kept; the
# filters loosened as tests/test_synth_models.py loosens them
TAGGER_TH = np.zeros(12, np.float32)
SYNTH_KW = dict(min_detections=2, max_detections=6, mask_area_min=0.0, mask_area_max=1.0, nms_iou=1.01,
                containment_iou=1.01, dbscan_min_points=2, n_pairs=2, n_conv=2)


def _stage_models(side: str):
    sam_model, sam_p = sam_pair()
    if side == "jax":
        return jmodels.build_stage_models(
            ram_params=params("ram"), ram_cfg=RAM_J, ram_tags=TAGS, owl_params=params("owl"), owl_cfg=OWL_J,
            owl_tokenize=_tokenize, sam_params=sam_p, sam_cfg=SAM_J, depth_params=depth_params(), depth_cfg=DA_J,
            calib_params=params("cam"), calib_cfg=CAM_J, box_threshold=0.0, thresholds=TAGGER_TH)
    return tmodels.build_stage_models(
        ram_params=_ram_model(), ram_cfg=RAM_T, ram_tags=TAGS, owl_params=_owl_model(), owl_cfg=OWL_T,
        owl_tokenize=_tokenize, sam_params=sam_model, sam_cfg=SAM_T,
        depth_params=load_depth_anything_from_jax(depth_params(), DA_T, "cpu"), depth_cfg=DA_T,
        calib_params=_cam_model(), calib_cfg=CAM_T, box_threshold=0.0, thresholds=TAGGER_TH, device="cpu")


def _records_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = got[name], want[name]
        assert [q for q in g["qa"]] == [q for q in w["qa"]], name
        assert [o["caption"] for o in g["objects"]] == [o["caption"] for o in w["objects"]], name
        for go, wo in zip(g["objects"], w["objects"]):
            np.testing.assert_allclose(go["box"], wo["box"], atol=1e-3, rtol=0)
            for key in ("center", "extent"):
                np.testing.assert_allclose(go[key], wo[key], atol=1e-4, rtol=0, err_msg=f"{name} {key}")


def test_pipeline_annotate_and_run_directory_match_jax(tmp_path):
    """Tagger -> detector -> SAM -> CameraNet intrinsics and gravity ->
    metric depth -> lift -> QA, with every slot filled, on 3 PNGs of two
    shapes plus a blank one that the segment stage skips: ``annotate``'s
    records and ``run_directory``'s JSON equal the JAX pipeline's (the same
    captions, QA strings and types; boxes within 1e-3 px, centres and
    extents within 1e-4), skips included."""
    from PIL import Image

    rng = np.random.default_rng(12)
    imgs = {"a.png": synth_photo(rng, 48, 64), "b.png": synth_photo(rng, 64, 48), "c.png": synth_photo(rng, 48, 64)}
    for name, img in imgs.items():
        Image.fromarray(img).save(tmp_path / name)
    (tmp_path / "notes.txt").write_text("not an image")
    models = {"jax": _stage_models("jax"), "torch": _stage_models("torch")}
    assert set(models["torch"]) == set(models["jax"]) == {"tagger", "detector", "segmenter", "depth_model",
                                                          "gravity_model", "intrinsics_model"}
    pipes = {"jax": jpipe.SynthPipeline(jpipe.SynthConfig(**SYNTH_KW), **models["jax"]),
             "torch": tpipe.SynthPipeline(tpipe.SynthConfig(**SYNTH_KW), **models["torch"])}
    one = {side: pipes[side].annotate(imgs["a.png"]) for side in pipes}
    _records_equal({"a": one["torch"]}, {"a": one["jax"]})
    assert len(one["jax"]["objects"]) >= 2 and len(one["jax"]["qa"]) > 0
    blank = np.zeros((48, 64, 3), np.uint8)  # a region-free photo: skipped or annotated alike
    outcome = {}
    for side, pipe in pipes.items():
        try:
            outcome[side] = pipe.annotate(blank)
        except (jpipe.SkipImageException, tpipe.SkipImageException) as e:
            outcome[side] = type(e).__name__
    assert type(outcome["torch"]) is type(outcome["jax"])
    if isinstance(outcome["jax"], dict):
        _records_equal({"blank": outcome["torch"]}, {"blank": outcome["jax"]})
    stats = {side: mod.run_directory(pipes[side], str(tmp_path), str(tmp_path / side / "out.json"))
             for side, mod in (("jax", jpipe), ("torch", tpipe))}
    assert stats["torch"] == stats["jax"] and stats["jax"]["annotated"] >= 2
    recs = {side: json.loads((tmp_path / side / "out.json").read_text()) for side in stats}
    _records_equal(recs["torch"], recs["jax"])


def test_pipeline_skips_match_jax():
    """``SkipImageException`` where the reference raises it: no detector,
    too few detections after the filters, no depth."""
    img = synth_photo(np.random.default_rng(13), 48, 64)
    for pipe_mod in (jpipe, tpipe):
        with pytest.raises(pipe_mod.SkipImageException, match="no detector"):
            pipe_mod.SynthPipeline(pipe_mod.SynthConfig()).annotate(img)
    kw = dict(SYNTH_KW, min_detections=7)
    jm, tm = _stage_models("jax"), _stage_models("torch")
    for pipe_mod, m in ((jpipe, jm), (tpipe, tm)):
        with pytest.raises(pipe_mod.SkipImageException, match="detections after filtering"):
            pipe_mod.SynthPipeline(pipe_mod.SynthConfig(**kw), **m).annotate(img)
        seg_only = {k: m[k] for k in ("tagger", "detector", "segmenter")}
        with pytest.raises(pipe_mod.SkipImageException, match="no depth"):
            pipe_mod.SynthPipeline(pipe_mod.SynthConfig(**SYNTH_KW), **seg_only).annotate(img)


# ---------------------------------------------------------------------------
# the device
# ---------------------------------------------------------------------------

_BUILDERS = {
    "build_stage_models": lambda: tmodels.build_stage_models(),
    "make_tagger": lambda: tram.make_tagger(_ram_model(), RAM_T, TAGS),
    "make_detector": lambda: towl.make_detector(_owl_model(), OWL_T, _tokenize),
    "make_sam_segmenter": lambda: tmodels.make_sam_segmenter(sam_pair()[0], SAM_T),
    "make_depth_model": lambda: tmodels.make_depth_model(load_depth_anything_from_jax(depth_params(), DA_T, "cpu"), DA_T),
    "make_metric_depth_model": lambda: tmodels.make_metric_depth_model(
        load_depth_anything_from_jax(depth_params(), DA_T, "cpu"), DA_T),
    "make_gravity_model": lambda: tcal.make_gravity_model(_cam_model(), CAM_T),
    "make_intrinsics_model": lambda: tcal.make_intrinsics_model(_cam_model(), CAM_T),
}


@pytest.mark.parametrize("builder", sorted(_BUILDERS))
def test_stage_builders_need_a_card_or_a_device(monkeypatch, builder):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card.*device='cpu'"):
        _BUILDERS[builder]()
