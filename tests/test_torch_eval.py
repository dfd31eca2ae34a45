"""Port parity for the evaluation entry points and the model leftovers they
pass through: ``eval/spatial_bench.py::run_bench`` (SpatialRGPT-Bench),
``eval/region_cls.py::run_region_cls``, ``eval/vqa.py::run_vqa`` and the
judge, against the JAX package's runners on one annotation file, one set
of images and one set of weights (a JAX ``init_params`` pytree carried
across by ``load_from_jax``), in fp32 on the CPU, where the port's kernel
wrappers take their plain versions.  The answers files must be equal
record for record: the raw greedy ids, the decoded text and every other
field.  Also: the identity and linear projectors, ``llama.forward_logits``,
``siglip.resize_pos_embeds`` and uint8 pixels through ``encode_images``.
Tolerances: fp32 accumulation order, except where a test states another.

The model is ``__graft_entry__._tiny_cfg`` with the mask / depth ids and
``model_max_length`` of ``tests/test_eval.py`` (its vocabulary widened to
1024, so that every id of the character tokenizer has an embedding row in
both packages), the tokenizer ``tests/test_templates.py::FakeTokenizer``
and the depth model ``tests/test_depth_anything.py``'s TINY at a 56-pixel
table."""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import __graft_entry__ as graft
from spatialrgpt_tpu import config as jconfig
from spatialrgpt_tpu.data import preprocess as jpp
from spatialrgpt_tpu.eval import judge as jjudge
from spatialrgpt_tpu.eval import region_cls as jrc
from spatialrgpt_tpu.eval import spatial_bench as jsb
from spatialrgpt_tpu.eval import vqa as jvqa
from spatialrgpt_tpu.models import depth_anything as jda
from spatialrgpt_tpu.models import llama as jllama
from spatialrgpt_tpu.models import projector as jproj
from spatialrgpt_tpu.models import siglip as jsiglip
from spatialrgpt_tpu.models import vlm as jvlm
from spatialrgpt_tpu_torch import config as tconfig
from spatialrgpt_tpu_torch.data import device_preprocess as tdp
from spatialrgpt_tpu_torch.data import preprocess as tpp
from spatialrgpt_tpu_torch.eval import judge as tjudge
from spatialrgpt_tpu_torch.eval import region_cls as trc
from spatialrgpt_tpu_torch.eval import spatial_bench as tsb
from spatialrgpt_tpu_torch.eval import vqa as tvqa
from spatialrgpt_tpu_torch.models import depth_anything as tda
from spatialrgpt_tpu_torch.models import llama as tllama
from spatialrgpt_tpu_torch.models import projector as tproj
from spatialrgpt_tpu_torch.models import siglip as tsiglip
from spatialrgpt_tpu_torch.models import vlm as tvlm
from spatialrgpt_tpu_torch.ops.layers import QuantLinear
from spatialrgpt_tpu_torch.utils.export import export_projector
from spatialrgpt_tpu_torch.utils.weights import export_depth_anything, load_depth_anything_from_jax, load_from_jax
from test_templates import FakeTokenizer
from test_torch_depth import da_cfgs, da_params

# the reference programs here run once each: XLA's CPU backend at optimisation
# level 0 compiles them in about half the time
QUICK_XLA = {"xla_backend_optimization_level": 0}

JCFG = graft._tiny_cfg(vocab=1024).replace(mask_token_id=1009, depth_token_id=1010, model_max_length=512)
TCFG = tconfig.SpatialRGPTConfig.from_json(JCFG.to_json())
DA_T, DA_J = da_cfgs(56)
DA_TARGET = 56

# a SpatialRGPT-Bench-shaped file: 3 images of two sizes (Depth-Anything
# batches by shape), rle masks (1-2), an entry with a bbox only, 1-2 rounds;
# 6 records, so batches of 4 make one full batch and one ragged
IMAGES = {"a.jpg": (60, 80), "b.jpg": (60, 80), "c.jpg": (72, 48)}


def _mask(hw, box):
    m = np.zeros(hw, np.uint8)
    x1, y1, x2, y2 = box
    m[y1:y2, x1:x2] = 1
    return m


def _entry(qid, fp, masks, bbox, qa, rounds):
    h, w = IMAGES[fp]
    conv = []
    for i, (q, a) in enumerate(rounds):
        conv += [{"from": "human", "value": ("<image>\n" if i == 0 else "") + q}, {"from": "gpt", "value": a}]
    e = {"id": qid, "image_info": {"file_path": fp, "height": h, "width": w}, "text_q": rounds[0][0],
         "qa_info": {"type": qa[0], "category": qa[1]}, "bbox": bbox, "conversations": conv}
    if masks:
        e["rle"] = [tpp.rle_encode(_mask((h, w), b)) for b in masks]
    return e


ANNOTATIONS = [
    _entry("q0", "a.jpg", [[20, 10, 50, 30], [5, 30, 40, 58]], [[20, 10, 50, 30], [5, 30, 40, 58]],
           ("quantitative", "width_data"),
           [("How wide is Region [0] <mask>?", "1.0 meters"), ("How far is Region [1] <mask>?", "2 meters")]),
    _entry("q1", "b.jpg", [[0, 0, 30, 30]], [[0, 0, 30, 30]], ("qualitative", "left_predicate"),
           [("Is Region [0] <mask> to the left?", "Yes, it is on the left.")]),
    _entry("q2", "c.jpg", None, [[4, 6, 40, 60]], ("quantitative", "direction"),
           [("Where is Region [0] <mask>?", "At 3 o'clock.")]),
    _entry("q3", "a.jpg", [[40, 20, 78, 59]], [[40, 20, 78, 59]], ("qualitative", "tall_predicate"),
           [("Is Region [0] <mask> taller?", "Region [0] is taller."), ("Is it wider?", "It is thinner.")]),
]
BENCH = dict(conv_mode="llama_3", batch_size=4, max_new_tokens=4, prompt_bucket=512, regions_per_image=2)
CASES = {
    "model_depth": {},
    "depth_folder": {"depth_folder": "depth"},  # c.jpg's depth from a PNG, the others from the model
    "w8a8_kv_int8_rgb": {"w8a8": True, "kv_quant": True, "depth_source": "rgb"},
}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The data directory and both packages' models: (root, JAX tuple, port
    tuple, JAX depth predictor, port depth predictor)."""
    root = tmp_path_factory.mktemp("eval")
    os.makedirs(root / "imgs")
    os.makedirs(root / "depth")
    rng = np.random.default_rng(0)
    for name, hw in IMAGES.items():
        Image.fromarray(rng.integers(0, 256, (*hw, 3), np.uint8)).save(root / "imgs" / name)
    Image.fromarray(rng.integers(0, 256, (*IMAGES["c.jpg"], 3), np.uint8)).save(root / "depth" / "c.png")
    (root / "ann.json").write_text(json.dumps(ANNOTATIONS))

    params = jax.jit(jvlm.init_params, static_argnums=1, compiler_options=QUICK_XLA)(jax.random.PRNGKey(0), JCFG)
    np_params = jax.tree.map(np.asarray, params)
    model = load_from_jax(np_params, TCFG, "cpu")
    tok = FakeTokenizer()
    tok.model_max_length = 512
    jmodel = (tok, params, JCFG, jpp.SiglipProcessor(size=JCFG.vision.image_size))
    tmodel = (tok, model, TCFG, tpp.SiglipProcessor(size=TCFG.vision.image_size))
    p = da_params(DA_J, 3)
    jpred = jda.DepthPredictor(jax.tree.map(jnp.asarray, p), DA_J, target=DA_TARGET)
    tpred = tda.DepthPredictor(load_depth_anything_from_jax(p, DA_T, "cpu"), DA_T, target=DA_TARGET)
    return root, jmodel, tmodel, jpred, tpred


def _bench_cfg(bcfg_cls, root, case, side):
    kw = dict(CASES[case])
    if "depth_folder" in kw:
        kw["depth_folder"] = str(root / kw["depth_folder"])
    return bcfg_cls(annotation_file=str(root / "ann.json"), image_folder=str(root / "imgs"),
                    answers_file=str(root / side / case / "answers.jsonl"), **BENCH, **kw)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def jax_bench(env):
    """The JAX ``run_bench``'s answers file of a case, run once."""
    root, jmodel, _, jpred, _ = env

    @functools.lru_cache(maxsize=None)
    def run(case):
        return jsb.run_bench(_bench_cfg(jsb.BenchConfig, root, case, "jax"), model=jmodel, depth_model=jpred)

    return run


def _fingerprint(module):
    return {k: (t.dtype, t.clone()) for k, t in module.state_dict().items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_bench_matches_jax(env, jax_bench, case):
    """Record for record: the reference protocol with a Depth-Anything
    predictor (one per package, the same weights), one image's depth from a
    ``depth_folder`` PNG, and W8A8 + the int8 KV cache over RGB as depth.
    The W8A8 run quantizes a view: the caller's model keeps its float
    weights and no ``QuantLinear``."""
    root, _, tmodel, _, tpred = env
    before = _fingerprint(tmodel[1])
    got = tsb.run_bench(_bench_cfg(tsb.BenchConfig, root, case, "torch"), model=tmodel, depth_model=tpred,
                        device="cpu")
    want = _records(jax_bench(case))
    recs = _records(got)
    assert len(recs) == len(want) == 6
    assert [list(r) for r in recs] == [list(r) for r in want]  # the fields, in the reference's order
    assert recs == want
    assert [r["round"] for r in recs] == [0, 1, 0, 0, 0, 1]
    assert all(len(r["output_ids"]) == BENCH["max_new_tokens"] for r in recs)
    after = _fingerprint(tmodel[1])
    assert not any(isinstance(m, QuantLinear) for m in tmodel[1].modules())
    assert list(after) == list(before)
    for k, (dtype, t) in before.items():
        assert after[k][0] == dtype and torch.equal(after[k][1], t), k


def test_score_file_matches_jax(env, jax_bench):
    """``judge.score_file`` on the port's answers (the port's judge) against
    the JAX package's on its own: the same score.json."""
    root, _, tmodel, _, tpred = env
    want = jjudge.score_file(jax_bench("model_depth"))
    ans = tsb.run_bench(_bench_cfg(tsb.BenchConfig, root, "model_depth", "torch_score"), model=tmodel,
                        depth_model=tpred, device="cpu")
    got = tjudge.score_file(ans)
    assert got == want
    with open(os.path.join(os.path.dirname(ans), "score.json")) as f:
        assert json.load(f) == want
    cats = {a["qa_info"]["category"] for a in ANNOTATIONS}
    assert {"Quan_width_acc", "Quan_direction_acc", "Qual_left/right_acc", "Qual_tall/short_acc"} <= set(got), cats


def test_run_bench_refusals(env):
    """No predictor for ``depth_source="model"`` raises ``ValueError`` (no
    silent RGB fallback); ``tp > 1`` without a process group of tp ranks
    raises ``RuntimeError`` (tensor-parallel ``run_bench`` itself runs in
    tests/test_torch_tp.py)."""
    root, _, tmodel, _, _ = env
    bcfg = _bench_cfg(tsb.BenchConfig, root, "model_depth", "torch_refusals")
    with pytest.raises(ValueError, match="depth_source"):
        tsb.run_bench(bcfg, model=tmodel, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        tsb.run_bench(dataclasses.replace(bcfg, tp=2), model=tmodel, device="cpu")


def test_runners_need_a_card_unless_told(env):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    root, _, tmodel, _, tpred = env
    bcfg = _bench_cfg(tsb.BenchConfig, root, "model_depth", "torch_nocard")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsb.run_bench(bcfg, model=tmodel, depth_model=tpred)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trc.run_region_cls(tmodel, [], str(root / "imgs"), answers_file=str(root / "nocard.jsonl"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvqa.run_vqa(tvqa.VQAConfig(question_file=str(root / "ann.json")), tmodel)


@pytest.mark.parametrize("conv_mode", ["v1", "llama_3", "plain"])
def test_build_round_prompts_equal(conv_mode):
    for line in ANNOTATIONS:
        assert tsb.build_round_prompts(conv_mode, line["conversations"]) == \
            jsb.build_round_prompts(conv_mode, line["conversations"])
        q = line["conversations"][0]["value"]
        assert tsb.build_prompt(conv_mode, q) == jsb.build_prompt(conv_mode, q)
    assert tsb.stop_str_for(conv_mode) == jsb.stop_str_for(conv_mode)


@pytest.mark.parametrize("aspect", ["pad", "resize"])
@pytest.mark.parametrize("use_mask", [True, False])
def test_masks_for_line_equal(aspect, use_mask):
    """RLE masks, the bbox fallback (no rle, ``use_mask`` off, or an rle that
    fails to decode) and pad-to-square."""
    broken = dict(ANNOTATIONS[0], rle=[{"size": [60, 80], "counts": "not an rle"}])
    for line in ANNOTATIONS + [broken]:
        got, want = tsb.masks_for_line(line, aspect, use_mask), jsb.masks_for_line(line, aspect, use_mask)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _coco(root):
    return {
        "images": [{"id": 1, "file_name": "a.jpg", "height": 60, "width": 80},
                   {"id": 2, "file_name": "c.jpg", "height": 72, "width": 48}],
        "categories": [{"id": 3, "name": "dog"}, {"id": 4, "name": "chair"}],
        "annotations": [
            {"image_id": 1, "bbox": [10, 10, 30, 40], "category_id": 3},
            {"image_id": 1, "bbox": [0, 5, 70, 50], "category_id": 4, "iscrowd": 1},
            {"image_id": 2, "bbox": [4, 30, 40, 40], "category_id": 4},
            {"image_id": 1, "bbox": [50, 0, 25, 20], "category_id": 4},
        ],
    }


def test_run_region_cls_matches_jax(env):
    """The seeded paraphrase, the square crop, one region a row with the
    image as its depth; ``coco_annotation_to_items`` and
    ``score_region_predictions`` on both sides."""
    root, jmodel, tmodel, _, _ = env
    items = trc.coco_annotation_to_items(_coco(root))
    assert items == jrc.coco_annotation_to_items(_coco(root)) and len(items) == 3
    kw = dict(conv_mode="v1", batch_size=2, max_new_tokens=3, prompt_bucket=384, seed=1)
    want = _records(jrc.run_region_cls(jmodel, items, str(root / "imgs"), answers_file=str(root / "rc_j.jsonl"), **kw))
    got = _records(trc.run_region_cls(tmodel, items, str(root / "imgs"), answers_file=str(root / "rc_t.jsonl"),
                                      device="cpu", **kw))
    assert got == want and len(got) == 3
    assert trc.score_region_predictions(got) == jrc.score_region_predictions(want)
    recs = [{"pred": "a Dog on grass", "gt_category": "dog"}, {"pred": "table", "gt_category": "chair"}]
    assert trc.score_region_predictions(recs) == jrc.score_region_predictions(recs)
    for box, info in (([10, 10, 40, 50], {"height": 60, "width": 80}), ([0, 0, 70, 70], {"height": 60, "width": 80}),
                      ([30, 50, 45, 70], {"height": 72, "width": 48})):
        assert trc.get_crop_box([box], info) == jrc.get_crop_box([box], info)


def test_run_vqa_matches_jax(env):
    root, jmodel, tmodel, _, _ = env
    qs = [{"question_id": 7, "image": "a.jpg", "text": "What is in the image?"},
          {"image": "c.jpg", "text": "<image>\nDescribe it."},
          {"question_id": "x", "image": "b.jpg", "text": "Any red?"}]
    with open(root / "vqa.jsonl", "w") as f:
        f.writelines(json.dumps(q) + "\n" for q in qs)
    kw = dict(question_file=str(root / "vqa.jsonl"), image_folder=str(root / "imgs"), conv_mode="v1", batch_size=2,
              max_new_tokens=3, prompt_bucket=384)
    want = _records(jvqa.run_vqa(jvqa.VQAConfig(answers_file=str(root / "vqa_j.jsonl"), **kw), jmodel))
    got = _records(tvqa.run_vqa(tvqa.VQAConfig(answers_file=str(root / "vqa_t.jsonl"), **kw), tmodel, device="cpu"))
    assert got == want and len(got) == 3


def test_depth_model_path_matches_jax(tmp_path, monkeypatch):
    """``depth_model_path``: an HF-named ``pytorch_model.bin`` (written from
    ``export_depth_anything``) loaded strictly by the port against the JAX
    package's ``convert_depth_anything`` of the same file; both ``_build_depth_predictor``s read
    ``DepthAnythingConfig()``, here patched to the tiny model.  The
    tolerance of ``test_torch_depth.py::test_depth_predictor_matches_jax``."""
    p = da_params(DA_J, 5)
    sd = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in export_depth_anything(p, DA_T).items()}
    sd["backbone.embeddings.mask_token"] = torch.zeros(1, DA_T.hidden_size)  # HF's, unused by the model
    torch.save(sd, tmp_path / "pytorch_model.bin")
    fields = {f.name: getattr(DA_T, f.name) for f in dataclasses.fields(DA_T)}
    monkeypatch.setattr(jda, "DepthAnythingConfig", functools.partial(jda.DepthAnythingConfig, **fields))
    monkeypatch.setattr(tda, "DepthAnythingConfig", functools.partial(tda.DepthAnythingConfig, **fields))
    bcfg = dict(depth_model_path=str(tmp_path))
    want_pred = jsb._build_depth_predictor(jsb.BenchConfig(**bcfg), None)
    got_pred = tsb._build_depth_predictor(tsb.BenchConfig(**bcfg), None, "cpu")
    assert isinstance(got_pred, tda.DepthPredictor) and got_pred.cfg == DA_T
    raw = list(np.random.default_rng(6).integers(0, 256, (2, 50, 70, 3), np.uint8))
    for g, w in zip(got_pred.predict_colorized(raw), want_pred.predict_colorized(raw)):
        assert g.shape == w.shape == (50, 70, 3) and g.dtype == np.uint8
        diff = np.abs(g.astype(int) - w.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01


# ---------------------------------------------------------------------------
# model leftovers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["identity", "linear"])
def test_projector_types_match_jax(kind):
    jcfg = jconfig.ProjectorConfig(projector_type=kind, mm_hidden_size=16, hidden_size=16 if kind == "identity" else 32)
    tcfg = tconfig.ProjectorConfig(**dataclasses.asdict(jcfg))
    params = jax.tree.map(np.asarray, jproj.init_params(jax.random.PRNGKey(2), jcfg))
    module = tproj.MultimodalProjector(tcfg)
    module.load_state_dict({k: torch.tensor(v) for k, v in export_projector(params, kind).items()}, strict=True)
    x = np.random.default_rng(3).standard_normal((2, 25, 16)).astype(np.float32)
    want = jproj.forward(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jcfg)
    got = tproj.forward(module, torch.tensor(x), tcfg)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert len(list(module.parameters())) == (2 if kind == "linear" else 0)


def test_vlm_with_linear_projector_loads_from_jax():
    """``load_from_jax`` carries a linear projector's ``fc`` across, and the
    spliced image tokens equal JAX's (no 2x2 fold: tokens_per_image is the
    pooled grid)."""
    jcfg = JCFG.replace(projector=jconfig.ProjectorConfig(projector_type="linear", mm_hidden_size=32, hidden_size=64))
    tcfg = tconfig.SpatialRGPTConfig.from_json(jcfg.to_json())
    params = jax.tree.map(np.asarray, jax.jit(jvlm.init_params, static_argnums=1, compiler_options=QUICK_XLA)(
        jax.random.PRNGKey(4), jcfg))
    model = load_from_jax(params, tcfg, "cpu")
    px = np.random.default_rng(4).standard_normal((2, 56, 56, 3)).astype(np.float32)
    want, _, _ = jvlm.encode_images(jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(px), None, None)
    got, _, _ = tvlm.encode_images(model, tcfg, torch.tensor(px), None, None)
    assert tuple(got.shape) == want.shape == (2, tcfg.tokens_per_image, 64)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=2e-5)


def test_forward_logits_matches_jax(env):
    _, jmodel, tmodel, _, _ = env
    rng = np.random.default_rng(5)
    ids = rng.integers(0, JCFG.llm.vocab_size, (2, 12))
    pos = np.tile(np.arange(12), (2, 1))
    seg = np.ones((2, 12), np.int32)
    seg[1, 9:] = 0
    want = jllama.forward_logits(jmodel[1]["llm"], JCFG.llm, input_ids=jnp.asarray(ids), position_ids=jnp.asarray(pos),
                                 segment_ids=jnp.asarray(seg))
    got = tllama.forward_logits(tmodel[1].llm, TCFG.llm, input_ids=torch.tensor(ids), position_ids=torch.tensor(pos),
                                segment_ids=torch.tensor(seg))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("new_resolution", [84, 42, 56, -1])
def test_resize_pos_embeds_matches_jax(env, new_resolution):
    """The reference's index mapping exactly (up and down); the input model
    keeps its table; at the same resolution (or -1) nothing changes."""
    _, jmodel, tmodel, _, _ = env
    model = tmodel[1].vision_tower
    before = model.vision_model.embeddings.position_embedding.weight.clone()
    jp, jc = jsiglip.resize_pos_embeds(jmodel[1]["vision"], JCFG.vision, new_resolution)
    tm, tc = tsiglip.resize_pos_embeds(model, TCFG.vision, new_resolution)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    table = tm.vision_model.embeddings.position_embedding.weight
    assert tuple(table.shape) == jp["pos_embed"].shape == (tc.num_patches, TCFG.vision.hidden_size)
    np.testing.assert_allclose(table.detach().numpy(), np.asarray(jp["pos_embed"]), rtol=1e-6, atol=1e-7)
    assert torch.equal(model.vision_model.embeddings.position_embedding.weight, before)
    assert tm.vision_model.encoder is model.vision_model.encoder  # the rest is shared
    px = np.random.default_rng(6).standard_normal((1, tc.image_size, tc.image_size, 3)).astype(np.float32)
    want = jsiglip.forward_features(jp, jnp.asarray(px), jc)
    got = tsiglip.forward_features(tm, torch.tensor(px), tc)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=2e-5)


def test_uint8_pixels_through_encode_images_match_jax(env):
    """Raw uint8 images and depths are normalized on the device into the
    tower's dtype and uint8 masks cast, as the reference's
    ``encode_images`` does: against JAX on the same uint8 inputs, and
    against the port's own float path on the normalized pixels."""
    _, jmodel, tmodel, _, _ = env
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (2, 56, 56, 3), np.uint8)
    deps = rng.integers(0, 256, (2, 56, 56, 3), np.uint8)
    masks = (rng.random((2, 2, 56, 56)) > 0.5).astype(np.uint8)
    want = jvlm.encode_images(jmodel[1], JCFG, jnp.asarray(imgs), jnp.asarray(deps), jnp.asarray(masks))
    got = tvlm.encode_images(tmodel[1], TCFG, torch.tensor(imgs), torch.tensor(deps), torch.tensor(masks))
    floats = tvlm.encode_images(tmodel[1], TCFG, tdp.device_siglip_normalize(torch.tensor(imgs)),
                                tdp.device_siglip_normalize(torch.tensor(deps)), torch.tensor(masks).float())
    for g, w, f in zip(got, want, floats):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-4, atol=2e-5)
        np.testing.assert_allclose(g.detach().numpy(), f.detach().numpy(), rtol=1e-5, atol=1e-6)
