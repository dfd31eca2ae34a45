"""The port's copies of the data layer (``data/{tokenize,templates,
preprocess,sampler,interleaved,video,prefetch,dataset}.py``) and of
``train/args.py`` give what the JAX package's originals give: the same
ids and labels, pixels, masks, index streams, samples and collated batches
on the same inputs, and ``VLMInputs.from_spliced`` the arrays of the
reference's ``to_vlm_inputs``.  Exact equality throughout: the copies run
the same numpy code."""

import dataclasses
import json
import os
import subprocess

import numpy as np
import pytest
import torch
from PIL import Image

from spatialrgpt_tpu import conversation as jconv
from spatialrgpt_tpu.data import dataset as jds
from spatialrgpt_tpu.data import interleaved as jinter
from spatialrgpt_tpu.data import prefetch as jprefetch
from spatialrgpt_tpu.data import preprocess as jpre
from spatialrgpt_tpu.data import sampler as jsampler
from spatialrgpt_tpu.data import templates as jtemplates
from spatialrgpt_tpu.data import tokenize as jtokenize
from spatialrgpt_tpu.data import video as jvideo
from spatialrgpt_tpu.train import args as jargs
from spatialrgpt_tpu_torch.data import dataset as tds
from spatialrgpt_tpu_torch.data import interleaved as tinter
from spatialrgpt_tpu_torch.data import prefetch as tprefetch
from spatialrgpt_tpu_torch.data import preprocess as tpre
from spatialrgpt_tpu_torch.data import sampler as tsampler
from spatialrgpt_tpu_torch.data import templates as ttemplates
from spatialrgpt_tpu_torch.data import tokenize as ttokenize
from spatialrgpt_tpu_torch.data import video as tvideo
from spatialrgpt_tpu_torch.models.vlm import VLMInputs
from spatialrgpt_tpu_torch.train import args as targs

from test_templates import FakeTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _same_sample(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (a is None) == (b is None), f.name
        if b is not None:
            _same(a, b, f.name)


# ---------------------------------------------------------------------------
# tokenize + templates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lstrip", [False, True])
@pytest.mark.parametrize("bos", [True, False])
def test_tokenizer_image_token_equal(bos, lstrip):
    tok = FakeTokenizer(prepend_bos=bos)
    for prompt in ("hi<image>yo", "<image>\nwhat<image>is it?", "no image here"):
        want = jtokenize.tokenizer_image_token(prompt, tok, lstrip=lstrip, return_array=True)
        _same(ttokenize.tokenizer_image_token(prompt, tok, lstrip=lstrip, return_array=True), want, prompt)


def _outcome(templates, name, tok, sources, has_image):
    templates.set_default_template(name)
    try:
        return templates.preprocess(sources, tok, has_image=has_image)
    except Exception as e:  # the copy must fail where the original fails
        return type(e).__name__
    finally:
        templates.set_default_template("v1")


def _conversations(has_image):
    img = "<image>\n" if has_image else ""
    first = [{"from": "human", "value": img + "Is <mask> <depth> left of <mask> <depth>?"},
             {"from": "gpt", "value": "Yes, by about 2 meters."}]
    return [first], [first + [{"from": "human", "value": "And its height?"}, {"from": "gpt", "value": "1.5 m"}]]


def _ids_labels_equal(got, want, what):
    if isinstance(want, str):
        assert got == want, what
        return
    for key in ("input_ids", "labels"):
        assert len(got[key]) == len(want[key]) == 1
        _same(got[key][0], want[key][0], f"{what} {key}")


@pytest.mark.parametrize("has_image", [True, False])
@pytest.mark.parametrize("name", sorted(jconv.conv_templates))
def test_template_preprocess_equal(name, has_image):
    """Every conversation template's ``preprocess``: ids and labels of a
    one-round and a two-round conversation, with and without the image,
    BOS prepended by the tokenizer or not."""
    for sources in _conversations(has_image):
        for bos in (True, False):
            want = _outcome(jtemplates, name, FakeTokenizer(prepend_bos=bos), sources, has_image)
            got = _outcome(ttemplates, name, FakeTokenizer(prepend_bos=bos), sources, has_image)
            _ids_labels_equal(got, want, name)


@pytest.mark.parametrize("fn,template", [("preprocess_v1", "v1"), ("preprocess_llama_2", "llama_2"),
                                         ("preprocess_llama_3", "llama_3"), ("preprocess_mpt", "mpt")])
def test_template_rounds_unstrict_equal(fn, template):
    """The round-splitting label arithmetic with ``strict=False`` (the fake
    tokenizer lacks the real ones' merges, so strict mode falls back to
    all-IGNORE labels on some templates): answers supervised, the rest not."""
    for has_image in (True, False):
        for sources in _conversations(has_image):
            for bos in (True, False):
                outs = []
                for templates in (jtemplates, ttemplates):
                    templates.set_default_template(template)
                    outs.append(getattr(templates, fn)(sources, FakeTokenizer(prepend_bos=bos), has_image=has_image,
                                                       strict=False))
                    templates.set_default_template("v1")
                _ids_labels_equal(outs[1], outs[0], fn)
                assert (outs[0]["labels"][0] != -100).any()


# ---------------------------------------------------------------------------
# preprocess
# ---------------------------------------------------------------------------


def _rle_string(counts):
    """COCO's compressed RLE string of run lengths (maskApi.c rleToString)."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            out.append(chr((c | 0x20 if more else c) + 48))
    return "".join(out)


def test_rle_round_trips_equal():
    rng = np.random.default_rng(0)
    for h, w in ((7, 5), (32, 48)):
        for first in (0, 1):
            mask = (rng.random((h, w)) > 0.6).astype(np.uint8)
            mask[0, 0] = first
            rle = tpre.rle_encode(mask)
            assert rle == jpre.rle_encode(mask)
            for counts in (rle["counts"], _rle_string(rle["counts"])):
                want = jpre.rle_decode({"size": [h, w], "counts": counts})
                _same(tpre.rle_decode({"size": [h, w], "counts": counts}), want)
                _same(want, mask)


def _photo(rng, h, w):
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


@pytest.mark.parametrize("aspect", ["resize", "pad"])
def test_process_image_depth_masks_equal(aspect):
    rng = np.random.default_rng(1)
    jp, tp = jpre.SiglipProcessor(size=56), tpre.SiglipProcessor(size=56)
    for hw in ((40, 64), (64, 40)):
        image = _photo(rng, *hw)
        want, info = jpre.process_image(image, jp, aspect, return_info=True)
        got, tinfo = tpre.process_image(image, tp, aspect, return_info=True)
        _same(got, want)
        assert tinfo == info
        depth = Image.fromarray(rng.integers(0, 2**16, hw, dtype=np.uint16))
        _same(tpre.process_depth(depth, tp, aspect), jpre.process_depth(depth, jp, aspect))
        masks = [(rng.random(hw) > 0.5).astype(np.uint8) for _ in range(3)]
        _same(tpre.process_masks(masks, tp, aspect), jpre.process_masks(masks, jp, aspect))
    # float arrays through the PIL-exact bicubic, uint8 through its fixed-point path
    for arr in (rng.standard_normal((30, 45, 3)).astype(np.float32), rng.integers(0, 256, (30, 45, 3), dtype=np.uint8)):
        _same(tp(arr), jp(arr))


def test_masks_from_annotations_and_slots_equal():
    rng = np.random.default_rng(2)
    mask = (rng.random((20, 30)) > 0.5).astype(np.uint8)
    source = {
        "rle": [jpre.rle_encode(mask), {"size": [20, 30], "counts": _rle_string(jpre.rle_encode(1 - mask)["counts"])}],
        "segmentation": [[[2.0, 3.0, 20.0, 4.0, 12.0, 15.0]], [[0.0, 0.0, 9.0, 0.0, 9.0, 9.0, 0.0, 9.0]]],
        "bbox": [[1, 2, 10, 12], [-5, 3, 50, 8]],
        "image_info": {"height": 20, "width": 30},
    }
    for modality in ("rle", "segmentation", "bbox"):
        want = jpre.masks_from_annotations(source, modality=modality)
        got = tpre.masks_from_annotations(source, modality=modality)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            _same(a, b, modality)
    # the modality drawn from a seeded generator
    picks = [len(tpre.masks_from_annotations(source, rng=np.random.default_rng(s))) for s in range(4)]
    assert picks == [len(jpre.masks_from_annotations(source, rng=np.random.default_rng(s))) for s in range(4)]
    masks = jpre.process_masks(want, jpre.SiglipProcessor(size=20))
    for slots in (1, 4):
        for a, b in zip(tpre.pad_masks_to_slots(masks, slots, 20), jpre.pad_masks_to_slots(masks, slots, 20)):
            _same(a, b)
    for a, b in zip(tpre.pad_masks_to_slots(None, 3, 8), jpre.pad_masks_to_slots(None, 3, 8)):
        _same(a, b)


# ---------------------------------------------------------------------------
# sampler, prefetcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("replicas", [1, 2])
def test_sampler_streams_equal(replicas):
    for lens, bs in (([100, 40], 2), ([32], 4), ([17, 9, 64], 3)):
        for rank in range(replicas):
            j = jsampler.DistributedMixtureSampler(lens, num_replicas=replicas, rank=rank, batch_size=bs, seed=5)
            t = tsampler.DistributedMixtureSampler(lens, num_replicas=replicas, rank=rank, batch_size=bs, seed=5)
            assert len(t) == len(j)
            for epoch in (0, 1):
                j.set_epoch(epoch)
                t.set_epoch(epoch)
                stream = list(t)
                assert stream == list(j) and len(stream) == len(j)


def test_prefetcher_order_and_errors():
    """tests/test_dataset_collator.py's prefetcher test on both packages."""
    for mod in (jprefetch, tprefetch):
        assert list(mod.Prefetcher(iter(range(17)), depth=3)) == list(range(17))
        assert list(mod.Prefetcher(range(5), depth=2, transfer=lambda x: x * 10)) == [0, 10, 20, 30, 40]

        def boom():
            yield 1
            yield 2
            raise RuntimeError("producer failed")

        it = mod.Prefetcher(boom(), depth=2)
        assert next(it) == 1 and next(it) == 2
        with pytest.raises(RuntimeError, match="producer failed"):
            next(it)
        p = mod.Prefetcher(range(1000), depth=1)  # close() unblocks a full queue
        assert next(p) == 0
        p.close()
        assert not p._thread.is_alive()


# ---------------------------------------------------------------------------
# interleaved, video
# ---------------------------------------------------------------------------


def _img_dir(tmp_path, names, rng):
    d = tmp_path / "imgs"
    d.mkdir(exist_ok=True)
    for n in names:
        _photo(rng, 40, 52).save(d / n)
    return str(d)


def test_interleaved_samples_equal(tmp_path):
    rng = np.random.default_rng(3)
    folder = _img_dir(tmp_path, ["a.png", "b.png", "c.png", "d.png"], rng)
    files = {
        "mmc4": {"text_list": ["first sentence.", "second sentence.", "third."],
                 "image_info": [{"matched_text_index": 0, "image_name": "a.png"},
                                {"matched_text_index": 2, "image_name": "b.png"}]},
        "coyo": {"image": "c.png", "text": "a red car"},
        "vflan": {"image": ["d.png", "a.png"], "question": "what color?", "answer": "red"},
    }
    for name, entry in files.items():
        (tmp_path / f"{name}.jsonl").write_text(json.dumps(entry) + "\n")
    for cls in ("MMC4Dataset", "CoyoDataset", "VFlanDataset"):
        path = str(tmp_path / f"{cls[:-7].lower()}.jsonl")
        for bos in (True, False):
            want = getattr(jinter, cls)(path, FakeTokenizer(bos), jpre.SiglipProcessor(size=56), folder)[0]
            got = getattr(tinter, cls)(path, FakeTokenizer(bos), tpre.SiglipProcessor(size=56), folder)[0]
            _same_sample(got, want)


def test_video_frames_equal(tmp_path):
    import cv2

    path = str(tmp_path / "v.avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 5, (32, 32))
    rng = np.random.default_rng(4)
    for _ in range(10):
        w.write(rng.integers(0, 255, (32, 32, 3), np.uint8))
    w.release()
    for p in (path, str(tmp_path / "missing.mp4")):
        frames, total = tvideo.extract_frames(p, num_frames=4, size=(16, 16))
        want, want_total = jvideo.extract_frames(p, num_frames=4, size=(16, 16))
        assert total == want_total and len(frames) == len(want) == 4
        for a, b in zip(frames, want):
            _same(a, b)


# ---------------------------------------------------------------------------
# datasets, collator, to the device
# ---------------------------------------------------------------------------


def _spatial_files(tmp_path, rng, n=3):
    """OpenSpatialDataset-format json with PNG images, 16-bit depth PNGs
    (one image without its depth: the fake-depth fallback) and RLE masks."""
    img_dir, depth_dir = tmp_path / "images", tmp_path / "depths"
    img_dir.mkdir()
    depth_dir.mkdir()
    entries = []
    for i in range(n):
        h, w = 36 + 4 * i, 50
        _photo(rng, h, w).save(img_dir / f"im{i}.png")
        if i != 1:
            Image.fromarray(rng.integers(0, 2**16, (h, w), dtype=np.uint16)).save(depth_dir / f"im{i}.png")
        masks = [(rng.random((h, w)) > 0.5).astype(np.uint8) for _ in range(2)]
        entries.append({
            "image": f"im{i}.png",
            "rle": [jpre.rle_encode(m) for m in masks],
            "conversations": [{"from": "human", "value": "Is <mask> behind <mask>?"},
                              {"from": "gpt", "value": f"Yes, {i + 1} meters behind."}],
        })
    path = tmp_path / "osd.json"
    path.write_text(json.dumps(entries))
    return str(path), str(img_dir), str(depth_dir)


def _collator(mod, **kw):
    return mod.Collator(mod.CollatorConfig(max_len=1024, tokens_per_image=4, mask_token_id=1009, depth_token_id=1010,
                                           regions_per_image=2, image_size=56, **kw))


def _collated_equal(got, want):
    _same(got[0].input_ids, want[0].input_ids)
    for f in dataclasses.fields(want[0]):
        _same(getattr(got[0], f.name), getattr(want[0], f.name), f.name)
    for a, b, name in zip(got[1:], want[1:], ("images", "depths", "masks", "mask_valid")):
        _same(a, b, name)


def test_spatial_dataset_samples_batch_and_inputs_equal(tmp_path):
    from spatialrgpt_tpu.data.dataset import to_vlm_inputs

    path, img_dir, depth_dir = _spatial_files(tmp_path, np.random.default_rng(5))
    kw = dict(image_folder=img_dir, depth_folder=depth_dir, conv_template="llama_3", seed=7)
    jd = jds.SpatialDataset(path, FakeTokenizer(False), jpre.SiglipProcessor(size=56), **kw)
    td = tds.SpatialDataset(path, FakeTokenizer(False), tpre.SiglipProcessor(size=56), **kw)
    want, got = [jd[i] for i in range(3)], [td[i] for i in range(3)]
    for a, b in zip(got, want):
        _same_sample(a, b)
    for pack in (True, False):
        jb, tb = _collator(jds, pack=pack)(want), _collator(tds, pack=pack)(got)
        _collated_equal(tb, jb)
        if pack:
            assert (tb[0].segment_ids.max(axis=1) >= 2).any()  # packing put samples together
            assert tb[0].is_mask.sum() == tb[0].is_depth.sum() == 6
    jin = to_vlm_inputs(*jb)
    tin = VLMInputs.from_spliced(*tb, device="cpu")
    for name in VLMInputs._fields:
        a, b = getattr(tin, name), getattr(jin, name)
        assert (a is None) == (b is None), name
        if b is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert tin.segment_ids.dtype == torch.int32 and tin.images.dtype == torch.float32
    assert tin.input_ids.dtype == tin.image_gather_idx.dtype == tin.mask_slot.dtype == torch.int64
    assert tin.is_image.dtype == tin.mask_valid.dtype == torch.bool


def test_supervised_preference_dummy_and_mixture_equal(tmp_path):
    rng = np.random.default_rng(6)
    folder = _img_dir(tmp_path, ["p.png"], rng)
    conv = [{"from": "human", "value": "Where is the lamp?"}, {"from": "gpt", "value": "Behind the couch."}]
    (tmp_path / "sft.jsonl").write_text(json.dumps({"conversations": conv, "image": "p.png"}) + "\n"
                                        + json.dumps({"conversations": conv}) + "\n")
    (tmp_path / "pairs.json").write_text(json.dumps([
        {"prompt": "Which is taller?", "chosen": "the lamp", "rejected": "the chair", "image": "p.png"},
        {"conversations": conv, "chosen": "yes", "rejected": "no"}]))
    for cls, name in (("SupervisedDataset", "sft.jsonl"), ("PreferenceDataset", "pairs.json")):
        j = getattr(jds, cls)(str(tmp_path / name), FakeTokenizer(False), jpre.SiglipProcessor(size=56), folder)
        t = getattr(tds, cls)(str(tmp_path / name), FakeTokenizer(False), tpre.SiglipProcessor(size=56), folder)
        for i in range(2):
            got, want = (t[i], j[i]) if cls == "PreferenceDataset" else ((t[i],), (j[i],))
            for a, b in zip(got, want, strict=True):  # a pair's chosen and rejected samples
                _same_sample(a, b)
    # the dummy mixture, twice: each part draws its pixels from its own generator
    j = jds.build_datasets("dummy+dummy", FakeTokenizer(False), None)
    t = tds.build_datasets("dummy+dummy", FakeTokenizer(False), None)
    assert len(t) == len(j) == 64 and len(t.parts) == 2
    batch = [0, 33, 5, 63]
    want, got = [j[i] for i in batch], [t[i] for i in batch]
    for a, b in zip(got, want):
        _same_sample(a, b)
    kw = dict(max_len=1024, mask_token_id=1009, depth_token_id=1010, regions_per_image=8, image_size=384)
    _collated_equal(tds.Collator(tds.CollatorConfig(**kw))(got), jds.Collator(jds.CollatorConfig(**kw))(want))


# ---------------------------------------------------------------------------
# train/args.py on the launch scripts
# ---------------------------------------------------------------------------


LAUNCHERS = sorted(f"{model}/{stage}" for model in ("sheared_3b", "llama2_7b", "llama3_8b")
                   for stage in ("1_mm_align.sh", "2_pretrain.sh", "3_sft.sh"))


def _launcher_argv(tmp_path, script):
    """The argv a launch script hands to ``python -m ...train.train``, as bash
    expands it: a stand-in ``python`` on the PATH prints its arguments."""
    fake = tmp_path / "bin"
    fake.mkdir(exist_ok=True)
    (fake / "python").write_text("#!/bin/sh\nprintf '%s\\0' \"$@\"\n")
    (fake / "python").chmod(0o755)
    env = {"PATH": f"{fake}:{os.environ['PATH']}", "HOME": str(tmp_path)}
    out = subprocess.run(["bash", os.path.join(ROOT, "scripts", "srgpt", script)], env=env, capture_output=True,
                         check=True, timeout=60).stdout.decode()
    argv = out.split("\0")[:-1]
    assert argv[:2] == ["-m", "spatialrgpt_tpu.train.train"], argv
    return argv[2:]


@pytest.mark.parametrize("script", LAUNCHERS)
def test_parse_args_on_launch_scripts_equal(tmp_path, script):
    argv = _launcher_argv(tmp_path, script)
    assert len(argv) > 30
    want, got = jargs.parse_args(argv), targs.parse_args(argv)
    for a, b in zip(got, want):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert type(a).__name__ == type(b).__name__
    assert dataclasses.asdict(targs.parse_args([])[2]) == dataclasses.asdict(jargs.parse_args([])[2])
