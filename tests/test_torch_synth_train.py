"""Port parity for ``synth/train_calibration.py``: the virtual-camera warp
and the warp / RGBD batch streams bit-equal to the reference's from the same
seed, ``silog_loss`` and ``canonicalize_depth``, both trainers' loss
histories from the same weights and batches against the JAX trainers (with
``freeze_backbone``'s weight decay on the stopped parameters), the npz
checkpoints both ways, and the CLI; the cases of the reference's
``tests/test_synth_train.py`` on the port.

fp32 on the CPU.  Tolerances: the streams exactly; the loss 1e-6 relative
on the same inputs; loss histories 1e-5 relative over 5 AdamW updates and
the trained weights 1e-4 of their largest value (fp32 summation order
through the backward, which Adam's normalisation carries into every
update); the frozen backbone's decay 1e-6 relative."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from spatialrgpt_tpu.models import depth_anything as jda
from spatialrgpt_tpu.synth import calibration as jcalib
from spatialrgpt_tpu.synth import train_calibration as jtc
from spatialrgpt_tpu_torch.models import depth_anything as tda
from spatialrgpt_tpu_torch.synth import calibration as tcalib
from spatialrgpt_tpu_torch.synth import train_calibration as ttc
from spatialrgpt_tpu_torch.utils.weights import (camera_net_tree, depth_anything_tree, load_camera_net_from_jax,
                                                 load_depth_anything_from_jax)

LOSS_REL = 1e-6
HISTORY_REL = 1e-5
WEIGHT_REL = 1e-4


def _scene_image(size=96, seed=0):
    """The reference test's upright scene: bright sky over dark ground (a
    horizon) and vertical posts (a roll cue)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((size, size, 3), np.float32)
    img[: size // 2] = [200, 220, 255]
    img[size // 2 :] = [60, 50, 40]
    for x in range(0, size, 12):
        img[:, x : x + 3] = [rng.uniform(100, 255)] * 3
    return img


def _cam_cfg(c):
    return c.CameraNetConfig(image_size=48, patch_size=8, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                             intermediate_size=128)


def _da_cfg(c):
    return c.DepthAnythingConfig(image_size=42, patch_size=14, hidden_size=48, num_hidden_layers=4,
                                 num_attention_heads=2, intermediate_size=96, out_indices=(1, 2, 3, 4),
                                 neck_hidden_sizes=(8, 12, 16, 20), reassemble_factors=(4, 2, 1, 0.5),
                                 fusion_hidden_size=16, head_hidden_size=8, metric=True, max_depth=20.0)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close_tree(got_tree, want_tree, rel):
    got, want = jax.tree.leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(np.asarray(a), b, rtol=rel, atol=rel * max(float(np.abs(b).max()), 1e-12))


# ---------------------------------------------------------------------------
# the data paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("roll,pitch,src,dst,size", [(0.0, 0.0, 60.0, 60.0, 64), (90.0, 0.0, 60.0, 60.0, 64),
                                                     (-17.5, 22.0, 70.0, 41.0, 48), (3.0, -29.0, 70.0, 25.0, 80)])
def test_warp_virtual_camera_bit_equal(roll, pitch, src, dst, size):
    img = _scene_image(64, seed=1)
    np.testing.assert_array_equal(ttc.warp_virtual_camera(img, roll, pitch, src, dst, size),
                                  jtc.warp_virtual_camera(img, roll, pitch, src, dst, size))


def test_warp_behaves_as_the_reference_tests_say():
    """The reference's three warp tests on the port: identity at roll =
    pitch = 0 and equal vfovs, a 90-degree roll swaps row and column
    variation, a narrower vfov zooms in."""
    img = _scene_image(64)
    assert np.allclose(ttc.warp_virtual_camera(img, 0.0, 0.0, 60.0, 60.0, 64), img, atol=2.0)
    out = ttc.warp_virtual_camera(img, 90.0, 0.0, 60.0, 60.0, 64)
    assert np.var(img.mean(axis=(1, 2))) > 1000
    assert np.var(out.mean(axis=(0, 2))) > np.var(out.mean(axis=(1, 2)))
    band = np.zeros((128, 128, 3), np.float32)
    band[60:68] = 255.0
    wide = ttc.warp_virtual_camera(band, 0.0, 0.0, 60.0, 55.0, 128)
    tight = ttc.warp_virtual_camera(band, 0.0, 0.0, 60.0, 25.0, 128)
    assert (tight.mean(axis=(1, 2)) > 100).sum() > 1.5 * (wide.mean(axis=(1, 2)) > 100).sum()


def test_warp_batches_bit_equal():
    """Three batches of the endless stream from one seed, with a non-square
    uint8-range image among square ones."""
    images = [_scene_image(96, seed=s) for s in range(3)] + [_scene_image(96, seed=4)[:80]]
    ours, theirs = ttc.warp_batches(images, _cam_cfg(tcalib), 5, seed=3), jtc.warp_batches(images, _cam_cfg(jcalib), 5,
                                                                                          seed=3)
    for _ in range(3):
        for a, b in zip(next(ours), next(theirs)):
            np.testing.assert_array_equal(a, b)


def _rgbd_manifest(tmp_path, n=3):
    """n PNGs of 30 x 44 and 50 x 36 with .npy depths (meters, a hole of
    zeros each) and focal lengths, as a JSONL manifest."""
    rng = np.random.default_rng(11)
    rows = []
    for i in range(n):
        h, w = (30, 44) if i % 2 == 0 else (50, 36)
        img, dep = tmp_path / f"im{i}.png", tmp_path / f"d{i}.npy"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(img)
        d = rng.uniform(0.5, 15.0, (h, w)).astype(np.float32)
        d[: h // 4, : w // 4] = 0.0
        np.save(dep, d)
        rows.append({"image": str(img), "depth": str(dep), "fx": 300.0 + 50 * i})
    path = tmp_path / "manifest.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(path)


def test_rgbd_batches_bit_equal(tmp_path):
    manifest = _rgbd_manifest(tmp_path)
    ours = ttc.rgbd_batches(manifest, _da_cfg(tda), 3, seed=2)
    theirs = jtc.rgbd_batches(manifest, _da_cfg(jda), 3, seed=2)
    for _ in range(2):
        for a, b in zip(next(ours), next(theirs)):
            np.testing.assert_array_equal(a, b)
    (tmp_path / "empty.jsonl").write_text("\n")
    with pytest.raises(ValueError, match="empty manifest"):
        next(ttc.rgbd_batches(str(tmp_path / "empty.jsonl"), _da_cfg(tda), 1))


def test_silog_loss_and_canonicalize_depth_match_jax():
    """SiLog over the valid pixels (a third of them invalid, predictions
    below the 1e-6 floor among them) and lambda 0.5 and 0.15; the canonical
    depth and its inverse, the serving wrapper's de-canonicalization."""
    rng = np.random.default_rng(0)
    pred = rng.uniform(0.0, 10.0, (2, 9, 11)).astype(np.float32)
    pred[0, 0, :3] = 0.0
    tgt = rng.uniform(0.5, 10.0, (2, 9, 11)).astype(np.float32)
    valid = (rng.random((2, 9, 11)) > 0.33).astype(np.float32)
    for lam in (0.5, 0.15):
        want = float(jtc.silog_loss(jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(valid), lam))
        got = float(ttc.silog_loss(torch.tensor(pred), torch.tensor(tgt), torch.tensor(valid), lam))
        assert got == pytest.approx(want, rel=LOSS_REL)
    depth = rng.uniform(0.5, 20.0, (37, 53)).astype(np.float32)
    canon = ttc.canonicalize_depth(depth, 480.0, 64, 1000.0)
    np.testing.assert_array_equal(canon, jtc.canonicalize_depth(depth, 480.0, 64, 1000.0))
    np.testing.assert_allclose(canon * (480.0 * 64 / 53) / 1000.0, depth, rtol=1e-6)


# ---------------------------------------------------------------------------
# the trainers against the JAX trainers
# ---------------------------------------------------------------------------


def _close_trained(got_tree, want_tree, kw):
    """Trained weights within WEIGHT_REL, except the attention key biases:
    softmax over keys ignores a bias shared by every key, so their exact
    gradient is 0 and each package moves them by Adam-normalised rounding
    noise, at most lr per step."""
    flat_got = jax.tree_util.tree_flatten_with_path(got_tree)[0]
    flat_want = jax.tree.leaves(want_tree)
    assert len(flat_got) == len(flat_want)
    for (path, a), b in zip(flat_got, flat_want):
        key = jax.tree_util.keystr(path)
        if "['wk']['bias']" in key:
            assert np.abs(np.asarray(a) - np.asarray(b)).max() <= 2 * kw["lr"] * kw["steps"], key
        else:
            _close_tree(a, b, WEIGHT_REL)


def test_train_camera_net_matches_jax():
    """Five AdamW steps (2 of warmup, the cosine after) of CameraNet on the
    warp stream from the same weights and seed: the loss histories and the
    trained weights equal the reference's."""
    images = [_scene_image(96, seed=s) for s in range(3)]
    jparams = jcalib.init_params(jax.random.PRNGKey(0), _cam_cfg(jcalib))
    kw = dict(steps=5, batch_size=4, lr=1e-3, warmup=2, seed=0, log_every=1)
    jtrained, jhist = jtc.train_camera_net(images, _cam_cfg(jcalib), params=jparams, **kw)
    model = load_camera_net_from_jax(_np_tree(jparams), _cam_cfg(tcalib), "cpu")
    trained, hist = ttc.train_camera_net(images, _cam_cfg(tcalib), model=model, device="cpu", **kw)
    assert trained is model and len(hist) == len(jhist) == 5
    np.testing.assert_allclose(hist, jhist, rtol=HISTORY_REL)
    _close_trained(camera_net_tree(trained), _np_tree(jtrained), kw)


@pytest.mark.parametrize("freeze", [False, True], ids=["all", "freeze_backbone"])
def test_train_metric_depth_matches_jax(freeze):
    """Five AdamW steps of the tiny metric Depth-Anything on one stream of
    synthetic (pixels, canonical target, valid) batches from the same
    weights: the loss histories and the trained weights equal the
    reference's.  With ``freeze_backbone`` only the DPT head learns, and
    the stopped backbone and neck still decay: each weight is its start
    times prod(1 - lr_t wd), as optax's decoupled decay leaves it."""
    cfg_j, cfg_t = _da_cfg(jda), _da_cfg(tda)
    jparams = jda.init_params(jax.random.PRNGKey(1), cfg_j)
    jparams["head"]["conv3"]["kernel"] = jax.random.normal(jax.random.PRNGKey(2), jparams["head"]["conv3"]["kernel"].shape) * 0.1

    def batches():
        rng = np.random.default_rng(1)
        while True:
            px = rng.standard_normal((2, 42, 42, 3)).astype(np.float32)
            tg = (5.0 + 2.0 * np.abs(px.mean(axis=3))).astype(np.float32)
            va = (rng.random((2, 42, 42)) > 0.1).astype(np.float32)
            yield px, tg, va

    kw = dict(steps=5, lr=3e-4, warmup=2, log_every=1, weight_decay=0.05, freeze_backbone=freeze)
    jtrained, jhist = jtc.train_metric_depth(batches(), cfg_j, params=jparams, **kw)
    model = load_depth_anything_from_jax(_np_tree(jparams), cfg_t, "cpu")
    _, hist = ttc.train_metric_depth(batches(), cfg_t, model=model, device="cpu", **kw)
    np.testing.assert_allclose(hist, jhist, rtol=HISTORY_REL)
    got = depth_anything_tree(model, cfg_t)
    _close_trained(got, _np_tree(jtrained), kw)
    if freeze:
        lrs = [3e-4 * c / 2 for c in range(2)] + [3e-4 * 0.5 * (1 + np.cos(np.pi * t / 3)) for t in range(3)]
        shrink = np.prod([1 - lr * 0.05 for lr in lrs])
        start = _np_tree(jparams)
        for key in ("layers", "reassemble", "fusion"):
            _close_tree(got[key], jax.tree.map(lambda a: a * shrink, start[key]), LOSS_REL)
        assert not np.array_equal(got["layers"][0]["mlp"]["fc1"]["kernel"], start["layers"][0]["mlp"]["fc1"]["kernel"])


# ---------------------------------------------------------------------------
# checkpoints and the CLI
# ---------------------------------------------------------------------------


def test_npz_checkpoints_carry_across(tmp_path):
    """``save_params`` writes the reference's flat keys: the port reloads its
    own file exactly, the reference's ``load_params`` reads it into its tree,
    and the port reads the reference's npz into its modules (CameraNet and
    the metric Depth-Anything)."""
    cam_j = jcalib.init_params(jax.random.PRNGKey(0), _cam_cfg(jcalib))
    da_j = jda.init_params(jax.random.PRNGKey(1), _da_cfg(jda))
    for jparams, load, cfg_t in ((cam_j, load_camera_net_from_jax, _cam_cfg(tcalib)),
                                 (da_j, load_depth_anything_from_jax, _da_cfg(tda))):
        want = load(_np_tree(jparams), cfg_t, "cpu")
        ref_path, our_path = str(tmp_path / "ref.npz"), str(tmp_path / "ours.npz")
        jtc.save_params(jparams, ref_path)
        ttc.save_params(want, our_path)
        assert sorted(np.load(ref_path).files) == sorted(np.load(our_path).files)
        _close_tree(jtc.load_params(our_path, jparams), jparams, 0.0)
        fresh = load(_np_tree(jax.tree.map(jnp.zeros_like, jparams)), cfg_t, "cpu")
        for path in (ref_path, our_path):
            got = ttc.load_params(path, fresh)
            assert got is fresh
            for (name, a), b in zip(fresh.state_dict().items(), want.state_dict().values()):
                assert torch.equal(a, b), name


def test_camera_cli_on_an_image_folder(tmp_path, monkeypatch):
    """``python -m spatialrgpt_tpu_torch.synth.train_calibration --device cpu
    camera DIR``: CameraNet's default widths fit for two steps on a folder
    of photos and the npz lands where ``--out`` says; without ``--device``
    and a card it raises."""
    for i in range(2):
        Image.fromarray(_scene_image(120, seed=i).astype(np.uint8)).save(tmp_path / f"p{i}.jpg")
    out = tmp_path / "cam.npz"
    hist = ttc.main(["--device", "cpu", "camera", str(tmp_path), "--steps", "2", "--batch", "2", "--out", str(out)])
    assert len(hist) == 2 and all(np.isfinite(hist))
    assert "layers/5/mlp/fc2/kernel" in np.load(out).files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="train_calibration"):
        ttc.main(["camera", str(tmp_path)])
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no images"):
        ttc.main(["--device", "cpu", "camera", str(tmp_path / "empty")])
