"""Port parity for the tower and debugging utils: ``utils/delta.py`` on the
port's state dicts against the reference's pytree tools, ``utils/timing.py``
and ``utils/profiling.py`` on the CPU (CUDA events and the card's memory
report need a card), the copied ``utils/native.py`` (the same native
library) and ``utils/visualize_features.py`` against their originals.
"""

import os

import jax
import numpy as np
import pytest
import torch

from spatialrgpt_tpu.data.preprocess import rle_encode
from spatialrgpt_tpu.utils import delta as jdelta
from spatialrgpt_tpu.utils import native as jnative
from spatialrgpt_tpu.utils import visualize_features as jvis
from spatialrgpt_tpu_torch.utils import delta as tdelta
from spatialrgpt_tpu_torch.utils import native as tnative
from spatialrgpt_tpu_torch.utils import profiling, timing
from spatialrgpt_tpu_torch.utils import visualize_features as tvis
from spatialrgpt_tpu_torch.utils.checkpoint import load_state_dict
from spatialrgpt_tpu_torch.utils.weights import init_random
from test_torch_models import TINY_T


def _pair(rng, vocab):
    """A pytree for the reference, the same tensors as a state dict."""
    tree = {"embed_tokens": rng.standard_normal((vocab, 4)).astype(np.float32),
            "layers": [{"w": rng.standard_normal((3, 4)).astype(np.float32)}],
            "norm": rng.standard_normal(4).astype(np.float32)}
    sd = {"model.embed_tokens.weight": tree["embed_tokens"], "model.layers.0.w": tree["layers"][0]["w"],
          "model.norm.weight": tree["norm"]}
    return tree, {k: torch.tensor(v) for k, v in sd.items()}


def _as_list(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("base_vocab,target_vocab", [(10, 10), (10, 12)])
def test_make_and_apply_delta_equal_reference(base_vocab, target_vocab):
    """delta = target - base and target = base + delta on state dicts, with
    the vocabulary grown by 2 rows (the smaller table padded with zero rows
    along dim 0): the reference's values, and the round trip gives the
    target back."""
    rng = np.random.default_rng(base_vocab + target_vocab)
    jbase, tbase = _pair(rng, base_vocab)
    jtarget, ttarget = _pair(rng, target_vocab)
    jd, td = jdelta.make_delta(jbase, jtarget), tdelta.make_delta(tbase, ttarget)
    assert list(td) == list(tbase)
    for got, want in zip([td[k] for k in sorted(td)], _as_list(jd)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert td["model.embed_tokens.weight"].shape[0] == target_vocab
    back = tdelta.apply_delta(tbase, td)
    for got, want in zip([back[k] for k in sorted(back)], _as_list(jdelta.apply_delta(jbase, jd))):
        np.testing.assert_array_equal(got.numpy(), want)
    for k in ttarget:
        torch.testing.assert_close(back[k], ttarget[k], rtol=0, atol=1e-6)
    with pytest.raises(AssertionError):
        tdelta.make_delta(tbase, {k: v for k, v in ttarget.items() if "norm" not in k})


@pytest.mark.parametrize("with_base", [True, False])
def test_consolidate_writes_the_composite(tmp_path, with_base):
    """A trainer checkpoint's ``state.pt`` -> the split composite directory:
    with the model it trained as the base (the checkpoint holds only what
    was trained), or on its own when it holds every parameter."""
    model = init_random(TINY_T, "cpu", torch.float32, seed=4)
    ckpt = tmp_path / "checkpoint-2"
    ckpt.mkdir()
    if with_base:
        trained = {k: v + 1 for k, v in model.mm_projector.state_dict(prefix="mm_projector.").items()}
    else:
        trained = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save(trained, ckpt / "state.pt")
    base = init_random(TINY_T, "cpu", torch.float32, seed=4) if with_base else None
    tdelta.consolidate(str(ckpt), str(tmp_path / "out"), TINY_T, base)
    assert sorted(os.listdir(tmp_path / "out")) == ["config.json", "llm", "mm_projector", "region_extractor",
                                                   "vision_tower"]
    proj = load_state_dict(str(tmp_path / "out" / "mm_projector"))
    for k, v in proj.items():
        torch.testing.assert_close(v, trained["mm_projector." + k], rtol=0, atol=0)
    llm = load_state_dict(str(tmp_path / "out" / "llm"))
    torch.testing.assert_close(llm["model.norm.weight"], model.llm.model.norm.weight, rtol=0, atol=0)


def test_time_fn_and_device_sync_on_the_cpu():
    """On CPU tensors ``time_fn`` times with the host's clock (seconds per
    call, a slower function reads longer) and ``device_sync`` waits for
    nothing."""
    x = torch.ones(64, 64)
    fast = timing.time_fn(lambda a: a + 1, x, iters=5)
    slow = timing.time_fn(lambda a: [a @ a for _ in range(40)][-1], x, iters=5)
    assert 0 < fast < slow
    timing.device_sync({"out": [x]})
    timing.device_sync(None)


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    """``trace`` writes the enclosed block as a Chrome trace, and a range
    named by ``annotate`` is in it."""
    with profiling.trace(str(tmp_path / "tr")) as d:
        with profiling.annotate("tower_forward"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    path = os.path.join(d, "trace.json")
    assert os.path.exists(path) and "tower_forward" in open(path).read()


def test_profiling_prints_and_memory_report(capsys):
    """``mprint`` / ``rprint`` from rank 0 (the only rank), and
    ``device_memory_report``, which raises without a card rather than
    report zeros."""
    profiling.mprint("hello")
    profiling.rprint("there")
    out = capsys.readouterr().out.splitlines()
    assert out == ["hello", "[rank 0] there"]
    if torch.cuda.is_available():
        rep = profiling.device_memory_report()
        assert rep["cuda:0"]["bytes_limit"] > 0
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            profiling.device_memory_report()


def test_native_copy_gives_the_originals_answers():
    """The copied bindings load the same ``native/dataops.cpp`` library and
    give the reference bindings' answers: RLE (string and counts), both
    resizes and the greedy packing."""
    assert tnative.available() == jnative.available()
    rng = np.random.default_rng(20)
    mask = (rng.random((41, 57)) > 0.6).astype(np.uint8)
    rle = rle_encode(mask)
    np.testing.assert_array_equal(tnative.rle_decode(rle), jnative.rle_decode(rle))
    np.testing.assert_array_equal(tnative.rle_decode(rle), mask)
    np.testing.assert_array_equal(tnative.resize_nearest(mask, 96, 70), jnative.resize_nearest(mask, 96, 70))
    x = rng.standard_normal((24, 36)).astype(np.float32)
    np.testing.assert_array_equal(tnative.resize_bilinear(x, 50, 70), jnative.resize_bilinear(x, 50, 70))
    lengths = rng.integers(10, 100, 40)
    np.testing.assert_array_equal(tnative.pack_greedy(lengths, 128), jnative.pack_greedy(lengths, 128))


@pytest.mark.parametrize("batched", [False, True])
def test_visualize_features_copy(batched):
    """The PCA feature map (per image, or a batch on one basis) equals the
    original's, on a tower's features taken off the tensor."""
    feats = torch.randn((2, 16, 24) if batched else (16, 24), generator=torch.Generator().manual_seed(21))
    arr = feats.float().cpu().numpy()
    got, want = tvis.feature_map_rgb(arr), jvis.feature_map_rgb(arr)
    assert got.dtype == np.uint8 and got.shape == ((2, 4, 4, 3) if batched else (4, 4, 3))
    np.testing.assert_array_equal(got, want)
