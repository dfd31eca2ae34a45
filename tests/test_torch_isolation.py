"""The port stands alone: no module of ``spatialrgpt_tpu_torch`` (nor
``chip_smoke.py`` or ``tests/test_torch_gpu.py``) imports ``jax`` or the JAX
package, and the port's copies of the JAX package's framework-free
modules (``config``, ``constants``, ``conversation``, ``data/splice``,
``demo/engine``, the ``utils/export`` name maps, Pillow's bicubic
coefficients) give what the originals give.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from spatialrgpt_tpu import config as jconfig
from spatialrgpt_tpu import conversation as jconv
from spatialrgpt_tpu.data import preprocess as jpre
from spatialrgpt_tpu.data import splice as jsplice
from spatialrgpt_tpu.demo import engine as jengine
from spatialrgpt_tpu.models import vlm as jvlm
from spatialrgpt_tpu.utils import export as jexport
from spatialrgpt_tpu_torch import config as tconfig
from spatialrgpt_tpu_torch import conversation as tconv
from spatialrgpt_tpu_torch.data import device_preprocess as tdp
from spatialrgpt_tpu_torch.data import splice as tsplice
from spatialrgpt_tpu_torch.demo import engine as tengine
from spatialrgpt_tpu_torch.utils import export as texport

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a child interpreter in which ``import jax`` and ``import spatialrgpt_tpu``
# raise ImportError (a None entry in sys.modules blocks the import), then
# every module of the port, chip_smoke.py and the gpu test file
_ISOLATED = r"""
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None
sys.modules["spatialrgpt_tpu"] = None
sys.path.insert(0, ROOT)
import spatialrgpt_tpu_torch
names = ["spatialrgpt_tpu_torch"] + [m.name for m in pkgutil.walk_packages(spatialrgpt_tpu_torch.__path__, "spatialrgpt_tpu_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
spec = importlib.util.spec_from_file_location("test_torch_gpu", ROOT + "/tests/test_torch_gpu.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "spatialrgpt_tpu.")) or m == "spatialrgpt_tpu")
bad = [m for m in bad if sys.modules[m] is not None]
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", f"ROOT = {ROOT!r}\n" + _ISOLATED],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 30, proc.stdout  # the walk really found the package


@pytest.mark.parametrize("name", sorted(jconfig.LLAMA_PRESETS))
def test_presets_equal(name):
    assert sorted(tconfig.LLAMA_PRESETS) == sorted(jconfig.LLAMA_PRESETS)
    assert dataclasses.asdict(tconfig.preset(name)) == dataclasses.asdict(jconfig.preset(name))
    want = jconfig.preset(name, mask_token_id=7, model_max_length=4096)
    got = tconfig.preset(name, mask_token_id=7, model_max_length=4096)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tconfig.SpatialRGPTConfig.from_json(want.to_json()) == got


def _rows(rng, n, image_tokens=(0, 1, 2)):
    """``n`` prompts of random text with 0-2 ``<image>`` tokens and a
    ``<mask> <depth>`` pair per region."""
    rows, labels = [], []
    for _ in range(n):
        ids = [1]
        for _ in range(int(rng.choice(image_tokens))):
            ids += [jsplice.IMAGE_TOKEN_INDEX, 90, 91, 90, 91]
        ids += list(rng.integers(2, 80, int(rng.integers(3, 12))))
        rows.append(np.asarray(ids, np.int64))
        labels.append(np.where(np.arange(len(ids)) < 3, jsplice.IGNORE_INDEX, np.asarray(ids)).astype(np.int64))
    return rows, labels


def _fields_equal(got, want):
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("with_labels,pad_to", [(False, None), (True, None), (False, 64), (True, 96)])
def test_expand_rows_equal(with_labels, pad_to):
    rows, labels = _rows(np.random.default_rng(11), 5)
    kw = dict(max_len=128, tokens_per_image=4, mask_token_id=90, depth_token_id=91, regions_per_image=2, pad_to=pad_to)
    want = jsplice.expand_rows(rows, labels if with_labels else None, **kw)
    got = tsplice.expand_rows(rows, labels if with_labels else None, **kw)
    _fields_equal(got, want)


def test_pack_rows_equal():
    rows, labels = _rows(np.random.default_rng(12), 6, image_tokens=(1,))
    kw = dict(max_len=64, tokens_per_image=4, mask_token_id=90, depth_token_id=91, regions_per_image=2)
    want = jsplice.pack_rows([jsplice.expand_rows([r], [lab], **kw) for r, lab in zip(rows, labels)], max_len=64)
    got = tsplice.pack_rows([tsplice.expand_rows([r], [lab], **kw) for r, lab in zip(rows, labels)], max_len=64)
    assert got.input_ids.shape[0] < len(rows)  # packing put several samples in a row
    _fields_equal(got, want)


@pytest.mark.parametrize("name", sorted(jconv.conv_templates))
def test_conversation_prompts_equal(name):
    assert sorted(tconv.conv_templates) == sorted(jconv.conv_templates)
    convs = [jconv.conv_templates[name].copy(), tconv.conv_templates[name].copy()]
    for c in convs:
        if c.sep2 is None:  # the plain templates leave the answer's separator to the caller
            c.sep2 = "</s>"
        c.append_message(c.roles[0], "<image>\nHow far apart are <region0> and <region1>?")
        c.append_message(c.roles[1], "About 2 meters.")
    assert convs[1].get_prompt() == convs[0].get_prompt()


def test_demo_engine_helpers_equal():
    text = "Is <region2> left of <region0>? And <region2> vs <region1>?"
    for depth in (True, False):
        assert tengine.rewrite_region_prompt(text, depth) == jengine.rewrite_region_prompt(text, depth)
    assert tengine.remap_region_indices("[0] is left of [1]; [5]", [2, 0]) == \
        jengine.remap_region_indices("[0] is left of [1]; [5]", [2, 0])
    rng = np.random.default_rng(13)
    image = rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)
    masks = [(rng.random((12, 16)) > 0.5).astype(np.uint8) for _ in range(2)]
    np.testing.assert_array_equal(tengine.draw_som_overlay(image, masks), jengine.draw_som_overlay(image, masks))


@pytest.fixture(scope="module")
def tiny_params():
    """The JAX package's parameter pytree of a tiny config, its shapes from
    ``init_params`` (traced, never run) and its values drawn with numpy."""
    cfg = jconfig.SpatialRGPTConfig(
        llm=jconfig.LlamaConfig(vocab_size=32, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                                num_attention_heads=2, num_key_value_heads=1),
        vision=jconfig.SiglipVisionConfig(hidden_size=8, intermediate_size=16, num_hidden_layers=2,
                                          num_attention_heads=2, image_size=28, patch_size=14),
        projector=jconfig.ProjectorConfig(mm_hidden_size=8, hidden_size=16),
        region=jconfig.RegionExtractorConfig(mm_hidden_size=8, hidden_size=16, ada_pool_size=2),
    )
    shapes = jax.eval_shape(lambda: jvlm.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(14)
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("part,fn", [("vision", "export_siglip"), ("projector", "export_projector"),
                                     ("region", "export_region_extractor"), ("llm", "export_llama")])
def test_export_name_maps_equal(tiny_params, part, fn):
    want = getattr(jexport, fn)(tiny_params[part])
    got = getattr(texport, fn)(tiny_params[part])
    assert list(got) == list(want) and len(want) > 3
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("in_size,out_size", [(1024, 384), (37, 384), (640, 518), (7, 7)])
def test_pil_bicubic_coefficients_equal(in_size, out_size):
    assert tdp._PIL_PRECISION_BITS == jpre._PIL_PRECISION_BITS
    (m_t, mi_t), (m_j, mi_j) = tdp._resample_matrix(in_size, out_size), jpre._resample_matrix(in_size, out_size)
    np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_array_equal(mi_t, mi_j)
