"""Port parity for ``utils/weights.py::save_composite_hf``, the writer of the
composite directory the PyTorch reference loads (float32 tensors, each
component's HF config, SigLIP's preprocessor config, the top-level
LlavaConfig, the tokenizer in ``llm/``).

One JAX ``init_params`` tree per decoder family (seed 5, every leaf then
moved by seeded numpy noise, so that no norm scale is 1 and no bias 0) goes
to the JAX package's ``save_composite_hf`` and, through ``load_from_jax``,
to the port's, at the tiny widths of ``tests/test_torch_families.py``
(region pool 27, the size the format implies).  The two directories hold
the same files (``model.safetensors`` against ``pytorch_model.bin``), equal
JSON and equal float32 tensors.  The port's Llama directory loads into both
packages and gives the source model's logits: bit-equal within each
package, and within ``REL`` (1e-5 of the largest |logit|, the families'
composite forward tolerance) across them.  What the reference's export
cannot write raises ``ValueError`` before anything is written."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from spatialrgpt_tpu import config as jconfig
from spatialrgpt_tpu.data.dataset import to_vlm_inputs
from spatialrgpt_tpu.models import vlm as jvlm
from spatialrgpt_tpu.ops import quant as jquant
from spatialrgpt_tpu.utils import checkpoint as jckpt
from spatialrgpt_tpu.utils import export as jexport
from spatialrgpt_tpu_torch import config as tconfig
from spatialrgpt_tpu_torch.constants import IMAGE_TOKEN_INDEX
from spatialrgpt_tpu_torch.data.splice import expand_rows
from spatialrgpt_tpu_torch.models import mpt as tmpt
from spatialrgpt_tpu_torch.models import vlm as tvlm
from spatialrgpt_tpu_torch.ops.layers import quantize_model
from spatialrgpt_tpu_torch.utils import checkpoint as tckpt
from spatialrgpt_tpu_torch.utils import export as texport
from spatialrgpt_tpu_torch.utils.weights import init_random, load_from_jax, save_composite_hf
from test_torch_families import REL, _cfg, _np_tree, _rel_close

# a form -> (its family in tests/test_torch_families.py, the knobs changed there)
FORMS = {"llama": ("mistral", dict(sliding_window=None, rope_scaling_factor=2.0)),
         "mistral": ("mistral", {}), "gemma": ("gemma", {})}
JAX_WEIGHTS, PORT_WEIGHTS = "model.safetensors", "pytorch_model.bin"


def _configs(form: str):
    """(JAX config, port config) of a form, the region pool at 27: the
    reference's format records no pool size, and its loaders take 27."""
    family, kw = FORMS[form]
    return tuple(c.replace(region=dataclasses.replace(c.region, ada_pool_size=27))
                 for c in (_cfg(jconfig, family, **kw), _cfg(tconfig, family, **kw)))


_PAIRS = {}


def _pair(form: str):
    """(JAX config, port config, the numpy tree, the same weights in the
    port), made once per form."""
    if form not in _PAIRS:
        jc, tc = _configs(form)
        rng = np.random.default_rng(5)
        params = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
                              _np_tree(jax.jit(jvlm.init_params, static_argnums=1)(jax.random.PRNGKey(5), jc)))
        _PAIRS[form] = (jc, tc, params, load_from_jax(params, tc, "cpu"))
    return _PAIRS[form]


def _files(root) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def _both(tmp_path, form: str, tokenizers=(None, None)) -> tuple:
    """The JAX package's directory and the port's, written at the same path
    (the top-level config records it) one after the other."""
    jc, tc, params, model = _pair(form)
    root, jax_dir = str(tmp_path / "ckpt"), str(tmp_path / "jax")
    jexport.save_composite_hf(root, params, jc, tokenizer=tokenizers[0])
    os.rename(root, jax_dir)
    save_composite_hf(root, model, tc, tokenizer=tokenizers[1])
    return jax_dir, root


@pytest.mark.parametrize("form", sorted(FORMS))
def test_files_equal_the_references(form, tmp_path):
    """The same file names, every JSON file equal as a parsed dict, every
    split directory's tensors under the same names with equal float32
    values; the decoder's config a Llama's whatever the family, with the
    embedding's rows as its vocabulary and without Gemma's head dim or
    Mistral's window, as the reference writes it."""
    jax_dir, root = _both(tmp_path, form)
    want, got = _files(jax_dir), _files(root)
    assert got == sorted(p.replace(JAX_WEIGHTS, PORT_WEIGHTS) for p in want)
    assert len(got) == 10
    for path in got:
        if path.endswith(".json"):
            with open(os.path.join(root, path)) as f, open(os.path.join(jax_dir, path)) as g:
                assert json.load(f) == json.load(g), path
            continue
        tensors = torch.load(os.path.join(root, path), map_location="cpu", weights_only=True)
        arrays = load_file(os.path.join(jax_dir, path.replace(PORT_WEIGHTS, JAX_WEIGHTS)))
        assert sorted(tensors) == sorted(arrays), path
        for name, a in arrays.items():
            assert tensors[name].dtype == torch.float32 and a.dtype == np.float32, name
            np.testing.assert_array_equal(tensors[name].numpy(), a, err_msg=f"{path}: {name}")
    with open(os.path.join(root, "llm", "config.json")) as f:
        llm = json.load(f)
    with open(os.path.join(root, "config.json")) as f:
        top = json.load(f)
    assert (llm["model_type"], llm["vocab_size"], top["llm_cfg"]) == ("llama", 66, llm)
    assert "head_dim" not in llm and "sliding_window" not in llm
    assert llm.get("rope_scaling") == ({"type": "linear", "factor": 2.0} if form == "llama" else None)


def _batch(cfg):
    """Two region-QA prompts (RGB + depth + 2 regions) of different lengths,
    each image at the config's tokens per image."""
    prompts = [np.array([5, IMAGE_TOKEN_INDEX, 60, 61, 8, 9], np.int64),
               np.array([IMAGE_TOKEN_INDEX, 7, 60, 61], np.int64)]
    sb = expand_rows(prompts, None, max_len=256, tokens_per_image=cfg.tokens_per_image, mask_token_id=60,
                     depth_token_id=61, regions_per_image=2, pad_to=8)
    rng = np.random.default_rng(0)
    n, size = len(prompts), cfg.vision.image_size
    pix = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    dep = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    masks = (rng.random((n, 2, size, size)) > 0.5).astype(np.float32)
    valid = np.ones((n, 2), bool)
    return tvlm.VLMInputs.from_spliced(sb, pix, dep, masks, valid, "cpu"), to_vlm_inputs(sb, pix, dep, masks, valid)


def test_llama_directory_loads_in_both_packages(tmp_path):
    """The port's Llama directory read back by each package's
    ``SpatialRGPTConfig.load`` (the reference-composite branch: the region
    tokens inside the vocabulary) and ``load_reference_checkpoint``: the
    same config in both, and the composite forward's logits bit-equal to
    the source model's in each package, within REL across them."""
    jc, tc, params, model = _pair("llama")
    root = str(tmp_path / "ckpt")
    save_composite_hf(root, model, tc)
    tc2, jc2 = tconfig.SpatialRGPTConfig.load(root), jconfig.SpatialRGPTConfig.load(root)
    assert (tc2.llm.vocab_size, tc2.num_extra_tokens, tc2.mask_token_id, tc2.depth_token_id) == (66, 0, 60, 61)
    assert dataclasses.asdict(tc2) == dataclasses.asdict(jc2)
    assert tc2.replace(llm=tc.llm, num_extra_tokens=2) == tc
    back = tckpt.load_reference_checkpoint(root, tc2, "cpu", torch.float32)
    jback = jckpt.load_reference_checkpoint(root, jc2, dtype=jnp.float32)
    inputs, jin = _batch(tc)
    want_j = np.asarray(jax.jit(lambda p, i: jvlm.forward(p, jc, i))(params, jin))
    got_j = np.asarray(jax.jit(lambda p, i: jvlm.forward(p, jc2, i))(jback, jin))
    with torch.no_grad():
        want_t, got_t = tvlm.forward(model, tc, inputs), tvlm.forward(back, tc2, inputs)
    assert got_t.shape == want_j.shape == (2, inputs.input_ids.shape[1], 66)
    assert np.isfinite(want_j).all()
    np.testing.assert_array_equal(got_j, want_j)
    assert torch.equal(got_t, want_t)
    _rel_close(got_t, want_j, REL)


class StubTokenizer:
    """``save_pretrained`` as an HF tokenizer's: its files in the directory
    given."""

    def __init__(self):
        self.saved = []

    def save_pretrained(self, path):
        self.saved.append(path)
        with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
            json.dump({"tokenizer_class": "StubTokenizer"}, f)


def test_tokenizer_saved_into_llm(tmp_path):
    toks = StubTokenizer(), StubTokenizer()
    jax_dir, root = _both(tmp_path, "llama", toks)
    assert toks[0].saved == toks[1].saved == [os.path.join(root, "llm")]
    assert sorted(os.listdir(os.path.join(root, "llm"))) == ["config.json", PORT_WEIGHTS, "tokenizer_config.json"]
    assert sorted(os.listdir(os.path.join(jax_dir, "llm"))) == ["config.json", JAX_WEIGHTS, "tokenizer_config.json"]


def _refused(case: str):
    """(port model, its config, the JAX tree or None, the JAX config) of a
    case the reference's export cannot write."""
    jc, tc, params, _ = _pair("llama")
    if case == "moe":
        jm, tm = _cfg(jconfig, "mixtral"), _cfg(tconfig, "mixtral")
        moe = _np_tree(jax.jit(jvlm.init_params, static_argnums=1)(jax.random.PRNGKey(1), jm))
        return init_random(tm, "cpu", torch.float32), tm, moe, jm
    if case == "quantized":
        return (quantize_model(init_random(tc, "cpu", torch.float32), act_quant=True), tc,
                dict(params, llm=_np_tree(jquant.quantize_llm(params["llm"], act_quant=True))), jc)
    if case == "mpt":
        mpt = tmpt.MPTConfig(d_model=64, n_heads=4, n_layers=2, vocab_size=128, max_seq_len=128)
        return init_random(tc, "cpu", torch.float32, mpt_cfg=mpt), tc, None, jc
    if case == "no_region":
        tn = tc.replace(enable_region=False)
        return init_random(tn, "cpu", torch.float32), tn, None, jc
    tl = tc.replace(projector=dataclasses.replace(tc.projector, projector_type="linear"))
    return init_random(tl, "cpu", torch.float32), tl, None, jc


@pytest.mark.parametrize("case,cause", [("moe", "MoE"), ("quantized", "quantized"), ("mpt", "MptForCausalLM"),
                                        ("no_region", "region extractor"), ("linear_projector", "mlp_downsample")])
def test_refuses_what_the_reference_cannot_write(case, cause, tmp_path):
    """``ValueError`` naming the cause, and no file written; the JAX
    package's export fails on the same MoE and quantized trees."""
    model, cfg, jparams, jc = _refused(case)
    root = tmp_path / "ckpt"
    with pytest.raises(ValueError, match=cause):
        save_composite_hf(str(root), model, cfg)
    assert not root.exists()
    with pytest.raises(ValueError, match=cause):
        texport.save_composite_hf(str(root), model, cfg)
    if jparams is not None:
        with pytest.raises(KeyError):
            jexport.save_composite_hf(str(tmp_path / "jax"), jparams, jc)
