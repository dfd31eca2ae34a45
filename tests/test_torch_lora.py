"""Port parity for LoRA / QLoRA (``train/lora.py``): the reference's own LoRA
tests (tests/test_lora_towers.py) on the port, and the port's adapters,
merged and side-branch forms against the JAX package's on the same numpy
weights and the reference's adapters (carried by
``utils/weights.py::load_adapters_from_jax``), in fp32 on the CPU.

Tolerances: fp32 logits through two decoder layers in another summation
order, 1e-4 relative to the largest logit; a merged weight over an int8
base is bf16 in both packages (the reference's merged dtype), and its
f32 sum W + a b scale runs in another order: one bf16 ulp (2^-8 relative);
the side branch against the merged form within the reference's own 0.08
(the merged kernel's bf16 rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from spatialrgpt_tpu.models import llama as jllama
from spatialrgpt_tpu.ops import quant as jquant
from spatialrgpt_tpu.train import lora as jlora
from spatialrgpt_tpu_torch.models import llama as tllama
from spatialrgpt_tpu_torch.ops import layers as tlayers
from spatialrgpt_tpu_torch.train import lora as tlora
from spatialrgpt_tpu_torch.train import optimizer as topt
from spatialrgpt_tpu_torch.train import step as tstep
from spatialrgpt_tpu_torch.utils.weights import llama_module_name, load_adapters_from_jax, load_from_jax
from tests.test_torch_train import TINY, TINY_T, _batch, _np_tree

LCFG = dict(r=4, alpha=8.0)


@pytest.fixture(scope="module")
def params():
    from spatialrgpt_tpu.models import vlm as jvlm

    return jax.jit(jvlm.init_params, static_argnums=1)(jax.random.PRNGKey(0), TINY)


def _ids(seed=0, shape=(2, 12)):
    ids = np.random.default_rng(seed).integers(0, TINY.llm.vocab_size, shape)
    return ids, np.broadcast_to(np.arange(shape[1]), shape)


def _jax_logits(llm_params, ids, pos):
    return np.asarray(jllama.forward_logits(llm_params, TINY.llm, input_ids=jnp.asarray(ids, jnp.int32),
                                            position_ids=jnp.asarray(pos, jnp.int32)), np.float32)


def _logits(llm, ids, pos):
    h, _ = tllama.forward(llm, TINY_T.llm, inputs_embeds=tllama.embed_tokens(llm, torch.tensor(ids)),
                          position_ids=torch.tensor(np.ascontiguousarray(pos)))
    return tllama.logits(llm, h)


def _model(tree):
    return load_from_jax(_np_tree(tree), TINY_T, "cpu")


def _shifted(adapters, by):
    return jax.tree.map(lambda t: t + by, adapters)


def test_lora_zero_init_is_identity_and_trains(params):
    """tests/test_lora_towers.py:33 on the port: an adapter per targeted
    projection (2 layers x 7), b = 0 makes the merged model the base, and
    the gradient reaches the adapters only.  The adapters sit on the same
    projections as the reference's ``init_lora`` keys."""
    llm = _model(params).llm
    adapters = tlora.init_lora(llm, tlora.LoraConfig(**LCFG), torch.Generator().manual_seed(1))
    assert len(adapters) == 2 * 7
    jkeys = jlora.init_lora(jax.random.PRNGKey(1), params["llm"], jlora.LoraConfig(**LCFG)).keys()
    assert sorted(llama_module_name(k) for k in jkeys) == sorted(name for name, _ in adapters.items())
    ids, pos = _ids()
    base = _logits(llm, ids, pos)
    merged = _logits(tlora.apply_lora(llm, adapters, tlora.LoraConfig(**LCFG)), ids, pos)
    torch.testing.assert_close(merged, base, rtol=0, atol=1e-5)
    loss = _logits(tlora.apply_lora(llm, adapters, tlora.LoraConfig(**LCFG)), ids, pos).square().sum()
    loss.backward()
    assert sum(float(p.grad.abs().sum()) for p in adapters.parameters()) > 0
    assert all(p.grad is None for p in llm.parameters())


def test_lora_save_load_roundtrip(params, tmp_path):
    """tests/test_lora_towers.py:57 on the port (``torch.save``)."""
    llm = _model(params).llm
    lcfg = tlora.LoraConfig(r=2)
    adapters = tlora.init_lora(llm, lcfg, torch.Generator().manual_seed(1))
    path = str(tmp_path / "adapter.pt")
    tlora.save_adapters(path, adapters, lcfg)
    back = tlora.load_adapters(path)
    assert [n for n, _ in back.items()] == [n for n, _ in adapters.items()]
    for (_, a), (_, b) in zip(adapters.items(), back.items()):
        torch.testing.assert_close(a.a, b.a, rtol=0, atol=0)
        torch.testing.assert_close(a.b, b.b, rtol=0, atol=0)


def test_adapters_from_jax_and_both_forms_match_jax(params):
    """The reference's adapters carried across (names and values), then the
    merged form and the side branch of a float base at fp32 against the
    reference's logits of the same forms."""
    lcfg = jlora.LoraConfig(**LCFG)
    jad = _shifted(jlora.init_lora(jax.random.PRNGKey(1), params["llm"], lcfg), 0.02)
    adapters = load_adapters_from_jax(_np_tree(jad), "cpu")
    for path, node in jad.items():
        pair = dict(adapters.items())[llama_module_name(path)]
        np.testing.assert_array_equal(pair.a.detach().numpy(), np.asarray(node["a"]))
        np.testing.assert_array_equal(pair.b.detach().numpy(), np.asarray(node["b"]))
    llm = _model(params).llm
    ids, pos = _ids(1)
    for merge in (True, False):
        want = _jax_logits(jlora.apply_lora(params["llm"], jad, lcfg, merge=merge), ids, pos)
        got = _logits(tlora.apply_lora(llm, adapters, tlora.LoraConfig(**LCFG), merge=merge), ids, pos)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                   err_msg=f"merge={merge}")


def test_qlora_apply_on_quantized_base_matches_dequantized(params):
    """tests/test_lora_towers.py:122 on the port: merged over an int8 base
    equals merged over the dequantized base (both bf16 weights, bit for
    bit), the adapters have the same projections over either base, and the
    merged weights agree with the reference's within one bf16 ulp."""
    lcfg = tlora.LoraConfig(**LCFG)
    qtree = dict(params, llm=jquant.quantize_llm(params["llm"], bits=8))
    qllm = _model(qtree).llm
    jad = _shifted(jlora.init_lora(jax.random.PRNGKey(1), qtree["llm"], jlora.LoraConfig(**LCFG)), 0.01)
    adapters = load_adapters_from_jax(_np_tree(jad), "cpu")
    fllm = tlayers.dequantize_model(_model(qtree).llm, torch.float32)
    gen = torch.Generator().manual_seed(1)
    assert sorted(n for n, _ in tlora.init_lora(qllm, lcfg, gen).items()) == sorted(n for n, _ in adapters.items())
    merged_q = dict(tlora.apply_lora(qllm, adapters, lcfg).named_modules())
    merged_f = dict(tlora.apply_lora(fllm, adapters, lcfg).named_modules())
    jmerged = jlora.apply_lora(qtree["llm"], jad, jlora.LoraConfig(**LCFG))
    for path in jad:
        name = llama_module_name(path)
        w = merged_q[name].weight
        assert isinstance(merged_q[name], tlayers.MergedLinear) and w.dtype == torch.bfloat16
        torch.testing.assert_close(w, merged_f[name].weight.to(torch.bfloat16), rtol=0, atol=0)
        node = jmerged
        for k in path.split("/")[:-1]:
            node = node[int(k)] if k.isdigit() else node[k]
        want = np.asarray(node["kernel"].astype(jnp.float32)).T
        np.testing.assert_allclose(w.detach().float().numpy(), want, rtol=2.0**-8, atol=2.0**-8 * np.abs(want).max())
    assert isinstance(qllm.model.layers[0].self_attn.q_proj, tlayers.QuantLinear)  # the base is untouched


def test_qlora_side_branch_matches_merged_forward(params):
    """tests/test_lora_towers.py:147 on the port: ``apply_lora(merge=False)``
    leaves the int8 base as it is (the view shares its q tensors) and its
    logits agree with the merged form within the reference's 0.08 (the
    merged weights' bf16 rounding); the side branch contributes; and it
    equals the reference's side branch at fp32."""
    lcfg = tlora.LoraConfig(**LCFG)
    qtree = dict(params, llm=jquant.quantize_llm(params["llm"], bits=8))
    qllm = _model(qtree).llm
    jad = _shifted(jlora.init_lora(jax.random.PRNGKey(1), qtree["llm"], jlora.LoraConfig(**LCFG)), 0.02)
    adapters = load_adapters_from_jax(_np_tree(jad), "cpu")
    attached = tlora.apply_lora(qllm, adapters, lcfg, merge=False)
    for (name, a), (_, b) in zip(attached.named_modules(), qllm.named_modules()):
        if isinstance(b, tlayers.QuantLinear):
            assert a.q is b.q and a.scale is b.scale and getattr(b, "lora", None) is None
    ids, pos = _ids(2)
    side = _logits(attached, ids, pos).detach()
    merged = _logits(tlora.apply_lora(qllm, adapters, lcfg, merge=True), ids, pos).detach()
    torch.testing.assert_close(side, merged, rtol=0, atol=0.08)
    assert float((side - _logits(qllm, ids, pos)).abs().max()) > 0.01
    want = _jax_logits(jlora.apply_lora(qtree["llm"], jad, jlora.LoraConfig(**LCFG), merge=False), ids, pos)
    np.testing.assert_allclose(side.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    with pytest.raises(ValueError, match="DoRA"):
        tlora.apply_lora(qllm, adapters, tlora.LoraConfig(**LCFG, use_dora=True), merge=False)


def test_qlora_train_step_trains_adapters_only(params):
    """tests/test_lora_towers.py:186 on the port: ``make_lora_train_step`` on
    an int8 base, adapters and the projector trained: the loss falls over 6
    steps, the adapters move, and nothing else does (the region extractor,
    outside the optimizer, included)."""
    model = _model(dict(params, llm=jquant.quantize_llm(params["llm"], bits=8)))
    lcfg = tlora.LoraConfig(**LCFG)
    model.adapters = tlora.init_lora(model.llm, lcfg, torch.Generator().manual_seed(1))
    start = {n: p.detach().clone() for n, p in model.adapters.named_parameters()}
    holder = nn.ModuleDict({"adapters": model.adapters, "mm_projector": model.mm_projector})
    tx = topt.build_optimizer(holder, topt.OptimizerConfig(learning_rate=5e-3, total_steps=10, warmup_ratio=0.0))
    frozen = {k: v.clone() for k, v in model.state_dict().items()
              if not k.startswith(("adapters.", "mm_projector."))}
    step = tstep.make_lora_train_step(TINY_T, tx, lcfg)
    state = tstep.create_train_state(model, tx)
    inputs, _ = _batch(3)
    losses = []
    for _ in range(6):
        state, metrics = step(state, inputs)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses
    assert any(not torch.equal(p, start[n]) for n, p in model.adapters.named_parameters())
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in frozen.items())
