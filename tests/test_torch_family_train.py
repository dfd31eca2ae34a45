"""Port parity for the decoder families' training: Mistral's window, Gemma's
tied head (its backward through ``ops/layers.py::matmul_f32``) and head dim
past 128 (K4's plain versions at D = 256 against the Pallas kernels), and
Mixtral's MoE (the router aux loss in the loss, under remat and
``ce_chunk``, the dense and sparse blocks' gradients, LoRA on the experts),
through ``loss_fn``, ``sequence_logprob`` / ``dpo_loss``, the LoRA step and
``train.main``.

The same weights (a JAX ``init_params`` tree through ``load_from_jax``) and
the same numpy inputs go through the JAX package and the port in fp32 on
the CPU, where the port's kernel wrappers take their plain versions.  Tiny
widths, as ``tests/test_torch_families.py``: 2 layers, hidden 64, heads 4 /
2 (Gemma's explicit head dim 32), 4 experts top-2, a window of 8.

Tolerances: losses and the aux loss 1e-5 relative, gradients 1e-4 relative
L2 per tensor (fp32 summation order through two decoder layers); K4 at D =
256 as the D = 32 tests of ``tests/test_torch_kernels.py`` (atol 2e-5 /
rtol 2e-4 forward, 5e-5 / 5e-4 gradients)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from spatialrgpt_tpu import config as jconfig
from spatialrgpt_tpu.data.dataset import to_vlm_inputs
from spatialrgpt_tpu.models import llama as jllama
from spatialrgpt_tpu.models import vlm as jvlm
from spatialrgpt_tpu.ops import flash_attention as jflash
from spatialrgpt_tpu.train import dpo as jdpo
from spatialrgpt_tpu.train import lora as jlora
from spatialrgpt_tpu.train import optimizer as jopt
from spatialrgpt_tpu.train import step as jstep
from spatialrgpt_tpu_torch import config as tconfig
from spatialrgpt_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from spatialrgpt_tpu_torch.data.splice import expand_rows, pack_rows
from spatialrgpt_tpu_torch.models import llama as tllama
from spatialrgpt_tpu_torch.models import vlm as tvlm
from spatialrgpt_tpu_torch.ops import flash_attention as K4
from spatialrgpt_tpu_torch.ops import layers as tlayers
from spatialrgpt_tpu_torch.train import dpo as tdpo
from spatialrgpt_tpu_torch.train import lora as tlora
from spatialrgpt_tpu_torch.train import optimizer as topt
from spatialrgpt_tpu_torch.train import step as tstep
from spatialrgpt_tpu_torch.train import train as ttrain
from spatialrgpt_tpu_torch.utils import weights as tweights
from spatialrgpt_tpu_torch.utils.weights import llama_module_name, load_adapters_from_jax, load_from_jax

from test_templates import FakeTokenizer

LOSS_REL = 1e-5  # losses and the aux loss
GRAD_REL_L2 = 1e-4  # gradients, per tensor
S = 64  # tokens per packed row
FAMILIES = {
    "mistral": dict(sliding_window=8),
    "gemma": dict(hidden_act="gelu_tanh", norm_plus_one=True, scale_embeddings=True, explicit_head_dim=32,
                  tie_word_embeddings=True, rms_norm_eps=1e-6),
    "mixtral": dict(num_experts=4, num_experts_per_tok=2, rope_theta=1e6),
}


def _cfg(c, family: str, vocab: int = 64, mask: int = 60, depth: int = 61, **top):
    """A tiny composite config of one family, from each package's own config
    module (``tests/test_torch_families.py``'s widths)."""
    return c.SpatialRGPTConfig(
        llm=c.LlamaConfig(vocab_size=vocab, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=1024,
                          **FAMILIES[family]),
        vision=c.SiglipVisionConfig(hidden_size=16, intermediate_size=32, num_hidden_layers=2, num_attention_heads=2,
                                    image_size=56, patch_size=14),
        projector=c.ProjectorConfig(mm_hidden_size=16, hidden_size=64),
        region=c.RegionExtractorConfig(mm_hidden_size=16, hidden_size=64, ada_pool_size=4),
        mask_token_id=mask, depth_token_id=depth, **top,
    )


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


_PARAMS = {}


def _params(family: str):
    """(JAX config, port config, JAX params), seed 3, made once per family."""
    if family not in _PARAMS:
        jc, tc = _cfg(jconfig, family), _cfg(tconfig, family)
        _PARAMS[family] = (jc, tc, jax.jit(jvlm.init_params, static_argnums=1)(jax.random.PRNGKey(3), jc))
    return _PARAMS[family]


def _model(family: str, params=None):
    """A fresh port model of the family's weights, every parameter trained."""
    _, tc, jparams = _params(family)
    return load_from_jax(_np_tree(jparams if params is None else params), tc, "cpu").requires_grad_(True)


def _batch(seed: int, rows: int = 2):
    """``rows`` packed rows of S tokens: two samples per row (bos, the image,
    2 x (<mask>, <depth>), text with labels), a padded tail; RGB, depth and
    masks.  -> (port inputs, JAX inputs)."""
    rng = np.random.default_rng(seed)
    singles = []
    for _ in range(2 * rows):
        ids = [1, IMAGE_TOKEN_INDEX, 60, 61, 60, 61] + list(rng.integers(2, 58, int(rng.integers(12, 20))))
        labs = [IGNORE_INDEX] * 6 + ids[6:]
        singles.append(expand_rows([np.asarray(ids, np.int64)], [np.asarray(labs, np.int64)], max_len=S,
                                   tokens_per_image=4, mask_token_id=60, depth_token_id=61, regions_per_image=2))
    sb = pack_rows(singles, max_len=S)
    n = 2 * rows
    pix = rng.standard_normal((n, 56, 56, 3)).astype(np.float32)
    dep = rng.standard_normal((n, 56, 56, 3)).astype(np.float32)
    masks = (rng.random((n, 2, 56, 56)) > 0.5).astype(np.float32)
    valid = np.ones((n, 2), bool)
    return tvlm.VLMInputs.from_spliced(sb, pix, dep, masks, valid, "cpu"), to_vlm_inputs(sb, pix, dep, masks, valid)


def _rel_l2(got: torch.Tensor, want) -> float:
    want = torch.as_tensor(np.asarray(want, np.float32))
    got = got.detach().float()
    scale = float(want.norm())
    return float((got - want).norm()) / scale if scale > 0 else float(got.norm())


def _llm_grads_close(model: tvlm.SpatialRGPT, jgrads_llm) -> None:
    """Every decoder parameter's gradient (HF names, through the port's
    export of the JAX tree) within GRAD_REL_L2."""
    want = tweights.export_llama_families(_np_tree(jgrads_llm))
    named = dict(model.llm.named_parameters())
    assert sorted(named) == sorted(want)
    for name, w in want.items():
        assert named[name].grad is not None, name
        assert _rel_l2(named[name].grad, w) <= GRAD_REL_L2, (name, _rel_l2(named[name].grad, w))


def _grad_norm(tree) -> float:
    return float(np.sqrt(sum(float(np.sum(np.asarray(t, np.float64) ** 2)) for t in jax.tree.leaves(tree))))


_JAX_LOSS = {}


def _jax_loss_and_grads(family: str):
    """The JAX ``loss_fn`` (unchunked, no remat: the same values) and
    ``jax.grad`` of every parameter on ``_batch(0)``."""
    if family not in _JAX_LOSS:
        jc, _, params = _params(family)
        _, jin = _batch(0)
        fn = jax.jit(jax.value_and_grad(lambda p: jvlm.loss_fn(p, jc, jin), has_aux=True))
        (loss, metrics), grads = fn(params)
        _JAX_LOSS[family] = (float(loss), {k: float(v) for k, v in metrics.items()}, grads)
    return _JAX_LOSS[family]


# ---------------------------------------------------------------------------
# loss_fn and its gradients, per family, with and without remat / ce_chunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["plain", "pallas_remat", "pallas_remat_chunked"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_fn_and_gradients_match_jax(family, route):
    """``loss_fn``'s loss, metrics and every parameter's gradient against
    the JAX ``loss_fn`` and ``jax.grad``: on the plain route, and on K4's
    route (its plain versions here) under per-layer remat, with and
    without the chunked CE.  Mixtral's metrics hold the router aux loss and
    the total (CE + 0.02 aux); the reference runs an MoE decoder's
    ``ce_chunk`` unchunked, with the same value."""
    jc, tc, _ = _params(family)
    jloss, jm, jgrads = _jax_loss_and_grads(family)
    inputs, _ = _batch(0)
    kw = {"plain": dict(attn_impl="xla"), "pallas_remat": dict(attn_impl="pallas", remat=True),
          "pallas_remat_chunked": dict(attn_impl="pallas", remat=True, ce_chunk=16)}[route]
    model = _model(family)
    loss, m = tvlm.loss_fn(model, tc, inputs, **kw)
    loss.backward()
    assert sorted(m) == sorted(jm)
    assert ("router_aux_loss" in m) == (family == "mixtral")
    for k, v in jm.items():
        np.testing.assert_allclose(float(m[k]), v, rtol=LOSS_REL, err_msg=k)
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_REL)
    if family == "mixtral":
        ce = jm["loss"] - 0.02 * jm["router_aux_loss"]
        assert jm["router_aux_loss"] > 0 and abs(ce) > 0
    _llm_grads_close(model, jgrads["llm"])
    got_norm = float(torch.sqrt(sum(p.grad.double().square().sum() for p in model.parameters() if p.grad is not None)))
    np.testing.assert_allclose(got_norm, _grad_norm(jgrads), rtol=GRAD_REL_L2)


def test_remat_keeps_the_aux_loss_and_its_gradient():
    """``llama.forward(remat=True, with_aux=True)`` (it raised before the
    families trained): the summed aux and its gradient through the
    checkpointed layers' recompute equal the unchecked layers'."""
    _, tc, _ = _params("mixtral")
    model = _model("mixtral")
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((2, 12, 64)).astype(np.float32))
    pos = torch.arange(12).repeat(2, 1)
    grads = []
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        h, _, aux = tllama.forward(model.llm, tc.llm, inputs_embeds=x, position_ids=pos, remat=remat, with_aux=True)
        (h.square().mean() + aux).backward()
        grads.append((float(aux), {n: p.grad.clone() for n, p in model.llm.named_parameters() if p.grad is not None}))
    assert grads[0][0] == pytest.approx(grads[1][0], rel=LOSS_REL) and grads[0][0] > 0
    assert grads[0][1].keys() == grads[1][1].keys()
    for name, a in grads[0][1].items():
        torch.testing.assert_close(grads[1][1][name], a, rtol=1e-5, atol=1e-7, msg=name)
    router = model.llm.model.layers[1].block_sparse_moe.gate.weight
    assert float(router.grad.norm()) > 0


# ---------------------------------------------------------------------------
# the MoE blocks' gradients
# ---------------------------------------------------------------------------


def _moe(model):
    return model.llm.model.layers[0].block_sparse_moe


def _moe_grads(block, x: np.ndarray, g: np.ndarray, model, tc, extra=()):
    """Gradients of sum(out * g) + 0.3 aux w.r.t. x, the router and
    ``extra`` tensors (default: the experts' weights, w1 / w3 / w2 in
    expert order)."""
    moe = _moe(model)
    tx = torch.tensor(x, requires_grad=True)
    out, aux = block(tx, moe, tc.llm)
    ((out * torch.tensor(g)).sum() + 0.3 * aux).backward()
    leaves = list(extra) or [getattr(e, n).weight for e in moe.experts for n in ("w1", "w3", "w2")]
    return [tx.grad, moe.gate.weight.grad] + [t.grad for t in leaves]


def test_sparse_moe_gradients_equal_the_dense_blocks():
    """The sparse block (stacked experts: the grouped products with f32 sums
    and the f32 index-add) carries the dense block's gradients to x, the
    router and every expert's weights, on random (untied) router scores."""
    _, tc, _ = _params("mixtral")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    g = rng.standard_normal((2, 9, 64)).astype(np.float32)
    dense_model = _model("mixtral")
    dense = _moe_grads(tllama.moe_block, x, g, dense_model, tc)
    sparse_model = _model("mixtral")
    tllama.stack_experts(sparse_model.llm)
    stacked = [t.requires_grad_() for t in _moe(sparse_model).stacked]
    sparse = _moe_grads(tllama.moe_block_sparse, x, g, sparse_model, tc, extra=stacked)
    for got, want in zip(sparse[:2], dense[:2]):
        assert _rel_l2(got, want.numpy()) <= GRAD_REL_L2
    E = tc.llm.num_experts
    for i, st in enumerate(sparse[2:]):  # (E, out, in) against expert e's weight i
        for e in range(E):
            assert _rel_l2(st[e], dense[2 + 3 * e + i].numpy()) <= GRAD_REL_L2, (i, e)


def test_router_tie_gradient_matches_jax():
    """A tie at the k-th probability keeps both tied experts (three of four
    at top-2), and the gradients to x, the router and the experts through
    the kept, renormalised probabilities equal ``jax.grad`` of the
    reference's dense ``_moe_block``."""
    jc, tc, params = _params("mixtral")
    rng = np.random.default_rng(9)
    x = np.abs(rng.standard_normal((1, 6, 64))).astype(np.float32)
    g = rng.standard_normal((1, 6, 64)).astype(np.float32)
    w = np.abs(rng.standard_normal(64)).astype(np.float32) * 0.1
    router = np.stack([w, np.zeros(64), np.zeros(64), -w], axis=1).astype(np.float32)  # logits [s, 0, 0, -s]
    lp = dict(params["llm"]["layers"][0], router={"kernel": jnp.asarray(router)})

    def jloss(x, lp):
        out, aux = jllama._moe_block(x, lp, jc.llm)
        return jnp.sum(out * g) + 0.3 * aux

    jgx, jglp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), lp)
    model = _model("mixtral")
    with torch.no_grad():
        _moe(model).gate.weight.copy_(torch.tensor(router.T))
    probs, gates = tllama.router_gates(torch.tensor(x), _moe(model), tc.llm)
    assert int((gates[0] > 0).sum(-1).min()) == 3  # the tie keeps both
    got = _moe_grads(tllama.moe_block, x, g, model, tc)
    assert _rel_l2(got[0], np.asarray(jgx)) <= GRAD_REL_L2
    assert _rel_l2(got[1], np.asarray(jglp["router"]["kernel"]).T) <= GRAD_REL_L2
    for e, ep in enumerate(jglp["experts"]):
        for i, key in enumerate(("gate", "up", "down")):
            assert _rel_l2(got[2 + 3 * e + i], np.asarray(ep[key]["kernel"]).T) <= GRAD_REL_L2, (e, key)


# ---------------------------------------------------------------------------
# DPO on an MoE decoder: no aux loss
# ---------------------------------------------------------------------------


def test_sequence_logprob_and_dpo_loss_match_jax_on_moe():
    """``sequence_logprob`` of a Mixtral decoder leaves the aux loss out, as
    the reference's ``dpo.py:23-32``, and ``dpo_loss`` against a reference
    copy of other weights equals the reference's, metrics and all; the
    policy's gradient reaches the router."""
    jc, tc, params = _params("mixtral")
    ref_params = jax.tree.map(lambda t: t * 0.97, params)
    chosen, jchosen = _batch(1)
    rejected, jrejected = _batch(2)
    want_lp = jdpo.sequence_logprob(params, jc, jchosen)
    model, ref = _model("mixtral"), _model("mixtral", ref_params).requires_grad_(False)
    got_lp = tvlm.sequence_logprob(model, tc, chosen, attn_impl="pallas", remat=True)
    np.testing.assert_allclose(got_lp.detach().numpy(), np.asarray(want_lp), rtol=LOSS_REL)
    jl, jm = jdpo.dpo_loss(params, ref_params, jc, jchosen, jrejected)
    loss, m = tdpo.dpo_loss(model, ref, tc, chosen, rejected, remat=True)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_REL)
    assert sorted(m) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    loss.backward()
    assert float(_moe(model).gate.weight.grad.norm()) > 0


# ---------------------------------------------------------------------------
# LoRA on Mixtral's experts
# ---------------------------------------------------------------------------

LCFG = dict(r=4, alpha=8.0)


def test_lora_targets_the_experts_as_the_reference(tmp_path):
    """``init_lora``'s adapted set on a Mixtral decoder is the reference's
    (every expert's w1 / w3 / w2 as its gate / up / down, never the router),
    its names round-trip through ``save_adapters`` / ``load_adapters``, and
    ``apply_lora(merge=False)`` merges the experts (always, as the
    reference's) and side-branches the attention projections; merged expert
    weights equal the reference's, adapters carried across."""
    jc, tc, params = _params("mixtral")
    jad = jax.tree.map(lambda t: t + 0.02, jlora.init_lora(jax.random.PRNGKey(2), params["llm"],
                                                           jlora.LoraConfig(**LCFG)))
    model = _model("mixtral")
    ours = tlora.init_lora(model.llm, tlora.LoraConfig(**LCFG), torch.Generator().manual_seed(0))
    names = sorted(n for n, _ in ours.items())
    assert names == sorted(llama_module_name(p) for p in jad)
    assert not any(n.endswith("block_sparse_moe.gate") for n in names)
    assert sum(".experts." in n for n in names) == 2 * 4 * 3
    tlora.save_adapters(str(tmp_path / "adapters.pt"), ours, tlora.LoraConfig(**LCFG))
    back = dict(tlora.load_adapters(str(tmp_path / "adapters.pt")).items())
    assert sorted(back) == names
    for name, pair in ours.items():
        assert torch.equal(back[name].a, pair.a) and torch.equal(back[name].b, pair.b)
    japplied = jlora.apply_lora(params["llm"], jad, jlora.LoraConfig(**LCFG), merge=False)
    view = tlora.apply_lora(model.llm, load_adapters_from_jax(_np_tree(jad), "cpu"), tlora.LoraConfig(**LCFG),
                            merge=False)
    for li, layer in enumerate(view.model.layers):
        assert layer.self_attn.q_proj.lora is not None
        for e, expert in enumerate(layer.block_sparse_moe.experts):
            for key, name in tweights.MOE_PROJECTIONS.items():
                mod = getattr(expert, name)
                assert isinstance(mod, tlayers.MergedLinear)
                want = np.asarray(japplied["layers"][li]["experts"][e][key]["kernel"]).T
                assert _rel_l2(mod.weight, want) <= 1e-6
        assert not isinstance(layer.block_sparse_moe.gate, tlayers.MergedLinear)


def test_lora_step_on_mixtral_matches_jax():
    """One ``make_lora_train_step`` on a Mixtral decoder (adapters on the
    attention projections as the side branch and on every expert merged):
    loss with the aux, the adapters' gradients and their updates against
    the reference's step.  (The int8 weight-only base sums its products in
    another order than the reference's: ``tests/test_torch_qtrain.py``
    holds that route's LoRA step to its own tolerance.)"""
    jc, tc, params = _params("mixtral")
    inputs, jin = _batch(5)
    lcfg = jlora.LoraConfig(**LCFG)
    base = dict(params)
    adapters = jax.tree.map(lambda t: t + 0.02, jlora.init_lora(jax.random.PRNGKey(2), base["llm"], lcfg))
    trainable = {"adapters": adapters}
    ocfg = dict(learning_rate=5e-3, total_steps=10, warmup_ratio=0.0)
    jtx = jopt.build_optimizer(trainable, jopt.OptimizerConfig(**ocfg))
    step = jstep.make_lora_train_step(jc, jtx, lcfg, donate=False)
    jstate, jm = step(jstep.create_train_state(trainable, jtx), base, jin)

    def jloss(t):
        p = dict(jax.lax.stop_gradient(base))
        p["llm"] = jlora.apply_lora(base["llm"], t["adapters"], lcfg, merge=False)
        return jvlm.loss_fn(p, jc, jin)[0]

    jgrads = jax.grad(jloss)(trainable)["adapters"]
    model = load_from_jax(_np_tree(base), tc, "cpu")
    model.adapters = load_adapters_from_jax(_np_tree(adapters), "cpu")
    holder = nn.ModuleDict({"adapters": model.adapters})
    tx = topt.build_optimizer(holder, topt.OptimizerConfig(**ocfg))
    _, m = tstep.make_lora_train_step(tc, tx, tlora.LoraConfig(**LCFG), attn_impl="pallas", remat=True)(
        tstep.create_train_state(model, tx), inputs)
    for k in ("loss", "router_aux_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_REL, err_msg=k)
    new = load_adapters_from_jax(_np_tree(jstate.params["adapters"]), "cpu")
    grads = load_adapters_from_jax(_np_tree(jgrads), "cpu")
    lr = ocfg["learning_rate"]
    for (name, pair), (_, want), (_, g) in zip(model.adapters.items(), new.items(), grads.items()):
        for leaf in ("a", "b"):
            wg = getattr(g, leaf).detach()
            assert _rel_l2(getattr(pair, leaf).grad, wg.numpy()) <= GRAD_REL_L2, f"grad {name}.{leaf}"
            # Adam's first step moves each element by lr g / (|g| + eps): equal
            # where g lies clear of the tolerance around 0, at most 2 lr apart
            # where it does not (there the two gradients may differ in sign)
            diff = (getattr(pair, leaf).detach() - getattr(want, leaf).detach()).abs()
            clear = wg.abs() > 4 * GRAD_REL_L2 * wg.abs().max()
            bound = torch.where(clear, 1e-3 * lr, 2 * lr)
            assert bool((diff <= bound).all()), f"{name}.{leaf}"
    assert all(p.grad is None for p in model.llm.parameters())


# ---------------------------------------------------------------------------
# the tied head's backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tied_head_gradients_match_jax(dtype, monkeypatch):
    """``matmul_f32`` (Gemma's tied head: h (M, K) against the (N, K) table,
    f32 sums and an f32 result) carries JAX's VJP of ``jnp.dot(h, E.T,
    preferred_element_type=f32)``: dh and dE in their operands' dtypes,
    each one f32 product rounded once, with the table widened a few rows
    at a time (7 here, so the sums run in chunks).  f32: 1e-6 relative; bf16:
    within one bf16 rounding of JAX's value (the chunked f32 sums can land
    on the other side of a rounding edge)."""
    monkeypatch.setattr(tlayers, "MATMUL_F32_BWD_ROWS", 7)
    rng = np.random.default_rng(10)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    h = jnp.asarray(rng.standard_normal((5, 24)), jdt)
    E = jnp.asarray(rng.standard_normal((19, 24)), jdt)
    g = rng.standard_normal((5, 19)).astype(np.float32)
    y, vjp = jax.vjp(lambda h, E: jnp.dot(h, E.T.astype(h.dtype), preferred_element_type=jnp.float32), h, E)
    dh, dE = vjp(jnp.asarray(g))
    th = torch.tensor(np.asarray(h.astype(jnp.float32))).to(tdt).requires_grad_()
    tE = torch.tensor(np.asarray(E.astype(jnp.float32))).to(tdt).requires_grad_()
    out = tlayers.matmul_f32(th, tE)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), rtol=1e-6, atol=1e-6)
    out.backward(torch.tensor(g))
    assert th.grad.dtype == tE.grad.dtype == tdt
    for got, want in ((th.grad, dh), (tE.grad, dE)):
        want = np.asarray(want.astype(jnp.float32))
        rel = 2.0**-8 if dtype == "bfloat16" else 1e-6
        np.testing.assert_allclose(got.float().numpy(), want, rtol=rel, atol=rel * np.abs(want).max())
    # only the operand that needs it gets a gradient
    th2 = th.detach().clone().requires_grad_()
    tlayers.matmul_f32(th2, tE.detach()).backward(torch.tensor(g))
    torch.testing.assert_close(th2.grad, th.grad, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K4's plain versions at D = 256 against the Pallas kernels
# ---------------------------------------------------------------------------


def _seg(B, S):
    seg = np.zeros((B, S), np.int32)
    seg[0, :50], seg[0, 50:110], seg[0, 110:] = 1, 2, 3
    seg[1:, : S - 40] = 1
    return seg


@pytest.mark.parametrize("window", [None, 37])
def test_flash_plain_at_d256_matches_pallas(window):
    """K4's plain forward (out, lse) and backward (through
    ``flash_attention``'s Function: dQ and the group-summed dK / dV) at
    Gemma's head dim 256, GQA 2:1, packed segments, padding and a window
    that cuts inside the segments, against the reference's Pallas ``_fwd``
    in interpret mode and ``jax.grad`` of its ``flash_attention`` (the
    Pallas backward kernels in interpret mode)."""
    B, Sq, Hq, Hk, D = 2, 128, 4, 2, 256
    rng = np.random.default_rng(25)
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sq, Hk, D)).astype(np.float32) for _ in range(2))
    seg = _seg(B, Sq)
    jseg = jnp.asarray(seg)
    tr = lambda a: jnp.transpose(jnp.asarray(a), (0, 2, 1, 3))  # noqa: E731
    jout, jlse = jflash._fwd(tr(q), tr(k), tr(v), jseg, jseg, causal=True, sm_scale=D**-0.5, block_q=64,
                             block_k=64, interpret=True, window=window)
    out, lse = K4.flash_attention_fwd_plain(*(torch.tensor(a) for a in (q, k, v)), torch.tensor(seg), window)
    np.testing.assert_allclose(out.numpy(), np.transpose(np.asarray(jout), (0, 2, 1, 3)), atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=2e-5, rtol=2e-4)

    def loss_ref(q, k, v):
        o = jflash.flash_attention(q, k, v, segment_ids=jseg, block_q=64, block_k=64, interpret=True, window=window)
        return jnp.sum(o * jnp.cos(o))

    want = jax.grad(loss_ref, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = K4.flash_attention(tq, tk, tv, torch.tensor(seg), window=window)
    (o * torch.cos(o)).sum().backward()
    for got, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=5e-5, rtol=5e-4, err_msg=f"d{name}")
    assert np.all(tq.grad.numpy()[seg == 0] == 0)


# ---------------------------------------------------------------------------
# train.main per family
# ---------------------------------------------------------------------------

PRESET_OF = {"mistral": "mistral-7b", "gemma": "gemma-7b", "mixtral": "mixtral-8x7b"}
MAIN = [
    "--data_mixture", "dummy", "--conv_template", "llama_3", "--tune_vision_tower", "false",
    "--tune_mm_projector", "true", "--tune_language_model", "false", "--tune_region_extractor", "true",
    "--image_aspect_ratio", "resize", "--per_device_train_batch_size", "2", "--learning_rate", "1e-3",
    "--model_max_length", "1024", "--save_steps", "5", "--logging_steps", "1", "--max_steps", "1",
    "--regions_per_image", "2", "--attn_impl", "pallas", "--gradient_checkpointing", "true",
    "--model_dtype", "float32", "--dataloader_prefetch", "0",
]
ROUTES = {"align": [], "lora8": ["--lora_enable", "true", "--bits", "8", "--lora_r", "4", "--lora_alpha", "8"],
          "dpo": ["--dpo_enable", "true"]}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_main_runs_each_family(family, route, tmp_path, monkeypatch):
    """``train.main`` from argv with ``--llm_preset mistral-7b | gemma-7b |
    mixtral-8x7b`` (a tiny config of the family patched in for the preset,
    weights from ``init_random``) on the ``dummy`` mixture, remat and K4's
    route: one step of the align, the ``--lora_enable --bits 8`` and the
    ``--dpo_enable`` route; the jsonl log holds a finite loss, and for
    Mixtral's align and LoRA steps the router aux loss."""
    seen = []

    def tiny(name):
        seen.append(name)
        return _cfg(tconfig, family, vocab=1024, mask=-1, depth=-1, model_max_length=1024).replace(
            vision=tconfig.SiglipVisionConfig(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                                              num_attention_heads=2, image_size=384, patch_size=14))

    monkeypatch.setattr(ttrain, "preset", tiny)
    argv = MAIN + ["--llm_preset", PRESET_OF[family], "--output_dir", str(tmp_path / "run")] + ROUTES[route]
    if route == "dpo":
        from test_torch_recipe import _pairs_file

        argv += ["--dpo_data_path", _pairs_file(tmp_path, n=2)]
    got = ttrain.main(argv, device="cpu", tokenizer=FakeTokenizer(prepend_bos=False))
    assert got == {"status": "completed", "step": 1} and seen == [PRESET_OF[family]]
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        (rec,) = [json.loads(line) for line in f]
    loss = rec["dpo_loss" if route == "dpo" else "loss"]
    assert np.isfinite(loss)
    assert ("router_aux_loss" in rec) == (family == "mixtral" and route != "dpo")
    if "router_aux_loss" in rec:
        assert rec["router_aux_loss"] > 0
