"""Port parity for parallel training: the train step over FSDP2 with
Ulysses, ring and hybrid sequence parallelism (``train/step.py::
shard_state`` / ``batch_shardings``, ``models/vlm.py``'s sequence chunks and
global loss), DPO under FSDP, sharded checkpoints (``utils/orbax_io.py``
and the ``torch`` backend across FSDP degrees), ``train.main`` from argv on
two ranks, and the 8-rank dryrun (``spatialrgpt_tpu_torch/dryrun.py``).

The weights are a JAX ``init_params`` tree whose MLP is 1024 wide, so that
FSDP's rule shards real matrices; the batch is
``__graft_entry__._tiny_batch``'s, 8 rows of 64 positions.  One group of
ranks per world size (8, 2) runs every case of this file at that size once
(``torch_parallel_cases``); each case is its own test.  A parallel step's
loss and gradients equal the one-process step's (loss rtol 1e-5; gradients
atol 1e-6, rtol 1e-4) and the JAX package's ``jax.value_and_grad`` of
``vlm.loss_fn`` on the global batch (the same bounds), and its updated
parameters the one-process step's.  Mixtral-tiny (4 experts, top 2) at fsdp
2 and at Ulysses sp 2 holds its loss, router aux loss and gradients to the
JAX package's global ones at the same bounds.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from spatialrgpt_tpu import config as jconfig
from spatialrgpt_tpu.data.dataset import to_vlm_inputs
from spatialrgpt_tpu.models import vlm as jvlm
from spatialrgpt_tpu_torch import dryrun
from spatialrgpt_tpu_torch.train.dpo import DPOState, make_dpo_step, reference_copy
from spatialrgpt_tpu_torch.train.step import make_train_step
from spatialrgpt_tpu_torch.utils.weights import load_from_jax

QUICK_XLA = {"xla_backend_optimization_level": 0}
CFG_T = cases.tiny_cfg(intermediate=1024)
CFG_J = cases.tiny_cfg(jconfig, intermediate=1024)
MOE = dict(num_experts=4, num_experts_per_tok=2)
CFG_T_MOE = cases.tiny_cfg(intermediate=1024, **MOE)
CFG_J_MOE = cases.tiny_cfg(jconfig, intermediate=1024, **MOE)
ARRAYS = cases.tiny_batch_arrays(CFG_T, B=8, S=64)
CHOSEN = cases.tiny_batch_arrays(CFG_T, B=4, S=64, seed=1)
REJECTED = cases.tiny_batch_arrays(CFG_T, B=4, S=64, seed=2)
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
# train.main on the ``dummy`` mixture: the recipe tests' tiny preset and flags
MAIN_CFG = cases.tiny_cfg(vocab=1024).replace(
    vision=cases.tiny_cfg().vision.__class__(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                             num_attention_heads=2, image_size=384, patch_size=14),
    mask_token_id=-1, depth_token_id=-1, model_max_length=1024)
MAIN_FLAGS = [
    "--data_mixture", "dummy", "--conv_template", "llama_3", "--tune_vision_tower", "false",
    "--tune_mm_projector", "true", "--tune_language_model", "false", "--tune_region_extractor", "true",
    "--image_aspect_ratio", "resize", "--per_device_train_batch_size", "2", "--learning_rate", "1e-3",
    "--model_max_length", "1024", "--save_steps", "1", "--save_total_limit", "1", "--logging_steps", "1",
    "--max_steps", "2", "--regions_per_image", "2", "--attn_impl", "xla", "--model_dtype", "float32",
    "--dataloader_prefetch", "0",
]


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, jax.jit(jvlm.init_params, static_argnums=1, compiler_options=QUICK_XLA)(
        jax.random.PRNGKey(5), CFG_J))


@pytest.fixture(scope="module")
def moe_params():
    return jax.tree.map(np.asarray, jax.jit(jvlm.init_params, static_argnums=1, compiler_options=QUICK_XLA)(
        jax.random.PRNGKey(6), CFG_J_MOE))


@pytest.fixture(scope="module")
def single_ckpt(params, tmp_path_factory):
    """A one-process run's checkpoint after one step, per backend (for
    1 -> 2): its directory and state."""
    out = {}
    for backend in ("orbax", "torch"):
        d = str(tmp_path_factory.mktemp(f"ckpt_single_{backend}"))
        out[backend] = d, cases.checkpoint_roundtrip(params, CFG_T, ARRAYS, d, backend, fsdp=None, load=False)
    return out


@pytest.fixture(scope="module")
def groups(params, moe_params, single_ckpt, tmp_path_factory):
    root = tmp_path_factory.mktemp("ptrain")
    step = dict(params=params, cfg=CFG_T, arrays=ARRAYS)
    ck = dict(params=params, cfg=CFG_T, arrays=ARRAYS)
    moe = dict(params=moe_params, cfg=CFG_T_MOE, arrays=ARRAYS)
    spec = {
        8: [("ulysses", "train_step", dict(step, dp=2, fsdp=2, ulysses=2)),
            ("ring", "train_step", dict(step, dp=2, fsdp=2, ring=2)),
            ("hybrid", "train_step", dict(step, dp=1, fsdp=2, ulysses=2, ring=2))],
        2: [("moe_fsdp", "train_step", dict(moe, fsdp=2)),
            ("moe_ulysses", "train_step", dict(moe, ulysses=2)),
            ("dpo", "dpo_step", dict(params=params, cfg=CFG_T, chosen=CHOSEN, rejected=REJECTED, fsdp=2)),
            ("ckpt_orbax", "checkpoint_roundtrip", dict(ck, out_dir=str(root / "orbax"), backend="orbax", fsdp=2,
                                                        load=False)),
            ("ckpt_torch", "checkpoint_roundtrip", dict(ck, out_dir=str(root / "torch"), backend="torch", fsdp=2,
                                                        load=False)),
            ("ckpt_load_orbax", "checkpoint_roundtrip", dict(ck, out_dir=single_ckpt["orbax"][0], backend="orbax",
                                                             fsdp=2, load=True)),
            ("ckpt_load_torch", "checkpoint_roundtrip", dict(ck, out_dir=single_ckpt["torch"][0], backend="torch",
                                                             fsdp=2, load=True)),
            ("main_sp", "train_main", dict(argv=MAIN_FLAGS + ["--seq_parallel_size", "2"], cfg=MAIN_CFG,
                                           out_dir=str(root / "main_sp"))),
            ("main_fsdp", "train_main", dict(argv=MAIN_FLAGS + ["--fsdp_size", "2", "--ckpt_backend", "orbax"],
                                             cfg=MAIN_CFG, out_dir=str(root / "main_fsdp")))],
    }
    out = {"root": root}
    for world, calls in spec.items():
        out[world] = cases.spawn(world, calls, root / f"w{world}")
    return out


def _case(groups, world, name):
    results = [r[name] for r in groups[world]]
    for r in results:
        assert not (isinstance(r, dict) and "error" in r), r["error"]
    return results


def _named(model_or_tree, cfg=CFG_T):
    """A JAX gradient tree by the port's parameter names."""
    model = load_from_jax(jax.tree.map(np.asarray, model_or_tree), cfg, "cpu")
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def one_rank(params):
    """The one-process step on the global batch: loss, gradients, updated
    parameters."""
    state = cases.train_state(params, CFG_T)
    state, metrics = make_train_step(CFG_T, state.optimizer)(state, cases._inputs(ARRAYS))
    return {"loss": float(metrics["loss"]), "num_tokens": float(metrics["num_tokens"]),
            "grad_norm": float(metrics["grad_norm"]), "grads": cases.grads_by_name(state.model),
            "params": {n: p.detach().numpy() for n, p in state.model.named_parameters()}}


@pytest.fixture(scope="module")
def jax_ref(params):
    """The JAX package's loss and gradients on the global batch."""
    sb, img, dep, masks, valid = ARRAYS
    batch = to_vlm_inputs(sb, img, dep, masks, valid)

    def loss(p):
        return jvlm.loss_fn(p, CFG_J, batch)[0]

    value, grads = jax.jit(jax.value_and_grad(loss), compiler_options=QUICK_XLA)(jax.tree.map(jnp.asarray, params))
    return float(value), _named(grads)


@pytest.fixture(scope="module")
def jax_moe_ref(moe_params):
    """The JAX package's MoE loss, router aux loss and gradients on the
    global batch."""
    batch = to_vlm_inputs(*ARRAYS)

    def loss(p):
        return jvlm.loss_fn(p, CFG_J_MOE, batch)

    (value, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True), compiler_options=QUICK_XLA)(
        jax.tree.map(jnp.asarray, moe_params))
    return float(value), float(metrics["router_aux_loss"]), _named(grads, CFG_T_MOE)


@pytest.mark.parametrize("case", ["ulysses", "ring", "hybrid"])
def test_parallel_step_matches_one_rank(groups, one_rank, case):
    """dp x fsdp x sp = 2 x 2 x 2 (Ulysses, ring) and 1 x 2 x (2 x 2)
    (hybrid): every rank reports the global loss and token count, and the
    whole gradients and updated parameters are the one-process step's."""
    results = _case(groups, 8, case)
    for r in results:
        assert r["sharded"] > 0 and r["impl"] == case
        np.testing.assert_allclose(r["metrics"]["loss"], one_rank["loss"], **LOSS_TOL)
        assert r["metrics"]["num_tokens"] == one_rank["num_tokens"]
        np.testing.assert_allclose(r["metrics"]["grad_norm"], one_rank["grad_norm"], rtol=1e-5)
    got = results[0]
    assert got["grads"].keys() == one_rank["grads"].keys()
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g, one_rank["grads"][name], err_msg=name, **GRAD_TOL)
    for name, p in got["params"].items():
        np.testing.assert_allclose(p, one_rank["params"][name], atol=1e-6, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("case", ["ulysses", "ring", "hybrid"])
def test_parallel_step_matches_jax(groups, jax_ref, case):
    loss, grads = jax_ref
    got = _case(groups, 8, case)[0]
    np.testing.assert_allclose(got["metrics"]["loss"], loss, **LOSS_TOL)
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g, grads[name], err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("case", ["moe_fsdp", "moe_ulysses"])
def test_moe_step_matches_jax(groups, jax_moe_ref, case):
    """Mixtral-tiny's train step at fsdp 2 (each rank 4 of the 8 rows) and
    at Ulysses sp 2 (each rank half of every row): every rank reports the
    global loss and router aux loss, and the whole gradients, the routers'
    among them, are the JAX package's gradient of its global loss (the aux
    is taken over both ranks' tokens once, not once per rank)."""
    loss, aux, grads = jax_moe_ref
    results = _case(groups, 2, case)
    for r in results:
        assert r["sharded"] > 0
        np.testing.assert_allclose(r["metrics"]["loss"], loss, **LOSS_TOL)
        np.testing.assert_allclose(r["metrics"]["router_aux_loss"], aux, **LOSS_TOL)
    got = results[0]["grads"]
    assert set(got) <= set(grads)
    assert sum("block_sparse_moe.gate." in n for n in got) == CFG_T_MOE.llm.num_hidden_layers
    for name, g in got.items():
        np.testing.assert_allclose(g, grads[name], err_msg=name, **GRAD_TOL)


def test_dpo_under_fsdp_matches_one_rank(groups, params):
    """DPO with the policy and its reference copy FSDP-sharded at 2, each
    rank 2 of the 4 pairs: the global metrics and the gradients of the
    one-process step."""
    st = cases.train_state(params, CFG_T)
    state = DPOState(0, st.model, reference_copy(st.model, st.optimizer), st.optimizer)
    state, want = make_dpo_step(CFG_T, st.optimizer)(state, cases._inputs(CHOSEN), cases._inputs(REJECTED))
    grads = cases.grads_by_name(state.model)
    results = _case(groups, 2, "dpo")
    for r in results:
        assert r["ref_sharded"] > 0
        for k, v in want.items():
            np.testing.assert_allclose(r["metrics"][k], float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    for name, g in results[0]["grads"].items():
        np.testing.assert_allclose(g, grads[name], err_msg=name, **GRAD_TOL)


def _same_state(a, b):
    assert a["meta"] == b["meta"]
    assert {k: v.keys() for k, v in a["tree"].items()} == {k: v.keys() for k, v in b["tree"].items()}
    for part, ts in a["tree"].items():
        for name, t in ts.items():
            np.testing.assert_array_equal(t, b["tree"][part][name], err_msg=f"{part}/{name}")


@pytest.mark.parametrize("backend", ["orbax", "torch"])
def test_checkpoint_fsdp2_loads_at_fsdp1(groups, params, backend):
    """A checkpoint written at fsdp = 2 (orbax: each rank its shards) loads
    into a one-process run, bit for bit: parameters, Adam moments and the
    optimizer's counters."""
    saved = _case(groups, 2, f"ckpt_{backend}")
    out = str(groups["root"] / backend)
    loaded = cases.checkpoint_roundtrip(params, CFG_T, ARRAYS, out, backend, fsdp=None, load=True)
    for r in saved:
        _same_state(r, loaded)
    if backend == "orbax":
        assert os.path.exists(os.path.join(out, "checkpoint-1", "state_orbax", ".metadata"))


@pytest.mark.parametrize("backend", ["orbax", "torch"])
def test_checkpoint_fsdp1_loads_at_fsdp2(groups, single_ckpt, backend):
    """A one-process checkpoint loads at fsdp = 2 (each rank its shards of
    the parameters and moments), bit for bit."""
    for r in _case(groups, 2, f"ckpt_load_{backend}"):
        _same_state(r, single_ckpt[backend][1])


def test_train_main_on_two_ranks(groups, tmp_path):
    """``train.main`` from argv on 2 ranks: with ``--seq_parallel_size 2``
    (Ulysses; both ranks load the same rows) its losses are the one-process
    run's; with ``--fsdp_size 2 --ckpt_backend orbax`` it completes, writes
    sharded step checkpoints and the final composite."""
    from spatialrgpt_tpu_torch.train import train as ttrain

    ttrain_preset = ttrain.preset
    try:
        ttrain.preset = lambda name: MAIN_CFG
        ttrain.main(MAIN_FLAGS + ["--output_dir", str(tmp_path / "single")], device="cpu",
                    tokenizer=cases.HFCharTokenizer())
    finally:
        ttrain.preset = ttrain_preset
    with open(tmp_path / "single" / "metrics.jsonl") as f:
        want = [json.loads(line)["loss"] for line in f]
    sp = _case(groups, 2, "main_sp")
    assert sp[0]["result"] == {"status": "completed", "step": 2}
    np.testing.assert_allclose([m["loss"] for m in sp[0]["metrics"]], want, rtol=1e-5)
    fs = _case(groups, 2, "main_fsdp")
    assert all(r["result"] == {"status": "completed", "step": 2} for r in fs)
    assert all(np.isfinite(m["loss"]) for m in fs[0]["metrics"])
    assert {"checkpoint-2", "config.json", "llm", "mm_projector"} <= set(fs[0]["files"])
    assert os.path.exists(groups["root"] / "main_fsdp" / "checkpoint-2" / "state_orbax" / ".metadata")


def test_dryrun_on_8_ranks(capsys):
    """``python -m spatialrgpt_tpu_torch.dryrun 8 --device cpu``: every item's
    line; the tensor-parallel and the ring-prefill tokens are the same
    model's greedy tokens."""
    assert dryrun.main(["8", "--device", "cpu", "--timeout", "200"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    items = {line["item"]: line for line in lines}
    assert list(items) == ["train_step", "tp_generate", "tp_engine", "ring_prefill", "pipeline", "hybrid_step"]
    assert items["train_step"]["mesh"] == {"dp": 2, "fsdp": 2, "sp": 2}
    for item in ("train_step", "hybrid_step"):
        assert np.isfinite(items[item]["loss"]) and np.isfinite(items[item]["grad_norm"])
    assert items["tp_generate"]["tokens"] == items["ring_prefill"]["tokens"]
    assert items["pipeline"]["logits_shape"] == [4, 16, 128]
