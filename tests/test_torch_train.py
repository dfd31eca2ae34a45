"""Port parity for the stage-1 align training step: ``models/vlm.py::loss_fn``,
per-layer remat, ``train/optimizer.py``, ``train/step.py`` and
``train/trainer.py`` against their JAX twins, in fp32 on the CPU with the
same weights (bridged through the HF-named export) and the same numpy
batches.  On the CPU the port's ``attn_impl="pallas"`` runs K4's plain
forward and backward through its ``autograd.Function``; the JAX side runs
its XLA attention, which its own tests hold equal to the Pallas kernel.

Tolerances: fp32 accumulation order through two decoder layers (loss and
gradients), and through three optimizer updates (parameters)."""

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
from spatialrgpt_tpu.models import vlm as jvlm
from spatialrgpt_tpu.train import optimizer as jopt
from spatialrgpt_tpu.train import step as jstep
from spatialrgpt_tpu.utils import export
from spatialrgpt_tpu_torch import config as tconfig
from spatialrgpt_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from spatialrgpt_tpu_torch.data.splice import expand_rows, pack_rows
from spatialrgpt_tpu_torch.models import vlm as tvlm
from spatialrgpt_tpu_torch.ops import flash_attention as K4
from spatialrgpt_tpu_torch.train import optimizer as topt
from spatialrgpt_tpu_torch.train import step as tstep
from spatialrgpt_tpu_torch.train import trainer as ttrainer
from spatialrgpt_tpu_torch.utils.weights import init_random, load_from_jax



def _tiny(c):
    """__graft_entry__.py::_tiny_cfg (Llama 2 layers / 64 wide with GQA
    4q/2kv and a 128-token vocab, SigLIP 2 layers / 32 wide, 2 regions per
    image) in the config classes of module ``c``."""
    return c.SpatialRGPTConfig(
        llm=c.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512),
        vision=c.SiglipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
                                    image_size=56, patch_size=14),
        projector=c.ProjectorConfig(mm_hidden_size=32, hidden_size=64),
        region=c.RegionExtractorConfig(mm_hidden_size=32, hidden_size=64, ada_pool_size=4),
        mask_token_id=120, depth_token_id=121, model_max_length=512,
    )


# the JAX package's config goes to its functions, the port's to the port's
TINY, TINY_T = _tiny(jconfig), _tiny(tconfig)
S = 64
ALIGN = ("llm", "vision")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed, rows=2):
    """``rows`` packed rows of S tokens as bench_train.py builds them: two
    samples per row (bos, the image, 2 x (<mask>, <depth>), text with
    labels), distinct segment ids, a padded tail; RGB, depth and masks."""
    rng = np.random.default_rng(seed)
    m, d = TINY.mask_token_id, TINY.depth_token_id
    singles = []
    for _ in range(2 * rows):
        ids = [1, IMAGE_TOKEN_INDEX, m, d, m, d] + list(rng.integers(2, 100, int(rng.integers(12, 20))))
        labs = [IGNORE_INDEX] * 6 + ids[6:]
        singles.append(expand_rows([np.asarray(ids, np.int64)], [np.asarray(labs, np.int64)], max_len=S,
                                   tokens_per_image=4, mask_token_id=m, depth_token_id=d, regions_per_image=2))
    sb = pack_rows(singles, max_len=S)
    assert sb.input_ids.shape[0] == rows and (sb.segment_ids.max(axis=1) == 2).all()
    assert (sb.segment_ids[:, -1] == 0).all()
    n, size = 2 * rows, TINY.vision.image_size
    pix = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    dep = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    masks = (rng.random((n, 2, size, size)) > 0.5).astype(np.float32)
    valid = np.ones((n, 2), bool)
    return tvlm.VLMInputs.from_spliced(sb, pix, dep, masks, valid, "cpu"), to_vlm_inputs(sb, pix, dep, masks, valid)


@pytest.fixture(scope="module")
def weights():
    params = jax.jit(jvlm.init_params, static_argnums=1)(jax.random.PRNGKey(0), TINY)
    return params, _np_tree(params)


def _model(np_params):
    return load_from_jax(np_params, TINY_T, "cpu")


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ce_chunk", [0, 16])
def test_loss_fn_matches_jax(weights, ce_chunk):
    """Shifted CE with IGNORE_INDEX and segment-boundary masking over two
    packed samples per row; chunked (shift first, LM head per chunk under
    checkpoint) equals unchunked."""
    params, np_params = weights
    inputs, jin = _batch(0)
    jloss, jm = jax.jit(jvlm.loss_fn, static_argnums=1)(params, TINY, jin)
    model = _model(np_params)
    loss, m = tvlm.loss_fn(model, TINY_T, inputs, attn_impl="pallas", ce_chunk=ce_chunk)
    assert int(m["num_tokens"]) == int(jm["num_tokens"]) > 0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    plain, _ = tvlm.loss_fn(model, TINY_T, inputs, attn_impl="xla", ce_chunk=16 - ce_chunk)
    np.testing.assert_allclose(float(loss), float(plain), rtol=1e-6)  # chunked == unchunked
    with pytest.raises(ValueError, match="divide"):
        tvlm.loss_fn(model, TINY_T, inputs, ce_chunk=24)


def _grads(model, inputs, **kw):
    model.zero_grad(set_to_none=True)
    loss, _ = tvlm.loss_fn(model, TINY_T, inputs, **kw)
    loss.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


def test_remat_and_chunked_gradients_equal_plain(weights):
    """Per-layer checkpointing and the chunked CE recompute the forward in
    the backward: the gradients equal those of the plain pass, and K4's
    backward (plain on the CPU) equals autograd through the plain
    attention."""
    model = _model(weights[1]).requires_grad_(True)
    inputs, _ = _batch(1)
    ref = _grads(model, inputs, attn_impl="xla")
    for kw in ({"attn_impl": "pallas"}, {"attn_impl": "pallas", "remat": True, "ce_chunk": 16}):
        got = _grads(model, inputs, **kw)
        assert got.keys() == ref.keys()
        for name, g in got.items():
            torch.testing.assert_close(g, ref[name], rtol=1e-4, atol=1e-6, msg=f"{name} {kw}")


# ---------------------------------------------------------------------------
# the optimizer against optax
# ---------------------------------------------------------------------------


class _Modules(nn.Module):
    """Parameters under the port's module names, for optimizer-only tests."""

    def __init__(self, tree):
        super().__init__()
        for label, leaves in tree.items():
            holder = nn.Module()
            for name, a in leaves.items():
                holder.register_parameter(name, nn.Parameter(torch.tensor(a)))
            setattr(self, topt.MODULES[label], holder)


@pytest.mark.parametrize(
    "kw",
    [
        {"lr_scheduler": "cosine", "total_steps": 100, "max_grad_norm": 0.5},
        {"lr_scheduler": "linear", "total_steps": 20, "warmup_ratio": 0.1, "weight_decay": 0.1},
        {"lr_scheduler": "constant", "mm_projector_lr": 3e-2, "max_grad_norm": 100.0},
        {"lr_scheduler": "cosine", "total_steps": 4, "warmup_ratio": 0.0, "skip_nonfinite_updates": 1},
    ],
    ids=["cosine-clip", "linear-wd", "constant-projector-lr", "skip-nonfinite"],
)
def test_optimizer_matches_optax(kw):
    """Per-group clipping (each group by its own norm), the schedule read at
    the 0-based update count (warmup: the first update has lr 0), frozen
    groups, mm_projector_lr, decoupled weight decay and apply_if_finite:
    parameters after each of 5 updates equal optax's."""
    rng = np.random.default_rng(0)
    shapes = {"projector": {"w": (6, 5), "b": (5,)}, "region": {"w": (4, 3)}, "llm": {"w": (3, 3)}}
    tree = {lab: {n: rng.standard_normal(s).astype(np.float32) for n, s in leaves.items()} for lab, leaves in shapes.items()}
    ocfg = dict(learning_rate=1e-2, tune_language_model=False, **kw)
    jtx = jopt.build_optimizer(tree, jopt.OptimizerConfig(**ocfg))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jtx.init(jparams)
    model = _Modules(tree)
    tx = topt.build_optimizer(model, topt.OptimizerConfig(**ocfg))
    assert [g["label"] for g in tx.param_groups] == ["projector", "region"]
    assert not any(p.requires_grad for p in model.llm.parameters())
    for step in range(5):
        grads = {lab: {n: (3 * rng.standard_normal(s)).astype(np.float32) for n, s in leaves.items()}
                 for lab, leaves in shapes.items()}
        if kw.get("skip_nonfinite_updates") and step in (1, 3):
            grads["region"]["w"][0, 0] = np.nan  # single bad steps: skipped
        updates, jstate = jtx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        for lab, leaves in grads.items():
            for n, g in leaves.items():
                getattr(getattr(model, topt.MODULES[lab]), n).grad = torch.tensor(g)
        tx.step()
        for lab, leaves in jparams.items():
            for n, want in leaves.items():
                got = getattr(getattr(model, topt.MODULES[lab]), n).detach().numpy()
                np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-7, err_msg=f"{lab}.{n} @ {step}")
                first_lr = topt.learning_rate(tx.ocfg, 1.0, 0)
                if lab == "llm" or (step == 0 and first_lr == 0):
                    np.testing.assert_array_equal(got, tree[lab][n])  # frozen / lr 0
    # the moments are kept in the parameter dtype
    half = _Modules(tree).to(torch.bfloat16)
    tx = topt.build_optimizer(half, topt.OptimizerConfig(**ocfg))
    for p in half.parameters():
        p.grad = torch.ones_like(p)
    tx.step()
    assert all(st["mu"].dtype == st["nu"].dtype == torch.bfloat16 for st in tx.state.values())
    assert all(p.dtype == torch.bfloat16 for p in half.parameters())


# ---------------------------------------------------------------------------
# the train step and the trainer
# ---------------------------------------------------------------------------


def test_align_steps_match_jax(weights):
    """Three align steps (frozen llm and vision tower, lr 1e-3, 3 warmup
    steps so the first update has lr 0, max_grad_norm small enough that
    each group is clipped by its own norm): loss, grad_norm and the tuned
    parameters agree with the JAX step after every step, and the frozen
    modules do not move."""
    params, np_params = weights
    ocfg = dict(learning_rate=1e-3, total_steps=100, max_grad_norm=0.05,
                tune_language_model=False, tune_vision_tower=False)
    jtx = jopt.build_optimizer(params, jopt.OptimizerConfig(**ocfg))
    jstate = jstep.create_train_state(params, jtx)
    jfn = jstep.make_train_step(TINY, jtx, attn_impl="xla", frozen=ALIGN)
    model = _model(np_params)
    tx = topt.build_optimizer(model, topt.OptimizerConfig(**ocfg))
    state = tstep.create_train_state(model, tx)
    fn = tstep.make_train_step(TINY_T, tx, attn_impl="pallas", remat=True, frozen=ALIGN, ce_chunk=32)
    frozen_before = {n: p.clone() for n, p in model.named_parameters() if n.startswith(("llm.", "vision_tower."))}
    for i in range(3):
        inputs, jin = _batch(10 + i)
        before = export.export_projector(_np_tree(jstate.params["projector"]), TINY.projector.projector_type)
        jstate, jm = jfn(jstate, jin)
        state, m = fn(state, inputs)
        assert state.step == i + 1
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        # grad_norm well above max_grad_norm: the clip acts in both groups
        assert float(jm["grad_norm"]) > 10 * ocfg["max_grad_norm"]
        want = {
            "mm_projector": export.export_projector(_np_tree(jstate.params["projector"]), TINY.projector.projector_type),
            "region_extractor": export.export_region_extractor(_np_tree(jstate.params["region"])),
        }
        for mod, sd in want.items():
            got = getattr(model, mod).state_dict()
            for name, a in sd.items():
                np.testing.assert_allclose(got[name].numpy(), a, rtol=1e-4, atol=1e-7, err_msg=f"{mod}.{name} @ {i}")
        moved = any(not np.array_equal(before[n], want["mm_projector"][n]) for n in before)
        assert moved == (i > 0), "lr 0 on the first update only"
    for n, p in model.named_parameters():
        if n in frozen_before:
            assert torch.equal(p, frozen_before[n]), n
            assert p.grad is None, n


def test_trainer_resume_is_bit_exact(weights, tmp_path):
    """Twin of test_resume_is_bit_exact_with_uninterrupted_run: 3 steps, a
    preemption, and a resume for 3 more give bit-identical parameters and
    optimizer state to 6 uninterrupted steps (parameters, Adam moments,
    schedule position and data order restored); the final save writes the
    split composite layout under the reference's HF names."""
    np_params = weights[1]
    ocfg = topt.OptimizerConfig(learning_rate=1e-3, total_steps=6, warmup_ratio=0.0)

    def fresh():
        model = _model(np_params)
        tx = topt.build_optimizer(model, ocfg)
        return tstep.create_train_state(model, tx), tstep.make_train_step(TINY_T, tx, attn_impl="pallas")

    state, fn = fresh()
    straight = ttrainer.Trainer(TINY_T, ttrainer.TrainerConfig(output_dir=str(tmp_path / "a"), max_steps=6,
                                                             save_steps=100, log_steps=1),
                                fn, state, (_batch(20 + i, rows=1)[0] for i in range(6)))
    assert straight.train() == {"status": "completed", "step": 6}

    hits = []
    tcfg = ttrainer.TrainerConfig(output_dir=str(tmp_path / "b"), max_steps=6, save_steps=2, log_steps=1,
                                  autoresume_poll_steps=3)
    state, fn = fresh()
    first = ttrainer.Trainer(TINY_T, tcfg, fn, state, (_batch(20 + i, rows=1)[0] for i in range(6)),
                             autoresume_check=lambda: not hits.append(1))
    assert first.train() == {"status": "preempted", "step": 3}
    assert sorted(os.listdir(tmp_path / "b")) == ["checkpoint-3", "metrics.jsonl"]  # checkpoint-2 pruned
    state, fn = fresh()
    resumed = ttrainer.Trainer(TINY_T, tcfg, fn, state, (_batch(20 + i, rows=1)[0] for i in range(6)))
    assert resumed.train() == {"status": "completed", "step": 6}
    assert ttrainer.find_resume_checkpoint(str(tmp_path / "b")) == "DONE"

    a, b = straight.state, resumed.state
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert [g["count"] for g in sa["param_groups"]] == [g["count"] for g in sb["param_groups"]] == [6, 6, 6]
    for i, st in sa["state"].items():
        assert torch.equal(st["mu"], sb["state"][i]["mu"]) and torch.equal(st["nu"], sb["state"][i]["nu"])
    with open(tmp_path / "b" / "metrics.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3, 4, 5, 6]

    names = {
        "vision_tower": export.export_siglip(np_params["vision"]),
        "mm_projector": export.export_projector(np_params["projector"], TINY.projector.projector_type),
        "region_extractor": export.export_region_extractor(np_params["region"]),
        "llm": export.export_llama(np_params["llm"]),
    }
    for sub, sd in names.items():
        saved = torch.load(tmp_path / "b" / sub / "pytorch_model.bin")
        assert saved.keys() == sd.keys(), sub
    assert os.path.exists(tmp_path / "b" / "config.json")


def test_unported_training_options_raise(weights):
    with pytest.raises(NotImplementedError):  # "orbax" is ported (utils/orbax_io.py); others are not
        ttrainer.TrainerConfig(ckpt_backend="npz")
    with pytest.raises(ValueError, match="unknown frozen"):
        tstep.make_train_step(TINY_T, None, frozen=("tower",))
    # a MoE decoder trains (the families' training): its loss carries the aux
    moe = TINY_T.replace(llm=TINY_T.llm.__class__(**{**TINY_T.llm.__dict__, "num_experts": 2}))
    loss, metrics = tvlm.loss_fn(init_random(moe, "cpu", torch.float32, seed=0), moe, _batch(0)[0], attn_impl="pallas")
    assert np.isfinite(float(loss)) and float(metrics["router_aux_loss"]) > 0
    assert K4.launches == {"flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0}
