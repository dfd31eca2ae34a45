"""The training entry point of the port (``train/train.py::main``) and what it
needs beside the data layer: gradient accumulation (``MultiSteps``), DPO,
the composite-checkpoint loader and ``models/builder.py``, each against its
JAX twin on the CPU in fp32, with the same weights (a composite directory
that both packages load), the same fake tokenizer and the same numpy
inputs.

``main`` runs as a launch script runs it, from argv, on the ``dummy``
mixture (``--attn_impl xla``, ``device="cpu"``); the JAX ``main`` gets its
tokenizer through ``AutoTokenizer.from_pretrained``, patched to the fake.
Tolerances: per-step losses rtol 1e-5 and the trained parameters after 3
steps rtol 1e-4 (fp32 accumulation order through two decoder layers and
three updates), as ``tests/test_torch_train.py``; the optimizer alone
against optax rtol 1e-5 / atol 1e-7, as ``test_optimizer_matches_optax``."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from PIL import Image

from spatialrgpt_tpu import config as jconfig
from spatialrgpt_tpu.data.dataset import to_vlm_inputs
from spatialrgpt_tpu.models import builder as jbuilder
from spatialrgpt_tpu.models import vlm as jvlm
from spatialrgpt_tpu.train import dpo as jdpo
from spatialrgpt_tpu.train import lora as jlora
from spatialrgpt_tpu.train import optimizer as jopt
from spatialrgpt_tpu.train import train as jtrain
from spatialrgpt_tpu.utils import checkpoint as jckpt
from spatialrgpt_tpu.utils import export as jexport
from spatialrgpt_tpu_torch import config as tconfig
from spatialrgpt_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from spatialrgpt_tpu_torch.data.splice import expand_rows, pack_rows
from spatialrgpt_tpu_torch.models import builder as tbuilder
from spatialrgpt_tpu_torch.models import vlm as tvlm
from spatialrgpt_tpu_torch.train import dpo as tdpo
from spatialrgpt_tpu_torch.train import lora as tlora
from spatialrgpt_tpu_torch.train import optimizer as topt
from spatialrgpt_tpu_torch.train import train as ttrain
from spatialrgpt_tpu_torch.train import trainer as ttrainer
from spatialrgpt_tpu_torch.utils import checkpoint as tckpt
from spatialrgpt_tpu_torch.utils.weights import llama_module_name, load_adapters_from_jax, load_from_jax, save_composite

from test_templates import FakeTokenizer
from test_torch_train import _Modules


class HFFakeTokenizer(FakeTokenizer):
    """``FakeTokenizer`` (llama-3 style: no BOS prepended) with the methods
    of an HF tokenizer that ``load_tokenizer`` calls; ``specials`` replaces
    the special strings, and ``add_tokens`` appends unknown ones."""

    def __init__(self, specials=None):
        if specials is not None:
            self.SPECIALS = list(specials)
        super().__init__(prepend_bos=False)
        self.size = 1000 + len(self.SPECIALS)

    def __len__(self):
        return self.size

    def add_tokens(self, tokens, special_tokens=False):
        new = [t for t in tokens if t not in self.vocab]
        for t in new:
            self.vocab[t] = self.size
            self.size += 1
        self.SPECIALS = self.SPECIALS + new
        return len(new)

    def convert_tokens_to_ids(self, token):
        return self.vocab[token]


def _cfg(c, image_size=384):
    """Llama 2 layers / 64 wide (GQA 4q/2kv) over a 1024-token vocabulary
    that holds the fake tokenizer's ids, SigLIP 2 layers / 32 wide; the
    ``dummy`` mixture's images are 384 x 384 (196 tokens each)."""
    return c.SpatialRGPTConfig(
        llm=c.LlamaConfig(vocab_size=1024, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=1024),
        vision=c.SiglipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
                                    image_size=image_size, patch_size=14),
        projector=c.ProjectorConfig(mm_hidden_size=32, hidden_size=64),
        region=c.RegionExtractorConfig(mm_hidden_size=32, hidden_size=64, ada_pool_size=4),
        mask_token_id=1009, depth_token_id=1010, model_max_length=1024,
    )


CFG, CFG_T = _cfg(jconfig), _cfg(tconfig)
TUNED = ("mm_projector", "region_extractor")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


LR = 1e-3  # 1_mm_align.sh's learning rate, every run's here


def _close_trained(got, want, what):
    """A trained tensor against the reference's: rtol 1e-4, and atol 1e-2
    of the lr.  Adam moves an element by about lr g / (|g| + eps): where g
    sits at f32's rounding floor (a sum that cancels), the step's size
    follows that rounding, and differs from the reference's by up to a few
    thousandths of the lr; the port's own CPU backward, whose index_put_
    sums in thread order, differs from itself there too."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-2 * LR, err_msg=what)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """The JAX package's initial weights of ``CFG``, and the composite
    directory its ``save_composite`` writes (safetensors)."""
    params = _np_tree(jax.jit(jvlm.init_params, static_argnums=1)(jax.random.PRNGKey(0), CFG))
    root = str(tmp_path_factory.mktemp("base"))
    jexport.save_composite(root, params, CFG)
    return root, params


@pytest.fixture
def jax_tokenizer(monkeypatch):
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", lambda *a, **k: HFFakeTokenizer())


# ---------------------------------------------------------------------------
# gradient accumulation against optax.MultiSteps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 3])
def test_multisteps_matches_optax(k):
    """6 micro steps: the parameters after each equal optax.MultiSteps'
    (averaged gradients, the inner AdamW on every k-th call, its schedule
    counting updates), and between updates they do not move at all."""
    import optax

    rng = np.random.default_rng(k)
    shapes = {"projector": {"w": (6, 5), "b": (5,)}, "region": {"w": (4, 3)}, "llm": {"w": (3, 3)}}
    tree = {lab: {n: rng.standard_normal(s).astype(np.float32) for n, s in leaves.items()} for lab, leaves in shapes.items()}
    ocfg = dict(learning_rate=1e-2, tune_language_model=False, lr_scheduler="cosine", total_steps=6, warmup_ratio=0.0,
                max_grad_norm=0.5)
    jtx = optax.MultiSteps(jopt.build_optimizer(tree, jopt.OptimizerConfig(**ocfg)), k)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jtx.init(jparams)
    model = _Modules(tree)
    tx = topt.MultiSteps(topt.build_optimizer(model, topt.OptimizerConfig(**ocfg)), k)
    for step in range(6):
        grads = {lab: {n: (3 * rng.standard_normal(s)).astype(np.float32) for n, s in leaves.items()}
                 for lab, leaves in shapes.items()}
        updates, jstate = jtx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        for lab, leaves in grads.items():
            for n, g in leaves.items():
                getattr(getattr(model, topt.MODULES[lab]), n).grad = torch.tensor(g)
        tx.step()
        assert tx.mini_step == int(jstate.mini_step) == (step + 1) % k
        acc = dict(zip((id(p) for g in tx.param_groups for p in g["params"]), tx.acc, strict=True))
        for lab in ("projector", "region"):  # the mean so far (zeros after an update)
            for n, a in jstate.acc_grads[lab].items():
                got_a = acc[id(getattr(getattr(model, topt.MODULES[lab]), n))]
                np.testing.assert_allclose(got_a.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7, err_msg=f"{lab}.{n}")
        assert tx.gradient_step == int(jstate.gradient_step) == (step + 1) // k
        for lab, leaves in jparams.items():
            for n, want in leaves.items():
                got = getattr(getattr(model, topt.MODULES[lab]), n).detach()
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7,
                                           err_msg=f"{lab}.{n} @ {step}")
                if lab == "llm" or (step + 1) % k:
                    assert torch.equal(got, before[f"{topt.MODULES[lab]}.{n}"]), f"{lab}.{n} moved at {step}"
                else:
                    assert not torch.equal(got, before[f"{topt.MODULES[lab]}.{n}"]), f"{lab}.{n} still at {step}"
    assert [g["count"] for g in tx.param_groups] == [6 // k] * 2
    with pytest.raises(ValueError):
        topt.MultiSteps(tx.inner, 0)


# ---------------------------------------------------------------------------
# the composite checkpoint and the builder
# ---------------------------------------------------------------------------


def _export(params, cfg=CFG):
    return {
        "vision_tower": jexport.export_siglip(params["vision"]),
        "mm_projector": jexport.export_projector(params["projector"], cfg.projector.projector_type),
        "region_extractor": jexport.export_region_extractor(params["region"]),
        "llm": jexport.export_llama(params["llm"]),
    }


def _assert_model_equals(model, named, exact=True):
    state = model.state_dict()
    for sub, sd in named.items():
        for name, a in sd.items():
            got = state[f"{sub}.{name}"].float().numpy()
            if exact:
                np.testing.assert_array_equal(got, np.asarray(a, np.float32), err_msg=f"{sub}.{name}")
            else:
                np.testing.assert_allclose(got, np.asarray(a, np.float32), rtol=1e-4, atol=1e-7, err_msg=f"{sub}.{name}")
    assert len(state) == sum(len(sd) for sd in named.values())


def test_composite_checkpoint_both_ways(base, tmp_path):
    """A split directory written by the port's ``save_composite``
    (``pytorch_model.bin``) loads through the JAX package's
    ``load_reference_checkpoint`` and the port's to equal weights, and the
    JAX package's own directory (safetensors) loads into the port; the
    prefixes the reference's converters tolerate load too."""
    root, params = base
    named = _export(params)
    model = tckpt.load_reference_checkpoint(root, CFG_T, "cpu", torch.float32)
    _assert_model_equals(model, named)
    out = str(tmp_path / "port")
    save_composite(out, model, CFG_T)
    assert sorted(os.listdir(os.path.join(out, "llm"))) == ["pytorch_model.bin"]
    back = jckpt.load_reference_checkpoint(out, CFG, dtype=jnp.float32)
    _assert_model_equals(tckpt.load_reference_checkpoint(out, CFG_T, "cpu", torch.float32), _export(_np_tree(back)))
    _assert_model_equals(model, _export(_np_tree(back)))
    # HF prefixes: llm without "model.", projector under "mm_projector."
    for sub, rename in (("llm", lambda k: k.removeprefix("model.")), ("mm_projector", lambda k: "mm_projector." + k)):
        sd = tckpt.load_state_dict(os.path.join(out, sub))
        torch.save({rename(k): v for k, v in sd.items()}, os.path.join(out, sub, "pytorch_model.bin"))
    _assert_model_equals(tckpt.load_reference_checkpoint(out, CFG_T, "cpu", torch.float32), named)
    with pytest.raises(FileNotFoundError):
        tckpt.load_state_dict(str(tmp_path))


def test_load_pretrained_model_grows_vocab_as_jax(base, tmp_path, monkeypatch):
    """The tokenizer lacks ``<mask>`` / ``<depth>``: both builders add them
    (ids 1009, 1010 past the 1009 stored rows), record the ids, and grow
    the embedding table and the LM head by two rows of the stored mean."""
    root, params = base
    specials = [s for s in FakeTokenizer.SPECIALS if s not in ("<mask>", "<depth>")]
    small = dict(params)
    small["llm"] = dict(params["llm"], embed_tokens=params["llm"]["embed_tokens"][:1009],
                        lm_head={"kernel": params["llm"]["lm_head"]["kernel"][:, :1009]})
    cfg = CFG.replace(llm=CFG.llm.__class__(**{**CFG.llm.__dict__, "vocab_size": 1009}), mask_token_id=-1,
                      depth_token_id=-1)
    d = str(tmp_path / "ckpt")
    jexport.save_composite(d, small, cfg)
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", lambda *a, **k: HFFakeTokenizer(specials))
    jtok, jparams, jcfg, jproc = jbuilder.load_pretrained_model(d, dtype=jnp.float32)
    ttok, model, tcfg, tproc = tbuilder.load_pretrained_model(d, "cpu", torch.float32, HFFakeTokenizer(specials))
    assert len(ttok) == len(jtok) == 1011
    assert (tcfg.mask_token_id, tcfg.depth_token_id, tcfg.num_extra_tokens) == \
        (jcfg.mask_token_id, jcfg.depth_token_id, jcfg.num_extra_tokens) == (1009, 1010, 2)
    assert tproc.size == jproc.size == 384
    emb, head = model.llm.model.embed_tokens.weight, model.llm.lm_head.weight
    assert emb.shape == head.shape == (1011, 64)
    np.testing.assert_allclose(emb.detach().numpy(), np.asarray(jparams["llm"]["embed_tokens"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(head.detach().numpy(), np.asarray(jparams["llm"]["lm_head"]["kernel"]).T, rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(emb[:1009].detach().numpy(), small["llm"]["embed_tokens"])
    # with the ids it needs already in the tokenizer, nothing grows
    _, model, cfg2, _ = tbuilder.load_pretrained_model(root, "cpu", torch.float32, HFFakeTokenizer())
    assert model.llm.model.embed_tokens.weight.shape[0] == 1024 and cfg2.num_extra_tokens == 0
    assert tbuilder.get_model_name_from_path("/runs/x/checkpoint-4/") == jbuilder.get_model_name_from_path(
        "/runs/x/checkpoint-4/") == "x_checkpoint-4"


# ---------------------------------------------------------------------------
# DPO
# ---------------------------------------------------------------------------

SMALL, SMALL_T = _cfg(jconfig, image_size=56), _cfg(tconfig, image_size=56)


def _pair(seed):
    """(chosen, rejected) batches of two samples: one prompt each (bos, the
    image, <mask> <depth>, text) and two answers of random text, numbered
    and packed as ``Collator`` does; both packages' inputs."""
    rng = np.random.default_rng(seed)
    prompts = [[1, IMAGE_TOKEN_INDEX, 1009, 1010] + list(rng.integers(3, 900, 8)) for _ in range(2)]
    pix = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    masks = (rng.random((2, 2, 56, 56)) > 0.5).astype(np.float32)
    valid = np.ones((2, 2), bool)
    groups = []
    for _ in range(2):
        rows = []
        for i, p in enumerate(prompts):
            ans = list(rng.integers(3, 900, int(rng.integers(4, 9))))
            sb = expand_rows([np.asarray(p + ans, np.int64)], [np.asarray([IGNORE_INDEX] * len(p) + ans, np.int64)],
                             max_len=32, tokens_per_image=4, mask_token_id=1009, depth_token_id=1010,
                             regions_per_image=2)
            sb.image_gather_idx[sb.is_image] += 4 * i
            sb.mask_slot[sb.is_mask] += 2 * i
            sb.depth_slot[sb.is_depth] += 2 * i
            rows.append(sb)
        sb = pack_rows(rows, max_len=32)
        groups.append((tvlm.VLMInputs.from_spliced(sb, pix, pix, masks, valid, "cpu"),
                       to_vlm_inputs(sb, pix, pix, masks, valid)))
    return groups


@pytest.fixture(scope="module")
def small_params():
    return _np_tree(jax.jit(jvlm.init_params, static_argnums=1)(jax.random.PRNGKey(1), SMALL))


def _reward_atol(model, beta, *batches):
    """A reward is beta (pi - ref): a difference of two sums held to rtol
    1e-5 each, so its error is relative to beta |pi|, not to the reward."""
    with torch.no_grad():
        return 1e-5 * beta * max(float(tdpo.sequence_logprob(model, SMALL_T, b).abs().max()) for b in batches)


def test_sequence_logprob_and_dpo_loss_match_jax(small_params):
    ref_params = jax.tree.map(lambda a: a * np.float32(1.01), small_params)
    (c, jc), (r, jr) = _pair(0)
    policy, ref = load_from_jax(small_params, SMALL_T, "cpu"), load_from_jax(ref_params, SMALL_T, "cpu")
    want = jax.jit(jdpo.sequence_logprob, static_argnums=1)(small_params, SMALL, jc)
    got = tdpo.sequence_logprob(policy, SMALL_T, c)
    assert got.shape == (2,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    jloss, jm = jax.jit(jdpo.dpo_loss, static_argnums=2)(small_params, ref_params, SMALL, jc, jr, 0.5)
    loss, m = tdpo.dpo_loss(policy, ref, SMALL_T, c, r, beta=0.5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert m.keys() == jm.keys()
    reward_atol = _reward_atol(policy, 0.5, c, r)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=reward_atol, err_msg=k)
    assert abs(float(jm["chosen_reward"])) > 100 * reward_atol  # the two models differ


def test_dpo_steps_match_jax_and_resume_keeps_reference(small_params, tmp_path):
    """Two DPO steps with the stage-1 tune flags: metrics and the tuned
    parameters equal ``make_dpo_step``'s, the frozen ones and the reference
    copy do not move; a ``DPOState`` resumed from a checkpoint gets the
    policy and optimizer back and keeps its live reference copy."""
    ocfg = dict(learning_rate=LR, total_steps=10, warmup_ratio=0.0, tune_language_model=False)
    jtx = jopt.build_optimizer(small_params, jopt.OptimizerConfig(**ocfg))
    jparams = jax.tree.map(jnp.asarray, small_params)
    jstate = jdpo.DPOState(jnp.asarray(0, jnp.int32), jparams, jax.tree.map(jnp.copy, jparams), jtx.init(jparams))
    jstep = jdpo.make_dpo_step(SMALL, jtx, beta=0.5)
    model = load_from_jax(small_params, SMALL_T, "cpu")
    tx = topt.build_optimizer(model, topt.OptimizerConfig(**ocfg))
    state = tdpo.DPOState(0, model, tdpo.reference_copy(model, tx), tx)
    assert state.ref_model.llm.model.embed_tokens.weight is model.llm.model.embed_tokens.weight  # frozen: shared
    assert state.ref_model.mm_projector.layers[2].weight is not model.mm_projector.layers[2].weight
    step = tdpo.make_dpo_step(SMALL_T, tx, beta=0.5, remat=True)
    ref_before = {n: p.clone() for n, p in state.ref_model.named_parameters()}
    for i in range(2):
        (c, jc), (r, jr) = _pair(10 + i)
        atol = _reward_atol(model, 0.5, c, r)
        jstate, jm = jstep(jstate, jc, jr)
        state, m = step(state, c, r)
        for k in jm:
            if k == "reward_accuracy" and i == 0:
                continue  # the sign of the reference's rounding noise: its policy is its reference
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=atol, err_msg=f"{k} @ {i}")
        if i == 0:
            assert float(m["dpo_loss"]) == pytest.approx(np.log(2), abs=1e-6)
            assert float(m["chosen_reward"]) == float(m["rejected_reward"]) == 0.0  # the policy is its reference
    assert state.step == 2
    _assert_model_equals(model, _export(_np_tree(jstate.params), SMALL), exact=False)
    for n, p in state.ref_model.named_parameters():
        assert torch.equal(p, ref_before[n]), n
    tcfg = ttrainer.TrainerConfig(output_dir=str(tmp_path), max_steps=4, report_to="none")
    ttrainer.Trainer(SMALL_T, tcfg, None, state, iter([])).save_checkpoint(2)
    fresh = load_from_jax(jax.tree.map(lambda a: a * np.float32(0.5), small_params), SMALL_T, "cpu")
    ftx = topt.build_optimizer(fresh, topt.OptimizerConfig(**ocfg))
    resumed = ttrainer.Trainer(SMALL_T, tcfg, None, tdpo.DPOState(0, fresh, state.ref_model, ftx), iter([]))
    assert resumed.load_checkpoint(str(tmp_path / "checkpoint-2")) == 2
    assert isinstance(resumed.state, tdpo.DPOState) and resumed.state.ref_model is state.ref_model
    for name in TUNED:
        for (n, p), q in zip(getattr(fresh, name).named_parameters(), getattr(model, name).parameters()):
            assert torch.equal(p, q), n
    assert ftx.state_dict()["param_groups"][0]["count"] == 2


# ---------------------------------------------------------------------------
# main against the JAX main
# ---------------------------------------------------------------------------

STAGE1 = [
    "--data_mixture", "dummy", "--conv_template", "llama_3", "--llm_preset", "llama3-8b",
    "--tune_vision_tower", "false", "--tune_mm_projector", "true", "--tune_language_model", "false",
    "--tune_region_extractor", "true", "--image_aspect_ratio", "resize", "--per_device_train_batch_size", "4",
    "--learning_rate", str(LR), "--model_max_length", "1024", "--save_steps", "2", "--save_total_limit", "1",
    "--logging_steps", "1", "--max_steps", "3", "--regions_per_image", "2", "--attn_impl", "xla",
    "--model_dtype", "float32",
]


def _pairs_file(tmp_path, n=6):
    """A DPO jsonl of ``n`` pairs over one PNG (the prompt carries the image
    and a region)."""
    img = tmp_path / "pair.png"
    Image.fromarray(np.random.default_rng(7).integers(0, 256, (48, 64, 3), dtype=np.uint8)).save(img)
    answers = ["a red cube", "two boxes", "the lamp", "the chair", "yes", "no", "2 meters", "10 meters"]
    rows = [{"prompt": f"What is <mask> <depth> next to, {i}?", "chosen": answers[i % 8],
             "rejected": answers[(i + 3) % 8], "image": str(img)} for i in range(n)]
    path = tmp_path / "pairs.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(path)


FLAG_SETS = {
    "stage1": [],
    "accumulate2": ["--gradient_accumulation_steps", "2"],
    "lora8": ["--lora_enable", "true", "--bits", "8", "--lora_r", "4", "--lora_alpha", "8"],
    "dpo": ["--dpo_enable", "true", "--per_device_train_batch_size", "2"],
    "wandb": ["--report_to", "wandb"],  # with wandb unimportable: metrics.jsonl alone, in both
}


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _split_state(root, sub, load):
    return {k: np.asarray(v.float() if hasattr(v, "float") else v, np.float32)
            for k, v in load(os.path.join(root, sub)).items()}


@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
def test_main_matches_jax_main(base, tmp_path, monkeypatch, jax_tokenizer, flags):
    """``main`` and the JAX ``main`` on one composite directory: the same
    per-step losses and gradient norms, and the same trained parameters at
    the end (the composite's tuned modules; LoRA's ``adapter.npz`` and
    ``non_lora_trainables.npz``); the frozen modules bit-unchanged."""
    root, params = base
    argv = STAGE1 + ["--model_name_or_path", root] + FLAG_SETS[flags]
    if flags == "dpo":
        argv += ["--dpo_data_path", _pairs_file(tmp_path)]
    if flags == "lora8":  # the same adapter initialisation: the reference's draw, carried across
        drawn = {}
        jinit = jlora.init_lora

        def record(*a, **k):
            out = jinit(*a, **k)
            drawn["adapters"] = _np_tree(out)  # the JAX step donates the buffers it is given
            return out

        monkeypatch.setattr(jlora, "init_lora", record)
        monkeypatch.setattr(tlora, "init_lora", lambda llm, lcfg, generator, dtype: load_adapters_from_jax(
            drawn["adapters"], "cpu", dtype))
    if flags == "wandb":
        monkeypatch.setitem(sys.modules, "wandb", None)  # ``import wandb`` raises ImportError
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jtrain.main(argv + ["--output_dir", jout])
    got = ttrain.main(argv + ["--output_dir", tout], device="cpu", tokenizer=HFFakeTokenizer())
    assert got == want == {"status": "completed", "step": 3}
    jm, tm = _metrics(jout), _metrics(tout)
    assert [r["step"] for r in tm] == [r["step"] for r in jm] == [1, 2, 3]
    for a, b in zip(tm, jm):
        assert a.keys() == b.keys()
        for k in b:
            if k not in ("step", "time"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5 if "loss" in k else 1e-4, atol=1e-6, err_msg=k)
    if flags == "lora8":
        jad, tad = jckpt.load_pytree(os.path.join(jout, "adapter.npz")), tckpt.load_pytree(os.path.join(tout, "adapter.npz"))
        assert {int(tad["config"]["r"]), float(tad["config"]["alpha"])} == {4, 8.0}
        assert sorted(tad["adapters"]) == sorted(llama_module_name(p) for p in jad["adapters"])
        moved = 0
        for path, node in jad["adapters"].items():
            for leaf in ("a", "b"):
                got_a = tad["adapters"][llama_module_name(path)][leaf]
                _close_trained(got_a, node[leaf], f"{path} {leaf}")
            moved += bool(np.any(np.asarray(node["b"]) != 0))
        assert moved == len(jad["adapters"])
        jnon, tnon = (jckpt.load_pytree(os.path.join(jout, "non_lora_trainables.npz")),
                      tckpt.load_pytree(os.path.join(tout, "non_lora_trainables.npz")))
        want_sd = {"mm_projector": jexport.export_projector(_np_tree(jnon["projector"])),
                   "region_extractor": jexport.export_region_extractor(_np_tree(jnon["region"]))}
        assert sorted(tnon) == sorted(want_sd)
        for sub, sd in want_sd.items():
            assert sorted(tnon[sub]) == sorted(sd)
            for name, a in sd.items():
                _close_trained(tnon[sub][name], a, f"{sub}.{name}")
        return
    for sub in ("vision_tower", "mm_projector", "region_extractor", "llm"):
        a, b = _split_state(tout, sub, tckpt.load_state_dict), _split_state(jout, sub, jckpt.load_state_dict)
        start = _split_state(root, sub, jckpt.load_state_dict)
        assert a.keys() == b.keys() == start.keys()
        for name in b:
            if sub in TUNED:
                _close_trained(a[name], b[name], f"{sub}.{name}")
            else:
                np.testing.assert_array_equal(a[name], start[name], err_msg=f"{sub}.{name}")
    # the tuned modules did train
    assert any(not np.array_equal(v, _split_state(root, "mm_projector", jckpt.load_state_dict)[k])
               for k, v in _split_state(tout, "mm_projector", tckpt.load_state_dict).items())


@pytest.fixture
def deterministic():
    """PyTorch's deterministic algorithms: the CPU backward of the splice's
    gathers (index_put_ with accumulate) otherwise sums in thread order."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def test_main_resumes_mid_accumulation_bit_equal(base, tmp_path, deterministic):
    """``--gradient_accumulation_steps 2``: a run stopped by its time limit
    after micro step 1 (the accumulator half full) and resumed in the same
    output directory ends bit-equal to an uninterrupted run of 4 micro
    steps; the checkpoint holds the accumulator."""
    root, _ = base
    argv = STAGE1 + ["--model_name_or_path", root, "--gradient_accumulation_steps", "2", "--max_steps", "4"]
    run = lambda out, *extra: ttrain.main(argv + ["--output_dir", str(out), *extra], device="cpu",  # noqa: E731
                                          tokenizer=HFFakeTokenizer())
    assert run(tmp_path / "straight") == {"status": "completed", "step": 4}
    stopped = run(tmp_path / "resumed", "--total_time_limit", "1", "--pre_terminate_time", "1")
    assert stopped == {"status": "timeout", "step": 1}
    opt = torch.load(tmp_path / "resumed" / "checkpoint-1" / "opt.pt")
    assert opt["mini_step"] == 1 and opt["gradient_step"] == 0 and any(bool(a.any()) for a in opt["acc"])
    assert run(tmp_path / "resumed") == {"status": "completed", "step": 4}
    assert [r["step"] for r in _metrics(tmp_path / "resumed")] == [1, 2, 3, 4]
    for sub in TUNED:
        a = tckpt.load_state_dict(str(tmp_path / "straight" / sub))
        b = tckpt.load_state_dict(str(tmp_path / "resumed" / sub))
        assert a.keys() == b.keys()
        for name in a:
            assert torch.equal(a[name], b[name]), f"{sub}.{name}"


def test_main_without_model_dir_initialises_from_preset(monkeypatch, tmp_path):
    """No model directory: the config comes from ``--llm_preset`` (here a
    tiny one, patched in) and the weights from ``init_random``; the
    tokenizer is the caller's."""
    monkeypatch.setattr(ttrain, "preset", lambda name: CFG_T.replace(mask_token_id=-1, depth_token_id=-1))
    out = tmp_path / "run"
    got = ttrain.main(STAGE1 + ["--output_dir", str(out), "--dataloader_prefetch", "0"], device="cpu",
                      tokenizer=HFFakeTokenizer())
    assert got == {"status": "completed", "step": 3}
    losses = [r["loss"] for r in _metrics(out)]
    assert all(np.isfinite(losses)) and abs(losses[0] - np.log(1024)) < 1.0
    assert sorted(os.listdir(out)) == ["checkpoint-2", "config.json", "llm", "metrics.jsonl", "mm_projector",
                                       "region_extractor", "vision_tower"]


@pytest.mark.parametrize("flag", ttrain.PARALLEL_FLAGS)
def test_main_refuses_meshes(flag):
    """A degree above 1 in one process without a process group (the mesh
    itself runs in tests/test_torch_parallel_train.py)."""
    with pytest.raises(RuntimeError, match="needs a process group"):
        ttrain.main(STAGE1 + [f"--{flag}", "2"], device="cpu")


def test_main_needs_a_card_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(STAGE1)
