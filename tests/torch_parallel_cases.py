"""The multi-rank side of the port's parallel tests (``test_torch_sp.py``,
``test_torch_tp.py``, ``test_torch_parallel_train.py``).

Each group of gloo ranks runs ``run_group(cases)`` once
(``spatialrgpt_tpu_torch/parallel/launch.py::run_ranks``); every case is a
function of this module called on every rank with its keyword arguments,
and its result (numpy arrays, or the traceback of its error) is kept per
rank under the case's name.  This module imports torch and the port only:
the spawned ranks never import JAX.  The tests hold the results to the
JAX package in their own process.
"""

from __future__ import annotations

import traceback

import numpy as np
import torch
import torch.distributed as dist

from spatialrgpt_tpu_torch.parallel import mesh as mesh_lib
from spatialrgpt_tpu_torch.parallel.context import SPContext, set_sp_context

TIMEOUT_S = 240.0


def run_group(cases):
    """``cases``: [(name, function name, kwargs)] -> {name: result}; a case
    that raises records {"error": traceback} (every rank raises alike, so
    the group goes on)."""
    out = {}
    for name, fn, kw in cases:
        try:
            out[name] = globals()[fn](**kw)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
        finally:
            set_sp_context(None)
        dist.barrier()
    return out


def spawn(world: int, cases, workdir):
    """Rank r's results, for r in range(world)."""
    import os

    from spatialrgpt_tpu_torch.parallel.launch import run_ranks

    if workdir is not None:
        os.makedirs(workdir, exist_ok=True)
    return run_ranks(run_group, world, cases, device="cpu", timeout_s=TIMEOUT_S,
                     workdir=None if workdir is None else str(workdir))


def _np(t):
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().float().cpu().numpy()


# ---------------------------------------------------------------------------
# sequence-parallel attention
# ---------------------------------------------------------------------------


def sp_attention(kind: str, q, k, v, seg, ulysses: int = 1):
    """One sequence-parallel attention over the whole group on this rank's
    chunk of q, k, v (B, S, H, D) numpy, laid out as ``kind`` needs; sum of
    squares backward.  Returns (positions held, out, dq, dk, dv)."""
    from spatialrgpt_tpu_torch.parallel import hybrid, ring, ulysses as uly

    world = dist.get_world_size()
    S = q.shape[1]
    perm = np.arange(S)
    if kind == "stripe":
        perm = ring.stripe_permutation(S, world)[0]
    elif kind == "zigzag":
        perm = ring.zigzag_permutation(S, world)[0]
    if kind == "hybrid":
        mesh = mesh_lib.make_hybrid_mesh(sp_ulysses=ulysses, sp_ring=world // ulysses)
        chunk = mesh.get_local_rank("sp_r") * ulysses + mesh.get_local_rank("sp_u")
    else:
        chunk = dist.get_rank()
    n = S // world
    held = perm[chunk * n : (chunk + 1) * n]
    ql, kl, vl = (torch.tensor(t[:, held]).requires_grad_(True) for t in (q, k, v))
    sg = torch.tensor(seg[:, held])
    group = dist.group.WORLD
    if kind == "ring":
        out = ring.ring_attention(ql, kl, vl, sg, group=group)
    elif kind == "stripe":
        out = ring.stripe_ring_attention(ql, kl, vl, sg, group=group)
    elif kind == "zigzag":
        out = ring.zigzag_ring_attention(ql, kl, vl, sg, group=group)
    elif kind == "ulysses":
        out = uly.ulysses_attention(ql, kl, vl, sg, group)
    else:
        out = hybrid.hybrid_attention(ql, kl, vl, sg, mesh.get_group("sp_u"), mesh.get_group("sp_r"))
    out.square().sum().backward()
    return held, _np(out), _np(ql.grad), _np(kl.grad), _np(vl.grad)


def ulysses_bad_heads(q, k, v, seg):
    """Ulysses at a degree that does not divide the kv heads must raise the
    reference's ValueError."""
    from spatialrgpt_tpu_torch.parallel.ulysses import ulysses_attention

    try:
        ulysses_attention(*(torch.tensor(t) for t in (q, k, v, seg)), dist.group.WORLD)
    except ValueError as e:
        return str(e)
    return "no error"


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


def tiny_cfg(c=None, intermediate: int = 128, vocab: int = 128, **llm):
    """``__graft_entry__._tiny_cfg`` (4 q heads, 2 kv heads; tp = 2 and a
    Ulysses degree of 2 divide both) in the port's config classes;
    ``intermediate`` 1024 gives FSDP matrices to shard."""
    if c is None:
        from spatialrgpt_tpu_torch import config as c
    return c.SpatialRGPTConfig(
        llm=c.LlamaConfig(vocab_size=vocab, hidden_size=64, intermediate_size=intermediate, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512, **llm),
        vision=c.SiglipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
                                    image_size=56, patch_size=14),
        projector=c.ProjectorConfig(mm_hidden_size=32, hidden_size=64),
        region=c.RegionExtractorConfig(mm_hidden_size=32, hidden_size=64, ada_pool_size=4),
        mask_token_id=120, depth_token_id=121, model_max_length=512,
    )


def tiny_batch_arrays(cfg, B: int = 2, S: int = 64, seed: int = 0, n_regions: int = 2):
    """``__graft_entry__._tiny_batch``'s arrays: (spliced batch, images,
    depths, masks, mask_valid), numpy."""
    from spatialrgpt_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    from spatialrgpt_tpu_torch.data.splice import expand_rows

    rng = np.random.default_rng(seed)
    rows, labels = [], []
    for b in range(B):
        ids = [5 + b, IMAGE_TOKEN_INDEX, cfg.mask_token_id, cfg.depth_token_id] + list(rng.integers(1, 100, 40))
        rows.append(np.asarray(ids, np.int64))
        labels.append(np.asarray([IGNORE_INDEX] * 4 + list(ids[4:]), np.int64))
    sb = expand_rows(rows, labels, max_len=S, tokens_per_image=4, mask_token_id=cfg.mask_token_id,
                     depth_token_id=cfg.depth_token_id, regions_per_image=n_regions, pad_to=S)
    size = cfg.vision.image_size
    return (sb, rng.standard_normal((B, size, size, 3)).astype(np.float32),
            rng.standard_normal((B, size, size, 3)).astype(np.float32),
            (rng.random((B, n_regions, size, size)) > 0.5).astype(np.float32), np.ones((B, n_regions), bool))


def _inputs(arrays):
    from spatialrgpt_tpu_torch.models.vlm import VLMInputs

    return VLMInputs.from_spliced(*arrays, device="cpu")


def _model(params, cfg):
    from spatialrgpt_tpu_torch.utils.weights import load_from_jax

    return load_from_jax(params, cfg, "cpu")


def _tokens(model, cfg, arrays, **kw):
    from spatialrgpt_tpu_torch.serving.generate import generate

    inputs = _inputs(arrays)
    r = generate(model, cfg, inputs, inputs.segment_ids.sum(dim=1), temperature=0.0, eos_token_id=-1, **kw)
    return r.tokens.numpy()


def fsdp_generate(params, cfg, arrays, max_new: int):
    """Greedy tokens of ``generate`` on FSDP-sharded parameters (fsdp over
    the whole group)."""
    model = _model(params, cfg)
    mesh_lib.shard_model(model, mesh_lib.make_mesh(fsdp=dist.get_world_size()))
    sharded = sum(hasattr(p, "device_mesh") for p in model.parameters())
    return {"tokens": _tokens(model, cfg, arrays, max_new_tokens=max_new, attn_impl="xla"), "sharded": sharded}


def tp_generate(params, cfg, arrays, max_new: int, kv_quant: bool = False, quant: str = ""):
    """Greedy tokens of ``generate`` on a tensor-parallel model (tp over the
    whole group); ``quant``: "int8" (weight-only) or "w8a8" decoder."""
    from spatialrgpt_tpu_torch.ops.layers import quantize_model

    model = _model(params, cfg)
    if quant:
        quantize_model(model, bits=8, act_quant=quant == "w8a8")
    mesh_lib.tp_shard_model(model, mesh_lib.make_mesh(tp=dist.get_world_size()))
    heads = model.llm.model.layers[0].self_attn.q_proj.out_features // cfg.llm.head_dim
    return {"tokens": _tokens(model, cfg, arrays, max_new_tokens=max_new, attn_impl="xla", kv_quant=kv_quant),
            "local_q_heads": heads}


def tp_moe_logits(llm_sd, cfg_kw, ids):
    """``forward_logits`` of a sparse-MoE decoder (stacked experts) under
    tp over the whole group."""
    from spatialrgpt_tpu_torch.config import LlamaConfig
    from spatialrgpt_tpu_torch.models import llama

    cfg = LlamaConfig(**cfg_kw)
    model = llama.LlamaForCausalLM(cfg)
    model.load_state_dict({k: torch.tensor(v) for k, v in llm_sd.items()})
    llama.stack_experts(model)
    mesh_lib.tp_shard_model(model, mesh_lib.make_mesh(tp=dist.get_world_size()))
    ids = torch.tensor(ids)
    pos = torch.arange(ids.shape[1]).expand(*ids.shape)
    with torch.no_grad():
        return _np(llama.forward_logits(model, cfg, input_ids=ids, position_ids=pos))


def tp_engine(params, cfg, requests, max_new: int, kv_quant: bool, prefill_chunk: int = 0):
    """The ``ServingEngine`` with a tp mesh over the whole group (with
    ``prefill_chunk``, the fused chunked prefill: two rows in flight, their
    staging holding this rank's kv heads): tokens by request, greedy."""
    from spatialrgpt_tpu_torch.serving.engine import ServingEngine

    eng = ServingEngine(_model(params, cfg), cfg, num_slots=2, prompt_bucket=32, max_new_tokens=max_new,
                        attn_impl="xla", kv_quant=kv_quant, dtype=torch.float32, prefill_chunk=prefill_chunk,
                        chunk_rows=2, mesh=mesh_lib.make_mesh(tp=dist.get_world_size()))
    for arrays, plen in requests:
        eng.submit(_inputs(arrays), plen, max_new_tokens=max_new)
    return sorted((r.request_id, list(r.tokens)) for r in eng.run_until_drained(max_steps=100))


def fan_in_quant(x):
    """A W8A8 fan-in slice's int8 columns and row scales at tp over the
    whole group (``ops/layers.py::_fan_in_quantized``: the rows' maxima
    all-reduced), this rank holding its columns of the bf16 rows x, and
    the same from the whole rows gathered, quantized and sliced."""
    from types import SimpleNamespace

    from spatialrgpt_tpu_torch.ops.int8_linear import act_quant_int8_plain
    from spatialrgpt_tpu_torch.ops.layers import _fan_in_quantized
    from spatialrgpt_tpu_torch.parallel.comm import all_gather_cat

    tp = mesh_lib.tp_group(mesh_lib.make_mesh(tp=dist.get_world_size()))
    x = torch.tensor(x).to(torch.bfloat16)
    K = x.shape[1] // tp.size
    mine = x[:, tp.rank * K : (tp.rank + 1) * K].contiguous()
    xq, scale = _fan_in_quantized(mine, SimpleNamespace(tp_fan_in=tp))
    whole_q, whole_scale = act_quant_int8_plain(all_gather_cat(mine, tp.group, dim=1))
    return {"xq": xq.numpy(), "scale": scale.numpy(), "gathered_xq": whole_q[:, tp.rank * K : (tp.rank + 1) * K].numpy(),
            "gathered_scale": whole_scale.numpy()}


def engine_bad_tp(params, cfg):
    """tp = world must divide the kv heads (else the reference's ValueError)."""
    from spatialrgpt_tpu_torch.serving.engine import ServingEngine

    try:
        ServingEngine(_model(params, cfg), cfg, mesh=mesh_lib.make_mesh(tp=dist.get_world_size()), attn_impl="xla")
    except ValueError as e:
        return str(e)
    return "no error"


def sp_generate(params, cfg, arrays, max_new: int, impl: str, ulysses: int = 1):
    """Greedy tokens of ``generate`` with the ``impl`` prefill over the
    whole group (hybrid: ``ulysses`` x the rest)."""
    world = dist.get_world_size()
    if impl == "hybrid":
        mesh = mesh_lib.make_hybrid_mesh(sp_ulysses=ulysses, sp_ring=world // ulysses)
        set_sp_context(SPContext(mesh=mesh, ulysses_axis="sp_u", ring_axis="sp_r"))
    else:
        mesh = mesh_lib.make_mesh(sp=world)
        set_sp_context(SPContext(mesh=mesh, **({"ring_axis": "sp"} if impl == "ring" else {"ulysses_axis": "sp"})))
    return _tokens(_model(params, cfg), cfg, arrays, max_new_tokens=max_new, attn_impl=impl)


def pipeline(llm_sd, cfg_kw, ids, pp_microbatches, remat: bool = False, grads: bool = False, sparse: bool = False):
    """``pipeline_logits`` at pp = world: the logits, and with ``grads``
    this stage's layer gradients of sum(logits**2) by global layer name."""
    from spatialrgpt_tpu_torch.config import LlamaConfig
    from spatialrgpt_tpu_torch.models import llama
    from spatialrgpt_tpu_torch.parallel.pipeline import make_pp_mesh, pipeline_logits, pp_shard_params

    cfg = LlamaConfig(**cfg_kw)
    model = llama.LlamaForCausalLM(cfg)
    model.load_state_dict({k: torch.tensor(v) for k, v in llm_sd.items()})
    if sparse:
        llama.stack_experts(model)
    world = dist.get_world_size()
    mesh = make_pp_mesh(world)
    pp_shard_params(model, mesh)
    ids = torch.tensor(ids)
    pos = torch.arange(ids.shape[1]).expand(*ids.shape)
    out = pipeline_logits(model, cfg, input_ids=ids, position_ids=pos, segment_ids=torch.ones_like(ids).int(),
                          mesh=mesh, num_microbatches=pp_microbatches, remat=remat)
    res = {"logits": _np(out)}
    if grads:
        out.square().sum().backward()
        per = cfg.num_hidden_layers // world
        res["grads"] = {f"model.layers.{dist.get_rank() * per + int(n.split('.')[0])}.{n.split('.', 1)[1]}": _np(p.grad)
                        for n, p in model.model.layers.named_parameters()}
    return res


# ---------------------------------------------------------------------------
# tensor-parallel run_bench
# ---------------------------------------------------------------------------


class CharTokenizer:
    """``tests/test_templates.py::FakeTokenizer`` (character ids, special
    strings single tokens, BOS prepended), kept here so that the ranks
    import nothing of the JAX package."""

    SPECIALS = ["<|begin_of_text|>", "<|start_header_id|>", "<|end_header_id|>", "<|eot_id|>", "<|end_of_text|>",
                "</s>", "<s>", "[/INST]", "[INST]", "<mask>", "<depth>"]

    class Tokens:
        def __init__(self, ids):
            self.input_ids = ids

    def __init__(self):
        self.vocab = {s: 1000 + i for i, s in enumerate(self.SPECIALS)}
        self.bos_token_id, self.eos_token_id, self.pad_token_id = 1, 2, 0
        self.model_max_length = 512

    def __call__(self, text, **kw):
        ids, i = [self.bos_token_id], 0
        while i < len(text):
            for s in self.SPECIALS:
                if text.startswith(s, i):
                    ids.append(self.vocab[s])
                    i += len(s)
                    break
            else:
                ids.append(3 + ord(text[i]) % 900)
                i += 1
        return self.Tokens(ids)

    def decode(self, ids, skip_special_tokens=False):
        inv = {v: k for k, v in self.vocab.items()}
        out = []
        for t in (int(t) for t in ids):
            if t in (self.bos_token_id, self.eos_token_id, self.pad_token_id) or t in inv:
                if not skip_special_tokens:
                    out.append(inv.get(t, f"<{t}>"))
            else:
                out.append(chr((t - 3) % 900))
        return "".join(out)


BENCH_IMAGES = {"a.jpg": (60, 80), "b.jpg": (72, 48)}


def bench_cfg_kw(root: str) -> dict:
    """A SpatialRGPT-Bench-shaped file of 2 entries (bbox regions, 1-2
    rounds) under ``root``, written once; the ``BenchConfig`` fields of a
    run over it (depth from the RGB image)."""
    import json
    import os

    from PIL import Image

    if not os.path.exists(os.path.join(root, "ann.json")):
        os.makedirs(os.path.join(root, "imgs"), exist_ok=True)
        rng = np.random.default_rng(0)
        for name, hw in BENCH_IMAGES.items():
            Image.fromarray(rng.integers(0, 256, (*hw, 3), np.uint8)).save(os.path.join(root, "imgs", name))
        entries = []
        for qid, fp, box, rounds in (("q0", "a.jpg", [20, 10, 50, 30], [("How wide is Region [0] <mask>?", "1 m"),
                                                                          ("How far is it?", "2 m")]),
                                     ("q1", "b.jpg", [4, 6, 40, 60], [("Is Region [0] <mask> left?", "Yes.")])):
            h, w = BENCH_IMAGES[fp]
            conv = []
            for i, (q, a) in enumerate(rounds):
                conv += [{"from": "human", "value": ("<image>\n" if i == 0 else "") + q}, {"from": "gpt", "value": a}]
            entries.append({"id": qid, "image_info": {"file_path": fp, "height": h, "width": w}, "text_q": rounds[0][0],
                            "qa_info": {"type": "quantitative", "category": "width_data"}, "bbox": [box],
                            "conversations": conv})
        with open(os.path.join(root, "ann.json.tmp"), "w") as f:
            json.dump(entries, f)
        os.replace(os.path.join(root, "ann.json.tmp"), os.path.join(root, "ann.json"))
    return dict(annotation_file=os.path.join(root, "ann.json"), image_folder=os.path.join(root, "imgs"),
                conv_mode="llama_3", batch_size=4, max_new_tokens=4, prompt_bucket=512, regions_per_image=2,
                depth_source="rgb")


def bench_model(params, cfg):
    from spatialrgpt_tpu_torch.data.preprocess import SiglipProcessor

    return CharTokenizer(), _model(params, cfg), cfg, SiglipProcessor(size=cfg.vision.image_size)


def tp_run_bench(params, cfg, root: str):
    """``run_bench`` with ``tp`` = the group's size; rank 0's answers."""
    import json
    import os

    from spatialrgpt_tpu_torch.eval import spatial_bench as sb

    if dist.get_rank() == 0:
        kw = bench_cfg_kw(root)
    dist.barrier()
    kw = bench_cfg_kw(root)
    bcfg = sb.BenchConfig(answers_file=os.path.join(root, "tp", "answers.jsonl"), tp=dist.get_world_size(), **kw)
    path = sb.run_bench(bcfg, model=bench_model(params, cfg), device="cpu")
    if dist.get_rank() != 0:
        return None
    with open(path) as f:
        return [json.loads(line) for line in f]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TOKENS_PER_IMAGE = 4


def sp_mesh(dp: int, fsdp: int, ulysses: int, ring: int):
    """The mesh of the train flags and its attention impl, the sp context
    set (``train/train.py::build_mesh``'s rule)."""
    if ulysses > 1 and ring > 1:
        mesh = mesh_lib.make_hybrid_mesh(dp, fsdp, ulysses, ring)
        set_sp_context(SPContext(mesh=mesh, ulysses_axis="sp_u", ring_axis="sp_r"))
        return mesh, "hybrid"
    mesh = mesh_lib.make_mesh(dp, fsdp, ulysses * ring)
    if ring > 1:
        set_sp_context(SPContext(mesh=mesh, ring_axis="sp"))
        return mesh, "ring"
    if ulysses > 1:
        set_sp_context(SPContext(mesh=mesh, ulysses_axis="sp"))
        return mesh, "ulysses"
    return mesh, "xla"


def train_state(params, cfg, ocfg_kw=None):
    """The port's model of ``params`` and its optimizer (the vision tower
    tuned too, so every module trains)."""
    from spatialrgpt_tpu_torch.train.optimizer import OptimizerConfig, build_optimizer
    from spatialrgpt_tpu_torch.train.step import create_train_state

    model = _model(params, cfg)
    ocfg = OptimizerConfig(**{"total_steps": 10, "tune_vision_tower": True, "warmup_ratio": 0.0,
                              **(ocfg_kw or {})})
    return create_train_state(model, build_optimizer(model, ocfg))


def grads_by_name(model) -> dict:
    """Every gradient, gathered whole, by parameter name."""
    return {n: _np(p.grad) for n, p in model.named_parameters() if p.grad is not None}


def train_step(params, cfg, arrays, dp: int = 1, fsdp: int = 1, ulysses: int = 1, ring: int = 1):
    """One train step over a (dp, fsdp, sp) mesh of the whole group: this
    rank's rows of the global batch (``batch_shardings``), FSDP2 over the
    model; returns the metrics, and the whole gradients and updated
    parameters on rank 0."""
    from spatialrgpt_tpu_torch.train.step import batch_shardings, make_train_step, shard_state

    mesh, impl = sp_mesh(dp, fsdp, ulysses, ring)
    state = shard_state(train_state(params, cfg), mesh)
    batch = batch_shardings(mesh, _inputs(arrays), TOKENS_PER_IMAGE)
    state, metrics = make_train_step(cfg, state.optimizer, attn_impl=impl)(state, batch)
    out = {"metrics": {k: float(v) for k, v in metrics.items()}, "impl": impl,
           "sharded": sum(hasattr(p, "device_mesh") for p in state.model.parameters())}
    grads = grads_by_name(state.model)
    new = {n: _np(p) for n, p in state.model.named_parameters()}
    if dist.get_rank() == 0:
        out.update(grads=grads, params=new)
    return out


def dpo_step(params, cfg, chosen, rejected, fsdp: int):
    """One DPO step with the model and its reference copy under FSDP over
    the whole group (``fsdp`` = the group's size), each rank its rows of
    the pairs; the metrics and rank 0's whole gradients."""
    from spatialrgpt_tpu_torch.train.dpo import DPOState, make_dpo_step, reference_copy
    from spatialrgpt_tpu_torch.train.step import batch_shardings, shard_state

    mesh = mesh_lib.make_mesh(fsdp=fsdp)
    st = train_state(params, cfg)
    state = shard_state(DPOState(0, st.model, reference_copy(st.model, st.optimizer), st.optimizer), mesh)
    batches = [batch_shardings(mesh, _inputs(a), TOKENS_PER_IMAGE) for a in (chosen, rejected)]
    state, metrics = make_dpo_step(cfg, state.optimizer)(state, *batches)
    grads = grads_by_name(state.model)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "ref_sharded": sum(hasattr(p, "device_mesh") for p in state.ref_model.parameters()),
            "grads": grads if dist.get_rank() == 0 else None}


def checkpoint_roundtrip(params, cfg, arrays, out_dir: str, backend: str, fsdp: int, load: bool):
    """At ``fsdp`` over the whole group (None: one process, no mesh): with
    ``load`` a checkpoint written elsewhere is loaded into a fresh state,
    else one step runs and is saved; returns the state's whole tensors
    (``Trainer._tree``) and its optimizer counters."""
    from spatialrgpt_tpu_torch.train.step import batch_shardings, make_train_step, shard_state
    from spatialrgpt_tpu_torch.train.trainer import Trainer, TrainerConfig

    mesh = None if fsdp is None else mesh_lib.make_mesh(fsdp=fsdp)
    state = train_state(params, cfg)
    if mesh is not None:
        state = shard_state(state, mesh)
    step = make_train_step(cfg, state.optimizer)
    tr = Trainer(cfg, TrainerConfig(output_dir=out_dir, ckpt_backend=backend, report_to="none"), step, state, [])
    if load:
        tr.load_checkpoint(f"{out_dir}/checkpoint-1")
    else:
        batch = _inputs(arrays) if mesh is None else batch_shardings(mesh, _inputs(arrays), TOKENS_PER_IMAGE)
        tr.state, _ = step(state, batch)
        tr.save_checkpoint(1)
    tree = {part: {n: _np(t) for n, t in ts.items()} for part, ts in tr._tree().items()}
    return {"tree": tree, "meta": tr._meta()}


class HFCharTokenizer(CharTokenizer):
    """``tests/test_torch_recipe.py::HFFakeTokenizer`` on ``CharTokenizer``:
    no BOS, a length, ``add_tokens`` and ``convert_tokens_to_ids``."""

    def __init__(self):
        super().__init__()
        self.size = 1000 + len(self.SPECIALS)

    def __call__(self, text, **kw):
        out = super().__call__(text, **kw)
        out.input_ids = out.input_ids[1:]
        return out

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


def train_main(argv, cfg, out_dir: str):
    """``train.main`` from argv on this group (its preset replaced by
    ``cfg``); the result and rank 0's logged metrics."""
    import json
    import os

    from spatialrgpt_tpu_torch.train import train as train_mod

    train_mod.preset = lambda name: cfg
    result = train_mod.main(argv + ["--output_dir", out_dir], device="cpu", tokenizer=HFCharTokenizer())
    metrics = None
    if dist.get_rank() == 0:
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
    return {"result": result, "metrics": metrics, "files": sorted(os.listdir(out_dir))}
