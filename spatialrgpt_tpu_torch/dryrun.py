"""Multi-rank dryrun: the twin of ``__graft_entry__.py::dryrun_multichip``.

    python -m spatialrgpt_tpu_torch.dryrun N [--device cpu]

runs, on N ranks of one process group (``parallel/launch.py::run_ranks``:
NCCL with one card a rank, which needs N cards; gloo on the CPU when asked
for with ``--device cpu``, never as a fallback), the reference's items on
the tiny composite of ``tiny_cfg``, and prints one JSON line per item:

  - ``train_step``: the full train step (FSDP2 over a dp x fsdp x sp mesh,
    Ulysses attention over sp);
  - ``tp_generate`` and ``tp_engine``: ``generate`` and the
    ``ServingEngine`` at tp = 2 (N even);
  - ``ring_prefill``: generate with the ring prefill over sp = 2 (N even);
  - ``pipeline``: the pipelined decoder's forward and gradients at pp = 4
    (N a multiple of 4);
  - ``hybrid_step``: the train step with Ulysses x ring at 2 x 2 over a
    dp x fsdp = 2 x (2 x 2) mesh (N a multiple of 8).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def tiny_cfg(vocab: int = 128, sp_heads: int = 4):
    """``__graft_entry__._tiny_cfg`` in the port's config classes."""
    from spatialrgpt_tpu_torch.config import (
        LlamaConfig, ProjectorConfig, RegionExtractorConfig, SiglipVisionConfig, SpatialRGPTConfig,
    )

    return SpatialRGPTConfig(
        llm=LlamaConfig(vocab_size=vocab, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                        num_attention_heads=sp_heads, num_key_value_heads=sp_heads // 2, max_position_embeddings=512),
        vision=SiglipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
                                  image_size=56, patch_size=14),
        projector=ProjectorConfig(mm_hidden_size=32, hidden_size=64),
        region=RegionExtractorConfig(mm_hidden_size=32, hidden_size=64, ada_pool_size=4),
        mask_token_id=120, depth_token_id=121, model_max_length=512,
    )


TOKENS_PER_IMAGE = 4


def tiny_batch(cfg, device, B: int = 2, S: int = 64, n_regions: int = 2, seed: int = 0):
    """``__graft_entry__._tiny_batch``: one image a row, its depth and
    ``n_regions`` masks, 40 random text tokens, labels on the text."""
    from spatialrgpt_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    from spatialrgpt_tpu_torch.data.splice import expand_rows
    from spatialrgpt_tpu_torch.models.vlm import VLMInputs

    rng = np.random.default_rng(seed)
    rows, labels = [], []
    for b in range(B):
        ids = [5 + b, IMAGE_TOKEN_INDEX, cfg.mask_token_id, cfg.depth_token_id] + list(rng.integers(1, 100, 40))
        rows.append(np.asarray(ids, np.int64))
        labels.append(np.asarray([IGNORE_INDEX] * 4 + list(ids[4:]), np.int64))
    sb = expand_rows(rows, labels, max_len=S, tokens_per_image=TOKENS_PER_IMAGE, mask_token_id=cfg.mask_token_id,
                     depth_token_id=cfg.depth_token_id, regions_per_image=n_regions, pad_to=S)
    size = cfg.vision.image_size
    return VLMInputs.from_spliced(
        sb, rng.standard_normal((B, size, size, 3)).astype(np.float32),
        rng.standard_normal((B, size, size, 3)).astype(np.float32),
        (rng.random((B, n_regions, size, size)) > 0.5).astype(np.float32), np.ones((B, n_regions), bool), device)


def _train_step(cfg, device, mesh, attn_impl, rows):
    import torch

    from spatialrgpt_tpu_torch.train.optimizer import OptimizerConfig, build_optimizer
    from spatialrgpt_tpu_torch.train.step import batch_shardings, create_train_state, make_train_step, shard_state
    from spatialrgpt_tpu_torch.utils.weights import init_random

    model = init_random(cfg, device, torch.float32, seed=0)
    optimizer = build_optimizer(model, OptimizerConfig(total_steps=10, tune_vision_tower=True))
    state = shard_state(create_train_state(model, optimizer), mesh)
    batch = batch_shardings(mesh, tiny_batch(cfg, device, B=rows, S=64), TOKENS_PER_IMAGE)
    state, metrics = make_train_step(cfg, optimizer, attn_impl=attn_impl)(state, batch)
    return {k: float(v) for k, v in metrics.items()}


def _serving_batch(cfg, device):
    batch = tiny_batch(cfg, device, B=2, S=64)
    return batch, batch.segment_ids.sum(dim=1)


def _engine_requests(cfg, device):
    """The reference dryrun's two engine requests."""
    from spatialrgpt_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from spatialrgpt_tpu_torch.data.splice import expand_rows
    from spatialrgpt_tpu_torch.models.vlm import VLMInputs

    rng = np.random.default_rng(0)
    size = cfg.vision.image_size
    out = []
    for pids in ([5, IMAGE_TOKEN_INDEX, cfg.mask_token_id, 8], [9, IMAGE_TOKEN_INDEX, 11, 12, 13]):
        sb = expand_rows([np.asarray(pids, np.int64)], None, max_len=64, tokens_per_image=TOKENS_PER_IMAGE,
                         mask_token_id=cfg.mask_token_id, depth_token_id=cfg.depth_token_id, regions_per_image=2,
                         pad_to=32)
        inputs = VLMInputs.from_spliced(
            sb, rng.standard_normal((1, size, size, 3)).astype(np.float32),
            rng.standard_normal((1, size, size, 3)).astype(np.float32),
            (rng.random((1, 2, size, size)) > 0.5).astype(np.float32), np.ones((1, 2), bool), device)
        out.append((inputs, int(sb.segment_ids.sum())))
    return out


def rank_main(n: int, device_type: str) -> list:
    """Every item on this rank; returns the JSON lines (rank 0's are
    printed)."""
    import torch
    import torch.distributed as dist

    from spatialrgpt_tpu_torch.parallel import mesh as mesh_lib
    from spatialrgpt_tpu_torch.parallel.context import SPContext, default_inner_impl, set_sp_context
    from spatialrgpt_tpu_torch.serving.engine import ServingEngine
    from spatialrgpt_tpu_torch.serving.generate import generate
    from spatialrgpt_tpu_torch.utils.weights import init_random

    device = torch.device(device_type, dist.get_rank()) if device_type == "cuda" else torch.device("cpu")
    cfg = tiny_cfg(sp_heads=4)
    lines = []
    kw = dict(max_new_tokens=2, temperature=0.0, eos_token_id=-1)

    # the full train step over dp x fsdp x sp, Ulysses over sp
    sp = 2 if n % 2 == 0 else 1
    fsdp = 2 if (n // sp) % 2 == 0 else 1
    dp = n // sp // fsdp
    mesh = mesh_lib.make_mesh(dp=dp, fsdp=fsdp, sp=sp)
    impl = "ulysses" if sp > 1 else "xla"
    set_sp_context(SPContext(mesh=mesh, ulysses_axis="sp", inner_impl=default_inner_impl(device)) if sp > 1 else None)
    metrics = _train_step(cfg, device, mesh, impl, rows=dp * fsdp * 2)
    set_sp_context(None)
    lines.append({"item": "train_step", "mesh": {"dp": dp, "fsdp": fsdp, "sp": sp}, "attn_impl": impl, **metrics})

    if n % 2 == 0:
        # tensor-parallel generate and engine at tp = 2
        tmesh = mesh_lib.make_mesh(dp=n // 2, tp=2)
        model = mesh_lib.tp_shard_model(init_random(cfg, device, torch.float32, seed=0), tmesh)
        batch, plens = _serving_batch(cfg, device)
        r = generate(model, cfg, batch, plens, attn_impl="xla", **kw)
        lines.append({"item": "tp_generate", "tp": 2, "tokens": r.tokens.tolist()})
        eng = ServingEngine(init_random(cfg, device, torch.float32, seed=0), cfg, num_slots=2, prompt_bucket=32,
                            max_new_tokens=3, kv_quant=True, mesh=tmesh, attn_impl="xla")
        for inputs, plen in _engine_requests(cfg, device):
            eng.submit(inputs, plen, max_new_tokens=3)
        done = eng.run_until_drained(max_steps=20)
        lines.append({"item": "tp_engine", "tp": 2, "tokens": sorted([d.request_id, d.tokens] for d in done)})

        # the ring prefill over sp = 2, decode on the replicated path
        smesh = mesh_lib.make_mesh(dp=n // 2, sp=2)
        set_sp_context(SPContext(mesh=smesh, ring_axis="sp"))
        r = generate(init_random(cfg, device, torch.float32, seed=0), cfg, batch, plens, attn_impl="ring", **kw)
        set_sp_context(None)
        lines.append({"item": "ring_prefill", "sp": 2, "tokens": r.tokens.tolist()})

    if n % 4 == 0:
        # the GPipe schedule at pp = 4: forward and gradients
        import dataclasses

        from torch.distributed.device_mesh import init_device_mesh

        from spatialrgpt_tpu_torch.models.llama import LlamaForCausalLM
        from spatialrgpt_tpu_torch.parallel.pipeline import pipeline_logits, pp_shard_params
        from spatialrgpt_tpu_torch.utils.weights import _init_random_modules

        pcfg = dataclasses.replace(cfg.llm, num_hidden_layers=4)
        llm = LlamaForCausalLM(pcfg).to(device)
        with torch.no_grad():
            _init_random_modules(llm, torch.Generator(device=device).manual_seed(7))
        pmesh = init_device_mesh(mesh.device_type, (n // 4, 4), mesh_dim_names=("dp", "pp"))
        pp_shard_params(llm, pmesh)
        ids = torch.as_tensor(np.random.default_rng(7).integers(0, pcfg.vocab_size, (4, 16)), device=device)
        pos = torch.arange(16, device=device).expand(4, 16)
        out = pipeline_logits(llm, pcfg, input_ids=ids, position_ids=pos, mesh=pmesh, num_microbatches=4)
        out.square().sum().backward()
        gnorm = float(sum(p.grad.float().square().sum() for p in llm.model.layers.parameters()) ** 0.5)
        lines.append({"item": "pipeline", "pp": 4, "logits_shape": list(out.shape), "stage_grad_norm": gnorm})

    if n % 8 == 0:
        # the hybrid Ulysses x ring step at 2 x 2
        hmesh = mesh_lib.make_hybrid_mesh(dp=n // 8, fsdp=2, sp_ulysses=2, sp_ring=2)
        set_sp_context(SPContext(mesh=hmesh, ulysses_axis="sp_u", ring_axis="sp_r",
                                 inner_impl=default_inner_impl(device)))
        metrics = _train_step(cfg, device, hmesh, "hybrid", rows=(n // 8) * 2 * 2)
        set_sp_context(None)
        lines.append({"item": "hybrid_step", "mesh": {"dp": n // 8, "fsdp": 2, "sp_u": 2, "sp_r": 2}, **metrics})
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="the multi-rank dryrun")
    parser.add_argument("n", type=int, nargs="?", default=8, help="ranks")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda: NCCL, one card a rank; cpu: gloo")
    parser.add_argument("--timeout", type=float, default=600.0, help="seconds before the ranks are killed")
    args = parser.parse_args(argv)
    from spatialrgpt_tpu_torch.parallel.launch import run_ranks

    lines = run_ranks(rank_main, args.n, args.n, args.device, device=args.device, timeout_s=args.timeout)[0]
    for line in lines:
        print(json.dumps({"n": args.n, **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
