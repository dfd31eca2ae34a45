"""Training entry point (port of ``spatialrgpt_tpu/train/train.py``):
args -> model build or load -> freeze flags -> data -> train loop with
autoresume.  Run as

    python -m spatialrgpt_tpu_torch.train.train --output_dir ... --data_mixture ...

with the flags of the launch scripts (``scripts/srgpt/*/{1_mm_align,2_pretrain,3_sft}.sh``).

Every branch of the reference's ``main`` (``train.py:78-343``): the full
step with the modules the tune flags leave out frozen; LoRA / QLoRA over a
base quantized to ``--bits 8|4``, whose final save is ``adapter.npz`` and
``non_lora_trainables.npz``; DPO over ``PreferenceDataset``;
``--gradient_accumulation_steps`` (``optimizer.py::MultiSteps``);
``--dataloader_prefetch``; the time limit and pre-termination.
``--attn_impl pallas`` (the default) runs the decoder's attention on K4,
``xla`` on its plain version.

``main`` runs on the CUDA card unless the caller passes ``device`` (the
tests pass ``"cpu"``); with no card and no ``device`` it raises.  A caller
that has a tokenizer passes it; otherwise the model directory's tokenizer
is loaded (``models/builder.py``), or ``transformers.AutoTokenizer`` for a
name.

Meshes (reference ``train.py:82-105``): launched on N ranks (``torchrun
--nproc_per_node N -m spatialrgpt_tpu_torch.train.train ...``, or SLURM's
variables, ``parallel/mesh.py::init_distributed``; or a caller that made the
process group) with ``--dp_size`` x ``--fsdp_size`` x
``--seq_parallel_size`` x ``--seq_parallel_ring_size`` = N, ``main`` builds
the mesh and the sequence-parallel context as the reference does: the
hybrid mesh and ``hybrid`` attention when both sp degrees are above 1,
``ring`` when only the ring degree is, ``ulysses`` when only the Ulysses
degree is (its local attention K4 on the card under ``--attn_impl
pallas``).  The model and the optimizer state are FSDP-sharded
(``train/step.py::shard_state``), DPO's reference copy the same way; the
LoRA / QLoRA routes keep the model replicated and sum the gradients.  The
sampler's rank and replicas are the (dp, fsdp) coordinates, so the sp ranks
of a group load the same rows.  With every degree at 1 and no process
group, ``main`` is the single-process run.

One departure: ``make_batches`` walks the sampler for as many epochs as
``max_steps`` needs (``DistributedMixtureSampler.set_epoch`` each time),
where the reference's stops after one epoch; within the first epoch the two
give the same batches.
"""

from __future__ import annotations

import math
import os
import sys
from typing import Iterable

import numpy as np
import torch
from torch import nn

from spatialrgpt_tpu_torch.config import SpatialRGPTConfig, preset
from spatialrgpt_tpu_torch.data.dataset import Collator, CollatorConfig, build_datasets
from spatialrgpt_tpu_torch.data.sampler import DistributedMixtureSampler
from spatialrgpt_tpu_torch.models.vlm import VLMInputs
from spatialrgpt_tpu_torch.parallel import mesh as mesh_lib
from spatialrgpt_tpu_torch.parallel.context import SPContext, set_sp_context
from spatialrgpt_tpu_torch.train.args import parse_args
from spatialrgpt_tpu_torch.train.optimizer import MODULES, MultiSteps, OptimizerConfig, build_optimizer
from spatialrgpt_tpu_torch.train.step import create_train_state, make_lora_train_step, make_train_step, shard_state
from spatialrgpt_tpu_torch.train.trainer import Trainer, TrainerConfig
from spatialrgpt_tpu_torch.utils.device import card_device
from spatialrgpt_tpu_torch.utils.profiling import mprint



def build_config(margs, dargs, targs) -> SpatialRGPTConfig:
    cfg = preset(margs.llm_preset)
    return cfg.replace(
        enable_region=margs.enable_region,
        enable_depth=margs.enable_depth,
        image_aspect_ratio=dargs.image_aspect_ratio,
        model_max_length=targs.model_max_length,
    )


# the mesh's degrees (above 1 they need a process group)
PARALLEL_FLAGS = ("dp_size", "fsdp_size", "seq_parallel_size", "seq_parallel_ring_size")


def make_train_sampler(part_lens, batch_size: int, seed: int, mesh=None) -> DistributedMixtureSampler:
    """Each data-parallel rank feeds its own disjoint shard (the reference's
    VILADistributedSampler semantics); rank and replicas are the mesh's
    (dp, fsdp) coordinates (``data_parallel_rank``), so every sp rank of a
    group loads the same rows; without a mesh 0 and 1."""
    rank, world = mesh_lib.data_parallel_rank(mesh), mesh_lib.data_parallel_world(mesh)
    return DistributedMixtureSampler(part_lens, num_replicas=world, rank=rank, batch_size=batch_size, seed=seed)


def build_mesh(targs, device):
    """The mesh and the attention impl of the parallel flags (reference
    ``train.py:82-105``), the sp context set; (None, ``attn_impl``) on one
    process with every degree at 1."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        above = [f"--{flag} {getattr(targs, flag)}" for flag in PARALLEL_FLAGS if getattr(targs, flag) > 1]
        if not above:
            return None, targs.attn_impl
        raise RuntimeError(f"{', '.join(above)}: a mesh needs a process group; launch with torchrun (or SLURM), or "
                           "call parallel/mesh.py::init_distributed first")
    inner = "pallas" if torch.device(device).type == "cuda" and targs.attn_impl == "pallas" else "xla"
    u, r = targs.seq_parallel_size, targs.seq_parallel_ring_size
    if u > 1 and r > 1:
        mesh = mesh_lib.make_hybrid_mesh(targs.dp_size, targs.fsdp_size, u, r)
        set_sp_context(SPContext(mesh=mesh, ulysses_axis="sp_u", ring_axis="sp_r", inner_impl=inner))
        return mesh, "hybrid"
    mesh = mesh_lib.make_mesh(targs.dp_size, targs.fsdp_size, u * r)
    if r > 1:
        set_sp_context(SPContext(mesh=mesh, ring_axis="sp", inner_impl=inner))
        return mesh, "ring"
    if u > 1:
        set_sp_context(SPContext(mesh=mesh, ulysses_axis="sp", inner_impl=inner))
        return mesh, "ulysses"
    return mesh, targs.attn_impl


def make_batches(dataset, collator, sampler, batch_size, device, dtype, epochs: int = 1) -> Iterable:
    """Host-side batches, each collated and sent to ``device`` as
    ``VLMInputs`` (pixels in ``dtype``), over ``epochs`` passes of the
    sampler."""
    for epoch in range(epochs):
        sampler.set_epoch(epoch)
        idx_iter = iter(sampler)
        while True:
            idx = []
            try:
                for _ in range(batch_size):
                    idx.append(next(idx_iter))
            except StopIteration:
                if not idx:
                    break
            yield VLMInputs.from_spliced(*collator([dataset[i] for i in idx]), device=device, dtype=dtype)


def _optimizer(module: nn.Module, ocfg: OptimizerConfig, accumulate: int):
    optimizer = build_optimizer(module, ocfg)
    return MultiSteps(optimizer, accumulate) if accumulate > 1 else optimizer


def _lora(model, cfg, targs, ocfg, attn_impl: str, device):
    """The LoRA / QLoRA branch (reference ``train.py:246-301``): the adapters
    and the tuned modules train, the (int8 / int4) base is frozen outside
    the optimizer.  -> (state, step, save_final_fn)."""
    from spatialrgpt_tpu_torch.ops.layers import quantize_model
    from spatialrgpt_tpu_torch.train.lora import LoraConfig, init_lora
    from spatialrgpt_tpu_torch.utils.checkpoint import save_pytree

    lcfg = LoraConfig(r=targs.lora_r, alpha=targs.lora_alpha, use_dora=targs.use_dora)
    if targs.bits in (4, 8):
        quantize_model(model, bits=targs.bits)
    model.adapters = init_lora(model.llm, lcfg, torch.Generator(device=device).manual_seed(targs.seed + 1),
                               dtype=torch.float32)
    trainable = nn.ModuleDict({"adapters": model.adapters})
    for label, tuned in (("vision", targs.tune_vision_tower), ("projector", targs.tune_mm_projector),
                         ("region", targs.tune_region_extractor)):
        if tuned and getattr(model, MODULES[label], None) is not None:
            trainable[MODULES[label]] = getattr(model, MODULES[label])
    optimizer = _optimizer(trainable, ocfg, targs.gradient_accumulation_steps)
    step = make_lora_train_step(cfg, optimizer, lcfg, attn_impl=attn_impl, remat=targs.gradient_checkpointing)

    def save_final_fn(output_dir, state):
        # adapters + the non-LoRA trainables (the reference saves
        # adapter_model.bin + non_lora_trainables.bin)
        adapters = {name: dict(pair.named_parameters()) for name, pair in state.model.adapters.items()}
        save_pytree(os.path.join(output_dir, "adapter.npz"),
                    {"adapters": adapters, "config": {"r": lcfg.r, "alpha": lcfg.alpha}})
        non_lora = {name: dict(module.named_parameters()) for name, module in trainable.items() if name != "adapters"}
        if non_lora:
            save_pytree(os.path.join(output_dir, "non_lora_trainables.npz"), non_lora)

    return create_train_state(model, optimizer), step, save_final_fn


def _dpo(model, cfg, targs, dargs, ocfg, collator, tokenizer, processor, attn_impl: str, device, dtype, mesh):
    """The DPO branch (reference ``train.py:170-240``) -> its ``Trainer``."""
    from spatialrgpt_tpu_torch.data.dataset import PreferenceDataset
    from spatialrgpt_tpu_torch.train.dpo import DPOState, make_dpo_step, reference_copy

    pair_ds = PreferenceDataset(targs.dpo_data_path, tokenizer, processor,
                                image_aspect_ratio=dargs.image_aspect_ratio, conv_template=dargs.conv_template)
    bs = targs.per_device_train_batch_size

    def pair_batches():
        # over epochs (dpo_steps scales with num_train_epochs), a fresh
        # permutation per epoch seeded as (seed, epoch)
        for epoch in range(max(int(np.ceil(targs.num_train_epochs)), 1)):
            order = np.random.default_rng((targs.seed, epoch)).permutation(len(pair_ds))
            for start in range(0, len(order) - bs + 1, bs):
                chosen, rejected = [], []
                picked = order[start : start + bs]
                if mesh is not None:  # this data-parallel rank's pairs of the batch
                    picked = picked[mesh_lib.local_rows(len(picked), mesh)]
                for i in picked:
                    c, r = pair_ds[int(i)]
                    chosen.append(c)
                    rejected.append(r)
                yield tuple(VLMInputs.from_spliced(*collator(group), device=device, dtype=dtype)
                            for group in (chosen, rejected))

    dpo_steps = (targs.max_steps if targs.max_steps > 0
                 else max(int(len(pair_ds) // bs * targs.num_train_epochs), 1))
    optimizer = _optimizer(model, ocfg, targs.gradient_accumulation_steps)
    state = DPOState(0, model, reference_copy(model, optimizer), optimizer)
    if mesh is not None:  # the frozen reference copy is sharded the same way
        state = shard_state(state, mesh)
    dstep = make_dpo_step(cfg, optimizer, beta=targs.dpo_beta, attn_impl=attn_impl,
                          remat=targs.gradient_checkpointing)
    tcfg = TrainerConfig(output_dir=targs.output_dir, max_steps=dpo_steps, save_steps=targs.save_steps,
                         save_total_limit=targs.save_total_limit, log_steps=targs.logging_steps,
                         report_to=targs.report_to)
    return Trainer(cfg, tcfg, lambda s, b: dstep(s, b[0], b[1]), state, pair_batches())


def _pop_flag(argv, flag: str, default: str):
    """(value of ``flag`` in argv, argv without it): a flag of the port's
    entry point that the launch scripts' argument classes do not hold."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if flag not in argv:
        return default, argv
    i = argv.index(flag)
    return argv[i + 1], argv[:i] + argv[i + 2:]


def main(argv=None, *, device=None, tokenizer=None):
    """``--ckpt_backend torch|orbax`` (beside the launch scripts' flags) picks
    the ``Trainer``'s checkpoint backend (default torch)."""
    ckpt_backend, argv = _pop_flag(argv, "--ckpt_backend", "torch")
    margs, dargs, targs = parse_args(argv)
    dist = torch.distributed
    launched = int(os.environ.get("WORLD_SIZE", os.environ.get("SLURM_NTASKS", "1"))) > 1
    if launched and not dist.is_initialized():
        device = mesh_lib.init_distributed(device=device)
    device = card_device(device, "train.main")
    dtype = torch.bfloat16 if margs.model_dtype == "bfloat16" else torch.float32
    try:
        mesh, attn_impl = build_mesh(targs, device)
        return _main(margs, dargs, targs, device, dtype, mesh, attn_impl, tokenizer, ckpt_backend)
    finally:
        set_sp_context(None)


def _main(margs, dargs, targs, device, dtype, mesh, attn_impl, tokenizer, ckpt_backend):
    cfg = build_config(margs, dargs, targs)

    # ---- model ----
    if margs.model_name_or_path and os.path.isdir(margs.model_name_or_path):
        from spatialrgpt_tpu_torch.models.builder import load_pretrained_model

        tokenizer, model, cfg, processor = load_pretrained_model(margs.model_name_or_path, device, dtype, tokenizer)
    else:
        from spatialrgpt_tpu_torch.data.preprocess import SiglipProcessor
        from spatialrgpt_tpu_torch.utils.weights import init_random

        if tokenizer is None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(margs.model_name_or_path or "gpt2")
        model = init_random(cfg, device, dtype, seed=targs.seed)
        processor = SiglipProcessor(size=cfg.vision.image_size)

    # ---- data ----
    dataset = build_datasets(dargs.data_mixture, tokenizer, processor, conv_template=dargs.conv_template)
    collator = Collator(CollatorConfig(
        max_len=targs.model_max_length, mask_token_id=cfg.mask_token_id, depth_token_id=cfg.depth_token_id,
        regions_per_image=dargs.regions_per_image, image_size=cfg.vision.image_size,
    ))
    bs = targs.per_device_train_batch_size
    sampler = make_train_sampler([len(p) for p in dataset.parts], batch_size=bs, seed=targs.seed, mesh=mesh)
    steps_per_epoch = max(len(sampler) // bs, 1)
    max_steps = targs.max_steps if targs.max_steps > 0 else int(steps_per_epoch * targs.num_train_epochs)

    # ---- optimizer & step ----
    ocfg = OptimizerConfig(
        learning_rate=targs.learning_rate, mm_projector_lr=targs.mm_projector_lr, weight_decay=targs.weight_decay,
        warmup_ratio=targs.warmup_ratio, total_steps=max_steps, lr_scheduler=targs.lr_scheduler_type,
        tune_language_model=targs.tune_language_model, tune_vision_tower=targs.tune_vision_tower,
        tune_mm_projector=targs.tune_mm_projector, tune_region_extractor=targs.tune_region_extractor,
    )
    if targs.dpo_enable:
        trainer = _dpo(model, cfg, targs, dargs, ocfg, collator, tokenizer, processor, attn_impl, device, dtype, mesh)
        result = trainer.train()
        mprint(result)
        return result

    save_final_fn = None
    if targs.lora_enable:  # the model stays replicated (step.py sums the gradients over the ranks)
        state, step_fn, save_final_fn = _lora(model, cfg, targs, ocfg, attn_impl, device)
    else:
        optimizer = _optimizer(model, ocfg, targs.gradient_accumulation_steps)
        state = create_train_state(model, optimizer)
        if mesh is not None:
            state = shard_state(state, mesh)
        frozen = tuple(label for label, tuned in (
            ("llm", targs.tune_language_model), ("vision", targs.tune_vision_tower),
            ("projector", targs.tune_mm_projector), ("region", targs.tune_region_extractor),
        ) if not tuned and getattr(model, MODULES[label], None) is not None)
        step_fn = make_train_step(cfg, optimizer, attn_impl=attn_impl, remat=targs.gradient_checkpointing,
                                  frozen=frozen)

    batches = make_batches(dataset, collator, sampler, bs, device, dtype,
                           epochs=math.ceil(max_steps / steps_per_epoch))
    if targs.dataloader_prefetch > 0:
        # assemble the next batches on a thread while the card runs the step
        from spatialrgpt_tpu_torch.data.prefetch import Prefetcher

        batches = Prefetcher(batches, depth=targs.dataloader_prefetch)
    tcfg = TrainerConfig(
        output_dir=targs.output_dir, max_steps=max_steps, save_steps=targs.save_steps,
        save_total_limit=targs.save_total_limit, log_steps=targs.logging_steps,
        total_time_limit_min=targs.total_time_limit if targs.total_time_limit > 0 else None,
        pre_terminate_min=targs.pre_terminate_time, report_to=targs.report_to, ckpt_backend=ckpt_backend,
    )
    try:
        result = Trainer(cfg, tcfg, step_fn, state, batches, save_final_fn=save_final_fn).train()
    finally:
        if hasattr(batches, "close"):
            batches.close()
    mprint(result)
    return result


if __name__ == "__main__":
    main()
