"""Training argument dataclasses.

Mirrors the reference's HF-dataclass arg surface (llava/train/args.py:23-116)
so launch scripts translate 1:1; parsed with argparse instead of
HfArgumentParser.

The port's own copy of ``spatialrgpt_tpu/train/args.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ModelArguments:
    model_name_or_path: str = ""
    llm_preset: str = "llama3-8b"  # sheared-3b | llama2-7b | llama3-8b | ...
    vision_tower: str = "siglip-so400m-patch14-384"
    mm_projector: str = "mlp_downsample"
    region_extractor: str = "regiongpt"
    enable_region: bool = True
    enable_depth: bool = True
    mm_vision_select_layer: int = -2
    mm_vision_select_feature: str = "cls_patch"
    model_dtype: str = "bfloat16"


@dataclass
class DataArguments:
    data_mixture: str = "spatialrgpt_ft"
    image_aspect_ratio: str = "resize"
    conv_template: str = "llama_3"
    regions_per_image: int = 8
    lazy_preprocess: bool = True


@dataclass
class TrainingArguments:
    output_dir: str = "output"
    per_device_train_batch_size: int = 16
    gradient_accumulation_steps: int = 1
    learning_rate: float = 2e-5
    mm_projector_lr: Optional[float] = None
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    lr_scheduler_type: str = "cosine"
    model_max_length: int = 4096
    max_steps: int = -1
    num_train_epochs: float = 1.0
    save_steps: int = 100
    save_total_limit: int = 1
    logging_steps: int = 1
    seed: int = 42
    gradient_checkpointing: bool = True
    # module tuning flags (reference args.py:70-73)
    tune_language_model: bool = True
    tune_vision_tower: bool = False
    tune_mm_projector: bool = True
    tune_region_extractor: bool = True
    # parallelism (reference args.py:107-116 + DeepSpeed flags)
    dp_size: int = 1
    fsdp_size: int = 1
    seq_parallel_size: int = 1
    seq_parallel_ring_size: int = 1
    attn_impl: str = "pallas"
    # LoRA (reference train.py:550-589)
    lora_enable: bool = False
    lora_r: int = 64
    lora_alpha: float = 16.0
    use_dora: bool = False
    # base-weight quantization for QLoRA (reference train.py:401-421
    # BitsAndBytesConfig bits): 16 = bf16 base, 8/4 = int8/int4 base
    bits: int = 16
    # DPO (reference train.py:708-739 vendored-TRL branch)
    dpo_enable: bool = False
    dpo_beta: float = 0.1
    dpo_data_path: str = ""  # json/jsonl of {prompt, chosen, rejected, image?}
    # input-pipeline prefetch depth (reference dataloader_num_workers
    # analogue; 0 disables the background thread)
    dataloader_prefetch: int = 2
    # wall-clock budget (reference slurm_utils args)
    total_time_limit: int = -1  # minutes
    pre_terminate_time: int = 10  # minutes
    # jsonl (metrics.jsonl) | wandb (metrics.jsonl, and wandb where it
    # imports and inits; else jsonl alone) | none
    report_to: str = "jsonl"


def parse_args(argv=None):
    parser = argparse.ArgumentParser("spatialrgpt_tpu trainer")
    for cls in (ModelArguments, DataArguments, TrainingArguments):
        for f in dataclasses.fields(cls):
            arg_type = f.type if isinstance(f.type, type) else str
            if f.type in ("bool", bool):
                parser.add_argument(
                    f"--{f.name}",
                    type=lambda s: s.lower() in ("1", "true", "yes"),
                    default=f.default,
                )
            elif f.type in ("Optional[float]",):
                parser.add_argument(f"--{f.name}", type=float, default=f.default)
            else:
                pytype = {"int": int, "float": float, "str": str}.get(str(f.type), str)
                parser.add_argument(f"--{f.name}", type=pytype, default=f.default)
    ns = parser.parse_args(argv)

    def build(cls):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in vars(ns).items() if k in names})

    return build(ModelArguments), build(DataArguments), build(TrainingArguments)
