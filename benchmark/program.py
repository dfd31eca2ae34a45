"""The benchmark's only door into the system under test, the PyTorch + CUDA
port ``spatialrgpt_tpu_torch``: its kernels, its config and model built
from a configuration file and the benchmark's own tensors, its engine and
its train step.  Everything else under this folder is the
yardstick and imports nothing of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

LLM_KEYS = {  # HF config key -> the port's LlamaConfig field
    "vocab_size": "vocab_size", "hidden_size": "hidden_size", "intermediate_size": "intermediate_size",
    "num_hidden_layers": "num_hidden_layers", "num_attention_heads": "num_attention_heads",
    "num_key_value_heads": "num_key_value_heads", "max_position_embeddings": "max_position_embeddings",
    "rms_norm_eps": "rms_norm_eps", "rope_theta": "rope_theta", "sliding_window": "sliding_window",
    "tie_word_embeddings": "tie_word_embeddings", "bos_token_id": "bos_token_id", "eos_token_id": "eos_token_id",
    "num_local_experts": "num_experts", "num_experts_per_tok": "num_experts_per_tok",
    "router_aux_loss_coef": "router_aux_loss_coef",
}
VISION_KEYS = ("hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads", "image_size",
               "patch_size", "layer_norm_eps", "select_layer")


def port_config(c: dict, ignore_eos: bool = False, max_length: int = 4096):
    """The port's ``SpatialRGPTConfig`` for configuration file ``c``: its
    preset with every number of the file; eos at -1 where the traffic
    ignores it (a request then runs its drawn length)."""
    from spatialrgpt_tpu_torch import preset
    from spatialrgpt_tpu_torch.config import ProjectorConfig, RegionExtractorConfig

    cfg = preset(c["preset"])
    llm = {field: c[key] for key, field in LLM_KEYS.items() if key in c}
    llm["hidden_act"] = {"silu": "silu", "gelu_pytorch_tanh": "gelu_tanh"}[c["hidden_act"]]
    if c["head_dim"] != c["hidden_size"] // c["num_attention_heads"]:
        llm["explicit_head_dim"] = c["head_dim"]
    if ignore_eos:
        llm["eos_token_id"] = -1
    vision = {k: c["vision"][k] for k in VISION_KEYS}
    return cfg.replace(
        llm=dataclasses.replace(cfg.llm, **llm),
        vision=dataclasses.replace(cfg.vision, **vision),
        projector=ProjectorConfig(projector_type=c["projector"]["projector_type"],
                                  mm_hidden_size=vision["hidden_size"], hidden_size=c["hidden_size"]),
        region=RegionExtractorConfig(mm_hidden_size=vision["hidden_size"], hidden_size=c["hidden_size"],
                                     deconv_depth=c["region"]["deconv_depth"],
                                     ada_pool_size=c["region"]["ada_pool_size"]),
        mask_token_id=c["mask_token_id"], depth_token_id=c["depth_token_id"],
        num_extra_tokens=c["num_extra_tokens"], model_max_length=max(max_length, cfg.model_max_length),
    )


def build_model(pcfg, c: dict, weights: Dict[str, torch.Tensor]):
    """The port's ``SpatialRGPT`` holding ``weights`` as they are (no copy):
    built on the meta device, its linears under ``llm.`` and
    ``vision_tower.`` swapped for W8A8 ``QuantLinear``s where the
    configuration is quantized, then every tensor assigned."""
    from torch import nn

    from spatialrgpt_tpu_torch.models.vlm import SpatialRGPT
    from spatialrgpt_tpu_torch.ops.layers import QuantLinear

    with torch.device("meta"):
        model = SpatialRGPT(pcfg, torch.bfloat16)
        if c.get("quantized") == "w8a8":
            for name, lin in list(model.named_modules()):
                if isinstance(lin, nn.Linear) and name.startswith(("llm.", "vision_tower.")):
                    parent, _, attr = name.rpartition(".")
                    setattr(model.get_submodule(parent), attr, QuantLinear(
                        lin.in_features, lin.out_features, 8, a8=True, bias=lin.bias is not None,
                        dtype=torch.bfloat16))
    model.load_state_dict(weights, strict=True, assign=True)
    return model.requires_grad_(False).eval()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def make_engine(model, pcfg, t: dict):
    """The port's ``ServingEngine`` for traffic ``t``: its slots, bucket,
    cache and admission width, and any further keyword argument of the
    engine that ``t["engine"]`` names."""
    from spatialrgpt_tpu_torch.serving.engine import ServingEngine

    return ServingEngine(model, pcfg, num_slots=t["slots"], prompt_bucket=t["prompt_bucket"],
                         max_new_tokens=t["output_tokens"]["high"], attn_impl="onepass",
                         kv_quant=t["kv_cache"] == "int8", admit_width=t["admit_width"], **t.get("engine", {}))


def serve_request(pcfg, ids: Sequence[int], bucket: int, image, depth, masks):
    """One request as the engine queues it: the prompt spliced by the
    port's ``expand_rows`` and padded to ``bucket`` (index fields on the
    host), the pixels (1, S, S, 3) and masks (1, R, S, S) on the device.
    Returns (inputs, prompt length)."""
    from spatialrgpt_tpu_torch import NUM_TOKENS_PER_IMAGE, expand_rows
    from spatialrgpt_tpu_torch.models.vlm import VLMInputs

    R = masks.shape[1]
    sb = expand_rows([np.asarray(ids, np.int64)], None, max_len=pcfg.model_max_length,
                     tokens_per_image=NUM_TOKENS_PER_IMAGE, mask_token_id=pcfg.mask_token_id,
                     depth_token_id=pcfg.depth_token_id, regions_per_image=R, pad_to=bucket)
    fields = {f: getattr(sb, f) for f in sb.__dataclass_fields__ if f != "labels"}
    inputs = VLMInputs(**fields, labels=None, images=image, depths=depth, masks=masks,
                       mask_valid=np.ones((1, R), bool))
    return inputs, int(sb.segment_ids.sum())


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def train_inputs(rows: List[dict], images, depths, masks, device):
    """The port's ``VLMInputs`` of packed rows: each row a dict of its
    samples' expanded fields (``expand_packed``), the pixel tensors indexed
    by the samples' image numbers."""
    from spatialrgpt_tpu_torch.models.vlm import VLMInputs

    def stack(key, dtype):
        return torch.as_tensor(np.stack([r[key] for r in rows]), dtype=dtype, device=device)

    return VLMInputs(
        input_ids=stack("input_ids", torch.int64), is_image=stack("is_image", torch.bool),
        image_gather_idx=stack("image_gather_idx", torch.int64), position_ids=stack("position_ids", torch.int64),
        segment_ids=stack("segment_ids", torch.int32), labels=stack("labels", torch.int64),
        mask_slot=stack("mask_slot", torch.int64), is_mask=stack("is_mask", torch.bool),
        depth_slot=stack("depth_slot", torch.int64), is_depth=stack("is_depth", torch.bool),
        images=images, depths=depths, masks=masks,
        mask_valid=torch.ones(masks.shape[:2], dtype=torch.bool, device=device),
    )


# a module of the composite (its weights' name prefix) -> (OptimizerConfig's flag, make_train_step's label)
MODULES = {"llm": ("tune_language_model", "llm"), "vision_tower": ("tune_vision_tower", "vision"),
           "mm_projector": ("tune_mm_projector", "projector"), "region_extractor": ("tune_region_extractor", "region")}


def train_step(model, pcfg, c: dict, t: dict):
    """(state, step function) of a train step: the modules ``t["step"]["tuned"]``
    names tuned by AdamW with the traffic's schedule, the others frozen,
    remat, chunked cross entropy, the kernel route."""
    from spatialrgpt_tpu_torch.train.optimizer import OptimizerConfig, build_optimizer
    from spatialrgpt_tpu_torch.train.step import create_train_state, make_frozen_base_train_step, make_train_step

    s = t["step"]
    tuned = {flag: m in s["tuned"] for m, (flag, _) in MODULES.items()}
    ocfg = OptimizerConfig(learning_rate=s["lr"], warmup_ratio=s["warmup_ratio"], total_steps=s["total_steps"],
                           max_grad_norm=s["max_grad_norm"], adam_b1=s["adam_b1"], adam_b2=s["adam_b2"],
                           adam_eps=s["adam_eps"], weight_decay=s["weight_decay"], **tuned)
    optimizer = build_optimizer(model, ocfg)
    if c.get("quantized") == "w8a8":
        from spatialrgpt_tpu_torch.ops import layers

        layers.enable_int8_backward(s.get("int8_backward", False))
        step = make_frozen_base_train_step(pcfg, optimizer, attn_impl="pallas", remat=s["remat"],
                                           ce_chunk=s["ce_chunk"])
    else:
        frozen = tuple(label for m, (_, label) in MODULES.items() if m not in s["tuned"])
        step = make_train_step(pcfg, optimizer, attn_impl="pallas", remat=s["remat"], frozen=frozen,
                               ce_chunk=s["ce_chunk"])
    return create_train_state(model, optimizer), step


def adam_first_moment(state, name: str):
    """The optimizer's first moment of the parameter ``name`` of the model
    (zeros where the optimizer holds none: it took no step)."""
    param = dict(state.model.named_parameters())[name]
    st = state.optimizer.state.get(param)
    return st["mu"] if st else torch.zeros_like(param)


def load_kernels(device) -> None:
    """Build the port's CUDA kernels, or load them from the checkout's
    build cache (``build/kernels/<hash of the sources>``)."""
    if device.type == "cuda":
        from spatialrgpt_tpu_torch.ops import _build

        _build.lib()
