"""HF tensor names of the JAX package's parameter pytrees.

The port's copy of the four name maps of ``spatialrgpt_tpu/utils/export.py``
(``export_siglip``, ``export_projector``, ``export_region_extractor``,
``export_llama``): each takes a numpy pytree of the JAX package's
parameters and returns the HF-named state dict that
``utils/weights.py::load_from_jax`` loads.  Writing checkpoints to disk is
not part of the port.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _np32(x) -> np.ndarray:
    """To numpy, upcasting bfloat16 (not representable in safetensors'
    consumers' torch-free path) to float32."""
    a = np.asarray(x)
    try:
        import ml_dtypes

        if a.dtype == ml_dtypes.bfloat16:
            a = a.astype(np.float32)
    except ImportError:
        pass
    return a


def export_siglip(params: Dict) -> Dict[str, np.ndarray]:
    sd = {}
    pe = params["patch_embed"]
    sd["vision_model.embeddings.patch_embedding.weight"] = _np32(pe["kernel"]).transpose(3, 2, 0, 1)
    sd["vision_model.embeddings.patch_embedding.bias"] = _np32(pe["bias"])
    sd["vision_model.embeddings.position_embedding.weight"] = _np32(params["pos_embed"])
    for i, lp in enumerate(params["layers"]):
        p = f"vision_model.encoder.layers.{i}."
        sd[p + "layer_norm1.weight"] = _np32(lp["ln1"]["scale"])
        sd[p + "layer_norm1.bias"] = _np32(lp["ln1"]["bias"])
        sd[p + "layer_norm2.weight"] = _np32(lp["ln2"]["scale"])
        sd[p + "layer_norm2.bias"] = _np32(lp["ln2"]["bias"])
        for ours, theirs in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"), ("wo", "out_proj")):
            sd[p + f"self_attn.{theirs}.weight"] = _np32(lp["attn"][ours]["kernel"]).T
            sd[p + f"self_attn.{theirs}.bias"] = _np32(lp["attn"][ours]["bias"])
        sd[p + "mlp.fc1.weight"] = _np32(lp["mlp"]["fc1"]["kernel"]).T
        sd[p + "mlp.fc1.bias"] = _np32(lp["mlp"]["fc1"]["bias"])
        sd[p + "mlp.fc2.weight"] = _np32(lp["mlp"]["fc2"]["kernel"]).T
        sd[p + "mlp.fc2.bias"] = _np32(lp["mlp"]["fc2"]["bias"])
    sd["vision_model.post_layernorm.weight"] = _np32(params["post_ln"]["scale"])
    sd["vision_model.post_layernorm.bias"] = _np32(params["post_ln"]["bias"])
    return sd


def export_projector(params: Dict, projector_type: str = "mlp_downsample") -> Dict[str, np.ndarray]:
    if projector_type != "mlp_downsample":
        raise NotImplementedError(projector_type)
    return {
        "layers.1.weight": _np32(params["ln"]["scale"]),
        "layers.1.bias": _np32(params["ln"]["bias"]),
        "layers.2.weight": _np32(params["fc1"]["kernel"]).T,
        "layers.2.bias": _np32(params["fc1"]["bias"]),
        "layers.4.weight": _np32(params["fc2"]["kernel"]).T,
        "layers.4.bias": _np32(params["fc2"]["bias"]),
    }


def export_region_extractor(params: Dict) -> Dict[str, np.ndarray]:
    sd = {}
    idx = 0
    n = len(params["deconvs"])
    for d, dc in enumerate(params["deconvs"]):
        sd[f"feature_refinement_module.{idx}.weight"] = _np32(dc["kernel"]).transpose(2, 3, 0, 1)
        sd[f"feature_refinement_module.{idx}.bias"] = _np32(dc["bias"])
        idx += 1
        if d < n - 1:
            ln = params["lns"][d]
            sd[f"feature_refinement_module.{idx}.weight"] = _np32(ln["scale"])
            sd[f"feature_refinement_module.{idx}.bias"] = _np32(ln["bias"])
            idx += 2
        else:
            idx += 1
    for name in ("rgb_projector", "depth_projector"):
        sd[name + ".weight"] = _np32(params[name]["kernel"]).T
        sd[name + ".bias"] = _np32(params[name]["bias"])
    return sd


def export_llama(params: Dict) -> Dict[str, np.ndarray]:
    sd = {"model.embed_tokens.weight": _np32(params["embed_tokens"])}
    for i, lp in enumerate(params["layers"]):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = _np32(lp["input_ln"])
        sd[p + "post_attention_layernorm.weight"] = _np32(lp["post_ln"])
        for ours, theirs in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"), ("wo", "o_proj")):
            sd[p + f"self_attn.{theirs}.weight"] = _np32(lp["attn"][ours]["kernel"]).T
        for ours, theirs in (("gate", "gate_proj"), ("up", "up_proj"), ("down", "down_proj")):
            sd[p + f"mlp.{theirs}.weight"] = _np32(lp["mlp"][ours]["kernel"]).T
    sd["model.norm.weight"] = _np32(params["final_ln"])
    if "lm_head" in params:
        sd["lm_head.weight"] = _np32(params["lm_head"]["kernel"]).T
    return sd
