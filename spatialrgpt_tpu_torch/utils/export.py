"""HF tensor names of the JAX package's parameter pytrees.

The port's copy of the four name maps of ``spatialrgpt_tpu/utils/export.py``
(``export_siglip``, ``export_projector``, ``export_region_extractor``,
``export_llama``): each takes a numpy pytree of the JAX package's
parameters and returns the HF-named state dict that
``utils/weights.py::load_from_jax`` loads.  A dense entry quantized by
``quantize_llm`` (``kernel_q``) comes across as the ``QuantLinear``
buffers of its module (``_dense``).  Writing checkpoints to disk is not
part of the port.
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


# the markers of a ``kernel_q`` entry, carried under its module's name
QUANT_MARKERS = ("a8", "orig_dim0")


def _dense(sd: Dict[str, np.ndarray], name: str, p: Dict, bias: bool = False) -> None:
    """A dense entry under its HF module name: ``kernel`` (din, dout) as the
    (out, in) ``.weight``; a ``kernel_q`` as ``.q`` (its (din, dout) int8,
    or int4 nibble pairs packed along din, transposed to (out, in) or (out,
    ceil(in / 2))) and ``.scale`` ((1, dout) as (out,)), with its
    ``.a8`` / ``.orig_dim0`` markers."""
    if "kernel_q" in p:
        kq = p["kernel_q"]
        sd[name + ".q"] = np.asarray(kq["q"]).T
        sd[name + ".scale"] = np.asarray(kq["scale"], np.float32).reshape(-1)
        for marker in QUANT_MARKERS:
            if marker in kq:
                sd[f"{name}.{marker}"] = np.asarray(kq[marker])
    else:
        sd[name + ".weight"] = _np32(p["kernel"]).T
    if bias:
        sd[name + ".bias"] = _np32(p["bias"])


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
            _dense(sd, p + f"self_attn.{theirs}", lp["attn"][ours], bias=True)
        _dense(sd, p + "mlp.fc1", lp["mlp"]["fc1"], bias=True)
        _dense(sd, p + "mlp.fc2", lp["mlp"]["fc2"], bias=True)
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
            _dense(sd, p + f"self_attn.{theirs}", lp["attn"][ours])
        for ours, theirs in (("gate", "gate_proj"), ("up", "up_proj"), ("down", "down_proj")):
            _dense(sd, p + f"mlp.{theirs}", lp["mlp"][ours])
    sd["model.norm.weight"] = _np32(params["final_ln"])
    if "lm_head" in params:
        _dense(sd, "lm_head", params["lm_head"])
    return sd
