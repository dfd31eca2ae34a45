"""HF tensor names of the JAX package's parameter pytrees.

The port's copy of the four name maps of ``spatialrgpt_tpu/utils/export.py``
(``export_siglip``, ``export_projector``, ``export_region_extractor``,
``export_llama``): each takes a numpy pytree of the JAX package's
parameters and returns the HF-named state dict that
``utils/weights.py::load_from_jax`` loads.  A dense entry quantized by
``quantize_llm`` (``kernel_q``) comes across as the ``QuantLinear``
buffers of its module (``_dense``).

``hf_config_files`` is the port's copy of the HF config files that the
reference's ``save_composite_hf`` writes beside those tensors.  The port
writes checkpoints from its modules in ``utils/weights.py``:
``save_composite`` (the split tensors and the port's own ``config.json``)
and ``save_composite_hf`` (the directory the PyTorch reference loads),
which ``save_composite_hf`` here names.
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
    if projector_type == "identity":
        return {}
    if projector_type == "linear":
        return {"layers.weight": _np32(params["fc"]["kernel"]).T, "layers.bias": _np32(params["fc"]["bias"])}
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


# the reference's llama projection keys -> (their group in a layer's params,
# the port's module name under a decoder layer)
LLAMA_PROJECTIONS = {"wq": ("attn", "self_attn.q_proj"), "wk": ("attn", "self_attn.k_proj"),
                     "wv": ("attn", "self_attn.v_proj"), "wo": ("attn", "self_attn.o_proj"),
                     "gate": ("mlp", "mlp.gate_proj"), "up": ("mlp", "mlp.up_proj"), "down": ("mlp", "mlp.down_proj")}


def export_llama(params: Dict) -> Dict[str, np.ndarray]:
    sd = {"model.embed_tokens.weight": _np32(params["embed_tokens"])}
    for i, lp in enumerate(params["layers"]):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = _np32(lp["input_ln"])
        sd[p + "post_attention_layernorm.weight"] = _np32(lp["post_ln"])
        for key, (group, name) in LLAMA_PROJECTIONS.items():
            _dense(sd, p + name, lp[group][key])
    sd["model.norm.weight"] = _np32(params["final_ln"])
    if "lm_head" in params:
        _dense(sd, "lm_head", params["lm_head"])
    return sd


def hf_config_files(cfg, vocab_rows: int, root: str) -> Dict[str, dict]:
    """The JSON files of the reference's ``save_composite_hf`` by their path
    under ``root``, key for key: each component's HF config (the loaders of
    llava/model/builder.py:142-159 and llava_arch.py's ``init_vlm`` read
    them), SigLIP's preprocessor config, and the top-level LlavaConfig.
    ``vocab_rows``: the embedding table's rows (the region tokens
    included), the decoder's ``vocab_size``.  As the reference, the decoder
    is written as a Llama whatever its family, without Gemma's ``head_dim``
    or Mistral's ``sliding_window``."""
    v, L = cfg.vision, cfg.llm
    vision = {
        "model_type": "siglip_vision_model",
        "architectures": ["SiglipVisionModel"],
        "hidden_size": v.hidden_size,
        "intermediate_size": v.intermediate_size,
        "num_hidden_layers": v.num_hidden_layers,
        "num_attention_heads": v.num_attention_heads,
        "image_size": v.image_size,
        "patch_size": v.patch_size,
        "num_channels": 3,
        "layer_norm_eps": v.layer_norm_eps,
        "hidden_act": v.hidden_act,
        "attention_dropout": 0.0,
        # the attention-pool head is unused (features come from hidden_states)
        "vision_use_head": False,
        # the reference records the region token ids into the vision tower's
        # config (model/builder.py:186-192; read back at llava_arch.py:471,488)
        "llm_mask_token_id": cfg.mask_token_id,
        "llm_depth_token_id": cfg.depth_token_id,
    }
    preprocessor = {
        "image_processor_type": "SiglipImageProcessor",
        "processor_class": "SiglipProcessor",
        "do_resize": True,
        "size": {"height": v.image_size, "width": v.image_size},
        "resample": 3,  # bicubic
        "do_rescale": True,
        "rescale_factor": 1.0 / 255.0,
        "do_normalize": True,
        "image_mean": [0.5, 0.5, 0.5],
        "image_std": [0.5, 0.5, 0.5],
    }
    llm = {
        "model_type": "llama",
        "architectures": ["LlamaForCausalLM"],
        "vocab_size": int(vocab_rows),
        "hidden_size": L.hidden_size,
        "intermediate_size": L.intermediate_size,
        "num_hidden_layers": L.num_hidden_layers,
        "num_attention_heads": L.num_attention_heads,
        "num_key_value_heads": L.num_key_value_heads,
        "max_position_embeddings": L.max_position_embeddings,
        "rms_norm_eps": L.rms_norm_eps,
        "rope_theta": L.rope_theta,
        "hidden_act": L.hidden_act,
        "attention_bias": L.attention_bias,
        "tie_word_embeddings": L.tie_word_embeddings,
        "bos_token_id": L.bos_token_id,
        "eos_token_id": L.eos_token_id,
        "torch_dtype": "float32",
    }
    if L.rope_scaling_factor:
        llm["rope_scaling"] = {"type": "linear", "factor": L.rope_scaling_factor}
    top = {
        "model_type": "llava_llama",
        "architectures": ["LlavaLlamaModel"],
        # dict-valued sub-configs make the reference's get_model_config
        # (model/utils.py:25-55) resolve each component to <root>/<name>
        "llm_cfg": llm,
        "vision_tower_cfg": {"resolved": "vision_tower"},
        "mm_projector_cfg": {"resolved": "mm_projector"},
        "region_extractor_cfg": {"resolved": "region_extractor"},
        "resume_path": root,
        "enable_region": cfg.enable_region,
        "enable_depth": cfg.enable_depth,
        "hidden_size": L.hidden_size,
        "mm_hidden_size": v.hidden_size,
        "image_aspect_ratio": cfg.image_aspect_ratio,
        "mm_vision_select_layer": v.select_layer,
        "mm_vision_select_feature": v.select_feature,
        "mm_use_im_start_end": False,
        "mm_use_im_patch_token": True,
        "model_max_length": cfg.model_max_length,
        "model_dtype": "torch.float32",
        "s2": False,
        "transformers_version": "4.36.0",
    }
    return {
        "vision_tower/config.json": vision,
        "vision_tower/preprocessor_config.json": preprocessor,
        "llm/config.json": llm,
        "mm_projector/config.json": {"model_type": "v2l_projector", "mm_projector_type": cfg.projector.projector_type},
        "region_extractor/config.json": {"model_type": "region_extractor",
                                         "region_extractor_type": cfg.region.extractor_type},
        "config.json": top,
    }


def save_composite_hf(root: str, model, cfg, tokenizer=None, state=None) -> None:
    """The reference's ``save_composite_hf`` for the port's modules:
    ``utils/weights.py::save_composite_hf``."""
    from spatialrgpt_tpu_torch.utils.weights import save_composite_hf as save

    save(root, model, cfg, tokenizer, state)
