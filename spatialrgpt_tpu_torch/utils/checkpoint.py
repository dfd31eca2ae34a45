"""Checkpoint I/O (port of ``spatialrgpt_tpu/utils/checkpoint.py``).

- ``load_state_dict``: every tensor of an HF model directory, from its
  ``*.safetensors`` files (``safetensors``, imported at the call) or else
  its ``*.bin`` files (``torch.load(..., weights_only=True)``).
- ``load_reference_checkpoint``: the reference's split composite directory
  (``llm/ vision_tower/ mm_projector/ region_extractor/``, what
  ``utils/weights.py::save_composite`` and the JAX package's
  ``utils/export.py::save_composite`` write) -> ``SpatialRGPT``.  The port's
  modules hold their tensors under the HF names in the HF layouts, so the
  reference's converters (``checkpoint.py:87-240``: transposes into JAX
  layouts) reduce to the name prefixes each of them tolerates
  (``vision_model.``, ``mm_projector.``, ``model.``) and a strict load.
- ``save_pytree`` / ``load_pytree``: a nested dict of tensors or arrays as
  one ``.npz``, keys joined by ``/`` (the reference pickles a JAX treedef
  beside its leaves; the port has none).  bfloat16 is stored as float32,
  exactly, since numpy has no bfloat16.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from spatialrgpt_tpu_torch.config import SpatialRGPTConfig

# tensors of a reference checkpoint that no module of the port holds: the
# rotary tables older HF Llama checkpoints store, SigLIP's unused pooling head
_IGNORED = (".rotary_emb.inv_freq", "vision_model.head.")


def load_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """All tensors of an HF model directory, on the CPU as stored."""
    entries = sorted(os.listdir(model_dir))
    st_files = [e for e in entries if e.endswith(".safetensors")]
    bin_files = [e for e in entries if e.endswith(".bin")]
    out: Dict[str, torch.Tensor] = {}
    if st_files:
        from safetensors.torch import load_file

        for f in st_files:
            out.update(load_file(os.path.join(model_dir, f)))
    elif bin_files:
        for f in bin_files:
            out.update(torch.load(os.path.join(model_dir, f), map_location="cpu", weights_only=True))
    else:
        raise FileNotFoundError(f"no weights found under {model_dir}")
    return out


def _with_prefix(sd: Mapping[str, torch.Tensor], prefix: str, keep=lambda name: True) -> Dict[str, torch.Tensor]:
    """Names under ``prefix``, whether or not the checkpoint wrote it (the
    reference's converters accept both), except where ``keep`` says no."""
    has = any(k.startswith(prefix) for k in sd)
    return {k if has or not keep(k) else prefix + k: v for k, v in sd.items()}


def _split_state(root: str, cfg: SpatialRGPTConfig) -> Dict[str, torch.Tensor]:
    """The split directories' tensors under the port's module names."""
    parts = {
        "vision_tower": _with_prefix(load_state_dict(os.path.join(root, "vision_tower")), "vision_model."),
        "mm_projector": {k.removeprefix("mm_projector."): v
                         for k, v in load_state_dict(os.path.join(root, "mm_projector")).items()},
        "llm": _with_prefix(load_state_dict(os.path.join(root, "llm")), "model.", keep=lambda k: k != "lm_head.weight"),
    }
    if cfg.enable_region:
        parts["region_extractor"] = load_state_dict(os.path.join(root, "region_extractor"))
    return {f"{module}.{name}": t for module, sd in parts.items() for name, t in sd.items()
            if not any(s in name for s in _IGNORED)}


def load_reference_checkpoint(root: str, cfg: SpatialRGPTConfig, device, dtype=torch.bfloat16,
                              vocab_rows: Optional[int] = None):
    """A split composite directory -> ``SpatialRGPT`` on ``device`` in
    ``dtype``, loaded strictly (a missing or unknown tensor raises).  With
    ``vocab_rows`` larger than the stored vocabulary, the embedding table
    and the LM head grow to it, each new row the mean of the stored rows
    (``models/builder.py::load_pretrained_model``'s padding)."""
    from spatialrgpt_tpu_torch.utils.weights import _empty_model
    from spatialrgpt_tpu_torch.models.vlm import SpatialRGPT

    state = _split_state(root, cfg)
    for name in ("llm.model.embed_tokens.weight", "llm.lm_head.weight"):
        table = state.get(name)
        if vocab_rows is not None and table is not None and vocab_rows > table.shape[0]:
            # the reference takes the mean in the parameter dtype and adds it to zeros
            mean = table.to(dtype).float().mean(dim=0, keepdim=True).to(dtype)
            state[name] = torch.cat([table.to(dtype), mean.expand(vocab_rows - table.shape[0], -1)])
    model = _empty_model(SpatialRGPT, cfg, device, dtype)
    model.load_state_dict({k: v.to(device=device, dtype=dtype) for k, v in state.items()}, strict=True)
    return model


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            if "/" in str(k):
                raise ValueError(f"key {k!r} holds '/', the separator of save_pytree's names")
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        tree = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return {prefix[:-1]: np.asarray(tree)}


def save_pytree(path: str, tree) -> None:
    """A nested dict of tensors / arrays / numbers as one ``.npz``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(tree))


def load_pytree(path: str) -> Dict:
    """``save_pytree``'s nested dict, its leaves numpy arrays."""
    out: Dict = {}
    with np.load(path if path.endswith(".npz") else path + ".npz", allow_pickle=False) as z:
        for key in z.files:
            *heads, leaf = key.split("/")
            node = out
            for h in heads:
                node = node.setdefault(h, {})
            node[leaf] = z[key]
    return out
