"""Base / delta weight tools (port of ``spatialrgpt_tpu/utils/delta.py``).

The reference's apply_delta / make_delta / consolidate: a delta checkpoint
stores (finetuned - base) so that released weights can leave out a
licensed base model; consolidate turns a trainer checkpoint into a clean
composite directory.  They act on the port's state dicts (name ->
tensor); a table that grew (the vocabulary) is padded with zero rows
along dim 0 to the larger of the two, as the reference pads it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

StateDict = Dict[str, torch.Tensor]


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))], dim=0)


def _binary_op(a: StateDict, b: StateDict, op) -> StateDict:
    assert list(a) == list(b), "state dict names mismatch"
    out = {}
    for name, x in a.items():
        y = b[name]
        if x.shape != y.shape:
            # vocab-size growth: pad the smaller along dim 0 with zeros
            rows = max(x.shape[0], y.shape[0])
            x, y = _pad_rows(x, rows), _pad_rows(y, rows)
        out[name] = op(x, y)
    return out


def make_delta(base_params: StateDict, target_params: StateDict) -> StateDict:
    """delta = target - base."""
    return _binary_op(target_params, base_params, lambda t, b: t - b)


def apply_delta(base_params: StateDict, delta_params: StateDict) -> StateDict:
    """target = base + delta."""
    return _binary_op(base_params, delta_params, lambda b, d: b + d)


def consolidate(checkpoint_dir: str, out_dir: str, cfg, base: Optional[torch.nn.Module] = None) -> None:
    """A trainer checkpoint (``checkpoint-<N>/state.pt``, the trained
    parameters by name) -> the split composite directory of
    ``utils/weights.py::save_composite``.  The port's trainer saves only what
    it trains, so the rest comes from ``base`` (the model it trained, whose
    tensors the checkpoint's replace in place); without ``base`` the
    checkpoint must hold every parameter of a ``SpatialRGPT(cfg)``."""
    from spatialrgpt_tpu_torch.models.vlm import SpatialRGPT
    from spatialrgpt_tpu_torch.utils.weights import save_composite

    state = torch.load(os.path.join(checkpoint_dir, "state.pt"), map_location="cpu")
    if base is None:
        dtype = next(iter(state.values())).dtype
        with torch.device("meta"):
            base = SpatialRGPT(cfg, dtype)
        base = base.to_empty(device="cpu")
        base.load_state_dict(state, strict=True)
    else:
        missing = sorted(set(state) - set(base.state_dict()))
        if missing:
            raise KeyError(f"checkpoint names the model does not have: {missing[:5]}")
        base.load_state_dict(state, strict=False)
    save_composite(out_dir, base, cfg)
