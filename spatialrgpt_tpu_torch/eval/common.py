"""What the port's evaluation runners share: the device they run on, the
bf16 rounding of a batch's pixels, and the greedy ids cut at eos and
decoded."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from spatialrgpt_tpu_torch.models.vlm import SpatialRGPT, VLMInputs
from spatialrgpt_tpu_torch.utils.device import card_device


def eval_device(device) -> torch.device:
    """``device`` when given; else the card, and without one an error (the
    CPU only when the caller asks for it)."""
    return card_device(device, "the eval runners")


def batch_inputs(model: SpatialRGPT, sb, images: np.ndarray, depths: Optional[np.ndarray],
                 masks: Optional[np.ndarray], mask_valid: Optional[np.ndarray], device) -> VLMInputs:
    """``expand_rows`` output + host pixels -> ``VLMInputs`` on ``device``:
    pixels, depths and masks rounded to bf16 (the reference's
    ``jnp.asarray(..., jnp.bfloat16)``), then cast to the tower's dtype."""
    act = model.vision_tower.vision_model.embeddings.patch_embedding.bias.dtype
    inputs = VLMInputs.from_spliced(sb, images, depths, masks, mask_valid, device, dtype=torch.bfloat16)
    return inputs._replace(**{f: getattr(inputs, f).to(act) for f in ("images", "depths", "masks")
                              if getattr(inputs, f) is not None})


def prompt_lengths(sb, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(sb.segment_ids).sum(axis=1), dtype=torch.int32, device=device)


def cut_at_eos(ids: Sequence[int], eos: int) -> List[int]:
    ids = list(ids)
    return ids[: ids.index(eos)] if eos in ids else ids
