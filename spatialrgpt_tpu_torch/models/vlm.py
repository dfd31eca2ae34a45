"""SpatialRGPT composite VLM (port of ``spatialrgpt_tpu/models/vlm.py``):
SigLIP tower + region extractor + projector + Llama decoder, with the
static-shape multimodal splice.

Vision encode contract (as the reference):
  - the SAME tower encodes RGB images and depth maps, in one pass over the
    stacked ``[images; depths]`` batch,
  - RGB region pooling uses the deconv-refined high-res grid; depth region
    pooling uses the RAW depth tower features,
  - LLM image tokens come from the projector over the low-res global branch.

Refinement and pooling run over the whole batch at once, unchunked: the
reference chunks ``_refine_and_pool`` only to bound TPU memory at batch
96, and at the port's batch sizes the high-res grid fits the card with
room to spare.  Raw uint8 pixels are not accepted yet (the reference
normalizes them in-graph); pass normalized floats.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from spatialrgpt_tpu.config import SpatialRGPTConfig
from spatialrgpt_tpu_torch.models import llama, projector, region_extractor, siglip


class SpatialRGPT(nn.Module):
    """Parameter holder; sub-module names follow the reference's split
    checkpoint directories (llm/, vision_tower/, mm_projector/,
    region_extractor/)."""

    def __init__(self, cfg: SpatialRGPTConfig, dtype=None):
        super().__init__()
        self.vision_tower = siglip.SiglipVisionModel(cfg.vision, dtype)
        self.mm_projector = projector.MultimodalProjector(cfg.projector, dtype)
        self.region_extractor = region_extractor.RegionExtractor(cfg.region, dtype) if cfg.enable_region else None
        self.llm = llama.LlamaForCausalLM(cfg.llm, cfg.num_extra_tokens, dtype)


class VLMInputs(NamedTuple):
    """Device-side batch (see ``spatialrgpt_tpu/data/splice.py``)."""

    input_ids: torch.Tensor  # (B, S) int64, image slots 0
    is_image: torch.Tensor  # (B, S) bool
    image_gather_idx: torch.Tensor  # (B, S) int64 -> flat (N*T)
    position_ids: torch.Tensor  # (B, S) int64
    segment_ids: torch.Tensor  # (B, S) int32, 0 = pad
    labels: Optional[torch.Tensor]  # (B, S) int64
    mask_slot: torch.Tensor  # (B, S) int64 -> flat (N*R)
    is_mask: torch.Tensor  # (B, S) bool
    depth_slot: torch.Tensor  # (B, S) int64
    is_depth: torch.Tensor  # (B, S) bool
    images: torch.Tensor  # (N, H, W, 3)
    depths: Optional[torch.Tensor]  # (N, H, W, 3)
    masks: Optional[torch.Tensor]  # (N, R, Hm, Wm)
    mask_valid: Optional[torch.Tensor]  # (N, R) bool

    @classmethod
    def from_spliced(cls, batch, images, depths, masks, mask_valid, device, dtype=torch.float32) -> "VLMInputs":
        """``expand_rows`` output + numpy pixels -> tensors on ``device``
        (twin of ``spatialrgpt_tpu/data/dataset.py::to_vlm_inputs``).
        Index arrays become int64, the index type of torch gathers."""

        def idx(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=device)

        def flag(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.bool, device=device)

        def pix(a):
            return None if a is None else torch.as_tensor(np.asarray(a), device=device).to(dtype)

        return cls(
            input_ids=idx(batch.input_ids),
            is_image=flag(batch.is_image),
            image_gather_idx=idx(batch.image_gather_idx),
            position_ids=idx(batch.position_ids),
            segment_ids=torch.as_tensor(np.asarray(batch.segment_ids), dtype=torch.int32, device=device),
            labels=idx(batch.labels) if batch.labels is not None else None,
            mask_slot=idx(batch.mask_slot),
            is_mask=flag(batch.is_mask),
            depth_slot=idx(batch.depth_slot),
            is_depth=flag(batch.is_depth),
            images=pix(images),
            depths=pix(depths),
            masks=pix(masks),
            mask_valid=None if mask_valid is None else flag(mask_valid),
        )


def encode_images(
    model: SpatialRGPT,
    cfg: SpatialRGPTConfig,
    images: torch.Tensor,  # (N, H, W, 3) normalized
    depths: Optional[torch.Tensor],
    masks: Optional[torch.Tensor],  # (N, R, Hm, Wm)
    attn_impl: str = "onepass",
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(image_features (N, T, H), mask_embeds (N, R, H) | None,
    depth_embeds (N, R, H) | None)."""
    tower_fn = lambda x: siglip.forward_features(model.vision_tower, x, cfg.vision, attn_impl)  # noqa: E731
    mask_embeds = depth_embeds = None
    if cfg.enable_region:
        depth_feats = None
        if cfg.enable_depth and depths is not None:
            # one tower pass over [images; depths]: ViT blocks are per-sample
            tower, depth_feats = tower_fn(torch.cat([images, depths], dim=0)).chunk(2, dim=0)
        else:
            tower = tower_fn(images)
        hres, lres = region_extractor.feature_refinement(model.region_extractor, tower, cfg.region)
        if masks is not None:
            mask_embeds, depth_embeds = region_extractor.extract_regions(
                model.region_extractor, hres, depth_feats, masks, cfg.region
            )
    else:
        lres = tower_fn(images)
    image_features = projector.forward(model.mm_projector, lres, cfg.projector)
    return image_features, mask_embeds, depth_embeds


def _gather_rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """table (M, H) rows at index (B, S) -> (B, S, H).  The index is clamped
    into range, as the reference's ``jnp.take(..., mode="clip")``: torch
    indexing raises where JAX clips, and a stray slot must stay benign (the
    is_* masks decide what is used)."""
    return table[index.clamp(0, table.shape[0] - 1)]


def splice_embeds(
    model: SpatialRGPT,
    cfg: SpatialRGPTConfig,
    inputs: VLMInputs,
    image_features: torch.Tensor,  # (N, T, H)
    mask_embeds: Optional[torch.Tensor],  # (N, R, H)
    depth_embeds: Optional[torch.Tensor],
) -> torch.Tensor:
    """(B, S, H) input embeddings: text from the table, <mask>/<depth>
    positions overwritten by region embeds, image slots by projected image
    tokens."""
    embeds = llama.embed_tokens(model.llm, inputs.input_ids)
    H = embeds.shape[-1]
    if mask_embeds is not None:
        got = _gather_rows(mask_embeds.reshape(-1, H), inputs.mask_slot)
        embeds = torch.where(inputs.is_mask[..., None], got.to(embeds.dtype), embeds)
    if depth_embeds is not None:
        got = _gather_rows(depth_embeds.reshape(-1, H), inputs.depth_slot)
        embeds = torch.where(inputs.is_depth[..., None], got.to(embeds.dtype), embeds)
    got = _gather_rows(image_features.reshape(-1, H), inputs.image_gather_idx)
    return torch.where(inputs.is_image[..., None], got.to(embeds.dtype), embeds)


def prepare_embeds(model: SpatialRGPT, cfg: SpatialRGPTConfig, inputs: VLMInputs, attn_impl: str = "onepass") -> torch.Tensor:
    image_features, mask_embeds, depth_embeds = encode_images(
        model, cfg, inputs.images, inputs.depths, inputs.masks, attn_impl
    )
    return splice_embeds(model, cfg, inputs, image_features, mask_embeds, depth_embeds)
