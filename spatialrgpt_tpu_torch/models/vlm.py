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
room to spare.  Raw uint8 pixels, depths and masks are accepted, as the
reference accepts them: pixels at the tower resolution are normalized on
the device (``data/device_preprocess.py::device_siglip_normalize``) into
the tower's dtype, masks are cast.  Built with ``mpt_cfg``, the model's
decoder is an MPT (``models/mpt.py``), which ``forward_mpt`` runs after
the same encode and splice.

Sequence parallelism (``attn_impl`` "ulysses", "ring" or "hybrid", with
the ambient ``parallel/context.py::SPContext``): every rank of an sp group
holds the same rows whole, images included; the tower, the projector and
the splice run on them, and the decoder then runs on this rank's chunk of
the sequence (``seq_shard``).  The loss shifts the labels before the
chunking, so every target is the next token of the whole row.

Under a process group of several ranks the loss is normalised by the
global number of targets (summed over every rank): the rank's loss is its
own targets' share of the reference's global loss, the gradients of the
ranks add up to the reference's, and ``metrics["loss"]`` is the global
value.  FSDP (``parallel/mesh.py::shard_model``) sums gradients, so it
does not rescale this.  A MoE decoder's router aux loss is each rank's
own.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from spatialrgpt_tpu_torch.config import SpatialRGPTConfig
from spatialrgpt_tpu_torch.constants import IGNORE_INDEX
from spatialrgpt_tpu_torch.data.device_preprocess import device_siglip_normalize
from spatialrgpt_tpu_torch.models import llama, mpt, projector, region_extractor, siglip
from spatialrgpt_tpu_torch.parallel.context import SP_IMPLS, seq_shard, sp_context, sp_sum
from spatialrgpt_tpu_torch.parallel.mesh import world_sum


class SpatialRGPT(nn.Module):
    """Parameter holder; sub-module names follow the reference's split
    checkpoint directories (llm/, vision_tower/, mm_projector/,
    region_extractor/).  With ``mpt_cfg`` the decoder is an MPT
    (``models/mpt.py``; the reference's LlavaMPT, run by ``forward_mpt``)
    instead of ``cfg.llm``'s Llama."""

    def __init__(self, cfg: SpatialRGPTConfig, dtype=None, mpt_cfg: Optional[mpt.MPTConfig] = None):
        super().__init__()
        self.vision_tower = siglip.SiglipVisionModel(cfg.vision, dtype)
        self.mm_projector = projector.MultimodalProjector(cfg.projector, dtype)
        self.region_extractor = region_extractor.RegionExtractor(cfg.region, dtype) if cfg.enable_region else None
        if mpt_cfg is not None:
            self.llm = mpt.MptForCausalLM(mpt_cfg, dtype)
        else:
            self.llm = llama.LlamaForCausalLM(cfg.llm, cfg.num_extra_tokens, dtype)

    def forward(self, fn, *args, **kwargs):
        """``fn(self, *args, **kwargs)`` as the module's forward: the
        functions of this module (``loss_fn``, ``sequence_logprob``) run
        through it where FSDP must gather the whole model's own parameters
        around them (``train/step.py``)."""
        return fn(self, *args, **kwargs)


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
    images: torch.Tensor,  # (N, H, W, 3) normalized float, or raw uint8
    depths: Optional[torch.Tensor],
    masks: Optional[torch.Tensor],  # (N, R, Hm, Wm)
    attn_impl: str = "onepass",
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(image_features (N, T, H), mask_embeds (N, R, H) | None,
    depth_embeds (N, R, H) | None).  uint8 images and depths (each on its
    own: a caller may mix a normalized field with a raw one) are normalized
    into the dtype of the patch embedding's bias (float also in a quantized
    tower), uint8 masks cast to it (the mask processor rescales by 1)."""
    act_dtype = model.vision_tower.vision_model.embeddings.patch_embedding.bias.dtype
    if images.dtype == torch.uint8:
        images = device_siglip_normalize(images, act_dtype)
    if depths is not None and depths.dtype == torch.uint8:
        depths = device_siglip_normalize(depths, act_dtype)
    if masks is not None and masks.dtype == torch.uint8:
        masks = masks.to(act_dtype)
    tower_fn = lambda x: model.vision_tower(x, cfg.vision, attn_impl)  # noqa: E731
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
    image_features = model.mm_projector(lres, cfg.projector)
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
    if isinstance(model.llm, mpt.MptForCausalLM):
        embeds = mpt.embed_tokens(model.llm, inputs.input_ids)
    else:
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


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------


def _hidden(model: SpatialRGPT, cfg: SpatialRGPTConfig, inputs: VLMInputs, attn_impl: str, remat: bool,
            with_aux: bool = False):
    # the plain path stays plain; every kernel route runs the tower on K1,
    # as the reference's tower takes its Pallas kernel whatever the decoder uses
    embeds = prepare_embeds(model, cfg, inputs, "xla" if attn_impl == "xla" else "onepass")
    pos, seg = inputs.position_ids, inputs.segment_ids
    if attn_impl in SP_IMPLS:  # the decoder runs this rank's chunk of the sequence
        ctx = sp_context(attn_impl)
        embeds, pos, seg = (seq_shard(t, ctx) for t in (embeds, pos, seg))
    out = llama.forward(
        model.llm, cfg.llm, inputs_embeds=embeds, position_ids=pos,
        segment_ids=seg, attn_impl=attn_impl, remat=remat, with_aux=with_aux,
    )
    return (out[0], out[2]) if with_aux else out[0]


def forward(
    model: SpatialRGPT, cfg: SpatialRGPTConfig, inputs: VLMInputs, attn_impl: str = "xla", remat: bool = False,
    with_aux: bool = False,
):
    """Full multimodal forward -> f32 logits (B, S, V), and with
    ``with_aux`` (logits, the summed MoE router aux loss)."""
    if with_aux:
        h, aux = _hidden(model, cfg, inputs, attn_impl, remat, with_aux=True)
        return llama.logits(model.llm, h), aux
    return llama.logits(model.llm, _hidden(model, cfg, inputs, attn_impl, remat))


def forward_mpt(
    model: SpatialRGPT, cfg: SpatialRGPTConfig, mpt_cfg: mpt.MPTConfig, inputs: VLMInputs, attn_impl: str = "onepass"
) -> torch.Tensor:
    """Composite forward with an MPT decoder (the reference's LlavaMPT):
    the same vision encode and splice (the tower on K1 unless
    ``attn_impl="xla"``), the ALiBi decoder stack, the tied head in f32 ->
    logits (B, S, V)."""
    embeds = prepare_embeds(model, cfg, inputs, attn_impl)
    h = mpt.forward_embeds(model.llm, mpt_cfg, embeds, inputs.segment_ids)
    return mpt.logits(model.llm, h)


def _shifted_targets(inputs: VLMInputs, attn_impl: str = "xla") -> Tuple[torch.Tensor, torch.Tensor]:
    """(targets, valid), (B, S): the target at position t is labels[t + 1];
    the last position, padding and segment ends are not valid.  Under
    sequence parallelism, this rank's chunk of both (shifted first)."""
    labels, seg = inputs.labels, inputs.segment_ids
    B = labels.shape[0]
    tgt = torch.cat([labels[:, 1:], labels.new_full((B, 1), IGNORE_INDEX)], dim=1)
    nxt = torch.cat([seg[:, 1:], seg.new_zeros((B, 1))], dim=1)
    valid = (tgt != IGNORE_INDEX) & (nxt != 0) & (nxt == seg)
    if attn_impl in SP_IMPLS:
        ctx = sp_context(attn_impl)
        return seq_shard(tgt, ctx), seq_shard(valid, ctx)
    return tgt, valid


def _token_logp(h: torch.Tensor, tgt: torch.Tensor, valid: torch.Tensor, llm: nn.Module) -> torch.Tensor:
    """(B, S) log p(target) at the valid positions, 0 elsewhere: LM head,
    logsumexp and the target gather (the lse form: no (.., V) log-softmax
    is built)."""
    lg = llama.logits(llm, h)
    tok = lg.gather(-1, torch.where(valid, tgt, 0)[..., None])[..., 0] - torch.logsumexp(lg, dim=-1)
    return tok * valid


def _token_logp_sum(h: torch.Tensor, tgt: torch.Tensor, valid: torch.Tensor, llm: nn.Module) -> torch.Tensor:
    return _token_logp(h, tgt, valid, llm).sum()


def sequence_logprob(
    model: SpatialRGPT, cfg: SpatialRGPTConfig, inputs: VLMInputs, attn_impl: str = "xla", remat: bool = False
) -> torch.Tensor:
    """(B,) sum of each row's log p(target) over its supervised targets (the
    port of ``spatialrgpt_tpu/train/dpo.py::sequence_logprob``, which takes
    a log-softmax of ``forward``'s logits; here the lse form of
    ``loss_fn``, the same function).  An MoE decoder's aux loss is left out,
    as the reference's ``forward`` without ``with_aux`` leaves it."""
    h = _hidden(model, cfg, inputs, attn_impl, remat)
    tgt, valid = _shifted_targets(inputs, attn_impl)
    rows = _token_logp(h, tgt, valid, model.llm).sum(dim=-1)
    return sp_sum(rows, sp_context(attn_impl)) if attn_impl in SP_IMPLS else rows


def loss_fn(
    model: SpatialRGPT,
    cfg: SpatialRGPTConfig,
    inputs: VLMInputs,
    attn_impl: str = "xla",
    remat: bool = False,
    ce_chunk: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy with IGNORE_INDEX and segment-boundary
    masking, divided by the number of valid targets (at least 1): the port
    of ``spatialrgpt_tpu/models/vlm.py::loss_fn``.

    ``ce_chunk > 0`` applies the target shift first, then runs the LM head,
    logsumexp and gather per chunk of ``ce_chunk`` positions under
    ``torch.utils.checkpoint``: the (B, S, V) logits never exist, and the
    backward recomputes one chunk's logits at a time.  A quantized decoder's
    projections and LM head take ``linear``'s quantized branches, whose
    backward carries dx (the W8A8 straight-through estimator; under remat
    the recompute runs K7 + K8 again, as ``jax.checkpoint`` recomputes the
    W8A8 forward).

    An MoE decoder adds ``router_aux_loss_coef`` x the summed router aux
    loss (the reference's load-balancing term, under remat too): the
    metrics hold it as ``router_aux_loss`` and ``loss`` is the total.  The
    reference runs an MoE decoder's ``ce_chunk`` on its unchunked branch;
    the chunked CE here has the same value.

    On a rank of a train step's process group the returned loss is this
    rank's share: its tokens' cross entropy over the global target count,
    plus the aux of the whole step (every rank's router statistics
    averaged, ``llama.router_aux``), whose backward reaches this rank's
    router only with its tokens' part.  The ranks' gradients summed are
    then the reference's gradient of its global loss; the metrics hold the
    global values."""
    moe = cfg.llm.is_moe
    h = _hidden(model, cfg, inputs, attn_impl, remat, with_aux=moe)
    if moe:
        h, aux = h
    tgt, valid = _shifted_targets(inputs, attn_impl)
    w = model.llm
    if ce_chunk:
        S = tgt.shape[1]
        if S % ce_chunk:
            raise ValueError(f"ce_chunk {ce_chunk} must divide S {S}")
        total = h.new_zeros((), dtype=torch.float32)
        for c0 in range(0, S, ce_chunk):
            c = slice(c0, c0 + ce_chunk)
            total = total + checkpoint(_token_logp_sum, h[:, c], tgt[:, c], valid[:, c], w, use_reentrant=False)
    else:
        total = _token_logp_sum(h, tgt, valid, w)
    n_valid = world_sum(valid.sum()).clamp(min=1)
    loss = -total / n_valid
    metrics = {"loss": -world_sum(total.detach()) / n_valid, "num_tokens": n_valid}
    if moe:
        coef = cfg.llm.router_aux_loss_coef
        loss = loss + coef * aux
        metrics.update(router_aux_loss=aux.detach(), loss=metrics["loss"] + coef * aux.detach())
    return loss, metrics
