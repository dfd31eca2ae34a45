"""Host-side multimodal sequence expansion.

The reference interleaves text embeddings and image features with a
per-sample python loop on device
(llava/model/llava_arch.py:453-539, `prepare_inputs_labels_for_multimodal`).
TPU-native, we split that into:

  1. THIS module (host, numpy, part of data prep): expand each tokenized
     sequence by replacing every IMAGE_TOKEN_INDEX with
     NUM_TOKENS_PER_IMAGE placeholder positions and precompute, for every
     output position, whether it is text / image / padding and which flat
     image-feature row it reads.  Pure integer bookkeeping, no tensors.
  2. models/vlm.py (device, jit): one gather + two where-scatters build
     the final (B, S, H) embedding tensor with static shapes.

Semantics mirrored exactly from the reference:
  - labels at image positions are IGNORE_INDEX (llava_arch.py:530-537),
  - sequences are truncated to max_len AFTER expansion (llava_arch.py:541-546),
  - right padding, fresh per-row position_ids (llava_arch.py:593-611),
  - <mask>/<depth> tokens keep their position (spliced in place, not
    expanded; llava_arch.py:470-501).

The port's own copy of ``spatialrgpt_tpu/data/splice.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from spatialrgpt_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX, NUM_TOKENS_PER_IMAGE


@dataclass
class SplicedBatch:
    """Static-shape device inputs for the multimodal forward pass.

    All arrays are (B, S) unless noted.  ``image_gather_idx`` indexes into
    the flattened (num_images * tokens_per_image,) image-feature rows.
    """

    input_ids: np.ndarray  # int32; image slots hold 0
    is_image: np.ndarray  # bool
    image_gather_idx: np.ndarray  # int32
    position_ids: np.ndarray  # int32
    segment_ids: np.ndarray  # int32; 0 = padding
    labels: np.ndarray  # int32; IGNORE_INDEX where masked
    # region bookkeeping: for <mask>/<depth> splicing on device.
    # Slots index the FLAT (num_images * regions_per_image,) region table:
    # row's k-th <mask> reads region k of the row's first image, matching
    # the reference's mask_embeds[cur_image_idx][:num_mask]
    # (llava_arch.py:470-501).  Flat indexing keeps packed rows (multiple
    # samples -> multiple images per row) well-defined.
    mask_slot: np.ndarray  # int32
    is_mask: np.ndarray  # bool
    depth_slot: np.ndarray  # int32
    is_depth: np.ndarray  # bool


def expand_rows(
    input_ids_rows: Sequence[np.ndarray],
    labels_rows: Optional[Sequence[np.ndarray]],
    *,
    max_len: int,
    tokens_per_image: int = NUM_TOKENS_PER_IMAGE,
    mask_token_id: int = -1,
    depth_token_id: int = -1,
    regions_per_image: int = 0,
    pad_to: Optional[int] = None,
) -> SplicedBatch:
    """Expand tokenized rows (with IMAGE_TOKEN_INDEX placeholders) into the
    static splice layout.

    ``image_gather_idx`` numbers images in row-major (batch, occurrence)
    order, matching the reference's ``cur_image_idx`` walk over the
    flattened image batch (llava_arch.py:452-526).
    """
    B = len(input_ids_rows)
    if labels_rows is None:
        labels_rows = [np.full_like(r, IGNORE_INDEX) for r in input_ids_rows]

    out_ids, out_isimg, out_gather, out_pos, out_seg, out_lab = [], [], [], [], [], []
    out_mslot, out_ismask, out_dslot, out_isdep = [], [], [], []

    img_counter = 0
    for b in range(B):
        ids = np.asarray(input_ids_rows[b])
        labs = np.asarray(labels_rows[b])
        row_first_image = img_counter  # regions of this row live at this image's slots
        r_ids: List[int] = []
        r_isimg: List[bool] = []
        r_gather: List[int] = []
        r_lab: List[int] = []
        for t, tok in enumerate(ids.tolist()):
            if tok == IMAGE_TOKEN_INDEX:
                base = img_counter * tokens_per_image
                img_counter += 1
                r_ids.extend([0] * tokens_per_image)
                r_isimg.extend([True] * tokens_per_image)
                r_gather.extend(range(base, base + tokens_per_image))
                r_lab.extend([IGNORE_INDEX] * tokens_per_image)
            else:
                r_ids.append(tok)
                r_isimg.append(False)
                r_gather.append(0)
                r_lab.append(int(labs[t]))
        # truncate after expansion (reference llava_arch.py:541-546)
        r_ids = r_ids[:max_len]
        r_isimg = r_isimg[:max_len]
        r_gather = r_gather[:max_len]
        r_lab = r_lab[:max_len]
        cur = len(r_ids)

        ids_arr = np.asarray(r_ids, np.int32)
        is_mask = (ids_arr == mask_token_id) if mask_token_id >= 0 else np.zeros(cur, bool)
        is_depth = (ids_arr == depth_token_id) if depth_token_id >= 0 else np.zeros(cur, bool)
        # occurrence index within the row: k-th <mask> reads region k of
        # the row's first image, flat into (num_images * regions_per_image)
        base = row_first_image * max(regions_per_image, 1)
        mask_slot = np.where(is_mask, base + np.cumsum(is_mask) - 1, 0).astype(np.int32)
        depth_slot = np.where(is_depth, base + np.cumsum(is_depth) - 1, 0).astype(np.int32)
        # mask/depth token ids may exceed the base vocab (added tokens);
        # their embedding rows are never used (overwritten by region
        # embeds) but keep ids in range for the gather.
        out_ids.append(ids_arr)
        out_isimg.append(np.asarray(r_isimg, bool))
        out_gather.append(np.asarray(r_gather, np.int32))
        out_pos.append(np.arange(cur, dtype=np.int32))
        out_seg.append(np.ones(cur, np.int32))
        out_lab.append(np.asarray(r_lab, np.int32))
        out_mslot.append(mask_slot)
        out_ismask.append(is_mask)
        out_dslot.append(depth_slot)
        out_isdep.append(is_depth)

    S = pad_to if pad_to is not None else max(len(r) for r in out_ids)
    S = min(S, max_len) if pad_to is None else pad_to

    def pad(rows, fill, dtype):
        arr = np.full((B, S), fill, dtype)
        for i, r in enumerate(rows):
            arr[i, : len(r)] = r[:S]
        return arr

    return SplicedBatch(
        input_ids=pad(out_ids, 0, np.int32),
        is_image=pad(out_isimg, False, bool),
        image_gather_idx=pad(out_gather, 0, np.int32),
        position_ids=pad(out_pos, 0, np.int32),
        segment_ids=pad(out_seg, 0, np.int32),
        labels=pad(out_lab, IGNORE_INDEX, np.int32),
        mask_slot=pad(out_mslot, 0, np.int32),
        is_mask=pad(out_ismask, False, bool),
        depth_slot=pad(out_dslot, 0, np.int32),
        is_depth=pad(out_isdep, False, bool),
    )


def pack_rows(batch_rows: List[SplicedBatch], max_len: int) -> SplicedBatch:
    """Greedy length-descending packing of single-row SplicedBatches into
    fewer rows (reference repack_multimodal_data, llava_arch.py:815-907):
    sort by length desc, first-fit into rows <= max_len, distinct segment
    ids per original sample, fresh per-sample position ids."""
    rows = []
    for sb in batch_rows:
        n = int(sb.segment_ids[0].sum())
        rows.append((n, sb))
    rows.sort(key=lambda x: -x[0])

    bins: List[List[SplicedBatch]] = []
    bin_lens: List[int] = []
    for n, sb in rows:
        placed = False
        for i in range(len(bins)):
            if bin_lens[i] + n <= max_len:
                bins[i].append(sb)
                bin_lens[i] += n
                placed = True
                break
        if not placed:
            bins.append([sb])
            bin_lens.append(n)

    B = len(bins)
    S = max_len

    def empty(fill, dtype):
        return np.full((B, S), fill, dtype)

    out = SplicedBatch(
        input_ids=empty(0, np.int32),
        is_image=empty(False, bool),
        image_gather_idx=empty(0, np.int32),
        position_ids=empty(0, np.int32),
        segment_ids=empty(0, np.int32),
        labels=empty(IGNORE_INDEX, np.int32),
        mask_slot=empty(0, np.int32),
        is_mask=empty(False, bool),
        depth_slot=empty(0, np.int32),
        is_depth=empty(False, bool),
    )
    for bi, group in enumerate(bins):
        off = 0
        for si, sb in enumerate(group):
            n = int(sb.segment_ids[0].sum())
            sl = slice(off, off + n)
            out.input_ids[bi, sl] = sb.input_ids[0, :n]
            out.is_image[bi, sl] = sb.is_image[0, :n]
            out.image_gather_idx[bi, sl] = sb.image_gather_idx[0, :n]
            out.position_ids[bi, sl] = sb.position_ids[0, :n]
            out.segment_ids[bi, sl] = si + 1
            out.labels[bi, sl] = sb.labels[0, :n]
            out.mask_slot[bi, sl] = sb.mask_slot[0, :n]
            out.is_mask[bi, sl] = sb.is_mask[0, :n]
            out.depth_slot[bi, sl] = sb.depth_slot[0, :n]
            out.is_depth[bi, sl] = sb.is_depth[0, :n]
            off += n
    return out
