"""Datasets and collation.

Rebuild of the reference data layer (llava/data/dataset.py):

- ``SpatialDataset`` == LazySupervisedSpatialDataset (dataset.py:1700-1792):
  OpenSpatialDataset json, RGB jpg + 16-bit-normalized depth png + region
  annotations (rle / segmentation / bbox), ``<mask>`` rewritten to
  ``<mask> <depth>`` when depth is enabled.
- ``SupervisedDataset`` == LazySupervisedDataset (generic json/jsonl with
  optional images).
- ``Collator`` replaces both reference collators (dataset.py:1795-2154):
  every sample is expanded host-side (data/splice.py) and packed into
  static-shape VLMInputs; greedy packing reproduces
  DataCollatorForSupervisedDatasetSeqParallel's
  196-tokens-per-image accounting by construction (expansion happens
  before packing, so lengths are exact, not estimated).
- ``DATASETS`` mixture registry == datasets_mixture.py; '+' combines.

Everything is numpy; images load lazily in __getitem__.

The port's own copy of ``spatialrgpt_tpu/data/dataset.py``, less
``to_vlm_inputs``, the data layer's one JAX function: its twin is
``models/vlm.py::VLMInputs.from_spliced``, which takes the device.
"""

from __future__ import annotations

import copy
import json
import os
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from spatialrgpt_tpu_torch.constants import (
    DEFAULT_DEPTH_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    DEFAULT_MASK_TOKEN,
    IGNORE_INDEX,
    NUM_TOKENS_PER_IMAGE,
)
from spatialrgpt_tpu_torch.data import preprocess as pp
from spatialrgpt_tpu_torch.data import templates
from spatialrgpt_tpu_torch.data.splice import SplicedBatch, expand_rows, pack_rows


# ---------------------------------------------------------------------------
# Mixture registry (datasets_mixture.py:5-66)
# ---------------------------------------------------------------------------


@dataclass
class DatasetSpec:
    name: str
    dataset_type: str  # "spatial" | "vqa" | "dummy"
    data_path: str = ""
    image_path: Optional[str] = None
    depth_path: Optional[str] = None
    description: str = ""


DATASETS: Dict[str, DatasetSpec] = {}


def add_dataset(spec: DatasetSpec) -> None:
    DATASETS[spec.name] = spec


add_dataset(
    DatasetSpec(
        name="spatialrgpt_ft",
        dataset_type="spatial",
        data_path="data/OpenSpatialDataset/osd.json",
        image_path="data/OpenSpatialDataset/images",
        depth_path="data/OpenSpatialDataset/depths",
        description="Open Spatial Dataset SFT mixture (reference datasets_mixture.py:57-66)",
    )
)
add_dataset(
    DatasetSpec(
        name="llava_1_5_mm_align",
        dataset_type="vqa",
        data_path="data/llava_1_5/mm_align.json",
        image_path="data/llava_1_5/images",
        description="alignment-stage caption data (reference mixture name)",
    )
)
add_dataset(
    DatasetSpec(
        name="mmc4core",
        dataset_type="mmc4",
        data_path="data/mmc4core/shards.jsonl",
        image_path="data/mmc4core/images",
        description="interleaved web documents (LazyMMC4Dataset equivalent)",
    )
)
add_dataset(
    DatasetSpec(
        name="coyo_25m",
        dataset_type="coyo",
        data_path="data/coyo/shards.jsonl",
        image_path="data/coyo/images",
        description="caption pairs (LazyCoyoDataset equivalent)",
    )
)
add_dataset(
    DatasetSpec(
        name="vflan",
        dataset_type="vflan",
        data_path="data/vflan/shards.jsonl",
        image_path="data/vflan/images",
        description="instruction data (LazyVFlanDataset equivalent)",
    )
)
add_dataset(
    DatasetSpec(name="dummy", dataset_type="dummy", description="synthetic smoke data")
)


# ---------------------------------------------------------------------------
# Samples
# ---------------------------------------------------------------------------


@dataclass
class Sample:
    """One training example after host preprocessing."""

    input_ids: np.ndarray  # (T,) with IMAGE_TOKEN_INDEX placeholders
    labels: np.ndarray  # (T,)
    image: Optional[np.ndarray] = None  # (H, W, 3)
    depth: Optional[np.ndarray] = None  # (H, W, 3)
    masks: Optional[np.ndarray] = None  # (R, H, W)


class SpatialDataset:
    """OpenSpatialDataset-format region-QA dataset."""

    def __init__(
        self,
        data_path: str,
        tokenizer,
        processor: pp.SiglipProcessor,
        image_folder: Optional[str] = None,
        depth_folder: Optional[str] = None,
        enable_depth: bool = True,
        image_aspect_ratio: str = "resize",
        conv_template: str = "llama_3",
        seed: int = 0,
    ):
        with open(data_path) as f:
            self.entries = json.load(f)
        self.tokenizer = tokenizer
        self.processor = processor
        self.image_folder = image_folder
        self.depth_folder = depth_folder
        self.enable_depth = enable_depth
        self.image_aspect_ratio = image_aspect_ratio
        self.conv_template = conv_template
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i: int) -> Sample:
        # bad-sample tolerance (reference dataset.py:1770-1774): corrupt
        # image/depth/annotation -> retry a random other index
        for attempt in range(8):
            try:
                return self._get(i)
            except Exception:
                if attempt == 7:
                    raise
                i = int(self.rng.integers(len(self.entries)))

    def _get(self, i: int) -> Sample:
        entry = copy.deepcopy(self.entries[i])
        conversations = entry["conversations"]
        # <mask> -> <mask> <depth> rewrite (dataset.py:1745-1752 /
        # eval_spatial.py:206) when the depth branch is on
        if self.enable_depth:
            for turn in conversations:
                turn["value"] = turn["value"].replace(
                    DEFAULT_MASK_TOKEN, f"{DEFAULT_MASK_TOKEN} {DEFAULT_DEPTH_TOKEN}"
                )
        if DEFAULT_IMAGE_TOKEN not in conversations[0]["value"]:
            conversations[0]["value"] = (
                DEFAULT_IMAGE_TOKEN + "\n" + conversations[0]["value"]
            )

        image_file = entry.get("image") or entry["image_info"]["file_path"]
        image_path = (
            os.path.join(self.image_folder, image_file)
            if self.image_folder
            else image_file
        )
        image, info = pp.process_image(
            image_path, self.processor, self.image_aspect_ratio, return_info=True
        )
        if "image_info" not in entry:
            entry["image_info"] = {"height": info["height"], "width": info["width"]}

        depth = None
        if self.enable_depth:
            # depth png shares the basename (SURVEY S2.5: filename.jpg +
            # filename.png); fall back to the RGB image as fake depth like
            # the reference collator (dataset.py:1840-1845)
            depth_file = os.path.splitext(image_file)[0] + ".png"
            depth_path = (
                os.path.join(self.depth_folder, depth_file)
                if self.depth_folder
                else depth_file
            )
            if os.path.exists(depth_path):
                depth = pp.process_depth(
                    depth_path, self.processor, self.image_aspect_ratio
                )
            else:
                depth = image.copy()

        raw_masks = pp.masks_from_annotations(entry, rng=self.rng)
        masks = pp.process_masks(raw_masks, self.processor, self.image_aspect_ratio)

        templates.set_default_template(self.conv_template)
        out = templates.preprocess([conversations], self.tokenizer, has_image=True)
        return Sample(
            input_ids=out["input_ids"][0],
            labels=out["labels"][0],
            image=image,
            depth=depth,
            masks=masks,
        )


class SupervisedDataset:
    """Generic conversation dataset (json/jsonl; optional image per entry)."""

    def __init__(
        self,
        data_path: str,
        tokenizer,
        processor: pp.SiglipProcessor,
        image_folder: Optional[str] = None,
        image_aspect_ratio: str = "resize",
        conv_template: str = "llama_3",
    ):
        if data_path.endswith(".jsonl"):
            with open(data_path) as f:
                self.entries = [json.loads(l) for l in f if l.strip()]
        else:
            with open(data_path) as f:
                self.entries = json.load(f)
        self.tokenizer = tokenizer
        self.processor = processor
        self.image_folder = image_folder
        self.image_aspect_ratio = image_aspect_ratio
        self.conv_template = conv_template

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i: int) -> Sample:
        entry = copy.deepcopy(self.entries[i])
        conversations = entry["conversations"]
        has_image = "image" in entry
        image = None
        if has_image:
            if DEFAULT_IMAGE_TOKEN not in conversations[0]["value"]:
                conversations[0]["value"] = (
                    DEFAULT_IMAGE_TOKEN + "\n" + conversations[0]["value"]
                )
            path = (
                os.path.join(self.image_folder, entry["image"])
                if self.image_folder
                else entry["image"]
            )
            image = pp.process_image(path, self.processor, self.image_aspect_ratio)
        templates.set_default_template(self.conv_template)
        out = templates.preprocess([conversations], self.tokenizer, has_image=has_image)
        return Sample(input_ids=out["input_ids"][0], labels=out["labels"][0], image=image)


class PreferenceDataset:
    """(chosen, rejected) preference pairs for DPO training (the
    reference's vendored-TRL DPO branch, llava/train/train.py:708-739;
    the trl directory is absent from the snapshot so the row format
    follows the standard DPO convention: prompt + chosen + rejected,
    optionally an image).  __getitem__ returns a (Sample, Sample) pair
    sharing the prompt/image."""

    def __init__(
        self,
        data_path: str,
        tokenizer,
        processor: pp.SiglipProcessor,
        image_folder: Optional[str] = None,
        image_aspect_ratio: str = "resize",
        conv_template: str = "llama_3",
    ):
        if data_path.endswith(".jsonl"):
            with open(data_path) as f:
                self.entries = [json.loads(l) for l in f if l.strip()]
        else:
            with open(data_path) as f:
                self.entries = json.load(f)
        self.tokenizer = tokenizer
        self.processor = processor
        self.image_folder = image_folder
        self.image_aspect_ratio = image_aspect_ratio
        self.conv_template = conv_template

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i: int):
        entry = copy.deepcopy(self.entries[i])
        prompt = entry.get("prompt")
        if prompt is None:
            prompt = entry["conversations"][0]["value"]
        has_image = "image" in entry
        image = None
        if has_image:
            if DEFAULT_IMAGE_TOKEN not in prompt:
                prompt = DEFAULT_IMAGE_TOKEN + "\n" + prompt
            path = (
                os.path.join(self.image_folder, entry["image"])
                if self.image_folder
                else entry["image"]
            )
            image = pp.process_image(path, self.processor, self.image_aspect_ratio)
        templates.set_default_template(self.conv_template)

        def build(answer: str) -> Sample:
            conv = [
                {"from": "human", "value": prompt},
                {"from": "gpt", "value": answer},
            ]
            out = templates.preprocess([conv], self.tokenizer, has_image=has_image)
            return Sample(
                input_ids=out["input_ids"][0], labels=out["labels"][0], image=image
            )

        return build(entry["chosen"]), build(entry["rejected"])


class DummyDataset:
    """Synthetic prompt/answer pairs (reference DummyDataset,
    dataset.py:639-750) — the fake-data backend for tests and smoke runs."""

    CAPTIONS = [
        "a red cube on a table",
        "two boxes side by side",
        "a chair in front of a window",
        "a tall lamp behind the couch",
    ]

    def __init__(self, tokenizer, processor, size=32, image_size=384, with_regions=True,
                 conv_template="llama_3", seed=0):
        self.tokenizer = tokenizer
        self.processor = processor
        self.size = size
        self.image_size = image_size
        self.with_regions = with_regions
        self.conv_template = conv_template
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.size

    def __getitem__(self, i: int) -> Sample:
        cap = self.CAPTIONS[i % len(self.CAPTIONS)]
        q = f"{DEFAULT_IMAGE_TOKEN}\nWhat is <mask> <depth>?"
        conv = [
            {"from": "human", "value": q},
            {"from": "gpt", "value": cap},
        ]
        templates.set_default_template(self.conv_template)
        out = templates.preprocess([conv], self.tokenizer, has_image=True)
        s = self.image_size
        img = self.rng.standard_normal((s, s, 3)).astype(np.float32)
        masks = (self.rng.random((1, s, s)) > 0.5).astype(np.float32)
        return Sample(
            input_ids=out["input_ids"][0],
            labels=out["labels"][0],
            image=img,
            depth=img.copy(),
            masks=masks if self.with_regions else None,
        )


# ---------------------------------------------------------------------------
# Collator
# ---------------------------------------------------------------------------


@dataclass
class CollatorConfig:
    max_len: int = 4096
    pack: bool = True  # greedy packing (reference non-SP collator packs too)
    tokens_per_image: int = NUM_TOKENS_PER_IMAGE
    mask_token_id: int = -1
    depth_token_id: int = -1
    regions_per_image: int = 8
    image_size: int = 384
    pad_batch_to: Optional[int] = None  # fixed row count for static shapes


class Collator:
    """Samples -> (SplicedBatch, images, depths, masks, mask_valid).

    Static-shape guarantees: masks padded to ``regions_per_image`` slots
    per image; rows padded to ``max_len``; optionally a fixed row count.
    """

    def __init__(self, cfg: CollatorConfig):
        self.cfg = cfg

    def __call__(self, samples: Sequence[Sample]):
        cfg = self.cfg
        per_sample = []
        images, depths, masks_list = [], [], []
        for s in samples:
            sb = expand_rows(
                [s.input_ids],
                [s.labels],
                max_len=cfg.max_len,
                tokens_per_image=cfg.tokens_per_image,
                mask_token_id=cfg.mask_token_id,
                depth_token_id=cfg.depth_token_id,
                regions_per_image=cfg.regions_per_image,
            )
            per_sample.append(sb)
            if s.image is not None:
                images.append(s.image)
                depths.append(s.depth if s.depth is not None else s.image)
                m, v = pp.pad_masks_to_slots(
                    s.masks, cfg.regions_per_image, cfg.image_size
                )
                masks_list.append((m, v))

        # NOTE: image slot indices assigned by expand_rows are per-call
        # sequential; since we expand one sample at a time each call starts
        # at 0 — renumber to global order here.
        offset = 0
        for sb in per_sample:
            n_img = int(sb.is_image.sum()) // cfg.tokens_per_image
            sb.image_gather_idx[sb.is_image] += offset * cfg.tokens_per_image
            sb.mask_slot[sb.is_mask] += offset * cfg.regions_per_image
            sb.depth_slot[sb.is_depth] += offset * cfg.regions_per_image
            offset += n_img

        if cfg.pack:
            batch = pack_rows(per_sample, max_len=cfg.max_len)
        else:
            width = max(sb.input_ids.shape[1] for sb in per_sample)
            batch = _stack_rows(per_sample, width)

        if cfg.pad_batch_to is not None and batch.input_ids.shape[0] < cfg.pad_batch_to:
            batch = _pad_batch_rows(batch, cfg.pad_batch_to)

        if images:
            images_arr = np.stack(images)
            depths_arr = np.stack(depths)
            masks_arr = np.stack([m for m, _ in masks_list])
            valid_arr = np.stack([v for _, v in masks_list])
        else:
            s = cfg.image_size
            images_arr = np.zeros((1, s, s, 3), np.float32)
            depths_arr = np.zeros((1, s, s, 3), np.float32)
            masks_arr = np.zeros((1, cfg.regions_per_image, s, s), np.float32)
            valid_arr = np.zeros((1, cfg.regions_per_image), bool)
        return batch, images_arr, depths_arr, masks_arr, valid_arr


def _stack_rows(per_sample: List[SplicedBatch], width: int) -> SplicedBatch:
    def cat(name, fill):
        rows = []
        for sb in per_sample:
            a = getattr(sb, name)
            pad = np.full((1, width - a.shape[1]), fill, a.dtype)
            rows.append(np.concatenate([a, pad], axis=1))
        return np.concatenate(rows, axis=0)

    return SplicedBatch(
        input_ids=cat("input_ids", 0),
        is_image=cat("is_image", False),
        image_gather_idx=cat("image_gather_idx", 0),
        position_ids=cat("position_ids", 0),
        segment_ids=cat("segment_ids", 0),
        labels=cat("labels", IGNORE_INDEX),
        mask_slot=cat("mask_slot", 0),
        is_mask=cat("is_mask", False),
        depth_slot=cat("depth_slot", 0),
        is_depth=cat("is_depth", False),
    )


def _pad_batch_rows(batch: SplicedBatch, rows: int) -> SplicedBatch:
    def pad(a, fill):
        extra = np.full((rows - a.shape[0], a.shape[1]), fill, a.dtype)
        return np.concatenate([a, extra], axis=0)

    return SplicedBatch(
        input_ids=pad(batch.input_ids, 0),
        is_image=pad(batch.is_image, False),
        image_gather_idx=pad(batch.image_gather_idx, 0),
        position_ids=pad(batch.position_ids, 0),
        segment_ids=pad(batch.segment_ids, 0),
        labels=pad(batch.labels, IGNORE_INDEX),
        mask_slot=pad(batch.mask_slot, 0),
        is_mask=pad(batch.is_mask, False),
        depth_slot=pad(batch.depth_slot, 0),
        is_depth=pad(batch.is_depth, False),
    )


def build_datasets(
    mixture: str,
    tokenizer,
    processor,
    conv_template: str = "llama_3",
    **kw,
):
    """'a+b+c' mixture -> concatenated dataset list
    (reference build_datasets, dataset.py:2189-2251)."""
    parts = []
    for name in mixture.split("+"):
        spec = DATASETS[name.strip()]
        if spec.dataset_type == "spatial":
            parts.append(
                SpatialDataset(
                    spec.data_path,
                    tokenizer,
                    processor,
                    image_folder=spec.image_path,
                    depth_folder=spec.depth_path,
                    conv_template=conv_template,
                    **kw,
                )
            )
        elif spec.dataset_type == "dummy":
            parts.append(DummyDataset(tokenizer, processor, conv_template=conv_template))
        elif spec.dataset_type in ("mmc4", "coyo", "vflan"):
            from spatialrgpt_tpu_torch.data import interleaved

            cls = {
                "mmc4": interleaved.MMC4Dataset,
                "coyo": interleaved.CoyoDataset,
                "vflan": interleaved.VFlanDataset,
            }[spec.dataset_type]
            extra = {"conv_template": conv_template} if spec.dataset_type == "vflan" else {}
            parts.append(
                cls(spec.data_path, tokenizer, processor, image_folder=spec.image_path, **extra)
            )
        else:
            parts.append(
                SupervisedDataset(
                    spec.data_path,
                    tokenizer,
                    processor,
                    image_folder=spec.image_path,
                    conv_template=conv_template,
                )
            )
    return ConcatDataset(parts)


class ConcatDataset:
    def __init__(self, parts):
        self.parts = parts
        self.offsets = np.cumsum([len(p) for p in parts])

    def __len__(self):
        return int(self.offsets[-1]) if len(self.parts) else 0

    def __getitem__(self, i):
        part = int(np.searchsorted(self.offsets, i, side="right"))
        prev = 0 if part == 0 else int(self.offsets[part - 1])
        return self.parts[part][i - prev]
