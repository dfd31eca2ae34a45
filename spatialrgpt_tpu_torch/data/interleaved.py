"""Interleaved image-text datasets (MMC4 / COYO / VFlan families).

Rebuild of the reference's web-corpus loaders (llava/data/dataset.py:
LazyMMC4Dataset :1091, LazyCoyoDataset :1295, LazyVFlanDataset :1470):
documents carry several images interleaved with text; each sample becomes
one token stream with an ``<image>`` placeholder at each image's
text position and labels covering the text (captions supervised,
image spans IGNORE).  Storage format here is jsonl shards:

  MMC4-style:  {"text_list": [...], "image_info": [{"matched_text_index":
               i, "image_name": f}, ...]}
  COYO-style:  {"url"|"image": f, "text": caption}
  VFlan-style: {"image": f|[f...], "question": q, "answer": a}

The port's own copy of ``spatialrgpt_tpu/data/interleaved.py``.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from spatialrgpt_tpu_torch.constants import DEFAULT_IMAGE_TOKEN, IGNORE_INDEX
from spatialrgpt_tpu_torch.data import preprocess as pp
from spatialrgpt_tpu_torch.data.dataset import Sample
from spatialrgpt_tpu_torch.data.tokenize import tokenizer_image_token


def _load_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(l) for l in f if l.strip()]


class MMC4Dataset:
    """Interleaved documents: text sentences with images attached at
    sentence indices; supervision on all text."""

    def __init__(self, data_path, tokenizer, processor, image_folder=None,
                 max_images: int = 6, image_aspect_ratio: str = "resize"):
        self.entries = _load_jsonl(data_path)
        self.tokenizer = tokenizer
        self.processor = processor
        self.image_folder = image_folder
        self.max_images = max_images
        self.image_aspect_ratio = image_aspect_ratio

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i: int) -> Sample:
        entry = self.entries[i]
        sentences = list(entry["text_list"])
        images = []
        # splice "<image>" before each matched sentence (MMC4 convention)
        for info in entry.get("image_info", [])[: self.max_images]:
            idx = min(info["matched_text_index"], len(sentences) - 1)
            sentences[idx] = DEFAULT_IMAGE_TOKEN + sentences[idx]
            path = (
                os.path.join(self.image_folder, info["image_name"])
                if self.image_folder
                else info["image_name"]
            )
            images.append(pp.process_image(path, self.processor, self.image_aspect_ratio))
        text = " ".join(sentences)
        ids = np.asarray(tokenizer_image_token(text, self.tokenizer), np.int64)
        labels = ids.copy()
        labels[ids < 0] = IGNORE_INDEX  # image placeholders
        image = np.stack(images) if images else None
        return Sample(input_ids=ids, labels=labels, image=image)


class CoyoDataset:
    """Caption pairs: '<image>caption' with the caption supervised."""

    def __init__(self, data_path, tokenizer, processor, image_folder=None,
                 image_aspect_ratio: str = "resize"):
        self.entries = _load_jsonl(data_path)
        self.tokenizer = tokenizer
        self.processor = processor
        self.image_folder = image_folder
        self.image_aspect_ratio = image_aspect_ratio

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i: int) -> Sample:
        entry = self.entries[i]
        img_file = entry.get("image") or entry["url"]
        path = os.path.join(self.image_folder, img_file) if self.image_folder else img_file
        image = pp.process_image(path, self.processor, self.image_aspect_ratio)
        text = DEFAULT_IMAGE_TOKEN + entry["text"]
        ids = np.asarray(tokenizer_image_token(text, self.tokenizer), np.int64)
        labels = ids.copy()
        # mask bos + image placeholder; caption supervised
        labels[ids < 0] = IGNORE_INDEX
        if len(labels) and self.tokenizer.bos_token_id is not None and ids[0] == self.tokenizer.bos_token_id:
            labels[0] = IGNORE_INDEX
        return Sample(input_ids=ids, labels=labels, image=image)


class VFlanDataset:
    """Instruction data: question supervised->masked, answer supervised."""

    def __init__(self, data_path, tokenizer, processor, image_folder=None,
                 conv_template: str = "v1", image_aspect_ratio: str = "resize"):
        self.entries = _load_jsonl(data_path)
        self.tokenizer = tokenizer
        self.processor = processor
        self.image_folder = image_folder
        self.conv_template = conv_template
        self.image_aspect_ratio = image_aspect_ratio

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i: int) -> Sample:
        from spatialrgpt_tpu_torch.data import templates

        entry = self.entries[i]
        q = entry["question"]
        if DEFAULT_IMAGE_TOKEN not in q:
            q = DEFAULT_IMAGE_TOKEN + "\n" + q
        conv = [
            {"from": "human", "value": q},
            {"from": "gpt", "value": entry["answer"]},
        ]
        templates.set_default_template(self.conv_template)
        out = templates.preprocess([conv], self.tokenizer, has_image=True)
        img_files = entry.get("image")
        image = None
        if img_files:
            if isinstance(img_files, str):
                img_files = [img_files]
            imgs = [
                pp.process_image(
                    os.path.join(self.image_folder, f) if self.image_folder else f,
                    self.processor,
                    self.image_aspect_ratio,
                )
                for f in img_files
            ]
            image = imgs[0] if len(imgs) == 1 else np.stack(imgs)
        return Sample(input_ids=out["input_ids"][0], labels=out["labels"][0], image=image)
