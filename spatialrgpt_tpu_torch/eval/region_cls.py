"""Region classification evaluation, COCO / ODinW protocol (port of
``spatialrgpt_tpu/eval/region_cls.py``).

Per annotated region: a square crop centred on the region box, a
``<mask>`` classification prompt drawn (seeded) from the 15-paraphrase
bank, greedy decode, and a score against the category names (substring
match).  ``PROMPTS``, ``get_crop_box``, ``score_region_predictions`` and
``coco_annotation_to_items`` are the reference's code
(``tests/test_torch_eval.py`` holds them to it); ``run_region_cls`` runs
the batches through the port's ``generate`` (its default route: the
kernels on the card), on the card unless the caller passes ``device``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from spatialrgpt_tpu_torch.constants import DEFAULT_IMAGE_TOKEN, NUM_TOKENS_PER_IMAGE
from spatialrgpt_tpu_torch.conversation import conv_templates
from spatialrgpt_tpu_torch.data import preprocess as pp
from spatialrgpt_tpu_torch.data.splice import expand_rows
from spatialrgpt_tpu_torch.data.tokenize import tokenizer_image_token
from spatialrgpt_tpu_torch.eval.common import batch_inputs, cut_at_eos, eval_device, prompt_lengths
from spatialrgpt_tpu_torch.serving.generate import generate

PROMPTS = [
    "Identify the object or feature present in the region denoted by <mask>.",
    "What category best describes the area represented by <mask>?",
    "Describe the content of the image section highlighted by <mask>.",
    "Can you specify the type of object or landscape within the bounds of <mask>?",
    "Which of the following categories best fits the region marked by <mask>? Provide your answer.",
    "What can you discern from the area indicated by <mask> in the image?",
    "Categorize the visual element within the area designated by <mask>.",
    "Give a brief description of the item or scene captured in the segment marked by <mask>.",
    "Which classification would you assign to the visual content found at <mask>?",
    "Determine and describe the primary subject located within <mask>.",
    "How would you label the section of the image encompassed by <mask>?",
    "Assess and classify the feature present within the confines of <mask>.",
    "If you were to tag the section indicated by <mask>, what tag would you use?",
    "What stands out to you in the region demarcated by <mask>? Please classify it.",
    "Evaluate the content of the image portion pinpointed by <mask> and provide its category.",
]


def get_crop_box(bboxes: List[List[float]], image_info: Dict) -> List[int]:
    """Square, short-side-sized crop centered on the first region box
    (eval_region_cls.py:49-72 semantics, including the full-image
    fallback for oversized regions)."""
    short = min(image_info["height"], image_info["width"])
    bbox = bboxes[0]
    if bbox[3] - bbox[1] > short or bbox[2] - bbox[0] > short:
        return [0, 0, image_info["width"], image_info["height"]]
    cx, cy = int((bbox[0] + bbox[2]) / 2), int((bbox[1] + bbox[3]) / 2)
    x_left, x_right = cx - short // 2, cx + short // 2
    y_top, y_bottom = cy - short // 2, cy + short // 2
    if x_left < 0:
        x_left, x_right = 0, short
    if x_right > short:
        x_left, x_right = image_info["width"] - short, image_info["width"]
    if y_top < 0:
        y_top, y_bottom = 0, short
    if y_bottom > short:
        y_top, y_bottom = image_info["height"] - short, image_info["height"]
    return [x_left, y_top, x_right, y_bottom]


def score_region_predictions(
    records: List[Dict], categories: Optional[List[str]] = None
) -> Dict[str, float]:
    """records: [{pred, gt_category}]; accuracy = gt name appears in the
    prediction (case-insensitive), the one-by-one COCO scorer protocol."""
    correct = 0
    per_cat = {}
    for r in records:
        gt = r["gt_category"].lower()
        hit = gt in r["pred"].lower()
        correct += int(hit)
        c = per_cat.setdefault(gt, [0, 0])
        c[0] += int(hit)
        c[1] += 1
    out = {"accuracy": 100.0 * correct / max(len(records), 1)}
    for cat, (h, n) in sorted(per_cat.items()):
        out[f"acc_{cat}"] = 100.0 * h / n
    return out


def coco_annotation_to_items(coco_json: Dict) -> List[Dict]:
    """COCO instances json -> per-annotation eval items
    (eval_region_cls.py:98-147 generate_data_list)."""
    id_to_img = {im["id"]: im for im in coco_json["images"]}
    id_to_cat = {c["id"]: c["name"] for c in coco_json["categories"]}
    items = []
    for ann in coco_json["annotations"]:
        if ann.get("iscrowd", 0):
            continue
        im = id_to_img[ann["image_id"]]
        x, y, w, h = ann["bbox"]
        items.append(
            {
                "file_name": im["file_name"],
                "image_info": {"height": im["height"], "width": im["width"]},
                "bbox": [x, y, x + w, y + h],
                "segmentation": ann.get("segmentation"),
                "category": id_to_cat[ann["category_id"]],
            }
        )
    return items



def run_region_cls(
    model,
    items: List[Dict],
    image_folder: str,
    answers_file: str = "region_cls.jsonl",
    conv_mode: str = "llama_3",
    batch_size: int = 16,
    max_new_tokens: int = 32,
    prompt_bucket: int = 512,
    crop: bool = True,
    seed: int = 0,
    *,
    device=None,
) -> str:
    """Region classification: per item a square crop around the region, a
    random paraphrase ``<mask>`` prompt (``seed``), batched greedy decode;
    writes jsonl records of pred and gt_category for
    ``score_region_predictions``.  One region a row, the image doubling as
    its depth."""
    from PIL import Image

    dev = eval_device(device)
    tokenizer, net, cfg, processor = model
    rng = np.random.default_rng(seed)
    out = open(answers_file, "w")

    for start in range(0, len(items), batch_size):
        chunk = items[start : start + batch_size]
        rows, images, mask_stacks, valids, metas = [], [], [], [], []
        for item in chunk:
            info = item["image_info"]
            img = Image.open(os.path.join(image_folder, item["file_name"])).convert("RGB")
            mask = np.zeros((info["height"], info["width"]), np.uint8)
            x1, y1, x2, y2 = (int(v) for v in item["bbox"])
            mask[y1:y2, x1:x2] = 1
            if crop:
                cb = get_crop_box([item["bbox"]], info)
                img = img.crop(tuple(cb))
                mask = mask[cb[1] : cb[3], cb[0] : cb[2]]
            image = pp.process_image(img, processor, cfg.image_aspect_ratio)
            proc_masks = pp.process_masks([mask], processor, cfg.image_aspect_ratio)
            m, v = pp.pad_masks_to_slots(proc_masks, 1, processor.size)

            prompt_text = PROMPTS[int(rng.integers(len(PROMPTS)))]
            prompt_text = prompt_text.replace("<mask>", "<mask> <depth>")
            conv = conv_templates[conv_mode].copy()
            conv.append_message(conv.roles[0], DEFAULT_IMAGE_TOKEN + "\n" + prompt_text)
            conv.append_message(conv.roles[1], None)
            rows.append(np.asarray(tokenizer_image_token(conv.get_prompt(), tokenizer), np.int64))
            images.append(image)
            mask_stacks.append(m)
            valids.append(v)
            metas.append(item)

        sb = expand_rows(
            rows, None,
            max_len=cfg.model_max_length,
            tokens_per_image=NUM_TOKENS_PER_IMAGE,
            mask_token_id=cfg.mask_token_id,
            depth_token_id=cfg.depth_token_id,
            regions_per_image=1,
            pad_to=prompt_bucket,
        )
        imgs = np.stack(images)
        inputs = batch_inputs(net, sb, imgs, None, np.stack(mask_stacks), np.stack(valids), dev)
        inputs = inputs._replace(depths=inputs.images)
        result = generate(net, cfg, inputs, prompt_lengths(sb, dev), max_new_tokens=max_new_tokens, temperature=0.0)
        toks = result.tokens.cpu().numpy()
        for i, item in enumerate(metas):
            ids = cut_at_eos(toks[i].tolist(), cfg.llm.eos_token_id)
            text = tokenizer.decode(ids, skip_special_tokens=True).strip()
            out.write(json.dumps({"pred": text, "gt_category": item["category"],
                                  "file_name": item["file_name"]}) + "\n")
    out.close()
    return answers_file
