"""The demo path as one batch pipeline on the port's models: the stages of
``bench_demo.py::main`` (the reference demo's flow: Depth-Anything depth,
SAM-HQ masks from box prompts, region QA), with every stage on the card.

    image -> stage_depth: Depth-Anything colorized depth (uint8 x 3)
          -> stage_sam: SAM-HQ mask logits, 2 boxes per image, in chunks
          -> preprocess_for_vlm: image, depth and masks to the SigLIP size
          -> stage_vlm: region QA through ``serving/generate.py``

Preprocessing runs on the device (``data/device_preprocess.py``) where
``bench_demo.py`` uses the host's PIL path; both are Pillow's bicubic bit for
bit.  Prompts are token ids built as ``bench_demo.py`` builds them: no
tokenizer is part of the port.  ``segment_boxes_fn`` and
``estimate_depth_fn`` adapt the models to the JAX package's framework-free
``DemoEngine`` (``demo/engine.py``), re-exported here with ``DemoState``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from spatialrgpt_tpu_torch.config import SpatialRGPTConfig
from spatialrgpt_tpu_torch.constants import IMAGE_TOKEN_INDEX, NUM_TOKENS_PER_IMAGE
from spatialrgpt_tpu_torch.data.splice import expand_rows
from spatialrgpt_tpu_torch.demo.engine import DemoEngine, DemoState  # noqa: F401  (re-exported)
from spatialrgpt_tpu_torch.data.device_preprocess import (
    device_mask_resize_nearest,
    device_preprocess_uint8,
    device_resize_uint8,
)
from spatialrgpt_tpu_torch.models import sam as sam_lib
from spatialrgpt_tpu_torch.models.depth_anything import DepthPredictor
from spatialrgpt_tpu_torch.models.vlm import SpatialRGPT, VLMInputs
from spatialrgpt_tpu_torch.serving.generate import GenerateResult, generate

SAM_CHUNK = 4  # images per SAM call (bench_demo.py's SRGPT_DEMO_SAM_CHUNK)
N_REGIONS = 2  # box prompts, so region slots, per image
_SAM_MEAN = (0.485, 0.456, 0.406)
_SAM_STD = (0.229, 0.224, 0.225)


def synth_photo(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Deterministic photo-like uint8 image: sky / ground gradient + boxes
    (``bench_demo.py::synth_photo``)."""
    img = np.zeros((h, w, 3), np.float32)
    img[:, :, 2] = np.linspace(220, 80, h)[:, None]
    img[h // 2 :, :, :] = [90, 75, 60]
    oy, ox = max(h // 8, 8), max(w // 8, 8)
    for _ in range(6):
        y = int(rng.integers(h // 3, max(h - oy, h // 3 + 1)))
        x = int(rng.integers(0, max(w - ox, 1)))
        bh, bw = int(rng.integers(oy // 2, oy)), int(rng.integers(ox // 2, ox))
        img[y : y + bh, x : x + bw] = rng.uniform(40, 255, 3)
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def demo_boxes(batch: int, h: int, w: int) -> np.ndarray:
    """The demo's two user boxes per image, xyxy in image pixels (B, 2, 4)."""
    one = np.array([[w * 0.1, h * 0.55, w * 0.45, h * 0.95], [w * 0.55, h * 0.5, w * 0.9, h * 0.9]], np.float32)
    return np.stack([one] * batch)


def demo_prompts(cfg: SpatialRGPTConfig, rng: np.random.Generator, batch: int, text_tokens: int = 96,
                 pad_to: int = 320, tokens_per_image: int = NUM_TOKENS_PER_IMAGE):
    """bench_demo.py's token rows: bos + 8 text ids + the image + 2 x
    (<mask>, <depth>) + ``text_tokens`` ids, padded to ``pad_to``."""
    hi = min(1000, cfg.mask_token_id - 1)
    rows = [
        np.asarray([1] + list(rng.integers(10, hi, 8)) + [IMAGE_TOKEN_INDEX]
                   + [cfg.mask_token_id, cfg.depth_token_id] * N_REGIONS + list(rng.integers(10, hi, text_tokens)),
                   np.int64)
        for _ in range(batch)
    ]
    return expand_rows(rows, None, max_len=cfg.model_max_length, tokens_per_image=tokens_per_image,
                       mask_token_id=cfg.mask_token_id, depth_token_id=cfg.depth_token_id,
                       regions_per_image=N_REGIONS, pad_to=pad_to)


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


def stage_depth(predictor: DepthPredictor, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, H, W, 3) uint8 colorized depth."""
    return predictor.colorized(images)


def stage_sam(model: sam_lib.SamHQModel, cfg: sam_lib.SamConfig, images: torch.Tensor, boxes: torch.Tensor,
              chunk: int = SAM_CHUNK, attn_impl: str = "onepass") -> torch.Tensor:
    """(B, H, W, 3) uint8 images and (B, N, 4) f32 xyxy boxes in image pixels
    -> (B * N, 4g, 4g) f32 mask logits.  Each image is resized to the SAM
    square (Pillow's bicubic, aspect not kept, as bench_demo.py) and
    ImageNet-normalized; the boxes are scaled alike."""
    size = cfg.vision.image_size
    h, w = images.shape[1:3]
    dtype = model.vision_encoder.pos_embed.dtype
    px = device_resize_uint8(images, size, size).float() / 255.0
    px = ((px - px.new_tensor(_SAM_MEAN)) / px.new_tensor(_SAM_STD)).to(dtype)
    bx = boxes.float() * boxes.new_tensor([size / w, size / h] * 2, dtype=torch.float32)
    outs = [
        sam_lib.predict_boxes_hq(model, cfg, px[i : i + chunk], bx[i : i + chunk], attn_impl=attn_impl)[0]
        for i in range(0, images.shape[0], chunk)
    ]
    return torch.cat(outs)


def preprocess_for_vlm(cfg: SpatialRGPTConfig, images: torch.Tensor, colorized: torch.Tensor,
                       mask_logits: torch.Tensor):
    """The VLM's inputs at the SigLIP size, as bench_demo.py's host
    ``process_image`` / ``process_depth`` / ``process_masks`` +
    ``pad_masks_to_slots`` make them: (pixels, depths, masks (B, R, S, S),
    mask_valid (B, R))."""
    size = cfg.vision.image_size
    B = images.shape[0]
    px = device_preprocess_uint8(images, size)
    dx = device_preprocess_uint8(colorized, size)
    binary = (mask_logits > 0).to(torch.uint8).reshape(B, N_REGIONS, *mask_logits.shape[-2:])
    mx = device_mask_resize_nearest(binary, size)
    return px, dx, mx, torch.ones((B, N_REGIONS), dtype=torch.bool, device=images.device)


def stage_vlm(model: SpatialRGPT, cfg: SpatialRGPTConfig, spliced, px, dx, mx, mv, max_new_tokens: int,
              attn_impl: str = "onepass") -> GenerateResult:
    """Greedy region QA over the spliced rows and the preprocessed images."""
    dtype = model.llm.model.embed_tokens.weight.dtype
    inputs = VLMInputs.from_spliced(spliced, None, None, None, None, device=px.device)._replace(
        images=px.to(dtype), depths=dx.to(dtype), masks=mx.to(dtype), mask_valid=mv
    )
    plens = torch.as_tensor(spliced.segment_ids.sum(axis=1), device=px.device)
    return generate(model, cfg, inputs, plens, max_new_tokens=max_new_tokens, temperature=0.0, eos_token_id=-1,
                    attn_impl=attn_impl, kv_quant=True)  # bench_demo.py:326


@dataclass
class DemoModels:
    depth: DepthPredictor
    sam: sam_lib.SamHQModel
    sam_cfg: sam_lib.SamConfig
    vlm: SpatialRGPT
    vlm_cfg: SpatialRGPTConfig


class DemoOutputs(NamedTuple):
    colorized: torch.Tensor  # (B, H, W, 3) uint8
    mask_logits: torch.Tensor  # (B * N, 4g, 4g) f32
    vlm_inputs: tuple  # (pixels, depths, masks, mask_valid)
    result: GenerateResult
    seconds: Dict[str, float]  # per stage


def run_pipeline(models: DemoModels, images: torch.Tensor, boxes: torch.Tensor, spliced, max_new_tokens: int,
                 attn_impl: str = "onepass", chunk: int = SAM_CHUNK,
                 sync: Callable[[], None] = lambda: None) -> DemoOutputs:
    """The four stages in order; ``sync`` (e.g. ``torch.cuda.synchronize``)
    runs before each stage's clock is read.  Each stage is a
    ``torch.profiler`` range of its name."""
    seconds: Dict[str, float] = {}

    def timed(name, fn, *args, **kw):
        sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            out = fn(*args, **kw)
            sync()
        seconds[name] = time.perf_counter() - t0
        return out

    colorized = timed("depth_s", stage_depth, models.depth, images)
    logits = timed("sam_s", stage_sam, models.sam, models.sam_cfg, images, boxes, chunk=chunk, attn_impl=attn_impl)
    pre = timed("preprocess_s", preprocess_for_vlm, models.vlm_cfg, images, colorized, logits)
    result = timed("vlm_s", stage_vlm, models.vlm, models.vlm_cfg, spliced, *pre, max_new_tokens, attn_impl=attn_impl)
    return DemoOutputs(colorized, logits, pre, result, seconds)


# ---------------------------------------------------------------------------
# adapters for demo/engine.py::DemoEngine
# ---------------------------------------------------------------------------


def segment_boxes_fn(model: sam_lib.SamHQModel, cfg: sam_lib.SamConfig, attn_impl: str = "onepass") -> Callable:
    """``segment_boxes(image (H, W, 3) uint8, boxes [[x1, y1, x2, y2], ...])``
    -> one (H, W) uint8 mask per box: SAM-HQ's logits bilinearly resized to
    the image and thresholded at 0."""
    dev = model.vision_encoder.pos_embed.device

    def segment_boxes(image: np.ndarray, boxes) -> List[np.ndarray]:
        img = torch.as_tensor(np.asarray(image, np.uint8)[None], device=dev)
        bx = torch.as_tensor(np.asarray(boxes, np.float32)[None], device=dev)
        logits = stage_sam(model, cfg, img, bx, attn_impl=attn_impl)
        up = F.interpolate(logits[:, None], size=tuple(image.shape[:2]), mode="bilinear", align_corners=False)
        return list((up[:, 0] > 0).to(torch.uint8).cpu().numpy())

    return segment_boxes


def estimate_depth_fn(predictor: DepthPredictor) -> Callable:
    """``estimate_depth(image (H, W, 3) uint8)`` -> (H, W) float32 depth."""
    dev = next(predictor.model.parameters()).device

    def estimate_depth(image: np.ndarray) -> np.ndarray:
        d = predictor.depth(torch.as_tensor(np.asarray(image, np.uint8)[None], device=dev))
        return d[0].float().cpu().numpy()

    return estimate_depth
