"""The synth pipeline's stage models on the port, port of
``spatialrgpt_tpu/synth/models.py``: each stage is a plain callable built
from a model of the port, run on the card unless the caller passes another
device.

  tagger    = RAM-style open-set tagger        (models/ram.py)
  detector  = OWL-ViT open-vocab grounding      (models/owl_vit.py)
  segmenter = SAM box-prompted masks            (models/sam.py: K5 on the card)
  depth     = Depth-Anything metric/relative    (models/depth_anything.py)
  gravity / intrinsics = CameraNet              (synth/calibration.py)

``build_stage_models`` assembles the keyword arguments of
``synth.pipeline.SynthPipeline``.  The host-side PIL resizes and the metric
depth's de-canonicalisation are the reference's, line for line;
``_to_uint8`` and ``_resize`` are copies of its helpers.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spatialrgpt_tpu_torch.models import depth_anything as da
from spatialrgpt_tpu_torch.models import owl_vit, ram, sam
from spatialrgpt_tpu_torch.utils.device import card_device

# SAM input normalization (HF SamProcessor pixel mean/std on 0-255 input)
SAM_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_STD = np.array([58.395, 57.12, 57.375], np.float32)


def _to_uint8(image: np.ndarray) -> np.ndarray:
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img * (255.0 if img.max() <= 1.5 else 1.0), 0, 255).astype(np.uint8)
    return img


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize((size, size), Image.BILINEAR), np.float32)


def sam_inputs(image: np.ndarray, boxes: Sequence[np.ndarray], cfg: sam.SamConfig) -> Tuple[np.ndarray, np.ndarray]:
    """An image and its xyxy pixel boxes -> SAM's (1, S, S, 3) normalized
    pixels and (1, N, 4) boxes at the model's square input, as the
    segmenter feeds them to ``predict_boxes``."""
    img = _to_uint8(image)
    H, W = img.shape[:2]
    S = cfg.vision.image_size
    x = (_resize(img, S) - SAM_MEAN) / SAM_STD
    scale = np.array([S / W, S / H, S / W, S / H], np.float32)
    return x[None], np.asarray(boxes, np.float32).reshape(1, len(boxes), 4) * scale


def make_sam_segmenter(model: sam.SamHQModel, cfg: sam.SamConfig, attn_impl: str = "onepass", device=None) -> Callable:
    """(image, [xyxy pixel boxes]) -> [(H, W) bool masks]: the
    get_sam_segmentation_from_xyxy contract (segment.py:99-101).  One
    ``predict_boxes`` call per image: on the card its global layers take K5
    (``attn_impl="xla"``: K5's plain version, the comparison route)."""
    dev = card_device(device, "make_sam_segmenter")
    model.to(dev)

    def segmenter(image: np.ndarray, boxes: Sequence[np.ndarray]) -> List[np.ndarray]:
        if len(boxes) == 0:
            return []
        H, W = np.asarray(image).shape[:2]
        x, b = sam_inputs(image, boxes, cfg)
        masks, _ = sam.predict_boxes(model, cfg, torch.as_tensor(x, device=dev), torch.as_tensor(b, device=dev),
                                     attn_impl=attn_impl)
        masks = masks.float().cpu().numpy()  # (N, 4g, 4g) logits
        from PIL import Image

        out = []
        for m in masks:
            mm = np.asarray(
                Image.fromarray(m.astype(np.float32)).resize((W, H), Image.BILINEAR)
            )
            out.append(mm > 0.0)
        return out

    return segmenter


def make_depth_model(model: da.DepthAnythingModel, cfg: da.DepthAnythingConfig, device=None) -> Callable:
    """image -> (H, W) float32 depth (relative; the demo-side slot)."""
    dev = card_device(device, "make_depth_model")
    model.to(dev)

    def depth_model(image: np.ndarray) -> np.ndarray:
        img = _to_uint8(image)
        H, W = img.shape[:2]
        S = cfg.image_size
        x = (_resize(img, S) / 255.0 - ram.IMAGENET_MEAN) / ram.IMAGENET_STD
        with torch.no_grad():
            d = da.forward_depth(model, torch.as_tensor(x, device=dev)[None], cfg)[0].float().cpu().numpy()
        from PIL import Image

        return np.asarray(Image.fromarray(d.astype(np.float32)).resize((W, H), Image.BILINEAR))

    return depth_model


def make_metric_depth_model(
    model: da.DepthAnythingModel,
    cfg: da.DepthAnythingConfig,
    canonical_focal: float = 1000.0,
    max_depth_m: float = 300.0,
    normalize: Callable = None,
    device=None,
) -> Callable:
    """(image, intrinsics) -> (H, W) metric depth in meters.

    The Metric3Dv2 contract (reference wrappers/metric3d_v2.py:15-68): the
    network predicts depth in a *canonical* camera of focal length
    ``canonical_focal``; metric depth is recovered by scaling with the
    image's true (resized) focal:

        depth = canonical_depth * (fx * scale) / canonical_focal

    where ``scale`` is the keep-ratio resize factor to the model's input
    size.  The network slot is the Depth-Anything port with a metric head
    (``cfg.metric=True``)."""
    dev = card_device(device, "make_metric_depth_model")
    model.to(dev)
    norm = normalize or (
        lambda x: (x / 255.0 - ram.IMAGENET_MEAN) / ram.IMAGENET_STD
    )

    def depth_model(image: np.ndarray, intrinsics: np.ndarray = None) -> np.ndarray:
        from PIL import Image

        img = _to_uint8(image)
        H, W = img.shape[:2]
        S = cfg.image_size
        # keep-ratio resize + pad to the square model input (the reference
        # pads to (616, 1064); our ViT input is square)
        scale = S / max(H, W)
        nh, nw = max(int(round(H * scale)), 1), max(int(round(W * scale)), 1)
        resized = np.asarray(
            Image.fromarray(img).resize((nw, nh), Image.BILINEAR), np.float32
        )
        pad_t, pad_l = (S - nh) // 2, (S - nw) // 2
        canvas = np.zeros((S, S, 3), np.float32)
        canvas[pad_t : pad_t + nh, pad_l : pad_l + nw] = resized
        x = norm(canvas)
        with torch.no_grad():
            d = da.forward_depth(model, torch.as_tensor(x, device=dev)[None], cfg)[0].float().cpu().numpy()
        d = d[pad_t : pad_t + nh, pad_l : pad_l + nw]
        d = np.asarray(Image.fromarray(d.astype(np.float32)).resize((W, H), Image.BILINEAR))
        if intrinsics is None:
            fx = float(canonical_focal)  # no de-canonicalization possible
        else:
            fx = float(intrinsics[0, 0])
        d = d * (fx * scale / canonical_focal)
        return np.clip(d, 0.0, max_depth_m)

    return depth_model


def build_stage_models(
    *,
    ram_params: Optional[ram.RamModel] = None,
    ram_cfg: Optional[ram.RamConfig] = None,
    ram_tags: Optional[Sequence[str]] = None,
    owl_params: Optional[owl_vit.OwlViTModel] = None,
    owl_cfg: Optional[owl_vit.OwlViTConfig] = None,
    owl_tokenize: Optional[Callable] = None,
    sam_params: Optional[sam.SamHQModel] = None,
    sam_cfg: Optional[sam.SamConfig] = None,
    depth_params: Optional[da.DepthAnythingModel] = None,
    depth_cfg: Optional[da.DepthAnythingConfig] = None,
    calib_params=None,  # synth.calibration.CameraNet
    calib_cfg=None,  # synth.calibration.CameraNetConfig
    box_threshold: float = 0.25,
    device=None,
    **tagger_kwargs,
) -> Dict[str, Callable]:
    """``SynthPipeline``'s stage models from whichever of the port's models
    are given (the ``*_params`` arguments keep the reference's names and
    take the port's modules).  Every model runs on ``device``: by default
    the card, and without one the call raises.

    A metric depth config (``depth_cfg.metric=True``) installs the
    Metric3Dv2-contract wrapper (canonical-camera de-canonicalization);
    ``calib_params`` installs the CameraNet gravity + intrinsics slots
    (PerspectiveFields / WildCamera equivalents, synth/calibration.py)."""
    dev = card_device(device, "build_stage_models")
    models: Dict[str, Callable] = {}
    if ram_params is not None:
        models["tagger"] = ram.make_tagger(ram_params, ram_cfg, ram_tags, device=dev, **tagger_kwargs)
    if owl_params is not None:
        models["detector"] = owl_vit.make_detector(
            owl_params, owl_cfg, owl_tokenize, box_threshold=box_threshold, device=dev
        )
    if sam_params is not None:
        models["segmenter"] = make_sam_segmenter(sam_params, sam_cfg, device=dev)
    if depth_params is not None:
        if depth_cfg is not None and depth_cfg.metric:
            models["depth_model"] = make_metric_depth_model(depth_params, depth_cfg, device=dev)
        else:
            models["depth_model"] = make_depth_model(depth_params, depth_cfg, device=dev)
    if calib_params is not None:
        from spatialrgpt_tpu_torch.synth import calibration

        models["gravity_model"] = calibration.make_gravity_model(calib_params, calib_cfg, device=dev)
        models["intrinsics_model"] = calibration.make_intrinsics_model(calib_params, calib_cfg, device=dev)
    return models
