"""2D -> 3D dataset-synthesis pipeline.

Rebuild of dataset_pipeline/run_template_qa.py + osdsynth/processor/*:
    segment  (tag -> detect -> mask -> filter)          [segment.py:22-141]
    lift     (depth + intrinsics + gravity -> clouds)   [pointcloud.py:20-168]
    caption  (per-object captions)                      [captions.py]
    generate (template QA over object pairs)            [prompt.py]

Model wrappers are pluggable callables so the pipeline runs with any
tagger/detector/segmenter/depth stack (the reference hardwires
RAM + GroundingDINO + SAM + Metric3Dv2 + PerspectiveFields/WildCamera);
deterministic fallbacks (provided boxes/masks, provided depth) keep the
pipeline testable offline.

The port's own copy of ``spatialrgpt_tpu/synth/pipeline.py``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from spatialrgpt_tpu_torch.synth.geometry import (
    PointCloud,
    dbscan_filter,
    intrinsics_from_fov,
    statistical_outlier_filter,
    rotation_from_roll_pitch,
    unproject_depth,
)
from spatialrgpt_tpu_torch.synth.prompts import PromptGenerator


class SkipImageException(Exception):
    """Raised by stages to drop an image (osdsynth/utils/logger.py)."""


@dataclass
class Detection:
    label: str
    box: np.ndarray  # (4,) xyxy
    mask: np.ndarray  # (H, W) bool
    score: float = 1.0


@dataclass
class SynthConfig:
    min_detections: int = 2
    max_detections: int = 12
    mask_area_min: float = 0.0005
    mask_area_max: float = 0.8
    containment_iou: float = 0.9
    nms_iou: float = 0.8
    dbscan_eps: float = 0.2
    dbscan_min_points: int = 10
    fov_deg: float = 55.0
    n_pairs: int = 3
    n_conv: int = 3
    seed: int = 0


def _box_iou(a: np.ndarray, b: np.ndarray) -> float:
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    return inter / max(area_a + area_b - inter, 1e-9)


def _containment(inner: np.ndarray, outer: np.ndarray) -> float:
    x1, y1 = max(inner[0], outer[0]), max(inner[1], outer[1])
    x2, y2 = min(inner[2], outer[2]), min(inner[3], outer[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    return inter / max((inner[2] - inner[0]) * (inner[3] - inner[1]), 1e-9)


class SegmentStage:
    """Tag + detect + segment + filter (segment.py:22-141 semantics: NMS,
    containment suppression, area bounds)."""

    def __init__(
        self,
        cfg: SynthConfig,
        tagger: Optional[Callable] = None,  # image -> [class names]
        detector: Optional[Callable] = None,  # (image, classes) -> [(label, box, score)]
        segmenter: Optional[Callable] = None,  # (image, boxes) -> [(H, W) masks]
    ):
        self.cfg = cfg
        self.tagger = tagger
        self.detector = detector
        self.segmenter = segmenter

    def process(self, image: np.ndarray, detections: Optional[List[Detection]] = None) -> List[Detection]:
        if detections is None:
            if not (self.detector and self.segmenter):
                raise SkipImageException("no detector configured and no detections given")
            classes = self.tagger(image) if self.tagger else None
            raw = self.detector(image, classes)
            boxes = [b for _, b, _ in raw]
            masks = self.segmenter(image, boxes)
            detections = [
                Detection(label=l, box=np.asarray(b, np.float64), mask=m.astype(bool), score=s)
                for (l, b, s), m in zip(raw, masks)
            ]

        H, W = image.shape[:2]
        area = H * W
        kept: List[Detection] = []
        for det in sorted(detections, key=lambda d: -d.score):
            frac = det.mask.sum() / area
            if not (self.cfg.mask_area_min <= frac <= self.cfg.mask_area_max):
                continue
            drop = False
            for other in kept:
                if _box_iou(det.box, other.box) > self.cfg.nms_iou:
                    drop = True
                    break
                if _containment(det.box, other.box) > self.cfg.containment_iou:
                    drop = True
                    break
            if not drop:
                kept.append(det)
            if len(kept) >= self.cfg.max_detections:
                break
        if len(kept) < self.cfg.min_detections:
            raise SkipImageException(f"only {len(kept)} detections after filtering")
        return kept


class LiftStage:
    """Metric depth + intrinsics + gravity -> per-object point clouds
    (pointcloud.py:51-168)."""

    def __init__(
        self,
        cfg: SynthConfig,
        depth_model: Optional[Callable] = None,  # image -> (H, W) metric depth
        intrinsics_model: Optional[Callable] = None,  # image -> (3,3) K
        gravity_model: Optional[Callable] = None,  # image -> (roll_deg, pitch_deg)
    ):
        self.cfg = cfg
        self.depth_model = depth_model
        self.intrinsics_model = intrinsics_model
        self.gravity_model = gravity_model

    def process(
        self,
        image: np.ndarray,
        detections: List[Detection],
        depth: Optional[np.ndarray] = None,
        intrinsics: Optional[np.ndarray] = None,
    ) -> List[Dict]:
        H, W = image.shape[:2]
        # intrinsics first: the metric-depth model (Metric3Dv2 contract,
        # synth/models.py::make_metric_depth_model) de-canonicalizes its
        # canonical-camera prediction by the true focal length
        # (reference pointcloud.py:85-89: WildCamera K feeds
        # inference_depth)
        if intrinsics is None:
            intrinsics = (
                self.intrinsics_model(image)
                if self.intrinsics_model
                else intrinsics_from_fov(W, H, self.cfg.fov_deg)
            )
        if depth is None:
            if self.depth_model is None:
                raise SkipImageException("no depth available")
            try:
                depth = self.depth_model(image, intrinsics)
            except TypeError:  # relative-depth models take only the image
                depth = self.depth_model(image)
        rotation = None
        if self.gravity_model is not None:
            roll, pitch = self.gravity_model(image)
            rotation = rotation_from_roll_pitch(roll, pitch)

        # ground-plane translation (reference pointcloud.py:93-100): shift
        # the gravity-aligned cloud so the lowest point among the nearest
        # 50% sits at height 0 (robust against far-field depth noise)
        ground_shift = 0.0
        if rotation is not None:
            full = unproject_depth(depth, intrinsics, None, rotation, max_points=16384)
            pts = full.points[full.points[:, 2].argsort()]
            near = pts[: max(len(pts) // 2, 1)]
            # predicate frame has +y up: the ground is the minimum height
            ground_shift = float(near[:, 1].min())

        objects = []
        for det in detections:
            cloud = unproject_depth(depth, intrinsics, det.mask, rotation)
            if len(cloud.points) < self.cfg.dbscan_min_points:
                continue
            cloud.points[:, 1] -= ground_shift
            # SOR first, then DBSCAN (reference process_pcd order,
            # pointcloud.py:239-249): SOR strips the sparse depth-bleed
            # streak at mask edges that DBSCAN alone can keep connected
            cloud = statistical_outlier_filter(cloud)
            cloud = dbscan_filter(cloud, self.cfg.dbscan_eps, self.cfg.dbscan_min_points)
            objects.append({"caption": det.label, "pcd": cloud, "detection": det})
        if len(objects) < self.cfg.min_detections:
            raise SkipImageException("too few lifted objects")
        return objects


class SynthPipeline:
    """End-to-end per-image annotate() (run_template_qa.py:28-113)."""

    def __init__(self, cfg: SynthConfig = SynthConfig(), **stage_models):
        self.cfg = cfg
        self.segment = SegmentStage(
            cfg,
            tagger=stage_models.get("tagger"),
            detector=stage_models.get("detector"),
            segmenter=stage_models.get("segmenter"),
        )
        self.lift = LiftStage(
            cfg,
            depth_model=stage_models.get("depth_model"),
            intrinsics_model=stage_models.get("intrinsics_model"),
            gravity_model=stage_models.get("gravity_model"),
        )
        self.prompter = PromptGenerator(cfg.n_pairs, cfg.n_conv, seed=cfg.seed)

    def annotate(
        self,
        image: np.ndarray,
        detections: Optional[List[Detection]] = None,
        depth: Optional[np.ndarray] = None,
        intrinsics: Optional[np.ndarray] = None,
    ) -> Dict:
        dets = self.segment.process(image, detections)
        objects = self.lift.process(image, dets, depth, intrinsics)
        qa = self.prompter.evaluate_predicates_on_pairs(objects)
        return {
            "objects": [
                {
                    "caption": o["caption"],
                    "center": o["pcd"].get_center().tolist(),
                    "extent": o["pcd"].extent().tolist(),
                    "box": o["detection"].box.tolist(),
                }
                for o in objects
            ],
            "qa": [
                {"question": q, "answer": a, "type": name}
                for (q, a), _, _, name in qa
            ],
        }


def run_directory(
    pipeline: SynthPipeline,
    image_dir: str,
    out_path: str,
    loader: Optional[Callable] = None,
) -> Dict[str, int]:
    """Annotate every image in a directory; skip failures; write json and a
    progress record (run_template_qa.py:66-113)."""
    from PIL import Image

    loader = loader or (lambda p: np.asarray(Image.open(p).convert("RGB")))
    results = {}
    skipped = 0
    for name in sorted(os.listdir(image_dir)):
        if not name.lower().endswith((".jpg", ".jpeg", ".png")):
            continue
        try:
            results[name] = pipeline.annotate(loader(os.path.join(image_dir, name)))
        except SkipImageException:
            skipped += 1
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(results, f)
    return {"annotated": len(results), "skipped": skipped}
