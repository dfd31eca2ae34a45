"""3D geometry for the dataset-synthesis pipeline.

Numpy rebuild of the Open3D-based helpers in
dataset_pipeline/osdsynth/processor/pointcloud.py: point-cloud container
with centers/AABBs, unprojection from metric depth, DBSCAN denoising, the
camera-frame convention (x right->left, y up, z forward after the
roll/pitch correction), plus the distance/clock-direction math the QA
templates consume (pointcloud.py:340-402, prompt_utils.py:13-31).

No Open3D dependency: AABBs and point distances are a few lines of numpy;
DBSCAN is a small grid-hash implementation.

The port's own copy of ``spatialrgpt_tpu/synth/geometry.py``.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np


@dataclass
class PointCloud:
    points: np.ndarray  # (N, 3) float

    def get_center(self) -> np.ndarray:
        return self.points.mean(axis=0)

    def min_bound(self) -> np.ndarray:
        return self.points.min(axis=0)

    def max_bound(self) -> np.ndarray:
        return self.points.max(axis=0)

    def extent(self) -> np.ndarray:
        return self.max_bound() - self.min_bound()

    def aabb(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.min_bound(), self.max_bound()

    def distance_to(self, other: "PointCloud") -> np.ndarray:
        """Per-point nearest-neighbor distance to ``other`` (the open3d
        compute_point_cloud_distance contract)."""
        # chunked brute force; synthesis clouds are downsampled (<= a few k)
        out = np.empty(len(self.points), np.float64)
        B = other.points
        for i in range(0, len(self.points), 1024):
            a = self.points[i : i + 1024]
            d2 = ((a[:, None, :] - B[None, :, :]) ** 2).sum(-1)
            out[i : i + 1024] = np.sqrt(d2.min(axis=1))
        return out


def average_cloud_distance(a: PointCloud, b: PointCloud) -> float:
    """Symmetric mean nearest-point distance (pointcloud.py:396-402)."""
    d = np.concatenate([a.distance_to(b), b.distance_to(a)])
    return float(d.mean())


def human_like_distance(distance_meters: float, rng: Optional[random.Random] = None) -> str:
    """Render a metric distance in a randomly chosen human unit with the
    reference's unit ranges and probabilities (pointcloud.py:340-394)."""
    rng = rng or random
    if distance_meters < 1:
        choices = [
            (round(distance_meters * 100, 2), "centimeters", 0.2),
            (round(distance_meters * 39.3701, 2), "inches", 0.8),
        ]
    elif distance_meters < 3:
        choices = [
            (round(distance_meters, 2), "meters", 0.5),
            (round(distance_meters * 3.28084, 2), "feet", 0.5),
        ]
    else:
        choices = [
            (round(distance_meters, 2), "meters", 0.7),
            (round(distance_meters * 3.28084, 2), "feet", 0.3),
        ]
    total = sum(p for _, _, p in choices)
    r = rng.random()
    acc = 0.0
    for value, unit, p in choices:
        acc += p / total
        if r < acc:
            return f"{value} {unit}"
    value, unit, _ = choices[-1]
    return f"{value} {unit}"


def calculate_angle_clockwise(A_pos, B_pos, x_right: bool = False) -> int:
    """Clock direction (1-12) of B as seen from A on the ground plane
    (prompt_utils.py:13-31)."""
    if x_right:
        v = (A_pos[0] - B_pos[0], B_pos[1] - A_pos[1])
    else:
        v = (B_pos[0] - A_pos[0], B_pos[1] - A_pos[1])
    angle_deg = (math.degrees(math.atan2(v[0], v[1])) + 360) % 360
    clock = 12 - angle_deg // 30
    clock = clock if clock > 0 else 12 + clock
    return int(clock)


# ---------------------------------------------------------------------------
# Unprojection & cleanup
# ---------------------------------------------------------------------------


def unproject_depth(
    depth: np.ndarray,  # (H, W) metric depth
    intrinsics: np.ndarray,  # (3, 3) K
    mask: Optional[np.ndarray] = None,  # (H, W) bool
    rotation: Optional[np.ndarray] = None,  # (3, 3) world correction
    max_points: int = 4096,
    rng: Optional[np.random.Generator] = None,
) -> PointCloud:
    """Depth map (+ object mask) -> world-frame point cloud.

    Camera frame: +x right, +y down, +z forward; the returned cloud is in
    the corrected frame (x left, y up, z forward) matching the pipeline's
    predicate conventions after the roll/pitch rotation (pointcloud.py's
    perspective-field correction)."""
    H, W = depth.shape
    fx, fy, cx, cy = intrinsics[0, 0], intrinsics[1, 1], intrinsics[0, 2], intrinsics[1, 2]
    ys, xs = np.nonzero(mask if mask is not None else np.ones_like(depth, bool))
    z = depth[ys, xs]
    keep = z > 0
    ys, xs, z = ys[keep], xs[keep], z[keep]
    x = (xs - cx) / fx * z
    y = (ys - cy) / fy * z
    pts = np.stack([x, y, z], axis=1)
    if rotation is not None:
        pts = pts @ rotation.T
    # flip into predicate frame: x -> left positive, y -> up positive
    pts = pts * np.array([-1.0, -1.0, 1.0])
    if len(pts) > max_points:
        rng = rng or np.random.default_rng(0)
        pts = pts[rng.choice(len(pts), max_points, replace=False)]
    return PointCloud(points=pts)


def statistical_outlier_filter(
    cloud: PointCloud, nb_neighbors: int = 10, std_ratio: float = 1.2
) -> PointCloud:
    """Drop points whose mean k-NN distance exceeds mean + std_ratio*std
    over the cloud (Open3D remove_statistical_outlier semantics; the
    reference runs this before DBSCAN, pointcloud.py:241).  This is the
    pass that strips depth-bleed points at mask boundaries — pixels whose
    predicted depth interpolates between object and background unproject
    to a sparse streak between the two surfaces."""
    pts = cloud.points
    n = len(pts)
    if n <= nb_neighbors:
        return cloud
    # brute-force kNN: clouds are capped at ~4096 points by unproject
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    k = min(nb_neighbors, n - 1)
    knn = np.sqrt(np.partition(d2, k - 1, axis=1)[:, :k])
    mean_d = knn.mean(axis=1)
    thresh = mean_d.mean() + std_ratio * mean_d.std()
    keep = mean_d <= thresh
    if not keep.any():
        return cloud
    return PointCloud(points=pts[keep])


def dbscan_filter(cloud: PointCloud, eps: float = 0.2, min_points: int = 10) -> PointCloud:
    """Keep the largest DBSCAN cluster (outlier removal, the pipeline's
    pcd denoise step).  Grid-hash implementation, O(N * 27)."""
    pts = cloud.points
    if len(pts) == 0:
        return cloud
    cell = eps
    keys = np.floor(pts / cell).astype(np.int64)
    grid: Dict[tuple, list] = {}
    for i, k in enumerate(map(tuple, keys)):
        grid.setdefault(k, []).append(i)

    def neighbors(i):
        k = keys[i]
        out = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    cellpts = grid.get((k[0] + dx, k[1] + dy, k[2] + dz))
                    if cellpts:
                        out.extend(cellpts)
        out = np.asarray(out)
        d2 = ((pts[out] - pts[i]) ** 2).sum(-1)
        return out[d2 <= eps * eps]

    labels = np.full(len(pts), -1, np.int64)
    cluster = 0
    for i in range(len(pts)):
        if labels[i] != -1:
            continue
        n = neighbors(i)
        if len(n) < min_points:
            continue
        labels[i] = cluster
        stack = list(n)
        while stack:
            j = stack.pop()
            if labels[j] == -1:
                labels[j] = cluster
                nj = neighbors(j)
                if len(nj) >= min_points:
                    stack.extend(nj[labels[nj] == -1])
        cluster += 1
    if cluster == 0:
        return cloud
    largest = np.argmax(np.bincount(labels[labels >= 0]))
    return PointCloud(points=pts[labels == largest])


def rotation_from_roll_pitch(roll_deg: float, pitch_deg: float) -> np.ndarray:
    """Camera-to-gravity-aligned rotation from PerspectiveFields-style
    roll/pitch estimates."""
    r, p = math.radians(roll_deg), math.radians(pitch_deg)
    Rz = np.array([[math.cos(r), -math.sin(r), 0], [math.sin(r), math.cos(r), 0], [0, 0, 1]])
    Rx = np.array([[1, 0, 0], [0, math.cos(p), -math.sin(p)], [0, math.sin(p), math.cos(p)]])
    return Rx @ Rz


def intrinsics_from_fov(width: int, height: int, fov_deg: float = 55.0) -> np.ndarray:
    """Pinhole K from a field-of-view guess (WildCamera fallback)."""
    f = 0.5 * width / math.tan(math.radians(fov_deg) / 2)
    return np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]])
