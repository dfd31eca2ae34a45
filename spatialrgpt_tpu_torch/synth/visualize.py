"""3D scene export for synthesis debugging.

Stands in for the reference's Wis3D visualizer
(dataset_pipeline/osdsynth/visualizer/som.py, 1.4k LoC of Wis3D glue):
writes point clouds as PLY and scenes (objects + AABBs + QA) as a JSON
any viewer can load; plus the SoM overlay reuse from demo/engine.py.

The port's own copy of ``spatialrgpt_tpu/synth/visualize.py``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from spatialrgpt_tpu_torch.synth.geometry import PointCloud


def write_ply(path: str, cloud: PointCloud, color=(200, 200, 200)) -> None:
    """Ascii PLY point cloud."""
    pts = np.asarray(cloud.points, np.float32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        r, g, b = color
        for p in pts:
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} {r} {g} {b}\n")


def export_scene(out_dir: str, objects: List[Dict], qa: Optional[List[Dict]] = None) -> str:
    """objects: [{'caption', 'pcd': PointCloud, ...}] -> scene.json + PLYs.

    JSON serialization of boxes mirrors the reference's
    save_detection_list_to_json (osdsynth/utils/logger.py)."""
    os.makedirs(out_dir, exist_ok=True)
    palette = [(255, 99, 71), (65, 105, 225), (60, 179, 113), (255, 215, 0), (186, 85, 211)]
    scene = {"objects": [], "qa": qa or []}
    for i, obj in enumerate(objects):
        ply = os.path.join(out_dir, f"object_{i}.ply")
        write_ply(ply, obj["pcd"], palette[i % len(palette)])
        lo, hi = obj["pcd"].aabb()
        scene["objects"].append(
            {
                "caption": obj["caption"],
                "ply": os.path.basename(ply),
                "center": obj["pcd"].get_center().tolist(),
                "aabb_min": lo.tolist(),
                "aabb_max": hi.tolist(),
                "extent": (hi - lo).tolist(),
            }
        )
    path = os.path.join(out_dir, "scene.json")
    with open(path, "w") as f:
        json.dump(scene, f, indent=2)
    return path
