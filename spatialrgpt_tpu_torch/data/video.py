"""Video frame extraction.

Rebuild of the reference's video path (llava/mm_utils.py:34-242
opencv_extract_frames + the black-frame fallback for corrupt files,
dataset.py:816-826): sample N frames uniformly from a video file/stream,
returning PIL-compatible arrays; failures yield synthetic black frames so
training never crashes on bad data.

The port's own copy of ``spatialrgpt_tpu/data/video.py``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def extract_frames(
    video_path: str,
    num_frames: int = 8,
    size: Tuple[int, int] = (384, 384),
) -> Tuple[List[np.ndarray], int]:
    """-> (frames [num_frames x (H, W, 3) uint8], actual_frame_count).

    Uniform temporal sampling; black frames on any failure."""
    try:
        import cv2

        cap = cv2.VideoCapture(video_path)
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if total <= 0:
            raise ValueError("empty video")
        idxs = np.linspace(0, total - 1, num_frames).astype(int)
        frames = []
        for idx in idxs:
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(idx))
            ok, frame = cap.read()
            if not ok:
                raise ValueError(f"read failed at {idx}")
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            frames.append(frame)
        cap.release()
        return frames, total
    except Exception:
        black = np.zeros((size[0], size[1], 3), np.uint8)
        return [black.copy() for _ in range(num_frames)], 0
