"""Interactive demo engine (UI-agnostic).

Rebuild of the reference's Gradio server logic
(demo/gradio_web_server_multi.py): box prompts -> SAM mask proposals ->
Depth-Anything depth map -> ``<regionX>`` prompt rewriting -> VLM
generate -> region-index remap of the response.  The engine is pure
library code.  The port's own copy of ``spatialrgpt_tpu/demo/engine.py``;
``demo/pipeline.py`` runs it on the port's models.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from spatialrgpt_tpu_torch.constants import DEFAULT_DEPTH_TOKEN, DEFAULT_IMAGE_TOKEN, DEFAULT_MASK_TOKEN
from spatialrgpt_tpu_torch.conversation import conv_templates

_REGION_RE = re.compile(r"<region(\d+)>")


def rewrite_region_prompt(text: str, enable_depth: bool = True) -> Tuple[str, List[int]]:
    """Replace each ``<regionK>`` with ``<mask> <depth>`` (or ``<mask>``)
    and return the region indices in occurrence order
    (gradio_web_server_multi.py:139-180 semantics)."""
    indices = [int(m.group(1)) for m in _REGION_RE.finditer(text)]
    token = (
        f"{DEFAULT_MASK_TOKEN} {DEFAULT_DEPTH_TOKEN}" if enable_depth else DEFAULT_MASK_TOKEN
    )
    return _REGION_RE.sub(token, text), indices


def remap_region_indices(response: str, used_indices: List[int]) -> str:
    """Model-side region references ``[K]`` index the per-prompt mask
    order; remap back to the user's region numbering
    (gradio_web_server_multi.py:205-238)."""

    def sub(m):
        k = int(m.group(1))
        if 0 <= k < len(used_indices):
            return f"[{used_indices[k]}]"
        return m.group(0)

    return re.sub(r"\[(\d+)\]", sub, response)


def draw_som_overlay(image: np.ndarray, masks: List[np.ndarray], alpha: float = 0.4) -> np.ndarray:
    """Set-of-marks visualization: tint each region and tag its index
    (demo/utils/som.py:37-76 behavior, numpy-only)."""
    colors = np.array(
        [
            [255, 99, 71],
            [65, 105, 225],
            [60, 179, 113],
            [255, 215, 0],
            [186, 85, 211],
            [255, 140, 0],
            [72, 209, 204],
            [199, 21, 133],
        ],
        np.float32,
    )
    out = image.astype(np.float32).copy()
    for i, m in enumerate(masks):
        color = colors[i % len(colors)]
        mm = m.astype(bool)
        out[mm] = out[mm] * (1 - alpha) + color * alpha
        ys, xs = np.nonzero(mm)
        if len(ys):
            cy, cx = int(ys.mean()), int(xs.mean())
            out[max(cy - 2, 0) : cy + 3, max(cx - 2, 0) : cx + 3] = color
    return out.astype(np.uint8)


@dataclass
class DemoState:
    """Per-session state: image, proposed regions, conversation."""

    image: Optional[np.ndarray] = None  # (H, W, 3) uint8
    depth_colorized: Optional[np.ndarray] = None  # (H, W, 3) uint8
    region_masks: List[np.ndarray] = field(default_factory=list)
    conv_mode: str = "llama_3"
    history: List[Tuple[str, str]] = field(default_factory=list)

    def reset(self):
        self.image = None
        self.depth_colorized = None
        self.region_masks = []
        self.history = []


class DemoEngine:
    """Wires SAM + Depth-Anything + the VLM behind a simple API.

    The three model callables are injected so the engine works with the
    JAX ports, remote endpoints, or fakes in tests:
      segment_boxes(image, boxes xyxy) -> [region masks]
      estimate_depth(image) -> (H, W) float depth
      generate(prompt_text, image, depth, masks) -> str
    """

    def __init__(
        self,
        segment_boxes: Callable,
        estimate_depth: Callable,
        generate: Callable,
        conv_mode: str = "llama_3",
        enable_depth: bool = True,
    ):
        self.segment_boxes = segment_boxes
        self.estimate_depth = estimate_depth
        self.generate = generate
        self.conv_mode = conv_mode
        self.enable_depth = enable_depth

    def set_image(self, state: DemoState, image: np.ndarray) -> DemoState:
        state.reset()
        state.image = image
        if self.enable_depth:
            depth = np.asarray(self.estimate_depth(image), np.float32)
            lo, hi = depth.min(), depth.max()
            u8 = ((depth - lo) / max(hi - lo, 1e-8) * 255).astype(np.uint8)
            state.depth_colorized = np.stack([u8] * 3, axis=-1)
        return state

    def add_regions(self, state: DemoState, boxes: List[List[float]]) -> np.ndarray:
        """Run SAM on user boxes; returns the set-of-marks overlay."""
        masks = self.segment_boxes(state.image, boxes)
        state.region_masks.extend(np.asarray(m).astype(np.uint8) for m in masks)
        return draw_som_overlay(state.image, state.region_masks)

    def chat(self, state: DemoState, user_text: str) -> str:
        text, indices = rewrite_region_prompt(user_text, self.enable_depth)
        if DEFAULT_IMAGE_TOKEN not in text and not state.history:
            text = DEFAULT_IMAGE_TOKEN + "\n" + text

        conv = conv_templates[self.conv_mode].copy()
        for u, a in state.history:
            conv.append_message(conv.roles[0], u)
            conv.append_message(conv.roles[1], a)
        conv.append_message(conv.roles[0], text)
        conv.append_message(conv.roles[1], None)
        prompt = conv.get_prompt()

        masks = [state.region_masks[i] for i in indices if i < len(state.region_masks)]
        response = self.generate(prompt, state.image, state.depth_colorized, masks)
        response = remap_region_indices(response, indices)
        state.history.append((text, response))
        return response
