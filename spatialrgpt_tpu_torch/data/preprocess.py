"""Host-side image / depth / mask preprocessing.

Behavior-compatible rebuild of the reference preprocessing
(llava/mm_utils.py:249-532) without torch/transformers/pycocotools at
runtime:

- ``SiglipProcessor``: resize (bicubic) -> rescale(1/255) -> normalize
  (mean=std=0.5), the defaults of SiglipImageProcessor for
  google/siglip-so400m-patch14-384.  Output is NHWC float32 (TPU layout;
  the reference emits CHW).
- ``process_image`` / ``process_depth``: 'resize' squashes to the crop
  size; 'pad' letterboxes to square with the mean color first
  (mm_utils.py:421-474, 378-418).  The 16-bit depth PNG is assumed
  pre-normalized, per the reference (mm_utils.py:389).
- ``process_masks``: COCO RLE (own decoder) / polygon (cv2) / bbox ->
  binary mask -> nearest-resize or pad-to-square -> through the processor
  with normalization off and rescale 1.0 (mm_utils.py:279-375).

The port's own copy of ``spatialrgpt_tpu/data/preprocess.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
from PIL import Image

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


# ---------------------------------------------------------------------------
# COCO RLE
# ---------------------------------------------------------------------------


def rle_decode(rle: Dict) -> np.ndarray:
    """Decode a COCO RLE dict {'size': [h, w], 'counts': str|bytes|list}
    into an (h, w) uint8 mask.  Implements the compressed-counts string
    format natively (column-major runs, LEB128-ish signed varints)."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (list, tuple)):
        runs = list(counts)
    else:
        if isinstance(counts, str):
            counts = counts.encode("ascii")
        runs = []
        i = 0
        while i < len(counts):
            x = 0
            k = 0
            more = True
            while more:
                c = counts[i] - 48
                x |= (c & 0x1F) << (5 * k)
                more = bool(c & 0x20)
                i += 1
                k += 1
                if not more and (c & 0x10):
                    x |= -1 << (5 * k)
            if len(runs) > 2:
                x += runs[-2]
            runs.append(x)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for run in runs:
        flat[pos : pos + run] = val
        pos += run
        val = 1 - val
    return flat.reshape(w, h).T  # column-major


def rle_encode(mask: np.ndarray) -> Dict:
    """Encode an (h, w) binary mask as uncompressed COCO RLE (counts list)."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).T.reshape(-1)
    change = np.flatnonzero(np.diff(flat)) + 1
    idx = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(idx).tolist()
    if flat[0] == 1:
        runs = [0] + runs
    return {"size": [h, w], "counts": runs}


def polygons_to_mask(polygons: Sequence[Sequence[float]], h: int, w: int) -> np.ndarray:
    """Rasterize COCO polygon segmentation(s) into an (h, w) uint8 mask."""
    mask = np.zeros((h, w), np.uint8)
    if cv2 is None:
        raise RuntimeError("cv2 required for polygon masks")
    for poly in polygons:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
    return mask


# ---------------------------------------------------------------------------
# PIL-exact bicubic resampling (numpy)
# ---------------------------------------------------------------------------
#
# The reference preprocessing is PIL bicubic end to end (Image.resize default
# resample, llava/mm_utils.py:441; HF image processors round-trip numpy
# arrays through PIL).  PIL Resample.c uses the Keys kernel with a=-0.5, a
# support window scaled by the downscale factor, per-window weight
# normalization, and — for 8-bit images — fixed-point int32 coefficients at
# PRECISION_BITS with an intermediate uint8 image between the horizontal and
# vertical passes.  cv2.INTER_CUBIC (a=-0.75, no support scaling) diverges by
# up to ~1.0 in normalized units; this implementation matches PIL's uint8
# output bit for bit (gated by tests/test_preprocess.py) and extends the
# same math to float32/multichannel arrays PIL cannot represent.

_PIL_PRECISION_BITS = 32 - 8 - 2  # Pillow src/libImaging/Resample.c


def _bicubic_kernel(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    head = ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0
    tail = (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a
    return np.where(ax < 1.0, head, np.where(ax < 2.0, tail, 0.0))


def _resample_matrix(in_size: int, out_size: int, support: float = 2.0):
    """Dense (out_size, in_size) float64 weight matrix of PIL's bicubic
    coefficients (normalized per clipped window), plus the fixed-point
    int64 variant used for 8-bit images."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    supp = support * filterscale
    inv = 1.0 / filterscale
    m = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - supp + 0.5), 0)
        xmax = min(int(center + supp + 0.5), in_size)
        k = _bicubic_kernel((np.arange(xmin, xmax) - center + 0.5) * inv)
        m[xx, xmin:xmax] = k / k.sum()
    # PIL rounds coefficients half-away-from-zero into fixed point
    v = m * (1 << _PIL_PRECISION_BITS)
    mi = np.where(v < 0, np.ceil(v - 0.5), np.floor(v + 0.5)).astype(np.int64)
    return m, mi


def _clip8(s: np.ndarray) -> np.ndarray:
    out = s >> _PIL_PRECISION_BITS
    out = np.where(s <= 0, 0, out)
    out = np.where(s >= (256 << _PIL_PRECISION_BITS), 255, out)
    return out.astype(np.uint8)


def pil_bicubic_resize(arr: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Resize (H, W) or (H, W, C) numpy array with PIL-identical bicubic.

    uint8 input reproduces Pillow's fixed-point path exactly (horizontal
    pass, uint8 intermediate, vertical pass); float input follows Pillow's
    32-bit-float path (double accumulation, float32 intermediate)."""
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[:, :, None]
    H, W, C = arr.shape
    if arr.dtype == np.uint8:
        bias = 1 << (_PIL_PRECISION_BITS - 1)
        if W != out_w:
            _, mh = _resample_matrix(W, out_w)
            s = np.einsum("vw,hwc->hvc", mh, arr.astype(np.int64)) + bias
            arr = _clip8(s)
        if H != out_h:
            _, mv = _resample_matrix(H, out_h)
            s = np.einsum("vh,hwc->vwc", mv, arr.astype(np.int64)) + bias
            arr = _clip8(s)
    else:
        work = arr.astype(np.float64)
        if W != out_w:
            mh, _ = _resample_matrix(W, out_w)
            work = np.einsum("vw,hwc->hvc", mh, work).astype(np.float32)
            work = work.astype(np.float64)
        if H != out_h:
            mv, _ = _resample_matrix(H, out_h)
            work = np.einsum("vh,hwc->vwc", mv, work).astype(np.float32)
        arr = work.astype(arr.dtype if arr.dtype != np.float64 else np.float32)
    return arr[:, :, 0] if squeeze else arr


# ---------------------------------------------------------------------------
# Processor
# ---------------------------------------------------------------------------


@dataclass
class SiglipProcessor:
    """Numpy re-implementation of SiglipImageProcessor's preprocess."""

    size: int = 384
    do_resize: bool = True
    do_rescale: bool = True
    rescale_factor: float = 1.0 / 255.0
    do_normalize: bool = True
    image_mean: tuple = (0.5, 0.5, 0.5)
    image_std: tuple = (0.5, 0.5, 0.5)

    def resize_pil(self, image: Image.Image) -> Image.Image:
        return image.resize((self.size, self.size), Image.BICUBIC)

    def __call__(self, image: Union[Image.Image, np.ndarray]) -> np.ndarray:
        """-> (H, W, C) float32, normalized."""
        if isinstance(image, Image.Image):
            arr = np.asarray(self.resize_pil(image) if self.do_resize else image)
            arr = arr.astype(np.float32)
        else:
            arr = np.asarray(image)
            if self.do_resize and arr.shape[:2] != (self.size, self.size):
                # PIL-exact bicubic (the uint8 path is bit-identical to
                # routing the array through PIL, like HF processors do)
                src = arr if arr.dtype == np.uint8 else arr.astype(np.float32)
                arr = pil_bicubic_resize(src, self.size, self.size)
            arr = arr.astype(np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if self.do_rescale:
            arr = arr * self.rescale_factor
        if self.do_normalize:
            mean = np.asarray(self.image_mean[: arr.shape[-1]], np.float32)
            std = np.asarray(self.image_std[: arr.shape[-1]], np.float32)
            arr = (arr - mean) / std
        return arr

    def mask_variant(self) -> "SiglipProcessor":
        """Reference's mask processor: same resize, no normalize, rescale 1
        (mm_utils.py:281-286)."""
        return SiglipProcessor(
            size=self.size,
            do_resize=self.do_resize,
            do_rescale=True,
            rescale_factor=1.0,
            do_normalize=False,
            image_mean=self.image_mean,
            image_std=self.image_std,
        )


def expand2square(pil_img: Image.Image, background_color) -> Image.Image:
    """Pad to square, centering the image (mm_utils.py:249-276)."""
    width, height = pil_img.size
    if pil_img.mode == "L" and isinstance(background_color, tuple):
        background_color = background_color[0]
    if width == height:
        return pil_img
    if width > height:
        result = Image.new(pil_img.mode, (width, width), background_color)
        result.paste(pil_img, (0, (width - height) // 2))
        return result
    result = Image.new(pil_img.mode, (height, height), background_color)
    result.paste(pil_img, ((height - width) // 2, 0))
    return result


def pad_to_square_array(array: np.ndarray) -> np.ndarray:
    """Center-pad a 2D array to square (mm_utils.py:312-321)."""
    H, W = array.shape
    side = max(H, W)
    out = np.zeros((side, side), array.dtype)
    ph = (side - H) // 2
    pw = (side - W) // 2
    out[ph : ph + H, pw : pw + W] = array
    return out


# ---------------------------------------------------------------------------
# Public preprocessing API
# ---------------------------------------------------------------------------


def process_image(
    image: Union[str, Image.Image],
    processor: SiglipProcessor,
    image_aspect_ratio: str = "resize",
    return_info: bool = False,
):
    """-> (H, W, 3) float32 (+ optional {'width','height'} of the original)."""
    if isinstance(image, str):
        image = Image.open(image)
    image = image.convert("RGB")
    ori_w, ori_h = image.size
    if image_aspect_ratio == "resize":
        image = image.resize((processor.size, processor.size))
    elif image_aspect_ratio == "pad":
        bg = tuple(int(x * 255) for x in processor.image_mean)
        image = expand2square(image, bg)
    arr = processor(image)
    if return_info:
        return arr, {"width": ori_w, "height": ori_h}
    return arr


def process_depth(
    depth: Union[str, Image.Image],
    processor: SiglipProcessor,
    image_aspect_ratio: str = "resize",
) -> np.ndarray:
    """Depth map through the same processor (mm_utils.py:378-418): the
    stored PNG is already normalized; 'resize' path resizes then
    normalizes like an RGB image."""
    if isinstance(depth, str):
        depth = Image.open(depth)
    if depth.mode != "RGB":
        depth = depth.convert("RGB")
    if image_aspect_ratio == "resize":
        depth = depth.resize((processor.size, processor.size))
    elif image_aspect_ratio == "pad":
        bg = tuple(int(x * 255) for x in processor.image_mean)
        depth = expand2square(depth, bg)
    return processor(depth)


def masks_from_annotations(
    source: Dict,
    image_info: Optional[Dict] = None,
    modality: Optional[str] = None,
    rng: Optional[np.random.Generator] = None,
) -> List[np.ndarray]:
    """Raw binary masks from 'rle' / 'segmentation' / 'bbox' annotations
    (mm_utils.py:286-366).  modality is chosen at random among available
    keys when not pinned (training-time augmentation in the reference)."""
    available = [m for m in ("rle", "segmentation", "bbox") if m in source]
    if not available:
        raise KeyError("no region annotations in source")
    if modality is None:
        rng = rng or np.random.default_rng()
        modality = available[int(rng.integers(len(available)))]

    info = image_info or source.get("image_info")

    masks = []
    if modality == "rle":
        for rle in source["rle"]:
            masks.append(rle_decode(rle).astype(np.uint8))
    elif modality == "segmentation":
        assert info is not None
        for poly in source["segmentation"]:
            masks.append(polygons_to_mask(poly, info["height"], info["width"]))
    else:
        assert info is not None
        h, w = info["height"], info["width"]
        for bbox in source["bbox"]:
            x1, y1, x2, y2 = (int(max(0, min(v, lim))) for v, lim in zip(bbox, (w, h, w, h)))
            m = np.zeros((h, w), np.uint8)
            m[y1:y2, x1:x2] = 1
            masks.append(m)
    return masks


def process_masks(
    masks: Sequence[np.ndarray],
    processor: SiglipProcessor,
    image_aspect_ratio: str = "resize",
) -> np.ndarray:
    """Binary masks -> (R, size, size) float32 at processor resolution
    (mm_utils.py:330-375): 'resize' uses nearest-neighbor to the crop
    size; 'pad' center-pads to square; then the un-normalized processor."""
    mp = processor.mask_variant()
    out = []
    for m in masks:
        m = np.asarray(m, np.uint8)
        if image_aspect_ratio == "resize":
            if cv2 is not None:
                m = cv2.resize(m, (mp.size, mp.size), interpolation=cv2.INTER_NEAREST)
            else:
                m = np.asarray(
                    Image.fromarray(m).resize((mp.size, mp.size), Image.NEAREST)
                )
        elif image_aspect_ratio == "pad":
            m = pad_to_square_array(m)
        arr = mp(m.astype(np.float32))
        out.append(arr[:, :, 0] if arr.ndim == 3 else arr)
    return np.stack(out).astype(np.float32)


def pad_masks_to_slots(
    masks: Optional[np.ndarray], num_slots: int, size: int
) -> tuple:
    """Static-shape region slots: (R, H, W) -> ((num_slots, H, W), valid)."""
    out = np.zeros((num_slots, size, size), np.float32)
    valid = np.zeros((num_slots,), bool)
    if masks is not None:
        r = min(len(masks), num_slots)
        out[:r] = masks[:r]
        valid[:r] = True
    return out, valid
