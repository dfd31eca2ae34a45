"""ctypes bindings for the repository's native data-ops library
(``native/dataops.cpp``; a copy of ``spatialrgpt_tpu/utils/native.py``).

Builds it with ``native/build.sh`` at first use when g++ is available;
every entry point has a numpy fallback so the package works without the
compiled library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is not None:
        return _LIB
    so = os.path.join(_NATIVE_DIR, "libdataops.so")
    if not os.path.exists(so):
        try:
            subprocess.run(
                ["sh", os.path.join(_NATIVE_DIR, "build.sh")],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.rle_decode.restype = ctypes.c_int
    lib.rle_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.rle_decode_counts.restype = ctypes.c_int
    lib.rle_decode_counts.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.resize_nearest.restype = None
    lib.resize_nearest.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
    ]
    lib.resize_bilinear.restype = None
    lib.resize_bilinear.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
    ]
    lib.pack_greedy.restype = ctypes.c_int64
    lib.pack_greedy.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def rle_decode(rle: dict) -> np.ndarray:
    """Native COCO RLE decode; falls back to the python implementation."""
    lib = _load()
    h, w = rle["size"]
    counts = rle["counts"]
    if lib is not None:
        mask = np.zeros((h, w), np.uint8)
        ptr = mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        if isinstance(counts, (bytes, str)):
            data = counts.encode("ascii") if isinstance(counts, str) else counts
            rc = lib.rle_decode(data, len(data), h, w, ptr)
        else:
            arr = np.ascontiguousarray(np.asarray(counts, np.int64))
            rc = lib.rle_decode_counts(
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(arr), h, w, ptr
            )
        if rc == 0:
            return mask
    from spatialrgpt_tpu_torch.data.preprocess import rle_decode as py_decode

    return py_decode(rle)


def resize_nearest(mask: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(mask, np.uint8)
    if lib is not None:
        dst = np.empty((out_h, out_w), np.uint8)
        lib.resize_nearest(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), src.shape[0], src.shape[1],
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out_h, out_w,
        )
        return dst
    try:
        import cv2

        return cv2.resize(src, (out_w, out_h), interpolation=cv2.INTER_NEAREST)
    except ImportError:
        from PIL import Image

        return np.asarray(Image.fromarray(src).resize((out_w, out_h), Image.NEAREST))


def resize_bilinear(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    lib = _load()
    src = np.ascontiguousarray(x, np.float32)
    if lib is not None:
        dst = np.empty((out_h, out_w), np.float32)
        lib.resize_bilinear(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), src.shape[0], src.shape[1],
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out_h, out_w,
        )
        return dst
    import cv2

    return cv2.resize(src, (out_w, out_h), interpolation=cv2.INTER_LINEAR)


def pack_greedy(lengths: np.ndarray, max_len: int) -> np.ndarray:
    """-> bin assignment per sample (first-fit decreasing)."""
    lib = _load()
    arr = np.ascontiguousarray(lengths, np.int64)
    if lib is not None:
        out = np.empty(len(arr), np.int64)
        lib.pack_greedy(
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(arr), max_len,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return out
    # python fallback
    order = sorted(range(len(arr)), key=lambda i: -arr[i])
    fill, out = [], np.empty(len(arr), np.int64)
    for i in order:
        for b in range(len(fill)):
            if fill[b] + arr[i] <= max_len:
                fill[b] += arr[i]
                out[i] = b
                break
        else:
            out[i] = len(fill)
            fill.append(int(arr[i]))
    return out
