"""Timing helpers (port of ``spatialrgpt_tpu/utils/timing.py``).

The reference fetches a scalar to the host to fence a queue of TPU
executions; on a CUDA card ``torch.cuda.synchronize`` is that fence, and
CUDA events time the device's work between two points of its stream.  On
the CPU the work is done when the call returns, and the host's clock
times it.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch


def _first_tensor(x) -> Optional[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def device_sync(x=None) -> None:
    """Wait for everything queued on the device of ``x``'s first tensor
    (``torch.cuda.synchronize`` on it); with no tensor in ``x`` the current
    CUDA device, if there is one.  CPU work is already done."""
    t = _first_tensor(x)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)
    elif t is None and torch.cuda.is_available():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 1) -> float:
    """Seconds per call of ``fn(*args)`` over ``iters`` back-to-back calls
    after ``warmup`` calls: CUDA events on the current stream where an
    argument or the warm-up's result is a CUDA tensor, else the host's
    ``perf_counter``."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    t = _first_tensor(list(args) + [out])
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters
