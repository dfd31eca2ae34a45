"""Profiling / tracing helpers (port of ``spatialrgpt_tpu/utils/profiling.py``).

``torch.profiler`` in the place of ``jax.profiler``: a Chrome trace of the
enclosed block (viewable in Perfetto), named ranges inside it, simple
wall-clock scopes, the card's memory report, and rank-aware printing.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    """Trace the enclosed block (the host, and the card when there is one)
    and write it to ``log_dir/trace.json`` as a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named range inside a trace (shows up in the profiler timeline)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def stopwatch(name: str, sink: Optional[Dict] = None):
    t0 = time.time()
    yield
    dt = time.time() - t0
    if sink is not None:
        sink[name] = sink.get(name, 0.0) + dt
    else:
        print(f"[stopwatch] {name}: {dt*1e3:.2f} ms")


def device_memory_report() -> Dict:
    """Per card, from ``torch.cuda.memory_stats``: the bytes the allocator
    holds for tensors now and at its peak, and the card's memory; raises
    without a card (there is nothing to report)."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_report: no CUDA card")
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out


def _rank() -> int:
    """This process's rank in the process group (0 without one)."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


# rank-aware printing (the reference's mprint / rprint)
def mprint(*args, **kwargs):
    """Print only on rank 0."""
    if _rank() == 0:
        print(*args, **kwargs)


def rprint(*args, **kwargs):
    """Print with the rank as a prefix."""
    print(f"[rank {_rank()}]", *args, **kwargs)
