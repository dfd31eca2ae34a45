"""Profiling / tracing helpers (port of ``spatialrgpt_tpu/utils/profiling.py``).

``torch.profiler`` in the place of ``jax.profiler``: a Chrome trace of the
enclosed block (viewable in Perfetto), named ranges inside it, the card's
memory report, and rank-aware printing.  The JAX package's ``stopwatch``
has no twin: a host clock without a synchronize times the enqueue of CUDA
work, not the work.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Union

import torch
from torch.autograd import profiler as _autograd_profiler

# what ``annotate`` returns while no profiler runs: one shared no-op context
NO_SPAN = contextlib.nullcontext()


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


def enabled() -> bool:
    """Whether a ``torch.profiler`` trace is running (one flag read)."""
    return _autograd_profiler._is_profiler_enabled


def annotate(name: Union[str, Callable[..., str]], *args):
    """A named range of a running ``torch.profiler`` trace
    (``record_function``): a host span on the profiler's clock, beside the
    card's kernels, so an idle gap of the card falls under the span that
    held the host.  ``name`` is the range's name, or a function that builds
    it from ``args``, called only while a profiler runs.

    While none runs (one flag read) it returns ``NO_SPAN``: no name is
    built and no ``record_function`` opened, so a span costs a call on
    paths that launch a thousand kernels a step.  It returns ``NO_SPAN``
    too while the current stream captures a CUDA graph: what is captured
    runs only when the graph is replayed, so a span there would mark no
    work."""
    if not _autograd_profiler._is_profiler_enabled or (
            torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
        return NO_SPAN
    return torch.profiler.record_function(name(*args) if callable(name) else name)


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
