"""A bounded slice of a run under ``torch.profiler``, read back as the
card's kernel intervals and the host's spans: busy and idle time, kernel
time by name, and what the host was doing in the longest idle gaps.

The slice is marked by a span of its own (``bench.slice``), so its start
and end are read on the trace's clock.  Only the profiler's start and stop
happen inside the measured window; the chrome trace is written after it
closes, to one fixed file inside the checkout, read and deleted.
"""

from __future__ import annotations

import bisect
import json
import os
import re
from typing import Dict, List, Optional, Tuple

SLICE = "bench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


class Timeline:
    def __init__(self, events: List[dict]):
        sl = [e for e in events if e.get("name") == SLICE and e.get("ph") == "X" and e.get("cat") in HOST_CATS]
        if not sl:
            raise ValueError("the trace holds no bench.slice span")
        s = sl[0]
        self.t0, self.t1 = float(s["ts"]), float(s["ts"]) + float(s["dur"])  # us
        self.main = (s.get("pid"), s.get("tid"))
        self.kernels: List[Tuple[float, float, str]] = []
        self.host: List[Tuple[float, float, str]] = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if b <= self.t0 or a >= self.t1:
                continue
            if e.get("cat") in DEVICE_CATS:
                self.kernels.append((max(a, self.t0), min(b, self.t1), e.get("name", "?")))
            elif e.get("cat") in HOST_CATS and (e.get("pid"), e.get("tid")) == self.main and e["name"] != SLICE:
                self.host.append((a, b, e["name"]))
        self.kernels.sort()

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for a, b, _ in self.kernels:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def idle_share(self) -> Optional[float]:
        """Share of the slice's wall time with no kernel, copy or set on the
        card, or None where nothing ran."""
        if not self.kernels:
            return None
        return 1.0 - self.busy_s / self.window_s

    def kernel_seconds(self, pattern: str) -> Tuple[float, int]:
        """(summed device seconds, launches) of the kernels whose name
        matches ``pattern`` (a regular expression, searched)."""
        rx = re.compile(pattern)
        hits = [b - a for a, b, n in self.kernels if rx.search(n)]
        return sum(hits) * 1e-6, len(hits)

    def device_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for a, b, name in self.kernels:
            by[name[:200]] = by.get(name[:200], 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The idle time between kernels, summed by the innermost host span
        under each gap's midpoint (``host idle`` where none)."""
        host = sorted(self.host)
        starts = [h[0] for h in host]
        by: Dict[str, float] = {}
        prev = self.t0
        for a, b in self.busy_intervals() + [(self.t1, self.t1)]:
            if a > prev:
                mid = (a + prev) / 2
                name = "host idle"
                i = bisect.bisect_right(starts, mid) - 1
                for j in range(i, max(i - 5000, -1), -1):  # the latest start that still covers mid
                    if host[j][1] >= mid:
                        name = host[j][2][:200]
                        break
                by[name] = by.get(name, 0.0) + (a - prev) * 1e-6
            prev = max(prev, b)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


class Slice:
    """A slice of a run under ``torch.profiler`` (host and CUDA activity)
    inside a ``bench.slice`` span.  ``start`` and ``stop`` are the only
    work inside the measured window; ``timeline`` exports, reads and
    deletes the chrome trace once the window has closed."""

    def __init__(self, path: str):
        self.path, self.prof, self.span = path, None, None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=False,
                            with_stack=False)
        self.prof.start()
        self.span = record_function(SLICE)
        self.span.__enter__()

    def stop(self) -> None:
        import torch

        self.span.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()

    def timeline(self) -> Timeline:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        try:
            with open(self.path) as f:
                data = json.load(f)
        finally:
            os.remove(self.path)
        return Timeline(data["traceEvents"] if isinstance(data, dict) else data)
