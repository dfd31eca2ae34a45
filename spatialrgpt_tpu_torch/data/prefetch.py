"""Input-pipeline prefetching: overlap host-side batch assembly (dataset
__getitem__ + collation + device transfer) with the device's train step.

The reference gets this from torch DataLoader worker processes
(llava/train/train.py dataloader_num_workers); here a background thread
keeps a small queue of ready batches and optionally device_put's them
ahead of time, so the accelerator never waits on the host between steps
(double buffering).  Threads (not processes) suffice: the heavy host ops
(image decode/resize, RLE) release the GIL inside numpy/PIL/native
dataops.

The port's own copy of ``spatialrgpt_tpu/data/prefetch.py``.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional


class Prefetcher:
    """Wrap a batch iterable; pull batches on a background thread.

    depth: max batches buffered ahead (2 = classic double buffering).
    transfer: optional callable applied on the background thread (e.g.
    ``lambda b: jax.device_put(b, sharding)``) so the host->HBM copy also
    overlaps compute.
    """

    _SENTINEL = object()

    def __init__(
        self,
        batches: Iterable,
        depth: int = 2,
        transfer: Optional[Callable[[Any], Any]] = None,
    ):
        self._it = iter(batches)
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._transfer = transfer
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for batch in self._it:
                if self._stop.is_set():
                    return
                if self._transfer is not None:
                    batch = self._transfer(batch)
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on the consumer thread
            self._err = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(self._SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        # drain so the fill thread can exit a blocked put
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
