"""Run one function on N new processes, one rank each, in one process group.

``run_ranks(fn, world, *args, device=...)`` spawns ``world`` processes;
each joins a process group through a ``FileStore`` in a fresh temporary
directory (NCCL with one card per rank for ``device="cuda"``, gloo for
``device="cpu"``: the caller names it, there is no default), runs ``fn(*args)`` and
returns what it returned, rank by rank.  The parent waits until a
deadline: a rank that fails or a group that is still running then is
killed, and ``run_ranks`` raises with the ranks' tracebacks, so a hang
cannot outlive the call.  ``fn`` must be importable by name (a module-level
function).  The dryrun (``dryrun.py``) and the tests' multi-rank cases run
through it.
"""

from __future__ import annotations

import datetime
import faulthandler
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List


def _entry(rank: int, fn: Callable, world: int, root: str, device: str, timeout_s: float) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    # a rank still running near the deadline prints where it waits
    faulthandler.dump_traceback_later(max(timeout_s - 5, 1))
    try:
        backend = "gloo" if device == "cpu" else "nccl"
        if backend == "nccl":
            torch.cuda.set_device(rank)
        store = dist.FileStore(os.path.join(root, "store"), world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(*torch.load(os.path.join(root, "args.pt"), weights_only=False))
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
        faulthandler.cancel_dump_traceback_later()
    except BaseException:
        with open(os.path.join(root, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn: Callable, world: int, *args, device: str, timeout_s: float = 120.0,
              workdir: str = None) -> List[Any]:
    """``fn(*args)`` on ``world`` ranks (``device`` "cuda": NCCL, rank r on
    card r, which needs ``world`` cards; "cpu": gloo); every rank's
    return value, in rank order.  Raises when a rank fails or the group
    outlives ``timeout_s`` seconds, after killing the ranks still alive.
    The store and the results live in a new directory under ``workdir``
    (the system's temporary directory by default)."""
    import torch
    import torch.multiprocessing as mp

    if device not in ("cpu", "cuda"):
        raise ValueError(f"run_ranks: device must be 'cuda' or 'cpu', not {device!r}")
    if device == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"run_ranks: {world} NCCL ranks need {world} cards, this machine has "
                           f"{torch.cuda.device_count()}")
    root = tempfile.mkdtemp(prefix="srgpt_ranks_", dir=workdir)
    # the arguments go through a file: a large payload in the spawn pipe
    # would hold each start until the previous child has unpickled it
    torch.save(args, os.path.join(root, "args.pt"))
    ctx = mp.start_processes(_entry, args=(fn, world, root, device, timeout_s), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            try:
                if ctx.join(timeout=1.0):
                    break
            except Exception as e:  # a rank exited with an error
                raise RuntimeError(f"run_ranks: {_errors(root) or e}") from None
            if time.monotonic() > deadline:
                raise TimeoutError(f"run_ranks: {world} ranks still running after {timeout_s} s; killed. "
                                   f"{_errors(root)}")
        return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in range(world)]
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(root, ignore_errors=True)


def _errors(root: str) -> str:
    out = []
    for name in sorted(os.listdir(root)):
        if name.endswith(".err"):
            with open(os.path.join(root, name)) as f:
                out.append(f"{name[:-4]}:\n{f.read()}")
    return "\n".join(out)
