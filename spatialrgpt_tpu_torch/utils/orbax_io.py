"""The sharded, asynchronous checkpoint backend (port of
``spatialrgpt_tpu/utils/orbax_io.py``) on ``torch.distributed.checkpoint``.

The reference's orbax ``StandardCheckpointer`` writes asynchronously and
records shardings; ``torch.distributed.checkpoint`` (DCP, part of torch)
does both: each rank writes its own shards of a tree of tensors and
DTensors, ``async_save`` returns once the tensors are copied to host
memory and writes them on a thread, and a load into a tree of a different
sharding (fsdp 2 -> 1, 1 -> 2) reads the pieces each rank needs.  Select
with ``TrainerConfig(ckpt_backend="orbax")``.

Under a NCCL process group the checkpoint's own coordination runs on a
gloo group made once for it: DCP's asynchronous writer thread needs a
group that takes CPU tensors, and it must not share the card's
communicator with the training step.  Only the save and load planners'
metadata (which rank writes and reads which piece) and their barriers
cross that group; every rank writes and reads its own shards' data
through the file system.  It is the one group of a card run that is not
NCCL, and no training collective runs on it.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

_PENDING = []
_GROUP = None


def _group():
    """None without a process group; the group itself when it is gloo;
    else one gloo group over every rank, made at the first save (every
    rank saves at the same step)."""
    global _GROUP
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    if _GROUP is None:
        _GROUP = dist.new_group(backend="gloo")
    return _GROUP


def _rank0() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def save_pytree_orbax(path: str, tree: Any, wait: bool = False) -> None:
    """Asynchronous save of a (nested dict) tree of tensors and DTensors to
    the directory ``path``, replacing what is there.  Returns once the
    tensors are staged; pass ``wait=True`` (or call
    ``wait_until_finished``) to block until they are written."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    wait_until_finished()
    if _rank0() and os.path.isdir(path):
        shutil.rmtree(path)
    group = _group()
    if group is not None:
        dist.barrier(group=group)
    _PENDING.append(dcp.async_save(tree, checkpoint_id=path, process_group=group))
    if wait:
        wait_until_finished()


def wait_until_finished() -> None:
    while _PENDING:
        _PENDING.pop(0).result()


def load_pytree_orbax(path: str, like: Optional[Any] = None) -> Any:
    """Restore a tree saved by ``save_pytree_orbax``.  With ``like`` (a tree
    of tensors / DTensors of the names saved) the values are loaded into
    it in place, in its dtypes and shardings, and it is returned; without
    it the stored tensors come back whole."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    wait_until_finished()
    if like is None:
        from torch.distributed.checkpoint.state_dict_loader import _load_state_dict_from_keys

        return _load_state_dict_from_keys(checkpoint_id=path)
    dcp.load(like, checkpoint_id=path, process_group=_group())
    return like


def is_orbax_checkpoint(path: str) -> bool:
    """A finished checkpoint is a directory with DCP's metadata file (written
    last)."""
    return os.path.isdir(path) and os.path.exists(os.path.join(path, ".metadata"))
