"""Training loop with checkpoint / resume (port of
``spatialrgpt_tpu/train/trainer.py``).

- step checkpoints ``checkpoint-<N>/`` (``state.pt``: the optimizer's
  parameters by name; ``opt.pt``: the optimizer state; and
  ``trainer_state.json``), pruned to ``save_total_limit``;
- resume from the newest checkpoint, fast-forwarding the (deterministic)
  batch stream past the steps already taken; a ``config.json`` at the root
  means the run finished;
- wall-clock pre-termination and a pollable autoresume hook;
- jsonl metrics;
- a final save of the HF-named state dicts in the split composite layout
  (``utils/weights.py::save_composite``).

A checkpoint holds what training changes: the parameters handed to the
optimizer and its state.  Frozen modules are not written; the caller
builds them again as it did for the first run (the same weights, or the
same seed).

``ckpt_backend="orbax"`` is the reference's asynchronous, sharding-aware
backend, here ``utils/orbax_io.py`` on ``torch.distributed.checkpoint``:
``checkpoint-<N>/state_orbax/`` holds the trained parameters, the Adam
moments and a ``MultiSteps`` accumulator by parameter name (each rank its
shards), ``opt_meta.json`` the optimizer's counters; a run resumes at
another FSDP degree.  With the ``torch`` backend an FSDP-sharded model's
tensors are gathered whole and rank 0 writes them, in the layout of a
single-process run, which loads into a sharded run too.  Every rank of a
process group runs the ``Trainer``; rank 0 writes the files that are not
sharded and the metrics.
"""

from __future__ import annotations

import glob
import json
import os
import re
import shutil
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional

import torch
import torch.distributed as dist

from spatialrgpt_tpu_torch.config import SpatialRGPTConfig
from spatialrgpt_tpu_torch.parallel.mesh import world_size
from spatialrgpt_tpu_torch.train.optimizer import MultiSteps
from spatialrgpt_tpu_torch.utils import orbax_io
from spatialrgpt_tpu_torch.utils.weights import save_composite


def _distributed() -> bool:
    return world_size() > 1


def _rank0() -> bool:
    return not _distributed() or dist.get_rank() == 0


def _barrier() -> None:
    if _distributed():
        dist.barrier()


def _full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (a collective), a plain tensor itself."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _whole(obj):
    """A (nested) state dict with every DTensor gathered whole."""
    if isinstance(obj, dict):
        return {k: _whole(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_whole(v) for v in obj]
    return _full(obj).detach() if isinstance(obj, torch.Tensor) else obj


def _assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy a whole tensor into ``dst``, into its local shard when it is a
    DTensor."""
    if hasattr(dst, "device_mesh"):
        from torch.distributed.tensor import distribute_tensor

        src = distribute_tensor(src.to(dst.device, dst.dtype), dst.device_mesh, dst.placements).to_local()
        dst = dst.to_local()
    dst.copy_(src)


@dataclass
class TrainerConfig:
    output_dir: str = "output"
    max_steps: int = 1000
    save_steps: int = 100
    save_total_limit: int = 1
    log_steps: int = 10
    autoresume_poll_steps: int = 50
    total_time_limit_min: Optional[float] = None
    pre_terminate_min: float = 5.0
    report_to: str = "jsonl"  # jsonl | wandb (jsonl too; wandb where it imports and inits) | none
    # torch (torch.save of whole tensors) or orbax (async and sharded:
    # torch.distributed.checkpoint, utils/orbax_io.py)
    ckpt_backend: str = "torch"

    def __post_init__(self):
        if self.ckpt_backend not in ("torch", "orbax"):
            raise NotImplementedError(f"ckpt_backend={self.ckpt_backend!r}: the port saves with torch or orbax")
        if self.report_to not in ("jsonl", "wandb", "none"):
            raise NotImplementedError(f"report_to={self.report_to!r}: the port logs to jsonl, wandb or nowhere")


def find_resume_checkpoint(output_dir: str) -> Optional[str]:
    """Newest complete ``checkpoint-<N>`` directory, or None; "DONE" when a
    root ``config.json`` says the run already finished."""
    if os.path.exists(os.path.join(output_dir, "config.json")):
        return "DONE"
    steps = []
    for c in glob.glob(os.path.join(output_dir, "checkpoint-*")):
        m = re.match(r".*checkpoint-(\d+)$", c)
        orbax = os.path.isdir(os.path.join(c, "state_orbax"))
        # an orbax checkpoint counts once its writer finished (DCP's metadata is written last)
        if m and os.path.exists(os.path.join(c, "trainer_state.json")) and (
                not orbax or orbax_io.is_orbax_checkpoint(os.path.join(c, "state_orbax"))):
            steps.append((int(m.group(1)), c))
    return max(steps)[1] if steps else None


class MetricsLogger:
    """Rank 0's metrics: ``metrics.jsonl`` for ``"jsonl"`` and ``"wandb"``;
    for ``"wandb"`` also ``wandb.log``, where ``import wandb`` and
    ``wandb.init`` succeed (else jsonl alone, as the reference does)."""

    def __init__(self, cfg: TrainerConfig):
        self.f = None
        self.wandb = None
        if not _rank0():
            return
        if cfg.report_to in ("jsonl", "wandb"):
            os.makedirs(cfg.output_dir, exist_ok=True)
            self.f = open(os.path.join(cfg.output_dir, "metrics.jsonl"), "a")
        if cfg.report_to == "wandb":
            try:
                import wandb

                wandb.init(project=os.environ.get("WANDB_PROJECT", "SpatialRGPT"), resume="allow")
                self.wandb = wandb
            except Exception:  # no wandb, or no run: jsonl alone
                pass

    def log(self, step: int, metrics: Dict) -> None:
        rec = {"step": step, "time": time.time(), **{k: float(v) for k, v in metrics.items()}}
        if self.f:
            self.f.write(json.dumps(rec) + "\n")
            self.f.flush()
        if self.wandb:
            self.wandb.log(rec, step=step)

    def close(self) -> None:
        if self.f:
            self.f.close()


class Trainer:
    def __init__(
        self,
        cfg: SpatialRGPTConfig,
        tcfg: TrainerConfig,
        train_step: Callable,
        state,
        batches: Iterable,
        autoresume_check: Optional[Callable[[], bool]] = None,
        save_final_fn: Optional[Callable] = None,
    ):
        self.cfg = cfg
        self.tcfg = tcfg
        self.train_step = train_step
        self.state = state
        self.batches = batches
        self.autoresume_check = autoresume_check
        self.save_final_fn = save_final_fn
        self.logger = MetricsLogger(tcfg)
        self.start_time = time.time()

    # -- checkpointing -----------------------------------------------------

    def _trained(self) -> Dict[str, torch.nn.Parameter]:
        """The optimizer's parameters under their names in the model."""
        ids = {id(p) for group in self.state.optimizer.param_groups for p in group["params"]}
        return {name: p for name, p in self.state.model.named_parameters() if id(p) in ids}

    def _inner(self):
        opt = self.state.optimizer
        return opt.inner if isinstance(opt, MultiSteps) else opt

    def _tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """What a checkpoint holds, by parameter name: the trained
        parameters, their Adam moments (made as zeros where the optimizer
        has not stepped yet, which is its own first step's state) and a
        ``MultiSteps`` accumulator; DTensors where the model is sharded."""
        trained, inner = self._trained(), self._inner()
        tree = {"params": dict(trained), "mu": {}, "nu": {}}
        for name, p in trained.items():
            st = inner.state[p]
            if not st:
                st["mu"], st["nu"] = torch.zeros_like(p), torch.zeros_like(p)
            tree["mu"][name], tree["nu"][name] = st["mu"], st["nu"]
        opt = self.state.optimizer
        if isinstance(opt, MultiSteps):
            index = {id(p): i for i, p in enumerate(opt._params())}
            tree["acc"] = {name: opt.acc[index[id(p)]] for name, p in trained.items()}
        return tree

    def _meta(self) -> Dict:
        inner, opt = self._inner(), self.state.optimizer
        meta = {"counts": [g["count"] for g in inner.param_groups], "notfinite_count": inner.notfinite_count}
        if isinstance(opt, MultiSteps):
            meta.update(mini_step=opt.mini_step, gradient_step=opt.gradient_step)
        return meta

    def _set_meta(self, meta: Dict) -> None:
        inner, opt = self._inner(), self.state.optimizer
        for g, n in zip(inner.param_groups, meta["counts"], strict=True):
            g["count"] = n
        inner.notfinite_count = meta["notfinite_count"]
        if isinstance(opt, MultiSteps):
            opt.mini_step, opt.gradient_step = meta["mini_step"], meta["gradient_step"]

    def save_checkpoint(self, step: int) -> str:
        d = os.path.join(self.tcfg.output_dir, f"checkpoint-{step}")
        os.makedirs(d, exist_ok=True)
        if self.tcfg.ckpt_backend == "orbax":
            # asynchronous: training goes on while the shards are written
            orbax_io.save_pytree_orbax(os.path.join(d, "state_orbax"), self._tree())
            if _rank0():
                with open(os.path.join(d, "opt_meta.json"), "w") as f:
                    json.dump(self._meta(), f)
        else:
            params = {name: _full(p).detach() for name, p in self._trained().items()}
            opt = _whole(self.state.optimizer.state_dict())
            if _rank0():
                torch.save(params, os.path.join(d, "state.pt"))
                torch.save(opt, os.path.join(d, "opt.pt"))
        if _rank0():
            with open(os.path.join(d, "trainer_state.json"), "w") as f:  # written last: marks the checkpoint whole
                json.dump({"step": step}, f)
        if self.tcfg.ckpt_backend == "orbax" and self.tcfg.save_total_limit > 0:
            orbax_io.wait_until_finished()  # a directory a writer may still own is not pruned
        _barrier()
        if _rank0():
            self._prune()
        _barrier()
        return d

    def _prune(self) -> None:
        cands = sorted(
            glob.glob(os.path.join(self.tcfg.output_dir, "checkpoint-*")),
            key=lambda c: int(re.match(r".*checkpoint-(\d+)$", c).group(1)),
        )
        while len(cands) > self.tcfg.save_total_limit:
            shutil.rmtree(cands.pop(0))

    def load_checkpoint(self, path: str) -> int:
        if os.path.isdir(os.path.join(path, "state_orbax")):
            with torch.no_grad():
                orbax_io.load_pytree_orbax(os.path.join(path, "state_orbax"), like=self._tree())
            with open(os.path.join(path, "opt_meta.json")) as f:
                self._set_meta(json.load(f))
        else:
            self._load_torch(path)
        with open(os.path.join(path, "trainer_state.json")) as f:
            step = json.load(f)["step"]
        self.state = self.state._replace(step=step)
        return step

    def _load_torch(self, path: str) -> None:
        """``state.pt`` (the trained parameters by name) and ``opt.pt`` (the
        optimizer's ``state_dict``), whole tensors, into this run's
        parameters and optimizer, sharded or not."""
        params = torch.load(os.path.join(path, "state.pt"), map_location="cpu")
        trained = self._trained()
        if params.keys() != trained.keys():
            raise ValueError(f"{path}: checkpoint parameters differ from the optimizer's")
        with torch.no_grad():
            for name, p in trained.items():
                _assign(p, params[name])
        opt = self.state.optimizer
        opt.load_state_dict(torch.load(os.path.join(path, "opt.pt"), map_location="cpu"))
        # the loaded moments and accumulator are whole: shard them as their parameters
        from torch.distributed.tensor import distribute_tensor

        inner = self._inner()
        for p in trained.values():
            if hasattr(p, "device_mesh"):
                for k, t in inner.state[p].items():
                    if isinstance(t, torch.Tensor) and not hasattr(t, "device_mesh"):
                        inner.state[p][k] = distribute_tensor(t, p.device_mesh, p.placements)
        if isinstance(opt, MultiSteps):
            opt.acc = [distribute_tensor(a, p.device_mesh, p.placements)
                       if hasattr(p, "device_mesh") and not hasattr(a, "device_mesh") else a
                       for a, p in zip(opt.acc, opt._params())]

    # -- time budget -------------------------------------------------------

    def _out_of_time(self) -> bool:
        if self.tcfg.total_time_limit_min is None:
            return False
        elapsed_min = (time.time() - self.start_time) / 60
        return elapsed_min > self.tcfg.total_time_limit_min - self.tcfg.pre_terminate_min

    # -- loop --------------------------------------------------------------

    def train(self) -> Dict:
        tcfg = self.tcfg
        resume = find_resume_checkpoint(tcfg.output_dir)
        step = 0
        if resume == "DONE":
            return {"status": "already_done"}
        if resume:
            step = self.load_checkpoint(resume)
            # the resumed run sees the data order of an uninterrupted one
            it = iter(self.batches)
            for _ in range(step):
                next(it, None)
            self.batches = it

        status = "completed"
        for batch in self.batches:
            if step >= tcfg.max_steps:
                break
            self.state, metrics = self.train_step(self.state, batch)
            step += 1
            if step % tcfg.log_steps == 0:
                self.logger.log(step, metrics)
            if step % tcfg.save_steps == 0:
                self.save_checkpoint(step)
            if (
                self.autoresume_check is not None
                and step % tcfg.autoresume_poll_steps == 0
                and self.autoresume_check()
            ):
                self.save_checkpoint(step)
                status = "preempted"
                break
            if self._out_of_time():
                self.save_checkpoint(step)
                status = "timeout"
                break

        if self.tcfg.ckpt_backend == "orbax":
            orbax_io.wait_until_finished()  # a timeout or preemption saves just before it breaks out
        if status == "completed":
            self.save_final()
        self.logger.close()
        return {"status": status, "step": step}

    def save_final(self) -> None:
        if self.save_final_fn is not None:
            self.save_final_fn(self.tcfg.output_dir, self.state)
            return
        model = self.state.model
        if _distributed():  # whole tensors, written by rank 0
            state = {name: _full(t).detach().cpu() for name, t in model.state_dict().items()}
            if _rank0():
                save_composite(self.tcfg.output_dir, model, self.cfg, state=state)
            _barrier()
            return
        save_composite(self.tcfg.output_dir, model, self.cfg)
