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
same seed).  ``ckpt_backend="orbax"`` is the reference's TPU-side async
backend and raises here.
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

from spatialrgpt_tpu_torch.config import SpatialRGPTConfig
from spatialrgpt_tpu_torch.utils.weights import save_composite


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
    report_to: str = "jsonl"  # jsonl | none
    ckpt_backend: str = "torch"  # torch (torch.save); "orbax" is not ported

    def __post_init__(self):
        if self.ckpt_backend != "torch":
            raise NotImplementedError(f"ckpt_backend={self.ckpt_backend!r}: the port saves with torch.save only")
        if self.report_to not in ("jsonl", "none"):
            raise NotImplementedError(f"report_to={self.report_to!r}: the port logs to jsonl or nowhere")


def find_resume_checkpoint(output_dir: str) -> Optional[str]:
    """Newest complete ``checkpoint-<N>`` directory, or None; "DONE" when a
    root ``config.json`` says the run already finished."""
    if os.path.exists(os.path.join(output_dir, "config.json")):
        return "DONE"
    steps = []
    for c in glob.glob(os.path.join(output_dir, "checkpoint-*")):
        m = re.match(r".*checkpoint-(\d+)$", c)
        if m and os.path.exists(os.path.join(c, "trainer_state.json")):
            steps.append((int(m.group(1)), c))
    return max(steps)[1] if steps else None


class MetricsLogger:
    def __init__(self, cfg: TrainerConfig):
        self.f = None
        if cfg.report_to == "jsonl":
            os.makedirs(cfg.output_dir, exist_ok=True)
            self.f = open(os.path.join(cfg.output_dir, "metrics.jsonl"), "a")

    def log(self, step: int, metrics: Dict) -> None:
        if self.f:
            rec = {"step": step, "time": time.time(), **{k: float(v) for k, v in metrics.items()}}
            self.f.write(json.dumps(rec) + "\n")
            self.f.flush()

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

    def save_checkpoint(self, step: int) -> str:
        d = os.path.join(self.tcfg.output_dir, f"checkpoint-{step}")
        os.makedirs(d, exist_ok=True)
        torch.save({name: p.detach() for name, p in self._trained().items()}, os.path.join(d, "state.pt"))
        torch.save(self.state.optimizer.state_dict(), os.path.join(d, "opt.pt"))
        with open(os.path.join(d, "trainer_state.json"), "w") as f:  # written last: marks the checkpoint whole
            json.dump({"step": step}, f)
        self._prune()
        return d

    def _prune(self) -> None:
        cands = sorted(
            glob.glob(os.path.join(self.tcfg.output_dir, "checkpoint-*")),
            key=lambda c: int(re.match(r".*checkpoint-(\d+)$", c).group(1)),
        )
        while len(cands) > self.tcfg.save_total_limit:
            shutil.rmtree(cands.pop(0))

    def load_checkpoint(self, path: str) -> int:
        params = torch.load(os.path.join(path, "state.pt"), map_location="cpu")
        trained = self._trained()
        if params.keys() != trained.keys():
            raise ValueError(f"{path}: checkpoint parameters differ from the optimizer's")
        with torch.no_grad():
            for name, p in trained.items():
                p.copy_(params[name])
        self.state.optimizer.load_state_dict(torch.load(os.path.join(path, "opt.pt"), map_location="cpu"))
        with open(os.path.join(path, "trainer_state.json")) as f:
            step = json.load(f)["step"]
        self.state = self.state._replace(step=step)
        return step

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

        if status == "completed":
            self.save_final()
        self.logger.close()
        return {"status": status, "step": step}

    def save_final(self) -> None:
        if self.save_final_fn is not None:
            self.save_final_fn(self.tcfg.output_dir, self.state)
            return
        save_composite(self.tcfg.output_dir, self.state.model, self.cfg)
