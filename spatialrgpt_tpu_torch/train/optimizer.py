"""Optimizer: per-module groups, each clipped by its own norm, AdamW with a
warmup + decay schedule (port of ``spatialrgpt_tpu/train/optimizer.py``).

The reference builds ``optax.multi_transform`` over the top-level modules
(llm / vision / projector / region): each tuned group gets its own
``chain(clip_by_global_norm(max_grad_norm), adamw(schedule))`` and each
frozen group ``set_to_zero``; ``skip_nonfinite_updates`` wraps the whole in
``apply_if_finite``.  ``AdamW`` here keeps those numerics:

- the clip is per group: a group's gradients are scaled by
  ``max_grad_norm / norm`` when their own norm is not below
  ``max_grad_norm``;
- the learning rate of a group's n-th update (0-based) is the optax
  schedule at n, so with a warmup the first update has lr 0 (the moments
  move, the parameters do not);
- weight decay is decoupled (added to the Adam direction before the lr),
  eps sits outside the square root, and the moments are kept in the
  parameter dtype;
- a frozen group's parameters are not handed to the optimizer and have
  ``requires_grad=False`` (``build_optimizer`` sets it from the tune flags);
- LoRA adapters (a module named ``adapters``) always train, at the base lr
  (``spatialrgpt_tpu/train/optimizer.py:93-94``);
- with ``skip_nonfinite_updates = n > 0`` a step whose gradients hold a
  non-finite value changes nothing, unless it is the (n + 1)-th such step
  in a row.

FSDP-sharded parameters (DTensors, ``parallel/mesh.py::shard_model``): a
group's norm sums the squares over the shards, the moments are DTensors of
the parameter's sharding, and the elementwise update runs on the local
shards.

``MultiSteps`` is gradient accumulation with ``optax.MultiSteps``' meaning
(``train/train.py:165-168`` wraps the optimizer in it): the gradients of k
micro steps are averaged, and the wrapped ``AdamW`` updates on every k-th
call only, so its schedule counts updates, not micro steps.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (its storage: in-place updates reach the
    DTensor), a plain tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def sq_sum(t: torch.Tensor) -> torch.Tensor:
    """The f32 sum of squares of every element of t, a plain 0-dim tensor;
    a sharded DTensor's is reduced over its shards (a collective every
    rank takes)."""
    s = t.float().square().sum()
    return s.full_tensor() if hasattr(s, "full_tensor") else s


@dataclass(frozen=True)
class OptimizerConfig:
    """Field-for-field twin of the reference's ``OptimizerConfig``."""

    learning_rate: float = 2e-5
    mm_projector_lr: Optional[float] = None  # defaults to learning_rate
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    warmup_ratio: float = 0.03
    total_steps: int = 1000
    lr_scheduler: str = "cosine"  # cosine | linear | constant
    max_grad_norm: float = 1.0
    tune_language_model: bool = True
    tune_vision_tower: bool = False
    tune_mm_projector: bool = True
    tune_region_extractor: bool = True
    skip_nonfinite_updates: int = 0  # 0 = off; else max consecutive skips


# reference label -> the port's sub-module (the split checkpoint dir names;
# ``adapters``: the LoRA / QLoRA adapters, ``train/lora.py::LoraAdapters``)
MODULES: Dict[str, str] = {
    "llm": "llm",
    "vision": "vision_tower",
    "projector": "mm_projector",
    "region": "region_extractor",
    "adapters": "adapters",
}


def learning_rate(ocfg: OptimizerConfig, peak_lr: float, count: int) -> float:
    """The optax schedule of ``_schedule`` at update ``count`` (0-based):
    cosine = ``warmup_cosine_decay_schedule(0, peak, warmup,
    max(total, warmup + 1), 0)``; linear = warmup then linear decay to 0."""
    warmup = max(int(ocfg.warmup_ratio * ocfg.total_steps), 0)
    if ocfg.lr_scheduler == "cosine":
        if count < warmup:
            return peak_lr * count / warmup
        decay = max(ocfg.total_steps, warmup + 1) - warmup
        t = min(count - warmup, decay)
        return peak_lr * 0.5 * (1 + math.cos(math.pi * t / decay))
    if ocfg.lr_scheduler == "linear":
        if count < warmup:
            w = max(warmup, 1)
            return peak_lr * min(count, w) / w
        n = max(ocfg.total_steps - warmup, 1)
        return peak_lr * (1 - min(count - warmup, n) / n)
    return peak_lr


class AdamW(torch.optim.Optimizer):
    """One param group per tuned module (``label``, ``peak_lr``, ``count``:
    the group's applied updates); see the module docstring.  A parameter
    of a group with no gradient counts as a zero gradient, as a
    stop-gradient gives in the reference."""

    def __init__(self, groups, ocfg: OptimizerConfig):
        super().__init__(groups, defaults={"count": 0})
        self.ocfg = ocfg
        self.notfinite_count = 0

    def _grads(self, group):
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in group["params"]]

    def learning_rate(self, group, count: int) -> float:
        """The group's learning rate at its update ``count`` (0-based)."""
        return learning_rate(self.ocfg, group["peak_lr"], count)

    @torch.no_grad()
    def step(self, closure=None) -> None:
        c = self.ocfg
        grads = [self._grads(group) for group in self.param_groups]
        if c.skip_nonfinite_updates > 0:
            from spatialrgpt_tpu_torch.parallel.mesh import world_sum

            bad = sum(int((~torch.isfinite(local(g))).sum()) for gs in grads for g in gs)
            finite = int(world_sum(torch.tensor(bad))) == 0
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            if not finite and self.notfinite_count <= c.skip_nonfinite_updates:
                return
        for group, gs in zip(self.param_groups, grads):
            norm = torch.sqrt(sum(sq_sum(g) for g in gs))
            keep = norm < c.max_grad_norm
            n = group["count"]
            lr = self.learning_rate(group, n)
            # optax forms the bias corrections in f32, then divides in the
            # moment's dtype
            bc1, bc2 = (1 - torch.tensor(b, dtype=torch.float32) ** (n + 1) for b in (c.adam_b1, c.adam_b2))
            for p, g in zip(group["params"], gs):
                st = self.state[p]
                if not st:
                    st["mu"], st["nu"] = torch.zeros_like(p), torch.zeros_like(p)
                pl, g, mu0, nu0 = local(p), local(g), local(st["mu"]), local(st["nu"])
                g = torch.where(keep, g, g / norm.to(g.dtype) * c.max_grad_norm)
                mu = (1 - c.adam_b1) * g + c.adam_b1 * mu0
                nu = (1 - c.adam_b2) * (g * g) + c.adam_b2 * nu0
                mu_hat = mu / bc1.to(pl.device, mu.dtype)
                nu_hat = nu / bc2.to(pl.device, nu.dtype)
                u = mu_hat / (torch.sqrt(nu_hat) + c.adam_eps) + c.weight_decay * pl
                pl.add_(u * -lr)
                mu0.copy_(mu)
                nu0.copy_(nu)
            group["count"] = n + 1

    def state_dict(self):
        return {**super().state_dict(), "notfinite_count": self.notfinite_count}

    def load_state_dict(self, state_dict) -> None:
        state_dict = dict(state_dict)
        self.notfinite_count = state_dict.pop("notfinite_count", 0)
        super().load_state_dict(state_dict)


class MultiSteps:
    """``optax.MultiSteps(inner, every_k)`` with its defaults: each call
    folds the micro step's gradients into a running mean (Welford's
    ``acc + (g - acc) / (n + 1)``, as optax), and the k-th call hands the
    mean to ``inner`` as the gradients of one update and starts the mean
    again; between, the parameters do not move.  A parameter with no
    gradient counts as a zero gradient, as in ``AdamW``.  The state (the
    means, the micro step and the updates taken) is part of
    ``state_dict``, so a checkpoint taken in the middle of an accumulation
    resumes it exactly."""

    def __init__(self, inner: AdamW, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k {every_k} < 1")
        self.inner, self.every_k = inner, every_k
        self.mini_step = self.gradient_step = 0
        self.acc = [torch.zeros_like(p) for group in inner.param_groups for p in group["params"]]

    @property
    def param_groups(self):
        return self.inner.param_groups

    def _params(self):
        return [p for group in self.inner.param_groups for p in group["params"]]

    @torch.no_grad()
    def step(self, closure=None) -> None:
        n = self.mini_step
        for i, p in enumerate(self._params()):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            self.acc[i] = self.acc[i] + (g - self.acc[i]) / (n + 1)
        if n + 1 < self.every_k:
            self.mini_step = n + 1
            return
        for i, p in enumerate(self._params()):
            p.grad, self.acc[i] = self.acc[i], torch.zeros_like(p)
        self.inner.step()
        self.mini_step, self.gradient_step = 0, self.gradient_step + 1

    def state_dict(self):
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step, "gradient_step": self.gradient_step,
                "acc": list(self.acc)}

    def load_state_dict(self, state_dict) -> None:
        self.inner.load_state_dict(state_dict["inner"])
        self.mini_step, self.gradient_step = state_dict["mini_step"], state_dict["gradient_step"]
        self.acc = [saved.to(a.device, a.dtype) for a, saved in zip(self.acc, state_dict["acc"], strict=True)]


def build_optimizer(model: torch.nn.Module, ocfg: OptimizerConfig) -> AdamW:
    """Turn ``requires_grad`` on for the tuned modules and off for the
    frozen ones, and hand the tuned modules' parameters to ``AdamW``, one
    group each; the projector's peak is ``mm_projector_lr`` when set.

    ``model`` holds the modules under the port's names (``MODULES``): the
    whole ``SpatialRGPT``, or a holder of the trainable ones only (an
    ``nn.ModuleDict`` of ``mm_projector``, ``region_extractor`` and
    ``adapters``), as the reference builds its LoRA optimizer from the
    trainable tree alone."""
    tuned = {
        "llm": ocfg.tune_language_model,
        "vision": ocfg.tune_vision_tower,
        "projector": ocfg.tune_mm_projector,
        "region": ocfg.tune_region_extractor,
        "adapters": True,
    }
    groups = []
    for label, name in MODULES.items():
        module = getattr(model, name, None)
        if module is None:
            continue
        module.requires_grad_(tuned[label])
        if tuned[label]:
            peak = (ocfg.mm_projector_lr or ocfg.learning_rate) if label == "projector" else ocfg.learning_rate
            groups.append({"params": list(module.parameters()), "label": label, "peak_lr": peak})
    return AdamW(groups, ocfg)
