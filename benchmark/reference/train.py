"""The align step in plain PyTorch: next-token cross entropy of the
composite over packed samples, its gradients to the trained modules, and
AdamW with a per-module clip by global norm and a warmup + cosine
schedule (optax's ``warmup_cosine_decay_schedule``).  It follows the
program's first steps on the same batches from the same start."""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from reference.model import Composite, pad_rows

IGNORE = -100


def learning_rate(s: dict, count: int) -> float:
    """The schedule at update ``count`` (0-based): linear warmup from 0 over
    int(warmup_ratio x total_steps) updates, then a cosine decay to 0."""
    warmup = int(s["warmup_ratio"] * s["total_steps"])
    if count < warmup:
        return s["lr"] * count / warmup
    decay = max(s["total_steps"], warmup + 1) - warmup
    return s["lr"] * 0.5 * (1 + math.cos(math.pi * min(count - warmup, decay) / decay))


def loss(model: Composite, batch: dict, remat: bool = True) -> torch.Tensor:
    """Mean of -log p(target) over every valid target of the batch's
    samples, each sample a sequence of its own (a packed row's samples see
    only themselves)."""
    img, mask_emb, depth_emb = model.encode(batch["images"], batch["depths"], batch["masks"])
    rows, targets = [], []
    for s in batch["samples"]:
        k = s["image"]
        rows.append(model.splice(s["ids"], img[k], mask_emb[k], depth_emb[k]))
        targets.append(s["labels"])
    x, pos, seg = pad_rows(rows)
    h = model.decode_stack(x, pos, seg, remat=remat)
    total, n = h.new_zeros(()), 0
    for b, labels in enumerate(targets):
        lab = torch.as_tensor(labels, device=h.device)
        tgt = lab[1:]
        valid = torch.nonzero(tgt != IGNORE).squeeze(1)
        lg = model.logits(h[b, valid])
        total = total + F.log_softmax(lg, dim=-1).gather(-1, tgt[valid][:, None]).sum()
        n += int(valid.numel())
    return -total / max(n, 1)


def groups_of(names) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    for n in names:
        out.setdefault(n.split(".")[0], []).append(n)
    return out


def follow(c: dict, W: Dict[str, torch.Tensor], trained_names: List[str], batches: List[dict], s: dict,
           lowp=None) -> dict:
    """The first ``len(batches)`` steps from the trained modules' tensors in
    ``W``: each step's loss, every trained leaf's first gradient as the
    optimizer takes it (clipped) and before the clip, and each leaf's
    change over the steps."""
    params = {n: W[n].detach().float().clone().requires_grad_(True) for n in trained_names}
    start = {n: p.detach().clone() for n, p in params.items()}
    model = Composite(c, W, lowp, trained=params)
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    groups = groups_of(trained_names)
    out = {"loss": [], "grad1": {}, "grad1_raw": {}}
    for count, batch in enumerate(batches):
        value = loss(model, batch, remat=s["remat"])
        grads = dict(zip(params, torch.autograd.grad(value, list(params.values()))))
        out["loss"].append(float(value.detach()))
        lr = learning_rate(s, count)
        with torch.no_grad():
            for names in groups.values():
                norm = torch.sqrt(sum(grads[n].square().sum() for n in names))
                scale = 1.0 if norm < s["max_grad_norm"] else float(s["max_grad_norm"] / norm)
                for n in names:
                    g = grads[n] * scale
                    if count == 0:
                        out["grad1"][n] = float(g.norm())
                        out["grad1_raw"][n] = float(grads[n].norm())
                    mu[n] = (1 - s["adam_b1"]) * g + s["adam_b1"] * mu[n]
                    nu[n] = (1 - s["adam_b2"]) * g * g + s["adam_b2"] * nu[n]
                    mu_hat = mu[n] / (1 - s["adam_b1"] ** (count + 1))
                    nu_hat = nu[n] / (1 - s["adam_b2"] ** (count + 1))
                    u = mu_hat / (nu_hat.sqrt() + s["adam_eps"]) + s["weight_decay"] * params[n]
                    params[n].sub_(lr * u)
        del grads, value
    out["change"] = {n: float((params[n].detach() - start[n]).norm()) for n in params}
    return out
