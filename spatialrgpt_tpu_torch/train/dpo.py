"""Direct Preference Optimization (port of ``spatialrgpt_tpu/train/dpo.py``):
sigmoid DPO over (chosen, rejected) pairs against a frozen reference copy of
the model, the policy's multimodal forward reused as it is.

- ``sequence_logprob`` is ``models/vlm.py::sequence_logprob`` (the lse form
  of the reference's log-softmax over ``forward``'s logits).
- ``reference_copy`` is the frozen copy that ``train/train.py`` makes before
  the first step (the reference copies the whole tree, ``train.py:215-220``):
  the parameters the optimizer holds are cloned, and every other tensor is
  shared with the policy, since nothing can change it.
- ``make_dpo_step``'s gradients reach only the optimizer's parameters (the
  tune flags), the port's ``requires_grad`` idiom for the reference's
  ``set_to_zero`` groups; the reference copy runs under ``no_grad``.
  ``DPOState`` is a ``Trainer`` state: a resumed run restores the policy and
  the optimizer from the checkpoint and keeps the live reference copy, which
  ``main`` rebuilds from the starting weights as the reference does.
- Under a process group of several ranks (an FSDP-sharded model, whose
  reference copy is sharded the same way by ``train/step.py::
  shard_state``), both models run as module calls, the loss and the
  metrics are means over the global rows (a rank's rows are its share of
  the sum; sp ranks hold the same rows), and the replicated parameters'
  gradients are summed.
"""

from __future__ import annotations

import copy
import itertools
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from spatialrgpt_tpu_torch.config import SpatialRGPTConfig
from spatialrgpt_tpu_torch.models import vlm
from spatialrgpt_tpu_torch.models.vlm import sequence_logprob
from spatialrgpt_tpu_torch.parallel import mesh as mesh_lib
from spatialrgpt_tpu_torch.parallel.context import SP_IMPLS, sp_context
from spatialrgpt_tpu_torch.train.step import _freeze_untrained, _trained

__all__ = ["DPOState", "dpo_loss", "make_dpo_step", "reference_copy", "sequence_logprob"]


def dpo_loss(
    policy: vlm.SpatialRGPT,
    ref: vlm.SpatialRGPT,
    cfg: SpatialRGPTConfig,
    chosen: vlm.VLMInputs,
    rejected: vlm.VLMInputs,
    beta: float = 0.1,
    attn_impl: str = "xla",
    remat: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """sigmoid DPO: -log sigma(beta [(pi_c - pi_r) - (ref_c - ref_r)])."""
    pol_c = policy(sequence_logprob, cfg, chosen, attn_impl, remat)
    pol_r = policy(sequence_logprob, cfg, rejected, attn_impl, remat)
    with torch.no_grad():
        ref_c = ref(sequence_logprob, cfg, chosen, attn_impl)
        ref_r = ref(sequence_logprob, cfg, rejected, attn_impl)
    logits = beta * ((pol_c - pol_r) - (ref_c - ref_r))
    mean, metric = _row_means(attn_impl)
    loss = mean(-F.logsigmoid(logits))
    return loss, {
        "dpo_loss": metric(loss),
        "reward_accuracy": metric(mean((logits > 0).float())),
        "chosen_reward": metric(mean(beta * (pol_c - ref_c))),
        "rejected_reward": metric(mean(beta * (pol_r - ref_r))),
    }


def _row_means(attn_impl: str):
    """(mean, metric): on one process the mean over the rows and the value
    itself.  In a process group ``mean`` is the rank's share of the mean
    over the global rows (its rows' sum over their global count: the sp
    ranks of a group hold the same rows and, through ``sp_sum``, each the
    whole row's gradient of its own chunk), and ``metric`` adds the shares
    of the ranks, each row once."""
    if mesh_lib.world_size() == 1:
        return (lambda x: x.mean()), (lambda x: x.detach())
    sp = sp_context(attn_impl).sp_degree if attn_impl in SP_IMPLS else 1

    def mean(x):
        return x.sum() / (mesh_lib.world_sum(torch.tensor(float(x.shape[0]), device=x.device)) / sp)

    return mean, lambda x: mesh_lib.world_sum(x.detach()) / sp


class DPOState(NamedTuple):
    step: int
    model: vlm.SpatialRGPT
    ref_model: vlm.SpatialRGPT
    optimizer: object


@torch.no_grad()
def reference_copy(model: vlm.SpatialRGPT, optimizer) -> vlm.SpatialRGPT:
    """A frozen copy of ``model``: its own clones of the optimizer's
    parameters, every other parameter and buffer shared."""
    trained = _trained(optimizer)
    shared = {id(t): t for t in itertools.chain(model.parameters(), model.buffers()) if id(t) not in trained}
    ref = copy.deepcopy(model, dict(shared))
    for p in ref.parameters():
        if id(p) not in shared:
            p.requires_grad_(False)
    return ref


def make_dpo_step(cfg: SpatialRGPTConfig, optimizer, beta: float = 0.1, attn_impl: str = "xla",
                  remat: bool = False):
    """``step(state, chosen, rejected) -> (state, metrics)``: the DPO loss's
    gradients and one optimizer call.  ``remat`` checkpoints the policy's
    decoder layers (the reference does not; the values are the same)."""

    def step(state: DPOState, chosen: vlm.VLMInputs, rejected: vlm.VLMInputs):
        model = state.model
        _freeze_untrained(model, optimizer)
        model.zero_grad(set_to_none=True)
        loss, metrics = dpo_loss(model, state.ref_model, cfg, chosen, rejected, beta, attn_impl, remat)
        loss.backward()
        mesh_lib.sync_replicated_grads(model)
        optimizer.step()
        return state._replace(step=state.step + 1), {k: v.detach() for k, v in metrics.items()}

    return step
