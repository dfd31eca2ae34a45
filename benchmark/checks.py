"""The numbers that decide ``correct``: the program's readings against the
plain reference's."""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

# a trained leaf whose reference gradient is below this share of the
# median leaf's is nought to rounding (it moves under Adam by round-off
# alone) and is left out of the gradient and change comparisons
NOUGHT_SHARE = 1e-3


def counted_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g >= NOUGHT_SHARE * med]


def norm_gap(prog: Dict[str, float], ref: Dict[str, float], leaves: Sequence[str]) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median
    leaf."""
    med = statistics.median(ref[n] for n in leaves)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in leaves)


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    """The worst step's relative gap between the losses."""
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def train_readings(prog: dict, ref: dict) -> Dict[str, float]:
    leaves = counted_leaves(ref["grad1_raw"])
    return {"loss_gap": loss_gap(prog["loss"], ref["loss"]),
            "grad_gap": norm_gap(prog["grad1"], ref["grad1"], leaves),
            "change_gap": norm_gap(prog["change"], ref["change"], leaves)}


def served_readings(gaps: Sequence[Sequence[float]]) -> Dict[str, float]:
    """Over every checked token: the widest gap below the reference's best
    logit, the mean gap, and the share of tokens that are not the
    reference's best.  A cell's limits name the ones it compares: the
    widest by default, the mean where near-ties make a sound run's widest
    swing past the control's (PERF.md)."""
    flat = [x for g in gaps for x in g]
    return {"served_gap": max(flat), "served_gap_mean": sum(flat) / len(flat),
            "served_off_best": sum(x > 0 for x in flat) / len(flat)}
