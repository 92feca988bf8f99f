"""What decides `correct`: the program's readings against the plain
reference's, each number beside its limit (port_bench/limits/<cell>.json).

Training (the first three steps of the timed path):
  * loss_gap: the largest |program - reference| / |reference| of the
    three steps' losses;
  * grad_gap: the worst leaf's gap between the norms of the first clipped
    gradient, |n_p - n_r| / max(n_r, the median leaf's n_r);
  * grad_gap_median: the median over the leaves of that gap;
  * change_gap: the same of each leaf's norm of its change after three
    steps, over the leaves whose first reference gradient is at least a
    thousandth of the median leaf's (a leaf whose gradient is nought to
    rounding, as the bias of a layer under BN, moves under Adam by
    round-off alone).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

NOUGHT = 1e-3


@contextlib.contextmanager
def plain_precision(tf32: bool = False) -> Iterator[None]:
    """float32 matrix products as float32 (TF32 off), or TF32 for the
    control; the flags are restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep: Optional[List[str]] = None) -> float:
    names = keep if keep is not None else sorted(ref)
    med = float(np.median([ref[n] for n in names]))
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)


def moving_leaves(ref_first: Dict[str, float]) -> List[str]:
    med = float(np.median(list(ref_first.values())))
    return sorted(n for n, v in ref_first.items() if v >= NOUGHT * med)


def median_leaf(prog: Dict[str, float], ref: Dict[str, float],
                names: List[str]) -> float:
    """The median over `names` of each leaf's gap, as worst_leaf's."""
    med = float(np.median([ref[n] for n in names]))
    return float(np.median([abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
                            for n in names]))


def train_readings(r: dict) -> Dict[str, float]:
    loss_gap = max(abs(p - q) / max(abs(q), 1e-30)
                   for p, q in zip(r["losses"], r["ref_losses"]))
    moving = moving_leaves(r["ref_first"])
    return dict(
        loss_gap=loss_gap,
        grad_gap=worst_leaf(r["first"], r["ref_first"]),
        grad_gap_median=median_leaf(r["first"], r["ref_first"],
                                    sorted(r["ref_first"])),
        change_gap=worst_leaf(r["change"], r["ref_change"], moving),
        change_gap_median=median_leaf(r["change"], r["ref_change"],
                                      moving))


def judge(readings: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """Each number the cell's limits name, beside its limit (a number the
    run did not read is infinite, and fails); readings the limits do not
    name are not compared.  With no limits at all, every reading is shown
    with none, and the run is not correct."""
    if not limits:
        return {k: {"value": v, "limit": None} for k, v in readings.items()}
    return {k: {"value": readings.get(k, float("inf")), "limit": lim}
            for k, lim in limits.items()}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return bool(checks) and all(
        c["limit"] is not None and np.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values())
