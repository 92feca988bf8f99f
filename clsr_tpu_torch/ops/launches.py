"""The launch counters of the hand-written kernels, by kernel name.

Each wrapper adds one to its `.launches` where it launches its kernel.
The counters tick in Python, so a CUDA graph that captured a wrapper's
launch ticks it once at capture and never at replay; the graphed train
step (training/steps.py) adds its capture's counts after every replay.
"""

from __future__ import annotations

from typing import Callable, Dict

from clsr_tpu_torch.ops import fused_attention as fa
from clsr_tpu_torch.ops import fused_scan as fs
from clsr_tpu_torch.ops import fused_train_attention as fta
from clsr_tpu_torch.ops import row_update as ru


def kernel_counters() -> Dict[str, Callable]:
    """Every kernel's wrapper (its `.launches` counter), by kernel name."""
    return {"eval_scorer": fa.fused_eval_attention,
            "clsr_scan": fs.fused_scan,
            "clsr_scan_backward": fs.scan_backward,
            "train_stats0": fta.train_stats0,
            "train_stats1": fta.train_stats1,
            "row_scatter": ru.scatter_rows, "row_sweep": ru.sweep_rows}


def snapshot() -> Dict[str, int]:
    """Each kernel's launches so far."""
    return {n: c.launches for n, c in kernel_counters().items()}


def add(counts: Dict[str, int], times: int = 1) -> None:
    """Add `times` x `counts` to the counters."""
    ctrs = kernel_counters()
    for n, k in counts.items():
        ctrs[n].launches += k * times
