"""Profiling hooks.

Counterpart of clsr_tpu/utils/profiling.py: `trace(log_dir)` records a
`torch.profiler` trace of the CPU and, on the card, of the CUDA
activity, and writes it to `log_dir` as a Chrome trace (viewable in
Perfetto or chrome://tracing) where JAX writes a jax.profiler trace;
`StepTimer` times calls, waiting for the device before it reads the
clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile

from clsr_tpu_torch.utils.device import sync


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[Optional[profile]]:
    """`with trace(dir):` records a torch.profiler trace and writes
    `<dir>/trace_<pid>_<ns>.json` at the exit; with no dir, nothing."""
    if not log_dir:
        yield None
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        sync()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """A per-call timer that waits for the device after each call,
    discards `warmup` calls, and keeps the rest's seconds."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.times: List[float] = []
        self._calls = 0

    def __call__(self, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync()
        self._calls += 1
        if self._calls > self.warmup:
            self.times.append(time.perf_counter() - t0)
        return out

    @property
    def median(self) -> float:
        ts = sorted(self.times)
        return ts[len(ts) // 2] if ts else float("nan")

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")
