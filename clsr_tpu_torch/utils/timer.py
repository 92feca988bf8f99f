"""Wall-clock timer context manager (clsr_tpu/utils/timer.py, after the
reference's common/timer.py:8-70)."""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self._start = None
        self._interval = 0.0
        self.running = False

    def start(self) -> "Timer":
        self._start = time.perf_counter()
        self.running = True
        return self

    def stop(self) -> "Timer":
        if not self.running:
            raise ValueError("Timer has not been started")
        self._interval += time.perf_counter() - self._start
        self.running = False
        return self

    @property
    def interval(self) -> float:
        if self.running:
            raise ValueError("Timer is still running")
        return self._interval

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def __str__(self) -> str:
        return f"{self.interval:0.4f}"
