"""Time features of a history, as the reference's iterator computes them.

Counterpart of clsr_tpu/data/parser.py:63-113 (which reproduces
sequential_iterator.py:119-150 verbatim, including the `time_range`
quirk: second timestamps are divided by 86.4 s, millisecond ones by one
day).  All three features are floored at 0.5 before the natural log.
For a history t[0..n-1] and current time `cur`:

  time_diff[i]       = log(max((t[i+1]-t[i])/range, .5)),  last: cur - t[n-1]
  time_from_first[i] = log(max((t[i+1]-t[0])/range, .5)),  last: cur - t[0]
  time_to_now[i]     = log(max((cur - t[i])/range, .5))

Serving needs nothing else of the parser; the TSV path waits for the
host-data slice.
"""

from __future__ import annotations

import numpy as np


def time_range_for_unit(time_unit: str) -> float:
    """The reference's normalizer (sequential_iterator.py:119-122)."""
    if time_unit == "ms":
        return 3600.0 * 24.0 * 1000.0
    return 3600.0 * 24.0 / 1000.0


def compute_time_features(ts_hist: np.ndarray, current_time: float,
                          time_range: float):
    """(time_diff, time_from_first, time_to_now), float32 [n] each."""
    t = np.asarray(ts_hist, dtype=np.float64)
    n = len(t)
    diff = np.empty(n, dtype=np.float64)
    if n > 1:
        diff[:-1] = (t[1:] - t[:-1]) / time_range
    diff[-1] = (current_time - t[-1]) / time_range
    time_diff = np.log(np.maximum(diff, 0.5))

    from_first = np.empty(n, dtype=np.float64)
    if n > 1:
        from_first[:-1] = (t[1:] - t[0]) / time_range
    from_first[-1] = (current_time - t[0]) / time_range
    time_from_first = np.log(np.maximum(from_first, 0.5))

    to_now = np.log(np.maximum((current_time - t) / time_range, 0.5))
    return (time_diff.astype(np.float32),
            time_from_first.astype(np.float32),
            to_now.astype(np.float32))
