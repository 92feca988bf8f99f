"""A short traced sub-window, reduced in memory.

`profile_window(fn, calls, device)` runs `fn` once under a first,
discarded profile (the tracer's start-up falls there), then `calls`
times under `torch.profiler` (CPU and CUDA activity) inside a
`port_bench.window` range, waits for the card, and reduces the trace at
once, so no trace file is written.  The window runs from the first
device operation of the calls (not from the host's first launch after a
wait for the card, which the program, launching call after call, does
not wait) to the range's end.  The reduction gives the device's busy
seconds (the union of its operations' intervals inside the window), the
window's length, every kernel's count and seconds by name, the top
device operations, and the longest gaps between device operations, each
named by the innermost host range or call that covers its middle.  A
window with no device activity gives busy 0 and no kernels.
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, List

import torch

WINDOW = "port_bench.window"
TOP = 10
WARM_CALLS = 1      # calls of the discarded first profile


def _ns(e, which: str) -> int:
    f = getattr(e, f"{which}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{which}_us")() * 1000)


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _annotation(e) -> bool:
    f = getattr(e, "is_user_annotation", None)
    return bool(f()) if f is not None else e.name() == WINDOW


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def profile_window(fn: Callable[[], object], calls: int, device) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize(device)
    with profile(activities=acts):
        for _ in range(WARM_CALLS):
            fn()
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize(device)
    return reduce_events(prof.profiler.kineto_results.events())


def reduce_events(events) -> dict:
    host, dev = [], []
    w0 = w1 = None
    events = list(events)
    ranges = {e.name() for e in events
              if not _is_device(e) and _annotation(e)} | {WINDOW}
    for e in events:
        start = _ns(e, "start")
        end = start + int(e.duration_ns())
        if _is_device(e):
            if not _annotation(e) and e.name() not in ranges:
                dev.append((start, end, e.name(), _is_kernel(e.name())))
        else:
            if e.name() == WINDOW:
                w0, w1 = start, end
            host.append((start, end, e.name()))
    if w0 is None:
        raise RuntimeError("the traced window's range is missing")
    dev = sorted((max(s, w0), min(t, w1), n, k) for s, t, n, k in dev
                 if t > w0 and s < w1)
    if dev:
        w0 = dev[0][0]
    busy, cur_s, cur_e = 0, None, None
    gaps = []
    last_end = w0
    for s, t, _, _ in dev:
        if s > last_end:
            gaps.append((last_end, s))
        last_end = max(last_end, t)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s
    if w1 > last_end:
        gaps.append((last_end, w1))
    kernels: Dict[str, List[float]] = {}
    ops: Dict[str, float] = {}
    for s, t, n, is_kernel in dev:
        ops[n] = ops.get(n, 0.0) + (t - s) / 1e9
        if is_kernel:
            c = kernels.setdefault(n, [0, 0.0])
            c[0] += 1
            c[1] += (t - s) / 1e9
    host.sort()
    starts = [h[0] for h in host]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:TOP]:
        mid = (g0 + g1) // 2
        best = None
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            s, t, n = host[i]
            if t >= mid and n != WINDOW and (best is None
                                             or t - s < best[1] - best[0]):
                best = (s, t, n)
            if mid - s > 60e9:
                break
        named.append([best[2] if best else "idle", (g1 - g0) / 1e9])
    return dict(
        window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, kernels=kernels,
        n_kernels=sum(c[0] for c in kernels.values()),
        device_ops=sorted(([n, s] for n, s in ops.items()),
                          key=lambda x: -x[1])[:TOP],
        idle_gaps=named)
