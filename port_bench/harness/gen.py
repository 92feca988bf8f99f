"""The one traffic generator: a traffic mix's parameters and a seed to the
inputs of a run.

`train_rows` makes an expanding-history training set on the device, in a
few large calls: users with a heavy-tailed number of events, Zipf-popular
items with a category each, times in the log's days, then every prefix
of a user's training events as a row whose target is the next event,
its history the last L events before it, with the reference iterator's
time features.  The same seed gives the same inputs.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

DAY_S = 86400


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed of its own for each named stream of a run."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF] + [
        ord(c) for c in stream]
    return int(np.random.SeedSequence(words).generate_state(
        2, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g


def zipf_cdf(n: int, exponent: float, device) -> torch.Tensor:
    """Cumulative probabilities of ranks 1..n under p(r) ~ r^-exponent."""
    r = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    c = torch.cumsum(r.pow(-exponent), 0)
    return c / c[-1]


def zipf_draw(cdf: torch.Tensor, count: int, g: torch.Generator
              ) -> torch.Tensor:
    """`count` ranks 1..n (int64)."""
    u = torch.rand(count, generator=g, device=cdf.device,
                   dtype=torch.float64)
    return torch.searchsorted(cdf, u).clamp_max(cdf.numel() - 1) + 1


def events_per_user(spec: dict, count: int, g: torch.Generator,
                    device) -> torch.Tensor:
    """Each user's number of events (int64)."""
    if spec["law"] != "lognormal":
        raise ValueError(f"unknown law {spec['law']}")
    sigma = spec["sigma"]
    mu = math.log(spec["mean"]) - sigma * sigma / 2
    z = torch.randn(count, generator=g, device=device, dtype=torch.float64)
    n = torch.exp(mu + sigma * z).round().long()
    return n.clamp(spec["min"], spec["max"])


def _event_log(mix: dict, tables: dict, n_users_drawn: int, seed: int,
               device):
    """Users' event counts, item and category ids and integer times of a
    log of `n_users_drawn` users, flat in user order."""
    g = generator(seed, "events", device)
    n_ev = events_per_user(mix["events_per_user"], n_users_drawn, g, device)
    users = torch.randperm(tables["n_users"] - 1, generator=g,
                           device=device)[:n_users_drawn] + 1
    total = int(n_ev.sum())
    item_cdf = zipf_cdf(tables["n_items"] - 1, mix["item_zipf"], device)
    items = zipf_draw(item_cdf, total, g)
    del item_cdf
    cate_of = zipf_draw(zipf_cdf(tables["n_cates"] - 1, mix["cate_zipf"],
                                 device), tables["n_items"], g)
    cate_of[0] = 0
    cates = cate_of[items]
    del cate_of
    # times: a span a user, events at exponential gaps across it
    log_s = mix["log_days"] * DAY_S
    span = (0.05 + 0.95 * torch.rand(n_users_drawn, generator=g,
                                     device=device, dtype=torch.float64)
            ) * log_s
    start = torch.rand(n_users_drawn, generator=g, device=device,
                       dtype=torch.float64) * (log_s - span)
    gaps = -torch.log1p(-torch.rand(total, generator=g, device=device,
                                    dtype=torch.float64))
    owner = torch.repeat_interleave(torch.arange(n_users_drawn,
                                                 device=device), n_ev)
    csum = torch.cumsum(gaps, 0)
    ends = torch.cumsum(n_ev, 0)
    begin = ends - n_ev
    before = torch.where(begin > 0, csum[(begin - 1).clamp_min(0)],
                         torch.zeros_like(span))
    tot = csum[ends - 1] - before
    frac = (csum - before[owner]) / tot[owner]
    times = torch.floor(start[owner] + frac * span[owner])
    return n_ev, users, items, cates, times, begin


def _features(times_hist, t_next, t_first, now, time_range):
    """The iterator's three time features, float64 in, float32 out."""
    f = lambda x: torch.log(torch.clamp(x / time_range, min=0.5)).float()
    return (f(t_next - times_hist), f(t_next - t_first),
            f(now[:, None] - times_hist))


def train_rows(mix: dict, tables: dict, L: int, time_range: float,
               seed: int, device, chunk: int = 500_000
               ) -> Dict[str, torch.Tensor]:
    """The resident training set: `mix['rows']` rows of (user, target
    item and category, label 1, clamped length, [N, L] histories and time
    features), every field on `device`."""
    n_rows = mix["rows"]
    held = mix["held_out_per_user"]
    mean_rows = mix["events_per_user"]["mean"] - held - 1
    n_users_drawn = min(tables["n_users"] - 1,
                        int(n_rows / max(mean_rows, 1) * 1.3) + 64)
    n_ev, users, items, cates, times, begin = _event_log(
        mix, tables, n_users_drawn, seed, device)
    per_user = (n_ev - held - 1).clamp_min(0)     # prefixes k = 1..n-held-1
    cum = torch.cumsum(per_user, 0)
    if int(cum[-1]) < n_rows:
        raise ValueError(f"the drawn users give {int(cum[-1])} rows, "
                         f"fewer than {n_rows}")
    row_user = torch.searchsorted(cum, torch.arange(n_rows, device=device),
                                  right=True)
    k = (torch.arange(n_rows, device=device)
         - (cum[row_user] - per_user[row_user]) + 1)   # history length
    out = {
        "users": users[row_user].int(),
        "items": items[begin[row_user] + k].int(),
        "cates": cates[begin[row_user] + k].int(),
        "labels": torch.ones(n_rows, dtype=torch.float32, device=device),
        "lengths": k.clamp_max(L).int(),
    }
    for name, dt in (("item_hist", torch.int32), ("cate_hist", torch.int32),
                     ("time_diff", torch.float32),
                     ("time_from_first", torch.float32),
                     ("time_to_now", torch.float32)):
        out[name] = torch.zeros(n_rows, L, dtype=dt, device=device)
    col = torch.arange(L, device=device)
    for lo in range(0, n_rows, chunk):
        hi = min(n_rows, lo + chunk)
        u, kk = row_user[lo:hi], k[lo:hi]
        n = kk.clamp_max(L)
        first = begin[u] + kk - n                     # first kept event
        idx = first[:, None] + col[None, :]
        keep = col[None, :] < n[:, None]
        idx = torch.where(keep, idx, first[:, None])
        target = begin[u] + kk
        nxt = torch.where(col[None, :] + 1 < n[:, None], idx + 1,
                          target[:, None])
        t_hist = times[idx]
        td, tf, tn = _features(t_hist, times[nxt], times[begin[u]][:, None],
                               times[target], time_range)
        z = lambda x: torch.where(keep, x, torch.zeros_like(x))
        out["item_hist"][lo:hi] = z(items[idx]).int()
        out["cate_hist"][lo:hi] = z(cates[idx]).int()
        out["time_diff"][lo:hi] = z(td)
        out["time_from_first"][lo:hi] = z(tf)
        out["time_to_now"][lo:hi] = z(tn)
    return out
