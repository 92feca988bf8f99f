"""Synthetic datasets in the reference's file format.

Counterpart of clsr_tpu/data/synthetic.py: train/valid/test TSVs and
vocab pickles shaped like the reference ETL's output
(sequential_reviews.py:27-74): expanding-history train lines (label 1
only; the negatives are drawn in-batch at train time) and offline
popularity-sampled negatives for valid/test (1 positive followed by
`num_ngs` negative lines, each with the positive's user and history and
the negative item's own category, sequential_reviews.py:147-199).  For
the same arguments the files are byte-identical to the JAX package's: the
same RandomState draws in the same order, the same text.  That holds for
the drift generator too (`make_drift_events`, `write_drift_dataset`,
:152-241), which plants diverging long- and short-term interests.

`device_batch` (:24-52) draws a random Batch on the device from a
`torch.Generator`: JAX's shapes, dtypes, ranges and prefix masks, not
its numbers (jax.random's stream is not torch's).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch

from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.data.vocab import Vocab
from clsr_tpu_torch.utils.device import resolve_device


def device_batch(generator: torch.Generator, batch_rows: int, seq_len: int,
                 n_items: int, n_cates: int, n_users: int, G: int = 1,
                 device=None) -> Batch:
    """A random Batch on `device` (None: the card), drawn from
    `generator` (on that device): lengths in [1, L] with a prefix mask,
    users in [0, n_users), candidate and history ids in [1, n) (the
    history zero past its length), column 0 the positive, time features
    in [0, 1) on valid positions, every row valid.  As in JAX,
    time_to_now equals time_diff (JAX draws both from one key)."""
    dev = resolve_device(device)
    B, L = batch_rows, seq_len
    i32, f32 = torch.int32, torch.float32

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=generator,
                             device=dev, dtype=i32)

    def uniform(shape):
        return torch.rand(shape, generator=generator, device=dev,
                          dtype=f32)

    lengths = ri(1, L + 1, (B,))
    mask = (torch.arange(L, device=dev)[None, :] < lengths[:, None]).to(f32)
    labels = torch.zeros((B, G), dtype=f32, device=dev)
    labels[:, 0] = 1.0
    users = ri(0, n_users, (B,))
    items, cates = ri(1, n_items, (B, G)), ri(1, n_cates, (B, G))
    item_hist = (ri(1, n_items, (B, L)) * mask).to(i32)
    cate_hist = (ri(1, n_cates, (B, L)) * mask).to(i32)
    time_diff = uniform((B, L)) * mask
    time_from_first = uniform((B, L)) * mask
    return Batch(users=users, items=items, cates=cates, labels=labels,
                 item_hist=item_hist, cate_hist=cate_hist, mask=mask,
                 time_diff=time_diff, time_from_first=time_from_first,
                 time_to_now=time_diff.clone(),
                 valid=torch.ones((B,), dtype=f32, device=dev))


def write_synthetic_dataset_fast(out_dir: str, n_users: int = 5_000,
                                 n_items: int = 100_000,
                                 n_cates: int = 5_000,
                                 min_events: int = 10, max_events: int = 30,
                                 seed: int = 0,
                                 time_unit: str = "s") -> Dict[str, str]:
    """Benchmark-scale writer (train file + vocabs only): one popularity
    draw for every event, then string assembly per user; expanding
    histories, label-1 lines (sequential_reviews.py:441-520)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)

    pop = 1.0 / np.arange(1, n_items + 1) ** 0.8
    pop /= pop.sum()
    item2cate = rng.randint(1, n_cates + 1, size=n_items + 1)

    n_ev = rng.randint(min_events, max_events + 1, size=n_users)
    total = int(n_ev.sum())
    items_flat = rng.choice(n_items, size=total, p=pop) + 1
    t0 = 1_500_000_000
    span = 9 * 24 * 3600
    scale = 1000 if time_unit == "ms" else 1
    times_flat = t0 * scale + rng.randint(
        0, span * scale, size=total, dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(n_ev)])

    lines: List[str] = []
    for u in range(n_users):
        lo, hi = offsets[u], offsets[u + 1]
        items = items_flat[lo:hi]
        times = np.sort(times_flat[lo:hi])
        istr = [f"i{i}" for i in items]
        cstr = [f"c{item2cate[i]}" for i in items]
        tstr = [str(t) for t in times]
        ih, ch, th = istr[0], cstr[0], tstr[0]
        for k in range(1, hi - lo):
            lines.append(
                f"1\tu{u + 1}\t{istr[k]}\t{cstr[k]}\t{tstr[k]}\t"
                f"{ih}\t{ch}\t{th}")
            if k < hi - lo - 1:
                ih = ih + "," + istr[k]
                ch = ch + "," + cstr[k]
                th = th + "," + tstr[k]

    paths = {"train": os.path.join(out_dir, "train_data")}
    with open(paths["train"], "w") as f:
        f.write("\n".join(lines) + "\n")

    for name, size in [("user", n_users), ("item", n_items),
                       ("cate", n_cates)]:
        vocab = Vocab({f"default_{name}": 0,
                       **{f"{name[0]}{i}": i for i in range(1, size + 1)}})
        p = os.path.join(out_dir, f"{name}_vocab.pkl")
        vocab.save(p)
        paths[f"{name}_vocab"] = p
    return paths


def make_synthetic_events(n_users: int = 50, n_items: int = 200,
                          n_cates: int = 20, max_events: int = 30,
                          seed: int = 0, pref_strength: float = 0.8):
    """Per-user chronological event streams with Zipf-like item
    popularity.  Each user has two preferred categories; `pref_strength`
    of their events come from those categories' items, a signal a model
    can learn (the e2e checks ask for AUC > 0.5)."""
    rng = np.random.RandomState(seed)
    item_pop = 1.0 / np.arange(1, n_items + 1) ** 0.8
    item_pop /= item_pop.sum()
    item2cate = rng.randint(1, n_cates + 1, size=n_items)

    events = {}
    t0 = 1_500_000_000
    for u in range(1, n_users + 1):
        prefs = rng.choice(n_cates, size=2, replace=False) + 1
        in_pref = np.isin(item2cate, prefs)
        pref_p = item_pop * np.where(in_pref, 1.0, 0.0)
        pref_p = pref_p / pref_p.sum() if pref_p.sum() > 0 else item_pop
        n_ev = rng.randint(5, max_events + 1)
        from_pref = rng.rand(n_ev) < pref_strength
        items = np.where(
            from_pref,
            rng.choice(n_items, size=n_ev, p=pref_p),
            rng.choice(n_items, size=n_ev, p=item_pop),
        ) + 1
        times = np.sort(t0 + rng.randint(0, 9 * 24 * 3600, size=n_ev))
        events[u] = (items, times)
    return events, item2cate


def make_drift_events(n_users: int, n_items: int, n_cates: int,
                      min_events: int = 20, max_events: int = 40,
                      burst_len: int = 5, seed: int = 0,
                      alpha_low: float = 0.25, alpha_high: float = 0.75,
                      alpha_bimodal: bool = False):
    """Event streams with planted long- and short-term interests (JAX
    :152-219).  Each user has two stable long-term categories and a
    burst category, drawn from the others and redrawn every `burst_len`
    events; an event comes from the long-term ones with probability
    alpha_u (uniform in [alpha_low, alpha_high], or with alpha_bimodal
    one of the two by a coin flip), else from the burst.  Each category
    owns a contiguous block of items, Zipf-like inside it.

    Returns (events {u: (items, times)}, item2cate [n_items + 1] indexed
    by item id, alpha {u: alpha_u})."""
    rng = np.random.RandomState(seed)
    items_per_cate = n_items // n_cates
    item2cate = np.zeros(n_items + 1, dtype=np.int64)
    item2cate[1:] = np.repeat(np.arange(1, n_cates + 1), items_per_cate)[
        :n_items]
    within_pop = 1.0 / np.arange(1, items_per_cate + 1) ** 0.8
    within_pop /= within_pop.sum()

    def draw_item(cate):
        offset = (cate - 1) * items_per_cate
        return 1 + offset + rng.choice(items_per_cate, p=within_pop)

    events, alphas = {}, {}
    t0 = 1_500_000_000
    for u in range(1, n_users + 1):
        long_prefs = rng.choice(n_cates, size=2, replace=False) + 1
        others = np.setdiff1d(np.arange(1, n_cates + 1), long_prefs)
        if alpha_bimodal:
            alpha_u = alpha_high if rng.rand() < 0.5 else alpha_low
        else:
            alpha_u = alpha_low + (alpha_high - alpha_low) * rng.rand()
        n_ev = rng.randint(min_events, max_events + 1)
        burst = others[rng.randint(len(others))]
        items = np.empty(n_ev, dtype=np.int64)
        for e in range(n_ev):
            if e % burst_len == 0:
                burst = others[rng.randint(len(others))]
            if rng.rand() < alpha_u:
                cate = long_prefs[rng.randint(2)]
            else:
                cate = burst
            items[e] = draw_item(cate)
        times = np.sort(t0 + rng.randint(0, 9 * 24 * 3600, size=n_ev))
        events[u] = (items, times)
        alphas[u] = alpha_u
    return events, item2cate, alphas


def write_drift_dataset(out_dir: str, n_users: int = 1000,
                        n_items: int = 600, n_cates: int = 30,
                        valid_num_ngs: int = 4, test_num_ngs: int = 49,
                        seed: int = 0, **gen_kw) -> Dict[str, str]:
    """`write_synthetic_dataset` over `make_drift_events`, plus
    alphas.json, the planted alpha_u by user (JAX :222-241)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed + 1)
    events, item2cate, alphas = make_drift_events(
        n_users, n_items, n_cates, seed=seed, **gen_kw)
    paths = _emit_dataset(out_dir, events, item2cate[1:], n_users, n_items,
                          n_cates, valid_num_ngs, test_num_ngs, rng)
    alpha_path = os.path.join(out_dir, "alphas.json")
    with open(alpha_path, "w") as f:
        json.dump({str(u): a for u, a in alphas.items()}, f)
    paths["alphas"] = alpha_path
    return paths


def write_synthetic_dataset(out_dir: str, n_users: int = 50,
                            n_items: int = 200, n_cates: int = 20,
                            valid_num_ngs: int = 4, test_num_ngs: int = 9,
                            seed: int = 0) -> Dict[str, str]:
    """Write train/valid/test TSVs + vocab pickles; returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed + 1)
    events, item2cate = make_synthetic_events(n_users, n_items, n_cates,
                                              seed=seed)
    return _emit_dataset(out_dir, events, item2cate, n_users, n_items,
                         n_cates, valid_num_ngs, test_num_ngs, rng)


def _emit_dataset(out_dir, events, item2cate, n_users, n_items, n_cates,
                  valid_num_ngs, test_num_ngs, rng) -> Dict[str, str]:
    """The split, line and negatives writer (reference file layout).

    `item2cate[item - 1]` is an item's category.  Each (user, k) joins
    its history strings once and its 1 + num_ngs lines share them: the
    same text as a join per line."""

    user_vocab = Vocab({"default_user": 0,
                        **{f"u{u}": u for u in range(1, n_users + 1)}})
    item_vocab = Vocab({"default_item": 0,
                        **{f"i{i}": i for i in range(1, n_items + 1)}})
    cate_vocab = Vocab({"default_cate": 0,
                        **{f"c{c}": c for c in range(1, n_cates + 1)}})

    # popularity list for negative sampling (uniform over interactions ==
    # popularity-proportional, like _negative_sampling_offline)
    all_interactions: List[int] = []
    for items, _ in events.values():
        all_interactions.extend(items.tolist())
    all_interactions = np.asarray(all_interactions)

    train_lines, valid_lines, test_lines = [], [], []
    for u, (items, times) in events.items():
        n_ev = len(items)
        istr = [f"i{i}" for i in items]
        cstr = [f"c{item2cate[i - 1]}" for i in items]
        tstr = [str(t) for t in times]
        # last event -> test, second-to-last -> valid, rest -> train
        for k in range(1, n_ev):
            hist = (",".join(istr[:k]) + "\t" + ",".join(cstr[:k]) + "\t"
                    + ",".join(tstr[:k]))
            target, ts = int(items[k]), int(times[k])
            if k == n_ev - 1:
                dest, num_ngs = test_lines, test_num_ngs
            elif k == n_ev - 2:
                dest, num_ngs = valid_lines, valid_num_ngs
            else:
                dest, num_ngs = train_lines, 0
            dest.append(f"1\tu{u}\t{istr[k]}\t{cstr[k]}\t{ts}\t{hist}")
            for _ in range(num_ngs):
                neg = int(rng.choice(all_interactions))
                while neg == target:
                    neg = int(rng.choice(all_interactions))
                dest.append(f"0\tu{u}\ti{neg}\tc{item2cate[neg - 1]}\t"
                            f"{ts}\t{hist}")

    paths = {}
    for name, lines in [("train", train_lines), ("valid", valid_lines),
                        ("test", test_lines)]:
        p = os.path.join(out_dir, f"{name}_data")
        with open(p, "w") as f:
            f.write("\n".join(lines) + "\n")
        paths[name] = p
    for name, vocab in [("user", user_vocab), ("item", item_vocab),
                        ("cate", cate_vocab)]:
        p = os.path.join(out_dir, f"{name}_vocab.pkl")
        vocab.save(p)
        paths[f"{name}_vocab"] = p
    return paths
