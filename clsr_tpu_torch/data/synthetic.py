"""Synthetic datasets in the reference's file format.

Counterpart of clsr_tpu/data/synthetic.py:55-150, 242-323: train/valid/
test TSVs and vocab pickles shaped like the reference ETL's output
(sequential_reviews.py:27-74): expanding-history train lines (label 1
only; the negatives are drawn in-batch at train time) and offline
popularity-sampled negatives for valid/test (1 positive followed by
`num_ngs` negative lines, each with the positive's user and history and
the negative item's own category, sequential_reviews.py:147-199).  For
the same arguments the files are byte-identical to the JAX package's: the
same RandomState draws in the same order, the same text.  The on-device
batch generator and the drift generator wait for ROADMAP queue 1 item 11.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from clsr_tpu_torch.data.vocab import Vocab


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
