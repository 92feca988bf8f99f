"""TSV parsing and time-feature computation.

Counterpart of clsr_tpu/data/parser.py.  Line format (reference
sequential_iterator.py:90-103):

  label \t user \t item \t cate \t timestamp \t item_hist(,) \t cate_hist(,) \t ts_hist(,)

The time features reproduce sequential_iterator.py:119-150 verbatim,
including the `time_range` quirk: second timestamps are divided by
86.4 s, millisecond ones by one day.  All three features are floored at
0.5 before the natural log.  For a history t[0..n-1] and current time
`cur`:

  time_diff[i]       = log(max((t[i+1]-t[i])/range, .5)),  last: cur - t[n-1]
  time_from_first[i] = log(max((t[i+1]-t[0])/range, .5)),  last: cur - t[0]
  time_to_now[i]     = log(max((cur - t[i])/range, .5))

Parsed rows are packed (flat arrays + offsets), so an epoch shuffles an
index array.  The C++ parser (`clsr_tpu_torch.native`) takes the plain
TSV; the ablation options and other separators take the Python loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from clsr_tpu_torch.data.vocab import Vocab


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


@dataclasses.dataclass
class ParsedDataset:
    """Packed row storage: ragged histories as flat arrays + offsets."""

    labels: np.ndarray          # [N] float32
    users: np.ndarray           # [N] int32
    items: np.ndarray           # [N] int32
    cates: np.ndarray           # [N] int32
    times: np.ndarray           # [N] float64
    offsets: np.ndarray         # [N+1] int64 into the flat arrays
    hist_items: np.ndarray      # [total] int32
    hist_cates: np.ndarray      # [total] int32
    time_diff: np.ndarray       # [total] float32 (log-scaled)
    time_from_first: np.ndarray # [total] float32
    time_to_now: np.ndarray     # [total] float32

    def __len__(self) -> int:
        return len(self.labels)

    def seq_lengths(self) -> np.ndarray:
        return np.diff(self.offsets)


def _concat(parts, dtype) -> np.ndarray:
    return np.concatenate(parts) if parts else np.zeros(0, dtype)


def parse_file(path: str, user_vocab: Vocab, item_vocab: Vocab,
               cate_vocab: Vocab, time_unit: str = "s",
               col_sep: str = "\t", recent_k: Optional[int] = None,
               shuffle_seed: Optional[int] = None,
               use_native: bool = True) -> ParsedDataset:
    """Parse a train/valid/test TSV into a ParsedDataset.

    The C++ parser runs when `use_native` and the file is a plain TSV (no
    ablation); its build failing raises.  Ablation options, as the
    reference's iterator variants:
      * recent_k: keep only the last `recent_k` history events before the
        time features (RecentSASequentialIterator,
        sequential_iterator.py:735-763);
      * shuffle_seed: shuffle each line's item/cate history (not its
        times) by a permutation drawn per line from a RandomState seeded
        with (shuffle_seed * 1_000_003 + user id) % 2**31, as the JAX
        package draws it (ShuffleSASequentialIterator,
        sequential_iterator.py:766-793).
    """
    time_range = time_range_for_unit(time_unit)

    if (use_native and col_sep == "\t" and recent_k is None
            and shuffle_seed is None):
        from clsr_tpu_torch import native
        return ParsedDataset(*native.parse_file_native(
            path, user_vocab, item_vocab, cate_vocab, time_range))

    labels, users, items, cates, times = [], [], [], [], []
    offsets = [0]
    hist_items_parts, hist_cates_parts = [], []
    td_parts, tff_parts, ttn_parts = [], [], []

    ulook, ilook, clook = user_vocab.lookup, item_vocab.lookup, cate_vocab.lookup
    ilook_many, clook_many = item_vocab.lookup_many, cate_vocab.lookup_many

    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            cols = line.split(col_sep)
            labels.append(int(cols[0]))
            users.append(ulook(cols[1]))
            items.append(ilook(cols[2]))
            cates.append(clook(cols[3]))
            cur = float(cols[4])
            times.append(cur)

            hitems = ilook_many(cols[5].strip().split(","))
            hcates = clook_many(cols[6].strip().split(","))
            ts = np.array(cols[7].strip().split(","), dtype=np.float64)

            if recent_k is not None and len(hitems) > recent_k:
                hitems = hitems[-recent_k:]
                hcates = hcates[-recent_k:]
                ts = ts[-recent_k:]
            if shuffle_seed is not None:
                order = np.random.RandomState(
                    (shuffle_seed * 1_000_003 + users[-1]) % (2 ** 31)
                ).permutation(len(hitems))
                hitems = [hitems[i] for i in order]
                hcates = [hcates[i] for i in order]

            td, tff, ttn = compute_time_features(ts, cur, time_range)
            hist_items_parts.append(np.asarray(hitems, dtype=np.int32))
            hist_cates_parts.append(np.asarray(hcates, dtype=np.int32))
            td_parts.append(td)
            tff_parts.append(tff)
            ttn_parts.append(ttn)
            offsets.append(offsets[-1] + len(hitems))

    return ParsedDataset(
        labels=np.asarray(labels, dtype=np.float32),
        users=np.asarray(users, dtype=np.int32),
        items=np.asarray(items, dtype=np.int32),
        cates=np.asarray(cates, dtype=np.int32),
        times=np.asarray(times, dtype=np.float64),
        offsets=np.asarray(offsets, dtype=np.int64),
        hist_items=_concat(hist_items_parts, np.int32),
        hist_cates=_concat(hist_cates_parts, np.int32),
        time_diff=_concat(td_parts, np.float32),
        time_from_first=_concat(tff_parts, np.float32),
        time_to_now=_concat(ttn_parts, np.float32),
    )
