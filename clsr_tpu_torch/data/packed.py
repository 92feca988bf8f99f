"""Packed binary dataset format: the O(events) replacement for the
expanding-history TSV round trip.

Counterpart of clsr_tpu/data/packed.py, with its `.npz` keys and format
version, so a pack written by either package loads in the other.  The
reference writes every expanding-history prefix as text
(sequential_reviews.py:358-438): a user with E events writes O(E^2)
bytes, and the train-time iterator parses all of it again
(sequential_iterator.py:194-303).  A pack stores the information once:

  * the per-user EVENT STREAM: vocab-mapped int32 ids, float64
    timestamps and the user groups' offsets, in stream order;
  * per split, LINE RECORDS (group, k): "history = the group's first k
    events, target = event k", two int32s a line;
  * for valid/test, the offline negatives as [N, num_ngs] id and
    category arrays (sequential_reviews.py:147-199: popularity-
    proportional, unique a line, != the positive, the category
    substituted).

At load time `PackedView` builds the padded histories, the three
log-scaled time features (sequential_iterator.py:119-150, equal to the
TSV parse's) and the grouped eval targets; eval views present the
(1 + num_ngs)-row TSV layout through strided index adapters, without a
history copy a negative.

Against the TSV path for one seed: the kept lines are the same (the
subsample draws are the Python engine's RandomState stream:
RandomState.uniform(size=n) is n single uniform() calls); the vocabs are
bit-identical to `create_vocab` on the written train TSV, tie order
included; the negatives follow the same distribution from another draw
order (vectorised redraw rounds).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np

from clsr_tpu_torch.data.vocab import Vocab

PACKED_FILENAME = "packed.npz"
_FORMAT_VERSION = 1
_SPLITS = ("train", "valid", "test")


# =====================================================================
# container
# =====================================================================

@dataclasses.dataclass
class PackedSplit:
    line_group: np.ndarray            # [N] int32 — index into group_offsets
    line_k: np.ndarray                # [N] int32 — history length (target = k-th event)
    neg_item: Optional[np.ndarray] = None   # [N, ngs] int32 (mapped), eval only
    neg_cate: Optional[np.ndarray] = None   # [N, ngs] int32 (mapped)

    def __len__(self) -> int:
        return len(self.line_group)

    @property
    def num_ngs(self) -> int:
        return 0 if self.neg_item is None else self.neg_item.shape[1]


@dataclasses.dataclass
class PackedDataset:
    ev_user: np.ndarray       # [E] int32 vocab-mapped
    ev_item: np.ndarray       # [E] int32
    ev_cate: np.ndarray       # [E] int32
    ev_time: np.ndarray       # [E] float64 raw timestamps
    group_offsets: np.ndarray  # [n_groups+1] int64
    splits: Dict[str, PackedSplit]

    @property
    def n_events(self) -> int:
        return len(self.ev_user)

    def nbytes(self) -> int:
        total = sum(a.nbytes for a in (self.ev_user, self.ev_item,
                                       self.ev_cate, self.ev_time,
                                       self.group_offsets))
        for s in self.splits.values():
            total += s.line_group.nbytes + s.line_k.nbytes
            if s.neg_item is not None:
                total += s.neg_item.nbytes + s.neg_cate.nbytes
        return total

    # ------------------------------------------------------------- io
    def save(self, path: str) -> None:
        arrays = {
            "format_version": np.int64(_FORMAT_VERSION),
            "ev_user": self.ev_user, "ev_item": self.ev_item,
            "ev_cate": self.ev_cate, "ev_time": self.ev_time,
            "group_offsets": self.group_offsets,
        }
        for name, s in self.splits.items():
            arrays[f"{name}_line_group"] = s.line_group
            arrays[f"{name}_line_k"] = s.line_k
            if s.neg_item is not None:
                arrays[f"{name}_neg_item"] = s.neg_item
                arrays[f"{name}_neg_cate"] = s.neg_cate
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "wb") as f:
            np.savez(f, **arrays)


def load_packed(path: str) -> PackedDataset:
    with np.load(path) as z:
        version = int(z["format_version"])
        if version > _FORMAT_VERSION:
            raise ValueError(
                f"packed dataset {path} has format version {version}; "
                f"this build reads <= {_FORMAT_VERSION}")
        splits = {}
        for name in _SPLITS:
            key = f"{name}_line_group"
            if key not in z:
                continue
            splits[name] = PackedSplit(
                line_group=z[key], line_k=z[f"{name}_line_k"],
                neg_item=(z[f"{name}_neg_item"]
                          if f"{name}_neg_item" in z else None),
                neg_cate=(z[f"{name}_neg_cate"]
                          if f"{name}_neg_cate" in z else None))
        return PackedDataset(
            ev_user=z["ev_user"], ev_item=z["ev_item"],
            ev_cate=z["ev_cate"], ev_time=z["ev_time"],
            group_offsets=z["group_offsets"], splits=splits)


# =====================================================================
# generation (ETL side)
# =====================================================================

def _group_offsets_from_users(users: np.ndarray) -> np.ndarray:
    if len(users) == 0:
        return np.zeros(1, np.int64)
    starts = np.flatnonzero(
        np.concatenate([[True], users[1:] != users[:-1]]))
    return np.concatenate([starts, [len(users)]]).astype(np.int64)


def _vocab_index(vocab: Vocab, raw: np.ndarray) -> np.ndarray:
    """Map raw ids through a Vocab, OOV -> 0, vectorized via unique."""
    uniq, inverse = np.unique(raw, return_inverse=True)
    tokens = uniq.astype("U")
    get = vocab.mapping.get
    table = np.fromiter((get(t, 0) for t in tokens), np.int32, len(tokens))
    return table[inverse].astype(np.int32)


def _exact_vocabs(raw_user, raw_item, raw_cate, off, keep_train,
                  k_of_row, lo_of_row, hi_of_row
                  ) -> Tuple[Vocab, Vocab, Vocab]:
    """Vocabs BIT-IDENTICAL to create_vocab() run on the generated train
    TSV (sequential_reviews.py:77-144 semantics).

    count(token) = target + history occurrences over kept train lines.
    Tie order = first-seen order in the file scan (per line: target
    before history tokens; lines in file order), reproducing the
    stability of `sorted(counts.items(), key=count, reverse=True)` over
    a dict built in scan order.
    """
    E = len(raw_user)
    kt = keep_train
    cs = np.cumsum(kt)                       # kept-train lines up to row incl.
    cs_lo = np.where(lo_of_row > 0, cs[np.maximum(lo_of_row - 1, 0)], 0)
    cs_hi = cs[hi_of_row - 1]
    # occurrences of event row r in the train file:
    #   as history in every kept train line of the group with k > pos(r)
    #   (rows > r), plus as target when the row's own line is kept.
    hist_occ = cs_hi - cs                    # kept train lines at rows > r
    contrib = hist_occ + kt.astype(np.int64)

    # first-seen key: (global kept-train line index, within-line rank)
    # where rank 0 = target column, 1+pos = history position.
    idx = np.where(kt, np.arange(E), E)
    next_kt = np.minimum.accumulate(idx[::-1])[::-1]   # next kept row >= r
    has_line = next_kt < hi_of_row
    line_idx = np.where(has_line, cs[np.minimum(next_kt, E - 1)] - 1, 0)
    rank = np.where(next_kt == np.arange(E), 0, k_of_row + 1)
    BIG = np.int64(E + 2)
    key = line_idx.astype(np.int64) * BIG + rank.astype(np.int64)

    def build(raw, counts_per_row, keys_per_row, valid, default):
        uniq, inverse = np.unique(raw, return_inverse=True)
        counts = np.zeros(len(uniq), np.int64)
        np.add.at(counts, inverse, counts_per_row)
        first = np.full(len(uniq), np.iinfo(np.int64).max, np.int64)
        kv = np.where(valid, keys_per_row, np.iinfo(np.int64).max)
        np.minimum.at(first, inverse, kv)
        sel = counts > 0
        order = np.lexsort((first[sel], -counts[sel]))
        tokens = uniq[sel][order].astype("U")
        mapping = {default: 0}
        for i, t in enumerate(tokens):
            mapping[str(t)] = i + 1
        return Vocab(mapping)

    item_valid = (contrib > 0) & has_line
    item_vocab = build(raw_item, contrib, key, item_valid, "default_mid")
    cate_vocab = build(raw_cate, contrib, key, item_valid, "default_cat")

    # users: one occurrence per kept train line; first seen at the
    # group's first kept train line (user column precedes everything,
    # but users only compete with users — line index alone suffices).
    user_occ = np.zeros(E, np.int64)
    starts = lo_of_row == np.arange(E)       # group-start rows
    user_occ[starts] = (cs_hi - cs_lo)[starts]
    first_line_row = np.minimum(next_kt, E - 1)
    user_key = np.where(has_line, cs[first_line_row].astype(np.int64) - 1,
                        np.iinfo(np.int64).max)
    user_valid = starts & (user_occ > 0) & has_line
    user_vocab = build(raw_user, user_occ, user_key, user_valid,
                       "default_uid")
    return user_vocab, item_vocab, cate_vocab


def _sample_negatives(rng: np.random.RandomState, pos_raw: np.ndarray,
                      pool_raw: np.ndarray, num_ngs: int,
                      max_rounds: int = 200) -> np.ndarray:
    """[N, num_ngs] popularity-proportional negatives, unique per line,
    != positive (sequential_reviews.py:147-199 distribution; vectorized
    redraw rounds instead of the per-line rejection loop)."""
    N = len(pos_raw)
    if N == 0:
        return np.zeros((0, num_ngs), pool_raw.dtype)
    if len(np.unique(pool_raw)) <= num_ngs:
        raise ValueError(
            f"cannot sample {num_ngs} unique negatives from a pool with "
            f"{len(np.unique(pool_raw))} distinct items")
    neg = pool_raw[rng.randint(0, len(pool_raw), size=(N, num_ngs))]
    for _ in range(max_rounds):
        bad = neg == pos_raw[:, None]
        order = np.argsort(neg, axis=1, kind="stable")
        srt = np.take_along_axis(neg, order, axis=1)
        dup_sorted = np.zeros_like(bad)
        dup_sorted[:, 1:] = srt[:, 1:] == srt[:, :-1]
        dup = np.zeros_like(bad)
        np.put_along_axis(dup, order, dup_sorted, axis=1)
        bad |= dup
        n_bad = int(bad.sum())
        if n_bad == 0:
            return neg
        neg[bad] = pool_raw[rng.randint(0, len(pool_raw), size=n_bad)]
    raise RuntimeError("negative sampling failed to converge")


def build_packed(instances, splits, subsample: Dict[str, float],
                 min_sequence: int = 1,
                 rng: Optional[np.random.RandomState] = None,
                 valid_num_ngs: int = 4, test_num_ngs: int = 49,
                 vocabs: Optional[Tuple[Vocab, Vocab, Vocab]] = None
                 ) -> Tuple[PackedDataset, Tuple[Vocab, Vocab, Vocab]]:
    """instances (user_id,item_id,cate_id,timestamp sorted by (uid,ts))
    + per-row split names -> (PackedDataset, (user,item,cate) vocabs).

    The kept-line set replays generate_expanding's rng stream exactly
    (one uniform per candidate line whose split has frac < 1, in stream
    order).  When `vocabs` is None they are computed here, bit-identical
    to create_vocab on the equivalent TSV.
    """
    rng = rng or np.random.RandomState()
    raw_user = np.asarray(instances["user_id"])
    raw_item = np.asarray(instances["item_id"])
    raw_cate = np.asarray(instances["cate_id"])
    raw_time = np.asarray(instances["timestamp"]).astype(np.float64)
    split_names = np.asarray(splits)

    off = _group_offsets_from_users(raw_user)
    glen = np.diff(off)
    E = len(raw_user)
    lo_of_row = np.repeat(off[:-1], glen)
    hi_of_row = np.repeat(off[1:], glen)
    grp_of_row = np.repeat(np.arange(len(glen)), glen)
    k_of_row = np.arange(E) - lo_of_row

    split_code = np.full(E, -1, np.int8)
    for c, name in enumerate(_SPLITS):
        split_code[split_names == name] = c
    frac = np.asarray([subsample.get(s, 1.0) for s in _SPLITS],
                      np.float64)[np.maximum(split_code, 0)]

    cand = k_of_row >= 1
    needs_draw = cand & (frac < 1.0)
    draw_vals = np.ones(E)
    n_draws = int(needs_draw.sum())
    if n_draws:
        # same MT19937 stream as n sequential rng.uniform() calls
        draw_vals[needs_draw] = rng.uniform(size=n_draws)
    keep = cand & (k_of_row >= min_sequence) & \
        (~needs_draw | (draw_vals < frac))

    if vocabs is None:
        keep_train = keep & (split_code == 0)
        vocabs = _exact_vocabs(raw_user, raw_item, raw_cate, off,
                               keep_train, k_of_row, lo_of_row, hi_of_row)
    uv, iv, cv = vocabs

    pack = PackedDataset(
        ev_user=_vocab_index(uv, raw_user),
        ev_item=_vocab_index(iv, raw_item),
        ev_cate=_vocab_index(cv, raw_cate),
        ev_time=raw_time,
        group_offsets=off,
        splits={})

    # negatives: pool + item->cate map over the FULL instance stream
    # (negative_sampling_offline uses `instances`, keep-last cate like
    # dict(zip(...)) — sequential_reviews.py:430-432)
    uniq_items, inverse = np.unique(raw_item, return_inverse=True)
    last_cate_raw = np.empty(len(uniq_items), raw_cate.dtype)
    last_cate_raw[inverse] = raw_cate        # later rows overwrite
    cate_of_raw_mapped = _vocab_index(cv, last_cate_raw)

    ngs_by_split = {"valid": valid_num_ngs, "test": test_num_ngs}
    for c, name in enumerate(_SPLITS):
        rows = np.flatnonzero(keep & (split_code == c))
        s = PackedSplit(line_group=grp_of_row[rows].astype(np.int32),
                        line_k=k_of_row[rows].astype(np.int32))
        if name in ngs_by_split and len(rows):
            neg_raw = _sample_negatives(rng, raw_item[rows], raw_item,
                                        ngs_by_split[name])
            flat = neg_raw.reshape(-1)
            pos_in_uniq = np.searchsorted(uniq_items, flat)
            s.neg_item = _vocab_index(iv, flat).reshape(neg_raw.shape)
            s.neg_cate = cate_of_raw_mapped[pos_in_uniq] \
                .reshape(neg_raw.shape).astype(np.int32)
        pack.splits[name] = s
    return pack, vocabs


# =====================================================================
# load-time views (loader side)
# =====================================================================

class _StridedRows:
    """arr[idx] -> base[idx // G]: presents per-LINE data as the TSV's
    per-ROW layout ((1+ngs) file rows share one line's history)."""

    def __init__(self, base: np.ndarray, group: int, n_rows: int):
        self._base = base
        self._g = group
        self._n = n_rows
        self.shape = (n_rows,) + base.shape[1:]
        self.dtype = base.dtype

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx):
        return self._base[np.asarray(idx) // self._g]


class _StridedTargets:
    """arr[idx] -> base[idx // G, idx % G]: per-row targets from the
    [N_lines, G] packed target matrix (row order = file order: positive
    then its negatives)."""

    def __init__(self, base: np.ndarray, group: int):
        self._base = base
        self._g = group
        self.shape = (base.shape[0] * group,)
        self.dtype = base.dtype

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, idx):
        idx = np.asarray(idx)
        return self._base[idx // self._g, idx % self._g]


class PackedView:
    """PaddedView-compatible arrays built straight from a PackedDataset
    (no TSV, no ParsedDataset intermediate).

    For eval splits with packed negatives, per-row accessors present the
    (1+ngs)-rows-per-line TSV layout through strided adapters; histories
    and time features are materialized ONCE per line.
    """

    def __init__(self, pack: PackedDataset, split: str,
                 max_seq_length: int, time_range: float,
                 recent_k: Optional[int] = None):
        s = pack.splits[split]
        off = pack.group_offsets
        L = max_seq_length
        N = len(s)
        g = s.line_group.astype(np.int64)
        k = s.line_k.astype(np.int64)
        lo = off[g]
        tgt = lo + k
        eff_lo = lo if recent_k is None else np.maximum(lo, tgt - recent_k)
        hist_len = tgt - eff_lo
        tl = np.minimum(hist_len, L)

        item_hist = np.zeros((N, L), np.int32)
        cate_hist = np.zeros((N, L), np.int32)
        td = np.zeros((N, L), np.float32)
        tff = np.zeros((N, L), np.float32)
        ttn = np.zeros((N, L), np.float32)
        mask = np.zeros((N, L), np.float32)

        total = int(tl.sum())
        if total:
            rows = np.repeat(np.arange(N), tl)
            excl = np.concatenate([[0], np.cumsum(tl)[:-1]])
            pos = np.arange(total) - np.repeat(excl, tl)
            flat = np.repeat(tgt - tl, tl) + pos       # event rows used
            t = pack.ev_time
            cur = np.repeat(t[tgt], tl)
            t0 = np.repeat(t[eff_lo], tl)
            t_here = t[flat]
            # t[i+1] with the "current time" standing in at the last
            # position — covers both time_diff's and time_from_first's
            # final entries (sequential_iterator.py:124-143)
            t_next = np.where(flat + 1 == np.repeat(tgt, tl),
                              cur, t[np.minimum(flat + 1, pack.n_events - 1)])
            item_hist[rows, pos] = pack.ev_item[flat]
            cate_hist[rows, pos] = pack.ev_cate[flat]
            td[rows, pos] = np.log(
                np.maximum((t_next - t_here) / time_range, 0.5)
            ).astype(np.float32)
            tff[rows, pos] = np.log(
                np.maximum((t_next - t0) / time_range, 0.5)
            ).astype(np.float32)
            ttn[rows, pos] = np.log(
                np.maximum((cur - t_here) / time_range, 0.5)
            ).astype(np.float32)
            mask[rows, pos] = 1.0

        base_users = pack.ev_user[lo]
        base_lengths = hist_len
        pos_item = pack.ev_item[tgt]
        pos_cate = pack.ev_cate[tgt]

        if s.neg_item is not None:
            G = 1 + s.num_ngs
            tgt_item = np.concatenate([pos_item[:, None], s.neg_item], 1)
            tgt_cate = np.concatenate([pos_cate[:, None], s.neg_cate], 1)
            tgt_label = np.zeros((N, G), np.float32)
            tgt_label[:, 0] = 1.0
            n_rows = N * G
            self.users = _StridedRows(base_users, G, n_rows)
            self.lengths = _StridedRows(base_lengths, G, n_rows)
            self.items = _StridedTargets(tgt_item, G)
            self.cates = _StridedTargets(tgt_cate, G)
            self.labels = _StridedTargets(tgt_label, G)
            self.item_hist = _StridedRows(item_hist, G, n_rows)
            self.cate_hist = _StridedRows(cate_hist, G, n_rows)
            self.mask = _StridedRows(mask, G, n_rows)
            self.time_diff = _StridedRows(td, G, n_rows)
            self.time_from_first = _StridedRows(tff, G, n_rows)
            self.time_to_now = _StridedRows(ttn, G, n_rows)
            self.n_rows = n_rows
            self.group = G
        else:
            self.users = base_users
            self.lengths = base_lengths
            self.items = pos_item
            self.cates = pos_cate
            self.labels = np.ones(N, np.float32)
            self.item_hist = item_hist
            self.cate_hist = cate_hist
            self.mask = mask
            self.time_diff = td
            self.time_from_first = tff
            self.time_to_now = ttn
            self.n_rows = N
            self.group = 1


class _PackedLen:
    """len() shim standing in for SequenceLoader.ds."""

    def __init__(self, n: int):
        self._n = n

    def __len__(self) -> int:
        return self._n


def make_loader(pack: PackedDataset, split: str, max_seq_length: int,
                time_range: float, recent_k: Optional[int] = None,
                min_batch_rows: int = 5):
    """A SequenceLoader over a packed split (train or eval)."""
    from clsr_tpu_torch.data.loader import SequenceLoader

    view = PackedView(pack, split, max_seq_length, time_range, recent_k)
    return SequenceLoader(_PackedLen(view.n_rows), max_seq_length,
                          min_batch_rows=min_batch_rows, view=view)


def build_interaction_graph_packed(pack: PackedDataset, n_users: int,
                                   n_items: int):
    """InteractionGraph (data/graph.py) of a packed train split: each
    user's LAST train line, i.e. their whole train history and its
    target (graph.py semantics)."""
    from clsr_tpu_torch.data.graph import build_graph_from_arrays

    s = pack.splits["train"]
    off = pack.group_offsets
    g = s.line_group.astype(np.int64)
    k = s.line_k.astype(np.int64)
    # last train line a group (lines are in k order within a group)
    last = np.zeros(len(off) - 1, np.int64) - 1
    last[g] = np.arange(len(g))              # later lines overwrite
    sel = last[last >= 0]
    lo = off[g[sel]]
    n = k[sel] + 1                           # history + target
    rows = np.repeat(lo - np.concatenate([[0], np.cumsum(n)[:-1]]), n) \
        + np.arange(int(n.sum()))
    return build_graph_from_arrays(
        pack.ev_user[lo], np.concatenate([[0], np.cumsum(n)]),
        pack.ev_item[rows], pack.ev_cate[rows], n_users, n_items)
