"""Offline ETL: raw interaction logs -> train/valid/test TSVs (or the
packed format) + vocabs.

Counterpart of clsr_tpu/data/etl.py (itself after the reference's
reco_utils/dataset/sequential_reviews.py:27-1041), over plain dicts of
numpy columns instead of pandas DataFrames: the port runs where pandas is
not installed.  The semantics of every pandas step are kept, so the same
raw file and seed give the same files byte for byte:

  * `read_csv` (pd.read_csv): the C++ column reader of native/ (int64
    columns, and string columns interned), Python's csv module for a file
    it does not take (quoted fields, ragged rows); a column that is not
    all integers is inferred as pandas does it: int64, else float64 (its
    NA strings NaN), else strings;
  * drop_duplicates keeps each key's first row, in file order; a
    column's distinct values are listed in first-seen order;
  * `downsample`: Series.sample(frac=frac, random_state=rng) is
    rng.choice(n, size=round(frac * n), replace=False) over the values in
    first-seen order (pandas 3.0.3 generic.py `sample`, core/sample.py),
    so the RandomState is left where pandas leaves it;
  * groupby(...).count() counts the non-null values of the counted
    column; sort_values(["uid", "ts"], kind="stable") is a stable
    lexsort;
  * the date clamp is datetime(2017, 11, 25).timestamp(): local time;
  * the rejection loops of `get_sampled_data` and
    `negative_sampling_offline` draw rng.randint(n) in chunks
    (rng.randint(n, size=m) is the stream of m single draws) and rewind
    the generator to just past the last draw used, so every later draw
    is the sequential loop's.

  data_preprocessing (sequential_reviews.py:27-74):
    1. taobao_main (:955-982): 'pv' rows, dedup (uid, iid), drop items
       with more than one category (:936-943), clamp to 2017-11-25 ..
       2017-12-03, keep 5% of users (:946-952), 10-core on items then
       users (:815-828); kuaishou_main (:999-1041): the renamed columns,
       dedup, 10-core on items, 10-core on users counting positive rows,
       positives kept;
    2. create_instances (:592-630): each user's rows in time order with
       the item's category;
    3. get_sampled_data (:537-556): optional popularity-proportional
       item subsample;
    4. split_global_time: test = the last interval, valid = the one
       before (taobao 24 h in s, :705-735; kuaishou 12 h in ms, :672-702);
    5. the expanding-history lines (:358-438), valid/test kept at 20%
       (taobao) or all splits at 10% (kuaishou, :275-355), by a Python
       loop, by worker processes or by C++ (`engine="native"`); or the
       packed format (data/packed.py);
    6. create_vocab (:77-144): frequency-sorted, id 0 the default;
    7. negative_sampling_offline (:147-199): num_ngs negatives a valid
       and test line, drawn from the instance stream (popularity-
       proportional), unique a line, != the positive.
"""

from __future__ import annotations

import collections
import csv
import logging
import os
import time
from datetime import datetime
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from clsr_tpu_torch.data.vocab import Vocab

logger = logging.getLogger(__name__)

Columns = Dict[str, np.ndarray]
_SPLITS = ("train", "valid", "test")
# pd.read_csv's default NA strings (pandas/_libs/parsers.pyx
# STR_NA_VALUES)
_NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_DRAW_CHUNK = 1 << 16     # rng.randint draws taken at a time


# ------------------------------------------------------------ columns

def _take(cols: Columns, sel) -> Columns:
    """The rows `sel` (a mask or indices) of every column."""
    return {k: v[sel] for k, v in cols.items()}


def _notnull(a: np.ndarray) -> np.ndarray:
    if a.dtype.kind == "f":
        return ~np.isnan(a)
    if a.dtype.kind == "O":
        return np.array([not (x is None or (isinstance(x, float)
                                            and x != x)) for x in a], bool)
    return np.ones(len(a), bool)


def _codes(a: np.ndarray) -> Tuple[np.ndarray, int]:
    """(a code a row, number of distinct values): equal values share a
    code, codes ascend with the values.  Integers of a range within a few
    times the row count take a table, anything else a sort (not
    np.unique, which hashes large int64 arrays slowly in some numpy
    releases)."""
    n = len(a)
    if n == 0:
        return np.zeros(0, np.int64), 0
    if a.dtype.kind in "iu":
        lo, hi = int(a.min()), int(a.max())
        if hi - lo < max(4 * n, 1 << 22):
            present = np.zeros(hi - lo + 1, bool)
            at = a - lo
            present[at] = True
            return (np.cumsum(present) - 1)[at], int(present.sum())
    order = np.argsort(a)
    srt = a[order]
    new = np.ones(n, bool)
    new[1:] = srt[1:] != srt[:-1]
    inv = np.empty(n, np.int64)
    inv[order] = np.cumsum(new) - 1
    return inv, int(new.sum())


def _key(*arrays: np.ndarray) -> Tuple[np.ndarray, int]:
    """One code a row for the tuple of `arrays`' values, and the number
    of distinct tuples."""
    key, m = _codes(arrays[0])
    for a in arrays[1:]:
        code, n = _codes(a)
        key, m = _codes(key * n + code)
    return key, m


def _first_rows(*arrays: np.ndarray) -> np.ndarray:
    """Mask of each distinct tuple's first row (drop_duplicates)."""
    key, m = _key(*arrays)
    n = len(key)
    first = np.zeros(n, bool)
    if n:
        # a fancy assignment keeps the last write of an index: written in
        # reverse, each code keeps its first row
        at = np.empty(m, np.int64)
        at[key[::-1]] = np.arange(n - 1, -1, -1)
        first[at] = True
    return first


def _isin(a: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Series.isin: rows of `a` whose value is among `values`."""
    if len(values) == 0 or len(a) == 0:
        return np.zeros(len(a), bool)
    both, _ = _codes(np.concatenate([a, values]))
    hit = np.zeros(int(both.max()) + 1, bool)
    hit[both[len(a):]] = True
    return hit[both[:len(a)]]


# --------------------------------------------------------------- read

def _infer(strings: List[str], codes: np.ndarray) -> np.ndarray:
    """A column read as strings, typed as pd.read_csv types it: int64
    when every value is an integer, float64 when every value is a number
    or an NA string (NaN), else the strings (NA strings as NaN in an
    object column)."""
    try:
        return np.asarray([int(s) for s in strings], np.int64)[codes]
    except (ValueError, OverflowError):
        pass
    try:
        return np.asarray([np.nan if s in _NA_STRINGS else float(s)
                           for s in strings], np.float64)[codes]
    except ValueError:
        pass
    if any(s in _NA_STRINGS for s in strings):
        return np.asarray([np.nan if s in _NA_STRINGS else s
                           for s in strings], object)[codes]
    return np.asarray(strings)[codes]


def _read_csv_python(path: str, names: List[str], use: List[str],
                     skip: int) -> Columns:
    """The csv module's reading of what the C++ reader does not take."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f)][skip:]
    rows = [r for r in rows if r and r != [""]]
    for i, r in enumerate(rows):
        if len(r) != len(names):
            raise ValueError(f"{path}: row {i + skip + 1} has {len(r)} "
                             f"fields, expected {len(names)}")
    out = {}
    for name in use:
        c = names.index(name)
        vals = [r[c] for r in rows]
        index: Dict[str, int] = {}
        codes = np.asarray([index.setdefault(v, len(index)) for v in vals],
                           np.int64)
        out[name] = _infer(list(index), codes)
    return out


def read_csv(path: str, names: Optional[Sequence[str]] = None,
             usecols: Optional[Sequence[str]] = None,
             strings: Sequence[str] = ()) -> Columns:
    """The columns `usecols` (all by default) of a CSV file, as
    pd.read_csv(path, header=None, names=names) reads them, or
    pd.read_csv(path, header=0) when `names` is None (the names from the
    first line).  `strings` names columns known to hold text, read as
    strings at once."""
    skip = 0
    if names is None:
        with open(path, newline="") as f:
            names = next(csv.reader(f))
        skip = 1
    names = list(names)
    use = list(usecols) if usecols is not None else names
    missing = [u for u in use if u not in names]
    if missing:
        raise KeyError(f"{path} has no column {missing}")
    from clsr_tpu_torch import native

    kinds = ["s" if n in strings else "i" if n in use else "-"
             for n in names]
    while True:
        status, bad, cols = native.read_csv_native(path, kinds, skip)
        if status == native.CSV_NOT_INT:
            kinds[bad] = "s"
            continue
        break
    if status != native.CSV_OK:
        return _read_csv_python(path, names, use, skip)
    out = {}
    for name in use:
        col = cols[names.index(name)]
        out[name] = col if isinstance(col, np.ndarray) else _infer(col[1],
                                                                   col[0])
    return out


# ---------------------------------------------------------------- filters

def filter_k_core(record: Columns, k_core: int, filtered_column: str,
                  count_column: str) -> Columns:
    """Keep rows whose `filtered_column` value has >= k_core non-null
    `count_column` values (sequential_reviews.py:815-828)."""
    key = record[filtered_column]
    valid = _notnull(key)
    code, n = _codes(key)
    counts = np.bincount(code[valid & _notnull(record[count_column])],
                         minlength=n)
    return _take(record, valid & (counts >= k_core)[code])


def filter_items_with_multiple_cids(record: Columns) -> Columns:
    """Drop items mapped to more than one category id (:936-943)."""
    iid = record["iid"]
    pairs = _first_rows(iid, record["category"])
    code, n = _codes(iid)
    n_cids = np.bincount(code[pairs], minlength=n)
    return _take(record, _notnull(iid) & (n_cids == 1)[code])


def downsample(record: Columns, col: str, frac: float,
               rng: Optional[np.random.RandomState] = None) -> Columns:
    """Keep a random `frac` of the distinct `col` values (:946-952)."""
    values = record[col][_first_rows(record[col])]
    size = round(frac * len(values))
    idx = (rng if rng is not None else np.random).choice(
        len(values), size=size, replace=False)
    return _take(record, _isin(record[col], values[idx]))


# ----------------------------------------------------------- dataset mains

def taobao_main(reviews_file: str,
                rng: Optional[np.random.RandomState] = None,
                stages: Optional[Dict[str, float]] = None
                ) -> Tuple[Columns, Columns]:
    """UserBehavior.csv -> (reviews {uid, iid, ts}, meta {iid, category})
    (sequential_reviews.py:955-982).  `stages` gets the read and the
    filters' seconds."""
    t0 = time.perf_counter()
    reviews = read_csv(reviews_file,
                       names=["uid", "iid", "category", "behavior", "ts"],
                       strings=("behavior",))
    t1 = time.perf_counter()
    reviews = _take(reviews, reviews["behavior"] == "pv")
    reviews = _take(reviews, _first_rows(reviews["uid"], reviews["iid"]))
    reviews = filter_items_with_multiple_cids(reviews)
    start_ts = int(datetime(2017, 11, 25, 0, 0, 0).timestamp())
    end_ts = int(datetime(2017, 12, 3, 23, 59, 59).timestamp())
    ts = reviews["ts"]
    reviews = _take(reviews, (ts >= start_ts) & (ts <= end_ts))
    reviews = downsample(reviews, "uid", 0.05, rng)
    reviews = filter_k_core(reviews, 10, "iid", "uid")
    reviews = filter_k_core(reviews, 10, "uid", "iid")
    meta = _take({"iid": reviews["iid"], "category": reviews["category"]},
                 _first_rows(reviews["iid"], reviews["category"]))
    if stages is not None:
        stages["read"] = t1 - t0
        stages["filters"] = time.perf_counter() - t1
    return {k: reviews[k] for k in ("uid", "iid", "ts")}, meta


_KUAISHOU_NAMES = {"time_ms": "ts", "user_id": "uid", "photo_id": "iid",
                   "photo_kmeans_cluster_id": "category",
                   "effective_view": "effective_view"}


def kuaishou_main(reviews_file: str,
                  stages: Optional[Dict[str, float]] = None
                  ) -> Tuple[Columns, Columns]:
    """kuaishou.csv (a header line; other columns are ignored) ->
    (reviews, meta) (sequential_reviews.py:999-1041)."""
    t0 = time.perf_counter()
    raw = read_csv(reviews_file, usecols=list(_KUAISHOU_NAMES))
    t1 = time.perf_counter()
    reviews = {new: raw[old] for old, new in _KUAISHOU_NAMES.items()}
    reviews = _take(reviews, _first_rows(reviews["uid"], reviews["iid"]))
    reviews = filter_k_core(reviews, 10, "iid", "uid")
    # user 10-core counting only positive rows (:830-843, :1022)
    pos = _take(reviews, reviews["effective_view"] == 1)
    keep = filter_k_core(pos, 10, "uid", "iid")["uid"]
    reviews = _take(reviews, _isin(reviews["uid"], keep))
    reviews = _take(reviews, reviews["effective_view"] == 1)
    meta = _take({"iid": reviews["iid"], "category": reviews["category"]},
                 _first_rows(reviews["iid"], reviews["category"]))
    if stages is not None:
        stages["read"] = t1 - t0
        stages["filters"] = time.perf_counter() - t1
    return {k: reviews[k] for k in ("uid", "iid", "ts")}, meta


# ---------------------------------------------------------------- instances

def _map_categories(iid: np.ndarray, meta: Columns) -> np.ndarray:
    """Series.map(meta.set_index("iid")["category"]).fillna("default_cat"):
    an item that meta lacks gets "default_cat" (the column then holds
    objects, its other values floats, as pandas gives them)."""
    keys, cats = meta["iid"], meta["category"]
    if len(keys) != int(_first_rows(keys).sum()):
        raise ValueError("Reindexing only valid with uniquely valued Index "
                         "objects")
    if len(keys) == 0:
        return np.full(len(iid), "default_cat", object)
    order = np.argsort(keys, kind="stable")
    srt = keys[order]
    pos = np.minimum(np.searchsorted(srt, iid), len(srt) - 1)
    found = srt[pos] == iid
    out = cats[order][pos]
    if found.all():
        return out
    out = out.astype(np.float64 if cats.dtype.kind in "iub" else object)
    out = out.astype(object)
    out[~found] = "default_cat"
    return out


def create_instances(reviews: Columns, meta: Columns) -> Columns:
    """Each user's rows in time order with the item's category joined
    (:592-630): label, user_id, item_id, timestamp, cate_id."""
    cate = _map_categories(reviews["iid"], meta)
    order = np.lexsort((reviews["ts"], reviews["uid"]))
    return {"label": np.ones(len(order), np.int64),
            "user_id": reviews["uid"][order],
            "item_id": reviews["iid"][order],
            "timestamp": reviews["ts"][order],
            "cate_id": cate[order]}


def _consume(rng: np.random.RandomState, n: int, state, used: int) -> None:
    """Leave `rng` `used` draws of randint(n) past `state`."""
    if state is not None:
        rng.set_state(state)
        if used:
            rng.randint(n, size=used)


def get_sampled_data(instances: Columns, sample_rate: float,
                     rng: Optional[np.random.RandomState] = None
                     ) -> Columns:
    """Popularity-proportional item subsample (:537-556): items drawn one
    at a time from the instance stream until int(n_items * sample_rate)
    distinct ones are chosen."""
    if sample_rate >= 1:
        return instances
    rng = rng or np.random.RandomState()
    code, n_items = _codes(instances["item_id"])
    n_keep = int(n_items * sample_rate)
    n_pool = len(code)
    chosen = np.zeros(n_items, bool)
    n_chosen = 0
    state, used = None, 0
    while n_chosen < n_keep:
        state = rng.get_state()
        draws = code[rng.randint(n_pool, size=_DRAW_CHUNK)]
        # a draw is new when its item is not chosen and not drawn earlier
        # in the chunk
        first = _first_rows(draws) & ~chosen[draws]
        cum = np.cumsum(first)
        if n_chosen + int(cum[-1]) >= n_keep:
            used = int(np.searchsorted(cum, n_keep - n_chosen)) + 1
        else:
            used = len(draws)
        chosen[draws[:used]] = True
        n_chosen = int(chosen.sum())
    _consume(rng, n_pool, state, used)
    return _take(instances, chosen[code])


# ------------------------------------------------------------------- split

def split_global_time(instances: Columns, test_interval: float
                      ) -> np.ndarray:
    """'train' / 'valid' / 'test' a row: test = the last interval of
    global time, valid = the one before (:672-735)."""
    t = instances["timestamp"]
    t_max = t.max()
    test_split = t_max - test_interval
    valid_split = t_max - 2 * test_interval
    return np.where(t < valid_split, "train",
                    np.where(t < test_split, "valid", "test"))


# ----------------------------------------------------------- line generation

def _expand_user_lines(uid, items, cates, times, split_names, subsample,
                       min_sequence, rng, outs) -> None:
    """One user's expanding-history lines, the history built by one
    append a line; one uniform a line whose split has frac < 1, in k
    order (JAX etl.py:159-185)."""
    uid_s = str(uid)
    ih, ch, th = items[0], cates[0], times[0]
    for k in range(1, len(items)):
        split = split_names[k]
        frac = subsample.get(split, 1.0)
        keep = True
        if frac < 1.0:
            keep = rng.uniform() < frac
        if keep and k >= min_sequence:
            outs[split].write(
                f"1\t{uid_s}\t{items[k]}\t{cates[k]}\t{times[k]}\t"
                f"{ih}\t{ch}\t{th}\n")
        if k < len(items) - 1:
            ih = ih + "," + items[k]
            ch = ch + "," + cates[k]
            th = th + "," + times[k]


def _group_offsets(users: np.ndarray) -> np.ndarray:
    """Row offsets of the user blocks (contiguous in the instance
    stream), with the end."""
    starts = np.flatnonzero(
        np.concatenate([[True], users[1:] != users[:-1]]))
    return np.concatenate([starts, [len(users)]]).astype(np.int64)


def _stringify_columns(df: Columns):
    """One str conversion a column (.astype("U"): 123, never 123.0, for
    an int column) and the user blocks' offsets."""
    users = np.asarray(df["user_id"])
    items = np.asarray(df["item_id"]).astype("U")
    cates = np.asarray(df["cate_id"]).astype("U")
    times = np.asarray(df["timestamp"]).astype("U")
    return users, items, cates, times, np.asarray(df["_split"]), \
        _group_offsets(users)


def _expand_arrays(users, items, cates, times, splitc, offsets,
                   subsample, min_sequence, rng, outs) -> None:
    for gi in range(len(offsets) - 1):
        lo, hi = offsets[gi], offsets[gi + 1]
        _expand_user_lines(
            users[lo], items[lo:hi].tolist(), cates[lo:hi].tolist(),
            times[lo:hi].tolist(), splitc[lo:hi].tolist(), subsample,
            min_sequence, rng, outs)


def _expand_chunk(args) -> None:
    """Worker: expand a slice of users into its own part files."""
    (pkl_path, part_paths, subsample, min_sequence, seed) = args
    import pickle

    with open(pkl_path, "rb") as f:
        df = pickle.load(f)
    rng = np.random.RandomState(seed)
    outs = {s: open(p, "w", buffering=1 << 20)
            for s, p in part_paths.items()}
    try:
        _expand_arrays(*_stringify_columns(df), subsample, min_sequence,
                       rng, outs)
    finally:
        for f in outs.values():
            f.close()


def _int64_or_none(arr: np.ndarray) -> Optional[np.ndarray]:
    """`arr` as int64 when the conversion is lossless (JAX etl.py:246-
    253), else None: text ids, fractional or NaN values."""
    if arr.dtype.kind in "US":
        return None
    try:
        a64 = arr.astype(np.int64)
    except (TypeError, ValueError, OverflowError):
        return None
    with np.errstate(invalid="ignore"):
        same = np.array_equal(a64, arr.astype(np.float64)
                              if arr.dtype.kind == "f" else arr)
    return a64 if same else None


def _try_native_expand(df: Columns, train_file: str, valid_file: str,
                       test_file: str, subsample: Dict[str, float],
                       min_sequence: int,
                       rng: Optional[np.random.RandomState]
                       ) -> Optional[int]:
    """The C++ line generator when ids and timestamps are integers: the
    lines written, or None when they are not (the Python engine runs).
    The C++ subsample rng is mt19937_64 seeded by one draw of `rng`; the
    train split (frac 1.0) is byte-identical to the Python engine's.  A
    failed build raises (ops/_build.py)."""
    from clsr_tpu_torch import native

    cols = []
    for c in ("user_id", "item_id", "cate_id", "timestamp"):
        a64 = _int64_or_none(np.asarray(df[c]))
        if a64 is None:
            return None
        cols.append(a64)
    offsets = _group_offsets(cols[0])
    split_idx = np.full(len(cols[0]), -1, np.int8)
    names = np.asarray(df["_split"])
    for c, name in enumerate(_SPLITS):
        split_idx[names == name] = c
    sub3 = np.asarray([subsample.get(s, 1.0) for s in _SPLITS], np.float64)
    seed = int((rng or np.random.RandomState()).randint(0, 2 ** 63 - 1))
    return native.expand_lines_native(
        cols[0], cols[1], cols[2], cols[3], split_idx, offsets, sub3,
        min_sequence, seed, train_file, valid_file, test_file)


def generate_expanding(instances: Columns, splits: np.ndarray,
                       train_file: str, valid_file: str, test_file: str,
                       subsample: Dict[str, float],
                       min_sequence: int = 1,
                       rng: Optional[np.random.RandomState] = None,
                       processes: int = 1,
                       engine: str = "python") -> None:
    """Expanding-history TSV generation (:358-438).

    Every event of a user's stream past the first makes a line whose
    history is all the events before it, written to its split's file;
    `subsample[split]` keeps that fraction of the candidate lines.
    `processes > 1` shards users over worker processes (RandomState(seed0
    + worker) each; part files joined in worker order); `engine='native'`
    runs the loop in C++ when the ids are integers and else gives way to
    the Python engine (logged)."""
    df = dict(instances, _split=np.asarray(splits))
    if engine == "native":
        n = _try_native_expand(df, train_file, valid_file, test_file,
                               subsample, min_sequence, rng)
        if n is not None:
            logger.info("expanding histories: native engine, %d lines", n)
            return
        logger.info("expanding histories: ids are not integers, the "
                    "Python engine runs")
    if processes > 1:
        logger.info("expanding histories: %d worker processes", processes)
        _generate_expanding_mp(df, train_file, valid_file, test_file,
                               subsample, min_sequence, rng, processes)
        return
    logger.info("expanding histories: Python engine")
    rng = rng or np.random.RandomState()
    outs = {"train": open(train_file, "w", buffering=1 << 20),
            "valid": open(valid_file, "w", buffering=1 << 20),
            "test": open(test_file, "w", buffering=1 << 20)}
    try:
        _expand_arrays(*_stringify_columns(df), subsample, min_sequence,
                       rng, outs)
    finally:
        for f in outs.values():
            f.close()


def _generate_expanding_mp(df: Columns, train_file: str, valid_file: str,
                           test_file: str, subsample: Dict[str, float],
                           min_sequence: int,
                           rng: Optional[np.random.RandomState],
                           processes: int) -> None:
    import multiprocessing as mp
    import pickle
    import shutil
    import tempfile

    seed0 = int((rng or np.random.RandomState()).randint(0, 2 ** 31 - 1))
    users = np.asarray(df["user_id"])
    # user blocks are contiguous; cut at user boundaries into row ranges
    # of about equal size
    starts = np.flatnonzero(
        np.concatenate([[True], users[1:] != users[:-1]]))
    cut_rows = np.linspace(0, len(users), processes + 1)[1:-1]
    cut_idx = np.searchsorted(starts, cut_rows)
    bounds = np.concatenate([[0], starts[cut_idx], [len(users)]])

    tmp = tempfile.mkdtemp(prefix="clsr_etl_")
    try:
        jobs = []
        for w in range(processes):
            lo, hi = int(bounds[w]), int(bounds[w + 1])
            if lo >= hi:
                continue
            pkl = os.path.join(tmp, f"chunk_{w}.pkl")
            with open(pkl, "wb") as f:
                pickle.dump({k: v[lo:hi] for k, v in df.items()}, f)
            parts = {s: os.path.join(tmp, f"{s}_{w}.tsv") for s in _SPLITS}
            jobs.append((pkl, parts, subsample, min_sequence, seed0 + w))

        with mp.get_context("spawn").Pool(processes) as pool:
            pool.map(_expand_chunk, jobs)

        for split, path in (("train", train_file), ("valid", valid_file),
                            ("test", test_file)):
            with open(path, "w") as out:
                for job in jobs:
                    with open(job[1][split]) as part:
                        shutil.copyfileobj(part, out, 1 << 22)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def generate_no_expanding(instances: Columns, splits: np.ndarray,
                          train_file: str, valid_file: str, test_file: str,
                          min_sequence: int = 1) -> None:
    """One line a user (:441-523): the whole history predicts the last
    event of the stream, in the split of that event."""
    users = np.asarray(instances["user_id"])
    items = np.asarray(instances["item_id"]).astype(str)
    cates = np.asarray(instances["cate_id"]).astype(str)
    times = np.asarray(instances["timestamp"]).astype(str)
    splits = np.asarray(splits)
    off = _group_offsets(users) if len(users) else np.zeros(1, np.int64)
    outs = {"train": open(train_file, "w"), "valid": open(valid_file, "w"),
            "test": open(test_file, "w")}
    try:
        for g in range(len(off) - 1):
            lo, hi = int(off[g]), int(off[g + 1])
            if hi - lo - 1 > min_sequence:
                outs[str(splits[hi - 1])].write("\t".join([
                    "1", str(users[lo]), items[hi - 1], cates[hi - 1],
                    times[hi - 1], ",".join(items[lo:hi - 1].tolist()),
                    ",".join(cates[lo:hi - 1].tolist()),
                    ",".join(times[lo:hi - 1].tolist()),
                ]) + "\n")
    finally:
        for f in outs.values():
            f.close()


# ------------------------------------------------------------------- vocab

def create_vocab(train_file: str, user_vocab: str, item_vocab: str,
                 cate_vocab: str) -> None:
    """Frequency-sorted vocabs of the TRAIN file, id 0 the default
    (:77-144); counts cover targets and histories, ties keep first-seen
    order (a Counter fills in scan order, and the sort is stable)."""
    user_counts: collections.Counter = collections.Counter()
    item_counts: collections.Counter = collections.Counter()
    cate_counts: collections.Counter = collections.Counter()
    with open(train_file) as f:
        for line in f:
            arr = line.rstrip("\n").split("\t")
            if len(arr) < 7:
                continue
            user_counts[arr[1]] += 1
            item_counts[arr[2]] += 1
            cate_counts[arr[3]] += 1
            item_counts.update(arr[5].split(","))
            cate_counts.update(arr[6].split(","))

    def freq_vocab(counts, default: str) -> Vocab:
        mapping = {default: 0}
        for i, (tok, _) in enumerate(
                sorted(counts.items(), key=lambda kv: kv[1], reverse=True)):
            mapping[tok] = i + 1
        return Vocab(mapping)

    freq_vocab(user_counts, "default_uid").save(user_vocab)
    freq_vocab(item_counts, "default_mid").save(item_vocab)
    freq_vocab(cate_counts, "default_cat").save(cate_vocab)


# ------------------------------------------------------- negative sampling

def negative_sampling_offline(instances: Columns, valid_file: str,
                              test_file: str, valid_num_ngs: int = 4,
                              test_num_ngs: int = 49,
                              rng: Optional[np.random.RandomState] = None
                              ) -> None:
    """Write num_ngs popularity-sampled negative lines after each
    positive (:147-199): negatives unique a line, != the positive, the
    category replaced by the negative item's (the last instance's)."""
    rng = rng or np.random.RandomState()
    items = np.asarray(instances["item_id"]).astype(str)
    cates = np.asarray(instances["cate_id"]).astype(str)
    item2cate = dict(zip(items.tolist(), cates.tolist()))
    n_pool = len(items)
    code, n_distinct = _codes(items)
    tokens = np.empty(n_distinct, object)
    tokens[code] = items.tolist()
    token_code = {t: c for c, t in enumerate(tokens.tolist())}
    buf: List[int] = []
    j = 0
    state = None

    for path, num_ngs in ((valid_file, valid_num_ngs),
                          (test_file, test_num_ngs)):
        with open(path) as f:
            lines = f.readlines()
        with open(path, "w") as out:
            for line in lines:
                out.write(line)
                words = line.strip().split("\t")
                pos = token_code.get(words[2], -1)
                if num_ngs and n_distinct - (pos >= 0) < num_ngs:
                    raise ValueError(
                        f"cannot draw {num_ngs} distinct negatives other "
                        f"than {words[2]!r} from {n_distinct} items")
                taken: set = set()
                while len(taken) < num_ngs:
                    if j == len(buf):
                        state = rng.get_state()
                        buf = code[rng.randint(n_pool,
                                               size=_DRAW_CHUNK)].tolist()
                        j = 0
                    c = buf[j]
                    j += 1
                    if c == pos or c in taken:
                        continue
                    taken.add(c)
                    neg = tokens[c]
                    words[0] = "0"
                    words[2] = neg
                    words[3] = item2cate[neg]
                    out.write("\t".join(words) + "\n")
    _consume(rng, n_pool, state, j)


# -------------------------------------------------------------- orchestrate

def data_preprocessing(reviews_file: str, train_file: str, valid_file: str,
                       test_file: str, user_vocab: str, item_vocab: str,
                       cate_vocab: str, sample_rate: float = 1.0,
                       valid_num_ngs: int = 4, test_num_ngs: int = 9,
                       dataset: str = "taobao",
                       is_history_expanding: bool = True,
                       seed: Optional[int] = None,
                       processes: int = 1,
                       engine: str = "python",
                       output_format: str = "tsv") -> Dict[str, float]:
    """The whole pipeline (sequential_reviews.py:27-74; JAX etl.py:458).

    `processes > 1` runs the expanding-history lines in worker
    processes; `engine='native'` in C++ (integer ids).
    `output_format='packed'` writes `packed.npz` beside `train_file`
    instead of the TSVs (data/packed.py): the same kept lines and
    bit-identical vocabs for a seed, negatives from another draw order.
    Returns each stage's seconds (read, filters, instances, split,
    expand or pack, vocab, negatives)."""
    stages: Dict[str, float] = {}
    rng = np.random.RandomState(seed)
    if dataset == "taobao":
        reviews, meta = taobao_main(reviews_file, rng, stages)
        test_interval = 24 * 60 * 60
        subsample = {"train": 1.0, "valid": 0.2, "test": 0.2}
    elif dataset == "kuaishou":
        reviews, meta = kuaishou_main(reviews_file, stages)
        test_interval = 12 * 60 * 60 * 1000
        subsample = {"train": 0.1, "valid": 0.1, "test": 0.1}
    else:
        raise ValueError(f"unknown dataset {dataset}")

    def stage(name, t0):
        stages[name] = time.perf_counter() - t0
        logger.info("etl %s: %.3f s", name, stages[name])
        return time.perf_counter()

    t = time.perf_counter()
    instances = create_instances(reviews, meta)
    instances = get_sampled_data(instances, sample_rate, rng)
    t = stage("instances", t)
    splits = split_global_time(instances, test_interval)
    t = stage("split", t)

    for path in (train_file, valid_file, test_file, user_vocab, item_vocab,
                 cate_vocab):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    if output_format == "packed":
        if not is_history_expanding:
            raise ValueError(
                "output_format='packed' requires expanding histories")
        from clsr_tpu_torch.data.packed import PACKED_FILENAME, build_packed
        pack, (uv, iv, cv) = build_packed(
            instances, splits, subsample, rng=rng,
            valid_num_ngs=valid_num_ngs, test_num_ngs=test_num_ngs)
        pack.save(os.path.join(os.path.dirname(train_file) or ".",
                               PACKED_FILENAME))
        uv.save(user_vocab)
        iv.save(item_vocab)
        cv.save(cate_vocab)
        stage("pack", t)
        return stages

    if is_history_expanding:
        generate_expanding(instances, splits, train_file, valid_file,
                           test_file, subsample, rng=rng,
                           processes=processes, engine=engine)
    else:
        generate_no_expanding(instances, splits, train_file, valid_file,
                              test_file)
    t = stage("expand", t)
    create_vocab(train_file, user_vocab, item_vocab, cate_vocab)
    t = stage("vocab", t)
    negative_sampling_offline(instances, valid_file, test_file,
                              valid_num_ngs, test_num_ngs, rng)
    stage("negatives", t)
    return stages
