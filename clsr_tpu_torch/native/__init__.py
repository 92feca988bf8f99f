"""ctypes bindings of the C++ host data path (`fastparse.cpp`).

Counterpart of clsr_tpu/native/__init__.py: the TSV parse (:27-132) and
the ETL's expanding-history writer (`expand_lines_native`, :134-160),
plus the port's own CSV column reader of raw logs (`read_csv_native`).
The library is built from this package's own copy of the source by
`ops/_build.py` (g++, keyed by the source's hash) into `_build/`, on
first use.  Unlike the JAX package, which falls back to Python when its
build fails, a failed build raises here with the compiler's output:
`data.parser.parse_file(..., use_native=False)` and the ETL's
`engine="python"` are the explicit Python routes.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from clsr_tpu_torch.data.vocab import Vocab
from clsr_tpu_torch.ops import _build


def _lib():
    return _build.load("fastparse")


class NativeVocab:
    """A C++-side string -> id map built once from a Vocab's mapping."""

    def __init__(self, mapping: dict):
        lib = _lib()
        keys = list(mapping)
        blob = "\n".join(keys).encode("utf-8")
        ids = np.ascontiguousarray([mapping[k] for k in keys], np.int32)
        self._lib = lib
        self._ptr = lib.clsr_vocab_new(blob, len(blob), ids.ctypes.data,
                                       len(keys))

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.clsr_vocab_free(self._ptr)
            self._ptr = None


def native_vocab(vocab: Vocab) -> NativeVocab:
    """The NativeVocab of `vocab`, built on first use and kept on it."""
    nv = getattr(vocab, "_native", None)
    if nv is None:
        nv = vocab._native = NativeVocab(vocab.mapping)
    return nv


def parse_file_native(path: str, user_vocab: Vocab, item_vocab: Vocab,
                      cate_vocab: Vocab, time_range: float):
    """(labels, users, items, cates, times, offsets, hist_items,
    hist_cates, time_diff, time_from_first, time_to_now): the fields of
    data.parser.ParsedDataset, in that order."""
    lib = _lib()
    nvs = [native_vocab(v) for v in (user_vocab, item_vocab, cate_vocab)]
    res = lib.clsr_parse_file(str(path).encode(), *(v._ptr for v in nvs),
                              float(time_range))
    if not res:
        raise IOError(f"native parse failed for {path}")
    try:
        n = lib.clsr_result_n(res)
        total = lib.clsr_result_total(res)
        out = [np.empty(n, np.float32), np.empty(n, np.int32),
               np.empty(n, np.int32), np.empty(n, np.int32),
               np.empty(n, np.float64), np.empty(n + 1, np.int64),
               np.empty(total, np.int32), np.empty(total, np.int32),
               np.empty(total, np.float32), np.empty(total, np.float32),
               np.empty(total, np.float32)]
        lib.clsr_result_fill(res, *(a.ctypes.data for a in out))
    finally:
        lib.clsr_result_free(res)
    return tuple(out)


def expand_lines_native(users, items, cates, times, split_idx, offsets,
                        subsample3, min_sequence: int, seed: int,
                        train_path: str, valid_path: str,
                        test_path: str) -> int:
    """Expanding-history TSV generation in C++ (numeric-id datasets).

    users/items/cates/times int64 [n], split_idx int8 [n] (0 train / 1
    valid / 2 test), offsets int64 [n_groups + 1], subsample3 float64
    [3].  Returns the lines written; raises on an I/O error."""
    lib = _lib()
    arrays = [np.ascontiguousarray(a, t) for a, t in (
        (users, np.int64), (items, np.int64), (cates, np.int64),
        (times, np.int64), (split_idx, np.int8), (offsets, np.int64))]
    sub3 = np.ascontiguousarray(subsample3, np.float64)
    n = lib.clsr_expand_lines(
        *(a.ctypes.data for a in arrays), len(arrays[5]) - 1,
        sub3.ctypes.data, int(min_sequence), int(seed),
        str(train_path).encode(), str(valid_path).encode(),
        str(test_path).encode())
    if n < 0:
        raise IOError("native expand_lines failed (I/O error)")
    return int(n)


# the reader's statuses (fastparse.cpp CsvStatus)
CSV_OK, CSV_NOT_INT, CSV_QUOTE, CSV_FIELDS = 0, 1, 2, 3


def read_csv_native(path: str, kinds: Sequence[str], skip_lines: int
                    ) -> Tuple[int, int, List]:
    """Columns of a CSV file by the C++ reader: (status, bad column,
    columns).  `kinds` has a character a column: 'i' int64, 's' string,
    '-' skipped.  With CSV_OK, columns[c] is an int64 array for 'i', a
    (codes int32 array, distinct strings in first-seen order) pair for
    's' and None for '-'; otherwise the reader stopped at the bad column
    or row and the columns are empty."""
    lib = _lib()
    res = lib.clsr_csv_read(str(path).encode(), "".join(kinds).encode(),
                            len(kinds), int(skip_lines))
    if not res:
        raise IOError(f"cannot read {path}")
    try:
        info = np.zeros(4, np.int64)
        lib.clsr_csv_info(res, info.ctypes.data)
        status, bad_col, _, n = (int(x) for x in info)
        if status != CSV_OK:
            return status, bad_col, []
        cols: List = []
        for c, kind in enumerate(kinds):
            if kind == "i":
                out = np.empty(n, np.int64)
                lib.clsr_csv_fill_ints(res, c, out.ctypes.data)
                cols.append(out)
            elif kind == "s":
                codes = np.empty(n, np.int32)
                lib.clsr_csv_fill_codes(res, c, codes.ctypes.data)
                blob = np.empty(lib.clsr_csv_strings_bytes(res, c), np.uint8)
                lib.clsr_csv_fill_strings(res, c, blob.ctypes.data)
                strings = blob.tobytes().decode("utf-8").split("\n")[:-1]
                cols.append((codes, strings))
            else:
                cols.append(None)
        return status, bad_col, cols
    finally:
        lib.clsr_csv_free(res)
