"""ctypes bindings of the C++ TSV parser (`fastparse.cpp`).

Counterpart of the parse half of clsr_tpu/native/__init__.py:27-132.
The library is built from this package's own copy of the source by
`ops/_build.py` (g++, keyed by the source's hash) into `_build/`, on
first use.  Unlike the JAX package, which falls back to the Python parse
when its build fails, a failed build raises here with the compiler's
output: `data.parser.parse_file(..., use_native=False)` is the explicit
Python route.
"""

from __future__ import annotations

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
