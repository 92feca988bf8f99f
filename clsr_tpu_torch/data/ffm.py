"""FFM (field-aware factorization machine) text-format reader.

Counterpart of clsr_tpu/data/ffm.py (after the reference's
FFMTextIterator, io/iterator.py:27-221, the loader of xDeepFM-style
models).  A line is

    label field:feature:value [field:feature:value ...] [% impression_id]

with 1-based field and feature ids, shifted to 0-based on parse (as
iterator.py:95 does).  Batches are dense static-shape numpy arrays:

  * `labels` [B] float32;
  * `feat_ids` [B, F, M] int32 and `feat_weights` [B, F, M] float32, the
    features of each field padded to the batch's most features a field
    M (the reference's ragged dnn_feat_* triple, [B*F, M],
    iterator.py:157-179, holds the same);
  * `feat_mask` [B, F, M] float32, 1 on real entries.

`fm_sparse_triple` recovers the reference's fm CSR triple (indices,
values, shape).  The reader streams `batch_size` lines a batch without
loading the file (iterator.py:99-131); the last, partial batch keeps its
size.  No model of either package reads this format; it is ported so the
port does all that the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np


@dataclasses.dataclass
class FFMBatch:
    labels: np.ndarray        # [B] float32
    feat_ids: np.ndarray      # [B, F, M] int32 (0-based feature ids)
    feat_weights: np.ndarray  # [B, F, M] float32
    feat_mask: np.ndarray     # [B, F, M] float32
    impression_ids: List      # [B] (0 when the line carries no id)

    @property
    def batch_size(self) -> int:
        return self.labels.shape[0]


def parse_ffm_line(line: str, col_spliter: str = " ",
                   id_spliter: str = "%"):
    """label, [(field0, feat0, value), ...], impression_id — 0-based ids
    (iterator.py:71-97)."""
    impression_id = 0
    words = line.strip().split(id_spliter)
    if len(words) == 2:
        impression_id = words[1].strip()
    cols = words[0].strip().split(col_spliter)
    label = float(cols[0])
    features = []
    for word in cols[1:]:
        if not word.strip():
            continue
        f, feat, val = word.split(":")
        features.append((int(f) - 1, int(feat) - 1, float(val)))
    return label, features, impression_id


class FFMTextReader:
    """Streaming batch reader over an FFM text file."""

    def __init__(self, feature_count: int, field_count: int,
                 batch_size: int, col_spliter: str = " ",
                 id_spliter: str = "%"):
        self.feature_count = feature_count
        self.field_count = field_count
        self.batch_size = batch_size
        self.col_spliter = col_spliter
        self.id_spliter = id_spliter

    def _convert(self, labels, features, impression_ids) -> FFMBatch:
        B, F = len(labels), self.field_count
        per_field = [[len([1 for fd, _, _ in feats if fd == f])
                      for f in range(F)] for feats in features]
        M = max(1, max((max(c) if c else 0) for c in per_field))
        ids = np.zeros((B, F, M), np.int32)
        weights = np.zeros((B, F, M), np.float32)
        mask = np.zeros((B, F, M), np.float32)
        for i, feats in enumerate(features):
            fill = [0] * F
            for fd, feat, val in feats:
                j = fill[fd]
                fill[fd] += 1
                ids[i, fd, j] = feat
                weights[i, fd, j] = val
                mask[i, fd, j] = 1.0
        return FFMBatch(
            labels=np.asarray(labels, np.float32),
            feat_ids=ids, feat_weights=weights, feat_mask=mask,
            impression_ids=list(impression_ids))

    def load_data_from_file(self, path: str) -> Iterator[FFMBatch]:
        labels, features, imps = [], [], []
        with open(path, "r") as f:
            for line in f:
                if not line.strip():
                    continue
                label, feats, imp = parse_ffm_line(
                    line, self.col_spliter, self.id_spliter)
                labels.append(label)
                features.append(feats)
                imps.append(imp)
                if len(labels) == self.batch_size:
                    yield self._convert(labels, features, imps)
                    labels, features, imps = [], [], []
        if labels:
            yield self._convert(labels, features, imps)


def fm_sparse_triple(batch: FFMBatch, feature_count: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The reference's fm_feat_(indices, values, shape) CSR triple
    (iterator.py:146-149, 185-188), recovered from the dense layout."""
    rows, fields, slots = np.nonzero(batch.feat_mask)
    feats = batch.feat_ids[rows, fields, slots]
    vals = batch.feat_weights[rows, fields, slots]
    indices = np.stack([rows, feats], axis=1).astype(np.int64)
    shape = np.asarray([batch.batch_size, feature_count], np.int64)
    return indices, vals.astype(np.float32), shape
