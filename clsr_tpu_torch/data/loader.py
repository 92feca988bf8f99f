"""Host-side batching.

Counterpart of clsr_tpu/data/loader.py:52-320 (the single-batch paths),
which replaces the reference's per-batch Python assembly
(sequential_iterator.py:194-503) with a pad-once design:

  * the whole dataset is padded and left-truncated to [N, max_seq_length]
    once (`PaddedView`); an epoch's batching is fancy indexing;
  * train batches carry only the B positive rows (G = 1); the in-batch
    negatives are drawn on the device by the train step;
  * eval batches pack each run of (1 positive + num_ngs negative) file
    rows into ONE row with G targets, since the negatives share the
    positive's user and history (sequential_reviews.py:147-199);
  * every batch has a static shape: the final partial batch is
    zero-padded and masked by `valid`;
  * a trailing train batch of fewer than `min_batch_rows` (5) real rows is
    dropped (sequential_iterator.py:338-339), and rows whose history is
    shorter than min_seq_length are skipped (:245-246).

For K train steps a host call, `train_batches_stacked` (JAX :174-230)
gathers the whole epoch once, in a thread pool, into one of two buffer
sets that alternate across epochs (`_epoch_gather`, :119-172), and
yields [K, B, ...] views of whole batches, then the [B] tail batches.

A loader reads a `PaddedView` of a parsed TSV, or the packed format's
`PackedView` (data/packed.py), whose eval splits present the (1 +
num_ngs)-row layout through strided adapters: the same batches.

Batches stay on the host: `Batch` objects whose fields are numpy arrays.
`data.prefetch.prefetch_to_device` (or `data.prefetch.to_device`) turns
them into tensors on the device.  The resident path
(data/resident.py) uploads the `PaddedView` instead.  Eval batches can
be length-bucketed (`eval_batches(paddings=)`, JAX :233-279): each
bucket's batches carry only its Lb history columns.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.data.parser import ParsedDataset

# the epoch-gather pool, made at first use (numpy's fancy indexing
# releases the GIL; the gather is bound by host memory and scales with
# cores)
_GATHER_POOL: Optional[ThreadPoolExecutor] = None


def _gather_pool() -> ThreadPoolExecutor:
    global _GATHER_POOL
    if _GATHER_POOL is None:
        _GATHER_POOL = ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 4))
    return _GATHER_POOL


class PaddedView:
    """Dense [N, L] padded view of a ParsedDataset (built once)."""

    def __init__(self, ds: ParsedDataset, max_seq_length: int):
        n = len(ds)
        L = max_seq_length
        lengths = np.diff(ds.offsets)
        tl = np.minimum(lengths, L).astype(np.int64)

        self.item_hist = np.zeros((n, L), dtype=np.int32)
        self.cate_hist = np.zeros((n, L), dtype=np.int32)
        self.time_diff = np.zeros((n, L), dtype=np.float32)
        self.time_from_first = np.zeros((n, L), dtype=np.float32)
        self.time_to_now = np.zeros((n, L), dtype=np.float32)
        self.mask = np.zeros((n, L), dtype=np.float32)

        total = int(tl.sum())
        if total:
            rows = np.repeat(np.arange(n), tl)
            excl = np.concatenate([[0], np.cumsum(tl)[:-1]])
            pos = np.arange(total) - np.repeat(excl, tl)
            # keep the LAST tl entries of each ragged row (left-truncate)
            flat_idx = np.repeat(ds.offsets[1:] - tl, tl) + pos
            self.item_hist[rows, pos] = ds.hist_items[flat_idx]
            self.cate_hist[rows, pos] = ds.hist_cates[flat_idx]
            self.time_diff[rows, pos] = ds.time_diff[flat_idx]
            self.time_from_first[rows, pos] = ds.time_from_first[flat_idx]
            self.time_to_now[rows, pos] = ds.time_to_now[flat_idx]
            self.mask[rows, pos] = 1.0

        self.lengths = lengths
        self.users = ds.users
        self.items = ds.items
        self.cates = ds.cates
        self.labels = ds.labels


class SequenceLoader:
    """Batch iterator factory over a ParsedDataset."""

    def __init__(self, ds: ParsedDataset, max_seq_length: int,
                 min_batch_rows: int = 5, view=None):
        """`view` stands in for the PaddedView of `ds` (JAX :93-101): the
        packed format's `PackedView` (data/packed.py `make_loader`),
        built without a ParsedDataset; `ds` then only gives len()."""
        self.ds = ds
        self.max_seq_length = max_seq_length
        self.min_batch_rows = min_batch_rows
        self.view = view if view is not None else PaddedView(
            ds, max_seq_length)
        self._stacked_bufs: list = [None, None]
        self._buf_flip = 0

    def train_batches(self, batch_rows: int, rng: np.random.RandomState,
                      min_seq_length: int = 1) -> Iterator[Batch]:
        """Shuffled batches of positive rows, G = 1, [batch_rows] rows."""
        idx = np.flatnonzero(self.view.lengths >= min_seq_length)
        rng.shuffle(idx)
        for lo in range(0, len(idx), batch_rows):
            take = idx[lo:lo + batch_rows]
            if len(take) < self.min_batch_rows:
                continue  # the reference drops tiny trailing train batches
            yield self._make_batch(take, batch_rows, group=None)

    def _epoch_gather(self, take: np.ndarray) -> dict:
        """The epoch's rows `take`, gathered into reused contiguous
        buffers.  Two buffer sets alternate across epochs, so views of
        one epoch still queued for the device are not overwritten by the
        next epoch's gather."""
        v = self.view
        src = {
            "users": v.users, "items": v.items, "cates": v.cates,
            "labels": v.labels,
            "item_hist": v.item_hist, "cate_hist": v.cate_hist,
            "mask": v.mask, "time_diff": v.time_diff,
            "time_from_first": v.time_from_first,
            "time_to_now": v.time_to_now,
        }
        n = len(take)
        bufs = self._stacked_bufs[self._buf_flip]
        self._buf_flip ^= 1
        if bufs is None or len(next(iter(bufs.values()))) != n:
            bufs = {key: np.empty((n,) + arr.shape[1:],
                                  np.float32 if key == "labels"
                                  else arr.dtype)
                    for key, arr in src.items()}
            self._stacked_bufs[self._buf_flip ^ 1] = bufs

        pool = _gather_pool()
        jobs = []
        n_parts = pool._max_workers
        for key, arr in src.items():
            out = bufs[key]
            if arr.ndim == 1:
                jobs.append(pool.submit(np.take, arr, take, 0, out, "clip"))
            else:
                # the [N, L] gathers split by rows across the workers
                for p in range(n_parts):
                    lo, hi = p * n // n_parts, (p + 1) * n // n_parts
                    jobs.append(pool.submit(
                        np.take, arr, take[lo:hi], 0, out[lo:hi], "clip"))
        for j in jobs:
            j.result()
        return {
            "users": bufs["users"],
            "items": bufs["items"][:, None],
            "cates": bufs["cates"][:, None],
            "labels": bufs["labels"][:, None],
            "item_hist": bufs["item_hist"],
            "cate_hist": bufs["cate_hist"],
            "mask": bufs["mask"],
            "time_diff": bufs["time_diff"],
            "time_from_first": bufs["time_from_first"],
            "time_to_now": bufs["time_to_now"],
        }

    def train_batches_stacked(self, batch_rows: int, steps_per_call: int,
                              rng: np.random.RandomState,
                              min_seq_length: int = 1) -> Iterator[Batch]:
        """The epoch for K = steps_per_call steps a host call: [K, B, ...]
        stacks of whole batches, then plain [B] batches for the tail
        (told apart by users.ndim).  Rows, shuffle (the same RandomState
        draws) and the drop of a trailing batch of fewer than
        `min_batch_rows` rows are those of `train_batches`, so the steps
        are the same; each stack is a view of the epoch's buffers."""
        v = self.view
        idx = np.flatnonzero(v.lengths >= min_seq_length)
        rng.shuffle(idx)
        n = len(idx)
        rem = n % batch_rows
        if rem and rem < self.min_batch_rows:
            n -= rem  # the reference drops tiny trailing train batches
        if n == 0:
            return
        take = idx[:n].astype(np.int64)
        B, K = batch_rows, steps_per_call
        n_batches = -(-n // B)
        # only whole batches enter a stack; the last, padded one is a
        # single step of the tail
        n_calls = (n // B) // K

        ep = self._epoch_gather(take)
        for c in range(n_calls):
            lo = c * K * B
            yield Batch(
                valid=np.ones((K, B), dtype=np.float32),
                **{key: arr[lo:lo + K * B].reshape((K, B) + arr.shape[1:])
                   for key, arr in ep.items()})
        for b in range(n_calls * K, n_batches):
            lo = b * B
            take_n = min(B, n - lo)
            row = {key: arr[lo:lo + take_n] for key, arr in ep.items()}
            if take_n < B:
                row = {key: np.concatenate(
                    [arr, np.zeros((B - take_n,) + arr.shape[1:], arr.dtype)])
                    for key, arr in row.items()}
            valid = np.zeros(B, dtype=np.float32)
            valid[:take_n] = 1.0
            yield Batch(valid=valid, **row)

    def eval_batches(self, group_size: int, batch_groups: int,
                     min_seq_length: int = 1,
                     paddings: Optional[list] = None) -> Iterator[Batch]:
        """Grouped eval batches: one row per (1 pos + num_ngs neg) group.

        File rows must come in whole groups of `group_size` with the same
        user and history inside each group (the offline sampler's
        layout).  With group_size 1 every row is its own group (the
        predict path).

        `paddings` (ascending bucket paddings, data/resident.py
        `resolve_bucket_paddings`) buckets the groups by the anchor row's
        history length (a group's negatives share its history), and each
        bucket's batches carry its Lb history columns; strict edges keep
        column Lb - 1 padding.  The metrics do not depend on the groups'
        order."""
        v = self.view
        n_rows = len(v.labels)
        if n_rows % group_size != 0:
            raise ValueError(
                f"eval file rows ({n_rows}) not divisible by group size "
                f"({group_size})")
        anchors = np.arange(0, n_rows, group_size)
        if min_seq_length > 1:
            anchors = anchors[v.lengths[anchors] >= min_seq_length]
        if paddings:
            from clsr_tpu_torch.data.resident import bucket_rows
            L = v.item_hist.shape[1]
            for Lb, local in bucket_rows(v.lengths[anchors], L, paddings):
                sub = anchors[local]
                for lo in range(0, len(sub), batch_groups):
                    yield self._make_batch(sub[lo:lo + batch_groups],
                                           batch_groups, group=group_size,
                                           Lb=None if Lb == L else Lb)
            return
        for lo in range(0, len(anchors), batch_groups):
            yield self._make_batch(anchors[lo:lo + batch_groups],
                                   batch_groups, group=group_size)

    def _make_batch(self, row_idx: np.ndarray, target_rows: int,
                    group: Optional[int], Lb: Optional[int] = None) -> Batch:
        """`Lb` cuts the history fields to a bucket's padding (its rows
        all have clamped length <= Lb - 1; see eval_batches)."""
        v = self.view
        n = len(row_idx)
        cols = slice(None) if Lb is None else slice(0, Lb)

        def pad(arr):
            if n == target_rows:
                return np.ascontiguousarray(arr)
            shape = (target_rows - n,) + arr.shape[1:]
            return np.concatenate([arr, np.zeros(shape, dtype=arr.dtype)], 0)

        if group is None:
            items = v.items[row_idx][:, None]
            cates = v.cates[row_idx][:, None]
            labels = v.labels[row_idx][:, None]
        else:
            # group member g sits at file row anchor + g
            member = row_idx[:, None] + np.arange(group)[None, :]
            items = v.items[member]
            cates = v.cates[member]
            labels = v.labels[member]

        valid = np.zeros(target_rows, dtype=np.float32)
        valid[:n] = 1.0
        return Batch(
            users=pad(v.users[row_idx]),
            items=pad(items),
            cates=pad(cates),
            labels=pad(labels.astype(np.float32)),
            item_hist=pad(v.item_hist[row_idx][:, cols]),
            cate_hist=pad(v.cate_hist[row_idx][:, cols]),
            mask=pad(v.mask[row_idx][:, cols]),
            time_diff=pad(v.time_diff[row_idx][:, cols]),
            time_from_first=pad(v.time_from_first[row_idx][:, cols]),
            time_to_now=pad(v.time_to_now[row_idx][:, cols]),
            valid=valid,
        )
