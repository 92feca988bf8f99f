"""Device-resident training data and length buckets.

Counterpart of clsr_tpu/data/resident.py:44-527.  The streamed
path copies every batch from the host; here the padded train set is
uploaded once (`build_resident`) and each step gathers its B rows on the
device (`gather_batch`) from an epoch permutation at an offset, so a
call of K steps sends the device one scalar and no batch.

  * `ResidentDataset`: the padded arrays (ids, lengths, the parser's
    time features) as device tensors; the [N, L] mask is derived from
    `lengths` at the gather.
  * `epoch_permutation`: the epoch's shuffle and call layout.  It draws
    `np_rng.permutation(eligible)`, which consumes the RandomState as
    the loader's `rng.shuffle` of the same ids does, so a resident epoch
    trains the streamed epoch's batches in the same order.
  * Length buckets (cfg.length_buckets): `choose_bucket_edges`,
    `bucket_rows`, `resolve_bucket_paddings` and `build_resident_buckets`
    split the rows by history length into buckets, each padded to its
    own Lb < L, so the recurrence and the scorers run Lb steps, not L.
    Edges are strict: a bucket padded to Lb holds rows of length
    <= Lb - 1, so column Lb - 1, the model's time_to_now[:, -1] fusion
    input, stays padding as at L.
  * `EpochFeed`: the tensors one resident call reads (a dataset, its
    epoch permutation, the used length and the offset), kept in the same
    storage for a captured step's life; training/steps.py runs the
    steps.
  * On a (data, model) mesh (JAX :325-527): `build_resident_mesh` pads
    the rows with zeros to a multiple of the batch shards and uploads
    only this rank's block of them (block k of the batch shards' order,
    parallel/mesh.py `batch_index`: data-major over (data, model) under
    a flat batch, else the data index, the model row holding the same
    block); `gather_batch_mesh` gathers the batch rows the rank holds,
    the others +0.0 as `gather_batch` zeroes invalid rows, and one
    reduce_scatter over the batch group hands each rank its [B/n] block
    of rows, O(B x row bytes) a step whatever the dataset's size.  The
    fields travel as one int32 tensor (floats as their bits): a sum of
    one nonzero and zeros is exact in integers, so the block equals
    `gather_batch`'s rows bit for bit.  An `EpochFeed` made with the mesh
    gathers through it.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Tuple

import numpy as np
import torch

from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.parallel import collectives as col


@dataclasses.dataclass
class ResidentDataset:
    """The padded dataset as device tensors (one upload a fit)."""

    users: torch.Tensor            # [N] int32
    items: torch.Tensor            # [N] int32 (the positive target)
    cates: torch.Tensor            # [N] int32
    labels: torch.Tensor           # [N] float32
    lengths: torch.Tensor          # [N] int32, clamped to L
    item_hist: torch.Tensor        # [N, L] int32, left-aligned, 0-padded
    cate_hist: torch.Tensor        # [N, L] int32
    time_diff: torch.Tensor        # [N, L] float32
    time_from_first: torch.Tensor  # [N, L] float32
    time_to_now: torch.Tensor      # [N, L] float32

    @property
    def n_rows(self) -> int:
        return self.users.shape[0]

    @property
    def seq_len(self) -> int:
        return self.item_hist.shape[1]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in dataclasses.astuple(self))


def resident_nbytes_estimate(n_rows: int, max_seq_length: int) -> int:
    """The upload's size, for the 'auto' placement decision."""
    per_row = 5 * 4 + max_seq_length * (2 * 4 + 3 * 4)
    return n_rows * per_row


def build_resident(view, device) -> ResidentDataset:
    """Upload a PaddedView's (or a bucket's) arrays to `device`."""
    L = view.item_hist.shape[1]
    host = dict(
        users=view.users.astype(np.int32),
        items=view.items.astype(np.int32),
        cates=view.cates.astype(np.int32),
        labels=view.labels.astype(np.float32),
        lengths=np.minimum(view.lengths, L).astype(np.int32),
        item_hist=view.item_hist, cate_hist=view.cate_hist,
        time_diff=view.time_diff, time_from_first=view.time_from_first,
        time_to_now=view.time_to_now)
    return ResidentDataset(**{
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in host.items()})


def gather_batch(res: ResidentDataset, idx: torch.Tensor,
                 valid: torch.Tensor) -> Batch:
    """Rows `idx` [B] as a Batch (G = 1), the mask derived from lengths.

    Rows where `valid` [B] (bool) is False (batch padding past the
    epoch's end) are zeros, so the batch equals the loader's zero-padded
    one bit for bit: their ids must not reach the lazy L2's unique rows,
    lazyadam's touched rows or the BN statistics."""
    L = res.seq_len
    v1, v2 = valid, valid[:, None]

    def take(t, keep):
        return t.index_select(0, idx).masked_fill(~keep, 0)

    lengths = take(res.lengths, v1)
    mask = (torch.arange(L, device=idx.device)[None, :]
            < lengths[:, None]).to(torch.float32)
    return Batch(
        users=take(res.users, v1),
        items=take(res.items, v1)[:, None],
        cates=take(res.cates, v1)[:, None],
        labels=take(res.labels, v1)[:, None],
        item_hist=take(res.item_hist, v2),
        cate_hist=take(res.cate_hist, v2),
        mask=mask,
        time_diff=take(res.time_diff, v2),
        time_from_first=take(res.time_from_first, v2),
        time_to_now=take(res.time_to_now, v2),
        valid=valid.to(torch.float32),
    )


def epoch_permutation(eligible: np.ndarray, np_rng: np.random.RandomState,
                      batch_size: int, steps_per_call: int,
                      min_batch_rows: int = 5
                      ) -> Tuple[np.ndarray, int, int, int]:
    """Shuffle the eligible row ids; the epoch's call layout.

    Returns (perm padded to whole batches, n_use, n_calls, n_tail).  A
    trailing batch of fewer than `min_batch_rows` real rows is dropped,
    as the reference does (sequential_iterator.py:338)."""
    perm = np_rng.permutation(eligible).astype(np.int32)
    n = _rows_used(len(perm), batch_size, min_batch_rows)
    n_batches = -(-n // batch_size) if n else 0
    n_calls = n_batches // steps_per_call
    n_tail = n_batches - n_calls * steps_per_call
    out = np.zeros(perm_length(len(perm), batch_size, min_batch_rows),
                   dtype=np.int32)
    out[:n] = perm[:n]
    return out, n, n_calls, n_tail


def _rows_used(n: int, batch_size: int, min_batch_rows: int) -> int:
    """n rows less a trailing batch of fewer than min_batch_rows."""
    rem = n % batch_size
    return n - rem if rem and rem < min_batch_rows else n


def perm_length(n_eligible: int, batch_size: int,
                min_batch_rows: int = 5) -> int:
    """The length of `epoch_permutation`'s padded permutation: whole
    batches, at least one; the same every epoch."""
    n = _rows_used(n_eligible, batch_size, min_batch_rows)
    return max(-(-n // batch_size) * batch_size, batch_size)


def _round_up8(x: int) -> int:
    return -(-int(x) // 8) * 8


def choose_bucket_edges(lengths: np.ndarray, L: int, min_rows: int = 1024,
                        max_buckets: int = 3,
                        min_gain: float = 1.10) -> List[int]:
    """Bucket paddings that minimise the executed recurrence steps,
    sum over buckets of rows_b * Lb, by brute force over 1-3 buckets at
    multiples of 8 (clsr_tpu/data/resident.py:156-221), subject to:

      * strict edges: a bucket padded to Lb holds rows of clamped length
        <= Lb - 1, so column Lb - 1 stays padding (and time_to_now[:, -1]
        stays 0), the top bucket too, whose Lb may fall below L when no
        row fills L;
      * every bucket but the top holds >= min_rows rows;
      * each extra bucket must cut the cost by >= min_gain x.

    Returns the ascending paddings [L1, ..., Ltop], Ltop <= L."""
    tl = np.minimum(np.asarray(lengths), L).astype(np.int64)
    if len(tl) == 0:
        return [L]
    max_tl = int(tl.max())
    top = L if max_tl >= L else min(L, _round_up8(max_tl + 1))
    cum_rows = np.cumsum(np.bincount(tl, minlength=L + 1).astype(np.int64))

    def cost(edges):
        total, prev = 0, -1
        for e in edges:
            hi = e - 1 if e < top else top
            rows = int(cum_rows[min(hi, L)]
                       - (cum_rows[prev] if prev >= 0 else 0))
            if e < top and rows < min_rows:
                return None
            total += rows * e
            prev = min(hi, L)
        return total

    cands = list(range(8, top, 8))
    best, best_cost = [top], cost([top])
    for k in range(1, max_buckets):
        improved = None
        for combo in itertools.combinations(cands, k):
            c = cost(list(combo) + [top])
            if c is not None and (improved is None or c < improved[0]):
                improved = (c, list(combo) + [top])
        if improved is None or best_cost / improved[0] < min_gain:
            break
        best_cost, best = improved
    return best


def bucket_rows(lengths: np.ndarray, L: int, paddings: List[int]):
    """[(Lb, row ids)] by clamped length: the bucket padded to Lb holds
    lengths [previous edge, Lb - 1], the top one everything up to L;
    empty buckets dropped."""
    tl = np.minimum(np.asarray(lengths), L).astype(np.int64)
    out = []
    prev = 0
    for i, e in enumerate(paddings):
        hi = L if i == len(paddings) - 1 else e - 1
        rows = np.flatnonzero((tl >= prev) & (tl <= hi))
        if len(rows):
            out.append((int(e), rows))
        prev = hi + 1
    return out


_FIELDS = ("users", "items", "cates", "labels", "lengths", "item_hist",
           "cate_hist", "time_diff", "time_from_first", "time_to_now")


class _SubView:
    """Rows of a PaddedView, its history columns cut to Lb."""

    def __init__(self, view, rows: np.ndarray, Lb: int):
        for f in _FIELDS:
            x = getattr(view, f)[rows]
            setattr(self, f, x[:, :Lb] if x.ndim == 2 else x)


class _PadRows:
    """A view with its row count rounded up to a multiple by all-zero
    rows (length 0: never eligible, never gathered)."""

    def __init__(self, view, multiple: int):
        r = (-len(view.users)) % multiple
        for f in _FIELDS:
            x = np.asarray(getattr(view, f))
            if r:
                x = np.concatenate([x, np.zeros((r,) + x.shape[1:],
                                                x.dtype)])
            setattr(self, f, x)


def pad_view_rows(view, multiple: int):
    """`view` with its rows rounded up to `multiple` (cfg.
    resident_round_rows), or itself for 0 and 1."""
    if multiple and multiple > 1:
        return _PadRows(view, multiple)
    return view


def resolve_bucket_paddings(cfg, lengths: np.ndarray) -> List[int]:
    """cfg.length_buckets -> ascending bucket paddings, [] for off."""
    lb = getattr(cfg, "length_buckets", "off")
    L = cfg.max_seq_length
    if lb == "off":
        return []
    if lb == "auto":
        pads = choose_bucket_edges(lengths, L,
                                   min_rows=max(1024, 2 * cfg.batch_size))
        return pads if len(pads) > 1 or pads[0] < L else []
    edges = [int(e) for e in lb.split(",")]
    tl = np.minimum(np.asarray(lengths), L)
    max_tl = int(tl.max()) if len(tl) else L
    top = L if max_tl >= L else min(L, _round_up8(max_tl + 1))
    return [e for e in edges if e < top] + [top]


def build_resident_buckets(view, paddings: List[int], device,
                           round_rows: int = 0, mesh=None):
    """[(ResidentDataset padded to Lb, dataset row ids)] a bucket; the
    ids map a bucket's local rows back to the dataset's.  Short rows
    store Lb columns, so the buckets take less memory than one upload.
    With a mesh each bucket is row-sharded (`build_resident_mesh`)."""
    out = []
    for Lb, rows in bucket_rows(view.lengths, view.item_hist.shape[1],
                                paddings):
        sub = pad_view_rows(_SubView(view, rows, Lb), round_rows)
        out.append((build_resident(sub, device) if mesh is None
                    else build_resident_mesh(sub, mesh, device), rows))
    return out


def build_resident_mesh(view, mesh, device) -> ResidentDataset:
    """This rank's block of the view's rows, zero-padded to a multiple of
    the batch shards (JAX :346-386): rank k of the batch shards holds
    rows [k R, (k + 1) R).  The epoch permutation indexes real rows only,
    so no padding row is ever gathered."""
    padded = _PadRows(view, mesh.n_batch)
    R = len(padded.users) // mesh.n_batch
    k = mesh.batch_index
    return build_resident(_SubView(padded, np.arange(k * R, (k + 1) * R),
                                   view.item_hist.shape[1]), device)


_WIRE_FIELDS = ("users", "items", "cates", "labels", "item_hist",
                "cate_hist", "mask", "time_diff", "time_from_first",
                "time_to_now")


def gather_batch_mesh(res: ResidentDataset, idx: torch.Tensor,
                      valid: torch.Tensor, mesh) -> Batch:
    """This rank's [B/n] block of the batch at global rows `idx` [B]
    (valid [B] bool) from the rank's block `res` of a row-sharded
    dataset (JAX :389-442): the rows it holds gathered, the others
    zero, then one reduce_scatter over the batch group."""
    n = mesh.n_batch
    B = idx.shape[0]
    if B % n:
        raise ValueError(f"batch {B} not divisible by {n} batch shards")
    k, b = mesh.batch_index, B // n
    loc = idx - k * res.n_rows
    ok = (loc >= 0) & (loc < res.n_rows)
    part = gather_batch(res, torch.where(ok, loc, torch.zeros_like(loc)),
                        valid & ok)
    cols = [getattr(part, f) for f in _WIRE_FIELDS]
    wire = torch.cat([c.reshape(B, -1).view(torch.int32) for c in cols], 1)
    got = col.reduce_scatter(wire.reshape(n, b, -1), mesh.batch_group)
    out, at = {}, 0
    for f, c in zip(_WIRE_FIELDS, cols):
        w = c.reshape(B, -1).shape[1]
        out[f] = got[:, at:at + w].contiguous().view(c.dtype).reshape(
            (b,) + tuple(c.shape[1:]))
        at += w
    return Batch(**out, valid=valid[k * b:(k + 1) * b].to(torch.float32))


class EpochFeed:
    """What a resident call reads: a dataset, the epoch permutation
    (`perm`, padded to whole batches), its used length (`n_rows`) and the
    offset of the next step's first row (`offset`), all on the
    dataset's device.  A new epoch writes `perm` and `n_rows` in place
    (`set_epoch`) and a call sets `offset` with one fill, so a captured
    step that reads them stays valid; a step advances `offset` by B.
    With a mesh, `res` is the rank's block and `batch` returns the
    rank's share (`gather_batch_mesh`)."""

    def __init__(self, res: ResidentDataset, perm_len: int, mesh=None):
        device = res.users.device
        self.res = res
        self.mesh = mesh
        self.perm = torch.zeros(perm_len, dtype=torch.int64, device=device)
        self.n_rows = torch.zeros((), dtype=torch.int64, device=device)
        self.offset = torch.zeros((), dtype=torch.int64, device=device)

    def set_epoch(self, perm: np.ndarray, n_use: int) -> None:
        if len(perm) != self.perm.shape[0]:
            raise ValueError(f"an epoch permutation of {len(perm)} rows, "
                             f"the feed holds {self.perm.shape[0]}")
        self.perm.copy_(torch.from_numpy(perm.astype(np.int64)))
        self.n_rows.fill_(n_use)

    def batch(self, batch_size: int) -> Batch:
        """The batch at `offset` (rows perm[offset : offset + B], those
        at or past n_rows zeroed), then offset += B."""
        pos = self.offset + torch.arange(batch_size,
                                         device=self.perm.device)
        idx = self.perm.index_select(0, pos)
        batch = (gather_batch(self.res, idx, pos < self.n_rows)
                 if self.mesh is None else
                 gather_batch_mesh(self.res, idx, pos < self.n_rows,
                                   self.mesh))
        self.offset.add_(batch_size)
        return batch
