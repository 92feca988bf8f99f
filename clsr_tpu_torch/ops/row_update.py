"""K5 and K4: set sorted rows of [N, W] tables, in place.

Both kernels compute one function, the last write of the LazyAdam row
update (clsr_tpu/training/lazy_adam.py:191-192, 315-322, the scatter-set
`mn.at[tgt].set(rows, mode="drop", indices_are_sorted=True,
unique_indices=True)`):

    table[ids[j], :] = rows[j, :]  for every j with 0 <= ids[j] < N

and every other id is dropped.  The ids are int32 and sorted; unique on
the compact path, and on the legacy path duplicates carry identical rows.

  * `scatter_rows_group` (K5, `clsr_row_scatter_group` in
    csrc/row_update.cu) replaces scripts/bench_pallas_update.py:
    rowdma_kernel (:239, call :282): one launch writes up to MAX_GROUP
    (table, ids, rows) entries, f32 or bf16 (each entry's table and rows
    of one type; a lazy step mixes bf16 tables with f32 optimizer rows),
    each row's 16-byte units (else its elements) spread over threads,
    O(M) bytes.  A lazy train step hands it every scatter-set of
    the step at once, so it launches K5 once.  `scatter_rows` is the
    one-entry case.  Dropped ids stay on the device: the kernel drops
    them itself, so the step issues no host sync.
  * `sweep_rows` (K4, `clsr_row_sweep`) replaces
    scripts/bench_pallas_update.py:kernel (:143, call :203), the
    streaming sweep: one block per slab of `block` table rows finds the
    slab's segment of the sorted ids itself and writes those rows; the
    table stays where it is.  It runs on the bench entry point
    (clsr_tpu_torch.bench_row_update), f32 only.

Both are bound by the function's bytes: the ids, the rows read, the valid
rows written.  Each wrapper computes its plain PyTorch version for CPU
tensors (`scatter_rows_reference`, `scatter_rows_group_reference`,
`sweep_rows_reference`: index assignment on the ids a mask keeps, which
syncs once on the mask), and for CUDA tensors launches its kernel or
raises.  The CUDA path keeps its host cost small: one pass of checks
that also gathers the C arguments, the bound C function cached, every
argument packed into one int64 array (one pointer for ctypes to pass),
the raw stream pointer, and the device switched in C only when it is not
the current one.
`scatter_rows.launches` counts every K5 launch, `sweep_rows.launches`
every K4 launch.
"""

from __future__ import annotations

import itertools
import struct
from typing import List, Optional, Sequence, Tuple

import torch

from clsr_tpu_torch.ops import _build

MAX_GROUP = 16          # entries per K5 launch (kMaxEntries in the source)
_INT_MAX = 2 ** 31 - 1
# the C arguments of a K5 launch of k entries: count, device, stream,
# then 7 int64s an entry (table, N, W, ids, M, rows, element size); of K4:
# one entry's first 6, then block, device, stream
_ENTRY_ARGS = 7
_GROUP_ARGS = [struct.Struct(f"{3 + _ENTRY_ARGS * k}q")
               for k in range(MAX_GROUP + 1)]
K5_DTYPES = (torch.float32, torch.bfloat16)
_SWEEP_ARGS = struct.Struct("9q")
Entry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# PyTorch's current stream on a device as a raw pointer; the private
# binding skips building a torch.cuda.Stream object per launch
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)
_bound = {}             # C function name -> the bound function


def _c_function(name: str):
    fn = _bound.get(name)
    if fn is None:
        fn = _bound[name] = getattr(_build.load("row_update"), name)
    return fn


def _scan(entries: Sequence[Entry], dtypes=K5_DTYPES
          ) -> Tuple[Optional[int], List[int]]:
    """One pass over the entries: raise unless each is (table [N, W],
    ids [M] int32, rows [M, W]) with table and rows of one of `dtypes`,
    each contiguous, all on one device, no two tables overlapping in
    memory, and within the kernels' int32 indexing.  Return the device's
    index (-1 for the CPU, None for no entries) and the C arguments of
    the entries with work, seven a entry (table, N, W, ids, M, rows,
    element size), in one list."""
    index, args, spans = None, [], []
    for table, ids, rows in entries:
        if ids.dtype != torch.int32:
            raise TypeError(f"ids must be int32, got {ids.dtype}")
        if table.dtype != rows.dtype or table.dtype not in dtypes:
            raise TypeError(f"table and rows must be one of {dtypes}, of "
                            f"one type; got {table.dtype} and {rows.dtype}")
        t_shape, i_shape = table.shape, ids.shape
        if (len(t_shape) != 2 or len(i_shape) != 1
                or rows.shape != (i_shape[0], t_shape[1])):
            raise ValueError(
                f"want table [N, W], ids [M], rows [M, W]; got "
                f"{tuple(t_shape)}, {tuple(i_shape)}, {tuple(rows.shape)}")
        if not (table.is_contiguous() and ids.is_contiguous()
                and rows.is_contiguous()):
            raise ValueError("table, ids and rows must be contiguous")
        dev = table.get_device()
        if index is None:
            index = dev
        if dev != index or ids.get_device() != dev or rows.get_device() \
                != dev:
            raise ValueError(f"entries span devices: table on "
                             f"{table.device}, ids on {ids.device}, rows "
                             f"on {rows.device}")
        (N, W), M = t_shape, i_shape[0]
        if N and W:
            start, esize = table.data_ptr(), table.element_size()
            spans.append((start, start + esize * N * W))
            if M:
                if N > _INT_MAX or M * W > _INT_MAX:
                    raise ValueError(f"table {N} x {W} with {M} ids is past "
                                     f"the kernels' int32 indexing")
                args += (start, N, W, ids.data_ptr(), M, rows.data_ptr(),
                         esize)
    if len(spans) > 1:
        spans.sort()
        for (_, end), (start, _) in zip(spans, spans[1:]):
            if start < end:
                raise ValueError("two entries share one table: one launch "
                                 "gives their writes no order")
    return index, args


def _require_cpu(entries: Sequence[Entry]) -> None:
    """Raise unless every tensor lies on the CPU (where the plain version
    runs): a device that is neither CUDA nor the CPU has no kernel."""
    for t in itertools.chain.from_iterable(entries):
        if t.device.type != "cpu":
            raise ValueError(f"no kernel for device {t.device}")


@torch.no_grad()
def scatter_rows_reference(table: torch.Tensor, ids: torch.Tensor,
                           rows: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: table[ids] = rows on the ids in [0, N)."""
    keep = (ids >= 0) & (ids < table.shape[0])
    table[ids[keep].long()] = rows[keep]
    return table


def scatter_rows_group_reference(entries: Sequence[Entry]) -> None:
    """Plain version of a K5 group: `scatter_rows_reference` on each
    entry in turn."""
    for table, ids, rows in entries:
        scatter_rows_reference(table, ids, rows)


def slab_starts(ids: torch.Tensor, n_rows: int, block: int) -> torch.Tensor:
    """starts[b] = the first j with ids[j] >= b * block, for b = 0 .. NB
    (NB = ceil(n_rows / block) slabs): slab b's ids are
    ids[starts[b]:starts[b + 1]].  int32 [NB + 1], on ids' device."""
    n_slabs = -(-n_rows // block)
    bounds = torch.arange(n_slabs + 1, device=ids.device,
                          dtype=torch.int64) * block
    return torch.searchsorted(ids.to(torch.int64), bounds, out_int32=True)


@torch.no_grad()
def sweep_rows_reference(table: torch.Tensor, ids: torch.Tensor,
                         rows: torch.Tensor, block: int) -> torch.Tensor:
    """Plain version of K4: the rows of each slab's id segment (from
    `slab_starts`) whose id is below N."""
    starts = slab_starts(ids, table.shape[0], block)
    j = torch.arange(ids.shape[0], device=ids.device)
    keep = (j >= starts[0]) & (j < starts[-1]) & (ids < table.shape[0])
    table[ids[keep].long()] = rows[keep]
    return table


def scatter_rows_group(entries: Sequence[Entry]) -> None:
    """K5: table[ids] = rows for every (table [N, W], ids [M] int32
    sorted, rows [M, W] of the table's type, f32 or bf16) entry, in
    place, ids outside [0, N) dropped; one launch per MAX_GROUP entries
    that have work.  No two entries may share a table."""
    index, args = _scan(entries)
    if index is None:
        return
    if index < 0:
        _require_cpu(entries)
        scatter_rows_group_reference(entries)
        return
    fn = _c_function("clsr_row_scatter_group")
    stream = _raw_stream(index)
    for i in range(0, len(args), _ENTRY_ARGS * MAX_GROUP):
        part = args[i:i + _ENTRY_ARGS * MAX_GROUP]
        count = len(part) // _ENTRY_ARGS
        _build.check(fn(_GROUP_ARGS[count].pack(count, index, stream, *part)),
                     "row_scatter")
        scatter_rows.launches += 1


def scatter_rows(table: torch.Tensor, ids: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """K5 on one table: table [N, W] f32 or bf16, ids [M] int32 sorted,
    rows [M, W] of the table's type -> table, updated in place (ids
    outside [0, N) dropped)."""
    scatter_rows_group(((table, ids, rows),))
    return table


scatter_rows.launches = 0


def sweep_rows(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor,
               block: int = 2048) -> torch.Tensor:
    """K4: the same function as `scatter_rows` on an f32 table, by one
    block per slab of `block` table rows, in place."""
    entry = ((table, ids, rows),)
    index, args = _scan(entry, (torch.float32,))
    if block <= 0:
        raise ValueError(f"block must be positive, got {block}")
    if index < 0:
        _require_cpu(entry)
        return sweep_rows_reference(table, ids, rows, block)
    if args:
        _build.check(_c_function("clsr_row_sweep")(_SWEEP_ARGS.pack(
            *args[:6], block, index, _raw_stream(index))), "row_sweep")
        sweep_rows.launches += 1
    return table


sweep_rows.launches = 0
