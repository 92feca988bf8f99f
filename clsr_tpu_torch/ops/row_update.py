"""K5 and K4: set sorted rows of an [N, W] table, in place.

Both kernels compute one function, the last write of the LazyAdam row
update (clsr_tpu/training/lazy_adam.py:191-192, 315-322, the scatter-set
`mn.at[tgt].set(rows, mode="drop", indices_are_sorted=True,
unique_indices=True)`):

    table[ids[j], :] = rows[j, :]  for every j with 0 <= ids[j] < N

and every other id is dropped.  The ids are int32 and sorted; unique on
the compact path, and on the legacy path duplicates carry identical rows.

  * `scatter_rows` (K5, `clsr_row_scatter` in csrc/row_update.cu) replaces
    scripts/bench_pallas_update.py:rowdma_kernel (:239, call :282): one
    row copy per id, O(M) bytes.  Every scatter-set of both LazyAdam paths
    goes through it.  The tail of dropped ids stays on the device: the
    kernel drops them itself, so the step issues no host sync.
  * `sweep_rows` (K4, `clsr_row_sweep`) replaces
    scripts/bench_pallas_update.py:kernel (:143, call :203), the streaming
    sweep: one block per slab of `block` table rows copies the slab and
    overwrites the rows whose ids fall in it.  It moves the whole table,
    O(N) bytes where K5 moves O(M), so the update path takes K5 and the
    sweep runs on the bench entry point (clsr_tpu_torch.bench_row_update).

Both are bound by the function's bytes (the ids, the rows read, the valid
rows written); K4's own traffic is the table.  Each wrapper computes its plain PyTorch version
for CPU tensors (`scatter_rows_reference`, `sweep_rows_reference`: index
assignment on the ids a mask keeps, which syncs once on the mask), and for
CUDA tensors launches its kernel or raises.  `<wrapper>.launches` counts
kernel launches.
"""

from __future__ import annotations

import torch

from clsr_tpu_torch.ops import _build


def _check(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor
           ) -> None:
    """Raise unless table [N, W] and rows [M, W] are contiguous f32 and
    ids [M] contiguous int32, all on one device."""
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous vector")
    if ids.device != table.device:
        raise ValueError(f"ids are on {ids.device}, table on {table.device}")
    if table.dim() != 2:
        raise ValueError(f"table must be [N, W], got {tuple(table.shape)}")
    W = table.shape[1]
    _build.check_args(("table", "rows"), (table, rows),
                      (tuple(table.shape), (ids.shape[0], W)), table.device)


def _vec(W: int, *tensors: torch.Tensor) -> int:
    """1 if the kernels may copy 16 bytes a thread: W % 4 == 0 and every
    base pointer 16-byte aligned."""
    return int(W % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def slab_starts(ids: torch.Tensor, n_rows: int, block: int) -> torch.Tensor:
    """starts[b] = the first j with ids[j] >= b * block, for b = 0 .. NB
    (NB = ceil(n_rows / block) slabs): slab b's ids are
    ids[starts[b]:starts[b + 1]].  int32 [NB + 1], on ids' device."""
    n_slabs = -(-n_rows // block)
    bounds = torch.arange(n_slabs + 1, device=ids.device,
                          dtype=torch.int64) * block
    return torch.searchsorted(ids.to(torch.int64), bounds, out_int32=True)


@torch.no_grad()
def scatter_rows_reference(table: torch.Tensor, ids: torch.Tensor,
                           rows: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: table[ids] = rows on the ids in [0, N)."""
    keep = (ids >= 0) & (ids < table.shape[0])
    table[ids[keep].long()] = rows[keep]
    return table


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


def _stream():
    return torch.cuda.current_stream().cuda_stream


@torch.no_grad()
def scatter_rows(table: torch.Tensor, ids: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """K5: table [N, W] f32, ids [M] int32 sorted, rows [M, W] f32 ->
    table, updated in place (ids outside [0, N) dropped)."""
    _check(table, ids, rows)
    if table.device.type == "cpu":
        return scatter_rows_reference(table, ids, rows)
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for device {table.device}")
    N, W = table.shape
    M = ids.shape[0]
    if M == 0 or N == 0 or W == 0:
        return table
    lib = _build.load("row_update")
    with torch.cuda.device(table.device):
        rc = lib.clsr_row_scatter(table.data_ptr(), N, W, ids.data_ptr(), M,
                                  rows.data_ptr(), _vec(W, table, rows),
                                  _stream())
    _build.check(rc, "row_scatter")
    scatter_rows.launches += 1
    return table


scatter_rows.launches = 0


@torch.no_grad()
def sweep_rows(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor,
               block: int = 2048) -> torch.Tensor:
    """K4: the same function as `scatter_rows`, by a sweep over slabs of
    `block` table rows, in place."""
    _check(table, ids, rows)
    if block <= 0:
        raise ValueError(f"block must be positive, got {block}")
    if table.device.type == "cpu":
        return sweep_rows_reference(table, ids, rows, block)
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for device {table.device}")
    N, W = table.shape
    if N == 0 or W == 0:
        return table
    starts = slab_starts(ids, N, block)
    lib = _build.load("row_update")
    with torch.cuda.device(table.device):
        rc = lib.clsr_row_sweep(table.data_ptr(), table.data_ptr(), N, W,
                                ids.data_ptr(), starts.data_ptr(),
                                rows.data_ptr(), block, _vec(W, table, rows),
                                _stream())
    _build.check(rc, "row_sweep")
    sweep_rows.launches += 1
    return table


sweep_rows.launches = 0
