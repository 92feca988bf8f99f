"""Physical row layout of model-sharded embedding tables.

Counterpart of clsr_tpu/parallel/rowmap.py.  A table of N logical rows
row-sharded over the mesh's m model ranks keeps N/m rows on each rank:

  contiguous   rank j holds logical rows [j*N/m, (j+1)*N/m)
               (owner = id // rows, local = id - owner*rows)
  interleaved  rank j holds logical rows {i : i % m == j} at local
               position i // m (owner = id % m, local = id // m)

Contiguous is the default under the broadcast merge; interleaved is
the default under the owner-routed merge (`mesh_row_layout: auto`),
where it spreads a frequency-ordered vocab's hot rows over the owners'
buckets, and runs under either merge when `mesh_row_layout:
interleaved` asks for it.  Checkpoints hold
the LOGICAL (id-ordered) layout on every topology (training/trainer.py).

Every function takes numpy arrays or torch tensors.
"""

from __future__ import annotations


def resolve_interleaved(cfg) -> bool:
    """The layout rule of config `mesh_row_layout`: 'auto' interleaves
    exactly when the owner-routed merge is active."""
    if cfg is None:
        return False
    layout = getattr(cfg, "mesh_row_layout", "auto")
    if layout == "interleaved":
        return True
    if layout == "contiguous":
        return False
    return getattr(cfg, "mesh_update_routing", "broadcast") == "owner"


def owner_local(ids, m: int, rows: int, interleaved: bool):
    """(owner rank, local row) of logical row ids for an m-way sharded
    [m*rows, D] table.  Ids outside [0, m*rows) must be rejected by the
    caller (interleaved: id % m alone cannot reject them)."""
    if interleaved:
        return ids % m, ids // m
    owner = ids // rows
    return owner, ids - owner * rows


def _swap(x, a: int, b: int):
    """x [N, ...] -> reshape (a, b, ...) with the two axes swapped."""
    return x.reshape((a, b) + tuple(x.shape[1:])).swapaxes(0, 1).reshape(
        tuple(x.shape))


def interleave_rows(x, m: int):
    """Logical -> physical: row i moves to (i % m) * (N // m) + i // m, so
    block j of the result holds rank j's rows."""
    n = x.shape[0]
    if m <= 1 or n % m:
        return x
    return _swap(x, n // m, m)


def deinterleave_rows(x, m: int):
    """Physical -> logical (the inverse of interleave_rows)."""
    n = x.shape[0]
    if m <= 1 or n % m:
        return x
    return _swap(x, m, n // m)


def shard_block(x, m: int, j: int, interleaved: bool):
    """Rank j's [N/m, ...] block of a logical [N, ...] table."""
    rows = x.shape[0] // m
    if interleaved:
        return x[j::m]
    return x[j * rows:(j + 1) * rows]
