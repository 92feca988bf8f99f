"""Lookups in row-sharded embedding tables.

Counterpart of clsr_tpu/parallel/embedding.py: a table row-sharded over
the mesh's model row (parallel/mesh.py `place_model`) is looked up with
explicit collectives, never a full-table gather:

  * replicated batch (`mesh_flat_batch` off; :119-127): the model ranks
    of a data index hold the same ids; each gathers the rows it owns
    (zeros elsewhere) and one all_reduce over the model row sums them;
  * flat batch (:130-146): each rank holds ids of its own; the model
    row all_gathers its m id blocks (4 bytes an id), each rank gathers
    its owned rows of all m blocks, and one reduce_scatter hands each
    rank its own block's rows.

`gather_rows` is a `torch.autograd.Function` whose backward writes only
the rows the rank owns, through the port's fixed-order
`ops.segment_sum.table_grad` (a repeated row's cotangents summed in
sorted order, the same bits every call): replicated, the cotangent of
the all_reduce is the rank's own (the model ranks hold identical
activations, so summing it over the model row would count the table
gradient m times); flat, the cotangents of the m blocks are
all_gathered over the model row first.  The gradient is the rank's
block of the gradient of its batch shard; summing it over the data
column (training/steps.py) gives the global gradient.  Under
inference mode (eval, serving) no graph is kept.

`gather_rows` keeps no replicated-id twin (JAX's
`gather_rows_replicated`, :173-190): the port's lazy L2 and
discrepancy sums count each globally unique row once on the rank that
holds its first occurrence (`global_first`), so every lookup is a
batch-sharded one.  `global_first(ids, mesh)` is that mask: the batch
shards' ids are all_gathered over the batch group, stably sorted in
shard-major order, and a rank keeps the mask of its own block.
"""

from __future__ import annotations

import torch

from clsr_tpu_torch.ops.segment_sum import table_grad
from clsr_tpu_torch.parallel import collectives as col
from clsr_tpu_torch.parallel.mesh import Mesh
from clsr_tpu_torch.parallel.rowmap import owner_local


def owned_rows(ids: torch.Tensor, mesh: Mesh, rows: int):
    """(local rows clamped into the block, owned-here mask) of logical ids
    against this rank's [rows, D] block."""
    m = mesh.n_model
    owner, loc = owner_local(ids, m, rows, mesh.interleaved)
    ok = (owner == mesh.model_index) & (ids >= 0) & (ids < m * rows)
    return torch.clamp(loc, 0, rows - 1), ok


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, ids, mesh):
        rows, D = table.shape
        flat_ids = ids.reshape(-1)
        n = flat_ids.shape[0]
        if mesh.flat:
            flat_ids = col.all_gather(flat_ids, mesh.model_group).reshape(-1)
        loc, ok = owned_rows(flat_ids, mesh, rows)
        vals = torch.where(ok[:, None], table.index_select(0, loc),
                           torch.zeros((), dtype=table.dtype,
                                       device=table.device))
        if mesh.flat:
            out = col.reduce_scatter(vals.reshape(mesh.n_model, n, D),
                                     mesh.model_group)
        else:
            out = col.all_reduce(vals, mesh.model_group)
        ctx.mesh, ctx.rows = mesh, rows
        # rows the rank does not own go to the sink row `rows`
        ctx.save_for_backward(torch.where(ok, loc, rows))
        return out.reshape(tuple(ids.shape) + (D,))

    @staticmethod
    def backward(ctx, g):
        (tgt,) = ctx.saved_tensors
        mesh = ctx.mesh
        g = g.reshape(-1, g.shape[-1]).contiguous()
        if mesh.flat:
            g = col.all_gather(g, mesh.model_group).reshape(-1, g.shape[-1])
        return table_grad(tgt, g, ctx.rows), None, None


def gather_rows(table: torch.Tensor, ids: torch.Tensor, mesh: Mesh
                ) -> torch.Tensor:
    """table[ids] ([*ids.shape, D]) for this rank's block `table` of a
    row-sharded table and batch-leading ids of this rank's shard."""
    return _GatherRows.apply(table, ids, mesh)


def global_first(ids: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[n] bool for this rank's flat ids [n]: the id's first occurrence
    in the shard-major concatenation of every batch shard's ids, so each
    globally unique id is marked once, on one rank."""
    n = ids.shape[0]
    flat = col.all_gather(ids.contiguous(), mesh.batch_group).reshape(-1)
    perm = torch.argsort(flat, stable=True)
    s = flat.index_select(0, perm)
    first_sorted = torch.ones_like(s, dtype=torch.bool)
    first_sorted[1:] = s[1:] != s[:-1]
    first = torch.empty_like(first_sorted)
    first[perm] = first_sorted
    k = mesh.batch_index
    return first[k * n:(k + 1) * n]
