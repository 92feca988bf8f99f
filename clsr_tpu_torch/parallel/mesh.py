"""The (data, model) mesh of ranks, and what lives where on it.

Counterpart of clsr_tpu/parallel/mesh.py.  JAX's mesh is one program
over a device grid, and GSPMD makes every global quantity global; here
each rank is a process (parallel/distributed.py) that holds its share,
and the mesh makes every global quantity explicit:

  * `Mesh`: the rank grid, data-major (rank = i * n_model + j, as JAX
    reshapes its devices to (n_data, n_model)), with one process group
    per data column (the ranks of one model index j, over which a
    replicated batch is split), per model row (the ranks of one data
    index i, over which tables are row-sharded) and over every rank.
    The batch group is the world under `mesh_flat_batch` (the batch
    split over both axes) and the data column otherwise; `n_batch` and
    `batch_index` say how many batch shards there are and which one this
    rank holds.  The ranks of one model row then hold the same rows of a
    replicated batch and compute the same activations.
  * `resolve_flat_batch(cfg, pads_rows)` is JAX's rule (:47-59).
  * `use_mesh(mesh)` makes a mesh active for the calls inside it (the
    step builders below install it); the lookups, BN statistics,
    dropout masks, negatives and losses read `active_mesh()`.
  * `place_model(model, mesh)` (JAX's `place_state`, :90-167, for the
    port's state, whose optimizer is built after placement): each rank
    keeps its row block of every `*_embedding` table whose row count
    divides n_model (parallel/rowmap.py's layout), marked with its
    logical row count (`mesh_rows`); every other parameter and buffer
    is replicated.  The optimizer rows (pmn, Adam moments) are then
    made from the blocks, so they are blocks too.
  * `shard_rows` / `shard_batch` cut this rank's rows of a global
    batch; `gather_rows_of` puts the batch shards' outputs back in
    order.
  * `logical_tensor` / `local_tensor` move a row-sharded tensor between
    its block and the logical [N, ...] table (a checkpoint's layout);
    `logical_table` is `logical_tensor` with a backward, for a model
    that reads a whole table (LGN's propagation, models/lgn.py): its
    backward hands each rank its block of the logical gradient, summed
    over the model row under a flat batch (the row's ranks hold other
    rows of the batch) and the rank's own under a replicated one (the
    row's ranks compute the same gradient), as `gather_rows`' backward
    does (parallel/embedding.py); the step then sums the block over the
    data column as every table's (training/steps.py `reduce_grads`).
  * the sharded builders (JAX :170-305): training/steps.py's
    `make_train_step(model, cfg, mesh)` and `make_multi_train_step(...,
    mesh)` take this rank's share of the batch (K steps a call: CUDA
    graph replays on every rank when the backend is nccl, whose
    collectives run on the card's stream; eager steps under gloo, whose
    host-staged collectives a graph cannot capture);
    `make_sharded_eval_step` takes the global batch (padded to a
    multiple of n_batch, JAX trainer.py:69-82) and returns the global
    predictions.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Iterator, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from clsr_tpu_torch.config import Config
from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.parallel import collectives as col
from clsr_tpu_torch.parallel.distributed import host_batch_slice
from clsr_tpu_torch.parallel.rowmap import (deinterleave_rows,
                                            interleave_rows,
                                            resolve_interleaved,
                                            shard_block)


@dataclasses.dataclass
class Mesh:
    n_data: int
    n_model: int
    rank: int
    flat: bool                  # the batch over both axes
    interleaved: bool           # the tables' row layout
    world: Any                  # process groups
    data_group: Any
    model_group: Any

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def batch_group(self):
        return self.world if self.flat else self.data_group

    @property
    def n_batch(self) -> int:
        return self.n_data * (self.n_model if self.flat else 1)

    @property
    def batch_index(self) -> int:
        return self.rank if self.flat else self.data_index

    def sharded(self, n_rows: int) -> bool:
        """Whether a table of n_rows logical rows is row-sharded."""
        return self.n_model > 1 and n_rows % self.n_model == 0


def mesh_size(cfg: Config) -> int:
    return cfg.data_parallel * cfg.model_parallel


def resolve_flat_batch(cfg: Config, pads_rows: bool = False) -> bool:
    """The flat-batch rule of config `mesh_flat_batch`: 'on' forces it,
    'auto' turns it on when tables are sharded (model_parallel > 1) and
    the batch rows divide d*m, or the caller pads rows to a multiple
    itself (serving: pads_rows)."""
    if cfg.mesh_flat_batch == "off":
        return False
    if cfg.mesh_flat_batch == "on":
        return True
    return cfg.model_parallel > 1 and (
        pads_rows or cfg.batch_size % mesh_size(cfg) == 0)


# the process groups of each (d, m) grid of a world, made once: new_group
# is a collective every rank must call in one order
_groups = {}


def make_mesh(cfg: Config, pads_rows: bool = False) -> Mesh:
    """The mesh of cfg.data_parallel x cfg.model_parallel ranks over the
    process group this process joined (parallel/distributed.py); every
    rank must call it, in the same order as its other group calls."""
    n = mesh_size(cfg)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of {cfg.data_parallel} x {cfg.model_parallel} ranks "
            f"needs a torch.distributed process group: run under torchrun "
            f"or spawn the ranks with parallel.distributed.run_local_world")
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {cfg.data_parallel} x {cfg.model_parallel} "
                         f"!= {dist.get_world_size()} ranks")
    d, m = cfg.data_parallel, cfg.model_parallel
    key = (d, m, id(dist.group.WORLD))
    if key not in _groups:          # made once: new_group is collective
        _groups[key] = (
            [dist.new_group([i * m + j for i in range(d)])
             for j in range(m)],
            [dist.new_group([i * m + j for j in range(m)])
             for i in range(d)])
        for name, groups in zip(("data", "model"), _groups[key]):
            for g in groups:
                col.label_group(g, name)
        col.label_group(dist.group.WORLD, "world")
    data_groups, model_groups = _groups[key]
    rank = dist.get_rank()
    return Mesh(n_data=d, n_model=m, rank=rank,
                flat=resolve_flat_batch(cfg, pads_rows),
                interleaved=resolve_interleaved(cfg) and m > 1,
                world=dist.group.WORLD, data_group=data_groups[rank % m],
                model_group=model_groups[rank // m])


# the active meshes, innermost last: module-level, not thread-local, so
# that autograd's device threads see the mesh in the backward
_active: List[Mesh] = []


def active_mesh() -> Optional[Mesh]:
    return _active[-1] if _active else None


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[None]:
    """Make `mesh` active for the calls inside (None: no mesh)."""
    _active.append(mesh)
    try:
        yield
    finally:
        _active.pop()


# -------------------------------------------------------- batch totals


def batch_total(x: torch.Tensor) -> torch.Tensor:
    """x summed over the active mesh's batch shards, without gradient
    (counts, denominators); x itself without a mesh."""
    mesh = active_mesh()
    if mesh is None:
        return x
    return col.all_reduce(x.detach(), mesh.batch_group)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the batch shards, differentiable (the backward sums
    the shards' cotangents); x itself without a mesh."""
    mesh = active_mesh()
    if mesh is None:
        return x
    return col.all_reduce_grad(x, mesh.batch_group)


def batch_share(x: torch.Tensor) -> torch.Tensor:
    """A replicated term's share of this rank's loss: x on the first
    batch shard, 0 on the others, so the shares sum to x once."""
    mesh = active_mesh()
    if mesh is None or mesh.batch_index == 0:
        return x
    return x * 0.0


def global_rows(local_rows: int) -> int:
    """The global batch's rows, from a shard's (equal shards)."""
    mesh = active_mesh()
    return local_rows * (mesh.n_batch if mesh is not None else 1)


def local_rows_of(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This rank's rows of a global-batch tensor (equal shards)."""
    mesh = active_mesh()
    if mesh is None:
        return x
    n = x.shape[axis] // mesh.n_batch
    return x.narrow(axis, mesh.batch_index * n, n)


# ----------------------------------------------------- batch placement


def shard_rows(x, mesh: Mesh, axis: int = 0):
    """This rank's rows of a global array or tensor (rows divisible by
    n_batch)."""
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(*host_batch_slice(x.shape[axis], mesh.n_batch,
                                        mesh.batch_index))
    return x[tuple(idx)]


def shard_batch(batch: Batch, mesh: Mesh, axis: int = 0) -> Batch:
    """This rank's rows of every field (axis 1 for stacked [K, B, ...])."""
    return Batch(*(shard_rows(getattr(batch, f.name), mesh, axis)
                   for f in dataclasses.fields(Batch)))


def pad_batch_rows(batch: Batch, multiple: int) -> Batch:
    """Zero rows appended to a multiple of `multiple` (valid 0)."""
    rows = batch.users.shape[0]
    pad = (-rows) % multiple
    if not pad:
        return batch

    def padded(x):
        z = torch.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device)
        return torch.cat([x, z])
    return Batch(*(padded(getattr(batch, f.name))
                   for f in dataclasses.fields(Batch)))


def gather_rows_of(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The batch shards' [b, ...] outputs as one [n_batch * b, ...]."""
    g = col.all_gather(x.contiguous(), mesh.batch_group)
    return g.reshape((-1,) + tuple(x.shape[1:]))


# ------------------------------------------------------ state placement


def is_table(name: str) -> bool:
    return name.rpartition(".")[2].endswith("_embedding")


def sharded_tables(model: nn.Module):
    """{name: parameter} of the row-sharded tables (those placed with a
    `mesh_rows` mark)."""
    return {n: p for n, p in model.named_parameters()
            if getattr(p, "mesh_rows", None) is not None}


@torch.no_grad()
def place_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Keep this rank's row block of every shardable table, in place; the
    tables' Parameter objects stay (an optimizer built later holds
    them).  Idempotent."""
    for name, p in model.named_parameters():
        if (is_table(name) and getattr(p, "mesh_rows", None) is None
                and mesh.sharded(p.shape[0])):
            n = p.shape[0]
            p.data = shard_block(p.data, mesh.n_model, mesh.model_index,
                                 mesh.interleaved).clone()
            p.mesh_rows = n
    return model


def logical_tensor(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The logical [N, ...] table from every model rank's [N/m, ...]
    block (a collective over the model row)."""
    g = col.all_gather(x.contiguous(), mesh.model_group)
    full = g.reshape((-1,) + tuple(x.shape[1:]))
    return deinterleave_rows(full, mesh.n_model) if mesh.interleaved \
        else full


def local_tensor(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a logical [N, ...] table."""
    return shard_block(x, mesh.n_model, mesh.model_index,
                       mesh.interleaved).clone()


class _LogicalTable(torch.autograd.Function):

    @staticmethod
    def forward(ctx, block, mesh):
        ctx.mesh = mesh
        return logical_tensor(block, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        if not mesh.flat:
            return local_tensor(g, mesh), None
        phys = interleave_rows(g, mesh.n_model) if mesh.interleaved else g
        return col.reduce_scatter(
            phys.reshape((mesh.n_model, -1) + tuple(g.shape[1:]))
            .contiguous(), mesh.model_group), None


def logical_table(block: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The logical [N, ...] table of a row-sharded block, differentiable
    (see the module docstring)."""
    return _LogicalTable.apply(block, mesh)


# --------------------------------------------------------- step builders


def make_sharded_eval_step(cfg: Config, mesh: Mesh) -> Callable:
    """(model, global batch) -> (preds, alpha) of the global batch: the
    rows padded to a multiple of n_batch, this rank's rows scored, the
    shards' scores gathered and the padding cut."""
    from clsr_tpu_torch.training.steps import make_eval_step_fn
    inner = make_eval_step_fn(cfg)

    def step(model: nn.Module, batch: Batch):
        rows = batch.users.shape[0]
        local = shard_batch(pad_batch_rows(batch, mesh.n_batch), mesh)
        with use_mesh(mesh):
            preds, alpha = inner(model, local)
        return (gather_rows_of(preds, mesh)[:rows],
                gather_rows_of(alpha, mesh)[:rows])

    return step


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank (nothing without a mesh)."""
    if mesh is not None:
        dist.barrier(group=mesh.world)
