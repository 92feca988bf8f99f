"""The compact row engine on the (data, model) mesh.

Counterpart of clsr_tpu/training/mesh_compact.py.  The single-device
engine (training/compact_rows.py) sorts the batch's ids once per table,
gathers the rows once and writes each touched row once.  On a mesh each
rank holds one batch shard, so the plan is built per rank and the few
global facts are made explicit (`build_mesh_plan`, JAX :160-209):

  * this rank's plan: `compact_rows.build_plan` of its own sites;
  * the global merge order: the batch shards' sorted ids all_gathered
    over the batch group (4 bytes an id), one stable argsort of the
    shard-major concatenation (`gperm`), its run index (`gseg`) and each
    run's first position (`gidx_first`); every rank of the group
    computes the same;
  * `first` (the mask `CompactRows.sumsq_unique` and `pair_stats` read)
    becomes the GLOBAL first occurrence in that order, this rank's block
    of it, so each globally unique row's L2 and discrepancy terms are
    counted once, on one rank;
  * the rows: `gather_mesh_ws` looks the sorted ids up in the rank's
    block of the pmn array (parallel/embedding.py's collective lookup;
    a replicated array is indexed locally), [Mi, 3D] a rank, not the
    table.

The forward reads the rows through `compact_rows.make_context` as on one
device (`MeshPlan` is a `Plan`), and the w-space backward gives each
rank its [Mi, D] gradient; training/lazy_adam.py's broadcast merge
(`compact_mesh_update`) then all_gathers the (ids, gradients) and
replays `gperm`/`gseg`, so every rank sums each unique row's gradient
and the clip norm over the exact global row set, and writes the rows it
owns (K5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.ops.segment_sum import sorted_runs
from clsr_tpu_torch.parallel import collectives as col
from clsr_tpu_torch.parallel.embedding import gather_rows
from clsr_tpu_torch.parallel.mesh import Mesh
from clsr_tpu_torch.training.compact_rows import (SITE_SPECS, Plan,
                                                  build_plan)


@dataclasses.dataclass
class MeshPlan(Plan):
    """A rank's plan with `first` the global first-occurrence mask, and
    the batch group's merge order of the gathered sorted ids (every rank
    of the group holds the same)."""

    gperm: torch.Tensor = None       # [n*Mi] stable argsort of the ids
    gids: torch.Tensor = None        # [n*Mi] the ids in that order
    gseg: torch.Tensor = None        # [n*Mi] run index
    gidx_first: torch.Tensor = None  # [n*Mi] first position of each run


def build_mesh_plan(sites: Dict[str, torch.Tensor], mesh: Mesh
                    ) -> MeshPlan:
    plan = build_plan(sites)
    mi = plan.sorted_ids.shape[0]
    flat = col.all_gather(plan.sorted_ids, mesh.batch_group).reshape(-1)
    gperm = torch.argsort(flat, stable=True)
    gids = flat.index_select(0, gperm)
    firstg, gseg, gidx_first = sorted_runs(gids)
    gfirst = torch.empty_like(firstg)
    gfirst[gperm] = firstg                 # back to shard-major order
    k = mesh.batch_index
    fields = {f.name: getattr(plan, f.name)
              for f in dataclasses.fields(Plan)}
    fields["first"] = gfirst[k * mi:(k + 1) * mi]
    return MeshPlan(**fields, gperm=gperm.to(torch.int32), gids=gids,
                    gseg=gseg, gidx_first=gidx_first)


def build_mesh_plans(table_names: Dict[str, str], batch: Batch, mesh: Mesh
                     ) -> Dict[str, MeshPlan]:
    """One plan per table name (compact_rows.build_plans, mesh form)."""
    return {name: build_mesh_plan(SITE_SPECS[name](batch), mesh)
            for name in sorted(set(table_names.values()))}


def gather_mesh_ws(tables: Dict[str, torch.Tensor],
                   table_names: Dict[str, str],
                   plans: Dict[str, MeshPlan], mesh: Mesh,
                   sharded: Dict[str, bool]) -> Dict[str, torch.Tensor]:
    """The one row gather per table: {table name: rows [Mi, W]} of this
    rank's sorted ids, from the rank's block of a row-sharded array or
    the whole of a replicated one."""
    out = {}
    for path, table in tables.items():
        ids = plans[table_names[path]].sorted_ids
        out[table_names[path]] = (
            gather_rows(table.detach(), ids, mesh) if sharded[path]
            else table.detach().index_select(0, ids))
    return out
