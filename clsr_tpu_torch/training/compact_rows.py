"""Compact row engine: one sorted gather per embedding table per step.

Counterpart of clsr_tpu/training/compact_rows.py.  Per table and step:

  1. every batch id that can touch the table (its lookup sites,
     `SITE_SPECS`) is concatenated and argsorted; the inverse permutation
     gives each site its positions into the sorted ids (`build_plan`);
  2. w = table[sorted_ids] is gathered once (`gather_ws`) and is the
     differentiable input of the loss: the model's lookups slice the
     permuted rows of w (`CompactRows.site`), and the lazy L2 and CLSR's
     discrepancy statistics come from w with a first-occurrence mask, so
     the forward reads no table `Parameter`;
  3. the backward lands in w space ([M, D]); `permuted_rows` makes it a
     gather (g[perm]), not a scatter-add per lookup site;
  4. training/lazy_adam.py sums duplicate occurrences over the sorted runs
     and writes each touched row once (K5).

The JAX package installs the rows through a thread-local context
(`use_compact_rows`), a workaround for flax's module calls; the port
passes the context explicitly, `model(batch, ..., compact=ctx)` down to
`seq_graph`.  On a mesh, training/mesh_compact.py builds the plans
(`MeshPlan`, a `Plan` whose first-occurrence mask is the global one)
and the rows, and the context is made here the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.ops.segment_sum import sorted_runs

# Which batch id arrays can touch each known table (trace-order sites).
SITE_SPECS = {
    "item_embedding": lambda b: {"hist": b.item_hist, "targets": b.items},
    "cate_embedding": lambda b: {"hist": b.cate_hist, "targets": b.cates},
    "user_embedding": lambda b: {"rows": b.users},
    "user_long_embedding": lambda b: {"rows": b.users},
    "user_short_embedding": lambda b: {"rows": b.users},
}


@dataclasses.dataclass
class Plan:
    """Sorted-id bookkeeping for one table (all int32 or bool)."""

    sorted_ids: torch.Tensor         # [M] ascending
    seg: torch.Tensor                # [M] run index (cumsum(first) - 1)
    first: torch.Tensor              # [M] bool first-occurrence mask
    idx_first: torch.Tensor          # [M] first position of each run;
    #                                  INT32_MAX past the last run
    pos: Dict[str, torch.Tensor]     # site -> positions into sorted_ids
    perm: torch.Tensor               # [M] argsort of the concatenated ids
    inv: torch.Tensor                # [M] argsort(perm)
    # (name, flat offset, id shape) per site, in concat order
    site_slices: Tuple[Tuple[str, int, Tuple[int, ...]], ...] = ()


class _PermutedRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, w, inv, perm):
        ctx.save_for_backward(perm)
        return w.index_select(0, inv)

    @staticmethod
    def backward(ctx, g):
        (perm,) = ctx.saved_tensors
        return g.index_select(0, perm), None, None


def permuted_rows(w: torch.Tensor, inv: torch.Tensor,
                  perm: torch.Tensor) -> torch.Tensor:
    """rows = w[inv] with a gather backward, dL/dw = g[perm].

    `inv` is a permutation of range(M), so rows[i] is the table row of the
    i-th concatenated site id and each row of w gets exactly one cotangent
    row: the backward is a gather, where autograd of the per-site
    `w[pos]` would scatter-add once per site.  The values and gradients
    equal the scatter-add formulation's bit for bit (no two cotangent rows
    land on one row of w)."""
    return _PermutedRows.apply(w, inv, perm)


@dataclasses.dataclass
class CompactRows:
    """A table's gathered rows and plan, handed to the model's forward."""

    w: torch.Tensor                  # [M, D] = table[sorted_ids]
    plan: Plan
    rows: Optional[torch.Tensor] = None   # [M, D] permuted_rows(w): every
    #                                       site's lookup, concatenated in
    #                                       original order

    def site(self, name: str) -> torch.Tensor:
        """Embedding rows of a lookup site, in original order and shape: a
        static slice of the permuted rows, or w[pos] without them."""
        if self.rows is not None:
            for s, off, shape in self.plan.site_slices:
                if s == name:
                    n = 1
                    for d in shape:
                        n *= d
                    return self.rows[off:off + n].reshape(
                        shape + (self.rows.shape[-1],))
            if self.plan.site_slices:
                raise KeyError(
                    f"site {name!r} missing from plan.site_slices "
                    f"{[s for s, _, _ in self.plan.site_slices]}")
        return self.w[self.plan.pos[name].long()]

    def sumsq_unique(self) -> torch.Tensor:
        """sum ||row||^2 over the UNIQUE involved rows (the lazy L2 term,
        sequential_base_model.py:409-433)."""
        w = self.w.float()
        return ((w * w).sum(-1) * self.plan.first).sum()

    def pair_stats(self, other: "CompactRows"):
        """(sumsq_self, sumsq_other, sum||a-b||^2, n_unique*D) over unique
        rows: CLSR's involved-user L2 and discrepancy statistics
        (clsr.py:73-82, 118-127).  Both tables share one plan (the same
        ids), so the statistics come from the gathered rows."""
        wa, wb = self.w.float(), other.w.float()
        ff = self.plan.first[:, None].to(wa.dtype)
        diff = wa - wb
        return ((wa * wa * ff).sum(), (wb * wb * ff).sum(),
                (diff * diff * ff).sum(), ff.sum() * wa.shape[1])


def supported_tables(model: nn.Module) -> Optional[Dict[str, str]]:
    """{parameter name: table name} when every `*_embedding` parameter has
    a site spec, else None (the step takes the legacy lazy path)."""
    tables = {}
    for name, _ in model.named_parameters():
        leaf = name.rpartition(".")[2]
        if leaf.endswith("_embedding"):
            if leaf not in SITE_SPECS:
                return None
            tables[name] = leaf
    return tables or None


def build_plan(sites: Dict[str, torch.Tensor]) -> Plan:
    """Sort the concatenated site ids (stable); positions by the inverse
    argsort."""
    flat = torch.cat([ids.reshape(-1) for ids in sites.values()])
    perm = torch.argsort(flat, stable=True)
    sorted_ids = flat[perm].to(torch.int32)
    inv = torch.argsort(perm)
    first, seg, idx_first = sorted_runs(sorted_ids)
    inv32 = inv.to(torch.int32)
    pos, slices, off = {}, [], 0
    for s, ids in sites.items():
        n = ids.numel()
        pos[s] = inv32[off:off + n].reshape(ids.shape)
        slices.append((s, off, tuple(ids.shape)))
        off += n
    return Plan(sorted_ids=sorted_ids, seg=seg, first=first,
                idx_first=idx_first, pos=pos, perm=perm.to(torch.int32),
                inv=inv32, site_slices=tuple(slices))


def build_plans(table_names: Dict[str, str], batch: Batch
                ) -> Dict[str, Plan]:
    """One plan per table name; tables indexed by the same ids (CLSR's
    user long/short pair) get equal plans, built once each."""
    return {name: build_plan(SITE_SPECS[name](batch))
            for name in sorted(set(table_names.values()))}


def gather_ws(tables: Dict[str, torch.Tensor], table_names: Dict[str, str],
              plans: Dict[str, Plan]) -> Dict[str, torch.Tensor]:
    """The one sorted gather per table: {table name: table[sorted_ids]}."""
    return {table_names[path]: table.detach().index_select(
        0, plans[table_names[path]].sorted_ids)
        for path, table in tables.items()}


def make_context(plans: Dict[str, Plan], ws: Dict[str, torch.Tensor]
                 ) -> Dict[str, CompactRows]:
    return {name: CompactRows(
        w=ws[name], plan=plans[name],
        rows=permuted_rows(ws[name], plans[name].inv, plans[name].perm))
        for name in ws}
