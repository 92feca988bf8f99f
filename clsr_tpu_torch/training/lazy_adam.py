"""Lazy (sparse) Adam for embedding tables, single device.

Counterpart of clsr_tpu/training/lazy_adam.py (the reference's
`optimizer: lazyadam`, base_model.py:275-276, tf.contrib.opt's
LazyAdamOptimizer): the Adam moments of a table are updated only on the
rows the batch touched, with the bias correction of the global step count
(t = count + 1).  The non-table parameters take per-tensor clip and dense
Adam (`torch.optim.Adam`, the JAX package's `dense_tx`, :129-132).

Two layouts of a table's optimizer rows, told apart by width:

  * split [N, 2D] = mu | nu, the legacy path (`compact_rows: off`):
    `table_update` gathers the dense table gradient at the batch's sorted
    ids (duplicates included; they compute identical rows), clips it by
    the norm over the UNIQUE rows, and writes the param rows and the
    moment rows: two scatter-sets per table;
  * pmn [N, 3D] = param | mu | nu, the compact row engine
    (training/compact_rows.py): the forward's one sorted gather brings
    the moments along, `compact_table_update` sums the w-space gradient
    over the sorted runs (`ops.segment_sum`, in row order, into [Mc, D],
    Mc = min(M, N)), clips it by its norm, and writes the pmn rows, and the same new
    param rows into the table `Parameter`, which so stays equal to
    pmn[:, :D] bit for bit without an O(N) copy.

Under `embedding_dtype: bfloat16` (JAX :146-149, :188, :301-311) the
tables are bf16 and their gradients bf16; the moments, the gathered old
rows and the update arithmetic are f32, the new rows are stored
round-to-nearest in the table's type, and pmn's f32 param lane holds
those rounded rows, so a compact gather recovers the bf16 path exactly
(the step hands the lane to the model in the table's type).

The step count is a device int32 scalar, as JAX's is (:77, :162), and
the bias corrections are f32 arithmetic on the device, so a step reads
nothing from the host and can be captured in a CUDA graph.

Each table's update returns its scatter-sets as (table, ids, rows)
entries, and `_finish` writes every entry of the step with one
`row_update.scatter_rows_group` call: one K5 launch per step, in place.

On a (data, model) mesh (parallel/mesh.py), the broadcast half of the
JAX package's mesh updates:

  * `table_update_sharded` (JAX :194-259), the legacy path on a
    row-sharded table: the batch shards' ids all_gathered and sorted,
    the rank's block of the gradient (already summed over the data
    column, training/steps.py) read at the ids it owns, the clip norm's
    sum of squares all_reduced over the model row;
  * `compact_table_update_mesh` (JAX :324-418, the broadcast merge): the
    ranks' w-space gradients and ids all_gathered over the batch group,
    the plan's global order (training/mesh_compact.py) replayed, so each
    unique row's gradient and the clip norm are the global ones on every
    rank, then the pmn rows the rank owns updated;
  * a replicated table (rows not divisible by model_parallel) takes the
    single-device updates on the gathered ids and the batch-summed
    gradient.

  * `compact_table_update_mesh_owner` (JAX :420-606, the owner-routed
    merge, `mesh_update_routing: owner`, on every row-sharded table):
    the rank sums its own sorted runs, buckets the unique rows' (id,
    gradient) by owner into static [m, C] slots (empty slots hold the
    sentinel id N and a zero row), routes them (flat batch: one
    all_to_all over the model row; a replicated batch: the rank's own
    bucket, since its model row holds the same stream), all_gathers
    them over the data column, and merges them (sentinels sort last);
    the clip norm is the model row's sum of the owners' disjoint
    partial sums of squares.  A (source, owner) entry past C is an
    overflow.  Every owner-routed table's buckets come first
    (`owner_buckets`: they read only the plans and the w-space
    gradients), then one world all_reduce of the tables' counts, so
    every rank holds the same integers.  Under `mesh_owner_overflow:
    fallback` a table whose count is nonzero takes the broadcast merge
    that step (JAX's `lax.cond`): the step reads the counts once, as
    one small tensor (`MeshMerge.pattern`), and every rank takes the
    same branches; under `drop` the entries are dropped and nothing is
    read.  A captured step (training/steps.py) is a graph up to the
    counts and a graph of the rest for each pattern.  The counts add up
    in the state's `route_overflow`, a device int32 counter.

All write through K5, the rows the rank does not own filtered out
first: the owned rows' local targets come first, ascending, and the
others get targets past the block, which K5 drops.  The pmn param lane
holds the rows rounded to the table's type, as on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from clsr_tpu_torch.config import Config
from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.ops.row_update import Entry, scatter_rows_group
from clsr_tpu_torch.ops.segment_sum import (run_lengths, segment_sum,
                                            sorted_runs)
from clsr_tpu_torch.parallel import collectives as col
from clsr_tpu_torch.parallel.embedding import owned_rows
from clsr_tpu_torch.parallel.rowmap import owner_local
from clsr_tpu_torch.training.compact_rows import Plan, supported_tables
from clsr_tpu_torch.training.optimizer import (build_optimizer,
                                               clip_by_norm_each)

B1, B2, EPS = 0.9, 0.999, 1e-8


def is_table(name: str) -> bool:
    return name.rpartition(".")[2].endswith("_embedding")


def batch_table_ids(batch: Batch) -> Dict[str, torch.Tensor]:
    """Row ids each known embedding table can be touched by (JAX
    :43-58)."""
    items = torch.cat([batch.item_hist.reshape(-1), batch.items.reshape(-1)])
    cates = torch.cat([batch.cate_hist.reshape(-1), batch.cates.reshape(-1)])
    return {
        "item_embedding": items,
        "cate_embedding": cates,
        "user_embedding": batch.users,
        "user_long_embedding": batch.users,
        "user_short_embedding": batch.users,
        "user_gmf_embedding": batch.users,
        "user_mlp_embedding": batch.users,
        "item_gmf_embedding": batch.items.reshape(-1),
        "item_mlp_embedding": batch.items.reshape(-1),
    }


@dataclasses.dataclass
class LazyAdamState:
    """Per-table optimizer rows {table parameter name: [N, 2D] or [N, 3D]
    f32}, the step count (an int32 scalar on the tables' device), and the
    dense Adam over the other parameters.
    `route_overflow` (an int32 scalar on the same device) counts the
    owner-routed merge's overflowed bucket entries, summed over the
    world; it stays 0 on every other path."""

    moments: Dict[str, torch.Tensor]
    count: torch.Tensor
    dense_opt: torch.optim.Optimizer
    route_overflow: torch.Tensor


@dataclasses.dataclass
class MeshMerge:
    """A mesh compact step's table updates after the owner-routed merge's
    buckets (`LazyAdam.compact_mesh_update`).  `counts` [T] int32 holds
    the owner-routed tables' overflow counts, summed over the world, when
    a nonzero count changes a table's merge (`mesh_owner_overflow:
    fallback`), else None.  `finish(pattern)` runs the rest of the
    update, the row merges, K5, the clip and dense Adam: pattern[i] True
    takes the broadcast merge for owner-routed table i (JAX's
    `lax.cond`, :532, :581), () the owner merge for every one.  Every
    rank reads the same world sums, so every rank takes the same
    branches and issues the same collectives."""

    counts: Optional[torch.Tensor]
    finish: Callable[[Tuple[bool, ...]], None]

    def pattern(self) -> Tuple[bool, ...]:
        """The branches of this step: one host read of `counts`."""
        if self.counts is None:
            return ()
        return tuple(bool(c) for c in self.counts.tolist())


def is_pmn(param: torch.Tensor, mn: torch.Tensor) -> bool:
    """True if `mn` uses the fused param|mu|nu layout for `param`."""
    return mn.shape[1] == 3 * param.shape[1]


def fused_tables_enabled(cfg: Config, model: nn.Module) -> bool:
    """The pmn layout applies exactly when the compact row engine runs:
    lazyadam, compact_rows != off, not NextItNet's per-position training
    (JAX :107-109), every table site-mapped."""
    return (cfg.optimizer == "lazyadam" and cfg.compact_rows != "off"
            and not per_position(cfg)
            and supported_tables(model) is not None)


def per_position(cfg: Config) -> bool:
    """NextItNet's per-position training (cfg.nextitnet_per_position):
    [B, G, L] targets, and the legacy lazy path (JAX steps.py:52-55)."""
    return (cfg.model_type.lower() == "nextitnet"
            and cfg.nextitnet_per_position)


def _split(model: nn.Module):
    tables, dense = {}, {}
    for name, p in model.named_parameters():
        (tables if is_table(name) else dense)[name] = p
    return tables, dense


def _bias_corrections(t) -> Tuple[torch.Tensor, torch.Tensor]:
    """(1 - b1^t, 1 - b2^t) in f32, on the device of t (the step count,
    a tensor or an int)."""
    t = torch.as_tensor(t, dtype=torch.float32)
    return 1.0 - torch.pow(B1, t), 1.0 - torch.pow(B2, t)


def _adam_rows(p_old, mv, g, t, lr):
    """New param rows and moments from old rows, [mu | nu] and gradients."""
    D = p_old.shape[1]
    bc1, bc2 = _bias_corrections(t)
    m_new = B1 * mv[:, :D] + (1.0 - B1) * g
    v_new = B2 * mv[:, D:] + (1.0 - B2) * g * g
    step = lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + EPS)
    return p_old - step, m_new, v_new


def _owned_first(loc: torch.Tensor, ok: torch.Tensor, rows: int,
                 *values: torch.Tensor):
    """(targets, values reordered) for K5 on a rank's [rows, W] block: the
    owned rows first in their (ascending) order at their local rows, then
    the others at rows + i, past the block."""
    order = torch.argsort((~ok).to(torch.uint8), stable=True)
    ar = torch.arange(loc.shape[0], device=loc.device, dtype=loc.dtype)
    tgt = torch.where(ok, loc, rows + ar).index_select(0, order)
    return (tgt.to(torch.int32),) + tuple(v.index_select(0, order)
                                          for v in values)


class LazyAdam:
    """init / update of the lazy optimizer for one config (the JAX
    package's `make_lazy_optimizer`)."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.lr = cfg.learning_rate
        self.max_norm = cfg.max_grad_norm if cfg.is_clip_norm else 0.0

    def init(self, model: nn.Module) -> LazyAdamState:
        """Moments of zeros (with the table in front under pmn); moments
        are f32 whatever the table's type."""
        tables, dense = _split(model)
        fused = fused_tables_enabled(self.cfg, model)

        def init_rows(v):
            zeros = torch.zeros(v.shape[0], 2 * v.shape[1],
                                dtype=torch.float32, device=v.device)
            if fused:
                return torch.cat([v.detach().float(), zeros], dim=-1)
            return zeros

        device = next(model.parameters()).device
        return LazyAdamState(
            moments={n: init_rows(v) for n, v in tables.items()},
            count=torch.zeros((), dtype=torch.int32, device=device),
            dense_opt=build_optimizer(self.cfg, list(dense.values())),
            route_overflow=torch.zeros((), dtype=torch.int32,
                                       device=device))

    def _clip_scale(self, sumsq):
        if self.max_norm <= 0.0:
            return 1.0
        norm = torch.sqrt(sumsq)
        return torch.where(norm > self.max_norm, self.max_norm / norm,
                           torch.ones_like(norm))

    @torch.no_grad()
    def table_update(self, param: torch.Tensor, grad_dense: torch.Tensor,
                     mn: torch.Tensor, ids: torch.Tensor, t
                     ) -> List[Entry]:
        """Legacy path (JAX :167-192): the param and mn rows at the sorted
        ids, as two scatter-set entries for K5."""
        D = param.shape[1]
        off = D if is_pmn(param, mn) else 0
        ids = torch.sort(ids.reshape(-1).to(torch.int32)).values
        first = torch.ones_like(ids, dtype=torch.bool)
        first[1:] = ids[1:] != ids[:-1]
        g = grad_dense.index_select(0, ids).float()
        g = g * self._clip_scale(((g * g).sum(-1) * first).sum())
        mv = mn.index_select(0, ids)
        p_old = mv[:, :D] if off else param.index_select(0, ids).float()
        new_rows, m_new, v_new = _adam_rows(p_old, mv[:, off:], g, t,
                                            self.lr)
        new_rows = new_rows.to(param.dtype)   # pmn's lane: the table's rows
        parts = ([new_rows.float()] if off else []) + [m_new, v_new]
        return [(param.data, ids, new_rows),
                (mn, ids, torch.cat(parts, dim=-1))]

    @torch.no_grad()
    def compact_table_update(self, param: torch.Tensor, w: torch.Tensor,
                             gw: torch.Tensor, mn: torch.Tensor, plan: Plan,
                             t) -> List[Entry]:
        """Row update from the compact w-space gradient (JAX :261-322), as
        two scatter-set entries for K5: the new param rows into `param`,
        and into mn either the whole pmn rows (`w` is [M, 3D]
        param|mu|nu, the moments ride the forward gather) or the moments
        (split layout: `w` is the [M, D] forward gather, one moment
        gather here).  The runs are capped at Mc = min(M, N): a table has
        at most N distinct rows.  Targets past the nseg valid runs are
        N + i, which K5 drops."""
        N, D = param.shape
        fused = w.shape[1] == 3 * D
        M = plan.sorted_ids.shape[0]
        Mc = min(M, N)
        g = segment_sum(gw.float(), run_lengths(plan.idx_first, Mc))
        nseg = plan.seg[-1] + 1
        ar = torch.arange(Mc, dtype=torch.int32, device=gw.device)
        valid = ar < nseg
        g = g * self._clip_scale((g * g).sum())     # rows >= nseg are zero
        sel = torch.clamp(plan.idx_first[:Mc], max=M - 1)
        uid = plan.sorted_ids.index_select(0, sel)
        vf = valid[:, None].float()
        if fused:
            rows_first = w.index_select(0, sel)
            p_old = rows_first[:, :D]
            mv = rows_first[:, D:] * vf
        else:
            safe = torch.where(valid, uid, torch.zeros_like(uid))
            mv = mn.index_select(0, safe) * vf
            p_old = w.index_select(0, sel).float()
        new_rows, m_new, v_new = _adam_rows(p_old, mv, g, t, self.lr)
        new_rows = new_rows.to(param.dtype)   # pmn's lane: the table's rows
        tgt = torch.where(valid, uid, N + ar)
        mn_rows = ([new_rows.float()] if fused else []) + [m_new, v_new]
        return [(param.data, tgt, new_rows),
                (mn, tgt, torch.cat(mn_rows, -1))]

    @torch.no_grad()
    def table_update_sharded(self, param: torch.Tensor,
                             grad: torch.Tensor, mn: torch.Tensor,
                             ids: torch.Tensor, t, mesh) -> List[Entry]:
        """The legacy update of this rank's block of a row-sharded table
        (JAX :194-259): `grad` is the block's gradient summed over the
        data column, `ids` this rank's batch ids."""
        D = param.shape[1]
        off = D if is_pmn(param, mn) else 0
        ids = col.all_gather(ids.reshape(-1).to(torch.int32),
                             mesh.batch_group).reshape(-1)
        ids = torch.sort(ids).values
        first = torch.ones_like(ids, dtype=torch.bool)
        first[1:] = ids[1:] != ids[:-1]
        rows = param.shape[0]
        loc, ok = owned_rows(ids, mesh, rows)
        okf = ok[:, None].float()
        g = grad.index_select(0, loc).float() * okf
        sumsq = col.all_reduce(((g * g).sum(-1) * first).sum(),
                               mesh.model_group)
        g = g * self._clip_scale(sumsq)
        mv = mn.index_select(0, loc)
        p_old = (mv[:, :D] * okf if off
                 else param.index_select(0, loc).float())
        new_rows, m_new, v_new = _adam_rows(p_old, mv[:, off:], g, t,
                                            self.lr)
        new_rows = new_rows.to(param.dtype)
        mn_rows = torch.cat(([new_rows.float()] if off else [])
                            + [m_new, v_new], -1)
        tgt, new_rows, mn_rows = _owned_first(loc, ok, rows, new_rows,
                                              mn_rows)
        return [(param.data, tgt, new_rows), (mn, tgt, mn_rows)]

    @torch.no_grad()
    def compact_table_update_mesh(self, param: torch.Tensor,
                                  gw: torch.Tensor, mn: torch.Tensor, plan,
                                  t, mesh, n_rows: int, sharded: bool
                                  ) -> List[Entry]:
        """The broadcast merge (JAX :324-418) for this rank's block (or
        the whole, replicated) of a pmn table of n_rows logical rows:
        `gw` [Mi, D] is the rank's w-space gradient, `plan` its
        training/mesh_compact.py plan."""
        D = param.shape[1]
        if not is_pmn(param, mn):
            raise ValueError("the mesh compact update needs the pmn layout")
        n = plan.gids.shape[0]
        Mc = min(n, n_rows)     # at most n_rows distinct rows can occur
        g_all = col.all_gather(gw.float().contiguous(),
                               mesh.batch_group).reshape(-1, D)
        g = segment_sum(g_all.index_select(0, plan.gperm),
                        run_lengths(plan.gidx_first, Mc))
        ar = torch.arange(Mc, dtype=torch.int32, device=gw.device)
        valid = ar < plan.gseg[-1] + 1
        g = g * self._clip_scale((g * g).sum())     # rows >= nseg are zero
        uid = plan.gids.index_select(
            0, torch.clamp(plan.gidx_first[:Mc], max=n - 1))
        uid = torch.where(valid, uid, torch.zeros_like(uid))
        rows = param.shape[0]
        if sharded:
            loc, ok = owned_rows(uid, mesh, rows)
            ok = ok & valid
        else:
            loc, ok = uid, valid
        mv = mn.index_select(0, loc) * ok[:, None].float()
        new_rows, m_new, v_new = _adam_rows(mv[:, :D], mv[:, D:], g, t,
                                            self.lr)
        new_rows = new_rows.to(param.dtype)   # pmn's lane: the table's rows
        tgt, new_rows, mn_rows = _owned_first(
            loc, ok, rows, new_rows,
            torch.cat([new_rows.float(), m_new, v_new], -1))
        return [(param.data, tgt, new_rows), (mn, tgt, mn_rows)]

    @torch.no_grad()
    def owner_buckets(self, param: torch.Tensor, gw: torch.Tensor,
                      mn: torch.Tensor, plan, mesh, n_rows: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The owner-routed merge's first half (JAX :420-531) for this
        rank's block of a row-sharded pmn table of n_rows logical rows:
        (the wire tensor [m * C, D + 1] of the rank's unique rows' (id,
        gradient) bucketed by owner, the rank's overflowed entries, int32
        [1]).  No collective: it reads the plan and the w-space gradient,
        which no table's update changes."""
        D = param.shape[1]
        if not is_pmn(param, mn):
            raise ValueError("the owner-routed merge needs the pmn layout")
        N, m, rows = n_rows, mesh.n_model, param.shape[0]
        dev = gw.device
        ids = plan.sorted_ids
        Mi = ids.shape[0]
        C = max(1, min(Mi, -(-int(self.cfg.mesh_owner_capacity * Mi) // m)))
        # 1. the rank's per-unique-row sums over its sorted runs
        gsum = segment_sum(gw.float(), run_lengths(plan.idx_first, Mi))
        run_ok = (torch.arange(Mi, dtype=torch.int32, device=dev)
                  < plan.seg[-1] + 1)
        uid = ids.index_select(0, torch.clamp(plan.idx_first, max=Mi - 1))
        uid = torch.where(run_ok, uid, torch.full_like(uid, N))
        # 2. static [m, C] buckets by owner; a run's slot is its rank
        #    among the runs of its owner (a running count a column)
        owner = torch.clamp(owner_local(uid, m, rows, mesh.interleaved)[0],
                            0, m - 1)
        onehot = ((owner[:, None] == torch.arange(m, device=dev)[None])
                  & run_ok[:, None]).to(torch.int32)
        slot = torch.cumsum(onehot, 0).gather(1, owner[:, None].long())[
            :, 0] - 1
        in_cap = slot < C
        send_ok = run_ok & in_cap
        tgt = torch.where(send_ok, owner * C + slot,
                          torch.full_like(owner, m * C)).long()
        send_ids = torch.full((m * C + 1,), N, dtype=torch.int32,
                              device=dev)
        send_ids[tgt] = uid
        send_g = torch.zeros(m * C + 1, D, dtype=torch.float32, device=dev)
        send_g[tgt] = gsum
        # one wire tensor: the id rides in the last column as its int32
        # bits (collectives copy, never add, them); the sink slot m*C,
        # where the unsent runs went, is cut off
        send = torch.cat([send_g[:m * C],
                          send_ids[:m * C].view(torch.float32)[:, None]], 1)
        lost = run_ok & ~in_cap
        if not mesh.flat:   # the model row holds one stream: count once
            lost = lost & (owner == mesh.model_index)
        return send, lost.sum().to(torch.int32)[None]

    @torch.no_grad()
    def owner_merge(self, param: torch.Tensor, mn: torch.Tensor,
                    send: torch.Tensor, t, mesh, n_rows: int
                    ) -> List[Entry]:
        """The owner-routed merge's second half (JAX :533-606): route
        each bucket of `send` (`owner_buckets`) to its owner, collect the
        column's, merge them and update the rank's owned rows."""
        D = param.shape[1]
        N, m, rows = n_rows, mesh.n_model, param.shape[0]
        j = mesh.model_index
        dev = send.device
        C = send.shape[0] // m
        # 3. route each bucket to its owner; 4. collect the column's
        if mesh.flat:
            got = col.all_to_all(send.reshape(m, C, D + 1),
                                 mesh.model_group)
        else:
            got = send[j * C:(j + 1) * C]
        got = col.all_gather(got.contiguous(),
                             mesh.data_group).reshape(-1, D + 1)
        # 5. the merge: stable sort, the sentinels (N) last
        gid = got[:, D].contiguous().view(torch.int32)
        order = torch.argsort(gid, stable=True)
        sid = gid.index_select(0, order)
        K = sid.shape[0]
        Kc = min(K, N + 1)          # at most N real runs + the sentinels'
        _, seg, idx_first = sorted_runs(sid)
        g = segment_sum(got[:, :D].index_select(0, order),
                        run_lengths(idx_first, Kc))
        gu = sid.index_select(0, torch.clamp(idx_first[:Kc], max=K - 1))
        valid = ((torch.arange(Kc, dtype=torch.int32, device=dev)
                  < seg[-1] + 1) & (gu >= 0) & (gu < N))
        if self.max_norm > 0.0:
            # the owners' rows partition the unique rows: the model row's
            # sum of the disjoint partial sums is the whole table's
            sumsq = col.all_reduce(
                ((g * g).sum(-1) * valid).sum()[None], mesh.model_group)[0]
            g = g * self._clip_scale(sumsq)
        loc, ok = owned_rows(torch.where(valid, gu, torch.zeros_like(gu)),
                             mesh, rows)
        ok = ok & valid
        mv = mn.index_select(0, loc) * ok[:, None].float()
        new_rows, m_new, v_new = _adam_rows(mv[:, :D], mv[:, D:], g, t,
                                            self.lr)
        new_rows = new_rows.to(param.dtype)   # pmn's lane: the table's rows
        tgt, new_rows, mn_rows = _owned_first(
            loc, ok, rows, new_rows,
            torch.cat([new_rows.float(), m_new, v_new], -1))
        return [(param.data, tgt, new_rows), (mn, tgt, mn_rows)]

    def compact_mesh_update(self, model: nn.Module, state: LazyAdamState,
                            gws: Dict[str, torch.Tensor],
                            plans: Dict[str, Plan],
                            table_names: Dict[str, str], mesh
                            ) -> "MeshMerge":
        """Mesh compact table updates and dense Adam (JAX :633-666): the
        owner-routed merge for every row-sharded table under
        `mesh_update_routing: owner`, else (and for a replicated table)
        the broadcast merge; the dense gradients arrive summed over the
        batch shards.  It runs every owner-routed table's buckets and
        one world all_reduce of their overflow counts, adds them to
        `route_overflow`, and returns the rest as a `MeshMerge` to
        finish: under `mesh_owner_overflow: fallback` each table's branch
        waits for the counts' one host read."""
        owner = self.cfg.mesh_update_routing == "owner"
        routed = {}                 # table path -> the owner merge's wire
        losts = []
        tables, _ = _split(model)
        for path, param in tables.items():
            n_rows = getattr(param, "mesh_rows", None)
            if owner and n_rows is not None:
                name = table_names[path]
                routed[path], lost = self.owner_buckets(
                    param, gws[name], state.moments[path], plans[name],
                    mesh, n_rows)
                losts.append(lost)
        counts = None
        if losts:
            counts = col.all_reduce(torch.cat(losts), mesh.world)
            state.route_overflow.add_(counts.sum(dtype=torch.int32))

        def finish(pattern: Tuple[bool, ...] = ()) -> None:
            fallback = {p for p, f in zip(routed, pattern) if f}

            def per_table(path, param, mn, t):
                name = table_names[path]
                n_rows = getattr(param, "mesh_rows", None)
                if path in routed and path not in fallback:
                    return self.owner_merge(param, mn, routed[path], t,
                                            mesh, n_rows)
                return self.compact_table_update_mesh(
                    param, gws[name], mn, plans[name], t, mesh,
                    n_rows or param.shape[0], n_rows is not None)
            self._finish(model, state, per_table)

        fallback_mode = self.cfg.mesh_owner_overflow == "fallback"
        return MeshMerge(counts if fallback_mode else None, finish)

    def _finish(self, model: nn.Module, state: LazyAdamState,
                per_table: Callable[[str, torch.Tensor, torch.Tensor,
                                     torch.Tensor], List[Entry]]) -> None:
        """The shared tail (JAX :608-631): every table's row update, its
        entries written by one K5 launch, then per-tensor clip and dense
        Adam over the other parameters, each under its
        `train_step.<phase>` profiler range."""
        tables, dense = _split(model)
        state.count.add_(1)
        with record_function("train_step.row_update"):
            entries = []
            for name, param in tables.items():
                entries += per_table(name, param, state.moments[name],
                                     state.count)
            scatter_rows_group(entries)
        if self.cfg.is_clip_norm:
            with record_function("train_step.clip"):
                clip_by_norm_each([p.grad for p in dense.values()
                                   if p.grad is not None],
                                  self.cfg.max_grad_norm)
        with record_function("train_step.adam"):
            state.dense_opt.step()

    def compact_update(self, model: nn.Module, state: LazyAdamState,
                       gws: Dict[str, torch.Tensor],
                       plans: Dict[str, Plan], ws: Dict[str, torch.Tensor],
                       table_names: Dict[str, str]) -> None:
        """Compact table updates and dense Adam (JAX :668-680): `gws` and
        `ws` by table name (dL/dw [M, D] and the gathered rows)."""
        def per_table(path, param, mn, t):
            name = table_names[path]
            return self.compact_table_update(param, ws[name], gws[name], mn,
                                             plans[name], t)
        self._finish(model, state, per_table)

    def update(self, model: nn.Module, state: LazyAdamState,
               table_ids: Dict[str, torch.Tensor], mesh=None) -> None:
        """Legacy lazy update from the tables' dense gradients (JAX
        :682-702; on a mesh the gradients arrive summed over the batch
        shards, a row-sharded table's over the data column); the tables'
        .grad is released after."""
        def per_table(path, param, mn, t):
            name = path.rpartition(".")[2]
            ids = table_ids.get(name)
            if ids is None:
                raise ValueError(
                    f"lazyadam: no touched-row mapping for table {name}")
            if getattr(param, "mesh_rows", None) is not None:
                entries = self.table_update_sharded(param, param.grad, mn,
                                                    ids, t, mesh)
            else:
                if mesh is not None:
                    ids = col.all_gather(ids.reshape(-1).contiguous(),
                                         mesh.batch_group)
                entries = self.table_update(param, param.grad, mn, ids, t)
            param.grad = None
            return entries
        self._finish(model, state, per_table)
