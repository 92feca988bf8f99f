"""The train and eval steps.

Counterpart of clsr_tpu/training/steps.py.  The train step
(`make_train_step_fn`, :24-226; the single-device branches) is: on-device
in-batch negatives, the train-mode forward (dropout, batch-statistics BN
and its running-average update), the four-part loss, backward, then the
optimizer:

  * `adam` and the other dense rules (:210-219): per-tensor clip and
    the config's optimizer (training/optimizer.py) over every parameter;
  * `lazyadam` with `compact_rows: auto`, the compact row engine
    (`compact_step`, :58-129): one sorted gather per table (of the pmn
    param|mu|nu rows, so the moments ride along), the model's lookups
    from those rows, the backward in w space, and training/lazy_adam.py's
    row update, two scatter-sets per table (the pmn rows and the table
    `Parameter`'s rows); the table `Parameter`s get no gradient;
  * `lazyadam` with `compact_rows: off`, the legacy lazy path (:210-215):
    dense table gradients, then the lazy update at the batch's ids, two
    scatter-sets per table.

NextItNet's per-position training (cfg.nextitnet_per_position, JAX
:52-55, :170-173) draws [B, G, L] targets (`expand_nextitnet`) in place
of [B, G] ones and takes the legacy lazy path under lazyadam, as JAX
turns the compact one off (lazy_adam.py:107-109); the captured and the
resident steps run it unchanged.

All scatter-sets of a lazy step go out in one K5 launch.

On a (data, model) mesh (parallel/mesh.py; JAX's `mesh_compact_step`,
:131-163, and `_step_inner`'s dispatch, :167-200) each rank runs the
step on its batch shard with the mesh active: the negatives are drawn
on the global batch, the losses are the rank's shares, `reduce_grads`
sums the dense gradients over the batch group (each row-sharded table
block's over the data column), and the table update is the compact
engine's broadcast merge on the pmn layout (training/mesh_compact.py),
else the legacy lazy update of the sharded blocks; the dense rules clip
a sharded table by its whole norm.  The LossParts returned are the
global ones, summed over the ranks' shares.

The port runs the step on the model's device and updates the state in
place.  With use_pallas_train_attention on, both target-attention
layers run K3a, K3b and K1; with use_pallas_scan, the recurrence runs K2
forward and recomputes through the plain recurrence in the backward.
Each phase runs under a `torch.profiler.record_function` range named
`train_step.<phase>` (negatives, forward, backward, row_update, clip,
adam), which costs nothing measurable unless a profiler is recording.
The JAX package's `make_train_step` refreshes the tables from pmn[:, :D]
after each step (`sync_params_from_opt`, :229-264); here the lazy update
writes the touched table rows in the same launch as the pmn rows, so the
tables equal pmn[:, :D] after every step without that O(N) copy, and
eval, serving and `weights.to_flax` read the updated rows.
`sync_params_from_opt` stays for callers that load optimizer rows whose
param column the tables do not hold yet.

K train steps a host call (`make_multi_train_step`, :267-290, and
`stack_batches`, :293): JAX scans K steps in one dispatch; here one
train step is captured in a CUDA graph and replayed K times a call
(`MultiTrainStep`), which the fit runs when train_steps_per_call > 1;
on a mesh too when its backend is nccl (JAX's
`make_sharded_multi_train_step`, parallel/mesh.py:220-271).  A mesh
step whose owner-routed merge may fall back reads its overflow counts
once (`Staged`): it is a head graph, the read, and a tail graph a
branch pattern.

Resident steps (clsr_tpu/data/resident.py:530-639): `make_resident_step`
and `make_resident_multi_step` gather each step's batch on the device
from an `EpochFeed` (data/resident.py) at its offset, inside the
captured step, one graph per dataset shape (each length bucket's Lb);
`make_bn_refresh_fn` (JAX steps.py:301-328) and
`make_resident_bn_refresh` re-estimate the BN running statistics with
forward-only train-mode passes.

The eval step (:331-364): BN running statistics, no dropout
(base_model.py:366-392); preds = sigmoid(logit) for classification
(base_model.py:89-109).

The histogram step (`make_histogram_step`, :398-442, with
`device_histogram`, :372-395): the eval-mode forward on a probe batch,
and for each tensor the reference streams to tf.summary.histogram a
64-bucket histogram computed on the device, so only the counts and the
range cross to the host.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

from clsr_tpu_torch.config import Config
from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.data.resident import (EpochFeed, ResidentDataset,
                                          gather_batch, gather_batch_mesh)
from clsr_tpu_torch.models.base import check_not_quantized
from clsr_tpu_torch.ops import launches
from clsr_tpu_torch.parallel import collectives as col
from clsr_tpu_torch.parallel.collectives import all_reduce
from clsr_tpu_torch.parallel.embedding import gather_rows
from clsr_tpu_torch.parallel.mesh import (Mesh, gather_rows_of, is_table,
                                          make_mesh, mesh_size,
                                          pad_batch_rows, shard_batch,
                                          sharded_tables, use_mesh)
from clsr_tpu_torch.training.compact_rows import (build_plans, gather_ws,
                                                  make_context,
                                                  supported_tables)
from clsr_tpu_torch.training.lazy_adam import (LazyAdam, LazyAdamState,
                                               MeshMerge, batch_table_ids,
                                               fused_tables_enabled, is_pmn,
                                               per_position)
from clsr_tpu_torch.training.losses import LossParts, total_loss
from clsr_tpu_torch.training.mesh_compact import (build_mesh_plans,
                                                  gather_mesh_ws)
from clsr_tpu_torch.training.negative_sampling import (expand_nextitnet,
                                                       expand_with_negatives,
                                                       on_global_batch)
from clsr_tpu_torch.training.optimizer import clip_by_norm_each
from clsr_tpu_torch.training.state import TrainState

LOSS_FIELDS = tuple(f.name for f in dataclasses.fields(LossParts))


def _mesh_of(cfg: Config, mesh: Optional[Mesh]) -> Optional[Mesh]:
    """The step's mesh: `mesh`, or for a mesh config the process group's
    (parallel/mesh.py make_mesh, which raises without one)."""
    if mesh is None and mesh_size(cfg) > 1:
        mesh = make_mesh(cfg)
    return mesh


@torch.no_grad()
def reduce_grads(model: torch.nn.Module, mesh: Mesh, batch: Batch) -> None:
    """Sum the batch shards' gradients, in place: the replicated
    parameters' over the batch group in one all_reduce of their
    concatenation, each row-sharded table block's over the data column
    (its model row holds the other blocks).  A block's rows that no rank
    of the column touched are zero on every rank, so only a fixed set of
    rows travels: the touched rows in ascending order, padded to the
    most rows the column's batch can touch (`_touched_bound`) with row
    0, whose padded sums are row 0's own sum.  The same sums in the same
    rank order, a batch's rows in place of the block's, and no host
    sync, so a CUDA graph can capture it.  `batch` is this rank's shard,
    negatives drawn."""
    dense = [p for n, p in model.named_parameters()
             if p.grad is not None and getattr(p, "mesh_rows", None) is None]
    if dense:
        flat = all_reduce(torch.cat([p.grad.reshape(-1) for p in dense]),
                          mesh.batch_group)
        for p, g in zip(dense, flat.split([p.numel() for p in dense])):
            p.grad.copy_(g.view_as(p.grad))
    ids = batch_table_ids(batch)
    for name, p in sharded_tables(model).items():
        if p.grad is None:
            continue
        n = _touched_bound(model, name, ids, mesh, p.shape[0])
        touched = all_reduce((p.grad != 0).any(1).to(torch.uint8),
                             mesh.data_group)
        # the k-th touched row: the first whose running count reaches k
        rows = torch.searchsorted(torch.cumsum(touched > 0, 0),
                                  torch.arange(1, n + 1,
                                               device=touched.device))
        rows = torch.where(rows < p.shape[0], rows, torch.zeros_like(rows))
        p.grad[rows] = all_reduce(p.grad[rows], mesh.data_group)


def _touched_bound(model: torch.nn.Module, name: str,
                   ids: Dict[str, torch.Tensor], mesh: Mesh,
                   rows: int) -> int:
    """The most rows of a table block the data column's gradients can
    touch: each of the n_batch batch shards looks up its ids (a flat
    batch's model row hands a block its shards' rows, a replicated
    batch's the one shard's), capped at the block's rows; every row for
    a model that reads whole tables (LGN) or a table without known
    ids."""
    table_ids = ids.get(name.rpartition(".")[2])
    if table_ids is None or getattr(model, "reads_whole_tables", False):
        return rows
    return min(rows, mesh.n_batch * table_ids.numel())


def _clip_dense(model: torch.nn.Module, cfg: Config,
                mesh: Optional[Mesh]) -> None:
    """Per-tensor clip of every gradient; a row-sharded table's norm is
    its whole table's (summed over the model row)."""
    params = [p for p in model.parameters() if p.grad is not None]
    sumsq = None
    if mesh is not None:
        def sumsq(s, i):
            if getattr(params[i], "mesh_rows", None) is None:
                return s
            return all_reduce(s, mesh.model_group)
    clip_by_norm_each([p.grad for p in params], cfg.max_grad_norm, sumsq)


def _global_parts(parts: LossParts, mesh: Mesh) -> LossParts:
    """The global loss parts: the ranks' shares summed (no gradient)."""
    return _parts(all_reduce(_row(parts), mesh.batch_group))


def _make_step_body(model: torch.nn.Module, cfg: Config,
                    allow_pallas: Optional[bool],
                    mesh: Optional[Mesh] = None) -> Callable[
        [TrainState, Batch, torch.Generator], LossParts]:
    """The device work of one train step, from the negatives to the
    optimizer: (state, batch, generator) -> LossParts (not detached).
    It touches no host state but the tensors of `state`, so a CUDA graph
    can capture it; `make_train_step_fn` documents the step.  On a mesh
    `batch` is this rank's shard and the parts are the global ones
    (detached)."""
    mesh = _mesh_of(cfg, mesh)
    if mesh is not None:
        unplaced = [n for n, p in model.named_parameters()
                    if is_table(n) and mesh.sharded(p.shape[0])
                    and getattr(p, "mesh_rows", None) is None]
        if unplaced:
            raise ValueError(f"tables {unplaced} are not row-sharded: "
                             f"place the model (parallel.mesh.place_model) "
                             f"before making its state and steps")
    check_not_quantized(model)
    num_ngs = cfg.train_num_ngs
    lazy = LazyAdam(cfg) if cfg.optimizer == "lazyadam" else None
    expand = (expand_nextitnet if per_position(cfg)
              else expand_with_negatives)
    table_names = (supported_tables(model)
                   if fused_tables_enabled(cfg, model) else None)

    def forward_backward(batch, generator, compact=None):
        with record_function("train_step.forward"):
            logits, aux = model(batch, generator=generator,
                                train_kernel=allow_pallas, compact=compact)
            parts = total_loss(cfg, logits, aux, batch, model)
        model.zero_grad(set_to_none=True)
        with record_function("train_step.backward"):
            parts.loss.backward()
        if mesh is not None:
            with record_function("train_step.reduce_grads"):
                reduce_grads(model, mesh, batch)
        return parts

    def compact_step(state: TrainState, batch: Batch,
                     generator: torch.Generator) -> LossParts:
        """The compact row engine: the gathered rows w are leaves of the
        graph, their .grad is dL/dw, and no table Parameter is read."""
        opt = state.optimizer
        tables = {n: p for n, p in model.named_parameters()
                  if n in table_names}
        if mesh is not None:
            return mesh_compact_step(state, batch, generator, tables)
        fused = all(is_pmn(p, opt.moments[n]) for n, p in tables.items())
        plans = build_plans(table_names, batch)
        ws_full = gather_ws({n: opt.moments[n] for n in tables} if fused
                            else tables, table_names, plans)
        # pmn: the param lane in the table's dtype (exact: it holds the
        # table's rounded rows), so the gradient is of that dtype too
        ws = {table_names[n]: (ws_full[table_names[n]][:, :p.shape[1]]
                               .to(p.dtype).contiguous() if fused
                               else ws_full[table_names[n]]
                               ).requires_grad_()
              for n, p in tables.items()}
        parts = forward_backward(batch, generator, make_context(plans, ws))
        lazy.compact_update(model, opt, {k: w.grad for k, w in ws.items()},
                            plans, ws_full if fused else ws, table_names)
        return parts, None

    def mesh_compact_step(state: TrainState, batch: Batch,
                          generator: torch.Generator, tables
                          ) -> Tuple[LossParts, MeshMerge]:
        """The compact row engine on the mesh (JAX :131-163,
        training/mesh_compact.py): this rank's plans with the global
        merge order, one collective row gather per table, the w-space
        backward on the rank's rows, and the merges, to finish
        (`MeshMerge`)."""
        opt = state.optimizer
        plans = build_mesh_plans(table_names, batch, mesh)
        ws_full = gather_mesh_ws(
            {n: opt.moments[n] for n in tables}, table_names, plans, mesh,
            {n: getattr(p, "mesh_rows", None) is not None
             for n, p in tables.items()})
        ws = {table_names[n]: ws_full[table_names[n]][:, :p.shape[1]]
              .to(p.dtype).contiguous().requires_grad_()
              for n, p in tables.items()}
        parts = forward_backward(batch, generator, make_context(plans, ws))
        return parts, lazy.compact_mesh_update(
            model, opt, {k: w.grad for k, w in ws.items()}, plans,
            table_names, mesh)

    def compact_applies(state: TrainState) -> bool:
        """The compact engine runs; on a mesh only on the pmn layout (JAX
        :167-200: a split layout takes the legacy path there)."""
        if table_names is None:
            return False
        if mesh is None:
            return True
        params = dict(model.named_parameters())
        return all(is_pmn(params[n], state.optimizer.moments[n])
                   for n in table_names)

    def run(state: TrainState, batch: Batch, generator: torch.Generator
            ) -> Tuple[LossParts, Optional[MeshMerge]]:
        """The step; on a mesh under the compact engine its merges are
        left to finish."""
        if cfg.need_sample and num_ngs > 0:
            with record_function("train_step.negatives"):
                batch = on_global_batch(expand, generator, batch, num_ngs,
                                        per_position(cfg))
        model.train()
        if compact_applies(state):
            return compact_step(state, batch, generator)
        parts = forward_backward(batch, generator)
        if lazy is not None:
            lazy.update(model, state.optimizer, batch_table_ids(batch),
                        mesh)
        else:
            if cfg.is_clip_norm:
                with record_function("train_step.clip"):
                    _clip_dense(model, cfg, mesh)
            with record_function("train_step.adam"):
                state.optimizer.step()
        return parts, None

    def stage(state: TrainState, batch: Batch, generator: torch.Generator
              ) -> Staged:
        """The step up to its one host read, if it has one."""
        if mesh is None:
            return Staged(_row(run(state, batch, generator)[0]), None)
        with use_mesh(mesh):
            parts, merge = run(state, batch, generator)
            row = _row(_global_parts(parts, mesh))
            if merge is not None and merge.counts is None:
                merge.finish()
                merge = None
        if merge is not None:
            finish = merge.finish

            def finish_on_mesh(pattern=()):
                with use_mesh(mesh):
                    finish(pattern)
            merge = MeshMerge(merge.counts, finish_on_mesh)
        return Staged(row, merge)

    def body(state: TrainState, batch: Batch, generator: torch.Generator
             ) -> LossParts:
        return _parts(_run_eager(stage(state, batch, generator)))

    body.mesh = mesh
    body.stage = stage
    return body


def make_train_step_fn(model: torch.nn.Module, cfg: Config,
                       allow_pallas: Optional[bool] = None,
                       mesh: Optional[Mesh] = None) -> Callable[
        [TrainState, Batch, torch.Generator], Tuple[TrainState, LossParts]]:
    """The train step: (state, batch, generator) -> (state, LossParts).

    `batch` carries G = 1 (positives only) when cfg.need_sample, and
    1 + train_num_ngs candidates are drawn on its device from
    `generator`, which also draws the dropout masks; with need_sample
    False the batch's own candidates are used.  `allow_pallas` gates the
    fused train scorer; None defers to cfg.use_pallas_train_attention
    ('auto' = on for CUDA tensors).  After the step each parameter's
    `.grad` holds its clipped gradient, except the tables under
    lazyadam, which hold none.

    On a mesh (`mesh`, or the process group's for a mesh config) the
    model's tables must be placed (parallel/mesh.py `place_model`)
    before its state is made; `batch` is this rank's shard of the global
    batch, the step is the global batch's (negatives, dropout masks and
    BN statistics of the global batch, gradients summed over the
    shards), and the LossParts are the global ones on every rank."""
    body = _make_step_body(model, cfg, allow_pallas, mesh)

    def step(state: TrainState, batch: Batch, generator: torch.Generator):
        parts = body(state, batch, generator)
        state.step += 1
        return state, LossParts(**{f: getattr(parts, f).detach()
                                   for f in LOSS_FIELDS})

    return step


@torch.no_grad()
def sync_params_from_opt(state: TrainState) -> TrainState:
    """Refresh the table Parameters from pmn rows (param = pmn[:, :D]),
    as after loading optimizer rows (`weights.opt_from_flax`) that the
    tables do not hold; a no-op for every other optimizer or layout."""
    opt = state.optimizer
    if not isinstance(opt, LazyAdamState):
        return state
    params = dict(state.model.named_parameters())
    for name, mn in opt.moments.items():
        p = params[name]
        if is_pmn(p, mn):
            p.copy_(mn[:, :p.shape[1]])
    return state


def make_train_step(model: torch.nn.Module, cfg: Config,
                    mesh: Optional[Mesh] = None) -> Callable[
        [TrainState, Batch, torch.Generator], Tuple[TrainState, LossParts]]:
    """The train step with the config's kernel gates.  Unlike the JAX
    package's, it needs no parameter sync after a step: every lazy
    update writes the touched table rows itself."""
    return make_train_step_fn(model, cfg, mesh=mesh)


def _fields(batch: Batch) -> List[torch.Tensor]:
    return [getattr(batch, f.name) for f in dataclasses.fields(Batch)]


def stack_batches(batches: Sequence[Batch]) -> Batch:
    """Stack K same-shape batches of tensors into one [K, B, ...] batch
    (JAX :293)."""
    return Batch(*(torch.stack(ts) for ts in zip(*map(_fields, batches))))


def _row(parts: LossParts) -> torch.Tensor:
    """The loss parts as one [len(LOSS_FIELDS)] tensor."""
    return torch.stack([getattr(parts, f).detach() for f in LOSS_FIELDS])


def _parts(rows: torch.Tensor) -> LossParts:
    """LossParts of [..., len(LOSS_FIELDS)] rows, a field a column."""
    return LossParts(**{f: rows[..., i] for i, f in enumerate(LOSS_FIELDS)})


@dataclasses.dataclass
class Staged:
    """A train step run up to its one host read: the global loss parts
    [len(LOSS_FIELDS)], and `merge`, the update left to finish after the
    read (training/lazy_adam.py `MeshMerge`: on a mesh, the owner-routed
    merge under `mesh_owner_overflow: fallback`), or None when the step
    is whole."""

    row: torch.Tensor
    merge: Optional[MeshMerge]


def _run_eager(staged: Staged, warmed: Optional[set] = None
               ) -> torch.Tensor:
    """Finish a staged step eagerly (its one host read, then the branches
    it picks); its loss row.  The pattern joins `warmed`, the patterns
    whose finish has run eagerly and may now be captured."""
    if staged.merge is not None:
        pattern = staged.merge.pattern()
        staged.merge.finish(pattern)
        if warmed is not None:
            warmed.add(pattern)
    return staged.row


def graph_refusal(mesh: Optional[Mesh], device: torch.device
                  ) -> Optional[str]:
    """Why steps on `device` (and `mesh`) run eagerly, or None when a
    CUDA graph captures them: a CUDA device, and on a mesh the nccl
    backend."""
    if torch.device(device).type != "cuda":
        return "the tensors are on the CPU"
    if mesh is not None:
        backend = dist.get_backend(mesh.world)
        if backend != "nccl":
            return (f"the mesh's backend is {backend}: a CUDA graph "
                    f"cannot capture its host-staged collectives (nccl's "
                    f"run on the card's stream)")
    return None


class MultiTrainStep:
    """K train steps a host call (JAX's `make_multi_train_step`,
    :267-290): `multi(state, stacked, generator)` runs the steps of a
    [K, B, ...] batch in order and returns (state, LossParts of [K]),
    what K calls of `make_train_step` on its slices give; `step(state,
    batch, generator)` runs one [B] batch (an epoch's tail).

    On CPU tensors every step runs eagerly.  On CUDA the step from the
    negatives to the optimizer is captured once in a `torch.cuda.CUDAGraph`
    that reads static [B, ...] batch buffers, and each step copies its
    slice into them (one `_foreach_copy_`), replays the graph and copies
    out its loss parts: a few launches a step in place of the eager
    step's thousands.  The padded tail batches have the same shape, so
    the one graph serves them too.  The graph needs:

      * a warm-up: the first step after a (re)bind runs eagerly, a real
        step of the fit, which builds the kernels, Adam's state, the K1
        and K3 workspaces and cuBLAS's (on a mesh also the process
        groups' NCCL communicators); the next step is captured, and
        every later one replays;
      * the fit's generator registered with the graph, so that replay i
        draws the negatives and dropout masks eager step i would;
      * capturable Adam (training/optimizer.py) and lazyadam's device
        step count (training/lazy_adam.py), so that the step reads
        nothing from the host;
      * the launch counters and the collective-byte count: a wrapper
        ticks and a collective records once at capture and never at
        replay, so the capture's counts and calls are taken back and
        added after every replay (`ops.launches`,
        `parallel.collectives.replayed`).

    On a (data, model) mesh the same holds when the mesh's backend is
    nccl (a card a rank; `graph_refusal`): the graph captures the step's
    collectives, and every rank captures and replays in lockstep.  A
    step with a host read (`Staged`: the owner merge's overflow counts
    under `fallback`) is captured as a head graph up to the counts, then
    the one read, then one tail graph for each branch pattern seen, each
    captured at its pattern's second use, after an eager warm-up of the
    pattern's tail, in a pool of its own.  The counts are world sums, so
    every rank picks the same pattern.  Under gloo the steps run
    eagerly (a graph cannot capture gloo's host-staged collectives).

    `.grad` and the captured outputs live in the graphs' pools and hold
    the last replay's values until the next replay.  The graphs keep
    the state's tensors: `reset()` drops them (Trainer.load does, since
    loading replaces the optimizers' tensors), and a call with another
    state or generator warms up and captures again.  A capture that
    fails raises; no CUDA step falls back to the eager step."""

    def __init__(self, model: torch.nn.Module, cfg: Config,
                 steps_per_call: int, mesh: Optional[Mesh] = None):
        self.steps_per_call = steps_per_call
        self._body = _make_step_body(model, cfg, None, mesh)
        self.capture_stats: Optional[dict] = None
        self.reset()

    def reset(self) -> None:
        """Drop the graphs; the next CUDA step warms up and captures."""
        self._bound = None          # (state, generator) of the warm-up
        self._captured: Optional[_CapturedStep] = None
        self._static: List[torch.Tensor] = []
        self._warmed: set = set()   # patterns whose tail ran eagerly

    def __call__(self, state: TrainState, stacked: Batch,
                 generator: torch.Generator
                 ) -> Tuple[TrainState, LossParts]:
        K = stacked.users.shape[0]
        if K != self.steps_per_call:
            raise ValueError(f"a stacked batch of {K} steps, this call "
                             f"runs {self.steps_per_call}")
        rows = [self._step(state, Batch(*(t[i] for t in _fields(stacked))),
                           generator) for i in range(K)]
        return state, _parts(torch.stack(rows))

    def step(self, state: TrainState, batch: Batch,
             generator: torch.Generator) -> Tuple[TrainState, LossParts]:
        return state, _parts(self._step(state, batch, generator))

    def _step(self, state, batch, generator) -> torch.Tensor:
        """One step; its loss parts as a [len(LOSS_FIELDS)] tensor."""
        on_card = graph_refusal(self._body.mesh, batch.users.device) is None
        bound = (self._bound is not None and self._bound[0] is state
                 and self._bound[1] is generator)
        if on_card and bound:
            if self._captured is None:
                # the callable keeps no reference to self: a cycle would
                # leave the graphs to the garbage collector
                body = self._body
                static = self._static = [t.clone() for t in _fields(batch)]
                self._captured = _CapturedStep(
                    lambda: body.stage(state, Batch(*static), generator),
                    generator, batch.users.device, self._warmed)
            torch._foreach_copy_(self._static, _fields(batch))
            row = self._captured.run()
            self.capture_stats = self._captured.stats
        else:
            if on_card:             # the warm-up of a new binding
                self.reset()
                self._bound = (state, generator)
            row = _run_eager(self._body.stage(state, batch, generator),
                             self._warmed)
        state.step += 1
        return row


@dataclasses.dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    out: object                 # what the captured callable returned
    counts: Dict[str, int]      # the launches a replay adds
    calls: list                 # the collectives a replay adds
    stats: dict

    def replay(self):
        self.graph.replay()
        launches.add(self.counts)
        col.replayed(self.calls)
        return self.out


class _CapturedStep:
    """A step captured as CUDA graphs (see `MultiTrainStep`): the head,
    `stage()` (the whole step, or up to its host read), and a tail a
    branch pattern; `run()` replays them, tails captured or warmed up as
    they come, and returns a clone of the step's loss row."""

    def __init__(self, stage: Callable[[], Staged],
                 generator: torch.Generator, device: torch.device,
                 warmed: set):
        self._stage, self._generator, self._device = stage, generator, \
            device
        self._warmed = warmed
        self._head: Optional[_Graph] = None
        self._tails: Dict[Tuple[bool, ...], _Graph] = {}
        self.stats: Optional[dict] = None

    def run(self) -> torch.Tensor:
        if self._head is None:
            self._head = _capture_step(self._stage, self._generator,
                                       self._device)
            self.stats = dict(self._head.stats, tails=0)
        staged = self._head.replay()
        if staged.merge is not None:
            pattern = staged.merge.pattern()
            tail = self._tails.get(pattern)
            if tail is None and pattern in self._warmed:
                tail = self._tails[pattern] = _capture_step(
                    lambda: staged.merge.finish(pattern), None,
                    self._device)
                st = self.stats
                self.stats = dict(
                    st, capture_s=st["capture_s"] + tail.stats["capture_s"],
                    pool_bytes=st["pool_bytes"] + tail.stats["pool_bytes"],
                    tails=st["tails"] + 1)
            if tail is None:        # the pattern's eager warm-up
                staged.merge.finish(pattern)
                self._warmed.add(pattern)
            else:
                tail.replay()
        return staged.row.clone()


def _capture_step(run: Callable[[], object],
                  generator: Optional[torch.Generator],
                  device: torch.device) -> _Graph:
    """Capture `run` (a train step or a part of one) in a CUDA graph of
    its own memory pool, with `generator` registered (if any): the
    graph, what `run` returned, the launch counts and collective calls a
    replay adds, and stats.  Capturing runs nothing, so the counters'
    ticks are taken back and the calls recorded apart."""
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    before = launches.snapshot()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    t0 = time.perf_counter()
    # no garbage collection inside the capture: collecting a dead object
    # that holds another CUDA graph would destroy that graph mid-capture,
    # which invalidates the capture
    collecting = gc.isenabled()
    gc.disable()
    try:
        # thread_local: the prefetch thread may pin host memory and copy
        # on its own stream, and NCCL's watchdog thread queries events,
        # while the step is captured
        with col.capturing() as calls, \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = run()
    except RuntimeError as e:
        raise RuntimeError(
            f"capturing the train step in a CUDA graph failed: {e}"
            + (f" (while: {e.__context__})" if e.__context__ else "")
        ) from e
    finally:
        if collecting:
            gc.enable()
    counts = {n: k - before[n] for n, k in launches.snapshot().items()}
    launches.add(counts, -1)     # the capture launched nothing
    counts = {n: k for n, k in counts.items() if k}
    stats = dict(capture_s=time.perf_counter() - t0,
                 pool_bytes=torch.cuda.memory_reserved(device) - reserved,
                 launches=counts)
    return _Graph(graph, out, counts, calls, stats)


def make_multi_train_step(model: torch.nn.Module, cfg: Config,
                          steps_per_call: int,
                          mesh: Optional[Mesh] = None) -> MultiTrainStep:
    """K = steps_per_call train steps a host call (JAX :267-290); see
    `MultiTrainStep`."""
    return MultiTrainStep(model, cfg, steps_per_call, mesh)


def make_resident_step(model: torch.nn.Module, cfg: Config,
                       mesh: Optional[Mesh] = None) -> Callable[
        [TrainState, EpochFeed, int, torch.Generator],
        Tuple[TrainState, LossParts]]:
    """One resident step, eagerly (JAX resident.py:577-603):
    (state, feed, offset, generator) -> (state, LossParts), the batch
    gathered from feed's rows [offset, offset + B).  Unlike JAX's, it
    needs no `sync_params_from_opt` at its end: the lazy update writes the
    table rows itself (`make_train_step`).  On a mesh (JAX :448-485) the
    feed is the rank's block and gathers the rank's share."""
    step = make_train_step_fn(model, cfg, mesh=mesh)
    B = cfg.batch_size

    def run(state: TrainState, feed: EpochFeed, offset: int,
            generator: torch.Generator):
        feed.offset.fill_(offset)
        return step(state, feed.batch(B), generator)

    return run


class ResidentMultiStep:
    """K resident steps a host call (JAX resident.py:606-639):
    `multi(state, feed, offset, generator, steps=K)` runs `steps` train
    steps on the batches of feed's rows [offset, offset + steps * B) and
    returns (state, LossParts of [steps]), what as many eager steps give.

    On CPU tensors every step runs eagerly.  On CUDA the step, from the
    gather (`EpochFeed.batch`: the permutation at the device offset, the
    valid mask and `gather_batch`) to the optimizer and the offset's
    advance, is captured in a `torch.cuda.CUDAGraph`, one for each feed
    (a length bucket's Lb is a shape of its own), each in a memory pool
    of its own, since the buckets' calls come in a shuffled order.  A
    call fills the offset once and replays: it sends the device one
    scalar and no batch.  As in `MultiTrainStep`, the first step on a
    feed after a (re)bind to a state and generator runs eagerly (its
    warm-up, a real step), the next is captured, the fit's generator is
    registered with every graph, and each replay adds its capture's
    launch counts and collective calls.  A feed must keep its tensors
    for the graph's life (`EpochFeed.set_epoch` writes in place);
    `reset()` drops every graph.  `.grad` holds whichever graph's last
    values; nothing reads it between steps.  A capture that fails
    raises.

    On a mesh (JAX :488-527) the feeds are the rank's blocks; the steps
    are graphed under nccl as `MultiTrainStep`'s (one head graph a feed
    a rank, and its tails a branch pattern), and run eagerly under
    gloo."""

    def __init__(self, model: torch.nn.Module, cfg: Config,
                 steps_per_call: int, mesh: Optional[Mesh] = None):
        self.steps_per_call = steps_per_call
        self.batch_size = cfg.batch_size
        self._body = _make_step_body(model, cfg, None, mesh)
        self.reset()

    def reset(self) -> None:
        """Drop every graph; each feed's next CUDA step warms up again."""
        self._bound = None          # (state, generator)
        self._feeds: Dict[int, EpochFeed] = {}   # warmed up, by id
        self._warmed: Dict[int, set] = {}        # a feed's warm patterns
        self._graphs: Dict[int, _CapturedStep] = {}
        self.capture_stats: Dict[int, dict] = {}  # by the feed's Lb

    def __call__(self, state: TrainState, feed: EpochFeed, offset: int,
                 generator: torch.Generator, steps: Optional[int] = None
                 ) -> Tuple[TrainState, LossParts]:
        steps = self.steps_per_call if steps is None else steps
        feed.offset.fill_(offset)
        rows = [self._step(state, feed, generator) for _ in range(steps)]
        return state, _parts(torch.stack(rows))

    def _step(self, state, feed, generator) -> torch.Tensor:
        body, B = self._body, self.batch_size

        def stage():            # no reference to self, as MultiTrainStep's
            return body.stage(state, feed.batch(B), generator)
        if graph_refusal(self._body.mesh, feed.perm.device) is not None:
            row = _run_eager(stage())
        else:
            if not (self._bound is not None and self._bound[0] is state
                    and self._bound[1] is generator):
                self.reset()
                self._bound = (state, generator)
            key = id(feed)
            if self._feeds.get(key) is not feed:     # its warm-up
                self._feeds[key] = feed
                self._warmed[key] = set()
                self._graphs.pop(key, None)
                row = _run_eager(stage(), self._warmed[key])
            else:
                if key not in self._graphs:
                    self._graphs[key] = _CapturedStep(
                        stage, generator, feed.perm.device,
                        self._warmed[key])
                graph = self._graphs[key]
                row = graph.run()
                self.capture_stats[feed.res.seq_len] = graph.stats
        state.step += 1
        return row


def make_resident_multi_step(model: torch.nn.Module, cfg: Config,
                             steps_per_call: int,
                             mesh: Optional[Mesh] = None
                             ) -> ResidentMultiStep:
    """K = steps_per_call resident steps a host call; see
    `ResidentMultiStep`."""
    return ResidentMultiStep(model, cfg, steps_per_call, mesh)


def make_bn_refresh_fn(model: torch.nn.Module, cfg: Config,
                       mesh: Optional[Mesh] = None) -> Callable[
        [TrainState, Batch, torch.Generator], TrainState]:
    """Forward-only BN running-statistics refresh (JAX steps.py:301-328):
    (state, batch, generator) -> state.  The train-mode forward (the
    in-batch negatives, dropout, batch-statistics BN) under no_grad; the
    port's BN updates its running buffers in place, and nothing else of
    the state changes: no gradient, no optimizer, no step.  The length-
    bucketed epoch runs it over bucket-interleaved batches before the
    eval, since its K-step calls are each one bucket's and longer than
    the running averages' horizon.  On a mesh `batch` is the rank's
    share, the negatives are drawn on the global batch and the BN
    statistics are the global batch's."""
    num_ngs = cfg.train_num_ngs

    @torch.no_grad()
    def refresh(state: TrainState, batch: Batch,
                generator: torch.Generator) -> TrainState:
        with use_mesh(mesh):
            if cfg.need_sample and num_ngs > 0:
                batch = on_global_batch(expand_with_negatives, generator,
                                        batch, num_ngs)
            model.train()
            model(batch, generator=generator)
        return state

    return refresh


def make_resident_bn_refresh(model: torch.nn.Module, cfg: Config,
                             mesh: Optional[Mesh] = None
                             ) -> Callable[[TrainState, ResidentDataset,
                                            torch.Tensor, torch.Generator],
                                           TrainState]:
    """The refresh on resident rows (JAX resident.py:530-575):
    (state, res, idx [B], generator) -> state, every row valid; on a
    mesh `res` is the rank's block (`gather_batch_mesh`)."""
    refresh = make_bn_refresh_fn(model, cfg, mesh)

    def run(state: TrainState, res: ResidentDataset, idx: torch.Tensor,
            generator: torch.Generator) -> TrainState:
        valid = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
        batch = (gather_batch(res, idx, valid) if mesh is None
                 else gather_batch_mesh(res, idx, valid, mesh))
        return refresh(state, batch, generator)

    return run


def make_eval_step_fn(cfg: Config) -> Callable[
        [torch.nn.Module, Batch], Tuple[torch.Tensor, torch.Tensor]]:
    """The eval step: (model, batch) -> (preds [B, G], alpha [B, G]).

    The eval scorer kernel follows cfg.use_pallas_eval_attention, which
    the model's attention layers read ('auto' = on for CUDA tensors)."""

    def step(model: torch.nn.Module, batch: Batch):
        model.eval()
        with torch.inference_mode():
            logits, aux = model(batch)
            preds = (torch.sigmoid(logits)
                     if cfg.method == "classification" else logits)
            alpha = aux.get("alpha")
            if alpha is None:
                alpha = torch.zeros_like(preds)
        return preds, alpha

    return step


# (aux key, tag): the reference's tag names (clsr.py:111-276); the
# logits stream under 'logit' (JAX steps.py:415-422)
HISTOGRAM_AUX_TAGS = (("alpha", "alpha"), ("att_fea_long", "att_fea_long"),
                      ("att_fea_short", "att_fea2"),
                      ("model_output", "model_output"))


def device_histogram(x: torch.Tensor, nbins: int) -> Tuple[torch.Tensor, ...]:
    """(counts [nbins] int32, lo, hi, n_nonfinite) of `x` on its device
    (JAX `_device_histogram`): the buckets span the finite values' [lo,
    hi] (an all-non-finite tensor gets [0, 0]), a value's bucket is
    int((x - lo) / max(hi - lo, 1e-12) * nbins) clipped to the last
    bucket, in f32, and the non-finite values are counted apart.  The
    integer sums are exact in any order."""
    x = x.float().reshape(-1)
    finite = torch.isfinite(x)
    inf = torch.tensor(float("inf"), device=x.device)
    lo = torch.where(finite, x, inf).min()
    hi = torch.where(finite, x, -inf).max()
    zero = torch.zeros((), device=x.device)
    lo = torch.where(torch.isfinite(lo), lo, zero)
    hi = torch.where(torch.isfinite(hi), hi, zero)
    span = torch.clamp_min(hi - lo, 1e-12)
    idx = ((torch.where(finite, x, lo) - lo) / span * nbins).to(
        torch.int32).clamp(0, nbins - 1)
    counts = torch.zeros(nbins, dtype=torch.int32, device=x.device)
    counts.index_add_(0, idx, finite.to(torch.int32))
    return counts, lo, hi, (~finite).sum().to(torch.int32)


def make_histogram_step(nbins: int = 64, mesh: Optional[Mesh] = None
                        ) -> Callable[[torch.nn.Module, Batch],
                                      Dict[str, Tuple[torch.Tensor, ...]]]:
    """The activation-histogram step (JAX :398-442), like the eval step
    a function of (model, batch) -> {tag: (counts, lo, hi,
    n_nonfinite)}, from the eval-mode forward (running BN statistics, no
    dropout) on `batch`: the logits, the aux tensors of
    HISTOGRAM_AUX_TAGS the model returns, and for each table the batch
    touches (`batch_table_ids`) its gathered rows as `<table>_output`.

    On a mesh (`mesh`; JAX's step is one jit over the sharded state)
    every rank calls it with the global batch: it scores the rank's rows
    (padded to a multiple of the batch shards, as the sharded eval
    step), gathers the shards' logits and aux tensors in order and cuts
    the padding, and reads a row-sharded table's rows at the global ids
    from their owners (`gather_rows`' replicated-batch lookup: exact);
    so every rank holds the global histograms, the one-rank step's up
    to the forward's rounding."""

    def table_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        if mesh is None or getattr(table, "mesh_rows", None) is None:
            return table[ids]
        # every rank holds the global ids: the replicated-batch lookup
        return gather_rows(table, ids, dataclasses.replace(mesh, flat=False))

    def forward(model: torch.nn.Module, batch: Batch):
        if mesh is None:
            return model(batch)
        rows = batch.users.shape[0]
        local = shard_batch(pad_batch_rows(batch, mesh.n_batch), mesh)
        with use_mesh(mesh):
            logits, aux = model(local)
        whole = lambda t: gather_rows_of(t, mesh)[:rows]
        return whole(logits), {key: whole(aux[key])
                               for key, _ in HISTOGRAM_AUX_TAGS
                               if key in aux}

    def step(model: torch.nn.Module, batch: Batch):
        model.eval()
        with torch.inference_mode():
            logits, aux = forward(model, batch)
            hists = {"logit": device_histogram(logits, nbins)}
            for key, tag in HISTOGRAM_AUX_TAGS:
                if key in aux:
                    hists[tag] = device_histogram(aux[key], nbins)
            ids = batch_table_ids(batch)
            for name, table in model.named_parameters():
                if name in ids and table.dim() == 2:
                    rows = table_rows(table, ids[name].reshape(-1).long())
                    hists[f"{name}_output"] = device_histogram(rows, nbins)
        return hists

    return step
