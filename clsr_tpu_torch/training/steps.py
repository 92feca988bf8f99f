"""The train and eval steps.

Counterpart of clsr_tpu/training/steps.py.  The train step
(`make_train_step_fn`, :24-226; the single-device branches) is: on-device
in-batch negatives, the train-mode forward (dropout, batch-statistics BN
and its running-average update), the four-part loss, backward, then the
optimizer:

  * `adam` (:210-219): per-tensor clip and dense Adam over every
    parameter;
  * `lazyadam` with `compact_rows: auto`, the compact row engine
    (`compact_step`, :58-129): one sorted gather per table (of the pmn
    param|mu|nu rows, so the moments ride along), the model's lookups
    from those rows, the backward in w space, and training/lazy_adam.py's
    row update, two scatter-sets per table (the pmn rows and the table
    `Parameter`'s rows); the table `Parameter`s get no gradient;
  * `lazyadam` with `compact_rows: off`, the legacy lazy path (:210-215):
    dense table gradients, then the lazy update at the batch's ids, two
    scatter-sets per table.

All scatter-sets of a lazy step go out in one K5 launch.

The port runs the step eagerly on the model's device and updates the
state in place.  With use_pallas_train_attention on, both target-attention
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

The eval step (:331-364): BN running statistics, no dropout
(base_model.py:366-392); preds = sigmoid(logit) for classification
(base_model.py:89-109).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch.profiler import record_function

from clsr_tpu_torch.config import Config
from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.training.compact_rows import (build_plans, gather_ws,
                                                  make_context,
                                                  supported_tables)
from clsr_tpu_torch.training.lazy_adam import (LazyAdam, LazyAdamState,
                                               batch_table_ids, is_pmn)
from clsr_tpu_torch.training.losses import LossParts, total_loss
from clsr_tpu_torch.training.negative_sampling import expand_with_negatives
from clsr_tpu_torch.training.optimizer import clip_by_norm_each
from clsr_tpu_torch.training.state import TrainState


def make_train_step_fn(model: torch.nn.Module, cfg: Config,
                       allow_pallas: Optional[bool] = None) -> Callable[
        [TrainState, Batch, torch.Generator], Tuple[TrainState, LossParts]]:
    """The train step: (state, batch, generator) -> (state, LossParts).

    `batch` carries G = 1 (positives only) when cfg.need_sample, and
    1 + train_num_ngs candidates are drawn on its device from
    `generator`, which also draws the dropout masks; with need_sample
    False the batch's own candidates are used.  `allow_pallas` gates the
    fused train scorer; None defers to cfg.use_pallas_train_attention
    ('auto' = on for CUDA tensors).  After the step each parameter's
    `.grad` holds its clipped gradient, except the tables under
    lazyadam, which hold none."""
    if cfg.data_parallel * cfg.model_parallel > 1:
        raise NotImplementedError(
            "a device mesh waits for ROADMAP queue 1, parallel")
    num_ngs = cfg.train_num_ngs
    lazy = LazyAdam(cfg) if cfg.optimizer == "lazyadam" else None
    table_names = (supported_tables(model)
                   if lazy is not None and cfg.compact_rows != "off"
                   else None)

    def forward_backward(batch, generator, compact=None):
        with record_function("train_step.forward"):
            logits, aux = model(batch, generator=generator,
                                train_kernel=allow_pallas, compact=compact)
            parts = total_loss(cfg, logits, aux, batch, model)
        model.zero_grad(set_to_none=True)
        with record_function("train_step.backward"):
            parts.loss.backward()
        return parts

    def compact_step(state: TrainState, batch: Batch,
                     generator: torch.Generator) -> LossParts:
        """The compact row engine: the gathered rows w are leaves of the
        graph, their .grad is dL/dw, and no table Parameter is read."""
        opt = state.optimizer
        tables = {n: p for n, p in model.named_parameters()
                  if n in table_names}
        plans = build_plans(table_names, batch)
        fused = all(is_pmn(p, opt.moments[n]) for n, p in tables.items())
        ws_full = gather_ws({n: opt.moments[n] for n in tables} if fused
                            else tables, table_names, plans)
        ws = {table_names[n]: (ws_full[table_names[n]][:, :p.shape[1]]
                               .contiguous() if fused
                               else ws_full[table_names[n]]
                               ).requires_grad_()
              for n, p in tables.items()}
        parts = forward_backward(batch, generator, make_context(plans, ws))
        lazy.compact_update(model, opt, {k: w.grad for k, w in ws.items()},
                            plans, ws_full if fused else ws, table_names)
        return parts

    def step(state: TrainState, batch: Batch, generator: torch.Generator):
        if cfg.need_sample and num_ngs > 0:
            with record_function("train_step.negatives"):
                batch = expand_with_negatives(generator, batch, num_ngs)
        model.train()
        if table_names is not None:
            parts = compact_step(state, batch, generator)
        else:
            parts = forward_backward(batch, generator)
            if lazy is not None:
                lazy.update(model, state.optimizer, batch_table_ids(batch))
            else:
                if cfg.is_clip_norm:
                    with record_function("train_step.clip"):
                        clip_by_norm_each([p.grad for p in model.parameters()
                                           if p.grad is not None],
                                          cfg.max_grad_norm)
                with record_function("train_step.adam"):
                    state.optimizer.step()
        state.step += 1
        return state, LossParts(**{f.name: getattr(parts, f.name).detach()
                                   for f in dataclasses.fields(parts)})

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


def make_train_step(model: torch.nn.Module, cfg: Config) -> Callable[
        [TrainState, Batch, torch.Generator], Tuple[TrainState, LossParts]]:
    """The train step with the config's kernel gates.  Unlike the JAX
    package's, it needs no parameter sync after a step: every lazy
    update writes the touched table rows itself."""
    return make_train_step_fn(model, cfg)


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
