"""The train and eval steps.

Counterpart of clsr_tpu/training/steps.py.  The train step
(`make_train_step_fn`, :24-226, its dense single-device branch
:167-219) is: on-device in-batch negatives, the train-mode forward
(dropout, batch-statistics BN and its running-average update), the
four-part loss, backward, the per-tensor clip, Adam.  The port runs it
eagerly on the model's device and updates the state in place.  With
use_pallas_train_attention on, both target-attention layers run K3a,
K3b and K1; with use_pallas_scan, the recurrence runs K2 forward and
recomputes through the plain recurrence in the backward.  Each phase
runs under a `torch.profiler.record_function` range named
`train_step.<phase>` (negatives, forward, backward, clip, adam), which
costs nothing measurable unless a profiler is recording.

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
    `.grad` holds its clipped gradient."""
    if cfg.optimizer == "lazyadam":
        raise NotImplementedError(
            "optimizer lazyadam (and its compact row engine) waits for "
            "ROADMAP queue 1, LazyAdam and the compact row engine")
    if cfg.data_parallel * cfg.model_parallel > 1:
        raise NotImplementedError(
            "a device mesh waits for ROADMAP queue 1, parallel")
    num_ngs = cfg.train_num_ngs

    def step(state: TrainState, batch: Batch, generator: torch.Generator):
        if cfg.need_sample and num_ngs > 0:
            with record_function("train_step.negatives"):
                batch = expand_with_negatives(generator, batch, num_ngs)
        model.train()
        with record_function("train_step.forward"):
            logits, aux = model(batch, generator=generator,
                                train_kernel=allow_pallas)
            parts = total_loss(cfg, logits, aux, batch, model)
        state.optimizer.zero_grad(set_to_none=True)
        with record_function("train_step.backward"):
            parts.loss.backward()
        if cfg.is_clip_norm:
            with record_function("train_step.clip"):
                clip_by_norm_each([p.grad for p in model.parameters()
                                   if p.grad is not None], cfg.max_grad_norm)
        with record_function("train_step.adam"):
            state.optimizer.step()
        state.step += 1
        return state, LossParts(**{f.name: getattr(parts, f.name).detach()
                                   for f in dataclasses.fields(parts)})

    return step


def make_train_step(model: torch.nn.Module, cfg: Config) -> Callable[
        [TrainState, Batch, torch.Generator], Tuple[TrainState, LossParts]]:
    """The train step with the config's kernel gates."""
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
