"""Evaluation loop.

Counterpart of clsr_tpu/training/evaluator.py:26-105 (the reference's
SequentialBaseModel.run_weighted_eval, sequential_base_model.py:244-292):
device inference per batch, then host-side metrics over the pointwise
rows, the (num_ngs + 1)-sized groups and the per-user weighted metrics.
The grouped loader packs each group into one batch row with G targets,
so preds [B, G] are the groups, and their row-major order is the file's.

Phase 1 moves the batches to the device (`data.prefetch`, with
cfg.prefetch_batches in flight) and issues every eval step, keeping the
predictions on the device; phase 2 copies them to the host once and
assembles the metrics.  A dispatch takes max(1, batch_size // group)
groups, as in the JAX package (5 groups of 100 on the test split with
the CLI's defaults).  Under cfg.length_buckets the groups are bucketed
by the anchor row's history length (`resolve_bucket_paddings` over the
anchors, JAX :34-46), each bucket's batches at its Lb; eval-mode BN reads
the running statistics and the metrics do not depend on the groups'
order.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from clsr_tpu_torch.config import Config
from clsr_tpu_torch.data.loader import SequenceLoader
from clsr_tpu_torch.data.prefetch import device_batches
from clsr_tpu_torch.data.resident import resolve_bucket_paddings
from clsr_tpu_torch.metrics import (cal_mean_alpha_metric, cal_metric,
                                    cal_weighted_metric)


def _predict(eval_step: Callable, model: torch.nn.Module, batches,
             cfg: Config, with_alpha: bool):
    """([(users, labels, valid rows)] of each host batch, preds
    [n, B, G], alpha or None) over `batches`, the predictions copied to
    the host once at the end."""
    device = next(model.parameters()).device
    host = []

    def tap(it):
        for b in it:            # runs in the producer: host fields only
            host.append((b.users, b.labels, int(b.valid.sum())))
            yield b

    preds, alphas = [], []
    for batch in device_batches(tap(batches), device, cfg.prefetch_batches):
        p, a = eval_step(model, batch)
        preds.append(p)
        alphas.append(a)
    if not preds:
        return host, None, None
    preds = torch.stack(preds).cpu().numpy()
    alphas = torch.stack(alphas).cpu().numpy() if with_alpha else None
    return host, preds, alphas


def run_weighted_eval(eval_step: Callable, model: torch.nn.Module,
                      loader: SequenceLoader, cfg: Config, num_ngs: int,
                      batch_groups: Optional[int] = None,
                      calc_mean_alpha: bool = False) -> Dict[str, float]:
    """The metrics dict of `model` on `loader`'s grouped rows.  The JAX
    package passes the train state; the port's eval step reads the
    model, so the model is passed."""
    group = num_ngs + 1
    if batch_groups is None:
        batch_groups = max(1, cfg.batch_size // group)
    paddings = None
    if cfg.length_buckets != "off":
        anchors = np.arange(0, len(loader.view.labels), group)
        paddings = resolve_bucket_paddings(
            cfg, loader.view.lengths[anchors]) or None
    host, preds, alphas = _predict(
        eval_step, model,
        loader.eval_batches(group_size=group, batch_groups=batch_groups,
                            min_seq_length=cfg.min_seq_length,
                            paddings=paddings),
        cfg, calc_mean_alpha)

    users_all, preds_all, labels_all, alphas_all = [], [], [], []
    group_preds, group_labels = [], []
    for i, (users, labels, nv) in enumerate(host):
        p = preds[i, :nv]
        labels = labels[:nv]
        group_preds.append(p)
        group_labels.append(labels)
        users_all.append(np.repeat(users[:nv], group))
        preds_all.append(p.reshape(-1))
        labels_all.append(labels.reshape(-1))
        if calc_mean_alpha:
            alphas_all.append(alphas[i, :nv].reshape(-1))

    users = np.concatenate(users_all)
    flat_preds = np.concatenate(preds_all)
    labels = np.concatenate(labels_all)
    gp = np.concatenate(group_preds, axis=0)
    gl = np.concatenate(group_labels, axis=0)

    res = cal_metric(labels, flat_preds, cfg.metrics)
    res.update(cal_metric(gl, gp, cfg.pairwise_metrics))
    res.update(cal_weighted_metric(users, flat_preds, labels,
                                   cfg.weighted_metrics))
    if calc_mean_alpha:
        res.update(cal_mean_alpha_metric(np.concatenate(alphas_all), labels))
    return res


def predict_to_file(eval_step: Callable, model: torch.nn.Module,
                    loader: SequenceLoader, cfg: Config, out_path: str,
                    batch_groups: Optional[int] = None) -> None:
    """Write the sigmoid scores, one per input line
    (sequential_base_model.py:326-347)."""
    if batch_groups is None:
        batch_groups = cfg.batch_size
    host, preds, _ = _predict(
        eval_step, model,
        loader.eval_batches(group_size=1, batch_groups=batch_groups), cfg,
        False)
    with open(out_path, "w") as f:
        for i, (_, _, nv) in enumerate(host):
            f.write("\n".join(str(x) for x in preds[i, :nv].reshape(-1)))
            f.write("\n")
