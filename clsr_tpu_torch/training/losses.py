"""Loss assembly: the four-part CLSR objective (clsr.py:22-34).

Counterpart of clsr_tpu/training/losses.py:41-200:
  loss = data + regular + contrastive + discrepancy (+ the opt-in attn)

  * data — grouped softmax over the 1 + num_ngs candidates, the mean
    over valid rows of -log p(positive) (base_model.py:215-235), or a
    pointwise loss (:191-214);
  * regular — L2/L1: the lazy embedding L2 over the unique rows the
    batch touched (aux["embed_sumsq"]) plus every parameter whose name
    does not end in `_embedding` (tf.nn.l2_loss = sum(x^2)/2);
  * contrastive — triplet or bpr over the four (anchor, pos, neg)
    orderings of {att_fea_long, att_fea_short, hist_mean, hist_recent},
    on rows with seq_len > contrastive_length_threshold, times
    contrastive_loss_weight (clsr.py:46-71);
  * discrepancy — the NEGATIVE mean squared difference of the two user
    tables' involved rows (clsr.py:73-82);
  * attn (cfg.use_attn_loss) — attn_loss_weight * mse(alpha,
    attn_labels) over valid rows.

Every mean respects Batch.valid.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from clsr_tpu_torch.config import Config
from clsr_tpu_torch.data.batch import Batch


@dataclasses.dataclass
class LossParts:
    loss: torch.Tensor
    data_loss: torch.Tensor
    regular_loss: torch.Tensor
    contrastive_loss: torch.Tensor
    discrepancy_loss: torch.Tensor


def layer_param_sums(model: nn.Module
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of squares, sum of abs) over every parameter that is not an
    embedding table (a name ending in `_embedding`)."""
    sumsq = sumabs = 0.0
    for name, p in model.named_parameters():
        if name.rpartition(".")[2].endswith("_embedding"):
            continue
        sumsq = sumsq + (p * p).sum()
        sumabs = sumabs + p.abs().sum()
    return sumsq, sumabs


def data_loss_fn(cfg: Config, logits: torch.Tensor, labels: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """logits/labels [B, G], valid [B]."""
    n_valid = valid.sum().clamp_min(1.0)
    if cfg.loss == "softmax":
        logp = F.log_softmax(logits, dim=-1)
        pos_logp = (logp * labels).sum(-1)                   # [B]
        return -(pos_logp * valid).sum() / n_valid
    wflat = valid[:, None].expand(logits.shape)
    denom = wflat.sum().clamp_min(1.0)
    if cfg.loss == "cross_entropy_loss":
        ce = (torch.clamp(logits, min=0.0) - logits * labels
              + torch.log1p(torch.exp(-logits.abs())))
        return (ce * wflat).sum() / denom
    pred = (torch.sigmoid(logits) if cfg.method == "classification"
            else logits)
    if cfg.loss == "square_loss":
        return torch.sqrt(((pred - labels) ** 2 * wflat).sum() / denom)
    if cfg.loss == "log_loss":
        eps = 1e-7  # tf.losses.log_loss epsilon
        ll = -(labels * torch.log(pred + eps)
               + (1.0 - labels) * torch.log(1.0 - pred + eps))
        return (ll * wflat).sum() / denom
    raise ValueError(f"this loss not defined {cfg.loss}")


def regular_loss_fn(cfg: Config, model: nn.Module,
                    aux: Dict[str, Any]) -> torch.Tensor:
    layer_sumsq, layer_sumabs = layer_param_sums(model)
    embed_sumsq = aux.get("embed_sumsq", 0.0)
    l2 = 0.5 * cfg.embed_l2 * embed_sumsq + 0.5 * cfg.layer_l2 * layer_sumsq
    l1 = cfg.layer_l1 * layer_sumabs
    if cfg.embed_l1:
        l1 = l1 + cfg.embed_l1 * aux.get("embed_sumabs", 0.0)
    return l2 + l1


def contrastive_loss_fn(cfg: Config, aux: Dict[str, Any], batch: Batch
                        ) -> torch.Tensor:
    """clsr.py:46-71 over the [B, G] grid."""
    short_f = aux["att_fea_short"]                            # [B, G, D]
    B, G, D = short_f.shape
    long_f = aux["att_fea_long"][:, None, :].expand(B, G, D)
    mean_f = aux["hist_mean"][:, None, :].expand(B, G, D)
    recent_f = aux["hist_recent"][:, None, :].expand(B, G, D)
    cmask = ((aux["seq_len"] > cfg.contrastive_length_threshold).float()
             * batch.valid)[:, None].expand(B, G)
    denom = cmask.sum().clamp_min(1.0)

    def masked_mean(per_row):                                 # [B, G]
        return (cmask * per_row).sum() / denom

    if cfg.contrastive_loss == "bpr":
        def bpr(anchor, pos, neg):
            return masked_mean(F.softplus((anchor * (neg - pos)).sum(-1)))
        loss = (bpr(long_f, mean_f, recent_f)
                + bpr(short_f, recent_f, mean_f)
                + bpr(mean_f, long_f, short_f)
                + bpr(recent_f, short_f, long_f))
    elif cfg.contrastive_loss == "triplet":
        margin = cfg.triplet_margin
        d_lm = (long_f - mean_f) ** 2
        d_lr = (long_f - recent_f) ** 2
        d_sm = (short_f - mean_f) ** 2
        d_sr = (short_f - recent_f) ** 2

        def trip(d_ap, d_an):
            return masked_mean(torch.clamp(d_ap - d_an + margin,
                                           min=0.0).sum(-1))
        loss = (trip(d_lm, d_lr) + trip(d_sr, d_sm)
                + trip(d_lm, d_sm) + trip(d_sr, d_lr))
    else:
        raise ValueError(cfg.contrastive_loss)
    return cfg.contrastive_loss_weight * loss


def discrepancy_loss_fn(cfg: Config, aux: Dict[str, Any]) -> torch.Tensor:
    """clsr.py:73-82 — note the NEGATIVE sign."""
    count = torch.as_tensor(aux["discrepancy_count"], dtype=torch.float32)
    mean_sq = aux["discrepancy_sumsq"] / count.clamp_min(1.0)
    return -cfg.discrepancy_loss_weight * mean_sq


def attn_loss_fn(cfg: Config, aux: Dict[str, Any], batch: Batch
                 ) -> torch.Tensor:
    """attn_loss_weight * mse(alpha, attn_labels) over valid rows."""
    alpha = aux["alpha"]                                      # [B, G]
    w = batch.valid[:, None].expand(alpha.shape)
    mse = ((alpha - aux["attn_labels"]) ** 2 * w).sum() / w.sum().clamp_min(
        1.0)
    return cfg.attn_loss_weight * mse


def total_loss(cfg: Config, logits: torch.Tensor, aux: Dict[str, Any],
               batch: Batch, model: nn.Module) -> LossParts:
    data = data_loss_fn(cfg, logits, batch.labels, batch.valid)
    regular = regular_loss_fn(cfg, model, aux)
    if cfg.model_type.lower() == "clsr":
        contrastive = contrastive_loss_fn(cfg, aux, batch)
        discrepancy = discrepancy_loss_fn(cfg, aux)
    else:
        contrastive = discrepancy = torch.zeros((), device=logits.device)
    loss = data + regular + contrastive + discrepancy
    if cfg.use_attn_loss and "alpha" in aux and "attn_labels" in aux:
        loss = loss + attn_loss_fn(cfg, aux, batch)
    return LossParts(loss=loss, data_loss=data, regular_loss=regular,
                     contrastive_loss=contrastive,
                     discrepancy_loss=discrepancy)
