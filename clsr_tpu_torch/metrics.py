"""Evaluation metrics.

The port's copy of clsr_tpu/metrics.py (plain numpy, no JAX), kept here
so that the port imports nothing of the JAX package.  It reimplements
the metric semantics of the reference's
reco_utils/recommender/deeprec/deeprec_utils.py:554-821 in vectorized
numpy:

  * pointwise: auc / rmse / logloss / acc / f1          (cal_metric :621-653)
  * grouped  : mean_mrr / ndcg@k / hit@k / group_auc    (cal_metric :655-699,
               primitives mrr:554 ndcg:570 hit:585 dcg:603)
  * weighted : wauc / wmrr / whit@k / wndcg@k           (cal_weighted_metric
               :702-811) — per-user metrics weighted by the user's share of
               eval rows
  * mean_alpha (cal_mean_alpha_metric :813-821)

Semantic details preserved exactly:
  * Ranking ties are broken like `np.argsort(scores)[::-1]`: descending
    score, ties broken by *descending original index* — so an earlier row
    (the positive is row 0 of each group) loses ties.
  * Results are rounded to 4 decimals.
  * logloss clamps predictions to [1e-11, 1 - 1e-11] (the reference's
    `10e-12` literal).
  * rmse rounds the MSE to 4 decimals *before* the square root.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np


# --------------------------------------------------------------------------
# primitives (general, per ranking list)
# --------------------------------------------------------------------------

def _descending_order(y_score: np.ndarray) -> np.ndarray:
    """Indices sorting scores descending with reference tie-breaking."""
    return np.argsort(y_score, kind="stable")[::-1]


def mrr_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    y_true = np.asarray(y_true, dtype=np.float64)
    order = _descending_order(np.asarray(y_score))
    ranked = np.take(y_true, order)
    rr = ranked / (np.arange(len(ranked)) + 1)
    return float(np.sum(rr) / np.sum(ranked))


def dcg_score(y_true: np.ndarray, y_score: np.ndarray, k: int = 10) -> float:
    y_true = np.asarray(y_true, dtype=np.float64)
    k = min(y_true.shape[-1], k)
    order = _descending_order(np.asarray(y_score))
    ranked = np.take(y_true, order[:k])
    gains = 2 ** ranked - 1
    discounts = np.log2(np.arange(len(ranked)) + 2)
    return float(np.sum(gains / discounts))


def ndcg_score(y_true: np.ndarray, y_score: np.ndarray, k: int = 10) -> float:
    best = dcg_score(y_true, y_true, k)
    actual = dcg_score(y_true, y_score, k)
    return float(actual / best)


def hit_score(y_true: np.ndarray, y_score: np.ndarray, k: int = 10) -> float:
    y_true = np.asarray(y_true)
    order = _descending_order(np.asarray(y_score))[:k]
    return 1.0 if np.any(y_true[order] == 1) else 0.0


def binary_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """ROC AUC for binary labels via the rank statistic (ties averaged).

    Numerically identical to sklearn.metrics.roc_auc_score for binary
    labels, which the reference uses (deeprec_utils.py:632-634, :689-696).
    """
    y_true = np.asarray(y_true, dtype=np.float64)
    y_score = np.asarray(y_score, dtype=np.float64)
    n_pos = float(np.sum(y_true == 1))
    n_neg = float(len(y_true) - n_pos)
    if n_pos == 0 or n_neg == 0:
        raise ValueError("binary_auc needs both classes present")
    # average ranks with tie correction
    order = np.argsort(y_score, kind="stable")
    ranks = np.empty(len(y_score), dtype=np.float64)
    sorted_scores = y_score[order]
    # group ties: assign average rank within each tie-group
    ranks_sorted = np.arange(1, len(y_score) + 1, dtype=np.float64)
    boundaries = np.flatnonzero(np.diff(sorted_scores) != 0) + 1
    groups = np.split(ranks_sorted, boundaries)
    avg = np.concatenate([np.full(len(g), g.mean()) for g in groups])
    ranks[order] = avg
    pos_rank_sum = float(np.sum(ranks[y_true == 1]))
    return (pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


# --------------------------------------------------------------------------
# vectorized fast paths for equal-size groups with exactly one positive
# --------------------------------------------------------------------------

def _single_positive_rank(group_labels: np.ndarray, group_preds: np.ndarray):
    """0-based rank of the positive under reference tie-breaking, or None.

    Valid only when each group has exactly one positive.  Under
    `argsort(scores)[::-1]`, within a tie the *larger original index* comes
    first, so the positive's rank = (#strictly greater) + (#ties at a later
    index). Both counts are exact for arbitrary positive position.
    """
    labels = np.asarray(group_labels, dtype=np.float64)
    preds = np.asarray(group_preds, dtype=np.float64)
    if labels.ndim != 2 or not np.all(labels.sum(axis=1) == 1):
        return None
    pos_idx = np.argmax(labels == 1, axis=1)
    rows = np.arange(labels.shape[0])
    pos_score = preds[rows, pos_idx]
    greater = (preds > pos_score[:, None]).sum(axis=1)
    tied_later = (
        (preds == pos_score[:, None])
        & (np.arange(labels.shape[1])[None, :] > pos_idx[:, None])
    ).sum(axis=1)
    return greater + tied_later


def _grouped_arrays(labels, preds):
    """Coerce list-of-lists / 2D input into 2D arrays if rectangular."""
    try:
        la = np.asarray(labels, dtype=np.float64)
        pa = np.asarray(preds, dtype=np.float64)
    except ValueError:
        return None, None
    if la.ndim == 2 and pa.shape == la.shape:
        return la, pa
    return None, None


def _mean_mrr(labels, preds) -> float:
    la, pa = _grouped_arrays(labels, preds)
    if la is not None:
        ranks = _single_positive_rank(la, pa)
        if ranks is not None:
            return float(np.mean(1.0 / (ranks + 1)))
    return float(np.mean([mrr_score(l, p) for l, p in zip(labels, preds)]))


def _mean_ndcg(labels, preds, k: int) -> float:
    la, pa = _grouped_arrays(labels, preds)
    if la is not None:
        ranks = _single_positive_rank(la, pa)
        if ranks is not None:
            kk = min(la.shape[1], k)
            vals = np.where(ranks < kk, 1.0 / np.log2(ranks + 2), 0.0)
            return float(np.mean(vals))
    return float(np.mean([ndcg_score(l, p, k) for l, p in zip(labels, preds)]))


def _mean_hit(labels, preds, k: int) -> float:
    la, pa = _grouped_arrays(labels, preds)
    if la is not None:
        ranks = _single_positive_rank(la, pa)
        if ranks is not None:
            return float(np.mean(ranks < min(la.shape[1], k)))
    return float(np.mean([hit_score(l, p, k) for l, p in zip(labels, preds)]))


def _group_auc(labels, preds) -> float:
    la, pa = _grouped_arrays(labels, preds)
    if la is not None:
        ranks = _single_positive_rank(la, pa)
        if ranks is not None:
            # For 1 positive vs (G-1) negatives with average-tie AUC:
            # auc = (#neg strictly below + 0.5 * #tied) / #neg.
            pos_idx = np.argmax(la == 1, axis=1)
            rows = np.arange(la.shape[0])
            pos_score = pa[rows, pos_idx]
            below = (pa < pos_score[:, None]).sum(axis=1)
            tied = (pa == pos_score[:, None]).sum(axis=1) - 1  # exclude self
            n_neg = la.shape[1] - 1
            return float(np.mean((below + 0.5 * tied) / n_neg))
    return float(np.mean([binary_auc(l, p) for l, p in zip(labels, preds)]))


def _parse_at_k(metric: str) -> List[int]:
    """Parse 'ndcg@2;4;6' style metric names (deeprec_utils.py:663-667)."""
    parts = metric.split("@")
    if len(parts) > 1:
        return [int(tok) for tok in parts[1].split(";")]
    return [1, 2]


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def cal_metric(labels, preds, metrics: Iterable[str]) -> Dict[str, float]:
    """Pointwise & grouped metrics, mirroring deeprec_utils.cal_metric:621."""
    res: Dict[str, float] = {}
    if not metrics:
        return res
    for metric in metrics:
        if metric == "auc":
            res["auc"] = round(binary_auc(np.asarray(labels), np.asarray(preds)), 4)
        elif metric == "rmse":
            mse = float(np.mean((np.asarray(labels, dtype=np.float64)
                                 - np.asarray(preds, dtype=np.float64)) ** 2))
            res["rmse"] = float(np.sqrt(round(mse, 4)))
        elif metric == "logloss":
            p = np.clip(np.asarray(preds, dtype=np.float64), 10e-12, 1.0 - 10e-12)
            y = np.asarray(labels, dtype=np.float64)
            ll = float(np.mean(-(y * np.log(p) + (1 - y) * np.log(1 - p))))
            res["logloss"] = round(ll, 4)
        elif metric == "acc":
            pred = (np.asarray(preds, dtype=np.float64) >= 0.5).astype(np.float64)
            res["acc"] = round(float(np.mean(pred == np.asarray(labels))), 4)
        elif metric == "f1":
            pred = (np.asarray(preds, dtype=np.float64) >= 0.5).astype(np.float64)
            y = np.asarray(labels, dtype=np.float64)
            tp = float(np.sum((pred == 1) & (y == 1)))
            fp = float(np.sum((pred == 1) & (y == 0)))
            fn = float(np.sum((pred == 0) & (y == 1)))
            f1 = 2 * tp / (2 * tp + fp + fn) if (2 * tp + fp + fn) > 0 else 0.0
            res["f1"] = round(f1, 4)
        elif metric == "mean_mrr":
            res["mean_mrr"] = round(_mean_mrr(labels, preds), 4)
        elif metric.startswith("ndcg"):
            for k in _parse_at_k(metric):
                res[f"ndcg@{k}"] = round(_mean_ndcg(labels, preds, k), 4)
        elif metric.startswith("hit"):
            for k in _parse_at_k(metric):
                res[f"hit@{k}"] = round(_mean_hit(labels, preds, k), 4)
        elif metric == "group_auc":
            res["group_auc"] = round(_group_auc(labels, preds), 4)
        else:
            raise ValueError(f"not define this metric {metric}")
    return res


def cal_weighted_metric(users, preds, labels, metrics: Iterable[str]) -> Dict[str, float]:
    """Per-user metrics weighted by the user's share of eval rows.

    Mirrors deeprec_utils.cal_weighted_metric:702-811 (pandas groupby
    semantics) with a sort-based numpy groupby.
    """
    res: Dict[str, float] = {}
    if not metrics:
        return res
    users = np.asarray(users)
    preds = np.asarray(preds, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.float64)

    order = np.argsort(users, kind="stable")
    su, sp, sl = users[order], preds[order], labels[order]
    uniq, starts = np.unique(su, return_index=True)
    bounds = np.append(starts, len(su))
    counts = np.diff(bounds).astype(np.float64)
    weights = counts / counts.sum()

    slices = [(sl[bounds[i]:bounds[i + 1]], sp[bounds[i]:bounds[i + 1]])
              for i in range(len(uniq))]

    for metric in metrics:
        if metric == "wauc":
            per_user = np.array([binary_auc(l, p) for l, p in slices])
            res["wauc"] = round(float(np.sum(weights * per_user)), 4)
        elif metric == "wmrr":
            per_user = np.array([mrr_score(l, p) for l, p in slices])
            res["wmrr"] = round(float(np.sum(weights * per_user)), 4)
        elif metric.startswith("whit"):
            for k in _parse_at_k(metric):
                per_user = np.array([hit_score(l, p, k) for l, p in slices])
                res[f"whit@{k}"] = round(float(np.sum(weights * per_user)), 4)
        elif metric.startswith("wndcg"):
            for k in _parse_at_k(metric):
                per_user = np.array([ndcg_score(l, p, k) for l, p in slices])
                res[f"wndcg@{k}"] = round(float(np.sum(weights * per_user)), 4)
        else:
            raise ValueError(f"not define this metric {metric}")
    return res


def cal_mean_alpha_metric(alphas, labels) -> Dict[str, float]:
    """Label-weighted mean fusion weight (deeprec_utils.py:813-821)."""
    alphas = np.asarray(alphas, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.float64)
    return {"mean_alpha": round(float((alphas * labels).sum() / labels.sum()), 4)}
