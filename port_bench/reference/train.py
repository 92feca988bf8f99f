"""The plain train step: in-batch negatives, the loss, the gradient, and
lazy Adam on the tables with per-tensor clipped Adam on the rest.

Written from the reference's definitions (clsr.py's four-part loss,
base_model.py's grouped softmax and per-variable `tf.clip_by_norm`,
tf.contrib.opt's LazyAdamOptimizer as `optimizer: lazyadam` selects it),
independent of the program under test:

  * negatives: for each row, `num_ngs` draws uniform over the batch's
    real rows' positives, a draw equal to the row's own positive drawn
    again, in a fixed number of rounds.  The numbers come from a
    `torch.Generator` seeded as the run's, drawing float64 uniforms
    [B, num_ngs] a round, so the reference draws the negatives the
    timed path drew;
  * loss = data + regular + contrastive + discrepancy (the last two for
    CLSR only), every mean over the batch's real rows;
  * tables: the rows the batch touches (histories with their padding id
    and every candidate; the users) move, with the gradient clipped by
    its norm and Adam's bias correction at the global step; the others
    keep their rows and moments;
  * every other tensor: clipped to `max_grad_norm` by its own norm, then
    Adam.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from reference import model as M

B1, B2, EPS = 0.9, 0.999, 1e-8
NEGATIVE_ROUNDS = 8


def _draw(gen, shape, n_valid, device):
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
    return torch.minimum((u * n_valid).long(), n_valid - 1)


def add_negatives(gen: torch.Generator, batch: Dict[str, torch.Tensor],
                  num_ngs: int) -> Dict[str, torch.Tensor]:
    """[B] positives -> [B, 1 + num_ngs] candidates, column 0 positive."""
    items, cates = batch["items"], batch["cates"]
    B = items.shape[0]
    n_valid = batch["valid"].to(torch.int64).sum().clamp_min(1)
    idx = _draw(gen, (B, num_ngs), n_valid, items.device)
    for _ in range(1, NEGATIVE_ROUNDS):
        collide = items[idx] == items[:, None]
        fresh = _draw(gen, (B, num_ngs), n_valid, items.device)
        idx = torch.where(collide, fresh, idx)
    out = dict(batch)
    out["items"] = torch.cat([items[:, None], items[idx]], 1)
    out["cates"] = torch.cat([cates[:, None], cates[idx]], 1)
    labels = torch.zeros(out["items"].shape, dtype=torch.float32,
                         device=items.device)
    labels[:, 0] = 1.0
    out["labels"] = labels
    return out


def losses(P, logits, aux, batch, cfg) -> Dict[str, torch.Tensor]:
    valid = batch["valid"]
    n_valid = valid.sum().clamp_min(1.0)
    logp = F.log_softmax(logits, -1)
    data = -((logp * batch["labels"]).sum(-1) * valid).sum() / n_valid
    layer_sumsq = sum((p * p).sum() for n, p in P.items()
                      if not M.is_table(n))
    regular = (0.5 * cfg["embed_l2"] * aux["embed_sumsq"]
               + 0.5 * cfg["layer_l2"] * layer_sumsq)
    zero = torch.zeros((), device=logits.device)
    contrastive = discrepancy = zero
    if cfg["model_type"].lower() == "clsr":
        short = aux["att_fea_short"]
        B, G, D = short.shape
        long = aux["att_fea_long"][:, None, :].expand(B, G, D)
        mean = aux["hist_mean"][:, None, :].expand(B, G, D)
        recent = aux["hist_recent"][:, None, :].expand(B, G, D)
        cmask = ((aux["seq_len"] > cfg["contrastive_length_threshold"])
                 .float() * valid)[:, None].expand(B, G)
        denom = cmask.sum().clamp_min(1.0)
        margin = cfg["triplet_margin"]

        def trip(d_ap, d_an):
            per = torch.clamp(d_ap - d_an + margin, min=0.0).sum(-1)
            return (cmask * per).sum() / denom
        d_lm, d_lr = (long - mean) ** 2, (long - recent) ** 2
        d_sm, d_sr = (short - mean) ** 2, (short - recent) ** 2
        contrastive = cfg["contrastive_loss_weight"] * (
            trip(d_lm, d_lr) + trip(d_sr, d_sm) + trip(d_lm, d_sm)
            + trip(d_sr, d_lr))
        discrepancy = (-cfg["discrepancy_loss_weight"]
                       * aux["discrepancy_sumsq"]
                       / max(aux["discrepancy_count"], 1.0))
    loss = data + regular + contrastive + discrepancy
    return dict(loss=loss, data_loss=data, regular_loss=regular,
                contrastive_loss=contrastive, discrepancy_loss=discrepancy)


def touched_ids(batch) -> Dict[str, torch.Tensor]:
    items = torch.cat([batch["item_hist"].reshape(-1),
                       batch["items"].reshape(-1)])
    cates = torch.cat([batch["cate_hist"].reshape(-1),
                       batch["cates"].reshape(-1)])
    return {"item_embedding": items, "cate_embedding": cates,
            "user_long_embedding": batch["users"],
            "user_short_embedding": batch["users"]}


class PlainTrainer:
    """The parameters, BN statistics and optimizer moments of the plain
    model, stepped one batch at a time."""

    def __init__(self, weights: Dict[str, torch.Tensor], cfg: dict,
                 seed: int, device):
        self.cfg = cfg
        self.P = {n: t.detach().clone().requires_grad_()
                  for n, t in weights.items() if not M.is_buffer(n)}
        self.S = {n: t.detach().clone() for n, t in weights.items()
                  if M.is_buffer(n)}
        self.m = {n: torch.zeros_like(p) for n, p in self.P.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.P.items()}
        self.t = 0
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.grads: Dict[str, torch.Tensor] = {}

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        cfg = self.cfg
        batch = add_negatives(self.gen, batch, cfg["train_num_ngs"])
        logits, aux, new_stats = M.forward(self.P, self.S, batch, cfg,
                                           train=True)
        parts = losses(self.P, logits, aux, batch, cfg)
        grads = torch.autograd.grad(parts["loss"], list(self.P.values()),
                                    allow_unused=True)
        M.running_update(self.S, new_stats)
        self.t += 1
        self.grads = self._update(dict(zip(self.P, grads)),
                                  touched_ids(batch))
        return {k: float(v.detach()) for k, v in parts.items()}

    @torch.no_grad()
    def _update(self, grads, touched) -> Dict[str, torch.Tensor]:
        """Apply the step; the clipped gradients the optimizer took."""
        cfg, t = self.cfg, self.t
        lr, max_norm = cfg["learning_rate"], cfg["max_grad_norm"]
        bc1, bc2 = 1.0 - B1 ** t, 1.0 - B2 ** t
        taken = {}
        for name, p in self.P.items():
            g = grads[name]
            if g is None:
                g = torch.zeros_like(p)
            norm = torch.linalg.vector_norm(g)
            if norm > max_norm:
                g = g * (max_norm / norm)
            taken[name] = g
            m, v = self.m[name], self.v[name]
            if M.is_table(name):
                rows = torch.unique(touched[name])
                gr = g[rows]
                m[rows] = B1 * m[rows] + (1 - B1) * gr
                v[rows] = B2 * v[rows] + (1 - B2) * gr * gr
                p[rows] -= lr * (m[rows] / bc1) / (
                    torch.sqrt(v[rows] / bc2) + EPS)
            else:
                m.mul_(B1).add_((1 - B1) * g)
                v.mul_(B2).add_((1 - B2) * g * g)
                p -= (lr / bc1) * m / (torch.sqrt(v) / bc2 ** 0.5 + EPS)
        return taken


def follow(weights, cfg, seed, batches: List[Dict[str, torch.Tensor]],
           device) -> Tuple[List[float], Dict[str, float], Dict[str, float]]:
    """Run the plain steps over `batches` from `weights`: each step's
    loss, each leaf's norm of the first step's clipped gradient (what
    the optimizer took), and each leaf's norm of its change after the
    last step."""
    tr = PlainTrainer(weights, cfg, seed, device)
    step_losses, first = [], {}
    for i, b in enumerate(batches):
        parts = tr.step(b)
        step_losses.append(parts["loss"])
        if i == 0:
            first = {n: float(torch.linalg.vector_norm(g))
                     for n, g in tr.grads.items()}
    change = {n: float(torch.linalg.vector_norm(
        p.detach() - weights[n].to(p.device))) for n, p in tr.P.items()}
    return step_losses, first, change
