"""CLSR and SLI-Rec as plain float32 PyTorch, over a dict of named tensors.

The benchmark's yardstick: written from the published models (CLSR,
WWW '22, and SLI-Rec, IJCAI '19, as the reference repository's TF1 code
builds them) in plain tensor operations, with no kernel, no cache and
no batching trick, and independent of the program under test.  The
parameter names are the program's state_dict keys, so one weights dict
made by the benchmark serves both sides.

Where the plain form and the program's differ in algebra only, the plain
form is the published one:

  * the attention scorer's first layer reads the concatenation
    [k, q, k - q, k * q] (4 Dq wide) at every (row, position, candidate);
  * each recurrent cell multiplies [x_t, h] by its whole kernel at every
    step (TF1's cell), with the masked carry-through of dynamic_rnn;
  * batch normalisation takes E[x^2] - E[x]^2 over every axis but the
    last in train mode (flax's), the running statistics in eval mode.

`forward(P, S, batch, cfg, train)` returns the logits [B, G], the aux
terms the losses read and, in train mode, each BN layer's batch mean and
variance (`running_update` folds them into the running statistics).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

BN_EPS = 1e-4
BN_MOMENTUM = 0.95
MASK_PAD = -(2.0 ** 32) + 1


def dims(cfg: dict) -> dict:
    """The widths a model reads from its flat configuration."""
    T = cfg["item_embedding_dim"] + cfg["cate_embedding_dim"]
    return dict(I=cfg["item_embedding_dim"], C=cfg["cate_embedding_dim"],
                U=cfg["user_embedding_dim"], H=cfg["hidden_size"],
                A=cfg["attention_size"], T=T,
                att=tuple(cfg["att_fcn_layer_sizes"]),
                head=tuple(cfg["layer_sizes"]), L=cfg["max_seq_length"])


def _fcn_specs(prefix: str, in_dim: int, sizes, split_first: bool = False):
    """A dense stack with BN after each hidden layer: (name, shape, init)."""
    out = []
    width = in_dim
    for i, size in enumerate(sizes):
        if i == 0 and split_first:
            out.append((f"{prefix}.w_nn_layer0.kernel", (4 * in_dim, size),
                        "tnormal"))
        else:
            out.append((f"{prefix}.w_nn_layer{i}.weight", (size, width),
                        "tnormal"))
        out += [(f"{prefix}.w_nn_layer{i}.bias", (size,), "zeros"),
                (f"{prefix}.bn{i}.scale", (size,), "ones"),
                (f"{prefix}.bn{i}.bias", (size,), "zeros"),
                (f"{prefix}.bn{i}.mean", (size,), "zeros"),
                (f"{prefix}.bn{i}.var", (size,), "ones")]
        width = size
    out += [(f"{prefix}.w_nn_output.weight", (1, width), "tnormal"),
            (f"{prefix}.w_nn_output.bias", (1,), "zeros")]
    return out


def _attention_specs(prefix: str, dq: int, dk: int, sizes):
    return ([(f"{prefix}.attention_mat", (dk, dq), "tnormal")]
            + _fcn_specs(f"{prefix}.att_fcn", dq, sizes, split_first=True))


def _gru_specs(prefix: str, d: int, h: int):
    return [(f"{prefix}gate_kernel", (d + h, 2 * h), "glorot"),
            (f"{prefix}gate_bias", (2 * h,), "ones"),
            (f"{prefix}cand_kernel", (d + h, h), "glorot"),
            (f"{prefix}cand_bias", (h,), "zeros")]


def _time4lstm_specs(prefix: str, d: int, h: int):
    return [(f"{prefix}time_input_w1", (h,), "glorot"),
            (f"{prefix}time_input_bias1", (h,), "zeros"),
            (f"{prefix}time_input_w2", (h,), "glorot"),
            (f"{prefix}time_input_bias2", (h,), "zeros"),
            (f"{prefix}time_kernel_w1", (d, h), "glorot"),
            (f"{prefix}time_kernel_t1", (h, h), "glorot"),
            (f"{prefix}time_bias1", (h,), "zeros"),
            (f"{prefix}time_kernel_w2", (d, h), "glorot"),
            (f"{prefix}time_kernel_t2", (h, h), "glorot"),
            (f"{prefix}time_bias2", (h,), "zeros"),
            (f"{prefix}o_kernel_t1", (h, h), "glorot"),
            (f"{prefix}o_kernel_t2", (h, h), "glorot"),
            (f"{prefix}kernel", (d + h, 4 * h), "glorot"),
            (f"{prefix}bias", (4 * h,), "zeros")]


def param_specs(cfg: dict, n_users: int, n_items: int, n_cates: int
                ) -> List[Tuple[str, tuple, str]]:
    """Every tensor of the model as (name, shape, init): `tnormal` is the
    configuration's initialiser, `glorot` TF1's default of the recurrent
    kernels, `zeros` and `ones` constants; BN running statistics are the
    `.mean` / `.var` entries."""
    d = dims(cfg)
    T, U, H = d["T"], d["U"], d["H"]
    specs = [("item_embedding", (n_items, d["I"]), "tnormal"),
             ("cate_embedding", (n_cates, d["C"]), "tnormal")]
    kind = cfg["model_type"].lower()
    if kind == "clsr":
        specs += [("user_long_embedding", (n_users, U), "tnormal"),
                  ("user_short_embedding", (n_users, U), "tnormal")]
        specs += _attention_specs("long_term_att", U, T, d["att"])
        specs += _gru_specs("fused_encoders.stint_", T, U)
        specs += _time4lstm_specs("fused_encoders.t4l_", T, H)
        specs += _gru_specs("fused_encoders.causal2_", T, H)
        specs += _attention_specs("short_term_att", U + T, H, d["att"])
        specs += _fcn_specs("fcn_alpha", H + T + T + H + 1, d["att"])
        specs += _fcn_specs("logit_fcn", H + T, d["head"])
    elif kind in ("sli_rec", "slirec"):
        specs += [("long_term_asvd.attention_mat", (T, T), "tnormal"),
                  ("long_term_asvd.query", (d["A"],), "tnormal")]
        specs += _time4lstm_specs("time4lstm.", d["I"], H)
        specs += _attention_specs("attention_fcn", T, H, d["att"])
        specs += _fcn_specs("fcn_alpha", T + T + H + 1, d["att"])
        specs += _fcn_specs("logit_fcn", 2 * T, d["head"])
    else:
        raise ValueError(f"no plain reference for model {kind}")
    return specs


def glorot_limit(shape) -> float:
    """TF1's glorot uniform limit; rank-1 shapes take fan_in = fan_out."""
    if len(shape) == 1:
        fan_in = fan_out = shape[0]
    else:
        fan_in, fan_out = shape[-2], shape[-1]
    return math.sqrt(6.0 / (fan_in + fan_out))


def running_update(S: Dict[str, torch.Tensor],
                   batch_stats: Dict[str, torch.Tensor]) -> None:
    """flax's running average, in place: r = 0.95 r + 0.05 batch."""
    for n, x in batch_stats.items():
        S[n] = BN_MOMENTUM * S[n] + (1 - BN_MOMENTUM) * x


def is_buffer(name: str) -> bool:
    return name.endswith(".mean") or name.endswith(".var")


def is_table(name: str) -> bool:
    return name.endswith("_embedding")


# ---------------------------------------------------------------- layers
def batch_norm(x, prefix, P, S, train, new_stats):
    if train:
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(axes)
        var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
        new_stats[f"{prefix}.mean"] = mean.detach()
        new_stats[f"{prefix}.var"] = var.detach()
    else:
        mean, var = S[f"{prefix}.mean"], S[f"{prefix}.var"]
    return ((x - mean) / torch.sqrt(var + BN_EPS) * P[f"{prefix}.scale"]
            + P[f"{prefix}.bias"])


def fcn(x, prefix, P, S, train, new_stats, n_layers, first_kernel=False):
    """Dense -> BN -> relu per hidden layer, then the one-wide output."""
    for i in range(n_layers):
        if i == 0 and first_kernel:
            w = P[f"{prefix}.w_nn_layer0.kernel"]
        else:
            w = P[f"{prefix}.w_nn_layer{i}.weight"].t()
        x = x @ w + P[f"{prefix}.w_nn_layer{i}.bias"]
        x = batch_norm(x, f"{prefix}.bn{i}", P, S, train, new_stats)
        x = torch.relu(x)
    return (x @ P[f"{prefix}.w_nn_output.weight"].t()
            + P[f"{prefix}.w_nn_output.bias"])


def target_attention(prefix, query, keys, mask, P, S, train, new_stats,
                     n_layers):
    """query [B, G, Dq], keys [B, L, Dk], mask [B, L] -> [B, G, Dk]."""
    B, G, Dq = query.shape
    L = keys.shape[1]
    kp = keys @ P[f"{prefix}.attention_mat"]                  # [B, L, Dq]
    k = kp[:, :, None, :].expand(B, L, G, Dq)
    q = query[:, None, :, :].expand(B, L, G, Dq)
    x = torch.cat([k, q, k - q, k * q], dim=-1)               # [B, L, G, 4Dq]
    logits = fcn(x, f"{prefix}.att_fcn", P, S, train, new_stats, n_layers,
                 first_kernel=True)[..., 0]                    # [B, L, G]
    logits = torch.where(mask[:, :, None] > 0, logits,
                         torch.full_like(logits, MASK_PAD))
    w = torch.softmax(logits, dim=1)
    return torch.einsum("blg,bld->bgd", w, keys)


def gru(prefix, x, mask, P, h):
    """TF1 GRUCell over [B, L, D] from state h, masked carry-through:
    (outputs [B, L, H], final state)."""
    Hd = h.shape[-1]
    wg, bg = P[f"{prefix}gate_kernel"], P[f"{prefix}gate_bias"]
    wc, bc = P[f"{prefix}cand_kernel"], P[f"{prefix}cand_bias"]
    outs = []
    for t in range(x.shape[1]):
        m = mask[:, t, None]
        gates = torch.sigmoid(torch.cat([x[:, t], h], -1) @ wg + bg)
        r, u = gates[:, :Hd], gates[:, Hd:]
        c = torch.tanh(torch.cat([x[:, t], r * h], -1) @ wc + bc)
        new = u * h + (1 - u) * c
        h = m * new + (1 - m) * h
        outs.append(m * new)
    return torch.stack(outs, 1), h


def time4lstm(prefix, x, t_last, t_now, mask, P, hidden):
    """The time-aware LSTM of SLI-Rec / CLSR (rnn_cell_implement.py's
    Time4LSTMCell): (outputs [B, L, H], final (c, h))."""
    g = lambda n: P[f"{prefix}{n}"]
    B = x.shape[0]
    c = h = torch.zeros(B, hidden, dtype=x.dtype, device=x.device)
    outs = []
    for t in range(x.shape[1]):
        m = mask[:, t, None]
        xt = x[:, t]
        tn = torch.tanh(t_now[:, t, None] * g("time_input_w1")
                        + g("time_input_bias1"))
        tl = torch.tanh(t_last[:, t, None] * g("time_input_w2")
                        + g("time_input_bias2"))
        tn_gate = torch.sigmoid(xt @ g("time_kernel_w1")
                                + tn @ g("time_kernel_t1") + g("time_bias1"))
        tl_gate = torch.sigmoid(xt @ g("time_kernel_w2")
                                + tl @ g("time_kernel_t2") + g("time_bias2"))
        z = torch.cat([xt, h], -1) @ g("kernel") + g("bias")
        i, j, f, o = z.split(hidden, -1)
        o = o + tn @ g("o_kernel_t1") + tl @ g("o_kernel_t2")
        c_new = (torch.sigmoid(f + 1.0) * tl_gate * c
                 + torch.sigmoid(i) * tn_gate * torch.tanh(j))
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        c = m * c_new + (1 - m) * c
        h = m * h_new + (1 - m) * h
        outs.append(m * h_new)
    return torch.stack(outs, 1), (c, h)


# ---------------------------------------------------------------- models
def _unique_sumsq(table, ids):
    rows = table[torch.unique(ids.reshape(-1))]
    return (rows * rows).sum()


def forward(P: Dict[str, torch.Tensor], S: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor], cfg: dict, train: bool):
    """(logits [B, G], aux, the BN batch statistics in train mode)."""
    kind = cfg["model_type"].lower()
    d = dims(cfg)
    n_att, n_head = len(d["att"]), len(d["head"])
    new_stats: Dict[str, torch.Tensor] = {}
    item_hist = P["item_embedding"][batch["item_hist"]]
    cate_hist = P["cate_embedding"][batch["cate_hist"]]
    hist = torch.cat([item_hist, cate_hist], -1)               # [B, L, T]
    target = torch.cat([P["item_embedding"][batch["items"]],
                        P["cate_embedding"][batch["cates"]]], -1)  # [B,G,T]
    mask = batch["mask"]
    B, G = batch["items"].shape
    last_time = batch["time_to_now"][:, -1][:, None, None].expand(B, G, 1)
    aux = {}
    if kind == "clsr":
        users = batch["users"]
        user_long = P["user_long_embedding"][users]
        user_short = P["user_short_embedding"][users]
        att_long = target_attention(
            "long_term_att", user_long[:, None, :], hist, mask, P, S, train,
            new_stats, n_att)[:, 0]                             # [B, T]
        h1 = gru("fused_encoders.stint_", hist, mask, P, user_short)[1]
        rnn_out, _ = time4lstm("fused_encoders.t4l_", hist,
                               batch["time_from_first"],
                               batch["time_to_now"], mask, P, d["H"])
        zero = torch.zeros(B, d["H"], dtype=hist.dtype, device=hist.device)
        h2 = gru("fused_encoders.causal2_", hist, mask, P, zero)[1]
        query = torch.cat([h1[:, None, :].expand(B, G, -1), target], -1)
        att_short = target_attention("short_term_att", query, rnn_out, mask,
                                     P, S, train, new_stats, n_att)
        long_g = att_long[:, None, :].expand(B, G, -1)
        fusion_in = torch.cat([h2[:, None, :].expand(B, G, -1), target,
                               long_g, att_short, last_time], -1)
        alpha = torch.sigmoid(fcn(fusion_in, "fcn_alpha", P, S, train,
                                  new_stats, n_att))
        user_embed = long_g * alpha + att_short * (1 - alpha)
        if train:
            hist_mean = ((hist * mask[..., None]).sum(1)
                         / mask.sum(1, keepdim=True).clamp_min(1.0))
            position = torch.flip(torch.cumsum(torch.flip(mask, [1]), 1),
                                  [1])
            recent = ((position >= 1)
                      & (position <= cfg["contrastive_recent_k"])).to(
                          hist.dtype)
            hist_recent = ((hist * recent[..., None]).sum(1)
                           / recent.sum(1, keepdim=True).clamp_min(1.0))
            uniq = torch.unique(users)
            ul = P["user_long_embedding"][uniq]
            us = P["user_short_embedding"][uniq]
            aux.update(att_fea_long=att_long, att_fea_short=att_short,
                       hist_mean=hist_mean, hist_recent=hist_recent,
                       seq_len=mask.sum(-1),
                       user_sumsq=(ul * ul).sum() + (us * us).sum(),
                       discrepancy_sumsq=((ul - us) ** 2).sum(),
                       discrepancy_count=float(uniq.numel() * d["U"]))
    elif kind in ("sli_rec", "slirec"):
        w = torch.softmax((hist @ P["long_term_asvd.attention_mat"])
                          @ P["long_term_asvd.query"], dim=-1)   # [B, L]
        fea1 = (hist * w[..., None]).sum(1)                      # [B, T]
        rnn_out, _ = time4lstm("time4lstm.", item_hist,
                               batch["time_from_first"],
                               batch["time_to_now"], mask, P, d["H"])
        att2 = target_attention("attention_fcn", target, rnn_out, mask, P,
                                S, train, new_stats, n_att)
        fea1_g = fea1[:, None, :].expand(B, G, -1)
        alpha = torch.sigmoid(fcn(torch.cat([target, fea1_g, att2,
                                             last_time], -1),
                                  "fcn_alpha", P, S, train, new_stats,
                                  n_att))
        user_embed = fea1_g * alpha + att2 * (1 - alpha)
    else:
        raise ValueError(f"no plain reference for model {kind}")
    logits = fcn(torch.cat([user_embed, target], -1), "logit_fcn", P, S,
                 train, new_stats, n_head)[..., 0]
    if train:
        items = torch.cat([batch["item_hist"].reshape(-1),
                           batch["items"].reshape(-1)])
        cates = torch.cat([batch["cate_hist"].reshape(-1),
                           batch["cates"].reshape(-1)])
        aux["embed_sumsq"] = (_unique_sumsq(P["item_embedding"], items)
                              + _unique_sumsq(P["cate_embedding"], cates)
                              + aux.pop("user_sumsq", 0.0))
    return logits, aux, new_stats
