"""CLSR's model operations from the configuration's shapes, and the
kernel launches of its train step.

`forward_macs(s, G)` lists the multiply-adds of one row's forward with G
candidates over the whole history (L positions), term by term, in the
program's algebra (the scorer's first layer split into key, query and
product terms; elementwise work not counted).  Training counts each
term three times: the forward, the input's gradient and the weight's
(no recompute).  `train_ops(s)` names each hand-written kernel launch
of one train step with its shapes (port_bench/rooflines/<op>.py)."""


def _attention(L, G, Dq, Dk, A0, A1, key_in):
    return [("proj", L * key_in * Dq), ("key", L * Dq * A0),
            ("query", G * Dq * A0), ("product", L * G * Dq * A0),
            ("layer1", L * G * A0 * A1), ("out", L * G * A1),
            ("sum", L * G * Dk)]


def forward_macs(s, G):
    L, T = s["L"], s["I"] + s["C"]
    U, H, A0, A1 = s["U"], s["H"], s["A0"], s["A1"]
    terms = [("long." + n, m) for n, m in
             _attention(L, 1, U, T, A0, A1, T)]
    terms += [("encoder.inputs", L * T * (3 * U + 7 * H)),
              ("encoder.time", L * (2 * T * H + 4 * H * H)),
              ("encoder.recurrence", L * (3 * U * U + 7 * H * H))]
    terms += [("short." + n, m) for n, m in
              _attention(L, G, U + T, H, A0, A1, H)]
    terms += [("fusion", G * ((2 * H + 2 * T + 1) * A0 + A0 * A1 + A1)),
              ("head", G * ((H + T) * s["F0"] + s["F0"] * s["F1"]
                            + s["F1"]))]
    return terms


def train_flops_per_example(s):
    """Forward, input gradient and weight gradient of every term."""
    return 3 * 2.0 * sum(m for _, m in forward_macs(s, s["G"]))


def train_ops(s):
    T = s["I"] + s["C"]
    U, H, B, G = s["U"], s["H"], s["B"], s["G"]
    att = dict(L=s["L"], Lv=s["mean_len"], A0=s["A0"], A1=s["A1"])
    rec = dict(B=B, L=s["L"], Lv=s["mean_len"], U=U, H=H)
    long = dict(att, B=B, G=1, Dq=U, Dk=T)
    short = dict(att, B=B, G=G, Dq=U + T, Dk=H)
    rows = [(s["unique_items"], s["I"]), (s["unique_cates"], s["C"]),
            (s["unique_users"], U), (s["unique_users"], U)]
    return [("bn_stats0", long), ("bn_stats1", long),
            ("target_attention_scorer", long),
            ("bn_stats0", short), ("bn_stats1", short),
            ("target_attention_scorer", short),
            ("recurrence_forward", dict(rec, carries=1)),
            ("recurrence_backward", rec),
            ("row_update", dict(rows=rows))]
