"""SLI-Rec's model operations from the configuration's shapes, and the
kernel launches of its train step; as model_clsr.  Its Time4LSTM runs as
plain PyTorch, so a step's hand-written kernels are the attention's and
the row writes."""


def forward_macs(s, G):
    L, I, T = s["L"], s["I"], s["I"] + s["C"]
    H, A0, A1 = s["H"], s["A0"], s["A1"]
    return [("long.proj", L * T * T), ("long.query", L * T),
            ("long.sum", L * T),
            ("encoder.inputs", L * I * 4 * H),
            ("encoder.time", L * (2 * I * H + 4 * H * H)),
            ("encoder.recurrence", L * 4 * H * H),
            ("short.proj", L * H * T), ("short.key", L * T * A0),
            ("short.query", G * T * A0), ("short.product", L * G * T * A0),
            ("short.layer1", L * G * A0 * A1), ("short.out", L * G * A1),
            ("short.sum", L * G * H),
            ("fusion", G * ((2 * T + H + 1) * A0 + A0 * A1 + A1)),
            ("head", G * (2 * T * s["F0"] + s["F0"] * s["F1"] + s["F1"]))]


def train_flops_per_example(s):
    return 3 * 2.0 * sum(m for _, m in forward_macs(s, s["G"]))


def train_ops(s):
    T = s["I"] + s["C"]
    a = dict(L=s["L"], Lv=s["mean_len"], A0=s["A0"], A1=s["A1"],
             Dq=T, Dk=s["H"], B=s["B"], G=s["G"])
    rows = [(s["unique_items"], s["I"]), (s["unique_cates"], s["C"])]
    return [("bn_stats0", a), ("bn_stats1", a),
            ("target_attention_scorer", a),
            ("row_update", dict(rows=rows))]
