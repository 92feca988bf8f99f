"""CLSR's three recurrences forward (K2): each real step of a row
multiplies the interest GRU's state (U wide), the Time4LSTM's (H) and
the causal GRU's (H) by their recurrent matrices, 3 U^2 + 7 H^2
multiply-adds; the input projections come in precomputed.  Reads each
real step's inputs once, writes each real step's output (and, in
training, its carry for the backward) once.

Shapes: B, Lv (real steps a row, mean), L, U, H, `carries` 1 in training.
Returns (operations, bytes)."""


def cost(s):
    B, Lv, L, U, H = s["B"], s["Lv"], s["L"], s["U"], s["H"]
    macs = B * Lv * (3 * U * U + 7 * H * H)
    inputs = B * Lv * (3 * U + 10 * H) + B * L + B * U
    weights = 3 * U * U + 7 * H * H
    outputs = B * Lv * H + B * (U + H)
    if s.get("carries"):
        outputs += B * Lv * (U + 3 * H)
    return 2.0 * macs, 4.0 * (inputs + weights + outputs)
