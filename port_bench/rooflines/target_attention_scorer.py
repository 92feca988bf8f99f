"""The target-attention scorer's forward (K1): the split first layer, the
second layer, the one-wide output, the masked softmax over the history
and the weighted sum of the keys, over each row's real positions and
candidates.  Elementwise work is not counted.

Shapes: B rows, G candidates a row, Lv real positions a row (mean), L
padded positions, Dq query width, Dk key width, A0 and A1 the scorer's
layers.  Returns (operations, bytes)."""


def cost(s):
    B, G, Lv, L = s["B"], s["G"], s["Lv"], s["L"]
    Dq, Dk, A0, A1 = s["Dq"], s["Dk"], s["A0"], s["A1"]
    macs = (B * Lv * Dq * A0 + B * G * Dq * A0
            + B * Lv * G * (Dq * A0 + A0 * A1 + A1 + Dk))
    weights = 4 * Dq * A0 + A0 + A0 * A1 + 2 * A1 + 1
    words = (B * Lv * (Dk + Dq) + B * G * Dq + B * L + B * G * Dk
             + weights)
    return 2.0 * macs, 4.0 * words
