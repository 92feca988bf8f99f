"""The second BN statistics of the attention scorer in training (K3b):
the first layer again, normalised with the first statistics, and the
second layer's pre-activations over every (row, position, candidate),
reduced to a mean and a variance per channel.

Shapes as target_attention_scorer.  Returns (operations, bytes)."""


def cost(s):
    B, G, L = s["B"], s["G"], s["L"]
    Dq, A0, A1 = s["Dq"], s["A0"], s["A1"]
    macs = (B * L * Dq * A0 + B * G * Dq * A0
            + B * L * G * (Dq * A0 + A0 * A1))
    words = (B * L * Dq + B * G * Dq + 4 * Dq * A0 + 3 * A0 + A0 * A1
             + A1 + 2 * A1)
    return 2.0 * macs, 4.0 * words
