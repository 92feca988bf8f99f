"""The first BN statistics of the attention scorer in training (K3a): the
first layer's pre-activations over every (row, position, candidate),
padding included (the BN batch statistics count it), reduced to a mean
and a variance per channel.  Elementwise work is not counted.

Shapes as target_attention_scorer.  Returns (operations, bytes)."""


def cost(s):
    B, G, L = s["B"], s["G"], s["L"]
    Dq, A0 = s["Dq"], s["A0"]
    macs = B * L * Dq * A0 + B * G * Dq * A0 + B * L * G * Dq * A0
    words = B * L * Dq + B * G * Dq + 4 * Dq * A0 + A0 + 2 * A0
    return 2.0 * macs, 4.0 * words
