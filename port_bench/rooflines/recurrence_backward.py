"""CLSR's three recurrences backward (K2 backward): each real step's
adjoint through the recurrent matrices, 3 U^2 + 7 H^2 multiply-adds (the
forward's recompute and the five weight products, which run in cuBLAS,
are not counted).  Reads each real step's carry, inputs and output
cotangent once; writes each real step's input cotangents once.

Shapes as recurrence_forward.  Returns (operations, bytes)."""


def cost(s):
    B, Lv, L, U, H = s["B"], s["Lv"], s["L"], s["U"], s["H"]
    macs = B * Lv * (3 * U * U + 7 * H * H)
    reads = B * Lv * ((U + 3 * H) + (3 * U + 10 * H) + H) + B * L
    writes = B * Lv * (3 * U + 10 * H + U + H) + B * (U + H)
    weights = 3 * U * U + 7 * H * H
    return 2.0 * macs, 4.0 * (reads + writes + weights)
