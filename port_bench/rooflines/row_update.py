"""Lazy Adam's row writes (K5): every touched row of every table written
twice, its new parameter row (D wide) into the table and its
parameter | first | second moment row (3 D) into the optimizer's rows;
each written row is read once from the update's output, with its id.

Shapes: `rows`, a list of (unique rows a step, D) a table.  Returns
(operations, bytes)."""


def cost(s):
    words = sum(u * (2 * 4 * D + 2) for u, D in s["rows"])
    return 0.0, 4.0 * words
