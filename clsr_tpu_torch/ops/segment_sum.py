"""Sums over the runs of sorted ids, in one fixed order, and a table
lookup whose gradient is taken with them.

Counterpart of `jax.ops.segment_sum(..., indices_are_sorted=True)`
(clsr_tpu/training/lazy_adam.py:286-287, :355) and of the gradient of
`jnp.take` on a table.  On the card PyTorch's dense embedding backward
and `index_add_` sum the rows of a repeated id with atomics, in an order
that changes from call to call, so two train steps from one state differ
in the last bits and a CUDA graph replay cannot be held to its eager
step.  Here every sum is taken in sorted order:

  * `segment_sum(values, lengths)` sums consecutive runs of rows, run i
    of `lengths[i]` rows, each (run, column) in row order
    (`torch.segment_reduce(..., unsafe=True)`, which on the card gives
    each (run, column) to one thread that walks the run in order; an
    empty run sums to 0).  Static shapes, no host sync, so it can be
    captured in a CUDA graph.  `segment_sum_reference` is its plain
    version (`index_add_` on the CPU, which also adds in row order);
  * `sorted_runs` and `run_lengths` give the runs of sorted ids without a
    sync: the first-occurrence mask, each row's run index and each run's
    first row (`INT32_MAX` past the last run), and the first `cap` run
    lengths (0 past the last run);
  * `lookup(table, ids)` is `F.embedding` with this gradient
    (`table_grad`): stable-argsort the flat ids, sum the cotangent rows
    of each run with `segment_sum`, write each run's sum once at its id
    into the dense [N, D] gradient.  At most min(M, N) runs exist; the
    slots past the last run go to a sink row N that is cut off.

The train-mode forward looks every table up through `lookup`; eval and
serving keep `F.embedding`, which they never differentiate.

On a bf16 table the cotangent rows arrive in bf16 (the model upcasts
right after the gather, so each row is rounded once) and `segment_sum`
adds a run's rows one after another in bf16, in their order: the
gradient of a bf16 `jnp.take` on the CPU, where XLA scatter-adds the
rounded rows in bf16 in order, bit for bit for one lookup.  A table
read at several sites gets each site's gradient summed first, and the
sites' sums then added in bf16; XLA may add them in another order, and
inside a jitted step it may keep f32 bits it would round op by op
(excess precision).
"""

from __future__ import annotations

from typing import Tuple

import torch

INT32_MAX = 2 ** 31 - 1


def segment_sum(values: torch.Tensor, lengths: torch.Tensor
                ) -> torch.Tensor:
    """[S, D] sums of the consecutive runs of `values` [M, D]; run i has
    `lengths[i]` rows (int32 or int64, sum(lengths) <= M, unchecked)."""
    return torch.segment_reduce(values, "sum", lengths=lengths, unsafe=True,
                                initial=0.0)


def segment_sum_reference(values: torch.Tensor, lengths: torch.Tensor
                          ) -> torch.Tensor:
    """Plain version of `segment_sum`: each row added into its run."""
    seg = torch.repeat_interleave(
        torch.arange(lengths.shape[0], device=values.device),
        lengths.long())
    out = torch.zeros((lengths.shape[0],) + values.shape[1:],
                      dtype=values.dtype, device=values.device)
    return out.index_add_(0, seg, values[:seg.shape[0]])


def sorted_runs(sorted_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(first [M] bool, seg [M] int32 run index of each row, idx_first
    [M] int32 first row of each run, INT32_MAX past the last run) of
    ascending ids, on their device without a sync."""
    M = sorted_ids.shape[0]
    dev = sorted_ids.device
    first = torch.ones(M, dtype=torch.bool, device=dev)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg = torch.cumsum(first, 0, dtype=torch.int32) - 1
    idx_first = torch.full((M,), INT32_MAX, dtype=torch.int32,
                           device=dev).scatter_reduce_(
        0, seg.long(), torch.arange(M, dtype=torch.int32, device=dev),
        "amin")
    return first, seg, idx_first


def run_lengths(idx_first: torch.Tensor, cap: int) -> torch.Tensor:
    """The lengths [cap] of the first `cap` runs (cap <= M) from
    `sorted_runs`' idx_first; 0 past the last run.  They sum to M."""
    M = idx_first.shape[0]
    bounds = torch.cat([idx_first, idx_first.new_full((1,), M)]).clamp(
        max=M)
    return bounds[1:cap + 1] - bounds[:cap]


@torch.no_grad()
def table_grad(flat_ids: torch.Tensor, g: torch.Tensor,
               n_rows: int) -> torch.Tensor:
    """The dense gradient [N, D] of table[flat_ids] with cotangent g
    [M, D]: each id's rows summed in their order in `flat_ids`."""
    M, D = g.shape
    out = torch.zeros(n_rows + 1, D, dtype=g.dtype, device=g.device)
    if M == 0:
        return out[:n_rows]
    perm = torch.argsort(flat_ids, stable=True)
    ids = flat_ids.index_select(0, perm)
    _, seg, idx_first = sorted_runs(ids)
    cap = min(M, n_rows)
    sums = segment_sum(g.index_select(0, perm), run_lengths(idx_first, cap))
    runs = torch.arange(cap, device=g.device)
    uid = ids.index_select(0, idx_first[:cap].clamp(max=M - 1))
    tgt = torch.where(runs <= seg[-1], uid.long(),
                      torch.full_like(runs, n_rows))
    return out.index_copy_(0, tgt, sums)[:n_rows]


class _Lookup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        return table.index_select(0, ids.reshape(-1)).reshape(
            ids.shape + table.shape[1:])

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        D = g.shape[-1]
        return (table_grad(ids.reshape(-1), g.reshape(-1, D), ctx.n_rows),
                None)


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] ([..., D]) whose gradient is `table_grad`: the same
    bits on every call."""
    return _Lookup.apply(table, ids)
