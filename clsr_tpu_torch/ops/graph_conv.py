"""LGN's graph convolution, summed in a fixed order both ways.

Counterpart of the `jax.ops.segment_sum(w * ego[dst], src)` of
clsr_tpu/models/lgn.py:74-80 and of its gradient.  On the card
`index_add_`, `scatter_add_` and the backward of an indexing gather add
with atomics, in an order that changes from call to call, so two train
steps from one state would differ in the last bits; cuSPARSE's transpose
product is not held to one order either.  Here every sum walks its rows
in an order fixed once, when the graph is built (data/graph.py):

  * `propagate(ego, edges)` = A ego with A[s, d] = w over the edges
    (s, d, w), w = 1/deg(s) (the row-normalized D^-1 (A + I) of
    data/graph.py; `GraphEdges.build` checks it): the edges sorted by
    source, `segment_sum` of ego[d] over each source's run, then the
    run's sum times its w (JAX sums w ego[d]: the same up to rounding,
    and no [edges, D] product to write and read).  Its backward is A^T g
    = the sums of (w g)[s] over the same edges sorted by destination
    (the permutation and the runs built once): no tensor of the forward
    is saved, and both directions run in chunks of whole runs of at most
    `CHUNK_EDGES` edges (unless one node has more), so the [edges, D]
    gathers stay a few GB and every index fits in 32 bits at ~10^8
    edges;

Every shape and chunk boundary is a Python int, so the train step stays
capturable in a CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from clsr_tpu_torch.ops.segment_sum import segment_sum

CHUNK_EDGES = 1 << 24


def _chunks(run_lengths: np.ndarray, cap: int) -> List[Tuple[int, int, int,
                                                             int]]:
    """(first node, end node, first edge, end edge) of consecutive node
    ranges whose runs hold at most `cap` edges together (a node with
    more edges than `cap` gets a range of its own)."""
    ends = np.cumsum(run_lengths, dtype=np.int64)
    out, n0, e0 = [], 0, 0
    n = len(run_lengths)
    while n0 < n:
        n1 = int(np.searchsorted(ends, e0 + cap, side="right"))
        n1 = max(n1, n0 + 1)
        e1 = int(ends[n1 - 1])
        out.append((n0, n1, e0, e1))
        n0, e0 = n1, e1
    return out


@dataclasses.dataclass(eq=False)
class GraphEdges:
    """The edges of a row-normalized adjacency on one device, both ways.

    `scale` [n] each source's weight 1/deg; by source (the forward):
    `src_dst` the destinations, `src_runs` [n] each source's edge count;
    by destination (the backward): `dst_src`, `dst_runs`; `chunks_*` the
    chunked node ranges of each order."""

    n_nodes: int
    scale: torch.Tensor
    src_dst: torch.Tensor
    src_runs: torch.Tensor
    dst_src: torch.Tensor
    dst_runs: torch.Tensor
    chunks_src: List[Tuple[int, int, int, int]]
    chunks_dst: List[Tuple[int, int, int, int]]

    @classmethod
    def build(cls, n_nodes: int, src: np.ndarray, dst: np.ndarray,
              weight: np.ndarray, device,
              cap: int = CHUNK_EDGES) -> "GraphEdges":
        """From edges sorted by source (src ascending) whose weights are
        one value a source; the order by destination is a stable sort
        on the device."""
        src_runs = np.bincount(src, minlength=n_nodes)
        dst_runs = np.bincount(dst, minlength=n_nodes)
        scale = np.zeros(n_nodes, np.float32)
        scale[src] = weight
        if not np.array_equal(scale[src], weight):
            raise ValueError("the graph is not row-normalized: an edge's "
                             "weight differs from its source's other edges'")
        i32 = lambda a: torch.from_numpy(
            np.ascontiguousarray(a, np.int32)).to(device)
        src_t, dst_t = i32(src), i32(dst)
        perm = torch.sort(dst_t, stable=True).indices
        return cls(n_nodes=n_nodes, scale=torch.from_numpy(scale).to(device),
                   src_dst=dst_t, src_runs=i32(src_runs),
                   dst_src=src_t.index_select(0, perm),
                   dst_runs=i32(dst_runs),
                   chunks_src=_chunks(src_runs, cap),
                   chunks_dst=_chunks(dst_runs, cap))


def _gather_sums(x: torch.Tensor, cols: torch.Tensor, runs: torch.Tensor,
                 chunks) -> torch.Tensor:
    """out[r] = sum over run r's edges e, in order, of x[cols[e]]."""
    parts = [segment_sum(x.index_select(0, cols[e0:e1]), runs[n0:n1])
             for n0, n1, e0, e1 in chunks]
    return torch.cat(parts) if len(parts) > 1 else parts[0]


class _Propagate(torch.autograd.Function):

    @staticmethod
    def forward(ctx, ego, edges: GraphEdges):
        ctx.edges = edges
        return _gather_sums(ego, edges.src_dst, edges.src_runs,
                            edges.chunks_src).mul_(edges.scale[:, None])

    @staticmethod
    def backward(ctx, g):
        e = ctx.edges
        return (_gather_sums(g * e.scale[:, None], e.dst_src, e.dst_runs,
                             e.chunks_dst), None)


def propagate(ego: torch.Tensor, edges: GraphEdges) -> torch.Tensor:
    """A ego [n_nodes, D] -> [n_nodes, D], with a fixed-order backward."""
    return _Propagate.apply(ego, edges)
