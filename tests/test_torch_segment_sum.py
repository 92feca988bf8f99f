"""The port's sorted-run sums and its table lookup against JAX's.

  * `segment_sum` (over run lengths) against `jax.ops.segment_sum(...,
    indices_are_sorted=True)` over the same sorted run ids, 1e-6 abs: with
    empty runs among and after the others, one long run, runs of one
    row, and no row at all; `segment_sum_reference` gives the same bits;
  * `sorted_runs` and `run_lengths` give JAX's run bookkeeping: each
    row's run and each run's first row (INT32_MAX past the last run),
    and lengths that sum to M;
  * `lookup`'s gradient against `F.embedding`'s (1e-6 abs) and against
    the gradient of `jnp.take` on the table (1e-5 abs), with ids
    repeated many times (41 rows, 2,500 ids), ids that hit every row,
    a [B, L] id block, a table with more rows than ids, and no id;
  * a second backward gives the same bits.
"""

import os
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from clsr_tpu_torch.ops.segment_sum import (INT32_MAX, lookup, run_lengths,
                                            segment_sum,
                                            segment_sum_reference,
                                            sorted_runs)

# Six xdist workers, each with torch's default intra-op pool (a thread a
# core), oversubscribe the cores several times over; under xdist a
# worker keeps one thread.  Run alone (or on the card) torch keeps its
# default.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


# (name, run lengths, D)
SUM_CASES = [
    ("empty_runs", [3, 0, 2, 0, 0, 4, 1, 0], 5),
    ("one_long_run", [2000], 8),
    ("long_and_short", [1, 1500, 0, 1, 7, 0], 3),
    ("single_rows", [1] * 30, 4),
    ("no_rows", [0, 0, 0], 2),
]


@pytest.mark.parametrize("name,lengths,D", SUM_CASES,
                         ids=[c[0] for c in SUM_CASES])
def test_segment_sum_matches_jax(name, lengths, D):
    rng = np.random.RandomState(len(lengths) + D)
    lengths = np.asarray(lengths, np.int32)
    M = int(lengths.sum())
    values = rng.randn(M, D).astype(np.float32)
    seg = np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)
    want = np.asarray(jax.ops.segment_sum(
        jnp.asarray(values), jnp.asarray(seg), num_segments=len(lengths),
        indices_are_sorted=True))
    got = segment_sum(torch.from_numpy(values), torch.from_numpy(lengths))
    assert got.shape == (len(lengths), D)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (got.numpy()[lengths == 0] == 0).all()
    ref = segment_sum_reference(torch.from_numpy(values),
                                torch.from_numpy(lengths))
    assert torch.equal(got, ref)


@pytest.mark.parametrize("M,N", [(1, 1), (50, 7), (200, 1000), (64, 64)])
def test_sorted_runs_and_lengths(M, N):
    rng = np.random.RandomState(M + N)
    ids = np.sort(rng.randint(0, N, M)).astype(np.int32)
    first, seg, idx_first = sorted_runs(torch.from_numpy(ids))
    uniq, starts, counts = np.unique(ids, return_index=True,
                                     return_counts=True)
    want_first = np.zeros(M, bool)
    want_first[starts] = True
    assert np.array_equal(first.numpy(), want_first)
    assert np.array_equal(seg.numpy(), np.cumsum(want_first) - 1)
    want_idx = np.full(M, INT32_MAX, np.int64)
    want_idx[:len(starts)] = starts
    assert np.array_equal(idx_first.numpy(), want_idx)
    cap = min(M, N)
    lengths = run_lengths(idx_first, cap).numpy()
    want_len = np.zeros(cap, np.int64)
    want_len[:len(counts)] = counts
    assert np.array_equal(lengths, want_len) and lengths.sum() == M


# (name, N, D, id shape, id range)
LOOKUP_CASES = [
    ("41_rows_2500_ids", 41, 8, (2500,), 41),
    ("every_row", 6, 3, (4, 9), 6),
    ("more_rows_than_ids", 1000, 5, (3, 7), 1000),
    ("skewed", 30, 4, (16, 17), 3),
    ("no_id", 9, 4, (0,), 9),
]


@pytest.mark.parametrize("name,N,D,shape,hi", LOOKUP_CASES,
                         ids=[c[0] for c in LOOKUP_CASES])
def test_lookup_gradient_matches_embedding_and_jax(name, N, D, shape, hi):
    rng = np.random.RandomState(N + D)
    table = rng.randn(N, D).astype(np.float32)
    ids = rng.randint(0, hi, shape).astype(np.int64)
    cot = rng.randn(*shape, D).astype(np.float32)

    t = torch.from_numpy(table).requires_grad_()
    rows = lookup(t, torch.from_numpy(ids))
    assert torch.equal(rows.detach(),
                       F.embedding(torch.from_numpy(ids), t).detach())
    rows.backward(torch.from_numpy(cot))
    got = t.grad.clone()
    assert got.shape == (N, D)

    t.grad = None
    F.embedding(torch.from_numpy(ids), t).backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.numpy(), t.grad.numpy(), rtol=0,
                               atol=1e-6)

    want = jax.grad(lambda w: jnp.sum(jnp.take(w, jnp.asarray(ids), axis=0)
                                      * jnp.asarray(cot)))(
        jnp.asarray(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)

    t.grad = None
    lookup(t, torch.from_numpy(ids)).backward(torch.from_numpy(cot))
    assert torch.equal(t.grad, got)
