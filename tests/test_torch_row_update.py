"""The row-update wrappers (K5 `scatter_rows`, K4 `sweep_rows`) against JAX.

On CPU tensors each wrapper computes its plain version; both must equal
the JAX scatter-set of the LazyAdam update,
`jnp.asarray(table).at[ids].set(rows, mode="drop",
indices_are_sorted=True, unique_indices=True)`, exactly (they only copy):
unique ids, an out-of-range tail (the compact update's dropped targets
N + i), duplicate ids with equal rows (the legacy path; JAX is then told
only that the ids are sorted), an empty id vector, and ids in the last,
partial slab of the sweep.  The K5 group (`scatter_rows_group`) equals
the JAX scatter-set entry by entry over groups that mix widths 6, 8 and
24, hold an empty entry, a dropped tail and duplicates, and outnumber
one launch's MAX_GROUP entries; it refuses two entries on one table and
int64 ids.  A group of bf16 tables beside f32 optimizer rows equals
JAX's bf16 and f32 scatter-sets bit for bit; a table and rows of two
types, or of another type, are refused (K4 takes f32 only).  No launch
is counted on the CPU.
"""

import os
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsr_tpu_torch.ops import row_update as ru

# Six xdist workers, each with torch's default intra-op pool (a thread a
# core), oversubscribe the cores several times over; under xdist a
# worker keeps one thread.  Run alone (or on the card) torch keeps its
# default.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


N, W = 37, 6


def _case(name, rng):
    table = rng.randn(N, W).astype(np.float32)
    if name == "unique":
        ids = np.sort(rng.choice(N, 12, replace=False))
    elif name == "dropped_tail":
        valid = np.sort(rng.choice(N, 9, replace=False))
        ids = np.concatenate([valid, N + np.arange(4)])
    elif name == "duplicates":
        ids = np.sort(rng.randint(0, N, 15))
    elif name == "empty":
        ids = np.zeros(0, np.int64)
    elif name == "last_slab":
        ids = np.array([0, 5, N - 3, N - 1, N, N + 2])
    else:
        raise ValueError(name)
    ids = ids.astype(np.int32)
    rows = rng.randn(len(ids), W).astype(np.float32)
    if name == "duplicates":
        rows = table[ids] * 0.5 + 1.0      # equal rows for equal ids
    return table, ids, rows


CASES = ("unique", "dropped_tail", "duplicates", "empty", "last_slab")


def _jax_set(table, ids, rows, unique):
    out = jnp.asarray(table).at[jnp.asarray(ids)].set(
        jnp.asarray(rows), mode="drop", indices_are_sorted=True,
        unique_indices=unique)
    return np.asarray(out)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kernel", ["scatter", "sweep"])
def test_row_update_matches_jax_scatter_set(case, kernel):
    table, ids, rows = _case(case, np.random.RandomState(CASES.index(case)))
    want = _jax_set(table, ids, rows, unique=case != "duplicates")
    got = torch.from_numpy(table.copy())
    counter = ru.scatter_rows if kernel == "scatter" else ru.sweep_rows
    before = counter.launches
    if kernel == "scatter":
        out = ru.scatter_rows(got, torch.from_numpy(ids),
                              torch.from_numpy(rows))
    else:      # 8-row slabs: the last one (rows 32..36) is partial
        out = ru.sweep_rows(got, torch.from_numpy(ids),
                            torch.from_numpy(rows), block=8)
    assert out is got                        # in place
    assert counter.launches == before        # the plain version, no kernel
    np.testing.assert_array_equal(got.numpy(), want)


def _group_entry(case, width, rng):
    """(table, ids, rows, unique) of one group entry: `_case` at `width`
    (its table of N rows, ids and rows drawn anew)."""
    table, ids, rows = _case(case, rng)
    table = rng.randn(N, width).astype(np.float32)
    rows = rng.randn(len(ids), width).astype(np.float32)
    if case == "duplicates":
        rows = table[ids] * 0.5 + 1.0
    return table, ids, rows, case != "duplicates"


# each group mixes widths 6, 8 and 24; "many" has more entries than one
# launch takes (MAX_GROUP), so the wrapper splits it
GROUPS = {
    "mixed": [("unique", 6), ("dropped_tail", 8), ("empty", 24),
              ("duplicates", 24), ("last_slab", 6)],
    "many": [(CASES[i % len(CASES)], (6, 8, 24)[i % 3])
             for i in range(ru.MAX_GROUP + 4)],
}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_row_update_group_matches_jax_scatter_set(group):
    rng = np.random.RandomState(len(group))
    entries = [_group_entry(case, width, rng)
               for case, width in GROUPS[group]]
    got = [torch.from_numpy(t.copy()) for t, _, _, _ in entries]
    before = ru.scatter_rows.launches
    ru.scatter_rows_group([(g, torch.from_numpy(ids), torch.from_numpy(rows))
                           for g, (_, ids, rows, _) in zip(got, entries)])
    assert ru.scatter_rows.launches == before   # the plain version
    for g, (table, ids, rows, unique) in zip(got, entries):
        np.testing.assert_array_equal(g.numpy(),
                                      _jax_set(table, ids, rows, unique))


def test_row_update_group_checks_its_entries():
    table, other = torch.zeros(5, 4), torch.zeros(5, 4)
    ids, rows = torch.tensor([0, 1], dtype=torch.int32), torch.ones(2, 4)
    ru.scatter_rows_group([(table, ids, rows), (other, ids, rows)])
    with pytest.raises(ValueError, match="share one table"):
        ru.scatter_rows_group([(table, ids, rows), (other, ids, rows),
                               (table, ids, rows)])
    with pytest.raises(ValueError, match="share one table"):  # a row view
        ru.scatter_rows_group([(table, ids, rows),
                               (table[3:], ids, rows)])
    with pytest.raises(TypeError):
        ru.scatter_rows_group([(table, ids, rows),
                               (other, ids.long(), rows)])
    assert torch.equal(other, torch.zeros(5, 4).index_fill_(0, ids.long(),
                                                            1.0))


def test_slab_starts_segments_the_sorted_ids():
    ids = torch.tensor([-1, 0, 3, 8, 8, 15, 16, 40, 41], dtype=torch.int32)
    starts = ru.slab_starts(ids, 41, 8)     # 6 slabs, the last of one row
    assert starts.dtype == torch.int32
    # slab b holds ids[starts[b]:starts[b + 1]]; -1 precedes slab 0 and
    # 41 (>= N) falls in slab 5's segment, where the id check drops it
    assert starts.tolist() == [1, 3, 6, 7, 7, 7, 9]


def test_row_update_checks_its_arguments():
    table = torch.zeros(5, 4)
    rows = torch.ones(2, 4)
    with pytest.raises(TypeError):
        ru.scatter_rows(table, torch.tensor([0, 1]), rows)      # int64 ids
    with pytest.raises(ValueError):
        ru.scatter_rows(table, torch.tensor([0, 1], dtype=torch.int32),
                        torch.ones(2, 3))
    with pytest.raises(ValueError):
        ru.sweep_rows(table, torch.tensor([0, 1], dtype=torch.int32), rows,
                      block=0)


def test_row_update_group_bf16_and_mixed_match_jax_scatter_set():
    """A lazy step's group on bf16 tables beside f32 optimizer rows: the
    plain version equals JAX's bf16 and f32 scatter-sets bit for bit,
    and the tables keep their types."""
    rng = np.random.RandomState(3)
    entries, want = [], []
    for case, width in (("unique", 8), ("dropped_tail", 5),
                        ("duplicates", 4)):
        table, ids, rows = _case(case, rng)
        table, rows = table[:, :width], rows[:, :width]
        bf_table = jnp.asarray(table, jnp.bfloat16)
        bf_rows = jnp.asarray(rows, jnp.bfloat16)
        want.append(np.asarray(bf_table.at[jnp.asarray(ids)].set(
            bf_rows, mode="drop"), np.float32))
        entries.append((torch.from_numpy(table.copy()).bfloat16(),
                        torch.from_numpy(ids),
                        torch.from_numpy(rows.copy()).bfloat16()))
        pmn = rng.randn(N, 3 * width).astype(np.float32)
        pmn_rows = rng.randn(len(ids), 3 * width).astype(np.float32)
        want.append(_jax_set(pmn, ids, pmn_rows, case != "duplicates"))
        entries.append((torch.from_numpy(pmn), torch.from_numpy(ids),
                        torch.from_numpy(pmn_rows)))
    before = ru.scatter_rows.launches
    ru.scatter_rows_group(entries)
    assert ru.scatter_rows.launches == before
    for (table, _, _), w in zip(entries, want):
        assert table.dtype in ru.K5_DTYPES
        np.testing.assert_array_equal(table.float().numpy(), w)


def test_row_update_refuses_mixed_or_other_types():
    ids = torch.tensor([0, 1], dtype=torch.int32)
    bf = torch.zeros(5, 4, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="one type"):
        ru.scatter_rows(bf, ids, torch.ones(2, 4))
    with pytest.raises(TypeError, match="one type"):
        ru.scatter_rows(bf.half(), ids, torch.ones(2, 4).half())
    with pytest.raises(TypeError, match="one type"):      # K4: f32 only
        ru.sweep_rows(bf, ids, torch.ones(2, 4, dtype=torch.bfloat16))
