"""The port's FFM text reader (clsr_tpu_torch/data/ffm.py) against the
JAX package's (clsr_tpu/data/ffm.py), exact: `parse_ffm_line` on every
line, every batch of `FFMTextReader` (ids, weights, mask, labels,
impression ids; batch sizes 1, 2, 3 and the whole file, with the last
batch partial), and `fm_sparse_triple`, on the lines of JAX's
tests/test_ffm.py and on seeded random lines with blank lines, a tab
separator and impression ids."""

import os

import numpy as np
import pytest
import torch

from clsr_tpu.data import ffm as jax_ffm
from clsr_tpu_torch.data import ffm

# Six xdist workers, each with torch's default intra-op pool (a thread a
# core), oversubscribe the cores several times over; under xdist a
# worker keeps one thread.  Run alone (or on the card) torch keeps its
# default.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

LINES = [
    "1 1:3:1.0 1:7:0.5 2:2:2.0",
    "0 2:5:1.5 3:9:1.0 % imp42",
    "1 1:1:1.0",
    "0 3:4:0.25 3:6:0.75 3:8:1.0",
    "1 2:2:1.0 1:3:0.5",
]
FIELDS, FEATURES = 4, 40


def random_lines(seed, n=23, sep=" "):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        feats = [f"{rng.randint(1, FIELDS + 1)}:{rng.randint(1, FEATURES + 1)}"
                 f":{rng.uniform(-2, 2):.4f}"
                 for _ in range(rng.randint(0, 7))]
        line = sep.join([str(rng.randint(0, 2))] + feats)
        if rng.uniform() < 0.3:
            line += f" % imp{i}"
        out.append(line)
        if rng.uniform() < 0.1:
            out.append("")
    return out


@pytest.mark.parametrize("line", [x for x in LINES + random_lines(0)
                                  if x.strip()])
def test_parse_ffm_line_matches_jax(line):
    assert ffm.parse_ffm_line(line) == jax_ffm.parse_ffm_line(line)


@pytest.mark.parametrize("lines, batch_size, sep", [
    (LINES, 2, " "), (LINES, 5, " "), (random_lines(1), 1, " "),
    (random_lines(2), 3, " "), (random_lines(3, sep="\t"), 4, "\t"),
    (random_lines(4, n=40), 64, " ")])
def test_reader_batches_and_fm_triple_match_jax(tmp_path, lines,
                                                batch_size, sep):
    p = tmp_path / "ffm.txt"
    p.write_text("\n".join(lines) + "\n")
    got = list(ffm.FFMTextReader(FEATURES, FIELDS, batch_size, sep)
               .load_data_from_file(str(p)))
    want = list(jax_ffm.FFMTextReader(FEATURES, FIELDS, batch_size, sep)
                .load_data_from_file(str(p)))
    assert [b.batch_size for b in got] == [b.batch_size for b in want]
    assert sum(b.batch_size for b in got) == sum(1 for x in lines
                                                 if x.strip())
    for g, w in zip(got, want):
        for f in ("labels", "feat_ids", "feat_weights", "feat_mask"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert g.impression_ids == w.impression_ids
        for a, b in zip(ffm.fm_sparse_triple(g, FEATURES),
                        jax_ffm.fm_sparse_triple(w, FEATURES)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
