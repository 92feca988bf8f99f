"""The port's host data path against the JAX package's.

On the 50-user synthetic set of clsr_tpu/data/synthetic.py (valid 1 + 4,
test 1 + 9 groups):

  * `parse_file`, the C++ route and the Python route, plain and with the
    `recent_k` and `shuffle_seed` ablations, against JAX's `parse_file`:
    labels, ids and offsets exact, times exact, the time features to
    1e-6 abs (C++ `log` against numpy's, as tests/test_native_parser.py
    holds JAX's pair); a failed build of the C++ parser raises with the
    compiler's output;
  * `PaddedView`, every `train_batches` batch over two epochs from the
    same RandomState, and every `eval_batches` batch against JAX's:
    exact;
  * the synthetic files (`write_synthetic_dataset`,
    `write_synthetic_dataset_fast`): byte-identical to JAX's;
  * `prefetch_to_device` on the CPU: the batches in order as tensors, an
    error raised in the producer reaches the consumer, and an abandoned
    consumer releases its producer (the counterpart of
    tests/test_cli_and_io.py:100);
  * the JSONL summary writer, and the event-file and histogram writers.

The ETL from raw logs and the packed format are held against JAX's in
tests/test_torch_etl.py and tests/test_torch_packed.py.
"""

import os
import dataclasses
import filecmp
import gc
import json
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from clsr_tpu.data.loader import PaddedView as JaxPaddedView
from clsr_tpu.data.loader import SequenceLoader as JaxLoader
from clsr_tpu.data.parser import parse_file as jax_parse_file
from clsr_tpu.data.synthetic import \
    write_synthetic_dataset as jax_write_dataset
from clsr_tpu.data.synthetic import \
    write_synthetic_dataset_fast as jax_write_fast
from clsr_tpu.data.vocab import load_vocab as jax_load_vocab
from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.data.loader import PaddedView, SequenceLoader
from clsr_tpu_torch.data.parser import ParsedDataset, parse_file
from clsr_tpu_torch.data.prefetch import prefetch_to_device
from clsr_tpu_torch.utils import summaries
from clsr_tpu_torch.data.synthetic import (write_synthetic_dataset,
                                           write_synthetic_dataset_fast)
from clsr_tpu_torch.data.vocab import load_vocab
from clsr_tpu_torch.ops import _build
from clsr_tpu_torch.utils.summaries import SummaryWriter

# Six xdist workers, each with torch's default intra-op pool (a thread a
# core), oversubscribe the cores several times over; under xdist a
# worker keeps one thread.  Run alone (or on the card) torch keeps its
# default.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


SPLITS = ("train", "valid", "test")
INT_FIELDS = ("labels", "users", "items", "cates", "times", "offsets",
              "hist_items", "hist_cates")
TIME_FIELDS = ("time_diff", "time_from_first", "time_to_now")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = tmp_path_factory.mktemp("host_data")
    paths = write_synthetic_dataset(str(out), valid_num_ngs=4,
                                    test_num_ngs=9)
    vocabs = {name: (load_vocab(paths[f"{name}_vocab"]),
                     jax_load_vocab(paths[f"{name}_vocab"]))
              for name in ("user", "item", "cate")}
    port = tuple(v[0] for v in vocabs.values())
    jax = tuple(v[1] for v in vocabs.values())
    return paths, port, jax


def _assert_parsed_equal(got, want):
    assert len(got) == len(want) > 0
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    for f in TIME_FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=1e-6, err_msg=f)
        assert getattr(got, f).dtype == np.float32, f


ROUTES = {
    "native": dict(use_native=True),
    "python": dict(use_native=False),
    "recent_k": dict(recent_k=3),
    "shuffle": dict(shuffle_seed=5),
}


@pytest.mark.parametrize("unit", ["s", "ms"])
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_parse_file_matches_jax(dataset, route, split, unit):
    paths, port, jax = dataset
    got = parse_file(paths[split], *port, time_unit=unit, **ROUTES[route])
    want = jax_parse_file(paths[split], *jax, time_unit=unit,
                          **ROUTES[route])
    assert isinstance(got, ParsedDataset)
    _assert_parsed_equal(got, want)


def test_native_and_python_routes_agree(dataset):
    paths, port, _ = dataset
    for split in SPLITS:
        _assert_parsed_equal(
            parse_file(paths[split], *port, use_native=True),
            parse_file(paths[split], *port, use_native=False))


def test_native_build_failure_raises_with_compiler_output(
        dataset, tmp_path, monkeypatch):
    """Where the JAX package would fall back to the Python loop, the
    port raises with g++'s output."""
    paths, port, _ = dataset
    broken = tmp_path / "fastparse.cpp"
    broken.write_text("int broken( {\n")
    monkeypatch.setattr(_build, "HOST_SOURCES", {"fastparse": broken})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="fastparse.cpp"):
        parse_file(paths["train"], *port)
    # the explicit Python route does not build anything
    assert len(parse_file(paths["train"], *port, use_native=False)) > 0


def _loaders(dataset, split, L=10, **kw):
    paths, port, jax = dataset
    ds = parse_file(paths[split], *port)
    jds = jax_parse_file(paths[split], *jax)
    return SequenceLoader(ds, L, **kw), JaxLoader(jds, L, **kw)


def _assert_batch_equal(got, want):
    assert isinstance(got, Batch)
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), np.asarray(getattr(want, f.name))
        assert isinstance(g, np.ndarray), f.name
        assert g.dtype == w.dtype, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)


@pytest.mark.parametrize("L", [1, 10, 40])
def test_padded_view_matches_jax(dataset, L):
    paths, port, jax = dataset
    got = PaddedView(parse_file(paths["train"], *port), L)
    want = JaxPaddedView(jax_parse_file(paths["train"], *jax), L)
    for name in ("item_hist", "cate_hist", "time_diff", "time_from_first",
                 "time_to_now", "mask", "lengths", "users", "items",
                 "cates", "labels"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


@pytest.mark.parametrize("B, min_seq, min_rows", [
    (64, 1, 5), (50, 3, 5), (7, 1, 5), (100, 1, 30)])
def test_train_batches_match_jax(dataset, B, min_seq, min_rows):
    port, jax = _loaders(dataset, "train", min_batch_rows=min_rows)
    rng_p, rng_j = np.random.RandomState(11), np.random.RandomState(11)
    for _ in range(2):                       # RandomState consumption too
        got = list(port.train_batches(B, rng_p, min_seq_length=min_seq))
        want = list(jax.train_batches(B, rng_j, min_seq_length=min_seq))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _assert_batch_equal(g, w)


@pytest.mark.parametrize("split, group, groups, min_seq", [
    ("valid", 5, 3, 1), ("valid", 5, 12, 4), ("test", 10, 7, 1),
    ("test", 1, 64, 1)])
def test_eval_batches_match_jax(dataset, split, group, groups, min_seq):
    port, jax = _loaders(dataset, split)
    got = list(port.eval_batches(group, groups, min_seq_length=min_seq))
    want = list(jax.eval_batches(group, groups, min_seq_length=min_seq))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _assert_batch_equal(g, w)


def test_eval_batches_refuse_ragged_groups(dataset):
    port, _ = _loaders(dataset, "valid")
    with pytest.raises(ValueError, match="not divisible"):
        next(port.eval_batches(3, 4))


@pytest.mark.parametrize("kw", [
    dict(), dict(n_users=80, n_items=500, n_cates=30, valid_num_ngs=2,
                 test_num_ngs=19, seed=4)], ids=["defaults", "wider"])
def test_synthetic_files_are_byte_identical(tmp_path, kw):
    got = write_synthetic_dataset(str(tmp_path / "port"), **kw)
    want = jax_write_dataset(str(tmp_path / "jax"), **kw)
    assert got.keys() == want.keys()
    for key in got:
        assert filecmp.cmp(got[key], want[key], shallow=False), key


@pytest.mark.parametrize("unit", ["s", "ms"])
def test_fast_synthetic_files_are_byte_identical(tmp_path, unit):
    kw = dict(n_users=40, n_items=300, n_cates=12, seed=2, time_unit=unit)
    got = write_synthetic_dataset_fast(str(tmp_path / "port"), **kw)
    want = jax_write_fast(str(tmp_path / "jax"), **kw)
    assert got.keys() == want.keys()
    for key in got:
        assert filecmp.cmp(got[key], want[key], shallow=False), key


# ----------------------------------------------------------- prefetch


def _host_batches(n, B=4, G=2, L=3):
    for i in range(n):
        b = Batch(**{f.name: np.asarray(getattr(Batch.zeros(B, G, L),
                                                f.name))
                     for f in dataclasses.fields(Batch)})
        b.users[:] = i
        yield b


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetch_on_cpu_yields_tensors_in_order(depth):
    out = list(prefetch_to_device(_host_batches(7), "cpu", depth))
    assert [int(b.users[0]) for b in out] == list(range(7))
    for b in out:
        for f in dataclasses.fields(b):
            t = getattr(b, f.name)
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    assert out[0].items.dtype == torch.int32
    assert out[0].mask.dtype == torch.float32


def test_prefetch_reraises_producer_errors():
    def bad():
        yield from _host_batches(2)
        raise KeyError("in the producer")

    it = prefetch_to_device(bad(), "cpu", 2)
    assert int(next(it).users[0]) == 0
    with pytest.raises(KeyError, match="in the producer"):
        list(it)


def test_prefetch_abandoned_consumer_releases_producer():
    """An early-stopped consumer must not pin the producer (and its
    batches) behind a blocked put."""
    n_before = threading.active_count()
    big = list(_host_batches(50))
    refs = [weakref.ref(b) for b in big]

    def gen():
        for b in big:
            yield b

    it = prefetch_to_device(gen(), "cpu", 2)
    next(it)          # start the producer; it blocks on the full queue
    it.close()        # abandon mid-stream
    del it, big, gen
    for _ in range(100):
        gc.collect()
        if (threading.active_count() <= n_before
                and sum(r() is not None for r in refs) <= 4):
            break
        time.sleep(0.05)
    assert threading.active_count() <= n_before + 1
    assert sum(r() is not None for r in refs) <= 6


# ---------------------------------------------------------- summaries


def test_summary_writer(tmp_path):
    w = SummaryWriter(str(tmp_path / "logs"))
    w.scalars(10, {"loss": 1.5, "data_loss": np.float32(1.25)})
    w.scalars(20, {"loss": 1.1})
    w.close()
    lines = [json.loads(line) for line in
             open(tmp_path / "logs" / "scalars.jsonl")]
    assert lines[0]["step"] == 10 and lines[0]["loss"] == 1.5
    assert lines[0]["data_loss"] == 1.25 and lines[1]["step"] == 20
    SummaryWriter(None).scalars(1, {"loss": 1.0})      # no dir: a no-op


def test_summary_writers_write_tfevents_and_histograms(tmp_path):
    """Ported: an event file beside the JSONL, histogram records in both
    (against JAX's, tests/test_torch_summaries.py); without a log
    directory nothing is written."""
    w = SummaryWriter(str(tmp_path), write_tfevents=True)
    w.scalars(2, {"loss": 0.5})
    w.histograms(2, {"h": (np.array([3, 0, 1], np.int32), -1.0, np.inf,
                           2)})
    w.close()
    (path,) = tmp_path.glob("events.out.tfevents.*")
    events = summaries.read_events(str(path))
    assert events[0]["file_version"] == "brain.Event:2"
    assert [v["tag"] for e in events[1:] for v in e["values"]] == ["loss",
                                                                   "h"]
    # hi = inf is clamped to 0 (strict JSON): the edges split [-1, 0]
    np.testing.assert_allclose(events[2]["values"][0]["tensor"], [
        [-1.0, -2 / 3, 3.0], [-2 / 3, -1 / 3, 0.0], [-1 / 3, 0.0, 1.0]],
        rtol=0, atol=1e-15)
    rec = json.loads(open(tmp_path / "scalars.jsonl").readlines()[-1])
    assert rec == {"step": 2, "hist": "h", "lo": -1.0, "hi": 0.0,
                   "counts": [3, 0, 1], "nonfinite": 2}
    SummaryWriter(None).histograms(1, {"h": (np.zeros(2), 0.0, 1.0)})
