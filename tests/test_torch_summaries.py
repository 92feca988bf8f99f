"""The port's histograms, event files and timing utilities against JAX's.

  * `device_histogram` (training/steps.py) against JAX's
    `_device_histogram`: counts, lo, hi and the non-finite count equal,
    on normal values, +-inf and NaN among them, a constant tensor, an
    all-non-finite one, and values exactly on bucket edges;
  * `make_histogram_step` against JAX's on the same weights and probe
    batch: the same tags (logit, alpha, att_fea_long, att_fea2,
    model_output and each table's `_output`), the tables' counts equal,
    the activations' ranges to 1e-5 and their counts off by at most a
    value or two at a bucket edge;
  * the event files of `SummaryWriter(write_tfevents=True)` against the
    JAX package's (written through TensorFlow), both read by
    TensorFlow's `summary_iterator`: the same events, tags, steps,
    values and histogram tensors, the same bytes but the wall time and
    the writer's name; `read_events` reads both; the JSONL records equal;
  * `utils/profiling.py`, `utils/timer.py` and `utils/device.py`'s
    timing helpers on the CPU, `per_step_seconds` against JAX's.
"""

import glob
import json
import os

import jax
import numpy as np
import pytest
import tensorflow as tf
import torch

import clsr_tpu.training.steps as jax_steps
from clsr_tpu.training.optimizer import build_optimizer as jax_optimizer
from clsr_tpu.training.state import TrainState as JaxTrainState
from clsr_tpu.utils.device import per_step_seconds as jax_per_step
from clsr_tpu.utils.summaries import SummaryWriter as JaxWriter
from clsr_tpu_torch import weights
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.training.steps import (device_histogram,
                                           make_histogram_step)
from clsr_tpu_torch.utils import device, profiling, summaries
from clsr_tpu_torch.utils.summaries import SummaryWriter
from clsr_tpu_torch.utils.timer import Timer

from test_torch_common import (N_CATES, N_ITEMS, N_USERS, jax_batch,
                               jax_clsr, numpy_batch, port_batch,
                               port_cfg, small_jax_cfg, to_np)

NBINS = 64


def _edges(lo, hi, n=NBINS):
    """Values on every bucket edge of [lo, hi] in f32, both ends."""
    lo, hi = np.float32(lo), np.float32(hi)
    return lo + (hi - lo) * np.arange(n + 1, dtype=np.float32) / n


HIST_CASES = {
    "normal": np.random.RandomState(0).randn(7, 33),
    "nonfinite": np.concatenate([np.random.RandomState(1).randn(50),
                                 [np.inf, -np.inf, np.nan, np.nan, 3.5]]),
    "constant": np.full((4, 5), 2.25),
    "all_nonfinite": np.array([np.nan, np.inf, -np.inf]),
    "edges_int": np.arange(NBINS + 1, dtype=np.float64),
    "edges_ragged": np.concatenate([_edges(-1.3, 2.9), _edges(-1.3, 2.9)[
        ::3] + 1e-7]),
    "tiny_span": np.array([1.0, 1.0 + 2 ** -23, 1.0, 1.0 + 2 ** -22]),
}


@pytest.mark.parametrize("case", sorted(HIST_CASES))
def test_device_histogram_matches_jax(case):
    x = np.asarray(HIST_CASES[case], np.float32)
    want = jax.jit(jax_steps._device_histogram, static_argnums=1)(x, NBINS)
    got = device_histogram(torch.from_numpy(x), NBINS)
    assert got[0].dtype == torch.int32 and got[0].shape == (NBINS,)
    np.testing.assert_array_equal(to_np(got[0]), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        assert float(g) == float(w)
    assert int(got[0].sum()) + int(got[3]) == x.size


@pytest.fixture(scope="module")
def hist_pair():
    """JAX's and the port's histograms of one CLSR and probe batch."""
    jcfg = small_jax_cfg(seed=4)
    model, params, stats = jax_clsr(jcfg)
    arrays = numpy_batch(np.random.RandomState(6), 8, 5, 7)
    state = JaxTrainState.create(apply_fn=model.apply, params=params,
                                 batch_stats=stats, tx=jax_optimizer(jcfg))
    want = jax_steps.make_histogram_step(model, jcfg, NBINS)(
        state, jax_batch(arrays))
    pmodel = get_model_class("clsr")(port_cfg(jcfg), N_USERS, N_ITEMS,
                                     N_CATES, device="cpu")
    weights.from_flax(pmodel, params, stats)
    got = make_histogram_step(NBINS)(pmodel, port_batch(arrays))
    as_np = lambda h: {t: tuple(np.asarray(to_np(v)) for v in parts)
                       for t, parts in h.items()}
    return as_np(want), as_np(got)


def test_histogram_step_matches_jax(hist_pair):
    want, got = hist_pair
    assert set(got) == set(want) == {
        "logit", "alpha", "att_fea_long", "att_fea2", "model_output",
        "item_embedding_output", "cate_embedding_output",
        "user_long_embedding_output", "user_short_embedding_output"}
    for tag, (counts, lo, hi, bad) in got.items():
        w_counts, w_lo, w_hi, w_bad = want[tag]
        assert counts.sum() == w_counts.sum() and bad == w_bad == 0, tag
        np.testing.assert_allclose([lo, hi], [w_lo, w_hi], rtol=1e-5,
                                   atol=1e-6, err_msg=tag)
        moved = np.abs(counts.astype(int) - w_counts).sum()
        assert moved <= (0 if tag.endswith("_output") else 4), (tag, moved)


def _tf_events(log_dir):
    (path,) = glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))
    events = list(tf.compat.v1.train.summary_iterator(path))
    return path, events


def _write(writer_cls, log_dir, hists):
    w = writer_cls(str(log_dir), write_tfevents=True)
    w.scalars(3, {"loss": 1.5, "data_loss": np.float32(0.25)})
    w.scalars(7, {"valid/auc": 0.625})
    w.histograms(7, hists)
    w.close()


def test_event_files_match_jax(tmp_path, hist_pair):
    want_hists, got_hists = hist_pair
    _write(JaxWriter, tmp_path / "jax", want_hists)
    _write(SummaryWriter, tmp_path / "port", want_hists)
    (jpath, want), (ppath, got) = (_tf_events(tmp_path / n)
                                   for n in ("jax", "port"))
    assert len(got) == len(want) == 1 + 3 + len(want_hists)
    assert got[0].file_version == want[0].file_version == "brain.Event:2"
    for g, w in zip(got, want):
        assert g.step == w.step
        for e in (g, w):
            e.wall_time = 0.0
            e.ClearField("source_metadata")
        assert g.SerializeToString() == w.SerializeToString(), (g, w)
    for g in got[1:]:
        (value,) = g.summary.value
        tensor = tf.make_ndarray(value.tensor)
        if value.metadata.plugin_data.plugin_name == "histograms":
            counts = want_hists[value.tag][0]
            assert tensor.shape == (NBINS, 3) and tensor.dtype == np.float64
            np.testing.assert_array_equal(tensor[:, 2], counts)
    # the port's own reader on both files: what TensorFlow read
    for path, events in ((jpath, want), (ppath, got)):
        mine = summaries.read_events(path)
        assert [e["step"] for e in mine] == [e.step for e in events]
        for m, e in zip(mine[1:], events[1:]):
            (v,) = m["values"]
            (ev,) = e.summary.value
            assert v["tag"] == ev.tag
            assert v["plugin"] == ev.metadata.plugin_data.plugin_name
            np.testing.assert_array_equal(v["tensor"],
                                          tf.make_ndarray(ev.tensor))
    lines = {n: [json.loads(x) for x in open(tmp_path / n / "scalars.jsonl")]
             for n in ("jax", "port")}
    for g, w in zip(lines["port"], lines["jax"]):
        g.pop("time", None), w.pop("time", None)
        assert g == w


def test_read_events_refuses_a_bad_crc(tmp_path):
    w = summaries.EventFileWriter(str(tmp_path))
    w.scalar("loss", 0.5, 2)
    w.close()
    assert summaries.read_events(w.path)[1]["values"][0]["tensor"] == 0.5
    data = bytearray(open(w.path, "rb").read())
    data[-6] ^= 1
    open(w.path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="bad CRC"):
        summaries.read_events(w.path)
    assert summaries.masked_crc32c(b"") == 0xA282EAD8
    assert summaries.crc32c(b"123456789") == 0xE3069283


def test_timing_utilities(tmp_path):
    with Timer() as t:
        sum(range(1000))
    assert t.interval > 0 and not t.running and float(str(t)) >= 0
    with pytest.raises(ValueError, match="not been started"):
        Timer().stop()
    timer = profiling.StepTimer(warmup=2)
    for _ in range(5):
        timer(torch.ones, 3)
    assert len(timer.times) == 3 and timer.median > 0 and timer.mean > 0
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(4) @ torch.ones(4)
    assert prof is not None
    (trace_file,) = glob.glob(str(tmp_path / "trace" / "trace_*.json"))
    assert json.load(open(trace_file))["traceEvents"]
    with profiling.trace(None) as prof:
        assert prof is None
    assert len(device.timed_calls(lambda: torch.ones(2), 3, warmup=1)) == 3
    pts = [(1, 0.011), (4, 0.023), (16, 0.07), (32, 0.134)]
    assert device.per_step_seconds(pts) == pytest.approx(jax_per_step(pts),
                                                         rel=1e-12)
    with pytest.raises(ValueError, match=">=2"):
        device.per_step_seconds(pts[:1])
