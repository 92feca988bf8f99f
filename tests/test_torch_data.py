"""The port's config, vocab, time features and batch against clsr_tpu,
and the generators of data/synthetic.py: the drift dataset's files
byte-identical to JAX's `write_drift_dataset` (and its events to
`make_drift_events`), and `device_batch` with JAX's shapes, dtypes,
ranges and prefix masks."""

import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

import clsr_tpu
from clsr_tpu.config import load_config as jax_load_config
from clsr_tpu.data.parser import compute_time_features as jax_time_features
from clsr_tpu.data.parser import time_range_for_unit as jax_time_range
from clsr_tpu.data.synthetic import device_batch as jax_device_batch
from clsr_tpu.data.synthetic import make_drift_events as jax_drift_events
from clsr_tpu.data.synthetic import write_drift_dataset as jax_write_drift
from clsr_tpu.data.vocab import Vocab as JaxVocab
from clsr_tpu.data.vocab import load_vocab as jax_load_vocab
from clsr_tpu_torch.config import CONFIG_DIR, Config, load_config
from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.data.parser import (compute_time_features,
                                        time_range_for_unit)
from clsr_tpu_torch.data.synthetic import (device_batch, make_drift_events,
                                           write_drift_dataset)
from clsr_tpu_torch.data.vocab import Vocab, load_vocab

# Six xdist workers, each with torch's default intra-op pool (a thread a
# core), oversubscribe the cores several times over; under xdist a
# worker keeps one thread.  Run alone (or on the card) torch keeps its
# default.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


_VOCABS = dict(user_vocab="u", item_vocab="i", cate_vocab="c")
_JAX_YAML = os.path.join(os.path.dirname(clsr_tpu.__file__), "configs",
                         "clsr.yaml")


def test_clsr_yaml_loads_like_jax():
    port = load_config(f"{CONFIG_DIR}/clsr.yaml", **_VOCABS, seed=4)
    jax_cfg = jax_load_config(_JAX_YAML, **_VOCABS, seed=4)
    jax_fields = dataclasses.asdict(jax_cfg)
    for f in dataclasses.fields(Config):
        assert getattr(port, f.name) == jax_fields[f.name], f.name
    assert port.enable_bn and port.layer_sizes == (100, 64)
    assert port.att_fcn_layer_sizes == (80, 40)
    assert port.use_pallas_eval_attention == "auto"
    assert not port.use_pallas_scan


@pytest.mark.parametrize("bad, err", [
    (dict(user_vocab=None), ValueError),
    (dict(hidden_size=41), ValueError),
    (dict(hidden_size="40"), TypeError),
    (dict(loss="hinge"), ValueError),
    (dict(use_pallas_eval_attention="maybe"), ValueError),
    (dict(use_pallas_train_attention="maybe"), ValueError),
    (dict(contrastive_loss="hinge"), ValueError),
    (dict(learning_rate="fast"), TypeError),
    (dict(attention_block_size=64), ValueError),
])
def test_config_validation_raises(bad, err):
    kw = dict(_VOCABS, **bad)
    with pytest.raises(err):
        load_config(f"{CONFIG_DIR}/clsr.yaml", **kw)
    with pytest.raises(err):
        jax_load_config(_JAX_YAML, **kw)


def test_vocab_pickles_interoperate(tmp_path):
    counts = {"a": 3, "b": 5, "c": 3, "d": 1}
    port, jax_v = Vocab.from_counts(counts), JaxVocab.from_counts(counts)
    assert port.mapping == jax_v.mapping
    port.save(str(tmp_path / "p.pkl"))
    jax_v.save(str(tmp_path / "j.pkl"))
    assert jax_load_vocab(str(tmp_path / "p.pkl")).mapping == port.mapping
    back = load_vocab(str(tmp_path / "j.pkl"))
    assert back.lookup_many(["b", "zz", "d"]) == [1, 0, 4]
    assert len(back) == 5 and "a" in back


@pytest.mark.parametrize("unit", ["s", "ms"])
@pytest.mark.parametrize("n", [1, 2, 9])
def test_time_features_match_jax(unit, n):
    rng = np.random.RandomState(n)
    t = np.sort(1.5e9 + rng.randint(0, 10 ** 6, n)).astype(np.float64)
    cur = float(t[-1] + 3600)
    assert time_range_for_unit(unit) == jax_time_range(unit)
    for a, b in zip(compute_time_features(t, cur, time_range_for_unit(unit)),
                    jax_time_features(t, cur, jax_time_range(unit))):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_batch_zeros_and_to():
    b = Batch.zeros(3, 5, 7)
    assert b.items.shape == (3, 5) and b.mask.shape == (3, 7)
    assert b.users.shape == (3,)
    assert b.items.dtype == torch.int32 and b.mask.dtype == torch.float32
    moved = b.to("cpu")
    assert all(torch.equal(getattr(moved, f.name), getattr(b, f.name))
               for f in dataclasses.fields(Batch))


@pytest.mark.parametrize("kw", [
    dict(n_users=40, n_items=90, n_cates=9, seed=3),
    dict(n_users=25, n_items=63, n_cates=7, seed=1, alpha_bimodal=True,
         burst_len=3, min_events=6, max_events=12)])
def test_drift_dataset_is_byte_identical(tmp_path, kw):
    got = write_drift_dataset(str(tmp_path / "port"), valid_num_ngs=4,
                              test_num_ngs=9, **kw)
    want = jax_write_drift(str(tmp_path / "jax"), valid_num_ngs=4,
                           test_num_ngs=9, **kw)
    assert set(got) == set(want)
    for key in want:
        assert filecmp.cmp(got[key], want[key], shallow=False), key
    gen = {k: v for k, v in kw.items() if k not in ("n_users", "n_items",
                                                     "n_cates")}
    events, item2cate, alphas = make_drift_events(
        kw["n_users"], kw["n_items"], kw["n_cates"], **gen)
    j_events, j_item2cate, j_alphas = jax_drift_events(
        kw["n_users"], kw["n_items"], kw["n_cates"], **gen)
    np.testing.assert_array_equal(item2cate, j_item2cate)
    assert alphas == j_alphas and events.keys() == j_events.keys()
    for u, (items, times) in events.items():
        np.testing.assert_array_equal(items, j_events[u][0])
        np.testing.assert_array_equal(times, j_events[u][1])


@pytest.mark.parametrize("G", [1, 5])
def test_device_batch_has_jax_shapes_and_ranges(G):
    import jax
    B, L, n_items, n_cates, n_users = 64, 9, 30, 6, 11
    want = jax_device_batch(jax.random.PRNGKey(0), B, L, n_items, n_cates,
                            n_users, G=G)
    got = device_batch(torch.Generator().manual_seed(0), B, L, n_items,
                       n_cates, n_users, G=G, device="cpu")
    for f in dataclasses.fields(Batch):
        g, w = getattr(got, f.name), np.asarray(getattr(want, f.name))
        assert tuple(g.shape) == w.shape, f.name
        assert str(g.dtype).split(".")[1] == str(w.dtype), f.name
    lengths = got.mask.sum(1)
    assert lengths.min() >= 1 and lengths.max() <= L
    prefix = torch.arange(L)[None] < lengths[:, None]
    assert torch.equal(got.mask.bool(), prefix)
    assert got.users.min() >= 0 and got.users.max() < n_users
    for ids, hi in ((got.items, n_items), (got.cates, n_cates)):
        assert ids.min() >= 1 and ids.max() < hi
    for ids, hi in ((got.item_hist, n_items), (got.cate_hist, n_cates)):
        assert torch.equal(ids > 0, prefix) and ids.max() < hi
    for t in (got.time_diff, got.time_from_first, got.time_to_now):
        assert t.min() >= 0 and t.max() < 1
        assert torch.equal(t * got.mask, t)
    assert torch.equal(got.time_to_now, got.time_diff)   # JAX's one key
    np.testing.assert_array_equal(np.asarray(want.time_to_now),
                                  np.asarray(want.time_diff))
    assert torch.equal(got.labels[:, 0], torch.ones(B))
    assert got.labels[:, 1:].sum() == 0 and torch.equal(got.valid,
                                                        torch.ones(B))
    if not torch.cuda.is_available():     # the card by default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device_batch(torch.Generator(), B, L, n_items, n_cates, n_users)
