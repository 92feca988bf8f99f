"""Device-resident training data against the JAX package and the port's
streamed path.

  * `epoch_permutation` equals JAX's exactly (the permutation, the call
    layout and the RandomState's state after it), for layouts with and
    without a dropped trailing batch;
  * `gather_batch` equals JAX's bit for bit, invalid rows included, and
    the loader's zero-padded batch bit for bit, dtypes included;
  * `_use_resident` resolves 'auto' / 'on' / 'off' as JAX's does;
  * a resident `Trainer.fit` (one epoch, CPU) is bit-identical to the
    port's streamed fit from the same seed, at K = 1 and K = 3, with
    dense Adam and with compact lazyadam: every model and optimizer
    tensor, the losses logged and the valid metrics;
  * after a resident compact-lazyadam epoch the table Parameters equal
    pmn[:, :D] (the lazy update writes them; no sync is needed) and
    have moved, and the eval reads the trained rows;
  * a bucketed fit with K = 3 runs each bucket's batches as calls of 3
    and tail steps: the steps an epoch are the buckets' batches.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clsr_tpu.data.resident as jres
from clsr_tpu.training.trainer import Trainer as JaxTrainer
import clsr_tpu_torch.data.resident as pres
from clsr_tpu_torch.config import load_config
from clsr_tpu_torch.data.prefetch import to_device
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.training.evaluator import run_weighted_eval
from clsr_tpu_torch.training.lazy_adam import is_pmn
from clsr_tpu_torch.training.trainer import Trainer

from test_torch_common import padded_view, small_jax_cfg
from test_torch_trainer import FIT, OPTIMIZERS, _sizes, _state_tensors
from test_torch_trainer import data  # noqa: F401  (the fixture)


@pytest.mark.parametrize("n, B, K", [(707, 64, 3), (707, 64, 1),
                                     (643, 64, 4), (65, 16, 2),
                                     (3, 16, 1), (0, 16, 2)])
def test_epoch_permutation_equals_jax(n, B, K):
    eligible = np.flatnonzero(np.random.RandomState(n).rand(n + 40) < 0.9
                              )[:n]
    a, b = np.random.RandomState(11), np.random.RandomState(11)
    got = pres.epoch_permutation(eligible, a, B, K, 5)
    want = jres.epoch_permutation(eligible, b, B, K, 5)
    assert got[0].dtype == want[0].dtype == np.int32
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
    assert len(got[0]) == pres.perm_length(len(eligible), B, 5)
    assert a.randint(1 << 30) == b.randint(1 << 30)


def test_gather_batch_equals_jax_bit_for_bit():
    view = padded_view(0)
    res = pres.build_resident(view, "cpu")
    jr = jres.build_resident(view)
    assert res.nbytes() == jr.nbytes() and res.seq_len == jr.seq_len
    rng = np.random.RandomState(1)
    idx = rng.randint(0, len(view.users), 16).astype(np.int32)
    valid = np.arange(16) < 11                     # 5 invalid rows
    got = pres.gather_batch(res, torch.from_numpy(idx),
                            torch.from_numpy(valid))
    want = jres.gather_batch(jr, jnp.asarray(idx), jnp.asarray(valid))
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name).numpy(), np.asarray(getattr(want,
                                                                f.name))
        assert g.dtype == w.dtype and g.shape == w.shape, f.name
        assert np.array_equal(g, w), f.name
        assert not g[~valid].any(), f.name


def test_resident_batches_equal_the_loaders(data):  # noqa: F811
    """The feed's batches at each offset of an epoch are the streamed
    loader's batches from the same RandomState, bit for bit."""
    _, _, port, _ = data
    loader = port["train"]
    B = 64
    elig = np.flatnonzero(loader.view.lengths >= 1)
    perm, n_use, n_calls, n_tail = pres.epoch_permutation(
        elig, np.random.RandomState(4), B, 1, 5)
    feed = pres.EpochFeed(pres.build_resident(loader.view, "cpu"),
                          pres.perm_length(len(elig), B))
    feed.set_epoch(perm, n_use)
    streamed = list(loader.train_batches(B, np.random.RandomState(4)))
    assert len(streamed) == n_calls + n_tail > 1
    for i, want in enumerate(streamed):
        feed.offset.fill_(i * B)
        got = feed.batch(B)
        assert int(feed.offset) == (i + 1) * B
        for f in dataclasses.fields(got):
            g, w = getattr(got, f.name).numpy(), getattr(want, f.name)
            assert g.dtype == w.dtype and np.array_equal(g, w), f.name
            # +0.0 in the padding, as the loader's zeros
            assert np.array_equal(np.signbit(g), np.signbit(w)), f.name


@pytest.mark.parametrize("setting, max_bytes", [
    ("auto", 6_000_000_000), ("auto", 1000), ("on", 1000),
    ("off", 6_000_000_000)])
def test_use_resident_resolves_as_jax(data, setting, max_bytes):
    _, pv, port, jax_l = data
    kw = dict(FIT, resident_data=setting, resident_max_bytes=max_bytes)
    jt = types.SimpleNamespace(cfg=small_jax_cfg(**kw), _mesh=None)
    want = JaxTrainer._use_resident(jt, jax_l["train"])
    cfg = load_config(None, **dataclasses.asdict(small_jax_cfg(**kw)))
    t = Trainer(get_model_class("clsr")(cfg, *_sizes(pv), device="cpu"),
                cfg, log=lambda *a: None)
    assert t._use_resident(port["train"]) == want


def _fit(pv, port, log=None, **kw):
    cfg = load_config(None, **dict(
        dataclasses.asdict(small_jax_cfg(**FIT)),
        **dict(dict(seed=3, epochs=1, show_step=1), **kw)))
    t = Trainer(get_model_class("clsr")(cfg, *_sizes(pv), device="cpu"),
                cfg, log=log or (lambda *a: None))
    t.fit(port["train"], port["valid"])
    return t


def _losses(logs):
    return [line for line in logs if line.startswith("step ")]


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("opt", ["adam", "lazy_compact"])
def test_resident_fit_equals_streamed_fit(data, K, opt):
    _, pv, port, _ = data
    logs = {"off": [], "on": []}
    fits = {r: _fit(pv, port, logs[r].append, resident_data=r,
                    train_steps_per_call=K, **OPTIMIZERS[opt])
            for r in logs}
    assert fits["on"].feeds is not None and fits["off"].feeds is None
    a, b = (_state_tensors(fits[r].state) for r in ("on", "off"))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert fits["on"].state.step == fits["off"].state.step > 0
    assert fits["on"].eval_history == fits["off"].eval_history
    steps = lambda r: [s for s in fits[r].epoch_stats]
    assert [(s["steps"], s["examples"]) for s in steps("on")] == \
        [(s["steps"], s["examples"]) for s in steps("off")]
    if K == 1:          # one step a call both ways: the same log lines
        assert _losses(logs["on"]) == _losses(logs["off"])


def test_resident_lazy_tables_hold_the_trained_rows(data):
    _, pv, port, _ = data
    cfg_kw = dict(resident_data="on", train_steps_per_call=3,
                  **OPTIMIZERS["lazy_compact"])
    fresh = _fit(pv, port, **dict(cfg_kw, epochs=0))
    before = {n: p.detach().clone()
              for n, p in fresh.model.named_parameters()}
    t = _fit(pv, port, **cfg_kw)
    params = dict(t.model.named_parameters())
    moved = 0
    for name, mn in t.state.optimizer.moments.items():
        p = params[name]
        assert is_pmn(p, mn)
        assert torch.equal(p, mn[:, :p.shape[1]]), name
        moved += int(not torch.equal(p, before[name]))
    assert moved == len(t.state.optimizer.moments) == 4
    evaluate = lambda model: run_weighted_eval(
        t.eval_step, model, port["valid"], t.cfg, 4)
    assert evaluate(t.model) == t.eval_history[-1][1]
    assert evaluate(t.model) != evaluate(fresh.model)


def test_bucketed_fit_with_k3_runs_every_batch(data):
    _, pv, port, _ = data
    logs = []
    t = _fit(pv, port, logs.append, resident_data="on",
             train_steps_per_call=3, length_buckets="4",
             bn_refresh_batches=2)
    assert t.bucketed and len(t.feeds) == 2
    n_batches = sum(-(-pres._rows_used(len(e), 64, 5) // 64)
                    for _, e in t.feeds)
    stats = t.epoch_stats[0]
    logged = [int(line.split(",")[0].split()[1]) for line in _losses(logs)]
    assert stats["steps"] == n_batches == logged[-1]
    assert stats["examples"] == sum(pres._rows_used(len(e), 64, 5)
                                    for _, e in t.feeds)
    assert np.isfinite(stats["mean_loss"]) and stats["refresh_s"] > 0
    batch = to_device(next(port["valid"].eval_batches(5, 4)), "cpu")
    preds, _ = t.eval_step(t.model, batch)
    assert torch.isfinite(preds).all()
