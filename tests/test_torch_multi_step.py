"""K train steps a host call: the port's `make_multi_train_step`, its
stacked loader and its K = 3 fit against the JAX package's.

On the CPU, where `MultiTrainStep` runs its steps eagerly (on the card it
replays a CUDA graph of the step; tests/test_torch_fit_gpu.py holds the
replays to the eager steps bit for bit):

  * `make_multi_train_step` over a [3, B, ...] stack and `.step` over a
    tail batch equal 4 port single steps exactly (loss parts, every model
    and optimizer tensor, the step and lazyadam's count), for dense Adam
    and lazyadam compact and legacy, negatives drawn from the generator
    and embedding dropout on;
  * it equals JAX's `make_multi_train_step` over 3 steps to 1e-5 (loss
    parts of [3], parameters, BN statistics, lazyadam's moments and
    count), for dense Adam and lazyadam compact, the negatives carried in
    the batches (need_sample off), from JAX's perturbed init;
  * `train_batches_stacked` yields exactly JAX's arrays (the same items,
    stacked then tails, shapes, dtypes and values) over two epochs of one
    RandomState, with a padded tail, a dropped trailing batch and
    `min_seq_length`; each stack's slices are `train_batches`' batches;
  * two epochs of `Trainer.fit` at K = 3 against JAX's (stacked path,
    streaming), as tests/test_torch_trainer.py holds K = 1: losses 1e-4
    relative at the same logged steps, valid metrics 2e-4;
  * `Trainer.load` followed by a fit equals a fresh trainer loaded from
    the same checkpoint and fit the same way, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clsr_tpu.training.steps as jax_steps
from clsr_tpu.data.loader import SequenceLoader as JaxLoader
from clsr_tpu.data.parser import ParsedDataset as JaxParsed
from clsr_tpu.models.registry import get_model_class as jax_model_class
from clsr_tpu.training.lazy_adam import make_lazy_optimizer
from clsr_tpu.training.optimizer import build_optimizer as jax_optimizer
from clsr_tpu.training.state import TrainState as JaxTrainState
from clsr_tpu.training.trainer import Trainer as JaxTrainer
import clsr_tpu_torch.training.steps as port_steps
from clsr_tpu_torch import weights
from clsr_tpu_torch.config import load_config
from clsr_tpu_torch.data.loader import SequenceLoader
from clsr_tpu_torch.data.parser import ParsedDataset
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.training.state import create_train_state
from clsr_tpu_torch.training.steps import (make_multi_train_step,
                                           make_train_step, stack_batches)
from clsr_tpu_torch.training.trainer import Trainer

from test_torch_common import (N_CATES, N_ITEMS, N_USERS, TOL, jax_batch,
                               jax_clsr, numpy_batch, perturb, port_batch,
                               port_cfg, small_jax_cfg)
from test_torch_trainer import (FIT, OPTIMIZERS, _jax_negatives,
                                _port_negatives, _scalars, _sizes,
                                _state_tensors, data)  # noqa: F401

K = 3


def _flat(tree):
    from flax.traverse_util import flatten_dict
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


# ------------------------------------- K steps a call = K single steps


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_multi_step_equals_single_steps(opt):
    jcfg = small_jax_cfg(embedding_dropout=0.2, train_num_ngs=3,
                         embed_l2=1e-4, layer_l2=1e-4,
                         contrastive_length_threshold=2)
    cfg = port_cfg(jcfg, **OPTIMIZERS[opt])
    rng = np.random.RandomState(5)
    batches = []
    for _ in range(K + 1):
        b = numpy_batch(rng, 6, 1, jcfg.max_seq_length)
        b["labels"][:, 0] = 1.0
        batches.append(port_batch(b))
    batches[-1].valid[4:] = 0.0          # a padded tail

    runs = {}
    for run in ("single", "multi"):
        model = get_model_class("clsr")(cfg, N_USERS, N_ITEMS, N_CATES,
                                        device="cpu")
        state = create_train_state(model, cfg)
        gen = torch.Generator().manual_seed(9)
        if run == "single":
            step = make_train_step(model, cfg)
            parts = [step(state, b, gen)[1] for b in batches]
            losses = torch.stack([torch.stack([getattr(p, f.name)
                                               for p in parts])
                                  for f in dataclasses.fields(parts[0])])
        else:
            multi = make_multi_train_step(model, cfg, K)
            state, stacked = multi(state, stack_batches(batches[:K]), gen)
            state, tail = multi.step(state, batches[K], gen)
            losses = torch.stack([
                torch.cat([getattr(stacked, f.name),
                           getattr(tail, f.name)[None]])
                for f in dataclasses.fields(stacked)])
        runs[run] = (state, losses)
    (sa, la), (sb, lb) = runs["single"], runs["multi"]
    assert torch.equal(la, lb)
    assert sa.step == sb.step == K + 1
    ta, tb = _state_tensors(sa), _state_tensors(sb)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    if opt != "adam":
        assert int(sb.optimizer.count) == K + 1


# ----------------------------------------------------- against JAX's

_STEP_CFG = dict(need_sample=False, train_num_ngs=4, embed_l2=1e-4,
                 layer_l2=1e-4, contrastive_length_threshold=2,
                 max_grad_norm=0.5)


def _step_batches():
    rng = np.random.RandomState(12)
    out = []
    for _ in range(K):
        b = numpy_batch(rng, 4, 5, 7)
        b["labels"][:, 0] = 1.0
        out.append(b)
    return out


@pytest.mark.parametrize("opt", ["adam", "lazy_compact"])
def test_multi_step_matches_jax(opt):
    jcfg = small_jax_cfg(**_STEP_CFG, **OPTIMIZERS[opt])
    model, params, stats = jax_clsr(jcfg)
    if jcfg.optimizer == "lazyadam":
        init_fn, _ = make_lazy_optimizer(jcfg)
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                               apply_fn=model.apply, params=params, tx=None,
                               opt_state=init_fn(params), batch_stats=stats)
    else:
        jstate = JaxTrainState.create(apply_fn=model.apply, params=params,
                                      batch_stats=stats,
                                      tx=jax_optimizer(jcfg))
    batches = _step_batches()
    jmulti = jax_steps.make_multi_train_step(model, jcfg, K, donate=False)
    jstate, jparts = jmulti(jstate, jax_steps.stack_batches(
        [jax_batch(b) for b in batches]), jax.random.PRNGKey(0))

    cfg = port_cfg(jcfg)
    pmodel = get_model_class("clsr")(cfg, N_USERS, N_ITEMS, N_CATES,
                                     device="cpu")
    weights.from_flax(pmodel, params, stats)
    state = create_train_state(pmodel, cfg)
    multi = make_multi_train_step(pmodel, cfg, K)
    state, parts = multi(state, stack_batches([port_batch(b)
                                               for b in batches]),
                         torch.Generator().manual_seed(0))

    for f in dataclasses.fields(parts):
        got = getattr(parts, f.name).numpy()
        assert got.shape == (K,)
        np.testing.assert_allclose(got, np.asarray(getattr(jparts, f.name)),
                                   **TOL, err_msg=f.name)
    got_params, got_stats = weights.to_flax(pmodel)
    for got, want in ((got_params, jstate.params),
                      (got_stats, jstate.batch_stats)):
        want = _flat(want)
        assert set(_flat(got)) == set(want)
        for k, v in _flat(got).items():
            np.testing.assert_allclose(v, want[k], **TOL, err_msg=k)
    assert state.step == K
    if jcfg.optimizer == "lazyadam":
        moments, count = weights.opt_to_flax(state)
        want = {"/".join(k): np.asarray(v)
                for k, v in jstate.opt_state.moments.items()}
        assert count == int(jstate.opt_state.count) == K
        for k, v in _flat(moments).items():
            np.testing.assert_allclose(v, want[k], **TOL, err_msg=k)


# ------------------------------------------------- the stacked loader


def _parsed(n, seed):
    """(port, JAX) ParsedDatasets of the same n random rows, histories
    of 0..12 events."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(0, 13, n)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    total = int(offsets[-1])
    f32 = np.float32
    arrays = dict(
        labels=rng.randint(0, 2, n).astype(f32),
        users=rng.randint(0, 40, n).astype(np.int32),
        items=rng.randint(0, 90, n).astype(np.int32),
        cates=rng.randint(0, 9, n).astype(np.int32),
        times=rng.rand(n) * 1e6, offsets=offsets,
        hist_items=rng.randint(1, 90, total).astype(np.int32),
        hist_cates=rng.randint(1, 9, total).astype(np.int32),
        time_diff=rng.randn(total).astype(f32),
        time_from_first=rng.rand(total).astype(f32),
        time_to_now=rng.rand(total).astype(f32))
    return ParsedDataset(**arrays), JaxParsed(**arrays)


# (n rows, B, min_seq_length), rows of length 0 skipped: a 5-row padded
# tail; whole tail batches and a 4-row trailing batch dropped; a 3-row
# trailing batch dropped and no tail; min_seq_length 3, tails and a drop
STACK_CASES = [(99, 8, 1), (101, 8, 1), (103, 8, 1), (120, 10, 3)]


@pytest.mark.parametrize("n,B,min_len", STACK_CASES)
def test_train_batches_stacked_matches_jax(n, B, min_len):
    port_ds, jax_ds = _parsed(n, seed=n + B)
    port, jl = SequenceLoader(port_ds, 10), JaxLoader(jax_ds, 10)
    rngs = [np.random.RandomState(4), np.random.RandomState(4),
            np.random.RandomState(4)]
    n_stacked = 0
    for _ in range(2):                   # two epochs: both buffer sets
        got = list(port.train_batches_stacked(B, K, rngs[0],
                                              min_seq_length=min_len))
        want = list(jl.train_batches_stacked(B, K, rngs[1],
                                             min_seq_length=min_len))
        singles = list(port.train_batches(B, rngs[2],
                                          min_seq_length=min_len))
        assert len(got) == len(want)
        flat = []
        for g, w in zip(got, want):
            for f in dataclasses.fields(g):
                a, b = getattr(g, f.name), np.asarray(getattr(w, f.name))
                assert a.shape == b.shape and a.dtype == b.dtype, f.name
                assert np.array_equal(a, b), f.name
            if g.users.ndim == 2:
                n_stacked += 1
                flat += [{f.name: getattr(g, f.name)[i]
                          for f in dataclasses.fields(g)} for i in range(K)]
            else:
                flat.append({f.name: getattr(g, f.name)
                             for f in dataclasses.fields(g)})
        assert len(flat) == len(singles)
        for g, s in zip(flat, singles):
            for f in dataclasses.fields(s):
                assert np.array_equal(g[f.name], getattr(s, f.name)), f.name
    assert n_stacked > 0


# -------------------------------------------- the K = 3 fit against JAX


def test_two_epoch_fit_with_k3_matches_jax(data, tmp_path, monkeypatch):
    _, pv, port, jax_l = data
    monkeypatch.setattr(jax_steps, "expand_with_negatives", _jax_negatives)
    monkeypatch.setattr(port_steps, "expand_with_negatives",
                        _port_negatives)
    jcfg = small_jax_cfg(**dict(FIT, train_steps_per_call=K),
                         summaries_dir=str(tmp_path / "jax"))
    sizes = _sizes(pv)
    jmodel = jax_model_class("clsr")(cfg=jcfg, n_users=sizes[0],
                                     n_items=sizes[1], n_cates=sizes[2])
    sample = next(jax_l["train"].train_batches(jcfg.batch_size,
                                               np.random.RandomState(0)))
    jt = JaxTrainer(jmodel, jcfg, sample, log=lambda *a: None)
    rng = np.random.RandomState(7)
    jt.state = jt.state.replace(params=perturb(jt.state.params, rng),
                                batch_stats=perturb(jt.state.batch_stats,
                                                    rng))
    cfg = port_cfg(jcfg, summaries_dir=str(tmp_path / "port"))
    model = get_model_class("clsr")(cfg, *sizes, device="cpu")
    weights.from_flax(model, jt.state.params, jt.state.batch_stats)
    pt = Trainer(model, cfg, log=lambda *a: None)
    assert pt.multi_step is not None

    jt.fit(jax_l["train"], jax_l["valid"])
    pt.fit(port["train"], port["valid"])

    got, want = _scalars(tmp_path / "port"), _scalars(tmp_path / "jax")
    assert [r["step"] for r in got] == [r["step"] for r in want]
    n_logged = 0
    for g, w in zip(got, want):
        for key in set(w) - {"step", "time"}:
            if key.startswith("valid/"):
                assert abs(g[key] - w[key]) <= 2e-4 + 1e-9, (g, w)
            else:
                n_logged += 1
                np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                           err_msg=f"{key} at {g['step']}")
    assert n_logged >= 2 * 2 * 3
    for (ep, g), (jep, w) in zip(pt.eval_history, jt.eval_history):
        assert ep == jep and g.keys() == w.keys()
        for k in g:
            assert abs(g[k] - w[k]) <= 2e-4 + 1e-9, (ep, k, g[k], w[k])
    assert len(pt.eval_history) == 2
    assert pt.best_epoch == jt.best_epoch > 0


# ------------------------------------------------ load, then more steps


def _trainer(pv, seed, **kw):
    cfg = load_config(None, **dict(
        dataclasses.asdict(small_jax_cfg(**FIT)), seed=seed,
        train_steps_per_call=K, epochs=1, **kw))
    model = get_model_class("clsr")(cfg, *_sizes(pv), device="cpu")
    return Trainer(model, cfg, log=lambda *a: None)


@pytest.mark.parametrize("opt", ["adam", "lazy_compact"])
def test_load_then_fit_equals_a_fresh_load(data, tmp_path, opt):
    _, pv, port, _ = data
    kw = dict(OPTIMIZERS[opt], model_dir=str(tmp_path / "model"),
              save_model=True)
    first = _trainer(pv, 3, **kw)
    fresh = _trainer(pv, 3, **dict(kw, model_dir=None, save_model=False))
    first.fit(port["train"], port["valid"])
    first.load_latest(str(tmp_path / "model"))
    fresh.load_latest(str(tmp_path / "model"))
    for t in (first, fresh):
        t.cfg = t.cfg.replace(save_model=False)
        t.fit(port["train"], port["valid"])
    a, b = _state_tensors(first.state), _state_tensors(fresh.state)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert first.state.step == fresh.state.step > 0
    assert first.eval_history[-1] == fresh.eval_history[-1]
