"""The port's model zoo (GRU4Rec, A2SVD, DIN, DIEN, SLI-Rec and CLSR's
unfused encoders) against the JAX package's.

Each model at test widths (item 8, cate 4, hidden 12, attention 12,
scorer [8, 4], head [10, 6], L = 7), JAX's init perturbed as
tests/test_torch_common.py does and carried over by `weights.from_flax`,
the same numpy batches on both sides, f32 on the CPU:

  * the eval step against JAX's `make_eval_step_fn(model, cfg,
    allow_pallas=True)` at G = 1 and G = 12 (there JAX's K1 runs in
    interpret mode for DIN, SLI-Rec and CLSR; the port's K1 wrapper,
    'on', computes its plain version on CPU tensors): preds and alpha
    to 1e-5;
  * one dense-Adam train step with injected negatives (need_sample
    False) against JAX's jitted `make_train_step_fn`: loss parts to 1e-4
    relative, every clipped gradient to rtol 1e-4 / atol 1e-6, BN running
    statistics and the updated parameters to 1e-5;
  * one lazyadam step with the compact row engine against JAX's
    `make_train_step`: loss parts, parameters and moments to 1e-5, and
    K5's group (its plain version on the CPU) once with 4 entries (item
    and cate tables: these models hold no user table); JAX's state after
    it carried into a fresh port state by `weights.opt_from_flax`, its
    moments back out by `opt_to_flax` bit for bit;
  * DIN and SLI-Rec with use_pallas_eval_attention / _train_attention
    'on' against 'off' (the wrappers' plain versions on the CPU): eval
    preds, loss parts and gradients to 1e-5;
  * DIN's and DIEN's `ScoringService` against JAX's on the same requests
    (Dice's batch statistics see the padding of a dispatch, in both);
  * two epochs of DIN's `Trainer.fit` against JAX's, with the tolerances
    of tests/test_torch_trainer.py;
  * `from_flax` / `to_flax` round-trip every model's tree; the port's
    yaml copies equal JAX's and load to the same values; the registry
    resolves every name (item 8b's four since its port).
The JAX programs compile once per model (module fixtures).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clsr_tpu
import clsr_tpu.training.steps as jax_steps
from clsr_tpu.config import Config as JaxConfig
from clsr_tpu.config import load_config as jax_load_config
from clsr_tpu.data.vocab import Vocab as JaxVocab
from clsr_tpu.models.registry import get_model_class as jax_model_class
from clsr_tpu.serving import ScoringService as JaxService
from clsr_tpu.training.lazy_adam import make_lazy_optimizer
from clsr_tpu.training.losses import total_loss as jax_total_loss
from clsr_tpu.training.optimizer import build_optimizer as jax_optimizer
from clsr_tpu.training.state import TrainState as JaxTrainState
from clsr_tpu.training.steps import make_eval_step_fn as jax_eval_step_fn
from clsr_tpu.training.steps import make_train_step as jax_make_train_step
from clsr_tpu.training.steps import make_train_step_fn as jax_step_fn
from clsr_tpu.training.trainer import Trainer as JaxTrainer
import clsr_tpu_torch.training.steps as port_steps
from clsr_tpu_torch import weights
from clsr_tpu_torch.config import CONFIG_DIR, load_config
from clsr_tpu_torch.data.vocab import Vocab
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.ops import row_update as ru
from clsr_tpu_torch.serving import ScoringService
from clsr_tpu_torch.training.state import create_train_state
from clsr_tpu_torch.training.steps import (make_eval_step_fn,
                                           make_train_step,
                                           make_train_step_fn)
from clsr_tpu_torch.training.trainer import Trainer

from test_torch_common import (TOL, jax_batch, jax_state, numpy_batch,
                               perturb, port_batch, port_cfg, to_np)
from test_torch_lazy_adam import (_assert_step_matches, _dense_adam_moments,
                                  _moments)
from test_torch_serving import (N_CATES as S_CATES, N_ITEMS as S_ITEMS,
                                N_USERS as S_USERS, _MAPS, _requests)
from test_torch_trainer import (FIT, _jax_negatives, _port_negatives,
                                _scalars, _sizes, data)

N_USERS, N_ITEMS, N_CATES = 9, 23, 5
L = 7
WIDTHS = dict(user_vocab="u", item_vocab="i", cate_vocab="c",
              max_seq_length=L, hidden_size=12, item_embedding_dim=8,
              cate_embedding_dim=4, user_embedding_dim=12, attention_size=12,
              layer_sizes=(10, 6), activation=("relu",),
              att_fcn_layer_sizes=(8, 4), seed=3)
# the train steps' settings (tests/test_torch_train.py), dropout off
STEP = dict(need_sample=False, train_num_ngs=4, embed_l2=1e-4,
            layer_l2=1e-4, contrastive_length_threshold=2,
            max_grad_norm=0.5)

# case -> (model name, config overrides)
CASES = {
    "gru4rec": ("gru4rec", {}),
    "a2svd": ("a2svd", dict(user_dropout=True, dropout=(0.0, 0.0))),
    "din": ("din", {}),
    "dien": ("dien", dict(activation=("dice", "dice"))),
    "sli_rec": ("sli_rec", {}),
    "clsr_time4lstm": ("clsr", dict(use_fused_encoders=False)),
    "clsr_gru_no_evolve_no_causal2": ("clsr", dict(
        sequential_model="gru", interest_evolve=False,
        predict_long_short=False)),
    "clsr_lstm_no_causal2": ("clsr", dict(sequential_model="lstm",
                                          predict_long_short=False)),
}
LAZY_CASES = ("gru4rec", "a2svd", "din", "dien", "sli_rec")


def zoo_cfg(case, **overrides) -> JaxConfig:
    name, kw = CASES[case]
    return JaxConfig(**dict(WIDTHS, model_type=name, **STEP,
                            **dict(kw, **overrides))).validate()


def jax_zoo(case, **overrides):
    """(config, model, perturbed params, perturbed batch_stats) of the
    JAX model of `case`, with config overrides that keep its tree."""
    jcfg = zoo_cfg(case, **overrides)
    model = jax_model_class(jcfg.model_type)(
        cfg=jcfg, n_users=N_USERS, n_items=N_ITEMS, n_cates=N_CATES)
    return (jcfg, model) + _variables(case)


@functools.lru_cache(maxsize=None)
def _variables(case):
    """JAX's init of `case`, perturbed; computed once a module."""
    jcfg = zoo_cfg(case)
    model = jax_model_class(jcfg.model_type)(
        cfg=jcfg, n_users=N_USERS, n_items=N_ITEMS, n_cates=N_CATES)
    sample = jax_batch(numpy_batch(np.random.RandomState(0), 2, 8, L))
    variables = jax.jit(model.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        sample, train=True)
    rng = np.random.RandomState(7)
    return (perturb(variables["params"], rng),
            perturb(variables.get("batch_stats", {}), rng))


def port_model(jcfg, params, stats, sizes=(N_USERS, N_ITEMS, N_CATES),
               **overrides):
    cfg = port_cfg(jcfg, **overrides)
    model = get_model_class(cfg.model_type)(cfg, *sizes, device="cpu")
    weights.from_flax(model, params, stats)
    return cfg, model


@pytest.fixture(scope="module", params=sorted(CASES))
def jax_side(request):
    return (request.param,) + jax_zoo(request.param)


def _batch(seed, G):
    b = numpy_batch(np.random.RandomState(seed), 4, G, L,
                    lengths=[1, L, 3, 5])
    b["labels"][:, 0] = 1.0
    return b


# ------------------------------------------------------------- eval step


@pytest.mark.parametrize("G", [1, 12])
def test_eval_step_matches_jax(jax_side, G):
    case, jcfg, model, params, stats = jax_side
    b = _batch(G, G)
    want_p, want_a = jax_eval_step_fn(model, jcfg, allow_pallas=True)(
        jax_state(model, params, stats), jax_batch(b))
    cfg, pmodel = port_model(jcfg, params, stats,
                             use_pallas_eval_attention="on")
    got_p, got_a = make_eval_step_fn(cfg)(pmodel, port_batch(b))
    assert got_p.shape == (4, G)
    np.testing.assert_allclose(to_np(got_p), np.asarray(want_p), **TOL)
    np.testing.assert_allclose(to_np(got_a), np.asarray(want_a), **TOL)


def test_weights_round_trip(jax_side):
    _, jcfg, _, params, stats = jax_side
    _, pmodel = port_model(jcfg, params, stats)
    got_p, got_s = weights.to_flax(pmodel)
    for got, want in ((got_p, params), (got_s, stats)):
        got, want = weights.flatten_tree(got), weights.flatten_tree(want)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


# ------------------------------------------------------ dense train step


@pytest.fixture(scope="module")
def dense_step(jax_side):
    """JAX's dense-Adam step on one batch, and its unclipped gradients,
    in one jitted program (the two share their forward and backward)."""
    case, jcfg, model, params, stats = jax_side
    batch = jax_batch(_batch(20, 5))
    rng = jax.random.PRNGKey(0)
    state = JaxTrainState.create(apply_fn=model.apply, params=params,
                                 batch_stats=stats, tx=jax_optimizer(jcfg))
    step = jax_step_fn(model, jcfg, allow_pallas=False)

    def loss_fn(p):
        (logits, aux), _ = model.apply(
            {"params": p, "batch_stats": stats}, batch, train=True,
            rngs={"dropout": jax.random.split(rng)[1]},
            mutable=["batch_stats"])
        return jax_total_loss(jcfg, logits, aux, batch, p).loss

    (want_state, want_parts), grads = jax.jit(
        lambda s: (step(s, batch, rng), jax.grad(loss_fn)(s.params)))(state)
    return want_state, want_parts, weights.flatten_tree(grads)


def test_dense_train_step_matches_jax(jax_side, dense_step):
    case, jcfg, model, params, stats = jax_side
    want_state, want_parts, want_grads = dense_step
    cfg, pmodel = port_model(jcfg, params, stats)
    pstate = create_train_state(pmodel, cfg)
    pstate, parts = make_train_step_fn(pmodel, cfg, allow_pallas=False)(
        pstate, port_batch(_batch(20, 5)), torch.Generator().manual_seed(0))
    for field in dataclasses.fields(parts):
        np.testing.assert_allclose(
            to_np(getattr(parts, field.name)),
            np.asarray(getattr(want_parts, field.name)), rtol=1e-4,
            atol=1e-7, err_msg=field.name)
    params_by_name = dict(pmodel.named_parameters())
    for name, (coll, flax, transpose) in weights.flax_names(pmodel).items():
        if coll != "params":
            continue
        g = np.asarray(want_grads[flax])
        norm = np.sqrt(np.sum(g * g))
        if norm > jcfg.max_grad_norm:
            g = g * (jcfg.max_grad_norm / norm)
        got = params_by_name[name].grad
        np.testing.assert_allclose(to_np(got.t() if transpose else got), g,
                                   rtol=1e-4, atol=1e-6, err_msg=flax)
    got_p, got_s = weights.to_flax(pmodel)
    for got, want in ((got_p, want_state.params),
                      (got_s, want_state.batch_stats)):
        got, want = weights.flatten_tree(got), weights.flatten_tree(want)
        assert set(got) == set(want)
        for k, v in got.items():
            np.testing.assert_allclose(v, np.asarray(want[k]), **TOL,
                                       err_msg=k)


# --------------------------------------------------- lazyadam, compact


@pytest.mark.parametrize("case", LAZY_CASES)
def test_lazy_compact_step_matches_jax(case, monkeypatch):
    jcfg, model, params, stats = jax_zoo(case, optimizer="lazyadam")
    init_fn, _ = make_lazy_optimizer(jcfg)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), apply_fn=model.apply,
                          params=params, tx=None, opt_state=init_fn(params),
                          batch_stats=stats)
    b = _batch(30, 5)
    want_state, want_parts = jax_make_train_step(model, jcfg, donate=False)(
        state, jax_batch(b), jax.random.PRNGKey(0))
    calls = []   # K5's plain version runs where the kernel would launch
    plain = ru.scatter_rows_group_reference
    monkeypatch.setattr(ru, "scatter_rows_group_reference",
                        lambda entries: calls.append(len(entries))
                        or plain(entries))
    cfg, pmodel = port_model(jcfg, params, stats)
    pstate = create_train_state(pmodel, cfg)
    pstate, parts = make_train_step(pmodel, cfg)(
        pstate, port_batch(b), torch.Generator().manual_seed(0))
    n_tables = 4 if case.startswith("clsr") else 2
    assert calls == [2 * n_tables]
    _assert_step_matches(want_state, want_parts, pstate, parts)
    # JAX's state after the step carries into a fresh port state
    _, fresh = port_model(jcfg, want_state.params, want_state.batch_stats)
    fstate = create_train_state(fresh, cfg)
    weights.opt_from_flax(fstate, _moments(want_state),
                          int(want_state.opt_state.count),
                          *_dense_adam_moments(want_state))
    moments, count = weights.opt_to_flax(fstate)
    assert count == 1
    for k, v in weights.flatten_tree(moments).items():
        np.testing.assert_array_equal(v, _moments(want_state)[k])


# ----------------------------------------------- the kernel gates, on/off


@pytest.mark.parametrize("case", ["din", "sli_rec"])
def test_kernel_gates_on_and_off_agree(case):
    jcfg, _, params, stats = jax_zoo(case)
    b = _batch(40, 12)
    runs = {}
    for gate in ("on", "off"):
        cfg, pmodel = port_model(jcfg, params, stats,
                                 use_pallas_eval_attention=gate,
                                 use_pallas_train_attention=gate)
        preds, alpha = make_eval_step_fn(cfg)(pmodel, port_batch(b))
        state = create_train_state(pmodel, cfg)
        _, parts = make_train_step_fn(pmodel, cfg)(
            state, port_batch(_batch(41, 5)),
            torch.Generator().manual_seed(0))
        grads = {n: p.grad.clone() for n, p in pmodel.named_parameters()
                 if p.grad is not None}
        runs[gate] = (preds, alpha, parts, grads)
    (p1, a1, l1, g1), (p0, a0, l0, g0) = runs["on"], runs["off"]
    torch.testing.assert_close(p1, p0, **TOL)
    torch.testing.assert_close(a1, a0, **TOL)
    for field in dataclasses.fields(l1):
        torch.testing.assert_close(getattr(l1, field.name),
                                   getattr(l0, field.name), **TOL)
    assert g1.keys() == g0.keys()
    for k in g1:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-4, atol=1e-6,
                                   msg=k)


# --------------------------------------------------------------- serving


@pytest.mark.parametrize("case", ["din", "dien"])
def test_serving_matches_jax_service(case):
    jcfg = zoo_cfg(case, seed=11)
    kw = dict(batch_buckets=(2, 4), cand_buckets=(8, 16))
    jsvc = JaxService(jcfg, S_USERS, S_ITEMS, S_CATES,
                      *(JaxVocab(m) for m in _MAPS), **kw)
    rng = np.random.RandomState(0)
    params = perturb(jsvc.state.params, rng)
    stats = perturb(jsvc.state.batch_stats, rng)
    jsvc.state = jsvc.state.replace(params=params, batch_stats=stats)
    psvc = ScoringService(port_cfg(jcfg), S_USERS, S_ITEMS, S_CATES,
                          *(Vocab(m) for m in _MAPS), device="cpu", **kw)
    weights.from_flax(psvc.model, params, stats)
    # both buckets, histories longer than L, a spill into a second
    # dispatch: the padded rows and candidates enter Dice's statistics
    spec = [(3, 5), (12, 9), (1, 16), (7, 8), (2, 1), (9, 12), (4, 3)]
    jreqs, preqs = _requests(5, spec)
    want, got = jsvc.score(jreqs), psvc.score(preqs)
    assert [len(s) for s in got] == [c for _, c in spec]
    for g, w in zip(got, want):
        assert np.isfinite(g).all() and (g >= 0).all() and (g <= 1).all()
        np.testing.assert_allclose(g, w, **TOL)


# ------------------------------------------------- DIN's two-epoch fit


def test_din_fit_matches_jax(data, tmp_path, monkeypatch):
    _, pv, port, jax_l = data
    monkeypatch.setattr(jax_steps, "expand_with_negatives", _jax_negatives)
    monkeypatch.setattr(port_steps, "expand_with_negatives",
                        _port_negatives)
    jcfg = JaxConfig(**dict(WIDTHS, model_type="din", **FIT,
                            summaries_dir=str(tmp_path / "jax"))).validate()
    sizes = _sizes(pv)
    jmodel = jax_model_class("din")(cfg=jcfg, n_users=sizes[0],
                                    n_items=sizes[1], n_cates=sizes[2])
    sample = next(jax_l["train"].train_batches(jcfg.batch_size,
                                               np.random.RandomState(0)))
    jt = JaxTrainer(jmodel, jcfg, sample, log=lambda *a: None)
    rng = np.random.RandomState(7)
    jt.state = jt.state.replace(params=perturb(jt.state.params, rng),
                                batch_stats=perturb(jt.state.batch_stats,
                                                    rng))
    cfg, model = port_model(jcfg, jt.state.params, jt.state.batch_stats,
                            sizes=sizes, summaries_dir=str(tmp_path / "port"))
    pt = Trainer(model, cfg, log=lambda *a: None)
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
    assert n_logged >= 2 * 2 * 5
    assert len(pt.eval_history) == len(jt.eval_history) == 2
    for (ep, g), (jep, w) in zip(pt.eval_history, jt.eval_history):
        assert ep == jep and g.keys() == w.keys()
        for k in g:
            assert abs(g[k] - w[k]) <= 2e-4 + 1e-9, (ep, k, g[k], w[k])
    assert pt.best_epoch == jt.best_epoch > 0


# ------------------------------------------------------ configs, registry


@pytest.mark.parametrize("yaml", ["gru4rec", "asvd", "din", "dien",
                                  "sli_rec"])
def test_zoo_yaml_loads_like_jax(yaml):
    """The port's copy of each yaml is JAX's, and loads to the same value
    of every field the port keeps; a missing required key raises in
    both."""
    port_path = os.path.join(CONFIG_DIR, f"{yaml}.yaml")
    jax_path = os.path.join(os.path.dirname(clsr_tpu.__file__), "configs",
                            f"{yaml}.yaml")
    assert open(port_path).read() == open(jax_path).read()
    vocabs = dict(user_vocab="u", item_vocab="i", cate_vocab="c", seed=4)
    port = load_config(port_path, **vocabs)
    want = dataclasses.asdict(jax_load_config(jax_path, **vocabs))
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == want[f.name], f.name
    with pytest.raises(ValueError, match="item_embedding_dim"):
        load_config(port_path, **dict(vocabs, item_embedding_dim=None))
    with pytest.raises(ValueError, match="item_embedding_dim"):
        jax_load_config(jax_path, **dict(vocabs, item_embedding_dim=None))


# -------------------------------------------------------------- registry


def test_registry_names_and_refusals():
    for name, cls in (("GRU4REC", "GRU4RecModel"), ("a2svd", "A2SVDModel"),
                      ("asvd", "A2SVDModel"), ("DIN", "DINModel"),
                      ("DIEN", "DIENModel"), ("sli_rec", "SLIRecModel"),
                      ("SLIREC", "SLIRecModel"), ("CLSR", "CLSRModel")):
        assert get_model_class(name).__name__ == cls
    # item 8b's four resolve (tests/test_torch_zoo_rest.py); every name of
    # the JAX registry does, and an unknown one raises
    for name, cls in (("CASER", "CaserModel"), ("ncf", "NCFModel"),
                      ("NextItNet", "NextItNetModel"), ("lgn", "LGNModel")):
        assert get_model_class(name).__name__ == cls
    with pytest.raises(ValueError, match="Unknown model"):
        get_model_class("nope")
