"""The port's optimizers against the JAX package's `build_optimizer`.

Same numpy inputs on both sides, JAX on the CPU:

  * each rule (adadelta, adagrad, sgd, gd, pgd, rmsprop, ftrl, padagrad)
    and the fallback of an unknown name (sgd), with per-tensor clipping
    ahead of it, over 3 steps on a small parameter tree whose gradients
    the clip cuts: `clip_by_norm_each` + the port's optimizer against
    JAX's chain of `clip_by_norm_each` and `optax.flatten(rule)`,
    parameters and state within 1e-6 abs;
  * two whole CLSR train steps with each rule (negatives injected,
    need_sample False) against JAX's jitted `make_train_step_fn`: loss
    parts and parameters within 1e-5.  One exception, rmsprop on the
    biases whose gradient is zero up to rounding (a dense bias under
    train-mode BN): its first update is g / sqrt(0.1 g^2 + 1e-8), which
    turns rounding noise of ~1e-7 in g into ~1e-3 in the update, in both
    frameworks; those are held to lr * 1e-2;
  * a checkpoint of a dense rule's state round-trips bit for bit, and a
    checkpoint of one rule refuses to load into another.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from clsr_tpu.training.optimizer import build_optimizer as jax_optimizer
from clsr_tpu.training.state import TrainState as JaxTrainState
from clsr_tpu.training.steps import make_train_step_fn as jax_step_fn
from clsr_tpu_torch import weights
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.training import checkpoint
from clsr_tpu_torch.training.optimizer import (DenseRule, build_optimizer,
                                               clip_by_norm_each)
from clsr_tpu_torch.training.state import create_train_state
from clsr_tpu_torch.training.steps import make_train_step_fn

from test_torch_common import (N_CATES, N_ITEMS, N_USERS, TOL, jax_batch,
                               jax_clsr, numpy_batch, port_batch, port_cfg,
                               small_jax_cfg, to_np)

# the seven other rules, gd (sgd's alias) and a name JAX runs as sgd
RULES = ("adadelta", "adagrad", "sgd", "pgd", "rmsprop", "ftrl", "padagrad",
         "gd", "momentum")
SHAPES = {"a": (5, 3), "b": (7,), "c": (2, 2, 3)}
MAX_NORM = 0.5


def _grads(rng):
    # scale 2: most tensors' norms pass MAX_NORM, so the clip cuts them
    return {k: (rng.randn(*s) * 2.0).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("name", RULES)
def test_rule_matches_jax_build_optimizer(name):
    rng = np.random.RandomState(0)
    w0 = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [_grads(rng) for _ in range(3)]
    jcfg = small_jax_cfg(optimizer=name, learning_rate=0.05,
                         max_grad_norm=MAX_NORM)
    assert jcfg.is_clip_norm
    tx = jax_optimizer(jcfg)
    params = {k: jnp.asarray(v) for k, v in w0.items()}
    state = tx.init(params)
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in w0.items()}
    opt = build_optimizer(port_cfg(jcfg), ps.values())
    assert isinstance(opt, DenseRule)
    assert opt.rule == {"gd": "sgd", "momentum": "sgd"}.get(name, name)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, params)
        params = optax.apply_updates(params, updates)
        for k, p in ps.items():
            p.grad = torch.from_numpy(g[k].copy())
        clip_by_norm_each([p.grad for p in ps.values()], MAX_NORM)
        opt.step()
        for k, p in ps.items():
            np.testing.assert_allclose(to_np(p), np.asarray(params[k]),
                                       rtol=0, atol=1e-6, err_msg=k)
    # the state: optax's flattened vectors, in the tree's key order
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(state)
            if np.asarray(x).size == sum(np.prod(s) for s in SHAPES.values())]
    got = opt.state_dict()["state"]
    keys = sorted({k for st in got.values() for k in st})
    assert len(want) == len(keys), (keys, len(want))
    for key in keys:
        flat = np.concatenate([to_np(got[i][key]).ravel()
                               for i in range(len(SHAPES))])
        assert any(np.allclose(flat, w, rtol=0, atol=1e-6) for w in want), key


_STEP_CFG = dict(need_sample=False, train_num_ngs=4, embed_l2=1e-4,
                 layer_l2=1e-4, contrastive_length_threshold=2,
                 max_grad_norm=0.5, learning_rate=0.01)


def _batches():
    out = []
    for seed, lengths in ((10, [7, 3, 5, 1]), (11, [2, 7, 6, 4])):
        b = numpy_batch(np.random.RandomState(seed), 4, 5, 7,
                        lengths=lengths)
        b["labels"][:, 0] = 1.0
        out.append(b)
    return out


def _zero_by_construction(flax_name):
    """A dense bias under train-mode BN: its gradient is zero up to
    rounding."""
    return "/w_nn_layer" in flax_name and flax_name.endswith("/bias")


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


@pytest.fixture(scope="module")
def jax_model():
    jcfg = small_jax_cfg(**_STEP_CFG)
    return (jcfg,) + jax_clsr(jcfg)


# the seven rules (gd and the fallback are sgd's train step)
@pytest.mark.parametrize("name", RULES[:7])
def test_two_train_steps_match_jax(jax_model, name):
    jcfg, model, params, stats = jax_model
    jcfg = jcfg.replace(optimizer=name)
    state = JaxTrainState.create(apply_fn=model.apply, params=params,
                                 batch_stats=stats, tx=jax_optimizer(jcfg))
    jstep = jax.jit(jax_step_fn(model, jcfg, allow_pallas=False))
    cfg = port_cfg(jcfg)
    pm = get_model_class("clsr")(cfg, N_USERS, N_ITEMS, N_CATES,
                                 device="cpu")
    weights.from_flax(pm, params, stats)
    pstate = create_train_state(pm, cfg)
    pstep = make_train_step_fn(pm, cfg, allow_pallas=False)
    for i, b in enumerate(_batches()):
        state, want = jstep(state, jax_batch(b), jax.random.PRNGKey(i))
        pstate, got = pstep(pstate, port_batch(b),
                            torch.Generator().manual_seed(i))
        for field in dataclasses.fields(got):
            np.testing.assert_allclose(
                to_np(getattr(got, field.name)),
                np.asarray(getattr(want, field.name)), **TOL,
                err_msg=f"step {i} {field.name}")
        got_params, _ = weights.to_flax(pm)
        want_params = _flat(state.params)
        for k, v in _flat(got_params).items():
            tol = (dict(rtol=0, atol=jcfg.learning_rate * 1e-2)
                   if name == "rmsprop" and _zero_by_construction(k)
                   else TOL)
            np.testing.assert_allclose(v, want_params[k], **tol,
                                       err_msg=f"step {i} {k}")
    assert pstate.step == 2


def test_dense_rule_checkpoint_round_trips(jax_model, tmp_path):
    jcfg, _, params, stats = jax_model
    cfg = port_cfg(jcfg, optimizer="ftrl")
    runs = []
    for _ in range(2):
        pm = get_model_class("clsr")(cfg, N_USERS, N_ITEMS, N_CATES,
                                     device="cpu")
        weights.from_flax(pm, params, stats)
        runs.append((pm, create_train_state(pm, cfg)))
    (pm, state), (other_model, other) = runs
    make_train_step_fn(pm, cfg, allow_pallas=False)(
        state, port_batch(_batches()[0]), torch.Generator().manual_seed(0))
    checkpoint.save_state(str(tmp_path), state)
    checkpoint.load_state(str(tmp_path), other)
    want, got = state.optimizer.state_dict(), other.optimizer.state_dict()
    assert want["state"].keys() == got["state"].keys() and want["state"]
    for i, st in want["state"].items():
        assert st.keys() == got["state"][i].keys() == {"z", "n"}
        for k, v in st.items():
            assert torch.equal(v, got["state"][i][k]), (i, k)
    for k, v in pm.state_dict().items():
        assert torch.equal(v, other_model.state_dict()[k]), k
    assert other.step == 1
    wrong = create_train_state(other_model, cfg.replace(optimizer="adagrad"))
    with pytest.raises(ValueError, match="ftrl"):
        checkpoint.load_state(str(tmp_path), wrong)
