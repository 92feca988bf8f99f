"""The port's LazyAdam and compact row engine against the JAX package's.

Same numpy inputs and the same flax weights on both sides, JAX on the CPU:

  * the compact plan's bookkeeping equals JAX's `build_plan` exactly
    (sorted ids, runs, first occurrences, per-site positions, the
    permutation and its inverse);
  * `permuted_rows` gives the per-site lookups bit for bit, and its
    gather backward equals the per-site scatter-add formulation bit for
    bit (mirrors tests/test_compact_rows.py:84-122);
  * one CLSR train step with `optimizer: lazyadam`, compact rows `auto`
    (pmn param|mu|nu layout) and `off` (legacy, split mu|nu layout),
    against JAX's jitted `make_train_step` on the same parameters and
    batch (negatives injected, need_sample False): loss parts,
    parameters (`weights.to_flax`), moments (`weights.opt_to_flax`, in
    JAX's layout) to 1e-5, and the count; then a second step from JAX's
    state after the first, carried across by `weights.from_flax` and
    `weights.opt_from_flax` (t = 2 bias correction, stale moments);
  * rows no batch touched stay bit-identical; on the compact path no
    table Parameter gets a gradient; the K5 group's plain version runs
    where K5 would launch, once per step with 8 scatter-sets (each
    table's param rows and its optimizer rows), compact and legacy; the
    compact step leaves the table Parameters equal to pmn[:, :D] bit for
    bit without a sync;
  * lazy and dense Adam part where they should: a row touched by the
    first batch and not by the second stays put under lazyadam and moves
    under dense Adam (its stale moment), while a row first touched by
    the second batch takes the same step under both;
  * a split-layout state under compact rows `auto` (the engine's split
    branch) gives the legacy step's parameters and moments;
  * `sync_params_from_opt`, for callers that load optimizer rows, copies
    the pmn param column into the tables and leaves split layouts alone;
  * with a bf16 table the pmn param lane gets the rows rounded to bf16,
    equal to the table's (legacy and compact row updates called alone).

The JAX step compiles once per compact mode (module fixtures).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from clsr_tpu.training.compact_rows import build_plan as jax_build_plan
from clsr_tpu.training.lazy_adam import make_lazy_optimizer
from clsr_tpu.training.state import TrainState as JaxTrainState
from clsr_tpu.training.steps import make_train_step as jax_make_train_step
from clsr_tpu_torch import weights
from clsr_tpu_torch.config import load_config
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.ops import row_update as ru
from clsr_tpu_torch.training import compact_rows as cr
from clsr_tpu_torch.training.lazy_adam import LazyAdam
from clsr_tpu_torch.training.state import create_train_state
from clsr_tpu_torch.training.steps import (make_train_step,
                                           sync_params_from_opt)

from test_torch_common import (N_CATES, N_ITEMS, N_USERS, TOL, jax_batch,
                               jax_clsr, numpy_batch, port_batch, port_cfg,
                               small_jax_cfg, to_np)

_STEP_CFG = dict(need_sample=False, train_num_ngs=4, embed_l2=1e-4,
                 layer_l2=1e-4, contrastive_length_threshold=2,
                 max_grad_norm=0.5, optimizer="lazyadam")
MODES = ("auto", "off")
TABLES = ("item_embedding", "cate_embedding", "user_long_embedding",
          "user_short_embedding")


def _batches():
    """Two batches of B = 4, G = 5, L = 7.  The first touches items
    0..11 and users 0..3 only; the second users 4..7 (user 8 never)."""
    b1 = numpy_batch(np.random.RandomState(10), 4, 5, 7, lengths=[7, 3, 5, 1],
                     n_items=12)
    b2 = numpy_batch(np.random.RandomState(11), 4, 5, 7, lengths=[2, 7, 6, 4])
    for b, users in ((b1, [0, 1, 2, 3]), (b2, [4, 5, 6, 7])):
        b["labels"][:, 0] = 1.0
        b["users"] = np.array(users, np.int32)
    return b1, b2


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


def _moments(jax_state):
    return {"/".join(k): np.asarray(v)
            for k, v in jax_state.opt_state.moments.items()}


def _dense_adam_moments(jax_state):
    """JAX's flattened dense Adam (mu, nu), split back per parameter in
    the order optax.flatten ravels them, keyed by flax name."""
    adam = [s for s in jax.tree_util.tree_leaves(
        jax_state.opt_state.dense_opt,
        is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    dense = {k: v for k, v in flatten_dict(jax_state.params).items()
             if not str(k[-1]).endswith("_embedding")}
    out = ({}, {})
    off = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(dense)[0]:
        n = leaf.size
        name = "/".join(path[0].key)
        for tree, flat in zip(out, (adam.mu, adam.nu)):
            tree[name] = np.asarray(flat[off:off + n]).reshape(leaf.shape)
        off += n
    return out


@pytest.fixture(scope="module", params=MODES)
def jax_run(request):
    """JAX's lazyadam steps on the two batches, and its start."""
    jcfg = small_jax_cfg(compact_rows=request.param, **_STEP_CFG)
    model, params, stats = jax_clsr(jcfg)
    init_fn, _ = make_lazy_optimizer(jcfg)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), apply_fn=model.apply,
                          params=params, tx=None, opt_state=init_fn(params),
                          batch_stats=stats)
    step = jax_make_train_step(model, jcfg, donate=False)
    states, parts = [], []
    for i, b in enumerate(_batches()):
        state, p = step(state, jax_batch(b), jax.random.PRNGKey(i))
        states.append(state)
        parts.append(p)
    return request.param, jcfg, params, stats, states, parts


def _port(jcfg, params, stats, **kw):
    cfg = port_cfg(jcfg, **kw)
    model = get_model_class("clsr")(cfg, N_USERS, N_ITEMS, N_CATES,
                                    device="cpu")
    weights.from_flax(model, params, stats)
    return model, create_train_state(model, cfg), make_train_step(model, cfg)


def _step(state, step, b, seed):
    return step(state, port_batch(b), torch.Generator().manual_seed(seed))


def _assert_step_matches(jax_state, jax_parts, state, parts):
    for field in dataclasses.fields(parts):
        np.testing.assert_allclose(to_np(getattr(parts, field.name)),
                                   np.asarray(getattr(jax_parts, field.name)),
                                   **TOL, err_msg=field.name)
    got_params, got_stats = weights.to_flax(state.model)
    want = _flat(jax_state.params)
    assert set(_flat(got_params)) == set(want)
    for k, v in _flat(got_params).items():
        np.testing.assert_allclose(v, want[k], **TOL, err_msg=k)
    want_stats = _flat(jax_state.batch_stats)
    for k, v in _flat(got_stats).items():
        np.testing.assert_allclose(v, want_stats[k], **TOL, err_msg=k)
    moments, count = weights.opt_to_flax(state)
    want_m = _moments(jax_state)
    assert set(_flat(moments)) == set(want_m)
    for k, v in _flat(moments).items():
        assert v.shape == want_m[k].shape, k
        np.testing.assert_allclose(v, want_m[k], **TOL, err_msg=k)
    assert count == int(jax_state.opt_state.count) == state.step


# ------------------------------------------------------------- the plan


def test_plan_matches_jax_build_plan():
    rng = np.random.RandomState(0)
    sites = {"hist": rng.randint(0, 12, (4, 5)).astype(np.int32),
             "targets": rng.randint(0, 12, (4, 2)).astype(np.int32)}
    want = jax_build_plan({k: jnp.asarray(v) for k, v in sites.items()})
    got = cr.build_plan({k: torch.from_numpy(v) for k, v in sites.items()})
    for field in ("sorted_ids", "seg", "first", "idx_first", "perm", "inv"):
        w = np.asarray(getattr(want, field))
        g = to_np(getattr(got, field))
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    for s in sites:
        np.testing.assert_array_equal(to_np(got.pos[s]),
                                      np.asarray(want.pos[s]), err_msg=s)
    assert got.site_slices == want.site_slices


def test_permuted_rows_values_and_gather_backward():
    rng = np.random.RandomState(1)
    sites = {"hist": torch.from_numpy(rng.randint(0, 9, (3, 4)).astype(
        np.int32)), "targets": torch.from_numpy(rng.randint(0, 9, (3, 2))
                                                .astype(np.int32))}
    plan = cr.build_plan(sites)
    M = plan.sorted_ids.shape[0]
    w0 = torch.from_numpy(rng.randn(M, 5).astype(np.float32))

    def grad_through_sites(use_rows):
        w = w0.clone().requires_grad_()
        c = cr.CompactRows(w=w, plan=plan, rows=cr.permuted_rows(
            w, plan.inv, plan.perm) if use_rows else None)
        (torch.sin(c.site("hist")).sum() * 0.7
         + (c.site("targets") ** 2).sum()).backward()
        return c, w.grad

    (c_new, g_new), (c_old, g_old) = (grad_through_sites(True),
                                      grad_through_sites(False))
    for s, ids in sites.items():
        assert torch.equal(c_new.site(s), c_old.site(s))
        assert torch.equal(c_new.site(s), w0[plan.pos[s].long()])
        assert torch.equal(plan.sorted_ids[plan.pos[s].long()], ids)
    assert torch.equal(g_new, g_old)
    w = w0.clone().requires_grad_()
    g = torch.from_numpy(rng.randn(M, 5).astype(np.float32))
    (cr.permuted_rows(w, plan.inv, plan.perm) * g).sum().backward()
    assert torch.equal(w.grad, g[plan.perm.long()])


# ------------------------------------------------------------ the steps


def test_lazy_step_matches_jax(jax_run, monkeypatch):
    mode, jcfg, params, stats, states, parts = jax_run
    calls = []   # K5's plain version runs where the kernel would launch
    plain = ru.scatter_rows_group_reference
    monkeypatch.setattr(ru, "scatter_rows_group_reference",
                        lambda entries: calls.append(len(entries))
                        or plain(entries))
    _, state, step = _port(jcfg, params, stats)
    layout = {"auto": 3, "off": 2}[mode]
    for name, mn in state.optimizer.moments.items():
        assert mn.shape[1] == layout * dict(
            state.model.named_parameters())[name].shape[1]
    state, got = _step(state, step, _batches()[0], 0)
    # one group a step: each table's param rows and its optimizer rows
    assert calls == [2 * len(TABLES)]
    _assert_step_matches(states[0], parts[0], state, got)
    if mode == "auto":
        assert all(p.grad is None for n, p in state.model.named_parameters()
                   if n in TABLES)
        # the update wrote the table Parameters: pmn[:, :D], no sync
        for name in TABLES:
            p = dict(state.model.named_parameters())[name]
            assert torch.equal(p, state.optimizer.moments[name][
                :, :p.shape[1]])


def test_lazy_second_step_from_jax_state_matches_jax(jax_run):
    _, jcfg, _, _, states, parts = jax_run
    after1 = states[0]
    _, state, step = _port(jcfg, after1.params, after1.batch_stats)
    mu, nu = _dense_adam_moments(after1)
    weights.opt_from_flax(state, _moments(after1),
                          int(after1.opt_state.count), mu, nu)
    assert state.step == state.optimizer.count == 1
    state, got = _step(state, step, _batches()[1], 1)
    _assert_step_matches(states[1], parts[1], state, got)


@pytest.mark.parametrize("mode", MODES)
def test_untouched_rows_unchanged(mode):
    jcfg = small_jax_cfg(compact_rows=mode, **_STEP_CFG)
    _, params, stats = jax_clsr(jcfg)
    model, state, step = _port(jcfg, params, stats)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    moments = {n: m.clone() for n, m in state.optimizer.moments.items()}
    state, _ = _step(state, step, _batches()[0], 0)
    after = dict(model.named_parameters())
    # batch 1 touches items 0..11 and users 0..3 only
    for name, untouched in (("item_embedding", slice(12, None)),
                            ("user_long_embedding", slice(4, None)),
                            ("user_short_embedding", slice(4, None))):
        assert torch.equal(after[name][untouched], before[name][untouched])
        assert torch.equal(state.optimizer.moments[name][untouched],
                           moments[name][untouched])
        assert not torch.equal(after[name][:4], before[name][:4])


def test_lazy_and_dense_adam_part_on_stale_rows():
    """User rows 0..3 are touched by batch 1 only, 4..7 by batch 2 only."""
    jcfg = small_jax_cfg(compact_rows="auto", **_STEP_CFG)
    _, params, stats = jax_clsr(jcfg)
    runs = {}
    for name, kw in (("lazy", {}), ("dense", dict(optimizer="adam"))):
        model, state, step = _port(jcfg, params, stats, **kw)
        tables = []
        for i, b in enumerate(_batches()):
            state, _ = _step(state, step, b, i)
            tables.append(model.user_long_embedding.detach().clone())
        runs[name] = tables
    (lazy1, lazy2), (dense1, dense2) = runs["lazy"], runs["dense"]
    stale, fresh = slice(0, 4), slice(4, 8)
    # the same step on touched rows (torch.optim.Adam rounds its bias
    # correction in another order, so to 1e-5, not bit for bit)
    np.testing.assert_allclose(to_np(lazy1[stale]), to_np(dense1[stale]),
                               **TOL)
    np.testing.assert_allclose(to_np(lazy2[fresh]), to_np(dense2[fresh]),
                               **TOL)
    assert torch.equal(lazy2[stale], lazy1[stale])       # lazy: untouched
    moved = (dense2[stale] - dense1[stale]).abs()        # dense: momentum
    assert moved.min() > 0.1 * jcfg.learning_rate, moved.min()


def test_compact_step_on_split_moments_matches_legacy():
    """A split mu|nu state (say, one carried over from a legacy run)
    under compact rows `auto`: the compact engine's split branch (one
    moment gather, K5 into the table and into the moments) gives the
    legacy step's parameters and moments."""
    jcfg = small_jax_cfg(compact_rows="off", **_STEP_CFG)
    _, params, stats = jax_clsr(jcfg)
    runs = {}
    for mode in MODES:
        model, state, _ = _port(jcfg, params, stats)      # split moments
        step = make_train_step(model, port_cfg(jcfg, compact_rows=mode))
        state, parts = _step(state, step, _batches()[0], 0)
        if mode == "auto":
            assert all(p.grad is None for n, p in model.named_parameters()
                       if n in TABLES)
        runs[mode] = (parts, weights.to_flax(model)[0],
                      _flat(weights.opt_to_flax(state)[0]))
    (pa, ta, ma), (pb, tb, mb) = runs["auto"], runs["off"]
    for field in dataclasses.fields(pa):
        np.testing.assert_allclose(to_np(getattr(pa, field.name)),
                                   to_np(getattr(pb, field.name)), **TOL)
    for k, v in _flat(ta).items():
        np.testing.assert_allclose(v, _flat(tb)[k], **TOL, err_msg=k)
    for k, v in ma.items():
        assert v.shape == mb[k].shape
        np.testing.assert_allclose(v, mb[k], **TOL, err_msg=k)


@pytest.mark.parametrize("mode", MODES)
def test_sync_params_from_opt_copies_the_pmn_param_column(mode):
    """The step needs no sync (the update writes the table rows), but a
    caller that loads optimizer rows does: under pmn the tables become
    pmn[:, :D] bit for bit; the split layout is left alone."""
    cfg = port_cfg(small_jax_cfg(compact_rows=mode, **_STEP_CFG))
    model = get_model_class("clsr")(cfg, N_USERS, N_ITEMS, N_CATES,
                                    device="cpu")
    state = create_train_state(model, cfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for mn in state.optimizer.moments.values():
        mn.add_(torch.randn(mn.shape, generator=torch.Generator()
                            .manual_seed(0)))
    sync_params_from_opt(state)
    for name, mn in state.optimizer.moments.items():
        p = dict(model.named_parameters())[name]
        want = mn[:, :p.shape[1]] if mode == "auto" else before[name]
        assert torch.equal(p, want), name


@pytest.mark.parametrize("path", ["legacy", "compact"])
def test_pmn_param_lane_is_rounded_to_the_table_dtype(path):
    """A bf16 table under the pmn layout: the row update writes the
    rows rounded to bf16 into the table and, as f32, into pmn's param
    lane, so the two stay equal (JAX: lazy_adam.py:188-189, 311,
    317-318)."""
    opt = LazyAdam(port_cfg(small_jax_cfg(**_STEP_CFG)))
    N, D = 12, 8
    g = torch.Generator().manual_seed(0)
    param = torch.randn(N, D, generator=g).to(torch.bfloat16)
    mn = torch.cat([param.float(), torch.rand(N, 2 * D, generator=g)], -1)
    ids = torch.tensor([3, 1, 3, 7, 0, 11], dtype=torch.int32)
    before = param.clone()
    if path == "legacy":
        entries = opt.table_update(param, torch.randn(N, D, generator=g), mn,
                                   ids, 1)
    else:
        plan = cr.build_plan({"rows": ids})
        w = mn.index_select(0, plan.sorted_ids.long())
        entries = opt.compact_table_update(
            param, w, torch.randn(w.shape[0], D, generator=g), mn, plan, 1)
    ru.scatter_rows_group_reference(entries)
    assert param.dtype == torch.bfloat16
    assert torch.equal(mn[:, :D], param.float())
    touched = torch.zeros(N, dtype=torch.bool)
    touched[ids.long()] = True
    assert not torch.equal(param[touched], before[touched])
    assert torch.equal(param[~touched], before[~touched])


def test_compact_rows_config_is_checked():
    with pytest.raises(ValueError, match="compact_rows"):
        load_config(None, user_vocab="u", item_vocab="i", cate_vocab="c",
                    compact_rows="on")
