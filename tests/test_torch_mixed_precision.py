"""bf16 tables and bf16 compute: the port against the JAX package.

Same numpy inputs and the same flax weights (weights.from_flax) on both
sides, JAX on the CPU.  JAX's tables come from its init perturbed as
tests/test_torch_common.py does, then rounded to bf16 (the JAX model
holds bf16 tables under `embedding_dtype: bfloat16`); the port takes
their exact f32 widening.

bf16 tables, f32 compute:
  * the eval forward (K1 on and off) within 1e-5, the tables bf16;
  * a table's lookup gradient: XLA on the CPU rounds each cotangent row
    to bf16 and adds a repeated row's rows one after another in bf16, in
    their order; the port's sorted sum (`ops.segment_sum`, stable order)
    does the same, bit for bit for one lookup site.  The gap: a table
    read at several sites sums each site's gradient first, and the two
    frameworks may add the sites' sums in another order;
  * the compact step's w-space gradient (bf16: each cotangent row
    rounded, the lookup sites' and the L2's parts added in bf16) equals
    `jax.grad` of JAX's compact loss bit for bit;
  * two lazyadam steps, compact rows (pmn) and legacy, against JAX's
    jitted `make_train_step`: loss parts and dense parameters within
    1e-5, table rows within 1 bf16 ulp of JAX's with at least 99% of
    them bit-identical, the count; the tables stay bf16 and the moments
    f32, and pmn's param lane equals the table.  The moments are held
    to one bf16 rounding of the gradient (mu 2^-7 relative, nu, a
    square, 2^-6) plus half that of the table's largest moment (a part
    of a sum rounded before the parts cancel): inside its jitted step
    XLA may drop a convert pair f32 -> bf16 -> f32 (excess precision),
    so some of JAX's gradient entries keep f32 bits; JAX's own step
    moments stand up to 0.5% off 0.1 x its rounded gradient
    (`jax.grad`), which the port matches;
  * dense Adam with bf16 tables raises in both packages' config.

bf16 compute (the frameworks round bf16 at different places):
  * the eval logits within 2e-2 abs and f32, with the parameters f32;
  * the encoder's outputs within 2e-2;
  * two dense-Adam train steps: loss parts within 1e-2 relative;
  * a two-epoch `Trainer.fit` (tests/test_torch_trainer.py's setup,
    deterministic negatives) with losses within 2e-2 relative and valid
    AUC within 1e-2 of JAX's.

A bf16 lazyadam checkpoint round-trips bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import clsr_tpu.training.steps as jax_steps
from clsr_tpu.config import Config as JaxConfig
from clsr_tpu.models.registry import get_model_class as jax_model_class
from clsr_tpu.ops.fused_clsr import FusedCLSREncoder as JaxEncoder
from clsr_tpu.training.lazy_adam import make_lazy_optimizer
from clsr_tpu.training.optimizer import build_optimizer as jax_optimizer
from clsr_tpu.training.state import TrainState as JaxTrainState
from clsr_tpu.training.steps import make_train_step as jax_make_train_step
from clsr_tpu.training.steps import make_train_step_fn as jax_step_fn
from clsr_tpu.training.trainer import Trainer as JaxTrainer
import clsr_tpu_torch.training.steps as port_steps
from clsr_tpu_torch import weights
from clsr_tpu_torch.config import load_config
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.ops.fused_clsr import FusedCLSREncoder
from clsr_tpu_torch.ops.segment_sum import lookup
from clsr_tpu_torch.training import checkpoint
from clsr_tpu_torch.training.state import create_train_state
from clsr_tpu_torch.training.steps import make_train_step, make_train_step_fn
from clsr_tpu_torch.training.trainer import Trainer

from test_torch_common import (N_CATES, N_ITEMS, N_USERS, TOL, jax_batch,
                               jax_clsr, numpy_batch, perturb, port_batch,
                               port_cfg, small_jax_cfg, to_np)
from test_torch_trainer import (FIT, _jax_negatives, _port_negatives,
                                _scalars, _sizes, data)  # noqa: F401

BF16_TABLES = dict(embedding_dtype="bfloat16", optimizer="lazyadam")
BF16_COMPUTE = dict(compute_dtype="bfloat16")
TABLES = ("item_embedding", "cate_embedding", "user_long_embedding",
          "user_short_embedding")


def _bf16_tables(params):
    """JAX params with every table in bf16, as its model holds them."""
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (x.astype(jnp.bfloat16)
                      if str(p[-1].key).endswith("_embedding") else x),
        params)


def _port_model(cfg, params, stats):
    model = get_model_class("clsr")(cfg, N_USERS, N_ITEMS, N_CATES,
                                    device="cpu")
    weights.from_flax(model, params, stats)
    return model


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


def _bits(x):
    """bf16 values (any float array holding them) as int16 bit patterns
    in one monotone order (negative values mirrored)."""
    b = np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).view(np.int16)
    b = b.astype(np.int32)
    return np.where(b < 0, -32768 - b, b)


# --------------------------------------------- bf16 tables, f32 compute


@pytest.mark.parametrize("k1", ["on", "off"])
def test_bf16_tables_forward_matches_jax(k1):
    jcfg = small_jax_cfg(**BF16_TABLES)
    model, params, stats = jax_clsr(jcfg)
    params = _bf16_tables(params)
    b = numpy_batch(np.random.RandomState(1), 3, 9, jcfg.max_seq_length)
    want, _ = jax.jit(model.apply, static_argnames="train")(
        {"params": params, "batch_stats": stats}, jax_batch(b), train=False)
    pm = _port_model(port_cfg(jcfg, use_pallas_eval_attention=k1), params,
                     stats)
    for name in TABLES:
        p = getattr(pm, name)
        assert p.dtype == torch.bfloat16
        np.testing.assert_array_equal(to_np(p.float()),
                                      np.asarray(params[name], np.float32))
    pm.eval()
    with torch.no_grad():
        got, _ = pm(port_batch(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_bf16_lookup_gradient_equals_xla_bit_for_bit():
    rng = np.random.RandomState(0)
    table = rng.randn(7, 5).astype(ml_dtypes.bfloat16)
    ids = rng.randint(0, 7, (40, 3)).astype(np.int32)
    c = rng.randn(40, 3, 5).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(jnp.asarray(c) * t[ids].astype(
        jnp.float32)))(jnp.asarray(table))
    t = torch.from_numpy(table.astype(np.float32)).bfloat16()
    t.requires_grad_()
    (torch.from_numpy(c) * lookup(t, torch.from_numpy(ids)).float()
     ).sum().backward()
    assert t.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_np(t.grad.float()),
                                  np.asarray(want, np.float32))


_STEP_CFG = dict(need_sample=False, train_num_ngs=4, embed_l2=1e-4,
                 layer_l2=1e-4, contrastive_length_threshold=2,
                 max_grad_norm=0.5)


def _batches():
    out = []
    for seed, lengths in ((10, [7, 3, 5, 1]), (11, [2, 7, 6, 4])):
        b = numpy_batch(np.random.RandomState(seed), 4, 5, 7,
                        lengths=lengths)
        b["labels"][:, 0] = 1.0
        out.append(b)
    return out


@pytest.fixture(scope="module", params=("auto", "off"))
def jax_lazy_bf16(request):
    """JAX's two lazyadam steps with bf16 tables, and its start."""
    jcfg = small_jax_cfg(compact_rows=request.param, **BF16_TABLES,
                         **_STEP_CFG)
    model, params, stats = jax_clsr(jcfg)
    params = _bf16_tables(params)
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
    return jcfg, params, stats, states, parts


def test_bf16_compact_gradient_equals_jax_bit_for_bit(monkeypatch):
    import flax.traverse_util as tu
    from clsr_tpu.training import compact_rows as jcr
    from clsr_tpu.training.losses import total_loss as jax_total_loss
    from clsr_tpu_torch.training.lazy_adam import LazyAdam

    jcfg = small_jax_cfg(compact_rows="auto", **BF16_TABLES, **_STEP_CFG)
    model, params, stats = jax_clsr(jcfg)
    params = _bf16_tables(params)
    batch = jax_batch(_batches()[0])
    names = jcr.supported_tables(params)
    flat = tu.flatten_dict(params)
    tables = {p: v for p, v in flat.items() if p in names}
    dense = {p: v for p, v in flat.items() if p not in names}
    plans = jcr.build_plans(names, batch)
    ws = {names[p]: v[plans[names[p]].sorted_ids] for p, v in tables.items()}

    def loss_fn(ws_in):
        merged = dict(dense)
        merged.update(tables)
        prm = tu.unflatten_dict(merged)
        with jcr.use_compact_rows(jcr.make_context(plans, ws_in)):
            (logits, aux), _ = model.apply(
                {"params": prm, "batch_stats": stats}, batch, train=True,
                rngs={"dropout": jax.random.PRNGKey(0)},
                mutable=["batch_stats"])
        return jax_total_loss(jcfg, logits, aux, batch, prm).loss

    want = jax.grad(loss_fn)(ws)    # op by op: no excess precision
    got = {}
    update = LazyAdam.compact_update
    monkeypatch.setattr(LazyAdam, "compact_update",
                        lambda self, m, st, gws, *a: got.update(gws)
                        or update(self, m, st, gws, *a))
    cfg = port_cfg(jcfg)
    pm = _port_model(cfg, params, stats)
    make_train_step(pm, cfg)(create_train_state(pm, cfg),
                             port_batch(_batches()[0]),
                             torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want)
    for name, g in want.items():
        assert got[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(to_np(got[name].float()),
                                      np.asarray(g, np.float32),
                                      err_msg=name)


def test_bf16_lazy_steps_match_jax(jax_lazy_bf16):
    jcfg, params, stats, states, parts = jax_lazy_bf16
    model = _port_model(port_cfg(jcfg), params, stats)
    state = create_train_state(model, port_cfg(jcfg))
    step = make_train_step(model, port_cfg(jcfg))
    n_rows = n_same = 0
    for i, b in enumerate(_batches()):
        state, got = step(state, port_batch(b),
                          torch.Generator().manual_seed(i))
        want_state = states[i]
        for field in dataclasses.fields(got):
            np.testing.assert_allclose(
                to_np(getattr(got, field.name)),
                np.asarray(getattr(parts[i], field.name)), **TOL,
                err_msg=f"step {i} {field.name}")
        got_params, _ = weights.to_flax(model)
        want_params = _flat(want_state.params)
        for k, v in _flat(got_params).items():
            if k in TABLES:
                assert getattr(model, k).dtype == torch.bfloat16
                assert want_params[k].dtype == ml_dtypes.bfloat16
                ulps = np.abs(_bits(v) - _bits(want_params[k]))
                assert ulps.max() <= 1, (i, k, ulps.max())
                n_rows += ulps.shape[0]
                n_same += int((ulps == 0).all(-1).sum())
            else:
                np.testing.assert_allclose(v, want_params[k], **TOL,
                                           err_msg=f"step {i} {k}")
        want_m = {"/".join(k): np.asarray(v) for k, v in
                  want_state.opt_state.moments.items()}
        for name, mn in state.optimizer.moments.items():
            assert mn.dtype == torch.float32
            p = dict(model.named_parameters())[name]
            D = p.shape[1]
            got_m, w = to_np(mn), want_m[name]
            off = got_m.shape[1] - 2 * D
            if off:     # pmn: the param lane holds the table's rows
                assert torch.equal(mn[:, :D], p.float())
            for lane, rtol in ((slice(off, off + D), 2.0 ** -7),
                               (slice(off + D, None), 2.0 ** -6)):
                atol = rtol / 2 * np.abs(w[:, lane]).max()
                np.testing.assert_allclose(got_m[:, lane], w[:, lane],
                                           rtol=rtol, atol=atol,
                                           err_msg=f"step {i} {name}")
        assert int(state.optimizer.count) == i + 1
    assert n_same >= 0.99 * n_rows, (n_same, n_rows)


def test_dense_adam_with_bf16_tables_raises_as_jax_does():
    kw = dict(user_vocab="u", item_vocab="i", cate_vocab="c",
              embedding_dtype="bfloat16", optimizer="adam")
    with pytest.raises(ValueError, match="requires optimizer=lazyadam"):
        JaxConfig(**kw).validate()
    with pytest.raises(ValueError, match="requires optimizer=lazyadam"):
        load_config(None, **kw)
    assert load_config(None, **dict(kw, optimizer="lazyadam")
                       ).embedding_dtype == "bfloat16"


def test_bf16_lazy_checkpoint_round_trips(tmp_path):
    jcfg = small_jax_cfg(**BF16_TABLES, **_STEP_CFG)
    _, params, stats = jax_clsr(jcfg)
    params = _bf16_tables(params)
    cfg = port_cfg(jcfg)
    model = _port_model(cfg, params, stats)
    state = create_train_state(model, cfg)
    make_train_step(model, cfg)(state, port_batch(_batches()[0]),
                                torch.Generator().manual_seed(0))
    checkpoint.save_state(str(tmp_path), state)
    other = create_train_state(_port_model(cfg, params, stats), cfg)
    checkpoint.load_state(str(tmp_path), other)
    for k, v in state.model.state_dict().items():
        got = other.model.state_dict()[k]
        assert got.dtype == v.dtype and torch.equal(got, v), k
    assert state.model.item_embedding.dtype == torch.bfloat16
    for k, v in state.optimizer.moments.items():
        assert other.optimizer.moments[k].dtype == torch.float32
        assert torch.equal(other.optimizer.moments[k], v), k
    assert int(other.optimizer.count) == 1 == other.step


# ---------------------------------------------------------- bf16 compute


@pytest.mark.parametrize("k1", ["on", "off"])
def test_bf16_compute_logits_match_jax(k1):
    jcfg = small_jax_cfg(**BF16_COMPUTE)
    model, params, stats = jax_clsr(jcfg)
    b = numpy_batch(np.random.RandomState(1), 3, 9, jcfg.max_seq_length)
    want, _ = jax.jit(model.apply, static_argnames="train")(
        {"params": params, "batch_stats": stats}, jax_batch(b), train=False)
    pm = _port_model(port_cfg(jcfg, use_pallas_eval_attention=k1), params,
                     stats)
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    pm.eval()
    with torch.no_grad():
        got, _ = pm(port_batch(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0,
                               atol=2e-2)


def test_bf16_compute_encoder_matches_jax():
    B, L, D, U, H = 3, 11, 12, 10, 8
    rng = np.random.RandomState(1)
    hist = rng.randn(B, L, D).astype(np.float32)
    t_last = (rng.rand(B, L) * 3).astype(np.float32)
    t_now = (rng.rand(B, L) * 3).astype(np.float32)
    mask = (np.arange(L)[None] < np.array([[2], [L], [5]])).astype(
        np.float32)
    user_short = rng.randn(B, U).astype(np.float32)
    inputs = (hist, t_last, t_now, mask, user_short)
    jmod = JaxEncoder(U, H, dtype=jnp.bfloat16)
    params = perturb(jmod.init(jax.random.PRNGKey(2), *inputs)["params"],
                     rng)
    want = jmod.apply({"params": params}, *inputs)
    pmod = FusedCLSREncoder(D, U, H, torch.Generator(), torch.device("cpu"),
                            use_pallas=True, dtype=torch.bfloat16)
    weights.from_flax(pmod, params)
    with torch.no_grad():
        got = pmod(*map(torch.from_numpy, inputs))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(to_np(g), np.asarray(w, np.float32),
                                   rtol=0, atol=2e-2)


def test_bf16_compute_two_train_steps_match_jax():
    jcfg = small_jax_cfg(**BF16_COMPUTE, **_STEP_CFG)
    model, params, stats = jax_clsr(jcfg)
    state = JaxTrainState.create(apply_fn=model.apply, params=params,
                                 batch_stats=stats, tx=jax_optimizer(jcfg))
    jstep = jax.jit(jax_step_fn(model, jcfg, allow_pallas=False))
    cfg = port_cfg(jcfg)
    pm = _port_model(cfg, params, stats)
    pstate = create_train_state(pm, cfg)
    pstep = make_train_step_fn(pm, cfg, allow_pallas=False)
    for i, b in enumerate(_batches()):
        state, want = jstep(state, jax_batch(b), jax.random.PRNGKey(i))
        pstate, got = pstep(pstate, port_batch(b),
                            torch.Generator().manual_seed(i))
        for field in dataclasses.fields(got):
            np.testing.assert_allclose(
                to_np(getattr(got, field.name)),
                np.asarray(getattr(want, field.name)), rtol=1e-2,
                err_msg=f"step {i} {field.name}")
    assert all(p.dtype == torch.float32 for p in pm.parameters())


def test_bf16_compute_fit_matches_jax(data, tmp_path, monkeypatch):
    _, pv, port, jax_l = data
    monkeypatch.setattr(jax_steps, "expand_with_negatives", _jax_negatives)
    monkeypatch.setattr(port_steps, "expand_with_negatives",
                        _port_negatives)
    jcfg = small_jax_cfg(**FIT, **BF16_COMPUTE,
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
    jt.fit(jax_l["train"], jax_l["valid"])
    pt.fit(port["train"], port["valid"])

    got, want = _scalars(tmp_path / "port"), _scalars(tmp_path / "jax")
    assert [r["step"] for r in got] == [r["step"] for r in want]
    n_losses = 0
    for g, w in zip(got, want):
        for key in set(w) - {"step", "time"}:
            if not key.startswith("valid/"):
                n_losses += 1
                np.testing.assert_allclose(g[key], w[key], rtol=2e-2,
                                           err_msg=f"{key} at {g['step']}")
    assert n_losses >= 2 * 2 * 5
    assert len(pt.eval_history) == len(jt.eval_history) == 2
    for (ep, g), (_, w) in zip(pt.eval_history, jt.eval_history):
        assert abs(g["auc"] - w["auc"]) <= 1e-2, (ep, g["auc"], w["auc"])
