"""The port's train step and its parts against the JAX package's.

Same numpy inputs and the same flax weights (carried over by
weights.from_flax) on both sides, JAX on the CPU:

  * `fused_train_attention` (on CPU its kernels' plain versions) against
    JAX's `fused_train_attention` in interpret mode, as
    tests/test_pallas_train.py runs it: output and the four batch
    statistics to 2e-5, BN on and off; its recompute backward against
    `jax.grad` of `_xla_train_scorer`: rtol 1e-4, atol 1e-5;
  * K3a/K3b's plain version `train_stats_reference` against JAX's Pallas
    kernels `_stats0_kernel` / `_stats1_kernel` through `_stats_call` in
    interpret mode, their per-batch-row partials summed: the per-row
    sums (sum / n, sum of squares / n) to 1e-5, at ragged B and L, G 1
    and 5, L = 1, and c0 > 0 (so a padding row counted would show);
  * the `fused_scan` Function's backward (on CPU its hand-derived
    plain version from the saved carries) against `jax.vjp` of
    `_scan_reference`: 1e-5;
  * train-mode FcnNet (flax-semantics BN) outputs and running statistics
    against flax, and the running update alone against
    `manual_bn_stats`: 1e-5;
  * `total_loss` parts on the same aux: 1e-5;
  * negative-sampling properties (the numbers differ from JAX's);
  * one whole train step with injected negatives (need_sample False)
    against `make_train_step_fn(..., allow_pallas=True/False)`: loss
    parts to 1e-5, clipped gradients to rtol 1e-4 / atol 1e-6, BN
    running statistics to 1e-5, and the parameters after one Adam step
    by the `_one_step_close` rule of tests/test_mesh_compact.py.  The
    JAX side keeps use_pallas_scan off (its kernel has no CPU mode); the
    port runs its recurrence both ways.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from clsr_tpu.ops import pallas_attention as jpa
from clsr_tpu.ops import pallas_scan as jps
from clsr_tpu.ops.mlp import FcnNet as JaxFcnNet
from clsr_tpu.training.losses import total_loss as jax_total_loss
from clsr_tpu.training.optimizer import build_optimizer as jax_optimizer
from clsr_tpu.training.state import TrainState as JaxTrainState
from clsr_tpu.training.steps import make_train_step_fn as jax_step_fn
from clsr_tpu_torch import weights
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.ops import fused_scan as fs
from clsr_tpu_torch.ops import fused_train_attention as fta
from clsr_tpu_torch.ops.initializers import get_initializer
from clsr_tpu_torch.ops.mlp import FcnNet, dropout
from clsr_tpu_torch.training.losses import total_loss
from clsr_tpu_torch.training.negative_sampling import expand_with_negatives
from clsr_tpu_torch.training.state import create_train_state
from clsr_tpu_torch.training.steps import make_train_step_fn

from test_torch_common import (N_CATES, N_ITEMS, N_USERS, TOL, jax_batch,
                               jax_clsr, numpy_batch, perturb, port_batch,
                               port_cfg, small_jax_cfg, to_np)
from tests.test_mesh_compact import _one_step_close

# ------------------------------------------------------- the fused scorer


def _scorer_args(seed, B=4, L=13, G=5, D=12, Dk=16, H0=24, H1=8):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(1, L + 1, B)
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
    f = lambda *s: (rng.randn(*s) * 0.1).astype(np.float32)
    return [f(B, L, Dk), f(B, L, D), f(B, G, D), mask,
            f(4 * D, H0), f(H0), 1.0 + f(H0), f(H0),
            f(H0, H1), f(H1), 1.0 + f(H1), f(H1), f(H1)]


@pytest.mark.parametrize("enable_bn", [True, False])
def test_fused_train_attention_matches_jax_kernel(enable_bn):
    args = _scorer_args(0)
    want = jpa.fused_train_attention(*map(jnp.asarray, args), 8, None, True,
                                     enable_bn)
    before = (fta.train_stats0.launches, fta.train_stats1.launches)
    got = fta.fused_train_attention(*map(torch.from_numpy, args),
                                    enable_bn=enable_bn)
    assert (fta.train_stats0.launches, fta.train_stats1.launches) == before
    assert len(got) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("enable_bn", [True, False])
def test_fused_train_attention_gradients_match_jax(enable_bn):
    args = _scorer_args(1, L=17)
    diff = [i for i in range(13) if i != 3]          # all but the mask

    def loss_ref(*a):
        att, m0, v0, m1, v1 = jpa._xla_train_scorer(*a, enable_bn=enable_bn)
        return (jnp.sum(jnp.tanh(att)) + 0.3 * jnp.sum(m0 * v0)
                + 0.2 * jnp.sum(m1 + v1))

    want = jax.grad(loss_ref, argnums=diff)(*map(jnp.asarray, args))
    t = [torch.from_numpy(a).requires_grad_(i in diff)
         for i, a in enumerate(args)]
    att, m0, v0, m1, v1 = fta.fused_train_attention(*t, enable_bn=enable_bn)
    (torch.tanh(att).sum() + 0.3 * (m0 * v0).sum()
     + 0.2 * (m1 + v1).sum()).backward()
    assert t[3].grad is None
    for i, w in zip(diff, want):
        got = t[i].grad if t[i].grad is not None else torch.zeros(t[i].shape)
        np.testing.assert_allclose(to_np(got), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=f"input {i}")


def test_train_stats_reference_matches_scorer_math():
    """K3a/K3b's plain version gives the statistics the scorer math
    normalises with (biasless means, the same variances)."""
    keys, kp, q, mask, k0, b0, s0, sh0, w1, b1, s1, sh1, w2 = map(
        torch.from_numpy, _scorer_args(2))
    D = kp.shape[-1]
    wk, wq, wd, wm = k0.split(D)
    n = q.shape[0] * kp.shape[1] * q.shape[1]
    s, sq = fta.train_stats_reference(q, kp, wk + wd, wq - wd, wm)
    _, m0, v0, m1, v1 = fta.train_scorer_math(keys, kp, q, mask, k0, b0, s0,
                                              sh0, w1, b1, s1, sh1, w2)
    torch.testing.assert_close(s / n + b0, m0, **TOL)
    torch.testing.assert_close(sq / n - (s / n) ** 2, v0, **TOL)
    a0 = s0 * torch.rsqrt(v0 + 1e-4)
    c0 = sh0 - a0 * (s / n)
    s1_, sq1 = fta.train_stats_reference(q, kp, wk + wd, wq - wd, wm,
                                         (a0, c0, w1))
    torch.testing.assert_close(s1_ / n + b1, m1, **TOL)
    torch.testing.assert_close(sq1 / n - (s1_ / n) ** 2, v1, **TOL)


# (B, L, G, D, H0, H1): B not a multiple of the JAX kernel's 8 batch rows
# a step, L not a multiple of its stats block of 8, G 1 and 5, a history
# of length 1, and one case with no padding at all
STATS_CASES = [(5, 13, 1, 8, 16, 8), (11, 17, 5, 16, 16, 8),
               (5, 1, 5, 8, 16, 8), (11, 13, 5, 8, 24, 16),
               (8, 16, 1, 16, 16, 8)]


@pytest.mark.parametrize("second", [False, True], ids=["k3a", "k3b"])
@pytest.mark.parametrize("case", STATS_CASES,
                         ids=["-".join(map(str, c)) for c in STATS_CASES])
def test_train_stats_reference_matches_jax_kernels(case, second):
    """K3a/K3b's plain version against JAX's Pallas statistics kernels
    (interpret mode): masked positions count, padding rows do not."""
    B, L, G, D, H0, H1 = case
    rng = np.random.RandomState(sum(case) + second)
    f = lambda *s, std=1.0: (rng.randn(*s) * std).astype(np.float32)
    q, kp = f(B, G, D), f(B, L, D)
    w = [f(D, H0, std=0.3) for _ in range(3)]
    a0 = (rng.rand(H0) + 0.5).astype(np.float32)
    c0 = (rng.rand(H0) + 0.1).astype(np.float32)          # > 0
    w1 = f(H0, H1, std=0.3)
    bl = 8
    n_l = -(-L // bl)
    kp_pad = np.pad(kp, ((0, 0), (0, n_l * bl - L), (0, 0)))
    if second:
        spec = lambda *s: jpa.pl.BlockSpec(s, lambda b, l: (0, 0),
                                           memory_space=jpa.pltpu.VMEM)
        extra = [jnp.asarray(a0[None]), jnp.asarray(c0[None]),
                 jnp.asarray(w1)]
        sums, sqs = jpa._stats_call(
            jpa._stats1_kernel, extra,
            [spec(1, H0), spec(1, H0), spec(H0, H1)], B, bl, n_l, D, G, H1,
            H0, jnp.asarray(q), jnp.asarray(kp_pad),
            *map(jnp.asarray, w), True, jnp.float32, L)
        fold = tuple(map(torch.from_numpy, (a0, c0, w1)))
    else:
        sums, sqs = jpa._stats_call(
            jpa._stats0_kernel, [], [], B, bl, n_l, D, G, H0, H0,
            jnp.asarray(q), jnp.asarray(kp_pad), *map(jnp.asarray, w), True,
            jnp.float32, L)
        fold = None
    got = fta.train_stats_reference(torch.from_numpy(q),
                                    torch.from_numpy(kp),
                                    *map(torch.from_numpy, w), fold)
    n = B * L * G
    for g, want in zip(got, (sums, sqs)):
        np.testing.assert_allclose(to_np(g) / n,
                                   np.asarray(want).sum(0) / n, **TOL)


# ---------------------------------------------------------- the recurrence


def test_fused_scan_backward_matches_jax_vjp():
    B, L, U, H = 3, 8, 10, 12
    rng = np.random.RandomState(3)
    f = lambda *s: (rng.randn(*s) * 0.7).astype(np.float32)
    w = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)
    mask = (np.arange(L)[None] < np.array([[L], [3], [1]])).astype(
        np.float32)
    args = [f(B, L, 2 * U), f(B, L, U), f(B, L, 4 * H), f(B, L, H),
            f(B, L, H), f(B, L, H), f(B, L, 2 * H), f(B, L, H), mask,
            f(B, U), w(U, 2 * U), w(U, U), w(H, 4 * H), w(H, 2 * H),
            w(H, H)]
    cts = [f(B, U), f(B, L, H), f(B, H)]
    for used in ((0, 1, 2), (1,)):         # an unused output's grad is zero
        ct = [c if i in used else np.zeros_like(c) for i, c in
              enumerate(cts)]
        _, vjp = jax.vjp(jps._scan_reference, *map(jnp.asarray, args))
        want = vjp(tuple(map(jnp.asarray, ct)))
        t = [torch.from_numpy(a).requires_grad_(i != 8)
             for i, a in enumerate(args)]
        outs = fs.fused_scan(*t)
        sum(((o * torch.from_numpy(c)).sum() for i, (o, c) in
             enumerate(zip(outs, ct)) if i in used)).backward()
        assert t[8].grad is None
        for i, (tt, wg) in enumerate(zip(t, want)):
            if i != 8:
                np.testing.assert_allclose(to_np(tt.grad), np.asarray(wg),
                                           **TOL, err_msg=f"input {i}")


# ------------------------------------------------------ train-mode FcnNet


def _fcn_pair(split, seed):
    rng = np.random.RandomState(seed)
    jmod = JaxFcnNet((8, 4), ("relu",), enable_bn=True, out_dim=1)
    if split:
        inputs = (rng.randn(3, 5, 6).astype(np.float32),
                  rng.randn(3, 4, 6).astype(np.float32))
        variables = jmod.init(jax.random.PRNGKey(seed), None, train=True,
                              split_parts=tuple(map(jnp.asarray, inputs)))
    else:
        inputs = (rng.randn(7, 3, 6).astype(np.float32),)
        variables = jmod.init(jax.random.PRNGKey(seed),
                              jnp.asarray(inputs[0]), train=True)
    params = perturb(variables["params"], rng)
    stats = perturb(variables["batch_stats"], rng)
    pmod = FcnNet(6, (8, 4), ("relu",), get_initializer("tnormal", 0.01),
                  torch.Generator(), torch.device("cpu"), enable_bn=True,
                  out_dim=1, split_first=split).train()
    weights.from_flax(pmod, params, stats)
    return jmod, {"params": params, "batch_stats": stats}, pmod, inputs


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


@pytest.mark.parametrize("split", [False, True])
def test_fcn_net_train_mode_matches_flax(split):
    jmod, variables, pmod, inputs = _fcn_pair(split, seed=4 + split)
    jin = tuple(map(jnp.asarray, inputs))
    if split:
        want, mutated = jmod.apply(variables, None, train=True,
                                   split_parts=jin, mutable=["batch_stats"])
        got = pmod(None, split_parts=tuple(map(torch.from_numpy, inputs)))
    else:
        want, mutated = jmod.apply(variables, jin[0], train=True,
                                   mutable=["batch_stats"])
        got = pmod(torch.from_numpy(inputs[0]))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    _, got_stats = weights.to_flax(pmod)
    want_stats = _flat(mutated["batch_stats"])
    assert set(_flat(got_stats)) == set(want_stats)
    for k, v in _flat(got_stats).items():
        np.testing.assert_allclose(v, want_stats[k], **TOL, err_msg=k)


def test_bn_stats_update_matches_manual_bn_stats():
    jmod, variables, pmod, _ = _fcn_pair(False, seed=6)
    rng = np.random.RandomState(7)
    batch = [(rng.randn(8).astype(np.float32), rng.rand(8).astype(np.float32)),
             (rng.randn(4).astype(np.float32), rng.rand(4).astype(np.float32))]
    _, mutated = jmod.apply(variables, None, train=True,
                            manual_bn_stats=[tuple(map(jnp.asarray, p))
                                             for p in batch],
                            mutable=["batch_stats"])
    pmod.update_bn_stats([tuple(map(torch.from_numpy, p)) for p in batch])
    want = _flat(mutated["batch_stats"])
    for k, v in _flat(weights.to_flax(pmod)[1]).items():
        np.testing.assert_allclose(v, want[k], **TOL, err_msg=k)


def test_dropout_keeps_scales_and_repeats_by_seed():
    x = torch.ones(400, 50)
    a = dropout(x, 0.3, torch.Generator().manual_seed(0))
    b = dropout(x, 0.3, torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.7))
    assert dropout(x, 0.0, None) is x
    fcn = FcnNet(6, (8,), ("relu",), get_initializer("tnormal", 0.5),
                 torch.Generator().manual_seed(1), torch.device("cpu"),
                 dropout_rates=(0.5,))
    x = torch.randn(16, 6)
    draw = lambda: fcn(x, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(draw(), draw(), rtol=0, atol=0)
    assert not torch.equal(draw(), fcn.eval()(x))


# ------------------------------------------------------------------ losses

_LOSS_VARIANTS = {
    "triplet": dict(),
    "bpr_attn": dict(contrastive_loss="bpr", use_attn_loss=True),
    "pointwise": dict(loss="cross_entropy_loss", layer_l1=1e-3),
}


@pytest.mark.parametrize("variant", sorted(_LOSS_VARIANTS))
def test_total_loss_matches_jax(variant):
    jcfg = small_jax_cfg(contrastive_length_threshold=2, embed_l2=1e-3,
                         layer_l2=1e-3, **_LOSS_VARIANTS[variant])
    _, params, stats = jax_clsr(jcfg)
    model = get_model_class("clsr")(port_cfg(jcfg), N_USERS, N_ITEMS,
                                    N_CATES, device="cpu")
    weights.from_flax(model, params, stats)
    rng = np.random.RandomState(8)
    B, G, D = 5, 4, 12
    b = numpy_batch(rng, B, G, 7)
    b["labels"][:, 0] = 1.0
    b["valid"][-1] = 0.0
    f = lambda *s: rng.randn(*s).astype(np.float32)
    aux = dict(att_fea_long=f(B, D), att_fea_short=f(B, G, D),
               hist_mean=f(B, D), hist_recent=f(B, D),
               seq_len=b["mask"].sum(-1), embed_sumsq=np.float32(3.5),
               discrepancy_sumsq=np.float32(2.25),
               discrepancy_count=np.int32(24), alpha=rng.rand(B, G).astype(
                   np.float32), attn_labels=f(B, G))
    logits = f(B, G)
    want = jax_total_loss(jcfg, jnp.asarray(logits),
                          {k: jnp.asarray(v) for k, v in aux.items()},
                          jax_batch(b), params)
    got = total_loss(port_cfg(jcfg), torch.from_numpy(logits),
                     {k: torch.as_tensor(np.asarray(v)) for k, v in
                      aux.items()}, port_batch(b), model)
    for field in dataclasses.fields(got):
        np.testing.assert_allclose(to_np(getattr(got, field.name)),
                                   np.asarray(getattr(want, field.name)),
                                   **TOL, err_msg=field.name)


# --------------------------------------------------------------- negatives


def test_negative_sampling_properties():
    B, n_valid, num_ngs = 8, 6, 4
    b = port_batch(numpy_batch(np.random.RandomState(9), B, 1, 7))
    b.items[:, 0] = torch.arange(100, 100 + B, dtype=torch.int32)
    b.cates[:, 0] = torch.arange(B, dtype=torch.int32)
    b.valid[n_valid:] = 0.0
    draw = lambda seed: expand_with_negatives(
        torch.Generator().manual_seed(seed), b, num_ngs)
    out = draw(0)
    assert out.items.shape == out.cates.shape == out.labels.shape == (
        B, 1 + num_ngs)
    torch.testing.assert_close(out.items[:, 0], b.items[:, 0])
    assert out.labels[:, 0].eq(1).all() and out.labels[:, 1:].eq(0).all()
    neg = out.items[:, 1:]
    assert ((neg >= 100) & (neg < 100 + n_valid)).all()    # valid rows only
    assert (neg != out.items[:, :1]).all()                 # resampled
    torch.testing.assert_close(out.cates[:, 1:], neg - 100)  # pairs kept
    torch.testing.assert_close(draw(0).items, out.items, rtol=0, atol=0)
    assert not torch.equal(draw(1).items, out.items)
    assert b.items.shape == (B, 1)                          # input untouched


# ------------------------------------------------------- the whole step

_STEP_CFG = dict(need_sample=False, train_num_ngs=4, embed_l2=1e-4,
                 layer_l2=1e-4, contrastive_length_threshold=2,
                 max_grad_norm=0.5)


def _step_batch():
    b = numpy_batch(np.random.RandomState(10), 4, 5, 7,
                    lengths=[7, 3, 5, 1])
    b["labels"][:, 0] = 1.0
    return b


@pytest.fixture(scope="module")
def jax_model():
    jcfg = small_jax_cfg(**_STEP_CFG)
    model, params, stats = jax_clsr(jcfg)
    return jcfg, model, params, stats


@pytest.fixture(scope="module", params=[True, False],
                ids=["jax_kernel", "jax_plain"])
def jax_step(request, jax_model):
    """JAX's train step, its clipped gradients, and the state after it."""
    jcfg, model, params, stats = jax_model
    allow = request.param
    batch = jax_batch(_step_batch())
    rng = jax.random.PRNGKey(0)
    state = JaxTrainState.create(apply_fn=model.apply, params=params,
                                 batch_stats=stats, tx=jax_optimizer(jcfg))
    new_state, parts = jax.jit(jax_step_fn(model, jcfg,
                                           allow_pallas=allow))(
        state, batch, rng)

    def loss_fn(p):
        (logits, aux), _ = model.apply(
            {"params": p, "batch_stats": stats}, batch, train=True,
            rngs={"dropout": jax.random.split(rng)[1]},
            mutable=["batch_stats"])
        return jax_total_loss(jcfg, logits, aux, batch, p).loss

    with jpa.use_train_attention(allow):
        grads = jax.jit(jax.grad(loss_fn))(params)

    def clip(g):
        g = np.asarray(g)
        norm = np.sqrt(np.sum(g * g))
        return g * (jcfg.max_grad_norm / norm) if norm > jcfg.max_grad_norm \
            else g
    return allow, parts, {k: clip(v) for k, v in _flat(grads).items()}, \
        new_state


@pytest.mark.parametrize("use_pallas_scan", [False, True])
def test_train_step_matches_jax(jax_model, jax_step, use_pallas_scan,
                                monkeypatch):
    jcfg, _, params, stats = jax_model
    allow, want_parts, want_grads, want_state = jax_step
    cfg = port_cfg(jcfg, use_pallas_scan=use_pallas_scan)
    model = get_model_class("clsr")(cfg, N_USERS, N_ITEMS, N_CATES,
                                    device="cpu")
    weights.from_flax(model, params, stats)
    state = create_train_state(model, cfg)
    step = make_train_step_fn(model, cfg, allow_pallas=allow)
    calls = []   # K3a/K3b's plain version runs where they would launch
    plain = fta.train_stats_reference
    monkeypatch.setattr(fta, "train_stats_reference",
                        lambda *a: calls.append(1) or plain(*a))
    state, parts = step(state, port_batch(_step_batch()),
                        torch.Generator().manual_seed(0))
    assert state.step == 1
    assert len(calls) == (4 if allow else 0)     # 2 passes x 2 layers
    for field in dataclasses.fields(parts):
        np.testing.assert_allclose(to_np(getattr(parts, field.name)),
                                   np.asarray(getattr(want_parts,
                                                      field.name)),
                                   **TOL, err_msg=field.name)
    names = weights.flax_names(model)
    params_by_name = dict(model.named_parameters())
    for name, (collection, flax, transpose) in names.items():
        if collection != "params":
            continue
        g = params_by_name[name].grad
        g = to_np(g.t() if transpose else g)
        np.testing.assert_allclose(g, want_grads[flax], rtol=1e-4,
                                   atol=1e-6, err_msg=flax)
    got_params, got_stats = weights.to_flax(model)
    want_stats = _flat(want_state.batch_stats)
    assert set(_flat(got_stats)) == set(want_stats)
    for k, v in _flat(got_stats).items():
        np.testing.assert_allclose(v, want_stats[k], **TOL, err_msg=k)
    _one_step_close(want_state.params, got_params, jcfg.learning_rate)
