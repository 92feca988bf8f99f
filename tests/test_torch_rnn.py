"""The port's recurrent cells, Dice and SoftAttention against the JAX
package's.

The same numpy inputs and the same flax weights (JAX's init, perturbed a
little so that the ones / zeros biases matter, carried over by
`weights.from_flax`) on both sides, f32 on the CPU:

  * each cell of clsr_tpu_torch/ops/rnn.py against clsr_tpu/ops/rnn.py
    (GRU with and without an initial state, LSTM, Time4LSTM, Time4ALSTM,
    VecAttGRU with [B, L] and [B, G, L] scores) at lengths that include
    1 and L: outputs and final state to 1e-5 abs; then the gradient of
    a fixed weighting of the outputs and the final state with respect to
    every input and weight, torch.autograd against `jax.grad`, each
    within 1e-5 of its max abs;
  * the outputs are zero past each row's length and the final state is
    the state at length - 1;
  * `Dice` and `FcnNet` with dice activations (eval and train mode,
    batch statistics both times) and `SoftAttention` against flax: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsr_tpu.ops import rnn as jrnn
from clsr_tpu.ops.attention import SoftAttention as JaxSoftAttention
from clsr_tpu.ops.mlp import Dice as JaxDice
from clsr_tpu.ops.mlp import FcnNet as JaxFcnNet
from clsr_tpu_torch import weights
from clsr_tpu_torch.ops import rnn
from clsr_tpu_torch.ops.attention import SoftAttention
from clsr_tpu_torch.ops.initializers import get_initializer
from clsr_tpu_torch.ops.mlp import Dice, FcnNet

from test_torch_common import TOL, perturb, to_np

B, L, D, H, G = 5, 9, 10, 12, 3
LENGTHS = [1, L, 4, 7, 2]
CPU = torch.device("cpu")


def _inputs(seed):
    rng = np.random.RandomState(seed)
    f = lambda *s, std=1.0: (rng.randn(*s) * std).astype(np.float32)
    mask = (np.arange(L)[None] < np.asarray(LENGTHS)[:, None]).astype(
        np.float32)
    return dict(x=f(B, L, D) * mask[..., None], mask=mask,
                t_last=(rng.rand(B, L) * 3 * mask).astype(np.float32),
                t_now=(rng.rand(B, L) * 3 * mask).astype(np.float32),
                att=rng.rand(B, L).astype(np.float32),
                att_g=rng.rand(B, G, L).astype(np.float32),
                h0=f(B, H, std=0.5))


# name -> (JAX module, port class, inputs the call reads, in order)
CELLS = {
    "gru": (jrnn.GRU, rnn.GRU, ("x", "mask")),
    "gru_init_state": (jrnn.GRU, rnn.GRU, ("x", "mask", "h0")),
    "lstm": (jrnn.LSTM, rnn.LSTM, ("x", "mask")),
    "time4lstm": (jrnn.Time4LSTM, rnn.Time4LSTM,
                  ("x", "t_last", "t_now", "mask")),
    "time4alstm": (jrnn.Time4ALSTM, rnn.Time4ALSTM,
                   ("x", "t_last", "t_now", "att", "mask")),
    "vecattgru": (jrnn.VecAttGRU, rnn.VecAttGRU, ("x", "att", "mask")),
    "vecattgru_grouped": (jrnn.VecAttGRU, rnn.VecAttGRU,
                          ("x", "att_g", "mask")),
}
NO_GRAD = {"mask"}


def _pair(name, seed=0):
    jcls, pcls, keys = CELLS[name]
    arrays = _inputs(seed)
    args = [jnp.asarray(arrays[k]) for k in keys]
    jmod = jcls(H)
    params = jmod.init(jax.random.PRNGKey(seed), *args)["params"]
    params = perturb(params, np.random.RandomState(seed + 1), scale=0.1)
    pmod = pcls(D, H, torch.Generator().manual_seed(seed), CPU)
    weights.from_flax(pmod, params)
    return jmod, params, pmod, keys, arrays


def _leaves(out):
    """(outputs, final state leaves) of a cell's return value."""
    outs, final = out
    return [outs] + (list(final) if isinstance(final, tuple) else [final])


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_forward_matches_jax(name):
    jmod, params, pmod, keys, arrays = _pair(name)
    want = _leaves(jmod.apply({"params": params},
                              *[jnp.asarray(arrays[k]) for k in keys]))
    got = _leaves(pmod(*[torch.from_numpy(arrays[k]) for k in keys]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(to_np(g), np.asarray(w), **TOL)
    # masked carry-through: zero outputs past the length, and the final
    # state is the output at length - 1
    outs = to_np(got[0])
    lengths = np.asarray(LENGTHS)
    pad = (np.arange(L)[None] >= lengths[:, None])
    if outs.ndim == 4:                                   # [B, G, L, H]
        assert not outs.transpose(0, 2, 1, 3)[pad].any()
        last = outs[np.arange(B), :, lengths - 1]        # [B, G, H]
    else:
        assert not outs[pad].any()
        last = outs[np.arange(B), lengths - 1]
    final = to_np(got[1] if name.startswith(("gru", "vecattgru"))
                  else got[2])                           # (c, m): m last
    # Time4ALSTM's outputs are a * out + (1 - a) * out: one rounding off
    np.testing.assert_allclose(final, last, rtol=0, atol=1e-7)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_gradients_match_jax(name):
    jmod, params, pmod, keys, arrays = _pair(name, seed=1)
    rng = np.random.RandomState(2)
    probe = lambda: _leaves(pmod(*[torch.from_numpy(arrays[k])
                                   for k in keys]))
    cts = [rng.randn(*t.shape).astype(np.float32) for t in probe()]
    diff = [i for i, k in enumerate(keys) if k not in NO_GRAD]

    def jax_loss(p, *args):
        return sum(jnp.sum(o * c) for o, c in
                   zip(_leaves(jmod.apply({"params": p}, *args)), cts))

    jargs = [jnp.asarray(arrays[k]) for k in keys]
    want_p, *want_x = jax.grad(jax_loss, argnums=(0, *[1 + i for i in diff])
                               )(params, *jargs)
    targs = [torch.from_numpy(arrays[k]).requires_grad_(k not in NO_GRAD)
             for k in keys]
    got = _leaves(pmod(*targs))
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(got, cts)).backward()

    def close(g, w, what):
        w = np.asarray(w)
        err = np.abs(to_np(g) - w).max()
        assert err <= 1e-5 * max(np.abs(w).max(), 1e-6), (what, err)

    for i, w in zip(diff, want_x):
        close(targs[i].grad, w, keys[i])
    flat = weights.flatten_tree(want_p)
    grads = {n: p.grad for n, p in pmod.named_parameters()}
    assert set(flat) == {n.replace(".", "/") for n in grads}
    for n, g in grads.items():
        close(g, flat[n.replace(".", "/")], n)


# ------------------------------------------------- Dice and SoftAttention


def test_dice_matches_jax():
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 6, 8) * 2 + 0.5).astype(np.float32)
    jmod = JaxDice()
    params = perturb(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))[
        "params"], rng)
    pmod = Dice(8, CPU)
    weights.from_flax(pmod, params)
    np.testing.assert_allclose(
        to_np(pmod(torch.from_numpy(x))),
        np.asarray(jmod.apply({"params": params}, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_fcn_net_with_dice_matches_flax(train):
    rng = np.random.RandomState(4 + train)
    x = rng.randn(6, 5, 7).astype(np.float32)
    jmod = JaxFcnNet((8, 4), ("dice", "dice"), enable_bn=True, out_dim=1)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), train=True)
    params = perturb(variables["params"], rng)
    stats = perturb(variables["batch_stats"], rng)
    pmod = FcnNet(7, (8, 4), ("dice", "dice"),
                  get_initializer("tnormal", 0.01), torch.Generator(), CPU,
                  enable_bn=True, out_dim=1)
    assert {n for n, _ in pmod.named_parameters()} >= {"dice_0.alpha",
                                                       "dice_1.alpha"}
    weights.from_flax(pmod, params, stats)
    pmod.train(train)
    want = jmod.apply({"params": params, "batch_stats": stats},
                      jnp.asarray(x), train=train,
                      mutable=["batch_stats"])[0]
    np.testing.assert_allclose(to_np(pmod(torch.from_numpy(x))),
                               np.asarray(want), **TOL)


def test_soft_attention_matches_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(4, 7, 12).astype(np.float32)
    jmod = JaxSoftAttention(12)
    params = perturb(jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))[
        "params"], rng)
    pmod = SoftAttention(12, 12, get_initializer("tnormal", 0.01),
                         torch.Generator(), CPU)
    weights.from_flax(pmod, params)
    np.testing.assert_allclose(
        to_np(pmod(torch.from_numpy(x))),
        np.asarray(jmod.apply({"params": params}, jnp.asarray(x))), **TOL)
