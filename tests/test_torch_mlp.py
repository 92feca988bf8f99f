"""The port's FcnNet (eval mode, BN) and initializers against clsr_tpu.

FcnNet and its split first layer must give flax's eval-mode outputs to
1e-5 on the same weights; the initializers must draw the distributions
clsr_tpu/ops/initializers.py draws (the numbers differ by design).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsr_tpu.ops.mlp import FcnNet as JaxFcnNet
from clsr_tpu_torch import weights
from clsr_tpu_torch.ops.initializers import (get_initializer,
                                             tf1_glorot_uniform)
from clsr_tpu_torch.ops.mlp import BatchNorm, FcnNet

from test_torch_common import TOL, perturb


def _pair(in_dim, layer_sizes, acts, enable_bn, split, seed):
    rng = np.random.RandomState(seed)
    jmod = JaxFcnNet(layer_sizes, acts, enable_bn=enable_bn, out_dim=1)
    if split:
        kp = jnp.asarray(rng.randn(2, 5, in_dim).astype(np.float32))
        q = jnp.asarray(rng.randn(2, 9, in_dim).astype(np.float32))
        variables = jmod.init(jax.random.PRNGKey(seed), None, train=True,
                              split_parts=(kp, q))
        inputs = (kp, q)
    else:
        x = jnp.asarray(rng.randn(3, 4, in_dim).astype(np.float32))
        variables = jmod.init(jax.random.PRNGKey(seed), x, train=True)
        inputs = (x,)
    params = perturb(variables["params"], rng)
    stats = perturb(variables.get("batch_stats", {}), rng)
    g = torch.Generator().manual_seed(seed)
    pmod = FcnNet(in_dim, layer_sizes, acts, get_initializer("tnormal", .01),
                  g, torch.device("cpu"), enable_bn=enable_bn, out_dim=1,
                  split_first=split).eval()
    weights.from_flax(pmod, params, stats)
    variables = {"params": params, "batch_stats": stats}
    if split:
        want = jmod.apply(variables, None, split_parts=inputs)
        got = pmod(None, split_parts=tuple(torch.from_numpy(np.array(t))
                                           for t in inputs))
    else:
        want = jmod.apply(variables, inputs[0])
        got = pmod(torch.from_numpy(np.array(inputs[0])))
    return np.asarray(want), got.detach().numpy()


@pytest.mark.parametrize("enable_bn", [True, False])
@pytest.mark.parametrize("acts", [("relu",), ("tanh", "sigmoid")])
def test_fcn_net_eval_matches_flax(enable_bn, acts):
    want, got = _pair(11, (10, 6), acts, enable_bn, split=False, seed=1)
    assert got.shape == (3, 4, 1)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("enable_bn", [True, False])
def test_split_first_layer_matches_flax(enable_bn):
    want, got = _pair(6, (8, 4), ("relu",), enable_bn, split=True, seed=2)
    assert got.shape == (2, 5, 9, 1)
    np.testing.assert_allclose(got, want, **TOL)


def test_batch_norm_fold_and_train_mode():
    bn = BatchNorm(5, torch.Generator(), torch.device("cpu")).eval()
    with torch.no_grad():
        for p in (bn.scale, bn.bias, bn.mean):
            p.normal_()
        bn.var.uniform_(0.5, 2.0)
    x, bias = torch.randn(7, 5), torch.randn(5)
    a, c = bn.fold(bias)
    torch.testing.assert_close(a * x + c, bn(x + bias), rtol=1e-5,
                               atol=1e-5)
    bn.train()             # batch statistics, then the running update
    mean, var = bn.mean.clone(), bn.var.clone()
    y = bn(x)
    bm, bv = x.mean(0), x.var(0, unbiased=False)
    torch.testing.assert_close(
        y, (x - bm) * torch.rsqrt(bv + 1e-4) * bn.scale + bn.bias,
        rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(bn.mean, 0.95 * mean + 0.05 * bm)
    torch.testing.assert_close(bn.var, 0.95 * var + 0.05 * bv)


def test_initializers_draw_jax_distributions():
    g = torch.Generator().manual_seed(0)
    t = get_initializer("tnormal", 0.01)(torch.empty(400, 300), g)
    jt = np.asarray(jax.nn.initializers.truncated_normal(0.01)(
        jax.random.PRNGKey(0), (400, 300)))
    assert abs(t.std().item() - jt.std()) < 2e-4
    assert t.abs().max().item() <= 2 * 0.01 + 1e-7
    lim = (6.0 / (2 * 40)) ** 0.5            # rank 1: fan_in = fan_out
    w = tf1_glorot_uniform(torch.empty(40), g)
    assert w.abs().max().item() <= lim
    m = tf1_glorot_uniform(torch.empty(30, 50), g)
    assert m.abs().max().item() <= (6.0 / 80) ** 0.5
    assert m.abs().max().item() > 0.9 * (6.0 / 80) ** 0.5
