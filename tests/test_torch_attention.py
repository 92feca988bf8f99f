"""The port's TargetAttention and the K1 wrapper against clsr_tpu.

TargetAttention (BN on and off) must match JAX's plain path and JAX's
Pallas scorer path, run as tests/test_pallas_attention.py runs it
(`use_eval_attention(True)`: interpret mode on the CPU).  The plain
version of K1, `eval_scorer_reference`, must match
`fused_eval_attention(..., interpret=True)` on the same folded weights,
including a row whose history is all masked, and at the widths the CUDA
kernel is compiled for with G in {1, 5, 16}.  Tolerance 1e-5 in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsr_tpu.ops import pallas_attention as jpa
from clsr_tpu.ops.attention import TargetAttention as JaxTargetAttention
from clsr_tpu_torch import weights
from clsr_tpu_torch.ops import _build
from clsr_tpu_torch.ops import fused_attention as fa
from clsr_tpu_torch.ops.attention import TargetAttention
from clsr_tpu_torch.ops.initializers import get_initializer

from test_torch_common import TOL, perturb, to_np

B, L, G, DQ, DK = 3, 9, 10, 16, 12


def _inputs(seed, g=G, all_masked_row=False):
    rng = np.random.RandomState(seed)
    keys = rng.randn(B, L, DK).astype(np.float32)
    query = rng.randn(B, g, DQ).astype(np.float32)
    lengths = rng.randint(1, L + 1, B)
    if all_masked_row:
        lengths[-1] = 0
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
    return keys, query, mask


def _modules(enable_bn, seed=0):
    keys, query, mask = _inputs(seed)
    jmod = JaxTargetAttention((8, 4), ("relu", "relu"), enable_bn=enable_bn)
    variables = jmod.init(jax.random.PRNGKey(seed), query, keys, mask)
    rng = np.random.RandomState(seed + 1)
    params = perturb(variables["params"], rng)
    stats = perturb(variables.get("batch_stats", {}), rng)
    pmod = TargetAttention(DQ, DK, (8, 4), ("relu", "relu"),
                           get_initializer("tnormal", 0.01),
                           torch.Generator(), torch.device("cpu"),
                           enable_bn=enable_bn, use_kernel="on").eval()
    weights.from_flax(pmod, params, stats)
    return jmod, {"params": params, "batch_stats": stats}, pmod


@pytest.fixture(scope="module", params=[True, False], ids=["bn", "no_bn"])
def modules(request):
    return (request.param,) + _modules(request.param)


def _port(pmod, query, keys, mask, **kw):
    with torch.no_grad():
        return pmod(torch.from_numpy(query), torch.from_numpy(keys),
                    torch.from_numpy(mask), **kw)


@pytest.mark.parametrize("all_masked_row", [False, True])
def test_target_attention_matches_jax_plain_path(modules, all_masked_row):
    _, jmod, variables, pmod = modules
    keys, query, mask = _inputs(3, all_masked_row=all_masked_row)
    want = jmod.apply(variables, query, keys, mask)
    got = _port(pmod, query, keys, mask)
    assert got.shape == (B, G, DK)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_target_attention_matches_jax_pallas_path(modules):
    _, jmod, variables, pmod = modules
    keys, query, mask = _inputs(4)
    with jpa.use_eval_attention(True):
        want = jmod.apply(variables, query, keys, mask)
    assert pmod.kernel_applies(torch.from_numpy(keys), G, False)
    got = _port(pmod, query, keys, mask)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_single_query_and_weights_match_jax(modules):
    _, jmod, variables, pmod = modules
    keys, query, mask = _inputs(5, g=3)
    want, w_want = jmod.apply(variables, query[:, 0], keys, mask,
                              return_weights=True)
    got, w_got = _port(pmod, query[:, 0], keys, mask, return_weights=True)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(to_np(w_got), np.asarray(w_want), **TOL)
    # below G = 8 the gate keeps the plain path
    assert not pmod.kernel_applies(torch.from_numpy(keys), 7, False)


def test_fold_matches_jax(modules):
    enable_bn, _, variables, pmod = modules
    want = jpa.fold_scorer_params(variables["params"]["att_fcn"],
                                  variables["batch_stats"].get("att_fcn", {}),
                                  DQ, enable_bn)
    got = fa.fold_scorer_params(pmod.att_fcn, DQ, enable_bn)
    for w, g in zip(want, got):
        assert g.is_contiguous()
        np.testing.assert_allclose(to_np(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("bad, err", [
    (torch.zeros(2, 3, device="meta"), ValueError),
    (torch.zeros(2, 3, dtype=torch.float64), TypeError),
    (torch.zeros(3, 2), ValueError),
    (torch.zeros(3, 2).t(), ValueError),
])
def test_kernel_argument_checks_raise(bad, err):
    """What the wrappers check before a launch, short of the card."""
    good = torch.zeros(2, 3)
    _build.check_args(("x", "y"), (good, good), [(2, 3)] * 2,
                      torch.device("cpu"))
    with pytest.raises(err, match="y"):
        _build.check_args(("x", "y"), (good, bad), [(2, 3)] * 2,
                          torch.device("cpu"))


@pytest.mark.parametrize("all_masked_row", [False, True])
def test_scorer_reference_matches_jax_interpret_kernel(modules,
                                                       all_masked_row):
    enable_bn, _, _, pmod = modules
    keys, query, mask = _inputs(6, all_masked_row=all_masked_row)
    kp = np.random.RandomState(7).randn(B, L, DQ).astype(np.float32)
    folded = [to_np(t) for t in fa.fold_scorer_params(pmod.att_fcn, DQ,
                                                       enable_bn)]
    want = jpa.fused_eval_attention(keys, kp, query, mask, *folded,
                                    interpret=True)
    before = fa.fused_eval_attention.launches
    got = fa.fused_eval_attention(
        *(torch.from_numpy(x) for x in [keys, kp, query, mask] + folded))
    assert fa.fused_eval_attention.launches == before   # CPU: no launch
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    if all_masked_row:   # uniform weights over the real L
        np.testing.assert_allclose(to_np(got)[-1],
                                   np.broadcast_to(keys[-1].mean(0),
                                                   (G, DK)), **TOL)


@pytest.mark.parametrize("D", [40, 80])
@pytest.mark.parametrize("g", [1, 5, 16])
def test_scorer_reference_matches_jax_at_kernel_widths(g, D):
    """The plain version of K1 against JAX's interpret-mode kernel at the
    widths the CUDA kernel is compiled for (Dk=40, H0=80, H1=40) and at
    every G its row tiling serves (train 1 and 5, the serving bucket 16):
    folded weights drawn with numpy, a ragged batch of 7 rows, an
    all-masked row and a mask with holes."""
    b, l, dk, h0, h1 = 7, 17, 40, 80, 40
    rng = np.random.RandomState(100 + g + D)
    f = lambda *s, std=1.0: (rng.randn(*s) * std).astype(np.float32)
    lengths = rng.randint(1, l + 1, b)
    lengths[0] = 0
    mask = (np.arange(l)[None] < lengths[:, None]).astype(np.float32)
    mask[1] = rng.rand(l) > 0.4                      # valid, not a prefix
    mask[1, 0] = 1.0
    pos = lambda n: (rng.rand(n) + 0.5).astype(np.float32)
    arrays = [f(b, l, dk), f(b, l, D), f(b, g, D), mask,
              f(D, h0, std=0.2), f(D, h0, std=0.2), f(D, h0, std=0.2),
              pos(h0), f(h0, std=0.3), f(h0, h1, std=0.2), pos(h1),
              f(h1, std=0.3), f(h1, std=0.3)]
    want = jpa.fused_eval_attention(*arrays, interpret=True)
    got = fa.fused_eval_attention(*(torch.from_numpy(x) for x in arrays))
    assert got.shape == (b, g, dk)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
