"""The port's recurrence (K2's plain version) and FusedCLSREncoder.

`scan_reference` must match the JAX TPU kernel run in interpret mode,
`pallas_scan.fused_scan(..., 8, True)`, and JAX's `_scan_reference`; the
K2 wrapper on CPU tensors computes it without a launch.  The port's
FusedCLSREncoder must match the flax one, with the kernel flag on and
off.  Tolerance 1e-5 in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsr_tpu.ops import pallas_scan as jps
from clsr_tpu.ops.fused_clsr import FusedCLSREncoder as JaxEncoder
from clsr_tpu_torch import weights
from clsr_tpu_torch.ops import fused_scan as fs
from clsr_tpu_torch.ops.fused_clsr import FusedCLSREncoder

from test_torch_common import TOL, perturb, to_np

B, L, D, U, H = 3, 8, 12, 10, 12


def _scan_inputs(seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: (rng.randn(*s) * 0.7).astype(np.float32)
    lengths = np.array([L, 3, 1])
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
    return [f(B, L, 2 * U), f(B, L, U), f(B, L, 4 * H), f(B, L, H),
            f(B, L, H), f(B, L, H), f(B, L, 2 * H), f(B, L, H), mask,
            f(B, U), f(U, 2 * U), f(U, U), f(H, 4 * H), f(H, 2 * H),
            f(H, H)]


def test_scan_reference_matches_jax_kernel_and_reference():
    args = _scan_inputs(0)
    kernel = jps.fused_scan(*map(jnp.asarray, args), 8, True)
    ref = jps._scan_reference(*map(jnp.asarray, args))
    before = fs.fused_scan.launches
    got = fs.fused_scan(*map(torch.from_numpy, args))
    assert fs.fused_scan.launches == before          # CPU: no launch
    plain = fs.scan_reference(*map(torch.from_numpy, args))
    for g, p, k, r in zip(got, plain, kernel, ref):
        np.testing.assert_allclose(to_np(g), np.asarray(k), **TOL)
        np.testing.assert_allclose(to_np(p), np.asarray(r), **TOL)
    # masked steps carry through and emit zeros
    assert np.all(to_np(got[1])[2, 1:] == 0.0)


@pytest.mark.parametrize("kind", ["holes", "all_masked_row"])
def test_scan_reference_matches_jax_kernel_on_masks_with_holes(kind):
    """Masks that are not prefixes: holes in every row but row 1, and
    row 0 masked whole (`holes`), or a fully masked row beside two full
    ones (`all_masked_row`).  Masked steps emit zeros and carry every
    carry through, into the next step's saved carry."""
    args = _scan_inputs(2)
    rng = np.random.RandomState(3)
    if kind == "holes":
        mask = (rng.rand(B, L) > 0.4).astype(np.float32)
        mask[0], mask[1] = 0.0, 1.0
    else:
        mask = np.ones((B, L), np.float32)
        mask[1] = 0.0
    args[8] = mask
    kernel = jps.fused_scan(*map(jnp.asarray, args), 8, True)
    ref = jps._scan_reference(*map(jnp.asarray, args))
    targs = list(map(torch.from_numpy, args))
    got = fs.fused_scan(*targs)
    *plain, carries = fs.scan_forward_reference(*targs)
    for g, p, k, r in zip(got, plain, kernel, ref):
        np.testing.assert_allclose(to_np(g), np.asarray(k), **TOL)
        np.testing.assert_allclose(to_np(p), np.asarray(r), **TOL)
    outs, carries = to_np(got[1]), to_np(carries)
    assert np.all(outs[mask == 0] == 0.0)
    b, t = np.nonzero(mask[:, :-1] == 0)
    np.testing.assert_array_equal(carries[b, t + 1], carries[b, t])


@pytest.mark.parametrize("B", [0, 1, 8, 64, 132, 133, 264, 265, 400, 500,
                               528, 529, 1000])
@pytest.mark.parametrize("n_sm", [132, 114, 8])
def test_forward_rows_per_block_covers_every_row_in_one_wave(B, n_sm):
    """The row groups of either kernel cover each row once; the fewest
    rows a block that leave one group per SM, so both train batches on
    132 SMs (B = 400 and 500: 4 rows a block, 300 and 375 blocks) are one
    wave of the kernels' resident blocks; the most rows where no choice
    fits (B = 529)."""
    rows = fs.rows_per_block(B, n_sm)
    assert rows in fs.ROWS
    groups = -(-B // rows)
    covered = [g * rows + r for g in range(groups) for r in range(rows)
               if g * rows + r < B]
    assert covered == list(range(B))
    one_wave = 3 * groups <= fs.BLOCKS_PER_SM * n_sm
    assert one_wave == (-(-B // fs.ROWS[-1]) <= n_sm)
    assert all(-(-B // r) > n_sm for r in fs.ROWS if r < rows)
    if n_sm == 132:
        assert rows == (1 if B <= 132 else 4)
        assert one_wave == (B <= 528)
    if (B, n_sm) == (400, 132):
        assert 3 * groups == 300
    if (B, n_sm) == (500, 132):
        assert 3 * groups == 375


@pytest.mark.parametrize("U, H, ok", [(1, 1, True), (16, 40, True),
                                      (64, 64, True), (65, 40, False),
                                      (40, 65, False), (0, 40, False)])
def test_forward_width_check(U, H, ok):
    """Every U and H from 1 to 64 runs the forward kernel; a width past
    it raises ValueError naming the limit (checked without a launch)."""
    if ok:
        fs.check_forward_widths(U, H)
    else:
        with pytest.raises(ValueError, match=str(fs.FORWARD_MAX_WIDTH)):
            fs.check_forward_widths(U, H)


@pytest.fixture(scope="module")
def encoders():
    rng = np.random.RandomState(1)
    hist = rng.randn(B, L, D).astype(np.float32)
    t_last = rng.rand(B, L).astype(np.float32) * 3
    t_now = rng.rand(B, L).astype(np.float32) * 3
    mask = (np.arange(L)[None] < np.array([[2], [L], [5]])).astype(
        np.float32)
    user_short = rng.randn(B, U).astype(np.float32)
    inputs = (hist, t_last, t_now, mask, user_short)
    jmod = JaxEncoder(U, H)
    params = perturb(jmod.init(jax.random.PRNGKey(2), *inputs)["params"],
                     rng)
    return inputs, jmod, params


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("cells", [(True, True), (False, True),
                                   (True, False)])
def test_encoder_matches_flax(encoders, use_pallas, cells):
    inputs, _, params = encoders
    evolve, causal2 = cells
    jmod = JaxEncoder(U, H, interest_evolve=evolve,
                      predict_long_short=causal2)
    want = jmod.apply({"params": params}, *inputs)
    pmod = FusedCLSREncoder(D, U, H, torch.Generator(), torch.device("cpu"),
                            interest_evolve=evolve,
                            predict_long_short=causal2,
                            use_pallas=use_pallas)
    weights.from_flax(pmod, params)
    with torch.no_grad():
        got = pmod(*map(torch.from_numpy, inputs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), **TOL)
