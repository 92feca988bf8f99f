"""K2's hand-derived backward (the recurrence's) against the JAX package.

Same numpy inputs on both sides, JAX on the CPU, B = 6, L = 9, U = 10,
H = 12, rows of lengths 9, 3, 1, 0 (all masked), 5 and 9:

  * `scan_forward_reference` returns `scan_reference`'s outputs bit for
    bit, and its carries are each step's input carry: a step from
    carries[:, t] gives carries[:, t + 1], and JAX's `_bd_scan_fwd`
    (clsr_tpu/ops/fused_clsr.py:105-111) saves the same ones, to 1e-5;
  * `scan_backward_reference` (no autograd) equals `jax.vjp` of
    `_scan_reference` to 1e-5 on every input and weight gradient, for
    each subset of used outputs (None cotangents count as zero), and
    JAX's own hand-shaped backward, `jax.vjp` of `_bd_scan`;
  * masked steps pass the adjoint through and get zero gradients;
  * the `fused_scan` Function on CPU tensors runs the plain versions
    (no launch of either kernel) and the port's FusedCLSREncoder with the
    kernel flag on gives JAX's `FusedCLSREncoder(custom_vjp_scan=True)`
    parameter gradients to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clsr_tpu.ops import fused_clsr as jfc
from clsr_tpu.ops import pallas_scan as jps
from clsr_tpu_torch import weights
from clsr_tpu_torch.ops import fused_scan as fs
from clsr_tpu_torch.ops.fused_clsr import FusedCLSREncoder

from test_torch_common import TOL, perturb, to_np

B, L, U, H = 6, 9, 10, 12
LENGTHS = (9, 3, 1, 0, 5, 9)


def _inputs(seed):
    """(the 15 recurrence inputs, the 3 output cotangents) as numpy."""
    rng = np.random.RandomState(seed)
    f = lambda *s: (rng.randn(*s) * 0.7).astype(np.float32)
    w = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)
    mask = (np.arange(L)[None] < np.array(LENGTHS)[:, None]).astype(
        np.float32)
    args = [f(B, L, 2 * U), f(B, L, U), f(B, L, 4 * H), f(B, L, H),
            f(B, L, H), f(B, L, H), f(B, L, 2 * H), f(B, L, H), mask,
            f(B, U), w(U, 2 * U), w(U, U), w(H, 4 * H), w(H, 2 * H),
            w(H, H)]
    return args, [f(B, U), f(B, L, H), f(B, H)]


def _torch(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _jax_bd_scan_layout(args):
    """`_bd_scan`'s arguments from the 15: one concatenated time-major
    input, the carry, and the block-diagonal Wg [U+2H, 2U+6H] and
    Wc [U+H, U+H] (fused_clsr.py:374-384, 433-435); biases zero (the
    candidate biases are folded into xc1/xc2)."""
    (xg1, xc1, xw, tn, tl, ot, xg2, xc2, mask, ushort,
     whg1, whc1, wh4, whg2, whc2) = map(jnp.asarray, args)
    cat = jnp.concatenate([xg1, xw, xg2, xc1, xc2, tn, tl, ot,
                           mask[..., None]], axis=-1)
    zero = jnp.zeros((B, H), jnp.float32)
    Wg = jnp.zeros((U + 2 * H, 2 * U + 6 * H), jnp.float32)
    Wg = Wg.at[:U, :2 * U].set(whg1).at[U:U + H, 2 * U:2 * U + 4 * H].set(
        wh4).at[U + H:, 2 * U + 4 * H:].set(whg2)
    Wc = jnp.zeros((U + H, U + H), jnp.float32)
    Wc = Wc.at[:U, :U].set(whc1).at[U:, U:].set(whc2)
    return (jnp.moveaxis(cat, 1, 0), (ushort, zero, zero, zero), Wg, Wc,
            jnp.zeros(U), jnp.zeros(H))


def test_scan_forward_reference_saves_each_step_input_carry():
    args, _ = _inputs(1)
    t = _torch(args)
    h1f, outs, h2f, carries = fs.scan_forward_reference(*t)
    for got, want in zip((h1f, outs, h2f), fs.scan_reference(*t)):
        assert torch.equal(got, want)
    assert carries.shape == (B, L, U + 3 * H)
    torch.testing.assert_close(carries[:, 0, :U], t[9], rtol=0, atol=0)
    assert not carries[:, 0, U:].any()
    for step in range(L):     # a step from carries[:, t] -> t + 1
        new, _ = fs._step(step, carries[:, step].split([U, H, H, H], -1), t)
        new = torch.cat(new, -1)
        want = (carries[:, step + 1] if step + 1 < L else
                torch.cat([h1f, new[:, U:U + 2 * H], h2f], -1))
        assert torch.equal(new, want), step
    xs, carry0, Wg, Wc, b1, b2 = _jax_bd_scan_layout(args)
    _, (_, want, *_) = jfc._bd_scan_fwd(U, H, None, xs, carry0, Wg, Wc, b1,
                                        b2)
    np.testing.assert_allclose(to_np(carries), np.moveaxis(np.asarray(want),
                                                           0, 1), **TOL)


@pytest.mark.parametrize("used", [(0, 1, 2), (1,), (0,), (2,), (0, 2)],
                         ids=["all", "outs", "h1", "h2", "h1_h2"])
def test_scan_backward_reference_matches_jax_vjp(used):
    args, cts = _inputs(2)
    ct = [c if i in used else np.zeros_like(c) for i, c in enumerate(cts)]
    _, vjp = jax.vjp(jps._scan_reference, *map(jnp.asarray, args))
    want = vjp(tuple(map(jnp.asarray, ct)))
    t = _torch(args)
    *_, carries = fs.scan_forward_reference(*t)
    got = fs.scan_backward_reference(
        t, carries, *[torch.from_numpy(c) if i in used else None
                      for i, c in enumerate(cts)])
    assert len(got) == 15 and got[8] is None
    for i, (g, w) in enumerate(zip(got, want)):
        if i != 8:
            np.testing.assert_allclose(to_np(g), np.asarray(w), **TOL,
                                       err_msg=f"input {i}")


def test_scan_backward_reference_matches_jax_bd_scan():
    """JAX's hand-shaped backward (`_bd_scan`, the design the kernel
    follows) gives the same gradients, its weight gradients as blocks of
    the block-diagonal Wg and Wc."""
    args, cts = _inputs(3)
    xs, carry0, Wg, Wc, b1, b2 = _jax_bd_scan_layout(args)
    _, vjp = jax.vjp(lambda *a: jfc._bd_scan(U, H, None, *a), xs, carry0,
                     Wg, Wc, b1, b2)
    dxs, dcarry0, dWg, dWc, _, _ = vjp((jnp.asarray(cts[0]),
                                         jnp.asarray(cts[2]),
                                         jnp.moveaxis(jnp.asarray(cts[1]), 1,
                                                      0)))
    dxs = np.moveaxis(np.asarray(dxs), 0, 1)
    GW = 2 * U + 6 * H
    want = np.split(dxs[..., :-1], np.cumsum(
        [2 * U, 4 * H, 2 * H, U, H, H, H])[:7], axis=-1)
    dxg1, dxw, dxg2, dxc1, dxc2, dtn, dtl, dot = want
    dWg, dWc = np.asarray(dWg), np.asarray(dWc)
    want = [dxg1, dxc1, dxw, dtn, dtl, dot, dxg2, dxc2, None,
            np.asarray(dcarry0[0]), dWg[:U, :2 * U], dWc[:U, :U],
            dWg[U:U + H, 2 * U:2 * U + 4 * H], dWg[U + H:, 2 * U + 4 * H:GW],
            dWc[U:, U:]]
    t = _torch(args)
    *_, carries = fs.scan_forward_reference(*t)
    got = fs.scan_backward_reference(t, carries, *_torch(cts))
    for i, (g, w) in enumerate(zip(got, want)):
        if w is not None:
            np.testing.assert_allclose(to_np(g), w, **TOL,
                                       err_msg=f"input {i}")


def test_masked_steps_pass_the_adjoint_through():
    args, cts = _inputs(4)
    t = _torch(args)
    *_, carries = fs.scan_forward_reference(*t)
    got = fs.scan_backward_reference(t, carries, *_torch(cts))
    for b, n in enumerate(LENGTHS):
        for i in range(8):
            assert not got[i][b, n:].any(), (b, i)
    # the all-masked row: user_short's gradient is h1_final's cotangent
    assert torch.equal(got[9][3], t[9].new_tensor(cts[0][3]))


def test_fused_scan_function_on_cpu_runs_the_plain_versions():
    args, cts = _inputs(5)
    t = [torch.from_numpy(a).requires_grad_(i not in (8, 11))
         for i, a in enumerate(args)]
    before = (fs.fused_scan.launches, fs.scan_backward.launches)
    outs = fs.fused_scan(*t)
    sum((o * c).sum() for o, c in zip(outs, _torch(cts))).backward()
    assert (fs.fused_scan.launches, fs.scan_backward.launches) == before
    assert t[8].grad is None and t[11].grad is None
    *_, carries = fs.scan_forward_reference(*(x.detach() for x in t))
    want = fs.scan_backward_reference([x.detach() for x in t], carries,
                                      *_torch(cts))
    for i, x in enumerate(t):
        if i not in (8, 11):
            torch.testing.assert_close(x.grad, want[i], rtol=0, atol=0)


def test_carries_kept_only_where_a_backward_can_follow(monkeypatch):
    """Under no_grad (serving) the forward keeps no carries, even when the
    weights require gradients."""
    args, _ = _inputs(6)
    t = [torch.from_numpy(a).requires_grad_(i >= 10)
         for i, a in enumerate(args)]
    kept = []
    plain = fs.scan_forward_reference
    monkeypatch.setattr(fs, "scan_forward_reference",
                        lambda *a: kept.append(1) or plain(*a))
    with torch.no_grad():
        outs = fs.fused_scan(*t)
    assert not kept and not outs[1].requires_grad
    fs.fused_scan(*t)
    assert kept == [1]


def test_encoder_gradients_match_jax_custom_vjp_scan():
    """The port's FusedCLSREncoder with the kernel flag (on CPU: the
    Function's plain forward and backward) against JAX's encoder on its
    hand-shaped backward `_bd_scan`: every parameter's gradient."""
    D = 12
    rng = np.random.RandomState(6)
    mask = (np.arange(L)[None] < np.array(LENGTHS)[:, None]).astype(
        np.float32)
    inputs = (rng.randn(B, L, D).astype(np.float32),
              rng.rand(B, L).astype(np.float32) * 3,
              rng.rand(B, L).astype(np.float32) * 3, mask,
              rng.randn(B, U).astype(np.float32))
    cts = [rng.randn(B, U).astype(np.float32),
           rng.randn(B, L, H).astype(np.float32),
           rng.randn(B, H).astype(np.float32)]
    jmod = jfc.FusedCLSREncoder(U, H, custom_vjp_scan=True)
    params = perturb(jmod.init(jax.random.PRNGKey(7), *inputs)["params"],
                     rng)

    def loss(p):
        outs = jmod.apply({"params": p}, *inputs)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cts))

    want = weights.flatten_tree(jax.grad(loss)(params))
    pmod = FusedCLSREncoder(D, U, H, torch.Generator(), torch.device("cpu"),
                            use_pallas=True)
    weights.from_flax(pmod, params)
    outs = pmod(*_torch(inputs))
    sum((o * c).sum() for o, c in zip(outs, _torch(cts))).backward()
    names = weights.flax_names(pmod)
    assert len(names) == len(want)
    for name, p in pmod.named_parameters():
        _, flax, transpose = names[name]
        g = p.grad.t() if transpose else p.grad
        np.testing.assert_allclose(to_np(g), np.asarray(want[flax]), **TOL,
                                   err_msg=flax)
