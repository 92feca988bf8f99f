"""The port's long-context attention against the JAX package's.

`LongTargetAttention` (ops/long_context.py) against JAX's
(clsr_tpu/ops/long_context.py) on the same numpy inputs and flax
parameters (weights.from_flax): the output and the gradients of the
query, the keys and every parameter to 1e-5, at block sizes 1, 3, 4, L
and past L (L = 11, so the tail block is padded), with a 2-D query
(G = 1) and G = 5, one row fully masked (where the blocked function
weighs the padded tail too, unlike TargetAttention), and under bf16
compute at the port's bf16 tolerance.  Beside it: the port's blocked
function against its own TargetAttention (BN off) on rows with a valid
position; CLSR with `attention_block_size` (the JAX side is
tests/test_long_context.py:80-113): one train step against JAX's (loss
parts and clipped gradients, K2's plain versions on and off) and the
eval step; the flax subtree through from_flax / to_flax; the scoring
service against JAX's; K1 and K3 never run on the path; the sequence-
parallel merge refuses JAX's axis name, naming item 10b.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import clsr_tpu.serving as jax_serving
from clsr_tpu.data.vocab import Vocab as JaxVocab
from clsr_tpu.ops.long_context import LongTargetAttention as JaxLong
from clsr_tpu.serving import ScoreRequest as JaxRequest
from clsr_tpu.serving import ScoringService as JaxService
from clsr_tpu.training.losses import total_loss as jax_total_loss
from clsr_tpu.training.state import create_train_state as jax_create_state
from clsr_tpu.training.steps import make_eval_step_fn as jax_eval_fn
from clsr_tpu_torch import weights
from clsr_tpu_torch.data.vocab import Vocab
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.ops import fused_attention as fa
from clsr_tpu_torch.ops import fused_train_attention as fta
from clsr_tpu_torch.ops.attention import TargetAttention
from clsr_tpu_torch.ops.initializers import get_initializer
from clsr_tpu_torch.ops.long_context import LongTargetAttention
from clsr_tpu_torch.serving import ScoreRequest, ScoringService
from clsr_tpu_torch.training.losses import total_loss
from clsr_tpu_torch.training.steps import make_eval_step_fn

from test_torch_common import (N_CATES, N_ITEMS, N_USERS, TOL, jax_batch,
                               jax_clsr, jax_state, numpy_batch, perturb,
                               port_batch, port_cfg, small_jax_cfg, to_np)

B, L, DK, DQ = 4, 11, 12, 20
LAYERS = (8, 4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _inputs(G, seed=0):
    rng = np.random.RandomState(seed)
    query = rng.randn(B, G, DQ).astype(np.float32)
    keys = rng.randn(B, L, DK).astype(np.float32)
    lengths = np.array([L, 4, 0, 7])                 # row 2 fully masked
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
    cot = rng.randn(B, G, DK).astype(np.float32)
    return query, keys, mask, cot


def _jax_module(block, dtype=None):
    mod = JaxLong(LAYERS, block_size=block, dtype=dtype)
    q, k, m, _ = _inputs(5)
    params = mod.init(jax.random.PRNGKey(3), jnp.asarray(q),
                      jnp.asarray(k), jnp.asarray(m))["params"]
    return mod, perturb(params, np.random.RandomState(4))


def _port_module(block, params, dtype=None):
    g = torch.Generator().manual_seed(0)
    mod = LongTargetAttention(DQ, DK, LAYERS, get_initializer(
        "tnormal", 0.01), g, torch.device("cpu"), block_size=block,
        dtype=dtype)
    weights.from_flax(mod, params)
    return mod


def _jax_out_and_grads(mod, params, query, keys, mask, cot):
    """JAX's output and its VJP with `cot` (parameters, query, keys),
    in one jitted program."""
    @jax.jit
    def run(p, q, k):
        out, vjp = jax.vjp(lambda p_, q_, k_: mod.apply(
            {"params": p_}, q_, k_, jnp.asarray(mask)), p, q, k)
        return out, vjp(jnp.asarray(cot))
    return run(params, jnp.asarray(query), jnp.asarray(keys))


def _port_out_and_grads(mod, query, keys, mask, cot):
    q = torch.from_numpy(query).requires_grad_()
    k = torch.from_numpy(keys).requires_grad_()
    out = mod(q, k, torch.from_numpy(mask))
    (out * torch.from_numpy(cot)).sum().backward()
    return out, q.grad, k.grad


@pytest.mark.parametrize("block, G", [(1, 5), (3, 5), (4, 5), (L, 5),
                                      (L + 5, 5), (3, 1), (L + 5, 1)])
def test_long_attention_matches_jax(block, G):
    query, keys, mask, cot = _inputs(5)
    if G == 1:                      # a 2-D query, squeezed as JAX does
        query, cot = query[:, 0], cot[:, 0]
    mod, params = _jax_module(block)
    want, (gp, gq, gk) = _jax_out_and_grads(mod, params, query, keys,
                                            mask, cot)
    port = _port_module(block, params)
    got, q_grad, k_grad = _port_out_and_grads(port, query, keys, mask, cot)
    assert got.shape == want.shape
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(to_np(q_grad), np.asarray(gq), **TOL)
    np.testing.assert_allclose(to_np(k_grad), np.asarray(gk), **TOL)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(to_np(p.grad), np.asarray(gp[name]),
                                   **TOL, err_msg=name)


@pytest.mark.parametrize("G", [1, 5])
def test_long_attention_bf16_compute_matches_jax(G):
    query, keys, mask, cot = _inputs(5, seed=1)
    if G == 1:
        query, cot = query[:, 0], cot[:, 0]
    mod, params = _jax_module(4, dtype=jnp.bfloat16)
    want, (gp, gq, gk) = _jax_out_and_grads(mod, params, query, keys,
                                            mask, cot)
    port = _port_module(4, params, dtype=torch.bfloat16)
    got, q_grad, k_grad = _port_out_and_grads(port, query, keys, mask, cot)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(want), **BF16_TOL)
    for g, w in ((q_grad, gq), (k_grad, gk)):
        scale = np.abs(np.asarray(w)).max()
        np.testing.assert_allclose(to_np(g) / scale, np.asarray(w) / scale,
                                   **BF16_TOL)


def test_blocked_equals_unblocked_on_rows_with_history():
    """The port's blocked function against its own TargetAttention (BN
    off, the same parameters): equal on rows with a valid position; on
    the fully masked row the blocked one weighs the padded tail too."""
    query, keys, mask, cot = _inputs(5, seed=2)
    g = torch.Generator().manual_seed(0)
    init = get_initializer("tnormal", 0.3)
    full = TargetAttention(DQ, DK, LAYERS, ("relu",), init, g,
                           torch.device("cpu"))
    long = LongTargetAttention(DQ, DK, LAYERS, init, g, torch.device("cpu"),
                               block_size=3)
    fcn = full.att_fcn
    with torch.no_grad():
        long.attention_mat.copy_(full.attention_mat)
        long.w_nn_layer0_kernel.copy_(fcn.w_nn_layer0.kernel)
        long.w_nn_layer0_bias.copy_(fcn.w_nn_layer0.bias)
        long.w_nn_layer1_kernel.copy_(fcn.w_nn_layer1.weight.t())
        long.w_nn_layer1_bias.copy_(fcn.w_nn_layer1.bias)
        long.w_nn_output_kernel.copy_(fcn.w_nn_output.weight.t())
        long.w_nn_output_bias.copy_(fcn.w_nn_output.bias)
    args = [torch.from_numpy(a) for a in (query, keys, mask)]
    want, got = full(*args), long(*args)
    rows = [0, 1, 3]
    torch.testing.assert_close(got[rows], want[rows], **TOL)
    assert not torch.allclose(got[2], want[2], **TOL)
    padded = torch.cat([args[1][2], torch.zeros(1, DK)])   # 12 = 4 x 3
    torch.testing.assert_close(got[2], padded.mean(0).expand(5, DK), **TOL)


def test_sequence_parallel_merge_names_item_10():
    """The merge is ported (item 10b; tests/test_torch_mesh_resident.py
    runs it over 4 ranks): its axis is a process group, and JAX's axis
    name is refused, naming the item."""
    query, keys, mask, _ = _inputs(5)
    mod = LongTargetAttention(DQ, DK, LAYERS, get_initializer("tnormal",
                                                              0.1),
                              torch.Generator(), torch.device("cpu"))
    with pytest.raises(TypeError, match="process group.*item 10b\\b"):
        mod(*(torch.from_numpy(a) for a in (query, keys, mask)),
            axis_name="seq")


# ------------------------------------------------------------- CLSR

_STEP_CFG = dict(need_sample=False, train_num_ngs=4, embed_l2=1e-4,
                 layer_l2=1e-4, contrastive_length_threshold=2,
                 max_grad_norm=0.5, enable_bn=False, attention_block_size=3)


def _clsr_batch():
    b = numpy_batch(np.random.RandomState(10), 4, 5, 7,
                    lengths=[7, 3, 5, 1])
    b["labels"][:, 0] = 1.0
    return b


@pytest.fixture(scope="module")
def jax_long_clsr():
    jcfg = small_jax_cfg(**_STEP_CFG)
    model, params, stats = jax_clsr(jcfg)
    batch = jax_batch(_clsr_batch())

    def loss_fn(p):
        logits, aux = model.apply({"params": p, "batch_stats": stats},
                                  batch, train=True)
        parts = jax_total_loss(jcfg, logits, aux, batch, p)
        return parts.loss, parts

    (_, parts), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    return jcfg, model, params, stats, parts, flatten_dict(grads, sep="/")


def _port_clsr(jcfg, params, stats, **kw):
    cfg = port_cfg(jcfg, **kw)
    model = get_model_class("clsr")(cfg, N_USERS, N_ITEMS, N_CATES,
                                    device="cpu")
    weights.from_flax(model, params, stats)
    return cfg, model


def test_clsr_long_context_params_through_from_flax(jax_long_clsr):
    jcfg, _, params, stats, _, _ = jax_long_clsr
    _, model = _port_clsr(jcfg, params, stats)
    assert isinstance(model.long_term_att, LongTargetAttention)
    assert isinstance(model.short_term_att, LongTargetAttention)
    got, _ = weights.to_flax(model)
    want = flatten_dict(params, sep="/")
    flat = flatten_dict(got, sep="/")
    assert set(flat) == set(want)
    for site in ("long_term_att", "short_term_att"):
        assert {k for k in want if k.startswith(site + "/")} == {
            f"{site}/{n}" for n in (
                "attention_mat", "w_nn_layer0_kernel", "w_nn_layer0_bias",
                "w_nn_layer1_kernel", "w_nn_layer1_bias",
                "w_nn_output_kernel", "w_nn_output_bias")}
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], np.asarray(v), err_msg=k)


@pytest.mark.parametrize("use_pallas_scan", [False, True])
def test_clsr_long_context_train_step_matches_jax(jax_long_clsr,
                                                  use_pallas_scan,
                                                  monkeypatch):
    jcfg, _, params, stats, want_parts, want_grads = jax_long_clsr
    # K1 and K3 (their plain versions on the CPU) must not run here
    for mod, name in ((fa, "fused_eval_attention"),
                      (fta, "fused_train_attention")):
        monkeypatch.setattr(mod, name, _refuse)
    cfg, model = _port_clsr(jcfg, params, stats,
                            use_pallas_scan=use_pallas_scan,
                            use_pallas_train_attention="on",
                            use_pallas_eval_attention="on")
    model.train()
    batch = port_batch(_clsr_batch())
    logits, aux = model(batch, generator=torch.Generator().manual_seed(0))
    parts = total_loss(cfg, logits, aux, batch, model)
    parts.loss.backward()
    for field in dataclasses.fields(parts):
        np.testing.assert_allclose(to_np(getattr(parts, field.name)),
                                   np.asarray(getattr(want_parts,
                                                      field.name)),
                                   **TOL, err_msg=field.name)
    params_by_name = dict(model.named_parameters())
    for name, (collection, flax, transpose) in weights.flax_names(
            model).items():
        g = params_by_name[name].grad
        g = to_np(g.t() if transpose else g)
        np.testing.assert_allclose(g, np.asarray(want_grads[flax]),
                                   rtol=1e-5, atol=1e-6, err_msg=flax)


def _refuse(*a, **kw):
    raise AssertionError("a K1 / K3 scorer ran on the long-context path")


@pytest.mark.parametrize("use_pallas_scan", [False, True])
def test_clsr_long_context_eval_step_matches_jax(jax_long_clsr,
                                                 use_pallas_scan,
                                                 monkeypatch):
    jcfg, model, params, stats, _, _ = jax_long_clsr
    for mod, name in ((fa, "fused_eval_attention"),
                      (fta, "fused_train_attention")):
        monkeypatch.setattr(mod, name, _refuse)
    arrays = numpy_batch(np.random.RandomState(11), 5, 9, 7,
                         lengths=[7, 2, 0, 6, 1])
    want_preds, want_alpha = jax.jit(
        lambda p, b: jax_eval_fn(model, jcfg)(jax_state(model, p, stats),
                                              b))(params, jax_batch(arrays))
    cfg, pmodel = _port_clsr(jcfg, params, stats,
                             use_pallas_scan=use_pallas_scan,
                             use_pallas_eval_attention="on")
    preds, alpha = make_eval_step_fn(cfg)(pmodel, port_batch(arrays))
    np.testing.assert_allclose(to_np(preds), np.asarray(want_preds), **TOL)
    np.testing.assert_allclose(to_np(alpha), np.asarray(want_alpha), **TOL)


SVC_ITEMS, SVC_CATES, SVC_USERS = 30, 6, 10
_MAPS = ({f"u{i}": i for i in range(SVC_USERS)},
         {f"i{i}": i for i in range(SVC_ITEMS)},
         {f"c{i}": i for i in range(SVC_CATES)})


def _request(cls, rng, n_hist, n_cands, t0=1_500_600_000):
    hist = rng.randint(1, SVC_ITEMS + 5, n_hist)
    cands = rng.randint(1, SVC_ITEMS, n_cands)
    return cls(user=f"u{rng.randint(0, SVC_USERS)}",
               hist_items=[f"i{i}" for i in hist],
               hist_cates=[f"c{i % SVC_CATES}" for i in hist],
               hist_times=sorted(t0 - rng.randint(60, 10 ** 6, n_hist)),
               current_time=t0, cand_items=[f"i{c}" for c in cands],
               cand_cates=[f"c{c % SVC_CATES}" for c in cands])


def test_scoring_service_serves_long_context_as_jax(monkeypatch):
    """A long-context CLSR served by both services: the batch bucket of
    4 pads the second dispatch of 3 requests with a fully masked row
    (one bucket: JAX compiles one program; its service's state is
    created with the model's init jitted, the same values in a third of
    the time)."""
    def jitted_init(model, cfg, sample):
        fast = types.SimpleNamespace(
            init=jax.jit(model.init, static_argnames="train"),
            apply=model.apply)
        return jax_create_state(fast, cfg, sample)
    monkeypatch.setattr(jax_serving, "create_train_state", jitted_init)
    jcfg = small_jax_cfg(seed=11, enable_bn=False, attention_block_size=4)
    kw = dict(batch_buckets=(4,), cand_buckets=(16,))
    jsvc = JaxService(jcfg, SVC_USERS, SVC_ITEMS, SVC_CATES,
                      *(JaxVocab(m) for m in _MAPS), **kw)
    params = perturb(jsvc.state.params, np.random.RandomState(0))
    jsvc.state = jsvc.state.replace(params=params)
    psvc = ScoringService(port_cfg(jcfg), SVC_USERS, SVC_ITEMS, SVC_CATES,
                          *(Vocab(m) for m in _MAPS), device="cpu", **kw)
    weights.from_flax(psvc.model, params, {})
    spec = [(3, 5), (12, 9), (1, 16), (7, 8), (2, 1), (9, 12), (4, 3)]
    want = jsvc.score([_request(JaxRequest, np.random.RandomState(5 + i),
                                *hc) for i, hc in enumerate(spec)])
    got = psvc.score([_request(ScoreRequest, np.random.RandomState(5 + i),
                               *hc) for i, hc in enumerate(spec)])
    assert [len(s) for s in got] == [c for _, c in spec]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
