"""The port's CLSR eval step against the JAX package's.

Same perturbed weights (carried over by weights.from_flax) and the same
numpy batches: preds and alpha must agree to 1e-5 in f32.  The JAX side
runs `make_eval_step_fn(model, cfg, allow_pallas=True)`, so at G >= 8 its
short-term attention is the Pallas scorer in interpret mode; it keeps
`use_pallas_scan=False` (its recurrence kernel has no CPU mode).  The
port runs its scorer through the kernel wrapper ('on', which on CPU
tensors computes the plain version) and its recurrence both ways.
"""

import numpy as np
import pytest
import torch

from clsr_tpu.training.steps import make_eval_step_fn as jax_eval_step_fn
from clsr_tpu_torch import weights
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.training.state import create_train_state
from clsr_tpu_torch.training.steps import make_eval_step_fn, make_train_step_fn

from test_torch_common import (N_CATES, N_ITEMS, N_USERS, TOL, jax_batch,
                               jax_clsr, jax_state, numpy_batch, port_batch,
                               port_cfg, small_jax_cfg)

_VARIANTS = {
    "default": {},
    "manual_alpha": dict(manual_alpha=True, manual_alpha_value=0.3),
    "no_bn": dict(enable_bn=False),
    "no_evolve_no_causal2": dict(interest_evolve=False,
                                 predict_long_short=False),
}


@pytest.fixture(scope="module", params=sorted(_VARIANTS))
def jax_side(request):
    jcfg = small_jax_cfg(**_VARIANTS[request.param])
    model, params, stats = jax_clsr(jcfg)
    step = jax_eval_step_fn(model, jcfg, allow_pallas=True)
    return jcfg, params, stats, (lambda b: step(
        jax_state(model, params, stats), jax_batch(b)))


def _port_step(jcfg, params, stats, **overrides):
    cfg = port_cfg(jcfg, **overrides)
    model = get_model_class("clsr")(cfg, N_USERS, N_ITEMS, N_CATES,
                                    device="cpu")
    weights.from_flax(model, params, stats)
    step = make_eval_step_fn(cfg)
    return lambda b: step(model, port_batch(b))


@pytest.mark.parametrize("G", [1, 12])
@pytest.mark.parametrize("use_pallas_scan", [False, True])
def test_eval_step_matches_jax(jax_side, G, use_pallas_scan):
    jcfg, params, stats, jax_step = jax_side
    L = jcfg.max_seq_length
    b = numpy_batch(np.random.RandomState(G), 4, G, L,
                    lengths=[1, 3, L, 5])          # one full-length row
    want_p, want_a = jax_step(b)
    got_p, got_a = _port_step(jcfg, params, stats,
                              use_pallas_scan=use_pallas_scan,
                              use_pallas_eval_attention="on")(b)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)


def test_kernel_gate_on_and_off_agree():
    jcfg = small_jax_cfg()
    _, params, stats = jax_clsr(jcfg)
    b = numpy_batch(np.random.RandomState(1), 3, 9, jcfg.max_seq_length)
    on = _port_step(jcfg, params, stats, use_pallas_eval_attention="on",
                    use_pallas_scan=True)(b)
    off = _port_step(jcfg, params, stats, use_pallas_eval_attention="off")(b)
    for x, y in zip(on, off):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL)


def test_train_mode_and_unported_settings_raise():
    cfg = port_cfg(small_jax_cfg())
    model = get_model_class("clsr")(cfg, N_USERS, N_ITEMS, N_CATES,
                                    device="cpu")
    for name in ("lazyadam", "adagrad", "rmsprop"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            create_train_state(model, cfg.replace(optimizer=name))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step_fn(model, cfg.replace(optimizer="lazyadam"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step_fn(model, cfg.replace(data_parallel=2))
    for bad in (dict(data_parallel=2), dict(use_fused_encoders=False),
                dict(compute_dtype="bfloat16")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_model_class("clsr")(cfg.replace(**bad), N_USERS, N_ITEMS,
                                    N_CATES, device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        get_model_class("DIN")
    with pytest.raises(ValueError, match="Unknown model"):
        get_model_class("nope")


def test_model_defaults_to_cuda():
    cfg = port_cfg(small_jax_cfg())
    if torch.cuda.is_available():
        model = get_model_class("clsr")(cfg, N_USERS, N_ITEMS, N_CATES)
        assert model.item_embedding.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_model_class("clsr")(cfg, N_USERS, N_ITEMS, N_CATES)
