"""int8 serving tables: the port against the JAX package's.

The same perturbed flax weights on both sides (JAX on the CPU), f32
tables and bf16 tables:

  * the port's `quantize_tables` (through `ScoringService(...,
    checkpoint=..., int8_tables=True)`) gives JAX's `quantize_tables`
    int8 rows and `<name>_scales` bit for bit;
  * the int8 service's scores within 1e-5 of JAX's int8 service, and
    within 0.03 of the f32 service (JAX's own tolerance,
    tests/test_serving.py:183-200); under compute_dtype bfloat16 within
    2e-2 of JAX's int8 service (the frameworks round bf16 at different
    places);
  * training refuses a quantized model; `load_latest` of a training
    checkpoint (float tables) quantizes again after the load.
"""

import numpy as np
import pytest
import torch

from clsr_tpu.data.vocab import Vocab as JaxVocab
from clsr_tpu.serving import ScoreRequest as JaxRequest
from clsr_tpu.serving import ScoringService as JaxService
from clsr_tpu_torch import weights
from clsr_tpu_torch.data.vocab import Vocab
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.serving import (ScoreRequest, ScoringService,
                                    quantize_tables)
from clsr_tpu_torch.training import checkpoint
from clsr_tpu_torch.training.state import create_train_state
from clsr_tpu_torch.training.steps import make_train_step_fn

from test_torch_common import TOL, perturb, port_cfg, small_jax_cfg, to_np

N_ITEMS, N_CATES, N_USERS = 30, 6, 10
_MAPS = ({f"u{i}": i for i in range(N_USERS)},
         {f"i{i}": i for i in range(N_ITEMS)},
         {f"c{i}": i for i in range(N_CATES)})
KW = dict(batch_buckets=(2, 4), cand_buckets=(8, 16))
TABLES = ("item_embedding", "cate_embedding", "user_long_embedding",
          "user_short_embedding")
SETTINGS = {"f32": {}, "bf16_tables": dict(embedding_dtype="bfloat16",
                                           optimizer="lazyadam"),
            "bf16_compute": dict(compute_dtype="bfloat16")}


def _requests(cls, seed, spec):
    out = []
    for i, (n_hist, n_cands) in enumerate(spec):
        rng = np.random.RandomState(seed + i)
        hist = rng.randint(1, N_ITEMS + 5, n_hist)       # some OOV items
        cands = rng.randint(1, N_ITEMS, n_cands)
        t0 = 1_500_600_000
        out.append(cls(
            user=f"u{rng.randint(0, N_USERS)}",
            hist_items=[f"i{h}" for h in hist],
            hist_cates=[f"c{h % N_CATES}" for h in hist],
            hist_times=sorted(t0 - rng.randint(60, 10 ** 6, n_hist)),
            current_time=t0, cand_items=[f"i{c}" for c in cands],
            cand_cates=[f"c{c % N_CATES}" for c in cands]))
    return out


SPEC = [(3, 5), (12, 9), (1, 16), (7, 8), (2, 1), (9, 12)]


@pytest.fixture(scope="module", params=sorted(SETTINGS))
def services(request, tmp_path_factory):
    """(setting, JAX f32 service, JAX int8 service, port f32 service,
    port int8 service), all on the same perturbed weights."""
    jcfg = small_jax_cfg(seed=11, **SETTINGS[request.param])
    jvocabs = [JaxVocab(m) for m in _MAPS]
    jsvc = JaxService(jcfg, N_USERS, N_ITEMS, N_CATES, *jvocabs, **KW)
    rng = np.random.RandomState(0)
    params = perturb(jsvc.state.params, rng)
    stats = perturb(jsvc.state.batch_stats, rng)
    if request.param == "bf16_tables":
        params = {k: (v.astype("bfloat16") if k.endswith("_embedding")
                      else v) for k, v in params.items()}
    jsvc.state = jsvc.state.replace(params=params, batch_stats=stats)
    j8 = JaxService(jcfg, N_USERS, N_ITEMS, N_CATES, *jvocabs, **KW)
    j8.state = j8.state.replace(params=params, batch_stats=stats)
    j8.quantize_tables()
    cfg = port_cfg(jcfg)
    pvocabs = [Vocab(m) for m in _MAPS]
    psvc = ScoringService(cfg, N_USERS, N_ITEMS, N_CATES, *pvocabs,
                          device="cpu", **KW)
    weights.from_flax(psvc.model, params, stats)
    path = str(tmp_path_factory.mktemp("int8") / "f32.pt")
    psvc.save(path)
    p8 = ScoringService(cfg, N_USERS, N_ITEMS, N_CATES, *pvocabs,
                        checkpoint=path, int8_tables=True, device="cpu",
                        **KW)
    return request.param, jsvc, j8, psvc, p8


def test_quantized_tables_equal_jax_bit_for_bit(services):
    _, _, j8, _, p8 = services
    for name in TABLES:
        q, scales = getattr(p8.model, name), getattr(p8.model,
                                                     f"{name}_scales")
        assert q.dtype == torch.int8 and scales.dtype == torch.float32
        want_q = np.asarray(j8.state.params[name])
        want_s = np.asarray(j8.state.params[f"{name}_scales"])
        assert want_q.dtype == np.int8 and want_s.shape == (q.shape[0], 1)
        np.testing.assert_array_equal(to_np(q), want_q, err_msg=name)
        np.testing.assert_array_equal(to_np(scales), want_s, err_msg=name)


def test_int8_scores_match_jax_and_the_f32_service(services):
    setting, jsvc, j8, psvc, p8 = services
    got = p8.score(_requests(ScoreRequest, 5, SPEC))
    want = j8.score(_requests(JaxRequest, 5, SPEC))
    f32 = psvc.score(_requests(ScoreRequest, 5, SPEC))
    tol = dict(rtol=0, atol=2e-2) if setting == "bf16_compute" else TOL
    for g, w, f in zip(got, want, f32):
        assert np.isfinite(g).all() and g.shape == f.shape
        np.testing.assert_allclose(g, w, **tol)
        np.testing.assert_allclose(g, f, rtol=0, atol=0.03)
    # the JAX services agree with each other as closely
    for w, jf in zip(want, jsvc.score(_requests(JaxRequest, 5, SPEC))):
        np.testing.assert_allclose(w, jf, rtol=0, atol=0.03)


def test_training_refuses_a_quantized_model(services):
    _, _, _, _, p8 = services
    with pytest.raises(ValueError, match="serving only"):
        create_train_state(p8.model, p8.cfg)
    with pytest.raises(ValueError, match="serving only"):
        make_train_step_fn(p8.model, p8.cfg)


def test_load_latest_quantizes_the_checkpoint(services, tmp_path):
    _, _, _, psvc, p8 = services
    cfg = psvc.cfg
    trained = get_model_class("clsr")(cfg.replace(seed=5), N_USERS, N_ITEMS,
                                      N_CATES, device="cpu")
    checkpoint.save_state(str(tmp_path / "epoch_1"),
                          create_train_state(trained, cfg))
    p8.load_latest(str(tmp_path))
    quantize_tables(trained)
    for name, value in trained.state_dict().items():
        assert torch.equal(p8.model.state_dict()[name], value), name
