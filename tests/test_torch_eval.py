"""The port's metrics and evaluator against the JAX package's.

  * `cal_metric`, `cal_weighted_metric` and `cal_mean_alpha_metric` on the
    same arrays, with tied scores, ragged and multi-positive groups:
    equal dicts (the port's module is a copy; this holds it to JAX's);
  * `run_weighted_eval` on the 50-user synthetic set (valid 1 + 4, test
    1 + 9 groups, L = 10) with the JAX model's perturbed weights carried
    across by `weights.from_flax`: every prediction to 1e-5, every metric
    within 1e-4 (both rounded to 4 decimals), `mean_alpha` included;
    dispatches of max(1, batch_size // group) groups, as in JAX;
  * `predict_to_file`: the same line count as JAX's file and the test
    file, scores to 1e-5.
"""

import jax
import numpy as np
import pytest

from clsr_tpu import metrics as jax_metrics
from clsr_tpu.data.loader import SequenceLoader as JaxLoader
from clsr_tpu.data.parser import parse_file as jax_parse_file
from clsr_tpu.data.vocab import load_vocab as jax_load_vocab
from clsr_tpu.models.registry import get_model_class as jax_model_class
from clsr_tpu.training.evaluator import predict_to_file as jax_predict
from clsr_tpu.training.evaluator import run_weighted_eval as jax_eval
from clsr_tpu.training.optimizer import build_optimizer as jax_optimizer
from clsr_tpu.training.state import TrainState as JaxTrainState
from clsr_tpu.training.steps import make_eval_step as jax_eval_step
from clsr_tpu_torch import metrics, weights
from clsr_tpu_torch.data.loader import SequenceLoader
from clsr_tpu_torch.data.parser import parse_file
from clsr_tpu_torch.data.prefetch import to_device
from clsr_tpu_torch.data.synthetic import write_synthetic_dataset
from clsr_tpu_torch.data.vocab import load_vocab
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.training.evaluator import (predict_to_file,
                                               run_weighted_eval)
from clsr_tpu_torch.training.steps import make_eval_step_fn

from test_torch_common import (jax_batch, numpy_batch, perturb, port_cfg,
                               small_jax_cfg, to_np)

# ------------------------------------------------------------ metrics

POINTWISE = ("auc", "rmse", "logloss", "acc", "f1")
GROUPED = ("mean_mrr", "ndcg@1;3;20", "hit@2;4", "group_auc")
WEIGHTED = ("wauc", "wmrr", "whit@1;2", "wndcg@2;3")


def _scores(rng, shape, ties):
    p = rng.rand(*shape)
    return np.round(p, 1) if ties else p


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_pointwise_and_grouped_metrics_match_jax(ties):
    rng = np.random.RandomState(1 + ties)
    n, G = 40, 6
    labels = np.zeros((n, G), np.float32)
    labels[np.arange(n), rng.randint(0, G, n)] = 1.0
    preds = _scores(rng, (n, G), ties).astype(np.float32)
    preds[:3, :] = 0.5                           # whole groups tied
    for args in ((labels.reshape(-1), preds.reshape(-1), POINTWISE),
                 (labels, preds, GROUPED)):
        assert metrics.cal_metric(*args) == jax_metrics.cal_metric(*args)


def test_grouped_metrics_fallback_paths_match_jax():
    """Ragged groups and groups with two positives take the per-group
    loops, not the single-positive vector path."""
    rng = np.random.RandomState(3)
    ragged_l = [np.array([1, 0, 0]), np.array([0, 1, 0, 0, 0]),
                np.array([1, 0])]
    ragged_p = [np.round(rng.rand(len(l)), 1) for l in ragged_l]
    two = np.array([[1, 1, 0, 0], [0, 1, 0, 1]], np.float32)
    two_p = np.array([[0.2, 0.9, 0.9, 0.1], [0.5, 0.5, 0.5, 0.5]])
    for labels, preds in ((ragged_l, ragged_p), (two, two_p)):
        assert (metrics.cal_metric(labels, preds, GROUPED)
                == jax_metrics.cal_metric(labels, preds, GROUPED))


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_weighted_and_alpha_metrics_match_jax(ties):
    rng = np.random.RandomState(5 + ties)
    n = 120
    users = rng.randint(0, 9, n)
    labels = (rng.rand(n) < 0.3).astype(np.float32)
    labels[:9] = 1.0
    labels[9:18] = 0.0
    users[:9] = users[9:18] = np.arange(9)      # both classes per user
    preds = _scores(rng, (n,), ties)
    got = metrics.cal_weighted_metric(users, preds, labels, WEIGHTED)
    assert got == jax_metrics.cal_weighted_metric(users, preds, labels,
                                                  WEIGHTED)
    alphas = rng.rand(n)
    assert (metrics.cal_mean_alpha_metric(alphas, labels)
            == jax_metrics.cal_mean_alpha_metric(alphas, labels))


def test_unknown_metric_raises_like_jax():
    for fn, args in ((metrics.cal_metric, ([1, 0], [0.4, 0.3])),
                     (metrics.cal_weighted_metric,
                      ([0, 0], [0.4, 0.3], [1, 0]))):
        with pytest.raises(ValueError, match="not define"):
            fn(*args, ["nope"])
    assert metrics.cal_metric([1, 0], [0.1, 0.2], []) == {}


# ------------------------------------------------------------ evaluator

L = 10
TEST_NGS = 9


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    out = tmp_path_factory.mktemp("eval")
    paths = write_synthetic_dataset(str(out), valid_num_ngs=4,
                                    test_num_ngs=TEST_NGS)
    pv = [load_vocab(paths[f"{n}_vocab"]) for n in ("user", "item", "cate")]
    jv = [jax_load_vocab(paths[f"{n}_vocab"])
          for n in ("user", "item", "cate")]
    loaders = {s: (SequenceLoader(parse_file(paths[s], *pv), L),
                   JaxLoader(jax_parse_file(paths[s], *jv), L))
               for s in ("valid", "test")}
    sizes = tuple(map(len, pv))
    jcfg = small_jax_cfg(max_seq_length=L, batch_size=64,
                         test_num_ngs=TEST_NGS)
    jmodel = jax_model_class("clsr")(cfg=jcfg, n_users=sizes[0],
                                     n_items=sizes[1], n_cates=sizes[2])
    sample = jax_batch(numpy_batch(np.random.RandomState(0), 2, 8, L,
                                   n_users=sizes[0], n_items=sizes[1],
                                   n_cates=sizes[2]))
    variables = jmodel.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(1)}, sample,
                            train=True)
    rng = np.random.RandomState(7)
    params = perturb(variables["params"], rng)
    stats = perturb(variables["batch_stats"], rng)
    cfg = port_cfg(jcfg)
    model = get_model_class("clsr")(cfg, *sizes, device="cpu")
    weights.from_flax(model, params, stats)
    return dict(paths=paths, loaders=loaders, jcfg=jcfg, cfg=cfg,
                jstate=JaxTrainState.create(apply_fn=jmodel.apply,
                                            params=params, batch_stats=stats,
                                            tx=jax_optimizer(jcfg)),
                jstep=jax_eval_step(jmodel, jcfg), model=model)


def test_eval_predictions_match_jax(setup):
    port_l, jax_l = setup["loaders"]["test"]
    step = make_eval_step_fn(setup["cfg"])
    groups = 64 // (TEST_NGS + 1)
    got = list(port_l.eval_batches(TEST_NGS + 1, groups))
    want = list(jax_l.eval_batches(TEST_NGS + 1, groups))
    assert len(got) == len(want) > 1
    for b, jb in zip(got, want):
        preds, alpha = step(setup["model"], to_device(b, "cpu"))
        jpreds, jalpha = setup["jstep"](setup["jstate"], jb)
        np.testing.assert_allclose(to_np(preds), np.asarray(jpreds),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(to_np(alpha), np.asarray(jalpha),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("split, ngs, alpha, groups", [
    ("valid", 4, False, None), ("test", TEST_NGS, True, None),
    ("test", TEST_NGS, False, 4)])
def test_run_weighted_eval_matches_jax(setup, split, ngs, alpha, groups):
    port_l, jax_l = setup["loaders"][split]
    got = run_weighted_eval(make_eval_step_fn(setup["cfg"]), setup["model"],
                            port_l, setup["cfg"], ngs, batch_groups=groups,
                            calc_mean_alpha=alpha)
    want = jax_eval(setup["jstep"], setup["jstate"], jax_l, setup["jcfg"],
                    ngs, batch_groups=groups, calc_mean_alpha=alpha)
    assert got.keys() == want.keys()
    assert ("mean_alpha" in got) == alpha
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-4 + 1e-9, (k, got[k], want[k])


def test_predict_to_file_matches_jax(setup, tmp_path):
    port_l, jax_l = setup["loaders"]["test"]
    predict_to_file(make_eval_step_fn(setup["cfg"]), setup["model"], port_l,
                    setup["cfg"], str(tmp_path / "port.txt"))
    jax_predict(setup["jstep"], setup["jstate"], jax_l, setup["jcfg"],
                str(tmp_path / "jax.txt"))
    got = np.loadtxt(tmp_path / "port.txt")
    want = np.loadtxt(tmp_path / "jax.txt")
    with open(setup["paths"]["test"]) as f:
        n_lines = sum(1 for _ in f)
    assert got.shape == want.shape == (n_lines,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.isfinite(got).all() and ((got >= 0) & (got <= 1)).all()


def test_eval_of_an_empty_split_raises(setup):
    """No groups at all (every history filtered out) is an error."""
    port_l, _ = setup["loaders"]["valid"]
    cfg = setup["cfg"].replace(min_seq_length=10_000)
    with pytest.raises(ValueError):
        run_weighted_eval(make_eval_step_fn(cfg), setup["model"], port_l,
                          cfg, 4)
