"""Length buckets and MaskedBatchNorm against the JAX package.

  * the bucket helpers (`choose_bucket_edges`, `bucket_rows`,
    `resolve_bucket_paddings`, `pad_view_rows`) equal JAX's exactly on
    seeded lengths;
  * `MaskedBatchNorm`, train and eval, equals JAX's to 1e-6 (outputs and
    running statistics), a row with every position masked included;
  * the plain masked train scorer (`TargetAttention(bn_stats_mask=True)`)
    and its BN buffers equal JAX's to 1e-5, and the fused train scorer's
    gate stays shut under it (JAX attention.py:117);
  * a two-epoch bucketed `Trainer.fit` (edges "8" at L = 17, B = 16, the
    epoch-end BN refresh) against JAX's bucketed `Trainer.fit`, both
    resident, from the same weights and RandomState, with the
    deterministic negatives of tests/test_torch_trainer.py: losses at
    every show_step 1e-4 relative, valid metrics 2e-4, BN running
    statistics 1e-5 (the var, and the mean less the bias before it; see
    `_bn_offsets`);
  * on the fit's weights, the bucketed `run_weighted_eval` against JAX's
    (2e-4 a metric) and against the port's unbucketed eval (1e-5: the
    same groups at their own Lb give the same scores up to rounding).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clsr_tpu.data.resident as jres
import clsr_tpu.training.steps as jax_steps
from clsr_tpu.models.registry import get_model_class as jax_model_class
from clsr_tpu.ops.attention import TargetAttention as JaxTargetAttention
from clsr_tpu.ops.mlp import MaskedBatchNorm as JaxMaskedBatchNorm
from clsr_tpu.training.evaluator import run_weighted_eval as jax_eval
from clsr_tpu.training.trainer import Trainer as JaxTrainer
import clsr_tpu_torch.data.resident as pres
import clsr_tpu_torch.training.steps as port_steps
from clsr_tpu_torch import weights
from clsr_tpu_torch.data.loader import SequenceLoader
from clsr_tpu_torch.data.parser import parse_file
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.ops.attention import TargetAttention
from clsr_tpu_torch.ops.initializers import get_initializer
from clsr_tpu_torch.ops.mlp import MaskedBatchNorm
from clsr_tpu_torch.training.evaluator import run_weighted_eval
from clsr_tpu_torch.training.trainer import Trainer

from test_torch_common import (padded_view, perturb, port_cfg,
                               small_jax_cfg, to_np)
from test_torch_trainer import (_jax_negatives, _port_negatives, _scalars,
                                _sizes)
from test_torch_trainer import data  # noqa: F401  (the fixture)

L = 17


# ------------------------------------------------------- the helpers


def _lengths(seed, n=3000, L=L):
    """Short-skewed history lengths, as expanding histories give."""
    rng = np.random.RandomState(seed)
    return np.minimum(rng.geometric(0.15, n), L + 3)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("min_rows", [64, 512, 1024])
def test_choose_bucket_edges_equals_jax(seed, min_rows):
    lengths = _lengths(seed)
    for L_ in (17, 50):
        assert pres.choose_bucket_edges(lengths, L_, min_rows) == \
            jres.choose_bucket_edges(lengths, L_, min_rows)
    short = np.minimum(lengths, 12)          # no row fills L: top < L
    got = pres.choose_bucket_edges(short, 50, min_rows)
    assert got == jres.choose_bucket_edges(short, 50, min_rows)
    assert got[-1] == 16


@pytest.mark.parametrize("spec", ["off", "auto", "8", "4,8", "8,16",
                                  "16"])
def test_bucket_rows_and_paddings_equal_jax(spec):
    lengths = _lengths(3, n=2500)
    for L_ in (17, 24):
        cfg = dict(length_buckets=spec, max_seq_length=L_, batch_size=16)
        jcfg = small_jax_cfg(**cfg)
        pads = pres.resolve_bucket_paddings(port_cfg(jcfg), lengths)
        assert pads == jres.resolve_bucket_paddings(jcfg, lengths)
        if not pads:
            continue
        got = pres.bucket_rows(lengths, L_, pads)
        want = jres.bucket_rows(lengths, L_, pads)
        assert [lb for lb, _ in got] == [lb for lb, _ in want]
        for (_, g), (_, w) in zip(got, want):
            assert np.array_equal(g, w)
        # strict edges: a bucket padded to Lb holds lengths <= Lb - 1
        for lb, rows in got[:-1]:
            assert np.minimum(lengths[rows], L_).max() <= lb - 1
    # the top bucket below L when no row fills it
    short = np.minimum(lengths, 9)
    jcfg = small_jax_cfg(length_buckets="8", max_seq_length=17)
    assert pres.resolve_bucket_paddings(port_cfg(jcfg), short) == \
        jres.resolve_bucket_paddings(jcfg, short) == [8, 16]


@pytest.mark.parametrize("multiple", [0, 1, 8, 64])
def test_pad_view_rows_equals_jax(multiple):
    view = padded_view(multiple, 37, 9)
    got = pres.pad_view_rows(view, multiple)
    want = jres.pad_view_rows(view, multiple)
    for f in pres._FIELDS:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    if multiple > 1:
        assert len(got.users) % multiple == 0


# ---------------------------------------------------- MaskedBatchNorm


def _bn_inputs(seed, B=4, L_=6, G=3, C=5):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, L_, G, C) * 2 + 0.5).astype(np.float32)
    lengths = rng.randint(1, L_ + 1, B)
    lengths[1] = 0                           # every position masked
    mask = (np.arange(L_)[None] < lengths[:, None]).astype(np.float32)
    return x, mask[:, :, None, None]


@pytest.mark.parametrize("train", [True, False])
def test_masked_batch_norm_equals_jax(train):
    x, w = _bn_inputs(0)
    jmod = JaxMaskedBatchNorm()
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(w), False)
    rng = np.random.RandomState(5)
    params = perturb(variables["params"], rng)
    stats = perturb(variables["batch_stats"], rng)
    pmod = MaskedBatchNorm(5, torch.Generator(), torch.device("cpu"))
    with torch.no_grad():
        pmod.scale.copy_(torch.from_numpy(np.array(params["scale"])))
        pmod.bias.copy_(torch.from_numpy(np.array(params["bias"])))
        pmod.mean.copy_(torch.from_numpy(np.array(stats["mean"])))
        pmod.var.copy_(torch.from_numpy(np.array(stats["var"])))
    pmod.train(train)
    want, new = jmod.apply({"params": params, "batch_stats": stats},
                           jnp.asarray(x), jnp.asarray(w), train,
                           mutable=["batch_stats"])
    got = pmod(torch.from_numpy(x), torch.from_numpy(w))
    tol = dict(rtol=0, atol=1e-6)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **tol)
    np.testing.assert_allclose(to_np(pmod.mean),
                               np.asarray(new["batch_stats"]["mean"]), **tol)
    np.testing.assert_allclose(to_np(pmod.var),
                               np.asarray(new["batch_stats"]["var"]), **tol)
    moved = not np.array_equal(to_np(pmod.mean), np.asarray(stats["mean"]))
    assert moved == train


def test_masked_scorer_equals_jax_and_skips_the_train_kernel():
    B, L_, G, DQ, DK = 3, 9, 4, 16, 12
    rng = np.random.RandomState(2)
    keys = rng.randn(B, L_, DK).astype(np.float32)
    query = rng.randn(B, G, DQ).astype(np.float32)
    lengths = np.array([3, 0, 9])
    mask = (np.arange(L_)[None] < lengths[:, None]).astype(np.float32)
    jmod = JaxTargetAttention((8, 4), ("relu", "relu"), enable_bn=True,
                              bn_stats_mask=True)
    variables = jmod.init(jax.random.PRNGKey(0), query, keys, mask)
    params = perturb(variables["params"], rng)
    stats = perturb(variables["batch_stats"], rng)
    pmod = TargetAttention(DQ, DK, (8, 4), ("relu", "relu"),
                           get_initializer("tnormal", 0.01),
                           torch.Generator(), torch.device("cpu"),
                           enable_bn=True, use_train_kernel="on",
                           bn_stats_mask=True).train()
    weights.from_flax(pmod, params, stats)
    assert isinstance(pmod.att_fcn.bn0, MaskedBatchNorm)
    assert not pmod.train_kernel_applies(torch.from_numpy(keys), False)
    want, new = jmod.apply({"params": params, "batch_stats": stats},
                           query, keys, mask, train=True,
                           mutable=["batch_stats"])
    got = pmod(torch.from_numpy(query), torch.from_numpy(keys),
               torch.from_numpy(mask))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **tol)
    _, got_stats = weights.to_flax(pmod)
    for bn in ("bn0", "bn1"):
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                got_stats["att_fcn"][bn][k],
                np.asarray(new["batch_stats"]["att_fcn"][bn][k]), **tol)


# ------------------------------------------- the bucketed fit and eval

FIT = dict(max_seq_length=L, batch_size=16, epochs=2, show_step=5,
           train_steps_per_call=1, resident_data="on", length_buckets="8",
           bn_refresh_batches=8, valid_num_ngs=4, save_model=False,
           early_stop=10, contrastive_length_threshold=2, embed_l2=1e-4,
           layer_l2=1e-4)


@pytest.fixture(scope="module")
def loaders17(data):    # noqa: F811
    paths, pv, _, _ = data
    from clsr_tpu.data.loader import SequenceLoader as JaxLoader
    from clsr_tpu.data.parser import parse_file as jax_parse_file
    from clsr_tpu.data.vocab import load_vocab as jax_load_vocab
    jv = [jax_load_vocab(paths[f"{n}_vocab"])
          for n in ("user", "item", "cate")]
    port = {s: SequenceLoader(parse_file(paths[s], *pv), L)
            for s in ("train", "valid")}
    jax_l = {s: JaxLoader(jax_parse_file(paths[s], *jv), L)
             for s in ("train", "valid")}
    return pv, port, jax_l


@pytest.fixture(scope="module")
def fits(loaders17, tmp_path_factory):
    """JAX's and the port's two-epoch bucketed fits from one state."""
    pv, port, jax_l = loaders17
    out = tmp_path_factory.mktemp("bucket_fit")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_steps, "expand_with_negatives", _jax_negatives)
        mp.setattr(port_steps, "expand_with_negatives", _port_negatives)
        jcfg = small_jax_cfg(**FIT, summaries_dir=str(out / "jax"))
        sizes = _sizes(pv)
        jmodel = jax_model_class("clsr")(cfg=jcfg, n_users=sizes[0],
                                         n_items=sizes[1], n_cates=sizes[2])
        sample = next(jax_l["train"].train_batches(
            jcfg.batch_size, np.random.RandomState(0)))
        jt = JaxTrainer(jmodel, jcfg, sample, log=lambda *a: None)
        rng = np.random.RandomState(7)
        jt.state = jt.state.replace(
            params=perturb(jt.state.params, rng),
            batch_stats=perturb(jt.state.batch_stats, rng))
        cfg = port_cfg(jcfg, summaries_dir=str(out / "port"))
        model = get_model_class("clsr")(cfg, *sizes, device="cpu")
        weights.from_flax(model, jt.state.params, jt.state.batch_stats)
        logs = []
        pt = Trainer(model, cfg, log=logs.append)
        jt.fit(jax_l["train"], jax_l["valid"])
        pt.fit(port["train"], port["valid"])
    return jt, pt, out, logs


def test_bucketed_fit_follows_jax(fits):
    jt, pt, out, logs = fits
    assert "length buckets (Lb x rows): 8x312, 17x395" in logs
    assert pt.bucketed and [f.res.seq_len for f, _ in pt.feeds] == [8, 17]
    got, want = _scalars(out / "port"), _scalars(out / "jax")
    assert [r["step"] for r in got] == [r["step"] for r in want]
    n_logged = 0
    for g, w in zip(got, want):
        for key in set(w) - {"step", "time"}:
            if key.startswith("valid/"):
                assert abs(g[key] - w[key]) <= 2e-4 + 1e-9, (g, w)
            else:
                n_logged += 1
                np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                           err_msg=f"{key} at {g['step']}")
    assert n_logged >= 2 * 2 * 8
    assert len(pt.eval_history) == len(jt.eval_history) == 2
    for (ep, g), (jep, w) in zip(pt.eval_history, jt.eval_history):
        assert ep == jep and g.keys() == w.keys()
        for k in g:
            assert abs(g[k] - w[k]) <= 2e-4 + 1e-9, (ep, k, g[k], w[k])
    # the refresh ran; the running statistics agree with JAX's
    assert all(s["refresh_s"] > 0 for s in pt.epoch_stats)
    got = _bn_offsets(*weights.to_flax(pt.model))
    want = _bn_offsets(jax.device_get(jt.state.params),
                       jax.device_get(jt.state.batch_stats))
    assert got.keys() == want.keys() and len(got) == 8   # 2 BN x 4 MLPs
    for k in got:
        for g, w, what in zip(got[k], want[k], ("mean - bias", "var")):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5,
                                       err_msg=f"{k} {what}")


def _bn_offsets(params, stats, prefix=""):
    """{BN layer: (running mean - the bias of the Dense before it,
    running var)}.  A Dense bias followed by train-mode BN has a zero
    gradient by construction, so Adam walks it on rounding noise by a
    different 1e-5 in each package, and the running mean follows it; the
    model reads them only as their difference (eval BN of x + bias)."""
    out = {}
    for k, v in stats.items():
        if "mean" in v:
            bias = np.asarray(params[f"w_nn_layer{k[2:]}"]["bias"])
            out[prefix + k] = (np.asarray(v["mean"]) - bias,
                               np.asarray(v["var"]))
        else:
            out.update(_bn_offsets(params[k], v, prefix + k + "/"))
    return out


def test_bucketed_eval_equals_jax_and_unbucketed(fits, loaders17):
    jt, pt, _, _ = fits
    _, port, jax_l = loaders17
    cfg = pt.cfg
    got = run_weighted_eval(pt.eval_step, pt.state.model, port["valid"],
                            cfg, 4)
    want = jax_eval(jt.eval_step, jt.state, jax_l["valid"], jt.cfg, 4)
    assert got.keys() == want.keys()
    for k in got:
        assert abs(got[k] - want[k]) <= 2e-4 + 1e-9, (k, got[k], want[k])
    seen = []

    def recording(model, batch):
        seen.append(batch.item_hist.shape[1])
        return pt.eval_step(model, batch)

    bucketed = run_weighted_eval(recording, pt.state.model, port["valid"],
                                 cfg, 4)
    assert set(seen) == {8, 17}
    plain = run_weighted_eval(pt.eval_step, pt.state.model, port["valid"],
                              cfg.replace(length_buckets="off"), 4)
    assert bucketed.keys() == plain.keys()
    for k in plain:
        assert abs(bucketed[k] - plain[k]) <= 1e-5, (k, bucketed[k],
                                                      plain[k])
