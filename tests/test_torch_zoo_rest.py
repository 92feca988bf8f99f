"""The rest of the port's model zoo (Caser, NCF, NextItNet, LGN) against
the JAX package's.

Each model at test widths (item 8, cate 4, user 12, Caser L = 3 with
n_v 4 / n_h 3, NextItNet dilations (1, 2), NCF tower [10, 6], LGN two
layers, head [10, 6], history L = 7), JAX's init perturbed as
tests/test_torch_common.py does and carried over by `weights.from_flax`,
the same numpy batches on both sides, f32 on the CPU:

  * the eval step against JAX's at G = 1 and G = 12 (Caser, NCF,
    NextItNet), preds to 1e-5; ScoringService against JAX's on the same
    requests;
  * one dense-Adam train step (NextItNet per position, its negatives
    the same indices on both sides) against JAX's jitted step: loss
    parts, parameters and BN statistics to 1e-5;
  * one lazyadam step (Caser compact, NCF and NextItNet legacy, K5's
    group once) against JAX's `make_train_step`: loss parts, parameters
    and moments to 1e-5;
  * `expand_nextitnet` (the same negative indices fed to both),
    `right_align`, the per-position data loss, the convs against flax's
    `nn.Conv`, the graph propagation and its gradient against
    `jax.ops.segment_sum` under `jax.grad`;
  * the graph builder against JAX's (the sorted edges equal, the
    weights and item2cate bit for bit), from sequences and from a TSV;
    LGN's GCN output and logits against JAX's;
  * `from_flax` / `to_flax` round trips; the yaml copies load like
    JAX's; Caser under length buckets raises where JAX fails, and runs
    like JAX at max_seq_length 250; LGN's lazyadam and serving refusals.
The JAX programs compile once per model (module fixtures).
"""

import dataclasses
import functools
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clsr_tpu
from clsr_tpu.config import Config as JaxConfig
from clsr_tpu.config import load_config as jax_load_config
from clsr_tpu.data.graph import build_graph_from_sequences as jax_graph
from clsr_tpu.data.graph import build_interaction_graph as jax_tsv_graph
from clsr_tpu.data.synthetic import write_synthetic_dataset
from clsr_tpu.data.vocab import Vocab as JaxVocab
from clsr_tpu.data.vocab import load_vocab as jax_load_vocab
from clsr_tpu.models.nextitnet import right_align as jax_right_align
from clsr_tpu.models.registry import get_model_class as jax_model_class
from clsr_tpu.serving import ScoringService as JaxService
from clsr_tpu.training.lazy_adam import make_lazy_optimizer
from clsr_tpu.training.losses import data_loss_fn as jax_data_loss
from clsr_tpu.training.negative_sampling import \
    expand_nextitnet as jax_expand_nextitnet
from clsr_tpu.training.optimizer import build_optimizer as jax_optimizer
from clsr_tpu.training.state import TrainState as JaxTrainState
from clsr_tpu.training.steps import make_eval_step_fn as jax_eval_step_fn
from clsr_tpu.training.steps import make_train_step as jax_make_train_step
from clsr_tpu.training.steps import make_train_step_fn as jax_step_fn
from clsr_tpu_torch import weights
from clsr_tpu_torch.config import CONFIG_DIR, load_config
from clsr_tpu_torch.data.graph import (build_graph_from_sequences,
                                       build_interaction_graph)
from clsr_tpu_torch.data.vocab import Vocab, load_vocab
from clsr_tpu_torch.models.nextitnet import right_align
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.ops import row_update as ru
from clsr_tpu_torch.ops.conv import Conv1d
from clsr_tpu_torch.ops.graph_conv import GraphEdges, propagate
from clsr_tpu_torch.serving import ScoringService
from clsr_tpu_torch.training import negative_sampling as ns
from clsr_tpu_torch.training.losses import data_loss_fn
from clsr_tpu_torch.training.state import create_train_state
from clsr_tpu_torch.training.steps import (make_eval_step_fn,
                                           make_train_step,
                                           make_train_step_fn)

from test_torch_common import (TOL, jax_batch, jax_state, numpy_batch,
                               perturb, port_batch, port_cfg, to_np)
from test_torch_lazy_adam import _assert_step_matches
from test_torch_serving import (N_CATES as S_CATES, N_ITEMS as S_ITEMS,
                                N_USERS as S_USERS, _MAPS, _requests)

N_USERS, N_ITEMS, N_CATES = 9, 23, 5
L = 7
NGS = 4
WIDTHS = dict(user_vocab="u", item_vocab="i", cate_vocab="c",
              max_seq_length=L, item_embedding_dim=8, cate_embedding_dim=4,
              user_embedding_dim=12, hidden_size=12, layer_sizes=(10, 6),
              activation=("relu",), L=3, n_v=4, n_h=3, dilations=(1, 2),
              kernel_size=3, ncf_layer_sizes=(10, 6), n_layers=2, seed=3)
# the train steps' settings (tests/test_torch_zoo.py), dropout off
STEP = dict(need_sample=False, train_num_ngs=NGS, embed_l2=1e-4,
            layer_l2=1e-4, max_grad_norm=0.5)
MODELS = ("caser", "ncf", "nextitnet", "lgn")
EVAL_MODELS = ("caser", "ncf", "nextitnet")
# lazyadam: the K5 entries of a step (two a table)
LAZY_ENTRIES = {"caser": 4, "ncf": 12, "nextitnet": 4}


def rest_cfg(name, **overrides) -> JaxConfig:
    kw = dict(WIDTHS, model_type=name, **STEP)
    if name == "nextitnet":
        # per-position training draws its own [B, G, L] targets
        kw["need_sample"] = True
    kw.update(overrides)
    return JaxConfig(**kw).validate()


def _sequences(seed=5, n_users=N_USERS, n_items=N_ITEMS, n_cates=N_CATES):
    """Full-history sequences (a user may come twice; some consecutive
    items repeat, giving self loops)."""
    rng = np.random.RandomState(seed)
    out = []
    for s in range(n_users + 3):
        n = rng.randint(1, 9)
        items = [int(i) for i in rng.randint(0, n_items, n)]
        if n > 2 and s % 3 == 0:
            items[1] = items[0]
        out.append((s % n_users, items,
                    [int(c) for c in rng.randint(0, n_cates, n)]))
    return out


@functools.lru_cache(maxsize=None)
def graphs():
    """(JAX's graph, the port's) of `_sequences()`."""
    seqs = _sequences()
    return (jax_graph(seqs, N_USERS, N_ITEMS),
            build_graph_from_sequences(seqs, N_USERS, N_ITEMS))


def jax_model(jcfg):
    kw = {"graph": graphs()[0]} if jcfg.model_type == "lgn" else {}
    return jax_model_class(jcfg.model_type)(
        cfg=jcfg, n_users=N_USERS, n_items=N_ITEMS, n_cates=N_CATES, **kw)


@functools.lru_cache(maxsize=None)
def _variables(name):
    """JAX's init of `name`, perturbed; computed once a module."""
    model = jax_model(rest_cfg(name))
    sample = jax_batch(numpy_batch(np.random.RandomState(0), 2, 8, L))
    variables = jax.jit(model.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        sample, train=True)
    rng = np.random.RandomState(7)
    return (perturb(variables["params"], rng),
            perturb(variables.get("batch_stats", {}), rng))


def port_model(jcfg, params, stats, **overrides):
    cfg = port_cfg(jcfg, **overrides)
    kw = {"graph": graphs()[1]} if cfg.model_type == "lgn" else {}
    model = get_model_class(cfg.model_type)(cfg, N_USERS, N_ITEMS, N_CATES,
                                            device="cpu", **kw)
    weights.from_flax(model, params, stats)
    return cfg, model


def _batch(seed, G, B=4):
    b = numpy_batch(np.random.RandomState(seed), B, G, L,
                    lengths=[1, L, 3, 5, 2, 6][:B])
    b["labels"][:, 0] = 1.0
    return b


def _neg_base(shape):
    """Fixed negative indices (before the modulo by n_valid)."""
    n = int(np.prod(shape))
    return (np.arange(n, dtype=np.int64) * 7 + 3).reshape(shape)


@pytest.fixture
def same_negatives(monkeypatch):
    """Both packages' draws return `_neg_base` mod n_valid: JAX's
    jax.random.randint, the port's `_draw`; every rejection round then
    keeps them."""
    def jax_randint(key, shape, minval, maxval, dtype=jnp.int32):
        return (jnp.asarray(_neg_base(shape)) % maxval).astype(dtype)

    def port_draw(generator, shape, n_valid, device):
        return torch.from_numpy(_neg_base(shape)).to(device) % n_valid

    monkeypatch.setattr(jax.random, "randint", jax_randint)
    monkeypatch.setattr(ns, "_draw", port_draw)


# ------------------------------------------------------------- eval step


@pytest.fixture(scope="module", params=EVAL_MODELS)
def eval_side(request):
    name = request.param
    jcfg = rest_cfg(name)
    model = jax_model(jcfg)
    params, stats = _variables(name)
    step = jax_eval_step_fn(model, jcfg, allow_pallas=True)
    return name, jcfg, params, stats, jax.jit(
        lambda bb: step(jax_state(model, params, stats), bb))


@pytest.mark.parametrize("G", [1, 12])
def test_eval_step_matches_jax(eval_side, G):
    name, jcfg, params, stats, jax_eval = eval_side
    b = _batch(G, G)
    want_p, _ = jax_eval(jax_batch(b))
    cfg, pmodel = port_model(jcfg, params, stats)
    got_p, _ = make_eval_step_fn(cfg)(pmodel, port_batch(b))
    assert got_p.shape == (4, G)
    np.testing.assert_allclose(to_np(got_p), np.asarray(want_p), **TOL)


@pytest.mark.parametrize("name", MODELS)
def test_weights_round_trip(name):
    params, stats = _variables(name)
    _, pmodel = port_model(rest_cfg(name), params, stats)
    got_p, got_s = weights.to_flax(pmodel)
    for got, want in ((got_p, params), (got_s, stats)):
        got, want = weights.flatten_tree(got), weights.flatten_tree(want)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


@pytest.mark.parametrize("name", EVAL_MODELS)
def test_serving_matches_jax_service(name):
    jcfg = rest_cfg(name, seed=11)
    kw = dict(batch_buckets=(2, 4), cand_buckets=(8, 16))
    jsvc = JaxService(jcfg, S_USERS, S_ITEMS, S_CATES,
                      *(JaxVocab(m) for m in _MAPS), **kw)
    rng = np.random.RandomState(0)
    params = perturb(jsvc.state.params, rng)
    stats = perturb(jsvc.state.batch_stats, rng)
    jsvc.state = jsvc.state.replace(params=params, batch_stats=stats)
    psvc = ScoringService(port_cfg(jcfg), S_USERS, S_ITEMS, S_CATES,
                          *(Vocab(m) for m in _MAPS), device="cpu", **kw)
    weights.from_flax(psvc.model, params, stats)
    spec = [(3, 5), (12, 9), (1, 16)]       # two dispatches
    jreqs, preqs = _requests(5, spec)
    want, got = jsvc.score(jreqs), psvc.score(preqs)
    assert [len(s) for s in got] == [c for _, c in spec]
    for g, w in zip(got, want):
        assert np.isfinite(g).all() and (g >= 0).all() and (g <= 1).all()
        np.testing.assert_allclose(g, w, **TOL)


# ------------------------------------------------------ dense train step


def _assert_params_match(pmodel, want_state):
    got_p, got_s = weights.to_flax(pmodel)
    for got, want in ((got_p, want_state.params),
                      (got_s, want_state.batch_stats)):
        got, want = weights.flatten_tree(got), weights.flatten_tree(want)
        assert set(got) == set(want)
        for k, v in got.items():
            np.testing.assert_allclose(v, np.asarray(want[k]), **TOL,
                                       err_msg=k)


def _assert_parts_match(parts, want_parts):
    for field in dataclasses.fields(parts):
        np.testing.assert_allclose(
            to_np(getattr(parts, field.name)),
            np.asarray(getattr(want_parts, field.name)), **TOL,
            err_msg=field.name)


@pytest.mark.parametrize("name", MODELS)
def test_dense_train_step_matches_jax(name, same_negatives):
    jcfg = rest_cfg(name)
    model = jax_model(jcfg)
    params, stats = _variables(name)
    G = 1 if jcfg.need_sample else 1 + NGS
    b = _batch(20, G)
    state = JaxTrainState.create(apply_fn=model.apply, params=params,
                                 batch_stats=stats, tx=jax_optimizer(jcfg))
    want_state, want_parts = jax.jit(jax_step_fn(model, jcfg,
                                                 allow_pallas=False))(
        state, jax_batch(b), jax.random.PRNGKey(0))
    cfg, pmodel = port_model(jcfg, params, stats)
    pstate = create_train_state(pmodel, cfg)
    _, parts = make_train_step_fn(pmodel, cfg)(
        pstate, port_batch(b), torch.Generator().manual_seed(0))
    _assert_parts_match(parts, want_parts)
    _assert_params_match(pmodel, want_state)


# --------------------------------------------------------------- lazyadam


@pytest.mark.parametrize("name", sorted(LAZY_ENTRIES))
def test_lazy_step_matches_jax(name, same_negatives, monkeypatch):
    jcfg = rest_cfg(name, optimizer="lazyadam")
    model = jax_model(jcfg)
    params, stats = _variables(name)
    init_fn, _ = make_lazy_optimizer(jcfg)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), apply_fn=model.apply,
                          params=params, tx=None, opt_state=init_fn(params),
                          batch_stats=stats)
    b = _batch(30, 1 if jcfg.need_sample else 1 + NGS)
    want_state, want_parts = jax_make_train_step(model, jcfg, donate=False)(
        state, jax_batch(b), jax.random.PRNGKey(0))
    calls = []   # K5's plain version runs where the kernel would launch
    plain = ru.scatter_rows_group_reference
    monkeypatch.setattr(ru, "scatter_rows_group_reference",
                        lambda entries: calls.append(len(entries))
                        or plain(entries))
    cfg, pmodel = port_model(jcfg, params, stats)
    pstate = create_train_state(pmodel, cfg)
    # Caser's tables have site specs (compact, pmn [N, 3D]); NCF's four
    # own tables and per-position training take the legacy path
    widths = {n: m.shape[1] // p.shape[1] for (n, m), p in zip(
        pstate.optimizer.moments.items(),
        (dict(pmodel.named_parameters())[n]
         for n in pstate.optimizer.moments))}
    assert set(widths.values()) == {3 if name == "caser" else 2}
    pstate, parts = make_train_step(pmodel, cfg)(
        pstate, port_batch(b), torch.Generator().manual_seed(0))
    assert calls == [LAZY_ENTRIES[name]]
    _assert_step_matches(want_state, want_parts, pstate, parts)


# ------------------------------------------- NextItNet's per-position parts


def test_right_align_matches_jax():
    b = numpy_batch(np.random.RandomState(3), 6, 1, L,
                    lengths=[0, 1, L, 3, 5, 2])
    x = np.random.RandomState(4).randn(6, L, 5).astype(np.float32)
    want = jax_right_align(jnp.asarray(x), jnp.asarray(b["mask"]))
    got = right_align(torch.from_numpy(x), torch.from_numpy(b["mask"]))
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    ids = jax_right_align(jnp.asarray(b["item_hist"])[..., None],
                          jnp.asarray(b["mask"]))[..., 0]
    got = right_align(torch.from_numpy(b["item_hist"])[..., None],
                      torch.from_numpy(b["mask"]))[..., 0]
    np.testing.assert_array_equal(to_np(got), np.asarray(ids))


def test_expand_nextitnet_matches_jax(same_negatives):
    b = _batch(8, 1, B=6)
    b["valid"][-1] = 0.0                          # a padding row
    want = jax_expand_nextitnet(jax.random.PRNGKey(0), jax_batch(b), NGS)
    got = ns.expand_nextitnet(torch.Generator().manual_seed(0),
                              port_batch(b), NGS)
    assert tuple(got.items.shape) == (6, 1 + NGS, L)
    for f in ("items", "cates", "labels"):
        w, g = np.asarray(getattr(want, f)), to_np(getattr(got, f))
        assert g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    np.testing.assert_array_equal(to_np(got.labels[:, 0]), 1.0)
    np.testing.assert_array_equal(to_np(got.labels[:, 1:]), 0.0)


@pytest.mark.parametrize("loss", ["softmax", "cross_entropy_loss",
                                  "log_loss", "square_loss"])
def test_per_position_data_loss_matches_jax(loss):
    rng = np.random.RandomState(9)
    logits = rng.randn(5, 1 + NGS, L).astype(np.float32)
    labels = np.zeros_like(logits)
    labels[:, 0] = 1.0
    valid = np.array([1, 1, 0, 1, 1], np.float32)
    jcfg = rest_cfg("nextitnet", loss=loss)
    want = jax_data_loss(jcfg, jnp.asarray(logits), jnp.asarray(labels),
                         jnp.asarray(valid))
    got = data_loss_fn(port_cfg(jcfg), torch.from_numpy(logits),
                       torch.from_numpy(labels), torch.from_numpy(valid))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


# ------------------------------------------------------------- the ops


@pytest.mark.parametrize("k, d, padding, length", [
    (1, 1, "SAME", 7), (3, 1, "VALID", 7), (3, 2, "CAUSAL", 7),
    (8, 1, "VALID", 8)])
def test_conv_matches_flax(k, d, padding, length):
    rng = np.random.RandomState(k + d)
    x = rng.randn(3, length, 5).astype(np.float32)
    pad = ([((k - 1) * d, 0)] if padding == "CAUSAL" else padding)
    conv = fnn.Conv(4, kernel_size=(k,), kernel_dilation=(d,), padding=pad)
    params = perturb(conv.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                     np.random.RandomState(1))
    cot = rng.randn(*conv.apply(params, jnp.asarray(x)).shape).astype(
        np.float32)

    def jloss(p, xx):
        return jnp.sum(conv.apply(p, xx) * cot)
    want = conv.apply(params, jnp.asarray(x))
    want_gp, want_gx = jax.grad(jloss, argnums=(0, 1))(params,
                                                       jnp.asarray(x))
    port = Conv1d(5, 4, k, torch.Generator(), torch.device("cpu"),
                  dilation=d, padding=padding)
    weights.from_flax(port, params["params"])
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(to_np(xt.grad), np.asarray(want_gx), **TOL)
    for name in ("kernel", "bias"):
        np.testing.assert_allclose(
            to_np(getattr(port, name).grad),
            np.asarray(want_gp["params"][name]), **TOL, err_msg=name)


def test_graph_propagation_and_gradient_match_jax():
    jg, pg = graphs()
    n = N_USERS + N_ITEMS
    rng = np.random.RandomState(2)
    ego = rng.randn(n, 6).astype(np.float32)
    cot = rng.randn(n, 6).astype(np.float32)

    def jloss(e):
        side = jax.ops.segment_sum(jnp.asarray(jg.weight)[:, None]
                                   * e[jnp.asarray(jg.dst)],
                                   jnp.asarray(jg.src), num_segments=n)
        return jnp.sum(side * cot), side
    (_, want), want_g = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(ego))
    # chunks of at most 16 edges: several node ranges in each order
    edges = GraphEdges.build(n, pg.src, pg.dst, pg.weight, "cpu", cap=16)
    assert len(edges.chunks_src) > 3 and len(edges.chunks_dst) > 3
    et = torch.from_numpy(ego).requires_grad_()
    got = propagate(et, edges)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(to_np(et.grad), np.asarray(want_g), **TOL)


# ----------------------------------------------------------- LGN's graph


def _sorted_edges(g):
    order = np.lexsort((g.dst, g.src))
    return g.src[order], g.dst[order], g.weight[order]


def _assert_graphs_equal(jg, pg):
    assert (pg.n_users, pg.n_items) == (jg.n_users, jg.n_items)
    for w, g, what in zip(_sorted_edges(jg), _sorted_edges(pg),
                          ("src", "dst", "weight")):
        assert g.dtype == w.dtype, what
        np.testing.assert_array_equal(g, w, err_msg=what)
    np.testing.assert_array_equal(pg.item2cate, jg.item2cate)
    # the port keeps its edges sorted by (src, dst)
    np.testing.assert_array_equal(np.stack([pg.src, pg.dst]),
                                  np.stack(_sorted_edges(pg)[:2]))


def test_graph_builder_matches_jax():
    jg, pg = graphs()
    _assert_graphs_equal(jg, pg)
    assert (pg.src == pg.dst).sum() > N_USERS + N_ITEMS   # self loops too


def test_graph_from_tsv_matches_jax(tmp_path):
    paths = write_synthetic_dataset(str(tmp_path), n_users=20, n_items=40,
                                    n_cates=6, seed=2)
    jv = [jax_load_vocab(paths[k]) for k in ("user_vocab", "item_vocab",
                                             "cate_vocab")]
    pv = [load_vocab(paths[k]) for k in ("user_vocab", "item_vocab",
                                         "cate_vocab")]
    _assert_graphs_equal(jax_tsv_graph(paths["train"], *jv),
                         build_interaction_graph(paths["train"], *pv))


def test_lgn_gcn_and_logits_match_jax():
    """LGN's logits on a batch, the GCN output's whole user x item score
    table (every user against every item), and in train mode the lazy
    L2 of the GCN-output item rows and the attn labels."""
    jcfg = rest_cfg("lgn")
    model = jax_model(jcfg)
    params, stats = _variables("lgn")
    b = _batch(50, 12)
    table = numpy_batch(np.random.RandomState(51), N_USERS, N_ITEMS, L)
    table["users"] = np.arange(N_USERS, dtype=np.int32)
    table["items"] = np.tile(np.arange(N_ITEMS, dtype=np.int32),
                             (N_USERS, 1))
    apply = jax.jit(lambda bb, train: model.apply(
        {"params": params, "batch_stats": stats}, bb, train=train,
        rngs={"dropout": jax.random.PRNGKey(0)}), static_argnums=1)
    _, pmodel = port_model(jcfg, params, stats)
    for arrays in (b, table):
        want, _ = apply(jax_batch(arrays), False)
        pmodel.eval()
        with torch.no_grad():
            got, _ = pmodel(port_batch(arrays))
        np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    _, want_aux = apply(jax_batch(b), True)
    pmodel.train()
    with torch.no_grad():
        _, aux = pmodel(port_batch(b))
    for k in ("embed_sumsq", "attn_labels"):
        np.testing.assert_allclose(to_np(aux[k]), np.asarray(want_aux[k]),
                                   **TOL, err_msg=k)


# ------------------------------------------------------ configs, refusals


@pytest.mark.parametrize("yaml", ["caser", "ncf", "nextitnet", "lgn"])
def test_rest_yaml_loads_like_jax(yaml):
    """The port's copy of each yaml is JAX's and loads to the same value
    of every field the port keeps; a missing required key raises in
    both."""
    port_path = os.path.join(CONFIG_DIR, f"{yaml}.yaml")
    jax_path = os.path.join(os.path.dirname(clsr_tpu.__file__), "configs",
                            f"{yaml}.yaml")
    assert open(port_path).read() == open(jax_path).read()
    vocabs = dict(user_vocab="u", item_vocab="i", cate_vocab="c", seed=4)
    port = load_config(port_path, **vocabs)
    want = dataclasses.asdict(jax_load_config(jax_path, **vocabs))
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == want[f.name], f.name
    key = {"caser": "n_v", "nextitnet": "dilations"}.get(
        yaml, "user_embedding_dim")
    with pytest.raises(ValueError, match=key):
        load_config(port_path, **dict(vocabs, **{key: None}))
    with pytest.raises(ValueError, match=key):
        jax_load_config(jax_path, **dict(vocabs, **{key: None}))


def test_caser_needs_full_length_histories_as_jax_does():
    """Under length buckets a history is shorter than max_seq_length: JAX
    fails at the vertical conv's kernel shape, the port refuses the
    config and the model raises; at max_seq_length 250 both run and
    agree."""
    jcfg = rest_cfg("caser")
    model = jax_model(jcfg)
    params, stats = _variables("caser")
    short = _batch(60, 3)
    short = {k: (v[:, :5] if v.ndim == 2 and v.shape[1] == L else v)
             for k, v in short.items()}
    with pytest.raises(Exception, match="kernel"):
        model.apply({"params": params, "batch_stats": stats},
                    jax_batch(short), train=False)
    with pytest.raises(ValueError, match="length_buckets"):
        port_cfg(jcfg, length_buckets="auto")
    _, pmodel = port_model(jcfg, params, stats)
    with pytest.raises(ValueError, match="max_seq_length"):
        make_eval_step_fn(port_cfg(jcfg))(pmodel, port_batch(short))

    long_cfg = rest_cfg("caser", max_seq_length=250)
    long_model = jax_model(long_cfg)
    b = numpy_batch(np.random.RandomState(61), 3, 4, 250,
                    lengths=[250, 17, 1])
    variables = jax.jit(long_model.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(2)}, jax_batch(b), train=False)
    lp = perturb(variables["params"], np.random.RandomState(3))
    ls = perturb(variables["batch_stats"], np.random.RandomState(4))
    want, _ = jax.jit(lambda bb: long_model.apply(
        {"params": lp, "batch_stats": ls}, bb, train=False))(jax_batch(b))
    cfg, lmodel = port_model(long_cfg, lp, ls)
    lmodel.eval()
    with torch.no_grad():
        got, _ = lmodel(port_batch(b))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_lgn_refuses_lazyadam_as_jax_does():
    with pytest.raises(ValueError, match="lazyadam is not valid for lgn"):
        rest_cfg("lgn", optimizer="lazyadam")
    with pytest.raises(ValueError, match="lazyadam is not valid for lgn"):
        port_cfg(rest_cfg("lgn"), optimizer="lazyadam")


def test_lgn_is_not_served():
    cfg = port_cfg(rest_cfg("lgn"))
    with pytest.raises(ValueError, match="does not serve LGN"):
        ScoringService(cfg, S_USERS, S_ITEMS, S_CATES,
                       *(Vocab(m) for m in _MAPS), device="cpu")
    # nor can JAX's service build it: it passes no graph
    with pytest.raises(AttributeError):
        JaxService(rest_cfg("lgn"), S_USERS, S_ITEMS, S_CATES,
                   *(JaxVocab(m) for m in _MAPS))
    with pytest.raises(ValueError, match="interaction graph"):
        get_model_class("lgn")(cfg, N_USERS, N_ITEMS, N_CATES, device="cpu")
