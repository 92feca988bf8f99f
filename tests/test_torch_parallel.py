"""The port's (data, model) mesh against JAX's, module by module.

One 4-rank gloo world (parallel/distributed.py `run_local_world`, a
FileStore under the test's tmp dir) runs every rank-side case of
tests/torch_mesh_worker.py `parallel_world` on numpy inputs made here;
JAX's references run here on 4 devices of the 8-device CPU mesh that
tests/conftest.py gives, while the world runs.  At a (2, 2) mesh unless
said:

  * rowmap: the owner and layout functions equal JAX's (no world);
  * the collectives: all_reduce, all_gather, reduce_scatter over a model
    row and the world, exact rank-order sums, bit-identical on a second
    call, and all_reduce_grad's transpose;
  * `gather_rows` forward and logical table gradient against JAX's
    `gather_rows` under `use_sharded_tables` (shard_map), replicated and
    flat batch, contiguous and interleaved rows, and at (1, 4);
  * the fused train scorer's plain path (K3a/K3b's plain versions, then
    K1's) with global BN statistics against JAX's `_xla_train_scorer`
    inside shard_map with `psum_axes` (the mesh train kernel's plain
    form): output, statistics and every input gradient;
  * one CLSR train step with dense Adam (flat batch; the port's train
    scorer on) and one with the legacy lazy update (flat, compact rows
    off) against JAX's `make_sharded_train_step`, from one perturbed
    state, negatives injected (need_sample False): the loss parts to
    1e-5, every parameter and lazy moment to 1e-5, the moments' count,
    and dense Adam's moments (optax's mu / nu; under lazyadam its dense
    part's) in the gradient's units, g and |g|, to 1e-5; items and users
    are row-sharded, cates (5 rows) replicated.  max_grad_norm is set so
    that the item table's per-tensor clip engages on its whole norm
    only (each rank's block is under it), which the dense step asserts.
    The biases whose gradient is zero by construction (a layer feeding
    train-mode BN, an output bias under a softmax) carry Adam's sign
    flips of rounding noise, as tests/test_mesh_compact.py `_one_step_close`
    allows JAX's own mesh: those and the BN means they shift are held to
    2.1 lr;
  * one LGN step with dense Adam (its whole-graph propagation over the
    tables all_gathered over the model row, parallel/mesh.py
    `logical_table`), flat and replicated batch, against JAX's
    `make_sharded_train_step` (GSPMD gathers its tables) and against
    the one-rank port, from one perturbed state: the loss parts and
    every parameter to 1e-5, and the forward's gathers of the user and
    item blocks in the collective-byte count; with interleaved rows
    against the one-rank port alone (JAX's mesh LGN reads the placed
    tables' physical rows as logical ones there);
  * the mesh eval step (K1's plain path) against JAX's sharded eval
    step, and the mesh `ScoringService` against JAX's mesh service, to
    1e-5;
  * the mesh histogram step against the one-rank port's on the same
    weights and batch: JAX's tags, lo and hi to 1e-5, each tag's counts
    within 2 of the one-rank counts (a value on a bucket's edge may
    move by the forward's rounding);
  * int8 tables on the mesh: the scores against JAX's mesh int8 service
    (1e-5, as tests/test_serving.py
    `test_int8_tables_on_mesh_match_single_device_int8` holds JAX's
    mesh to its one device) and against the one-rank port's int8
    service bit for bit; the `_scales` blocks are sharded with their
    tables;
  * the async frontend on the mesh (rank 0 leads, the other ranks
    follow): 40 requests submitted from 4 threads on rank 0, at most 8
    a dispatch, equal the synchronous mesh service's scores of the same
    dispatches bit for bit (a row's bits may depend on its batch's
    bucket) and JAX's mesh service's to 1e-5; every rank runs the same
    dispatches and eval steps, and `submit` on another rank raises; a
    request that fails while rank 0 assembles its dispatch fails that
    dispatch alone and sends nothing, and a step that raises stops the
    frontend on every rank (pending futures fail, `submit` raises);
  * a sharded service's `save` / `load`: the mesh's logical files load
    on one rank, and the one-rank service's files load on the mesh,
    f32 and int8, the scores bit for bit those of a service built from
    the same weights on the same topology.
"""

import concurrent.futures
import dataclasses
import re

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import clsr_tpu.parallel.mesh as jax_mesh
import clsr_tpu.serving as jax_serving
from clsr_tpu.data.graph import build_graph_from_sequences as jax_graph
from clsr_tpu.data.vocab import Vocab as JaxVocab
from clsr_tpu.models.registry import get_model_class as jax_model_class
from clsr_tpu.ops.pallas_attention import _xla_train_scorer
from clsr_tpu.parallel import rowmap as jrowmap
from clsr_tpu.parallel.embedding import gather_rows as jax_gather_rows
from clsr_tpu.parallel.embedding import use_sharded_tables
from clsr_tpu.serving import ScoreRequest as JaxRequest
from clsr_tpu.serving import ScoringService as JaxService
from clsr_tpu.training.lazy_adam import make_lazy_optimizer
from clsr_tpu.training.optimizer import build_optimizer
from clsr_tpu.training.state import TrainState as JaxTrainState
from clsr_tpu_torch import weights
from clsr_tpu_torch.config import load_config
from clsr_tpu_torch.data.graph import build_graph_from_sequences
from clsr_tpu_torch.data.vocab import Vocab
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.parallel import collectives as col
from clsr_tpu_torch.parallel import rowmap
from clsr_tpu_torch.parallel.distributed import run_local_world
from clsr_tpu_torch.serving import ScoreRequest, ScoringService
from clsr_tpu_torch.training.state import create_train_state
from clsr_tpu_torch.training.steps import (make_histogram_step,
                                           make_train_step)

import torch_mesh_worker
from test_torch_common import (TOL, jax_batch, numpy_batch, perturb,
                               port_cfg, small_jax_cfg)

SIZES = (8, 24, 5)          # users, items (row-sharded), cates (replicated)
B, G, L = 16, 4, 7
STEP_CFG = dict(need_sample=False, train_num_ngs=G - 1, batch_size=B,
                embed_l2=1e-4, layer_l2=1e-4, contrastive_length_threshold=2,
                max_grad_norm=0.2, enable_bn=True, max_seq_length=L)
STEPS = {"dense": dict(optimizer="adam", mesh_flat_batch="on"),
         "legacy": dict(optimizer="lazyadam", compact_rows="off",
                        mesh_flat_batch="on")}
PORT_ONLY = {"dense": dict(use_pallas_train_attention="on")}
# LGN (dense Adam only, no BN): its user and item tables row-sharded
LGN = dict(model_type="lgn", n_layers=2, optimizer="adam", enable_bn=False)
LGN_STEPS = {"lgn_flat": dict(mesh_flat_batch="on"),
             "lgn": dict(mesh_flat_batch="off"),
             "lgn_interleaved": dict(mesh_flat_batch="on",
                                     mesh_row_layout="interleaved")}
# JAX's LGN reads a placed table's physical rows as logical ones, so its
# mesh step under interleaved rows is not its one-device step: that case
# is held to the one-rank port alone
JAX_LGN = ("lgn_flat", "lgn")
# the static reduce_grads' cases: tables larger than a batch's ids, so
# that the padded row set is shorter than the block and longer than the
# touched rows
STATIC_ROWS_SIZES = (64, 400, 5)
GATHERS = [(2, 2, False, "contiguous"), (2, 2, True, "contiguous"),
           (2, 2, False, "interleaved"), (2, 2, True, "interleaved"),
           (1, 4, False, "contiguous"), (1, 4, True, "contiguous")]
SHARDED = ["item_embedding", "user_long_embedding", "user_short_embedding"]
ADAM_B1, ADAM_B2 = 0.9, 0.999           # optax.adam's, torch.optim.Adam's
# zero gradient by construction: Adam's steps are rounding noise's signs
FLIPS = re.compile(r"(w_nn_layer\d+/bias|logit_fcn/w_nn_output/bias|"
                   r"att_fcn/w_nn_output/bias|bn\d+/mean)$")
_MAPS = ({f"u{i}": i for i in range(SIZES[0])},
         {f"i{i}": i for i in range(SIZES[1])},
         {f"c{i}": i for i in range(SIZES[2])})


_JAX_MAKE_MESH = jax_mesh.make_mesh


def jax_mesh_of(d, m):
    return _JAX_MAKE_MESH(d, m, devices=jax.devices()[:d * m])


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in
            tu.flatten_dict(tree).items()}


def _sequences(seed=5):
    """Full-history sequences over SIZES for LGN's graph."""
    rng = np.random.RandomState(seed)
    out = []
    for s in range(SIZES[0] + 3):
        n = rng.randint(1, 9)
        out.append((s % SIZES[0],
                    [int(i) for i in rng.randint(0, SIZES[1], n)],
                    [int(c) for c in rng.randint(0, SIZES[2], n)]))
    return out


def _graphs():
    """(JAX's LGN graph, the port's)."""
    seqs = _sequences()
    return (jax_graph(seqs, SIZES[0], SIZES[1]),
            build_graph_from_sequences(seqs, SIZES[0], SIZES[1]))


def _jax_model(jcfg):
    kw = {"graph": _graphs()[0]} if jcfg.model_type == "lgn" else {}
    return jax_model_class(jcfg.model_type)(cfg=jcfg, **_sizes_kw(), **kw)


def _variables(jcfg, seed=0):
    model = _jax_model(jcfg)
    sample = jax_batch(numpy_batch(np.random.RandomState(seed), 2, G, L,
                                   **_sizes_kw()))
    variables = jax.jit(model.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed + 1)}, sample, train=True)
    rng = np.random.RandomState(seed + 7)
    return (model, perturb(variables["params"], rng),
            perturb(variables.get("batch_stats", {}), rng))


def _sizes_kw():
    return dict(n_users=SIZES[0], n_items=SIZES[1], n_cates=SIZES[2])


def _port_model(jcfg, **kw):
    """The port's model of a JAX config (one rank), LGN with its graph."""
    cfg = port_cfg(jcfg, **kw)
    graph = {"graph": _graphs()[1]} if cfg.model_type == "lgn" else {}
    return get_model_class(cfg.model_type)(cfg, *SIZES, device="cpu",
                                           **graph)


def _state_dict(jcfg, params, stats):
    """The port's logical state_dict (numpy) of the flax trees."""
    model = _port_model(jcfg)
    weights.from_flax(model, params, stats)
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def _train_batch(seed):
    b = numpy_batch(np.random.RandomState(seed), B, G, L, **_sizes_kw())
    b["labels"][:, 0] = 1.0
    return b


def _jax_state(model, jcfg, params, stats):
    if jcfg.optimizer == "lazyadam":
        init_fn, _ = make_lazy_optimizer(jcfg)
        return JaxTrainState(step=jnp.zeros((), jnp.int32),
                             apply_fn=model.apply, params=params, tx=None,
                             opt_state=init_fn(params), batch_stats=stats)
    return JaxTrainState.create(apply_fn=model.apply, params=params,
                                batch_stats=stats, tx=build_optimizer(jcfg))


def _requests(cls, seed, n, min_hist=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        hist = rng.randint(1, SIZES[1], rng.randint(min_hist, L + 3))
        cands = rng.randint(1, SIZES[1], rng.randint(1, 12))
        out.append(cls(
            user=f"u{rng.randint(0, SIZES[0])}",
            hist_items=[f"i{i}" for i in hist],
            hist_cates=[f"c{i % SIZES[2]}" for i in hist],
            hist_times=sorted(1_500_600_000 - rng.randint(60, 10 ** 6,
                                                          len(hist))),
            current_time=1_500_600_000,
            cand_items=[f"i{c}" for c in cands],
            cand_cates=[f"c{c % SIZES[2]}" for c in cands]))
    return out


def _spec():
    """The world's inputs, and what JAX needs to hold it to them."""
    base = small_jax_cfg(**STEP_CFG)
    rng = np.random.RandomState(5)
    gather = {}
    for key in GATHERS:
        gather[key] = dict(
            table=rng.randn(SIZES[1], 5).astype(np.float32),
            ids=rng.randint(0, SIZES[1], (B, 3)).astype(np.int32),
            w=rng.randn(B, 3, 5).astype(np.float32))
    D, Dk, H0, H1 = 6, 5, 8, 4
    k3 = dict(keys=rng.randn(B, L, Dk), keys_proj=rng.randn(B, L, D),
              query=rng.randn(B, G, D),
              mask=(np.arange(L)[None] < rng.randint(1, L + 1, B)[:, None]),
              k0=rng.randn(4 * D, H0) * 0.3, b0=rng.randn(H0) * 0.1,
              scale0=1 + 0.2 * rng.randn(H0), shift0=0.1 * rng.randn(H0),
              w1=rng.randn(H0, H1) * 0.3, b1=rng.randn(H1) * 0.1,
              scale1=1 + 0.2 * rng.randn(H1), shift1=0.1 * rng.randn(H1),
              w2=rng.randn(H1) * 0.5, cot=rng.randn(B, G, Dk))
    k3 = {k: np.asarray(v, np.float32) for k, v in k3.items()}
    steps, jax_side = {}, {}
    _, params, stats = _variables(base)         # one init serves every case
    for name, kw in STEPS.items():
        jcfg = small_jax_cfg(**STEP_CFG, **kw, data_parallel=2,
                             model_parallel=2)
        model = _jax_model(jcfg)
        batch = _train_batch(10 + len(steps))
        cfg = dict(dataclasses.asdict(jcfg), **PORT_ONLY.get(name, {}))
        steps[name] = dict(cfg=cfg, batch=batch,
                           state_dict=_state_dict(jcfg, params, stats))
        jax_side[name] = (model, jcfg, params, stats, batch)
    _, lparams, lstats = _variables(small_jax_cfg(**dict(STEP_CFG, **LGN)))
    for i, (name, kw) in enumerate(LGN_STEPS.items()):
        jcfg = small_jax_cfg(**dict(STEP_CFG, **LGN), **kw,
                             data_parallel=2, model_parallel=2)
        batch = _train_batch(30 + i)
        steps[name] = dict(cfg=dataclasses.asdict(jcfg), batch=batch,
                           state_dict=_state_dict(jcfg, lparams, lstats),
                           graph=_graphs()[1])
        if name in JAX_LGN:
            jax_side[name] = (_jax_model(jcfg), jcfg, lparams, lstats,
                              batch)
    ecfg = small_jax_cfg(**STEP_CFG, data_parallel=2, model_parallel=2)
    emodel, eparams, estats = _jax_model(ecfg), params, stats
    eval_batch = numpy_batch(np.random.RandomState(3), 10, 9, L,
                             **_sizes_kw())
    static_rows = {
        name: dict(cfg=dataclasses.asdict(small_jax_cfg(
            **STEP_CFG, optimizer="adam", mesh_flat_batch=flat,
            data_parallel=2, model_parallel=2)), batch=_train_batch(50 + i),
            state_dict=None, sizes=STATIC_ROWS_SIZES)
        for i, (name, flat) in enumerate((("dense_replicated", "off"),
                                          ("dense_flat", "on")))}
    static_rows.update({name: steps[name] for name in ("lgn", "lgn_flat")})
    spec = dict(base_cfg=dataclasses.asdict(base), sizes=SIZES, gather=gather,
                k3=k3, steps=steps, static_rows=static_rows,
                eval=dict(cfg=dict(dataclasses.asdict(ecfg),
                                   use_pallas_eval_attention="on"),
                          batch=eval_batch,
                          state_dict=_state_dict(ecfg, eparams, estats)),
                serve=dict(cfg=dict(dataclasses.asdict(ecfg),
                                    use_pallas_eval_attention="on"),
                           maps=_MAPS,
                           requests=_requests(ScoreRequest, 4, 11),
                           async_requests=_requests(ScoreRequest, 6, 40,
                                                    min_hist=1),
                           w=_state_dict(ecfg, eparams, estats),
                           w2=_state_dict(ecfg, *_variables(base, 1)[1:])))
    return spec, jax_side, (emodel, ecfg, eparams, estats, eval_batch)


def _service(case, path=None, **kw):
    """A one-rank ScoringService of the serve case's config."""
    return ScoringService(load_config(None, **dict(
        case["cfg"], data_parallel=1, model_parallel=1)), *SIZES,
        *(Vocab(m) for m in case["maps"]), checkpoint=path,
        batch_buckets=(8, 64), cand_buckets=(16, 128), device="cpu", **kw)


def _weights_file(sd, path):
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(path))
    return str(path)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's results (run in a thread) and the JAX references."""
    spec, jax_side, jeval = _spec()
    tmp = tmp_path_factory.mktemp("parallel")
    serve = spec["serve"]
    serve["dir"] = str(tmp)
    # the one-rank services' files of w2, for the mesh to load
    w2 = _weights_file(serve["w2"], tmp / "w2.pt")
    _service(serve, w2).save(str(tmp / "one.pt"))
    _service(serve, w2, int8_tables=True).save(str(tmp / "one_int8.pt"))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_local_world, torch_mesh_worker.parallel_world, 4,
                      "gloo", "cpu", (spec,), 300.0)
    try:
        refs = _jax_references(spec, jax_side, jeval)
        ranks = fut.result()
    finally:
        pool.shutdown(wait=True)
    return spec, ranks, refs


def _jax_gather(case, d, m, flat, layout):
    mesh = jax_mesh_of(d, m)
    il = layout == "interleaved"
    w = jnp.asarray(case["w"])

    def loss(table, ids):
        with use_sharded_tables(mesh, flat, il):
            out = jax_gather_rows(table, ids)
        return jnp.sum(out * w), out

    phys = jrowmap.interleave_rows(case["table"], m) if il else case["table"]
    (_, out), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(phys), jnp.asarray(case["ids"]))
    grad = np.asarray(grad)
    return np.asarray(out), (jrowmap.deinterleave_rows(grad, m) if il
                             else grad)


def _jax_k3(case):
    mesh = jax_mesh_of(2, 2)
    axes = ("data", "model")
    names = ("k0", "b0", "scale0", "shift0", "w1", "b1", "scale1", "shift1",
             "w2")
    t3 = P(axes, None, None)

    def local(k, kp, q, m, *ps):
        return _xla_train_scorer(k, kp, q, m, *ps, psum_axes=axes)

    fn = jax.shard_map(local, mesh=mesh,
                       in_specs=(t3, t3, t3, P(axes, None))
                       + (P(),) * len(names),
                       out_specs=(t3, P(), P(), P(), P()), check_vma=False)
    args = [jnp.asarray(case[k]) for k in ("keys", "keys_proj", "query")]
    mask = jnp.asarray(case["mask"])
    params = [jnp.asarray(case[k]) for k in names]

    def f(k, kp, q, *ps):
        return fn(k, kp, q, mask, *ps)

    @jax.jit
    def value_and_grads(cot, *a):
        out, vjp = jax.vjp(f, *a)
        return out, vjp((cot,) + tuple(jnp.zeros_like(o) for o in out[1:]))

    out, grads = value_and_grads(jnp.asarray(case["cot"]), *args, *params)
    ref = {"att": np.asarray(out[0]),
           "stats": [np.asarray(o) for o in out[1:]]}
    for name, g in zip(("keys", "keys_proj", "query") + names, grads):
        ref[f"d_{name}"] = np.asarray(g)
    return ref


def _jax_references(spec, jax_side, jeval):
    refs = {}
    for key in GATHERS:
        refs[("gather",) + key] = _jax_gather(spec["gather"][key], *key)
    refs["k3"] = _jax_k3(spec["k3"])
    mesh = jax_mesh_of(2, 2)
    for name, (model, jcfg, params, stats, batch) in jax_side.items():
        state = _jax_state(model, jcfg, params, stats)
        flat = jax_mesh.resolve_flat_batch(jcfg)
        step = jax_mesh.make_sharded_train_step(model, jcfg, mesh, state,
                                                True, flat)
        placed = jax_mesh.place_state(state, mesh, True, jcfg)
        new, parts = step(placed, jax_mesh.shard_batch(jax_batch(batch),
                                                       mesh, flat),
                          jax.random.PRNGKey(0))
        refs[("step", name)] = (jax.device_get(new), jax.device_get(parts))
    model, ecfg, params, stats, batch = jeval
    state = _jax_state(model, ecfg, params, stats)
    flat = jax_mesh.resolve_flat_batch(ecfg)
    estep = jax_mesh.make_sharded_eval_step(model, ecfg, mesh, state, True,
                                            flat)
    rows = batch["users"].shape[0]
    padded = {k: np.concatenate([v, np.zeros((-rows % 4,) + v.shape[1:],
                                              v.dtype)])
              for k, v in batch.items()}
    preds, alpha = estep(jax_mesh.place_state(state, mesh, True, ecfg),
                         jax_mesh.shard_batch(jax_batch(padded), mesh, flat))
    refs["eval"] = (np.asarray(preds)[:rows], np.asarray(alpha)[:rows])
    with pytest.MonkeyPatch.context() as mp:
        # JAX's service on 4 of the 8 devices, built around the perturbed
        # state (its own init draws other weights, op by op)
        mp.setattr(jax_mesh, "make_mesh",
                   lambda d, m, devices=None: jax_mesh_of(d, m))
        mp.setattr(jax_serving, "create_train_state",
                   lambda model, cfg, sample: _jax_state(model, cfg, params,
                                                         stats))
        for key, kw in (("serve", {}), ("serve_int8",
                                         dict(int8_tables=True))):
            jsvc = JaxService(ecfg, *SIZES, *(JaxVocab(m) for m in _MAPS),
                              batch_buckets=(8, 64), cand_buckets=(16, 128),
                              **kw)
            refs[key] = jsvc.score(_requests(JaxRequest, 4, 11))
        refs["serve_async"] = jsvc.__class__(
            ecfg, *SIZES, *(JaxVocab(m) for m in _MAPS),
            batch_buckets=(8, 64), cand_buckets=(16, 128)).score(
                _requests(JaxRequest, 6, 40, min_hist=1))
    return refs


# ------------------------------------------------------------- rowmap


def test_rowmap_matches_jax():
    ids = np.arange(-2, 26)
    for m, rows, il in ((2, 12, False), (2, 12, True), (4, 6, True),
                        (4, 6, False)):
        for got, want in zip(rowmap.owner_local(ids, m, rows, il),
                             jrowmap.owner_local(ids, m, rows, il)):
            np.testing.assert_array_equal(got, want)
        x = np.arange(24 * 3).reshape(24, 3)
        phys = rowmap.interleave_rows(x, m)
        np.testing.assert_array_equal(phys, jrowmap.interleave_rows(x, m))
        np.testing.assert_array_equal(rowmap.deinterleave_rows(phys, m), x)
        t = torch.from_numpy(x)
        assert torch.equal(rowmap.interleave_rows(t, m),
                           torch.from_numpy(phys))
        for j in range(m):      # rank j's block of the physical layout
            np.testing.assert_array_equal(
                rowmap.shard_block(x, m, j, il),
                (phys if il else x)[j * 24 // m:(j + 1) * 24 // m])
    for layout, routing, want in (("auto", "broadcast", False),
                                  ("auto", "owner", True),
                                  ("interleaved", "broadcast", True),
                                  ("contiguous", "owner", False)):
        cfg = small_jax_cfg(mesh_row_layout=layout,
                            mesh_update_routing=routing)
        assert rowmap.resolve_interleaved(cfg) == want == \
            jrowmap.resolve_interleaved(cfg)


# -------------------------------------------------------- collectives


def test_collectives_sum_in_rank_order(world):
    _, ranks, _ = world
    xs = [np.random.RandomState(r).randn(4, 3).astype(np.float32)
          for r in range(4)]
    groups = {"model": lambda r: [2 * (r // 2), 2 * (r // 2) + 1],
              "world": lambda r: [0, 1, 2, 3]}
    for r, out in enumerate(ranks):
        got = out["collectives"]
        for name, members in groups.items():
            ms = members(r)
            n, k = len(ms), ms.index(r)
            total = xs[ms[0]]
            for q in ms[1:]:
                total = total + xs[q]
            np.testing.assert_array_equal(got[f"{name}/all_reduce"], total)
            np.testing.assert_array_equal(got[f"{name}/all_reduce_again"],
                                          total)
            np.testing.assert_array_equal(got[f"{name}/all_gather"],
                                          np.stack([xs[q] for q in ms]))
            rs = xs[ms[0]][k]
            for q in ms[1:]:
                rs = rs + xs[q][k]
            np.testing.assert_array_equal(got[f"{name}/reduce_scatter"], rs)
            w = lambda shape, q: np.arange(np.prod(shape), dtype=np.float32
                                           ).reshape(shape) + q
            np.testing.assert_allclose(
                got[f"{name}/all_reduce_grad/grad"],
                sum(w((n, 3), q) for q in ms), rtol=0)


def test_collective_count_replays_a_capture():
    """A CUDA graph replays its collectives without Python: the calls of
    a capture (`capturing`) go to its list alone, none to the open
    recorders, and each `replayed` appends them to every open recorder,
    as ops.launches.add does for the kernels' counters."""
    w = torch.zeros(5, 3)
    with col.count_collectives() as outer:
        col._record("all_gather", w, None, 4)
        with col.capturing() as captured:
            col._record("all_to_all", w, None, 4)
        assert [c.kind for c in captured] == ["all_to_all"]
        assert len(outer) == 1
        with col.count_collectives() as later:
            col.replayed(captured)
            col.replayed(captured)
    assert [c.kind for c in outer] == ["all_gather", "all_to_all",
                                       "all_to_all"]
    assert later == captured * 2
    assert outer[1].received_bytes == 5 * 3 * 4 * 3 // 4
    col.replayed(captured)          # no recorder open: nothing to add


@pytest.mark.parametrize("name", ["dense_replicated", "dense_flat", "lgn",
                                  "lgn_flat"])
def test_reduce_grads_static_rows_equal_nonzero_bit_for_bit(world, name):
    """reduce_grads' static row set (the touched rows, padded with row 0
    to the most the column's batch can touch, no host sync) gives the
    bits of its host-synced nonzero() form: loss parts, every parameter,
    BN statistic and dense Adam moment, under dense Adam with a
    replicated and a flat batch (tables past the batch's ids, so the set
    is padded) and for LGN (every row)."""
    _, ranks, _ = world
    for r in ranks:
        static, nonzero = r[("static_rows", name)]
        assert static["parts"] == nonzero["parts"]
        for part in ("state_dict", "dense_moments"):
            assert static[part].keys() == nonzero[part].keys()
            for k, v in nonzero[part].items():
                np.testing.assert_array_equal(static[part][k], v, err_msg=k)
        sharded = [c for c in static["calls"] if c[0] == "all_reduce"
                   and c[1] == "data" and c[3] == "torch.float32"
                   and len(c[2]) == 2]
        assert sharded, static["calls"]


# ----------------------------------------------------------- lookups


@pytest.mark.parametrize("key", GATHERS, ids=lambda k: f"{k[0]}x{k[1]}-"
                         f"{'flat' if k[2] else 'replicated'}-{k[3]}")
def test_gather_rows_and_table_grad_match_jax(world, key):
    _, ranks, refs = world
    out, grad = refs[("gather",) + key]
    for r in ranks:
        got = r[("gather",) + key]
        np.testing.assert_allclose(got["out"], out, **TOL)
        np.testing.assert_allclose(got["grad"], grad, **TOL)


# ------------------------------------------------------ global BN (K3)


def test_train_scorer_global_statistics_match_jax_mesh(world):
    _, ranks, refs = world
    want = refs["k3"]
    for r in ranks:
        got = r["k3"]
        assert got["launches"] == (0, 0)        # the plain versions ran
        for k, v in want.items():
            if k == "stats":
                for g, w in zip(got[k], v):
                    np.testing.assert_allclose(g, w, **TOL)
            else:
                np.testing.assert_allclose(got[k], v, **TOL, err_msg=k)
    for r in ranks[1:]:     # the statistics are bit-identical on every rank
        for g, w in zip(r["k3"]["stats"], ranks[0]["k3"]["stats"]):
            np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------- steps


@pytest.mark.parametrize("name", sorted(STEPS))
def test_train_step_matches_jax_mesh(world, name):
    spec, ranks, refs = world
    new, parts = refs[("step", name)]
    jcfg = small_jax_cfg(**STEP_CFG, **STEPS[name])
    for r in ranks:
        got = r[("step", name)]
        for field, value in got["parts"].items():
            np.testing.assert_allclose(value, float(getattr(parts, field)),
                                       **TOL, err_msg=field)
        model = get_model_class("clsr")(port_cfg(jcfg), *SIZES, device="cpu")
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in got["state_dict"].items()})
        gp, gs = map(_flat, weights.to_flax(model))
        want = dict(_flat(new.params), **{f"stats/{k}": v for k, v in
                                          _flat(new.batch_stats).items()})
        got_all = dict(gp, **{f"stats/{k}": v for k, v in gs.items()})
        assert got_all.keys() == want.keys()
        for k, v in got_all.items():
            if FLIPS.search(k):
                assert np.abs(v - want[k]).max() <= 2.1 * jcfg.learning_rate
            else:
                np.testing.assert_allclose(v, want[k], **TOL, err_msg=k)
        _assert_adam_moments_match(got["dense_moments"], model, new,
                                   jcfg.optimizer == "lazyadam")
        if jcfg.optimizer == "lazyadam":
            jm = {"/".join(k): np.asarray(v) for k, v in
                  new.opt_state.moments.items()}
            assert got["moments"].keys() == jm.keys()
            for k, v in got["moments"].items():
                np.testing.assert_allclose(v, jm[k], **TOL, err_msg=k)
            assert got["count"] == int(new.opt_state.count) == 1
        else:
            _assert_sharded_clip_engaged(got, jcfg.max_grad_norm)
    for r in ranks[1:]:     # every rank holds the same logical state
        for k, v in r[("step", name)]["state_dict"].items():
            np.testing.assert_array_equal(
                v, ranks[0][("step", name)]["state_dict"][k])


def _jax_adam_moments(new, lazy):
    """optax's flattened Adam (mu, nu) of a JAX state, split back per
    parameter (flax name) in the order optax.flatten ravels them: every
    parameter, or under lazyadam the dense ones."""
    tree = new.opt_state.dense_opt if lazy else new.opt_state
    adam = [s for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    params = {k: v for k, v in tu.flatten_dict(new.params).items()
              if not (lazy and str(k[-1]).endswith("_embedding"))}
    out, off = ({}, {}), 0
    for key in sorted(params):
        n = params[key].size
        for tree, flat in zip(out, (adam.mu, adam.nu)):
            tree["/".join(key)] = np.asarray(flat[off:off + n]).reshape(
                params[key].shape)
        off += n
    assert off == adam.mu.size
    return out


def _assert_adam_moments_match(got, model, new, lazy):
    """The port's dense Adam moments (logical) against optax's, in the
    gradient's own units: after one step exp_avg = (1 - b1) g and
    exp_avg_sq = (1 - b2) g^2, so g and |g| are held to TOL (a gradient
    off by a constant factor shows here, not in Adam's ~lr sign(g)
    step)."""
    mu, nu = _jax_adam_moments(new, lazy)
    names = weights.flax_names(model)
    params = dict(model.named_parameters())
    assert set(got) == {f"{key}/{n}" for n in params
                        if not (lazy and n.endswith("_embedding"))
                        for key in ("exp_avg", "exp_avg_sq")}
    for name in params:
        if f"exp_avg/{name}" not in got:
            continue
        _, flax, transpose = names[name]
        for key, want, to_grad in (
                ("exp_avg", mu[flax], lambda m: m / (1 - ADAM_B1)),
                ("exp_avg_sq", nu[flax],
                 lambda v: np.sqrt(v / (1 - ADAM_B2)))):
            want = want.T if transpose else want
            np.testing.assert_allclose(to_grad(got[f"{key}/{name}"]),
                                       to_grad(want), **TOL,
                                       err_msg=f"{key}/{name}")


def _assert_sharded_clip_engaged(got, max_norm):
    """Each row-sharded table's gradient was clipped by its whole
    table's norm (summed over the model row, past each rank's block's):
    the logical gradient after the clip (exp_avg / (1 - b1)) has norm
    min(whole, max_grad_norm).  The item table's clip engages, and on
    the whole norm only: its rank's block alone is under max_grad_norm."""
    norms = {n: got["clip_norms"][n] for n in SHARDED}
    for name, (local, whole) in norms.items():
        assert 0 < local < whole, norms
        g = got["dense_moments"][f"exp_avg/{name}"] / (1 - ADAM_B1)
        np.testing.assert_allclose(np.linalg.norm(g), min(whole, max_norm),
                                   rtol=1e-5, err_msg=name)
    local, whole = norms["item_embedding"]
    assert local < max_norm < whole, norms


# ------------------------------------------------------ eval, serving


def test_mesh_eval_and_service_match_jax_mesh(world):
    spec, ranks, refs = world
    preds, alpha = refs["eval"]
    for r in ranks:
        np.testing.assert_allclose(r["eval"]["preds"], preds, **TOL)
        np.testing.assert_allclose(r["eval"]["alpha"], alpha, **TOL)
        assert r["serve"]["n_batch"] == 4           # flat, rows padded
        assert r["serve"]["sharded"] == SHARDED
        assert len(r["serve"]["scores"]) == len(refs["serve"])
        for g, w in zip(r["serve"]["scores"], refs["serve"]):
            np.testing.assert_allclose(g, w, **TOL)


# ------------------------------------------------------------------ LGN


def _one_rank_step(case):
    """One train step of the port on one rank from the case's state."""
    cfg = load_config(None, **dict(case["cfg"], data_parallel=1,
                                   model_parallel=1))
    model = get_model_class("lgn")(cfg, *SIZES, device="cpu",
                                   graph=case["graph"])
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in case["state_dict"].items()})
    state = create_train_state(model, cfg)
    state, parts = make_train_step(model, cfg)(
        state, torch_mesh_worker.batch_of(case["batch"]),
        torch.Generator().manual_seed(0))
    return (torch_mesh_worker.parts_of(parts),
            {k: v.numpy() for k, v in model.state_dict().items()})


@pytest.mark.parametrize("name", sorted(LGN_STEPS))
def test_lgn_step_matches_jax_mesh_and_one_rank(world, name):
    spec, ranks, refs = world
    case = spec["steps"][name]
    one_parts, one_sd = _one_rank_step(case)
    jcfg = small_jax_cfg(**dict(STEP_CFG, **LGN), **LGN_STEPS[name])
    for r in ranks:
        got = r[("step", name)]
        for field, value in got["parts"].items():
            np.testing.assert_allclose(value, one_parts[field], **TOL,
                                       err_msg=field)
        for k, v in got["state_dict"].items():
            np.testing.assert_allclose(v, one_sd[k], **TOL, err_msg=k)
        if name in JAX_LGN:
            new, parts = refs[("step", name)]
            for field, value in got["parts"].items():
                np.testing.assert_allclose(
                    value, float(getattr(parts, field)), **TOL,
                    err_msg=field)
            model = _port_model(jcfg)
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in got["state_dict"].items()})
            gp, want = _flat(weights.to_flax(model)[0]), _flat(new.params)
            assert gp.keys() == want.keys()
            for k, v in gp.items():
                np.testing.assert_allclose(v, want[k], **TOL, err_msg=k)
        # the forward gathers each sharded block once over the model row
        # (user [8/2, 12], item [24/2, 8]); cates (5 rows) stay replicated
        gathers = [c for c in got["calls"]
                   if c[:2] == ("all_gather", "model")
                   and c[2] in ((4, 12), (12, 8))]
        assert sorted(c[2] for c in gathers) == [(4, 12), (12, 8)]
        assert all(c[5] == c[4] for c in gathers)   # (m - 1) x the block
    for r in ranks[1:]:
        for k, v in r[("step", name)]["state_dict"].items():
            np.testing.assert_array_equal(
                v, ranks[0][("step", name)]["state_dict"][k])


# ----------------------------------------------------------- histograms


def test_mesh_histograms_match_one_rank(world):
    spec, ranks, _ = world
    case = spec["eval"]
    model = get_model_class("clsr")(load_config(None, **dict(
        case["cfg"], data_parallel=1, model_parallel=1)), *SIZES,
        device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in case["state_dict"].items()})
    want = make_histogram_step()(model, torch_mesh_worker.batch_of(
        case["batch"]))
    assert {"alpha", "item_embedding_output"} <= set(want)
    for r in ranks:
        assert r["hist"].keys() == want.keys()
        for tag, (counts, lo, hi, nonfinite) in want.items():
            g = r["hist"][tag]
            assert np.abs(g[0] - counts.numpy()).sum() <= 2, tag
            assert g[0].sum() == counts.numpy().sum() and g[3] == nonfinite
            np.testing.assert_allclose([g[1], g[2]], [float(lo), float(hi)],
                                       **TOL, err_msg=tag)


# ------------------------------------------------- int8, async, save/load


def _equal(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def test_int8_tables_on_mesh_match_jax_mesh_and_one_rank(world):
    spec, ranks, refs = world
    serve = spec["serve"]
    path = _weights_file(serve["w"], serve["dir"] + "/w_one.pt")
    one = _service(serve, path, int8_tables=True).score(serve["requests"])
    for r in ranks:
        got = r["serve"]["scores_int8"]
        assert r["serve"]["sharded_int8"] == sorted(
            SHARDED + [f"{n}_scales" for n in SHARDED])
        assert _equal(got, one)
        assert len(got) == len(refs["serve_int8"])
        for g, w in zip(got, refs["serve_int8"]):
            np.testing.assert_allclose(g, w, **TOL)


def test_async_mesh_service_follows_rank_zero(world):
    _, ranks, refs = world
    scores, dispatches, steps, sync = ranks[0]["serve"]["async"]
    assert dispatches >= 5 and len(steps) >= dispatches
    assert _equal(scores, sync)
    assert len(scores) == len(refs["serve_async"])
    for g, w in zip(scores, refs["serve_async"]):
        np.testing.assert_allclose(g, w, **TOL)
    for r in ranks[1:]:
        msg, n, got_steps, got_sync = r["serve"]["async"]
        assert "rank 0 takes the requests" in msg
        assert (n, got_steps) == (dispatches, steps)
        assert _equal(got_sync, sync)


def test_async_mesh_service_fails_a_bad_dispatch_and_stops_on_a_step(world):
    _, ranks, _ = world
    zero = ranks[0]["serve"]["async_faults"]
    assert zero["plan_errors"] == ["RuntimeError", "RuntimeError"]
    assert np.array_equal(zero["good"], zero["want"])
    assert zero["step_error"] == "injected step failure"
    assert "the mesh service stopped" in zero["refused"]
    assert "injected step failure" in zero["refused"]
    for r in ranks:
        got = r["serve"]["async_faults"]
        # the failed plan sent nothing: one dispatch, one good step and
        # the failing one on every rank
        assert (got["dispatches"], got["steps"]) == (1, 2)
        assert got["error"] == "injected step failure"


def test_sharded_service_save_and_load_move_both_ways(world):
    spec, ranks, _ = world
    serve, reqs = spec["serve"], spec["serve"]["requests"]
    d = serve["dir"]
    w = _weights_file(serve["w"], d + "/w_one.pt")
    for mesh_file, kw in (("mesh.pt", {}),
                          ("mesh_int8.pt", dict(int8_tables=True))):
        want = _service(serve, w, **kw)
        svc = _service(serve, **kw)
        svc.load(f"{d}/{mesh_file}")
        got_sd, want_sd = svc.model.state_dict(), want.model.state_dict()
        assert got_sd.keys() == want_sd.keys()
        for k in want_sd:
            assert torch.equal(got_sd[k], want_sd[k]), k
        assert _equal(svc.score(reqs), want.score(reqs))
    for r in ranks:
        res = r["serve"]
        assert _equal(res["scores_loaded"], res["scores_w2"])
        assert _equal(res["scores_loaded_int8"], res["scores_w2_int8"])
        assert not _equal(res["scores_w2"], res["scores"])
