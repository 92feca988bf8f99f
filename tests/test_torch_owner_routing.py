"""The port's owner-routed mesh merge against JAX's and its own broadcast
merge, and the collective-byte count.

One 4-rank gloo world at (2, 2) (tests/torch_mesh_worker.py
`owner_world`) runs the port's steps on numpy inputs made here, while
JAX's `make_sharded_train_step` runs the same steps here on 4 of the 8
CPU devices, every step from one perturbed state, negatives injected
(need_sample False):

  * one compact-lazyadam step with `mesh_update_routing: owner`
    (capacity 4, the interleaved row layout that 'auto' then takes) for
    CLSR, flat batch and replicated batch (cates, 5 rows, do not divide
    model_parallel and keep the broadcast merge, as JAX's
    `test_owner_replicated_table_fallback`), and for GRU4Rec with a flat
    batch: the loss parts, every parameter and pmn row to 1e-5 (JAX's
    physical rows de-interleaved), the zero-gradient biases within
    Adam's sign-flip bound, 2.1 lr, as tests/test_torch_mesh_train.py;
    route_overflow 0, as JAX's;
  * GRU4Rec's broadcast step against JAX's mesh (the zoo on a mesh);
  * two GRU4Rec steps under `mesh_owner_overflow: drop` at a capacity
    that overflows: route_overflow after each step equal to JAX's
    exactly, and the state after them to the same tolerances (2.1 lr a
    step for the flips);
  * under `fallback` at a capacity that overflows on every step (C = 1),
    flat and not: the loss parts and the whole state bit for bit those
    of the broadcast merge on the same layout, with route_overflow > 0;
  * the owner merge against the port's broadcast merge, flat and not,
    to 1e-5;
  * the byte count (parallel/collectives.py `count_collectives`): the
    broadcast merge all_gathers the item table's [Mi, D] gradient
    stream; under `drop` no all_gather or all_to_all carries as many
    floats, its all_to_all is [m, C, D + 1] with JAX's C, and the
    merge's bytes received are below the broadcast's;
  * the owner merge's one host read a step (training/lazy_adam.py
    `MeshMerge`: every table's buckets and overflow count first, then
    each table's branch): against JAX's `lax.cond` mesh step (1e-5)
    where every step overflows (C = 1) and at a capacity where one
    table overflows and another does not, and bit for bit against the
    merges it composes: with no overflow, fallback equals drop (no
    read); with one table overflowing, after one step that table's rows
    equal the broadcast merge's and the others' the drop merge's, and
    every dense tensor and loss part equals both;
  * the port's scaling model (clsr_tpu_torch/scaling_model.py), JAX's
    tests/test_scaling_model.py cases on the port's own byte count
    (`count_step_calls`, one GRU4Rec step a topology in this world): the
    mesh's group labels and members at (4, 1), (2, 2) and (1, 4); the
    broadcast merge's all_gather of the [Mi, D] stream received as (n -
    1) x its payload (the port's all_gather, not a ring's (n - 1) / n);
    the bytes affine in the per-rank batch (the increments from b = 2
    to 4 to 8 in the ratio 1.8-2.2); owner routing at capacity 1 under
    drop below the broadcast merge at (1, 4), and (1, 4) moving the
    cross-host ('data', 'world') bytes onto 'model' against (4, 1); and
    the efficiency formulas on fixed numbers.
"""

import concurrent.futures
import dataclasses
import re

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clsr_tpu.parallel.mesh as jax_mesh
from clsr_tpu.config import Config as JaxConfig
from clsr_tpu.models.registry import get_model_class as jax_model_class
from clsr_tpu.parallel import rowmap as jrowmap
from clsr_tpu.training.lazy_adam import make_lazy_optimizer
from clsr_tpu.training.state import TrainState as JaxTrainState
from clsr_tpu_torch import scaling_model, weights
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.parallel.distributed import run_local_world

import torch_mesh_worker
from test_torch_common import (TOL, jax_batch, numpy_batch, perturb,
                               port_cfg)

L, G, B = 6, 4, 16
MESH = dict(data_parallel=2, model_parallel=2)
WIDTHS = dict(user_vocab="u", item_vocab="i", cate_vocab="c",
              max_seq_length=L, hidden_size=12, item_embedding_dim=8,
              cate_embedding_dim=4, user_embedding_dim=12,
              layer_sizes=(10, 6), activation=("relu",),
              att_fcn_layer_sizes=(8, 4), seed=3, need_sample=False,
              train_num_ngs=G - 1, batch_size=B, optimizer="lazyadam",
              embed_l2=1e-4, layer_l2=1e-4, contrastive_length_threshold=2,
              max_grad_norm=0.5, enable_bn=False)
# users, items, cates: CLSR's cates (5) stay replicated, GRU4Rec's shard
SIZES = {"clsr": (8, 24, 5), "gru4rec": (8, 24, 6)}
OWNER = dict(mesh_update_routing="owner", mesh_owner_capacity=4.0)
FLAT, NOT_FLAT = dict(mesh_flat_batch="on"), dict(mesh_flat_batch="off")
DROP_CAPACITY = 0.3         # overflows on both steps
# name -> (model, config, steps, held against JAX)
CASES = {
    "clsr_owner_flat": ("clsr", dict(OWNER, **FLAT), 1, True),
    "clsr_owner": ("clsr", dict(OWNER, **NOT_FLAT), 1, True),
    "gru4rec_owner_flat": ("gru4rec", dict(OWNER, **FLAT), 1, True),
    "gru4rec_broadcast": ("gru4rec", FLAT, 1, True),
    "gru4rec_drop": ("gru4rec", dict(FLAT, mesh_update_routing="owner",
                                     mesh_owner_capacity=DROP_CAPACITY,
                                     mesh_owner_overflow="drop"), 2, True),
    "clsr_broadcast_flat": ("clsr", dict(FLAT,
                                         mesh_row_layout="interleaved"),
                            1, False),
    "clsr_broadcast": ("clsr", dict(NOT_FLAT,
                                    mesh_row_layout="interleaved"), 1, False),
}
for _flat, _kw in (("flat", FLAT), ("not_flat", NOT_FLAT)):
    CASES[f"gru4rec_fallback_{_flat}"] = (
        "gru4rec", dict(_kw, mesh_update_routing="owner",
                        mesh_owner_capacity=0.01), 2, _flat == "flat")
    CASES[f"gru4rec_broadcast_il_{_flat}"] = (
        "gru4rec", dict(_kw, mesh_row_layout="interleaved"), 2, False)
# the owner merge's branches: at capacity 0.5 CLSR's user tables
# overflow on both steps and its item table does not
MIXED_CAPACITY = 0.5
CASES["clsr_mixed_flat"] = ("clsr", dict(FLAT, mesh_update_routing="owner",
                                         mesh_owner_capacity=MIXED_CAPACITY),
                            2, True)
# one step each: the mixed fallback and the two merges it composes, and
# no overflow with and without the read
BRANCHES = {
    "mixed": ("clsr", dict(FLAT, mesh_update_routing="owner",
                           mesh_owner_capacity=MIXED_CAPACITY)),
    "mixed_drop": ("clsr", dict(FLAT, mesh_update_routing="owner",
                                mesh_owner_capacity=MIXED_CAPACITY,
                                mesh_owner_overflow="drop")),
    "mixed_broadcast": ("clsr", dict(FLAT, mesh_row_layout="interleaved")),
    "none": ("clsr", dict(OWNER, **FLAT)),
    "none_drop": ("clsr", dict(OWNER, **FLAT, mesh_owner_overflow="drop")),
}
for _name, (_model, _kw) in BRANCHES.items():
    CASES[f"branches_{_name}"] = (_model, _kw, 1, False)
# steps that overflow: held to JAX's overflow counts, not to zero
OVERFLOWING = {"gru4rec_drop", "gru4rec_fallback_flat", "clsr_mixed_flat"}
# the scaling model's byte counts: (routing, d, m, per-rank b) -> one
# GRU4Rec step (owner routing at capacity 1 under drop, as JAX's test)
SCALING_SIZES = (16, 64, 16)            # every table divides m = 4
SCALING = [("broadcast", 2, 2, b) for b in (2, 4, 8)] + [
    ("broadcast", 1, 4, 4), ("owner", 1, 4, 4), ("owner", 4, 1, 4)]
TOPOLOGIES = [(4, 1), (2, 2), (1, 4)]


def _scaling_cfg(routing, d, m, b):
    kw = dict(need_sample=True, batch_size=b * d * m, data_parallel=d,
              model_parallel=m)
    if routing == "owner":
        kw.update(mesh_update_routing="owner", mesh_owner_capacity=1.0,
                  mesh_owner_overflow="drop")
    return _jcfg("gru4rec", **kw)
FLIPS = re.compile(r"(w_nn_layer\d+/bias|logit_fcn/w_nn_output/bias|"
                   r"att_fcn/w_nn_output/bias|bn\d+/mean)$")
_JAX_MAKE_MESH = jax_mesh.make_mesh


def _jcfg(model, **kw):
    return JaxConfig(**dict(WIDTHS, model_type=model, **kw)).validate()


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in
            tu.flatten_dict(tree).items()}


def _sizes_kw(model):
    return dict(zip(("n_users", "n_items", "n_cates"), SIZES[model]))


def _variables(model):
    jcfg = _jcfg(model)
    jmodel = jax_model_class(model)(cfg=jcfg, **_sizes_kw(model))
    sample = jax_batch(numpy_batch(np.random.RandomState(0), 2, G, L,
                                   **_sizes_kw(model)))
    variables = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        sample, train=True)
    rng = np.random.RandomState(7)
    return (perturb(variables["params"], rng),
            perturb(variables.get("batch_stats", {}), rng))


def _batches(model, n, seed):
    out = []
    for i in range(n):
        b = numpy_batch(np.random.RandomState(seed + i), B, G, L,
                        **_sizes_kw(model))
        b["labels"][:, 0] = 1.0
        out.append(b)
    return out


def _jax_steps(model, jcfg, params, stats, batches):
    """JAX's sharded steps: (state, [parts], [route_overflow after each
    step]) on the host."""
    jmodel = jax_model_class(model)(cfg=jcfg, **_sizes_kw(model))
    init_fn, _ = make_lazy_optimizer(jcfg)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                          apply_fn=jmodel.apply, params=params, tx=None,
                          opt_state=init_fn(params), batch_stats=stats)
    mesh = _JAX_MAKE_MESH(2, 2, devices=jax.devices()[:4])
    flat = jax_mesh.resolve_flat_batch(jcfg)
    step = jax_mesh.make_sharded_train_step(jmodel, jcfg, mesh, state, True,
                                            flat)
    st = jax_mesh.place_state(state, mesh, True, jcfg)
    parts, overflow = [], []
    for b in batches:
        st, p = step(st, jax_mesh.shard_batch(jax_batch(b), mesh, flat),
                     jax.random.PRNGKey(0))
        parts.append(jax.device_get(p))
        overflow.append(int(st.opt_state.route_overflow))
    return jax.device_get(st), parts, overflow


@pytest.fixture(scope="module")
def world():
    init = {model: _variables(model) for model in SIZES}
    state_dicts = {}
    for model, (params, stats) in init.items():
        one = get_model_class(model)(port_cfg(_jcfg(model)), *SIZES[model],
                                     device="cpu")
        weights.from_flax(one, params, stats)
        state_dicts[model] = {k: v.numpy().copy()
                              for k, v in one.state_dict().items()}
    cases, batches = {}, {}
    for name, (model, kw, n, _) in CASES.items():
        batches[name] = _batches(model, n, 30)
        cases[name] = dict(
            cfg=dataclasses.asdict(_jcfg(model, **kw, **MESH)),
            state_dict=state_dicts[model], batches=batches[name],
            sizes=SIZES[model])
    groups = {(d, m): dataclasses.asdict(_jcfg("gru4rec", data_parallel=d,
                                               model_parallel=m))
              for d, m in TOPOLOGIES}
    scaling = {key: (dataclasses.asdict(_scaling_cfg(*key)), SCALING_SIZES)
               for key in SCALING}
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_local_world, torch_mesh_worker.owner_world, 4,
                      "gloo", "cpu",
                      (dict(cases=cases, groups=groups, scaling=scaling),),
                      300.0)
    try:
        refs = {}
        for name, (model, kw, n, vs_jax) in CASES.items():
            if vs_jax:
                refs[name] = _jax_steps(model, _jcfg(model, **kw, **MESH),
                                        *init[model], batches[name])
        ranks = fut.result()
    finally:
        pool.shutdown(wait=True)
    return dict(ranks=ranks, refs=refs)


def _logical(name):
    """JAX's physical rows -> logical ones, for a case's layout."""
    model, kw, _, _ = CASES[name]
    jcfg = _jcfg(model, **kw, **MESH)
    if not jrowmap.resolve_interleaved(jcfg):
        return lambda k, v: v
    return lambda k, v: (jrowmap.deinterleave_rows(v, 2)
                         if k.endswith("_embedding") else v)


def _assert_matches_jax(name, got, ref):
    model, kw, n, _ = CASES[name]
    new, parts, overflow = ref
    jcfg = _jcfg(model, **kw)
    logical = _logical(name)
    for g, w in zip(got["parts"], parts):
        for field, value in g.items():
            np.testing.assert_allclose(value, float(getattr(w, field)),
                                       **TOL, err_msg=field)
    assert got["overflow"] == overflow
    want = {k: logical(k, v) for k, v in _flat(new.params).items()}
    pmodel = get_model_class(model)(port_cfg(jcfg), *SIZES[model],
                                    device="cpu")
    pmodel.load_state_dict({k: torch.from_numpy(v)
                            for k, v in got["state_dict"].items()})
    gp, _ = map(_flat, weights.to_flax(pmodel))
    assert gp.keys() == want.keys()
    for k, v in gp.items():
        if FLIPS.search(k):
            assert np.abs(v - want[k]).max() <= 2.1 * n * jcfg.learning_rate
        else:
            np.testing.assert_allclose(v, want[k], **TOL, err_msg=k)
    want_m = {"/".join(k): logical("_embedding", np.asarray(v))
              for k, v in new.opt_state.moments.items()}
    assert got["moments"].keys() == want_m.keys()
    for k, v in got["moments"].items():
        assert v.shape[1] == 3 * dict(pmodel.named_parameters())[k].shape[1]
        np.testing.assert_allclose(v, want_m[k], **TOL, err_msg=k)


@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items()
                                        if c[3] and n not in OVERFLOWING))
def test_owner_and_zoo_steps_match_jax_mesh(world, name):
    for r in world["ranks"]:
        got = r[name]
        assert got["flat"] == (CASES[name][1]["mesh_flat_batch"] == "on")
        _assert_matches_jax(name, got, world["refs"][name])
        assert got["overflow"] == [0]


def test_drop_overflow_count_matches_jax_exactly(world):
    overflow = world["refs"]["gru4rec_drop"][2]
    assert overflow[0] > 0 and overflow[1] > overflow[0]
    for r in world["ranks"]:
        _assert_matches_jax("gru4rec_drop", r["gru4rec_drop"],
                            world["refs"]["gru4rec_drop"])


@pytest.mark.parametrize("flat", ["flat", "not_flat"])
def test_fallback_equals_broadcast_bit_for_bit(world, flat):
    for r in world["ranks"]:
        got = r[f"gru4rec_fallback_{flat}"]
        want = r[f"gru4rec_broadcast_il_{flat}"]
        assert got["overflow"][0] > 0
        assert got["overflow"][1] > got["overflow"][0]
        assert got["parts"] == want["parts"]
        for part in ("state_dict", "moments"):
            assert got[part].keys() == want[part].keys()
            for k in want[part]:
                np.testing.assert_array_equal(got[part][k], want[part][k],
                                              err_msg=k)


@pytest.mark.parametrize("flat", ["_flat", ""])
def test_owner_merge_matches_broadcast_merge(world, flat):
    for r in world["ranks"]:
        got, want = r[f"clsr_owner{flat}"], r[f"clsr_broadcast{flat}"]
        for field, value in got["parts"][0].items():
            np.testing.assert_allclose(value, want["parts"][0][field],
                                       **TOL, err_msg=field)
        for part in ("state_dict", "moments"):
            for k, v in want[part].items():
                np.testing.assert_allclose(got[part][k], v, **TOL,
                                           err_msg=k)


def _stream_calls(calls, n_floats):
    """The float all_gathers and all_to_alls carrying >= n_floats."""
    return [c for c in calls if c[0] in ("all_gather", "all_to_all")
            and c[3] == "torch.float32"
            and int(np.prod(c[2])) >= n_floats]


def test_drop_moves_no_full_gradient_stream(world):
    D = WIDTHS["item_embedding_dim"]
    mi = (B // 4) * (L + G)     # a rank's sorted item ids (flat batch)
    C = -(-int(DROP_CAPACITY * mi) // 2)    # JAX's slots, m = 2
    for r in world["ranks"]:
        bcast = r["gru4rec_broadcast"]["calls"]
        drop = r["gru4rec_drop"]["calls"]
        assert [c for c in bcast if c[0] == "all_gather"
                and c[1] == "world" and c[2] == (mi, D)
                and c[3] == "torch.float32"]
        assert _stream_calls(drop, mi * D) == []
        a2a = [c for c in drop if c[0] == "all_to_all"]
        assert (2, C, D + 1) in {c[2] for c in a2a}
        assert all(c[1] == "model" for c in a2a)
        # the merges' bytes: the broadcast's gathers of the (id, gradient)
        # streams against the owner's all_to_alls and bucket gathers
        # (two steps under drop, one under broadcast)
        merge_b = sum(c[5] for c in bcast if c[0] == "all_gather"
                      and c[1] == "world" and c[3] == "torch.float32")
        merge_o = sum(c[5] for c in drop if c[0] == "all_to_all"
                      or (c[0] == "all_gather" and c[1] == "data"))
        assert merge_o / 2 < merge_b


# ------------------------------------------ the owner merge's branches


@pytest.mark.parametrize("name", ["gru4rec_fallback_flat",
                                  "clsr_mixed_flat"])
def test_fallback_branches_match_jax_mesh(world, name):
    """Counts first, one read a step, then each table's branch: JAX's
    lax.cond mesh step where every step overflows and where one table
    overflows and another does not."""
    mixed = name == "clsr_mixed_flat"
    for r in world["ranks"]:
        got = r[name]
        assert len(got["patterns"]) == 2            # one read a step
        for pattern in got["patterns"]:
            assert (set(pattern) == {False, True} if mixed
                    else all(pattern)), pattern
        assert got["overflow"][0] > 0
        _assert_matches_jax(name, got, world["refs"][name])


def _same(got, want, keys=None):
    for part in ("state_dict", "moments"):
        for k in want[part]:
            if keys is None or keys(k):
                np.testing.assert_array_equal(got[part][k], want[part][k],
                                              err_msg=k)


@pytest.mark.parametrize("setting", ["none", "mixed"])
def test_owner_merge_branches_bit_for_bit(world, setting):
    """The restructured merge against the merges it composes, one step:
    with no overflow the read picks the owner merge everywhere, as drop's
    step without a read; with CLSR's user tables overflowing and its
    item table not, the users' rows are the broadcast merge's and the
    items' the owner merge's (drop's), and the dense tensors, the
    replicated cate table and the loss parts equal both."""
    for r in world["ranks"]:
        got = r[f"branches_{setting}"]
        drop = r[f"branches_{setting}_drop"]
        assert drop["patterns"] == []               # drop reads nothing
        assert got["parts"] == drop["parts"]
        if setting == "none":
            assert got["patterns"] == [(False, False, False)]
            _same(got, drop)
            continue
        assert got["patterns"] == [(False, True, True)]
        bcast = r["branches_mixed_broadcast"]
        assert got["parts"] == bcast["parts"]
        users = lambda k: "user_" in k
        _same(got, bcast, users)
        _same(got, drop, lambda k: not users(k))
        _same(got, bcast, lambda k: not k.endswith("_embedding")
              or k.endswith("cate_embedding"))


# ------------------------------------------------- the scaling model


def _by_group(world, key):
    """The bytes received a step, by group: the largest over the ranks."""
    totals = []
    for r in world["ranks"]:
        t = {}
        for c in r[("scaling", key)]:
            t[c[1]] = t.get(c[1], 0) + c[5]
        totals.append(t)
    return {g: max(t.get(g, 0) for t in totals)
            for g in set().union(*totals)}


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_scaling_group_labels(world, topology):
    """The byte count's labels name the mesh's groups, data-major: a data
    column holds the ranks of one model index, a model row the ranks of
    one data index (JAX's test_classify_axis)."""
    d, m = topology
    for rank, r in enumerate(world["ranks"]):
        got = r[("groups", topology)]
        i, j = divmod(rank, m)
        assert got["data"] == ("data", [k * m + j for k in range(d)])
        assert got["model"] == ("model", [i * m + k for k in range(m)])
        assert got["world"] == ("world", list(range(4)))


def test_scaling_merge_all_gather_matches_closed_form(world):
    """The broadcast merge's all_gather of the item table's w-space
    gradient, f32 [Mi, D] a rank over the world (flat batch): each rank
    receives (n - 1) x its payload, the port's all_gather, where JAX's
    ring all_gather receives (n - 1) / n of the gathered [n, Mi, D]."""
    n, b = 4, 4
    mi = b * (L + G)                # a rank's history and candidate ids
    D = WIDTHS["item_embedding_dim"]
    for r in world["ranks"]:
        calls = r[("scaling", ("broadcast", 2, 2, b))]
        stream = [c for c in calls if c[:4] == (
            "all_gather", "world", (mi, D), "torch.float32")]
        assert stream, calls
        assert stream[0][4] == mi * D * 4
        assert stream[0][5] == (n - 1) * mi * D * 4


def test_scaling_bytes_affine_in_batch(world):
    """The bytes grow by the same amount for each row a rank adds (the
    model reads the line through two counted batches): the increments
    from b = 2 to 4 and 4 to 8 in the ratio 2 (1.8-2.2, JAX's test's
    range), above a fixed part (the dense gradients, the loss parts)."""
    tot = {b: sum(_by_group(world, ("broadcast", 2, 2, b)).values())
           for b in (2, 4, 8)}
    ratio = (tot[8] - tot[4]) / (tot[4] - tot[2])
    assert 1.8 <= ratio <= 2.2, tot
    assert 2 * tot[2] - tot[4] > 0, tot         # the fixed part
    line = scaling_model.bytes_at(
        {b: _by_group(world, ("broadcast", 2, 2, b)) for b in (2, 8)}, 4)
    assert sum(line.values()) == pytest.approx(tot[4], rel=0.05)


def test_scaling_owner_routing_moves_fewer_bytes_and_onto_model(world):
    """Owner routing at capacity 1 under drop receives fewer bytes than the
    broadcast merge at (1, 4); and at (1, 4) against (4, 1) it moves
    bytes off the cross-host groups ('data', 'world') onto 'model' (JAX's
    test_owner_routing_moves_fewer_bytes and
    test_model_within_host_moves_bytes_onto_ici)."""
    owner = _by_group(world, ("owner", 1, 4, 4))
    bcast = _by_group(world, ("broadcast", 1, 4, 4))
    assert sum(owner.values()) < sum(bcast.values()), (owner, bcast)
    turned = _by_group(world, ("owner", 4, 1, 4))
    cross = lambda x: x.get("data", 0) + x.get("world", 0)
    assert cross(owner) < cross(turned), (owner, turned)
    assert owner.get("model", 0) > turned.get("model", 0), (owner, turned)


def test_scaling_efficiencies_on_fixed_numbers():
    """JAX's formulas on the port's links: 4.5 MB over 'model' and 5 MB
    over 'data' a step, t1 = 10 ms, 4 ranks; one host puts both on
    NVLink (450 GB/s), two put the data bytes on InfiniBand (50 GB/s)."""
    at_b = {"model": 4.5e6, "data": 5e6, "world": 0.0}
    at_shard = {"model": 0.9e6, "data": 1e6}
    nv, ib = 450e9, 50e9
    t1, floor = 0.010, 0.0002
    weak, strong, t_coll, weak_ov = scaling_model.efficiencies(
        t1, floor, at_b, at_shard, 4, 1, nv, ib)
    assert t_coll == pytest.approx(9.5e6 / nv)
    assert weak == pytest.approx(t1 / (t1 + 9.5e6 / nv))
    assert strong == pytest.approx(t1 / (4 * (t1 / 4 + 1.9e6 / nv)))
    assert weak_ov == weak
    weak2, strong2, t2, ov2 = scaling_model.efficiencies(
        t1, 0.005, at_b, at_shard, 4, 2, nv, ib)
    assert t2 == pytest.approx(4.5e6 / nv + 5e6 / ib)
    assert weak2 == pytest.approx(t1 / (t1 + t2))
    assert strong2 == pytest.approx(
        t1 / (4 * (0.005 + 0.9e6 / nv + 1e6 / ib)))     # the floor binds
    assert ov2 == pytest.approx(t1 / (t1 + 4.5e6 / nv))  # 0.1 ms < t1
    assert scaling_model.predict_step_ms(10.0, at_b, 2, nv, ib) == \
        pytest.approx(10.0 + 1e3 * t2)
