"""The port's mesh-resident data, length buckets on a mesh, the
sequence-parallel merge and the zoo on a mesh, against JAX's and the
one-rank port.

One 4-rank gloo world at (2, 2) (tests/torch_mesh_worker.py
`resident_world`) runs while JAX's references and the one-rank port run
here (JAX on 4 of the 8 CPU devices):

  * `gather_batch_mesh` from each rank's block of a 41-row view (padded
    to 44), flat batch and replicated batch, at 16 global rows with
    rows of every shard and an invalid tail: every field equal to
    JAX's `gather_batch_mesh`, bit for bit but the sign of a zero (JAX's
    float psum turns a stored -0.0 into +0.0), and every bit of the
    port's one-device `gather_batch` of the same rows;
  * the sequence-parallel merge (ops/long_context.py): JAX's
    `test_sequence_sharded_attention` case (B = 4, L = 96, block 16, the
    keys over the 4 ranks), the output against JAX's sharded result to
    rtol 1e-4 / atol 1e-5, and the output and the gradients of the keys
    and parameters against the one-rank blocked attention (1e-5, 1e-4);
  * A2SVD, DIN, DIEN, SLI-Rec, Caser, NCF and NextItNet (per position),
    one lazyadam step each at (2, 2) against the one-rank port from one
    state (loss parts and every parameter to 1e-5; the elements whose
    gradient on the one-rank run was under 1e-5 at a step, zero by
    construction or nearly, as a bias feeding a normalization, and the
    BN means they shift, within Adam's sign-flip bound, 2.1 lr a step);
    GRU4Rec is
    held to JAX's mesh in tests/test_torch_owner_routing.py;
  * on the 50-user synthetic set, negatives injected: a CLSR epoch of
    lazyadam under the owner-routed merge (capacity 0.3, fallback),
    three steps a call, streamed and resident (`resident_data: auto`,
    which goes resident on the mesh, as JAX's
    `test_mesh_resident_default_on`; with resident_max_bytes 100 it
    streams): the eval history and every state tensor bit for bit, and
    rank 0 logs the fallback NOTE; under `drop` it logs the WARNING;
    without a seed the ranks share rank 0's, so the resident fit runs
    and every rank ends with the same state;
  * a two-epoch bucketed fit on the mesh (`length_buckets: "6"`, the BN
    refresh, flat batch, owner merge) against JAX's mesh `Trainer.fit`
    from the same perturbed state: per show_step the loss and data loss
    to 1e-4 relative, each valid metric within 2e-4;
  * kill and resume on the mesh (tests/test_torch_resume.py's
    counterpart): the streamed and the resident epoch above again with
    an autosave after every call, killed after call 4 and 2, and a fresh
    mesh Trainer resumed on its model_dir: its eval history and every
    state tensor equal the uninterrupted fit's bit for bit; the
    autosave (rank 0's logical state and run state) loads into a
    one-rank Trainer as the killed state, bit for bit; a run-state field
    that differs by rank is refused before rank 0 writes;
  * histograms on the mesh: the streamed and resident epochs write them
    (rank 0, at every show_step); their records carry JAX's tags
    (`alpha`, `item_embedding_output`, tests/test_summaries.py
    `test_fit_writes_histograms_on_mesh`) and match the one-rank port's
    fit from the same state and negatives: each record's count, lo and
    hi to 1e-4 relative (the two fits' states differ by rounding), and
    each count vector within 1% of its values of the one-rank vector (a
    value near a bucket's edge may change bucket).
"""

import concurrent.futures
import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxDeviceMesh
from jax.sharding import PartitionSpec as P

import clsr_tpu.parallel.mesh as jax_mesh
import clsr_tpu.training.steps as jax_steps
import clsr_tpu.training.trainer as jax_trainer_module
from clsr_tpu.data.loader import SequenceLoader as JaxLoader
from clsr_tpu.data.parser import parse_file as jax_parse_file
from clsr_tpu.data.resident import build_resident_mesh as jax_build_mesh
from clsr_tpu.data.resident import gather_batch_mesh as jax_gather_mesh
from clsr_tpu.data.vocab import load_vocab as jax_load_vocab
from clsr_tpu.models.registry import get_model_class as jax_model_class
from clsr_tpu.ops.attention import TargetAttention as JaxTargetAttention
from clsr_tpu.ops.long_context import LongTargetAttention as JaxLong
from clsr_tpu.training.lazy_adam import make_lazy_optimizer
from clsr_tpu.training.state import TrainState as JaxTrainState
from clsr_tpu.training.trainer import Trainer as JaxTrainer
from clsr_tpu_torch import weights
from clsr_tpu_torch.config import load_config
from clsr_tpu_torch.data.resident import build_resident, gather_batch
from clsr_tpu_torch.data.synthetic import write_synthetic_dataset
from clsr_tpu_torch.data.vocab import load_vocab
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.ops.initializers import get_initializer
from clsr_tpu_torch.ops.long_context import LongTargetAttention
import clsr_tpu_torch.training.steps as port_steps
from clsr_tpu_torch.parallel.distributed import run_local_world
from clsr_tpu_torch.training import checkpoint
from clsr_tpu_torch.training.lazy_adam import LazyAdamState
from clsr_tpu_torch.training.state import create_train_state
from clsr_tpu_torch.training.steps import make_train_step
from clsr_tpu_torch.training.trainer import Trainer

import torch_mesh_worker
from test_torch_common import (jax_batch, numpy_batch, padded_view,
                               perturb, port_cfg, small_jax_cfg)

L, TEST_NGS = 10, 9
MESH = dict(data_parallel=2, model_parallel=2)
FIT = dict(max_seq_length=L, batch_size=64, epochs=1, show_step=2,
           train_steps_per_call=3, valid_num_ngs=4, test_num_ngs=TEST_NGS,
           save_model=False, early_stop=10, contrastive_length_threshold=2,
           embed_l2=1e-4, layer_l2=1e-4, optimizer="lazyadam",
           mesh_update_routing="owner")
FITS = {"streamed": dict(resident_data="off", mesh_owner_capacity=0.3,
                         write_histograms=True),
        "resident": dict(resident_data="auto", mesh_owner_capacity=0.3,
                         write_histograms=True),
        "drop": dict(resident_data="auto", mesh_owner_capacity=0.3,
                     mesh_owner_overflow="drop"),
        "no_seed": dict(resident_data="auto", mesh_owner_capacity=0.3,
                        seed=None),
        "buckets": dict(resident_data="on", length_buckets="6",
                        bn_refresh_batches=8, epochs=2,
                        train_steps_per_call=1)}
RESUME = {"streamed": 4, "resident": 2}     # killed after this call
# the zoo: users, items (row-sharded), cates (replicated), one step
ZOO = ("a2svd", "din", "dien", "sli_rec", "caser", "ncf", "nextitnet")
ZOO_SIZES, ZOO_L, ZOO_STEPS = (8, 24, 5), 7, 1
ZOO_CFG = dict(user_vocab="u", item_vocab="i", cate_vocab="c",
               max_seq_length=ZOO_L, hidden_size=12, item_embedding_dim=8,
               cate_embedding_dim=4, user_embedding_dim=12,
               attention_size=12, layer_sizes=(10, 6), activation=("relu",),
               att_fcn_layer_sizes=(8, 4), seed=3, need_sample=False,
               train_num_ngs=3, batch_size=16, optimizer="lazyadam",
               embed_l2=1e-4, layer_l2=1e-4, max_grad_norm=0.5, L=3, n_v=4,
               n_h=3, dilations=(1, 2), kernel_size=3,
               ncf_layer_sizes=(10, 6), n_layers=2)
ZOO_FLIPS = re.compile(r"(w_nn_layer\d+\.bias|w_nn_output\.bias|"
                       r"bn\d+\.mean)$")
# the sequence-parallel case: JAX's test_sequence_sharded_attention
ATT = dict(B=4, G=3, L=96, D=16, layers=(12, 6), block=16)
_JAX_MAKE_MESH = jax_mesh.make_mesh


def jax_mesh_of(d, m):
    return _JAX_MAKE_MESH(d, m, devices=jax.devices()[:d * m])


def _zoo_cfg(name, **kw):
    out = dict(ZOO_CFG, model_type=name, **kw)
    if name == "nextitnet":     # per-position training draws its targets
        out["need_sample"] = True
    if name == "dien":
        out["activation"] = ("dice", "dice")
    return load_config(None, **out)


def _zoo_one_rank(cfg, state_dict, batches):
    """The one-rank port's steps: ([loss parts], state_dict, {parameter:
    mask of its elements whose gradient was under 1e-5 at some step}).
    There Adam's step, lr * m / (sqrt(v) + eps), takes the sign of a
    gradient that is as much rounding noise as signal (zero by
    construction, as a bias feeding a normalization, or nearly so), so
    the mesh and one rank may step it either way."""
    model = get_model_class(cfg.model_type)(cfg, *ZOO_SIZES, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()})
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg)
    parts, grad = [], {}
    for b in batches:
        state, p = step(state, torch_mesh_worker.batch_of(b),
                        torch.Generator().manual_seed(0))
        parts.append(torch_mesh_worker.parts_of(p))
        for k, q in model.named_parameters():
            if q.grad is not None:
                g = q.grad.abs().numpy()
                grad[k] = np.minimum(grad[k], g) if k in grad else g
    return parts, {k: v.numpy().copy()
                   for k, v in model.state_dict().items()}, {
        k: g < 1e-5 for k, g in grad.items()}


def _map_params(nested):
    """TargetAttention's tree -> LongTargetAttention's flat one."""
    flat = {"attention_mat": nested["attention_mat"]}
    fcn = nested["att_fcn"]
    for i in range(len(ATT["layers"])):
        flat[f"w_nn_layer{i}_kernel"] = fcn[f"w_nn_layer{i}"]["kernel"]
        flat[f"w_nn_layer{i}_bias"] = fcn[f"w_nn_layer{i}"]["bias"]
    flat["w_nn_output_kernel"] = fcn["w_nn_output"]["kernel"]
    flat["w_nn_output_bias"] = fcn["w_nn_output"]["bias"]
    return flat


def _attention_spec():
    B, G, Lk, D = ATT["B"], ATT["G"], ATT["L"], ATT["D"]
    rng = np.random.RandomState(0)
    keys = rng.randn(B, Lk, D).astype(np.float32)
    query = rng.randn(B, G, D).astype(np.float32)
    mask = (np.arange(Lk)[None] < rng.randint(1, Lk + 1, B)[:, None]
            ).astype(np.float32)
    ref = JaxTargetAttention(ATT["layers"], ("relu", "relu"),
                             enable_bn=False)
    params = ref.init(jax.random.PRNGKey(1), query, keys, mask)["params"]
    flat = {k: np.asarray(v) for k, v in _map_params(params).items()}
    return dict(keys=keys, query=query, mask=mask, params=flat,
                cot=rng.randn(B, G, D).astype(np.float32), dq=D, dk=D,
                layers=ATT["layers"], block=ATT["block"])


def _jax_sharded_attention(case):
    mod = JaxLong(ATT["layers"], block_size=ATT["block"])
    mesh = JaxDeviceMesh(np.asarray(jax.devices("cpu")[:4]).reshape(1, 4),
                         ("data", "seq"))

    def shard_fn(p, q, k, m):
        return mod.apply({"params": p}, q, k, m, axis_name="seq")

    return np.asarray(jax.jit(jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(None, "seq", None), P(None, "seq")),
        out_specs=P(), check_vma=False))(
        case["params"], case["query"], case["keys"], case["mask"]))


def _attention_one_rank(case):
    mod = LongTargetAttention(case["dq"], case["dk"], case["layers"],
                              get_initializer("tnormal", 0.1),
                              torch.Generator(), torch.device("cpu"),
                              block_size=case["block"])
    mod.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in case["params"].items()})
    keys = torch.from_numpy(case["keys"]).requires_grad_()
    out = mod(torch.from_numpy(case["query"]), keys,
              torch.from_numpy(case["mask"]))
    (out * torch.from_numpy(case["cot"])).sum().backward()
    return {"out": out.detach().numpy(), "d_keys": keys.grad.numpy(),
            "d_params": {k: p.grad.numpy()
                         for k, p in mod.named_parameters()}}


def _gather_one_device(view, idx, valid):
    """The port's one-device gather_batch of the same rows."""
    res = build_resident(view, "cpu")
    got = gather_batch(res, torch.from_numpy(idx).long(),
                       torch.from_numpy(valid))
    return {f.name: getattr(got, f.name).numpy()
            for f in dataclasses.fields(got)}


def _jax_state(model, jcfg, params, stats):
    init_fn, _ = make_lazy_optimizer(jcfg)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), apply_fn=model.apply,
                         params=params, tx=None, opt_state=init_fn(params),
                         batch_stats=stats)


def _scalars(path):
    with open(os.path.join(path, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_resident")
    paths = write_synthetic_dataset(str(tmp / "data"), n_users=51,
                                    n_items=199, n_cates=19,
                                    valid_num_ngs=4, test_num_ngs=TEST_NGS)
    pv = [load_vocab(paths[f"{n}_vocab"]) for n in ("user", "item", "cate")]
    jv = [jax_load_vocab(paths[f"{n}_vocab"])
          for n in ("user", "item", "cate")]
    sizes = tuple(map(len, pv))
    jax_l = {s: JaxLoader(jax_parse_file(paths[s], *jv), L)
             for s in ("train", "valid")}
    # one JAX init, perturbed, for the fits
    jcfg = small_jax_cfg(**FIT, **MESH)
    jmodel = jax_model_class("clsr")(cfg=jcfg, n_users=sizes[0],
                                     n_items=sizes[1], n_cates=sizes[2])
    sample = next(jax_l["train"].train_batches(64, np.random.RandomState(0)))
    variables = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        sample, train=True)
    rng = np.random.RandomState(7)
    params = perturb(variables["params"], rng)
    stats = perturb(variables["batch_stats"], rng)
    one = get_model_class("clsr")(port_cfg(jcfg, data_parallel=1,
                                           model_parallel=1),
                                  *sizes, device="cpu")
    weights.from_flax(one, params, stats)
    state_dict = {k: v.numpy().copy() for k, v in one.state_dict().items()}
    # gather_batch_mesh's inputs
    view = padded_view(11, n=41, L=9)
    grng = np.random.RandomState(3)
    idx = grng.randint(0, 41, 16).astype(np.int32)
    valid = np.ones(16, bool)
    valid[-3:] = False
    # the zoo's states and batches
    zoo, zoo_refs = {}, {}
    zrng = np.random.RandomState(40)
    zoo_batches = []
    for _ in range(ZOO_STEPS):
        b = numpy_batch(zrng, 16, 4, ZOO_L, n_users=ZOO_SIZES[0],
                        n_items=ZOO_SIZES[1], n_cates=ZOO_SIZES[2])
        b["labels"][:, 0] = 1.0
        zoo_batches.append(b)
    for name in ZOO:
        cfg = _zoo_cfg(name)
        model = get_model_class(name)(cfg, *ZOO_SIZES, device="cpu")
        sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
        zoo[name] = dict(cfg=dataclasses.asdict(_zoo_cfg(name, **MESH)),
                         state_dict=sd, batches=zoo_batches)
        zoo_refs[name] = _zoo_one_rank(cfg, sd, zoo_batches)
    att = _attention_spec()
    spec = dict(
        sizes=sizes, paths=paths, L=L, state_dict=state_dict,
        gather=dict(cfg=dataclasses.asdict(small_jax_cfg(
            max_seq_length=9, batch_size=16, **MESH)), view=view, idx=idx,
            valid=valid),
        attention=att, zoo=zoo, zoo_sizes=ZOO_SIZES,
        fits={name: dataclasses.asdict(small_jax_cfg(
            **dict(FIT, **kw), **MESH, summaries_dir=str(tmp / name)))
            for name, kw in FITS.items()},
        resume={name: dict(cfg=dataclasses.asdict(small_jax_cfg(
            **dict(FIT, **FITS[name]), **MESH, autosave_every_calls=1,
            model_dir=str(tmp / f"resume_{name}"),
            summaries_dir=str(tmp / f"resume_{name}_summaries"))),
            kill=kill, copy=str(tmp / f"autosave_{name}"))
            for name, kill in RESUME.items()})
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_local_world, torch_mesh_worker.resident_world, 4,
                      "gloo", "cpu", (spec,), 300.0)
    try:
        refs = {"zoo": zoo_refs, "attention": _attention_one_rank(att),
                "gather_one": _gather_one_device(view, idx, valid),
                "attention_jax": _jax_sharded_attention(att)}
        mesh = jax_mesh_of(2, 2)
        for flat in (True, False):
            res = jax_build_mesh(view, mesh, flat)
            refs[("gather", flat)] = jax.device_get(jax.jit(
                lambda r, i, v: jax_gather_mesh(mesh, flat, r, i, v))(
                res, jnp.asarray(idx), jnp.asarray(valid)))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_mesh, "make_mesh",
                       lambda d, m, devices=None: jax_mesh_of(d, m))
            mp.setattr(jax_trainer_module, "create_train_state",
                       lambda model, cfg, sample, rng=None: _jax_state(
                           model, cfg, params, stats))
            mp.setattr(jax_steps, "expand_with_negatives",
                       torch_jax_negatives)
            # the bucketed config's model: its scorers' masked BN
            bcfg = small_jax_cfg(**dict(FIT, **FITS["buckets"]), **MESH,
                                 summaries_dir=str(tmp / "jax_buckets"))
            jt = JaxTrainer(jax_model_class("clsr")(
                cfg=bcfg, n_users=sizes[0], n_items=sizes[1],
                n_cates=sizes[2]), bcfg, sample, log=lambda *a: None)
            jt.fit(jax_l["train"], jax_l["valid"])
        refs["jax_buckets"] = (jt.eval_history, jt._buckets is not None)
        # the one-rank port's streamed fit, histograms on
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(port_steps, "expand_with_negatives",
                       torch_mesh_worker.deterministic_negatives)
            ocfg = port_cfg(small_jax_cfg(**dict(FIT, **FITS["streamed"]),
                                          summaries_dir=str(tmp / "one")))
            omodel = get_model_class("clsr")(ocfg, *sizes, device="cpu")
            omodel.load_state_dict(one.state_dict())
            loaders = torch_mesh_worker.loaders_of(spec)
            Trainer(omodel, ocfg, log=lambda *a: None).fit(
                loaders["train"], loaders["valid"])
        ranks = fut.result()
    finally:
        pool.shutdown(wait=True)
    return dict(tmp=tmp, ranks=ranks, refs=refs, sizes=sizes)


def torch_jax_negatives(rng, batch, num_ngs):
    """tests/test_torch_mesh_train.py's injected negatives, JAX side."""
    B = batch.items.shape[0]
    n_valid = jnp.maximum(batch.valid.sum().astype(jnp.int32), 1)
    idx = jnp.mod(jnp.arange(B)[:, None] + jnp.arange(1, num_ngs + 1)[None],
                  n_valid)
    pi, pc = batch.items[:, 0], batch.cates[:, 0]
    items = jnp.concatenate([pi[:, None], pi[idx]], axis=1)
    cates = jnp.concatenate([pc[:, None], pc[idx]], axis=1)
    labels = jnp.zeros(items.shape, jnp.float32).at[:, 0].set(1.0)
    return batch.replace(items=items, cates=cates, labels=labels)


@pytest.mark.parametrize("flat", [True, False])
def test_gather_batch_mesh_equals_jax(world, flat):
    want = world["refs"][("gather", flat)]
    one = world["refs"]["gather_one"]
    for r in world["ranks"]:
        got = r[("gather", flat)]
        for field in got:
            g, w = got[field], np.asarray(getattr(want, field))
            assert g.dtype == w.dtype and g.shape == w.shape, field
            np.testing.assert_array_equal(g, w, err_msg=field)
            # bit for bit but the sign of a zero: JAX's float psum makes
            # a stored -0.0 +0.0, the port's integer sum keeps the bits
            nz = w != 0
            np.testing.assert_array_equal(g[nz].view(np.uint8),
                                          w[nz].view(np.uint8),
                                          err_msg=field)
            # and every bit of the one-device gather_batch's rows
            np.testing.assert_array_equal(g.view(np.uint8),
                                          one[field].view(np.uint8),
                                          err_msg=field)


def test_sequence_parallel_merge_matches_jax_and_one_rank(world):
    want, jax_out = world["refs"]["attention"], world["refs"][
        "attention_jax"]
    for r in world["ranks"]:
        got = r["attention"]
        assert np.isfinite(got["out"]).all()
        np.testing.assert_allclose(got["out"], jax_out, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got["out"], want["out"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(
            got["d_keys"].transpose(1, 0, 2, 3).reshape(want["d_keys"].shape)
            if got["d_keys"].ndim == 4 else got["d_keys"], want["d_keys"],
            rtol=1e-4, atol=1e-5)
        for k, v in want["d_params"].items():
            np.testing.assert_allclose(got["d_params"][k], v, rtol=1e-4,
                                       atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ZOO)
def test_zoo_trains_on_the_mesh_as_on_one_rank(world, name):
    want_parts, want, noise = world["refs"]["zoo"][name]
    lr = _zoo_cfg(name).learning_rate
    for r in world["ranks"]:
        got = r[("zoo", name)]
        assert got["flat"]
        for g, w in zip(got["parts"], want_parts):
            for field, value in w.items():
                np.testing.assert_allclose(g[field], value, rtol=1e-5,
                                           atol=1e-6, err_msg=field)
        assert got["state_dict"].keys() == want.keys()
        for k, v in want.items():
            g = got["state_dict"][k]
            flips = (np.ones(v.shape, bool) if ZOO_FLIPS.search(k)
                     else noise.get(k, np.zeros(v.shape, bool)))
            assert np.abs(g - v)[flips].max(initial=0.0) <= (
                2.1 * ZOO_STEPS * lr), k
            np.testing.assert_allclose(g[~flips], v[~flips], rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_resident_mesh_fit_equals_streamed_bit_for_bit(world):
    for rank, r in enumerate(world["ranks"]):
        streamed, resident = r[("fit", "streamed")], r[("fit", "resident")]
        assert not streamed["resident"] and resident["resident"]
        # 'auto' streams when the upload does not fit
        assert not resident["uses_resident_small"]
        assert streamed["history"] == resident["history"]
        assert streamed["steps"] == resident["steps"] == [11]
        assert streamed["overflow"] == resident["overflow"] > 0
        for a, b in zip(streamed["state"], resident["state"]):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        if rank == 0:
            for fit in (streamed, resident):
                assert any(line.startswith("NOTE: owner-routed update "
                                           "merge fell back")
                           for line in fit["logs"])
            assert any(line.startswith("WARNING: owner-routed update merge "
                                       "dropped")
                       for line in r[("fit", "drop")]["logs"])
    tmp = world["tmp"]
    assert _scalars(tmp / "streamed") != [] and [
        {k: v for k, v in s.items() if k != "time"}
        for s in _scalars(tmp / "streamed")] == [
        {k: v for k, v in s.items() if k != "time"}
        for s in _scalars(tmp / "resident")]


def test_mesh_fit_without_a_seed_draws_one_batch(world):
    """Without cfg.seed the ranks take rank 0's clock seed (Trainer
    `_shared_seed`): one epoch permutation and one set of negatives, so
    the resident gathers assemble and every rank ends with one state."""
    fits = [r[("fit", "no_seed")] for r in world["ranks"]]
    assert all(f["resident"] and f["steps"] == [11] for f in fits)
    for f in fits[1:]:
        assert f["history"] == fits[0]["history"]
        for a, b in zip(f["state"], fits[0]["state"]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_bucketed_mesh_fit_matches_jax(world):
    history, jax_bucketed = world["refs"]["jax_buckets"]
    assert jax_bucketed
    tmp = world["tmp"]
    got, want = _scalars(tmp / "buckets"), _scalars(tmp / "jax_buckets")
    assert [s["step"] for s in got] == [s["step"] for s in want]
    n_logged = 0
    for g, w in zip(got, want):
        for key in set(w) - {"step", "time"}:
            if key.startswith("valid/"):
                assert abs(g[key] - w[key]) <= 2e-4 + 1e-9, (g, w)
            else:
                n_logged += 1
                np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                           err_msg=f"{key} at {g['step']}")
    assert n_logged >= 2 * 2 * 4
    for r in world["ranks"]:
        fit = r[("fit", "buckets")]
        assert fit["resident"] and fit["bucketed"]
        assert len(fit["history"]) == len(history) == 2
        for (ep, g), (jep, w) in zip(fit["history"], history):
            assert ep == jep and g.keys() == w.keys()
            for k in g:
                assert abs(g[k] - w[k]) <= 2e-4 + 1e-9, (ep, k, g[k], w[k])


# ------------------------------------------------------- kill and resume


@pytest.mark.parametrize("name", sorted(RESUME))
def test_killed_mesh_fit_resumes_bit_for_bit(world, name):
    for rank, r in enumerate(world["ranks"]):
        a, c = r[("fit", name)], r[("resume", name)]
        assert c["killed_at"] == RESUME[name]
        assert c["resident"] == a["resident"] == (name == "resident")
        assert c["history"] == a["history"]
        # 11 steps: three calls of K = 3, then two single tail steps; the
        # resumed epoch counts the steps run after the resume
        done = 3 * min(RESUME[name], 3) + max(RESUME[name] - 3, 0)
        assert a["steps"] == [11] and c["steps"] == [11 - done]
        for x, y in zip(c["state"], a["state"]):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        assert not c["autosave_left"]
        assert "run states differ in ['total']" in c["lockstep"]
        if rank == 0:
            assert any(f"resuming at epoch 1, call {RESUME[name]}" in line
                       for line in c["logs"])


@pytest.mark.parametrize("name", sorted(RESUME))
def test_mesh_autosave_loads_on_one_rank(world, name):
    """The killed mesh fit's autosave, written by rank 0 in the logical
    layout, loads into a one-rank Trainer as the killed state."""
    killed, kmoments, _ = world["ranks"][0][("resume", name)][
        "killed_state"]
    path = world["tmp"] / f"autosave_{name}"
    cfg = port_cfg(small_jax_cfg(**dict(FIT, **FITS[name])))
    t = Trainer(get_model_class("clsr")(cfg, *world["sizes"],
                                        device="cpu"), cfg,
                log=lambda *a: None)
    t.load(str(path / "state"))
    sd = t.state.model.state_dict()
    assert sd.keys() == killed.keys()
    for k, v in killed.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert isinstance(t.state.optimizer, LazyAdamState)
    for k, v in kmoments.items():
        np.testing.assert_array_equal(t.state.optimizer.moments[k].numpy(),
                                      v, err_msg=k)
    run = checkpoint.load_run_state(str(path))
    assert (run["calls_done"], run["mode"]) == (
        RESUME[name], "resident" if name == "resident" else "stream")


# ------------------------------------------------------------ histograms


def _hists(path):
    return {(r["step"], r["hist"]): r for r in _scalars(path)
            if "hist" in r}


def test_mesh_histogram_records_match_one_rank(world):
    tmp = world["tmp"]
    want = _hists(tmp / "one")
    assert {"alpha", "item_embedding_output"} <= {t for _, t in want}
    for name in ("streamed", "resident"):
        got = _hists(tmp / name)
        assert got.keys() == want.keys()
        for key, w in want.items():
            g = got[key]
            np.testing.assert_allclose([g["lo"], g["hi"]],
                                       [w["lo"], w["hi"]], rtol=1e-4,
                                       atol=1e-6, err_msg=str(key))
            gc, wc = np.asarray(g["counts"]), np.asarray(w["counts"])
            assert gc.sum() == wc.sum(), key
            assert np.abs(gc - wc).sum() <= 0.01 * wc.sum(), key
