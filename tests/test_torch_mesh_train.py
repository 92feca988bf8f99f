"""The port's mesh training against JAX's mesh and its own one-rank run.

One 4-rank gloo world at (2, 2) (tests/torch_mesh_worker.py
`train_world`) runs, while JAX's references and the one-rank port run
here on the 50-user synthetic set (vocabs of 52 users, 200 items, 20
cates, every table row-sharded), L = 10, JAX on 4 of the 8 CPU devices:

  * one compact-lazyadam (pmn) step, flat batch with interleaved rows
    and replicated batch with contiguous rows, against JAX's
    `make_sharded_train_step` from one perturbed state, negatives
    injected: loss parts, parameters and pmn rows to 1e-5 (JAX's
    physical rows de-interleaved), the zero-gradient biases to Adam's
    sign-flip bound as in tests/test_torch_parallel.py;
  * two epochs of `Trainer.fit` with dense Adam (flat batch) against
    JAX's mesh `Trainer.fit` from the same perturbed weights, both with
    the deterministic negatives of tests/test_torch_trainer.py: per
    show_step the loss and data loss to 1e-4 relative (rank 0's
    scalars.jsonl), each valid metric within 2e-4, the same best epoch;
  * an epoch with the port's own in-batch sampling (drawn on the
    global batch), four steps a call, against the one-rank port from
    the same seed and weights, to the same tolerances; and a second
    mesh run bit for bit equal to the first (state, metrics);
  * checkpoints move both ways: a one-device checkpoint loads on the
    mesh, and the mesh's (rank 0 writes the logical layout) loads on one
    device, each eval equal to 1e-5.
"""

import concurrent.futures
import dataclasses
import json
import os
import re

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clsr_tpu.parallel.mesh as jax_mesh
import clsr_tpu.training.steps as jax_steps
import clsr_tpu.training.trainer as jax_trainer_module
from clsr_tpu.data.loader import SequenceLoader as JaxLoader
from clsr_tpu.data.parser import parse_file as jax_parse_file
from clsr_tpu.data.vocab import load_vocab as jax_load_vocab
from clsr_tpu.models.registry import get_model_class as jax_model_class
from clsr_tpu.parallel import rowmap as jrowmap
from clsr_tpu.training.lazy_adam import make_lazy_optimizer
from clsr_tpu.training.optimizer import build_optimizer
from clsr_tpu.training.state import TrainState as JaxTrainState
from clsr_tpu.training.trainer import Trainer as JaxTrainer
from clsr_tpu_torch import weights
from clsr_tpu_torch.data.loader import SequenceLoader
from clsr_tpu_torch.data.parser import parse_file
from clsr_tpu_torch.data.synthetic import write_synthetic_dataset
from clsr_tpu_torch.data.vocab import load_vocab
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.parallel.distributed import run_local_world
from clsr_tpu_torch.training.evaluator import run_weighted_eval
from clsr_tpu_torch.training.trainer import Trainer

import torch_mesh_worker
from test_torch_common import (TOL, jax_batch, numpy_batch, perturb,
                               port_cfg, small_jax_cfg)

L, TEST_NGS, SPLITS = 10, 9, ("train", "valid", "test")
FIT = dict(max_seq_length=L, batch_size=64, epochs=2, show_step=2,
           train_steps_per_call=1, resident_data="off", valid_num_ngs=4,
           test_num_ngs=TEST_NGS, save_model=False, early_stop=10,
           contrastive_length_threshold=2, embed_l2=1e-4, layer_l2=1e-4)
STEP_CFG = dict(FIT, need_sample=False, train_num_ngs=3, batch_size=16,
                max_grad_norm=0.5, optimizer="lazyadam")
STEPS = {"compact_flat": dict(mesh_flat_batch="on",
                              mesh_row_layout="interleaved"),
         "compact": dict(mesh_flat_batch="off")}
MESH = dict(data_parallel=2, model_parallel=2)
FLIPS = re.compile(r"(w_nn_layer\d+/bias|logit_fcn/w_nn_output/bias|"
                   r"att_fcn/w_nn_output/bias|bn\d+/mean)$")
_JAX_MAKE_MESH = jax_mesh.make_mesh


def jax_mesh_of(d, m):
    return _JAX_MAKE_MESH(d, m, devices=jax.devices()[:d * m])


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in
            tu.flatten_dict(tree).items()}


def _scalars(path):
    with open(os.path.join(path, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def _jax_state(model, jcfg, params, stats):
    if jcfg.optimizer == "lazyadam":
        init_fn, _ = make_lazy_optimizer(jcfg)
        return JaxTrainState(step=jnp.zeros((), jnp.int32),
                             apply_fn=model.apply, params=params, tx=None,
                             opt_state=init_fn(params), batch_stats=stats)
    return JaxTrainState.create(apply_fn=model.apply, params=params,
                                batch_stats=stats, tx=build_optimizer(jcfg))


def _jax_negatives(rng, batch, num_ngs):
    B = batch.items.shape[0]
    n_valid = jnp.maximum(batch.valid.sum().astype(jnp.int32), 1)
    idx = jnp.mod(jnp.arange(B)[:, None] + jnp.arange(1, num_ngs + 1)[None],
                  n_valid)
    pi, pc = batch.items[:, 0], batch.cates[:, 0]
    items = jnp.concatenate([pi[:, None], pi[idx]], axis=1)
    cates = jnp.concatenate([pc[:, None], pc[idx]], axis=1)
    labels = jnp.zeros(items.shape, jnp.float32).at[:, 0].set(1.0)
    return batch.replace(items=items, cates=cates, labels=labels)


def _port_dict(jcfg, **kw):
    return dict(dataclasses.asdict(jcfg), **kw)


def _eval(trainer, loader, cfg):
    return run_weighted_eval(trainer.eval_step, trainer.state.model, loader,
                             cfg, TEST_NGS, calc_mean_alpha=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    paths = write_synthetic_dataset(str(tmp / "data"), n_users=51,
                                    n_items=199, n_cates=19,
                                    valid_num_ngs=4, test_num_ngs=TEST_NGS)
    pv = [load_vocab(paths[f"{n}_vocab"]) for n in ("user", "item", "cate")]
    jv = [jax_load_vocab(paths[f"{n}_vocab"])
          for n in ("user", "item", "cate")]
    sizes = tuple(map(len, pv))
    port = {s: SequenceLoader(parse_file(paths[s], *pv), L) for s in SPLITS}
    jax_l = {s: JaxLoader(jax_parse_file(paths[s], *jv), L) for s in SPLITS}

    # one JAX init (jitted) and its perturbation serve every case
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
    one = get_model_class("clsr")(port_cfg(jcfg, **{k: 1 for k in MESH}),
                                  *sizes, device="cpu")
    weights.from_flax(one, params, stats)
    state_dict = {k: v.numpy().copy() for k, v in one.state_dict().items()}

    steps, step_batches = {}, {}
    for i, (name, kw) in enumerate(STEPS.items()):
        b = numpy_batch(np.random.RandomState(20 + i), 16, 4, L,
                        n_users=sizes[0], n_items=sizes[1],
                        n_cates=sizes[2])
        b["labels"][:, 0] = 1.0
        scfg = small_jax_cfg(**STEP_CFG, **kw, **MESH)
        steps[name] = dict(cfg=_port_dict(scfg), batch=b,
                           state_dict=state_dict)
        step_batches[name] = (scfg, b)

    # a one-device checkpoint for the mesh to load
    loaded_dir = str(tmp / "one_device_model")
    one_cfg = port_cfg(small_jax_cfg(**FIT, seed=11, model_dir=loaded_dir))
    t = Trainer(get_model_class("clsr")(one_cfg, *sizes, device="cpu"),
                one_cfg, log=lambda *a: None)
    t.save(os.path.join(loaded_dir, "epoch_1"))
    want_loaded = _eval(t, port["test"], one_cfg)

    own = small_jax_cfg(**dict(FIT, train_steps_per_call=4, epochs=1),
                        seed=3)
    spec = dict(
        sizes=sizes, paths=paths, L=L, steps=steps,
        loaded=dict(cfg=_port_dict(small_jax_cfg(**FIT, **MESH, seed=11)),
                    model_dir=loaded_dir),
        fit=dict(cfg=_port_dict(jcfg, summaries_dir=str(tmp / "port_fit")),
                 state_dict=state_dict),
        own=dict(cfgs=[_port_dict(own, **MESH,
                                  summaries_dir=str(tmp / "own"),
                                  model_dir=str(tmp / "own_model"),
                                  save_model=True),
                       _port_dict(own, **MESH,
                                  summaries_dir=str(tmp / "own_again"))]))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(run_local_world, torch_mesh_worker.train_world, 4,
                      "gloo", "cpu", (spec,), 300.0)
    try:
        refs = {}
        mesh = jax_mesh_of(2, 2)
        for name, (scfg, b) in step_batches.items():
            state = _jax_state(jmodel, scfg, params, stats)
            flat = jax_mesh.resolve_flat_batch(scfg)
            step = jax_mesh.make_sharded_train_step(jmodel, scfg, mesh,
                                                    state, True, flat)
            new, parts = step(jax_mesh.place_state(state, mesh, True, scfg),
                              jax_mesh.shard_batch(jax_batch(b), mesh, flat),
                              jax.random.PRNGKey(0))
            refs[("step", name)] = jax.device_get((new, parts))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_mesh, "make_mesh",
                       lambda d, m, devices=None: jax_mesh_of(d, m))
            mp.setattr(jax_trainer_module, "create_train_state",
                       lambda model, cfg, sample, rng=None: _jax_state(
                           model, cfg, params, stats))
            mp.setattr(jax_steps, "expand_with_negatives", _jax_negatives)
            jt = JaxTrainer(jmodel, small_jax_cfg(
                **FIT, **MESH, summaries_dir=str(tmp / "jax_fit")), sample,
                log=lambda *a: None)
            jt.fit(jax_l["train"], jax_l["valid"])
        refs["jax_fit"] = (jt.eval_history, jt.best_epoch)
        # the one-rank port with its own sampling, from the same seed
        ocfg = port_cfg(own, summaries_dir=str(tmp / "one_own"))
        omodel = get_model_class("clsr")(ocfg, *sizes, device="cpu")
        omodel.load_state_dict(one.state_dict())
        ot = Trainer(omodel, ocfg, log=lambda *a: None)
        ot.fit(port["train"], port["valid"])
        refs["one_own"] = (ot.eval_history, ot.best_epoch)
        ranks = fut.result()
    finally:
        pool.shutdown(wait=True)
    # the mesh's checkpoint, loaded on one device
    mcfg = port_cfg(own, model_dir=str(tmp / "own_model"))
    back = Trainer(get_model_class("clsr")(mcfg, *sizes, device="cpu"), mcfg,
                   log=lambda *a: None)
    back.load_latest(mcfg.model_dir)
    refs["mesh_ckpt_test"] = _eval(back, port["test"], mcfg)
    refs["loaded_want"] = want_loaded
    return dict(tmp=tmp, sizes=sizes, ranks=ranks, refs=refs)


def _assert_metrics_close(got, want, tol):
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= tol + 1e-9, (k, got[k], want[k])


@pytest.mark.parametrize("name", sorted(STEPS))
def test_compact_step_matches_jax_mesh(world, name):
    new, parts = world["refs"][("step", name)]
    scfg = small_jax_cfg(**STEP_CFG, **STEPS[name])
    il = STEPS[name].get("mesh_row_layout") == "interleaved"
    logical = ((lambda k, v: jrowmap.deinterleave_rows(v, 2)
                if k.endswith("_embedding") else v) if il
               else (lambda k, v: v))
    want = {k: logical(k, v) for k, v in _flat(new.params).items()}
    want.update({f"stats/{k}": v for k, v in
                 _flat(new.batch_stats).items()})
    want_m = {"/".join(k): logical("_embedding", np.asarray(v))
              for k, v in new.opt_state.moments.items()}
    for r in world["ranks"]:
        got = r[("step", name)]
        for field, value in got["parts"].items():
            np.testing.assert_allclose(value, float(getattr(parts, field)),
                                       **TOL, err_msg=field)
        model = get_model_class("clsr")(port_cfg(scfg), *world["sizes"],
                                        device="cpu")
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in got["state_dict"].items()})
        gp, gs = map(_flat, weights.to_flax(model))
        got_all = dict(gp, **{f"stats/{k}": v for k, v in gs.items()})
        assert got_all.keys() == want.keys()
        for k, v in got_all.items():
            if FLIPS.search(k):
                assert np.abs(v - want[k]).max() <= 2.1 * scfg.learning_rate
            else:
                np.testing.assert_allclose(v, want[k], **TOL, err_msg=k)
        assert got["moments"].keys() == want_m.keys()
        for k, v in got["moments"].items():
            assert v.shape[1] == 3 * dict(model.named_parameters())[
                k].shape[1]                          # the pmn layout
            np.testing.assert_allclose(v, want_m[k], **TOL, err_msg=k)
        assert got["count"] == int(new.opt_state.count) == 1


def test_fit_matches_jax_mesh_fit(world):
    tmp = world["tmp"]
    got, want = _scalars(tmp / "port_fit"), _scalars(tmp / "jax_fit")
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
    assert n_logged >= 2 * 2 * 4
    history, best = world["refs"]["jax_fit"]
    for r in world["ranks"]:
        fit = r["fit"]
        assert len(fit["history"]) == len(history) == 2
        for (ep, g), (jep, w) in zip(fit["history"], history):
            assert ep == jep
            _assert_metrics_close(g, w, 2e-4)
        assert fit["best_epoch"] == best > 0


def test_mesh_sampling_equals_one_rank_port(world):
    tmp = world["tmp"]
    got, want = _scalars(tmp / "own"), _scalars(tmp / "one_own")
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        for key in set(w) - {"step", "time"}:
            tol = 2e-4 if key.startswith("valid/") else None
            if tol:
                assert abs(g[key] - w[key]) <= tol + 1e-9, (key, g, w)
            else:
                np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                           err_msg=f"{key} at {g['step']}")
    history, best = world["refs"]["one_own"]
    for r in world["ranks"]:
        for (ep, g), (oep, w) in zip(r["own"]["history"], history):
            assert ep == oep
            _assert_metrics_close(g, w, 2e-4)
        assert r["own"]["best_epoch"] == best
        # a second mesh run from the seed: the same bits
        assert r["own_again"]["history"] == r["own"]["history"]
        for a, b in zip(r["own"]["state"], r["own_again"]["state"]):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert _scalars(tmp / "own_again") != [] and [
        {k: v for k, v in r.items() if k != "time"}
        for r in _scalars(tmp / "own_again")] == [
        {k: v for k, v in r.items() if k != "time"} for r in got]


def test_checkpoints_move_between_mesh_and_one_device(world):
    refs = world["refs"]
    for r in world["ranks"]:
        _assert_metrics_close(r["loaded_test"], refs["loaded_want"], 1e-5)
        _assert_metrics_close(refs["mesh_ckpt_test"], r["own"]["ckpt_test"],
                              1e-5)
    assert os.path.isdir(world["tmp"] / "own_model")


def test_mesh_multi_steps_stay_eager_off_nccl(world):
    """K steps a call graph only on CUDA over nccl (training/steps.py
    `graph_refusal`): on this gloo mesh on the CPU they run eagerly, and
    the Trainer logs so once, on rank 0, naming the reason."""
    for rank, r in enumerate(world["ranks"]):
        refusals = r["eager"]["refusals"]
        assert refusals["cpu"] == "the tensors are on the CPU"
        assert refusals["cuda"].startswith("the mesh's backend is gloo")
        eager = [line for line in r["eager"]["logs"]
                 if "run eagerly" in line]
        assert eager == ([] if rank else [
            "train_steps_per_call 4 on the mesh: each call's steps run "
            "eagerly, not as CUDA graph replays (the tensors are on the "
            "CPU)"]), r["eager"]["logs"]
