"""The rank side of the port's mesh tests (tests/test_torch_parallel.py,
tests/test_torch_mesh_train.py, tests/test_torch_owner_routing.py,
tests/test_torch_mesh_resident.py).

Each spawned rank of a 4-rank gloo world (parallel/distributed.py
`run_local_world`) runs one of the `*_world` functions below on the
inputs its test file made with numpy, and returns numpy results (logical
tables, global outputs) for the file to hold against JAX's mesh and the
port's one-rank run.  This module imports torch and the port only: a
spawned rank imports it to find its function, and JAX stays out of the
ranks.
"""

import concurrent.futures
import dataclasses
import os
import shutil

import numpy as np
import torch

import clsr_tpu_torch.training.steps as port_steps
from clsr_tpu_torch import scaling_model
from clsr_tpu_torch.config import load_config
from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.data.loader import SequenceLoader
from clsr_tpu_torch.data.parser import parse_file
from clsr_tpu_torch.data.resident import (build_resident_mesh,
                                          gather_batch_mesh)
from clsr_tpu_torch.data.vocab import Vocab, load_vocab
from clsr_tpu_torch.models.registry import get_model_class
from clsr_tpu_torch.ops import fused_train_attention as fta
from clsr_tpu_torch.ops.initializers import get_initializer
from clsr_tpu_torch.ops.long_context import LongTargetAttention
from clsr_tpu_torch.parallel import collectives as col
from clsr_tpu_torch.parallel import mesh as pm
from clsr_tpu_torch.parallel.embedding import gather_rows
from clsr_tpu_torch.serving import AsyncScoringService, ScoringService
from clsr_tpu_torch.training.evaluator import run_weighted_eval
from clsr_tpu_torch.training.lazy_adam import LazyAdamState, MeshMerge
from clsr_tpu_torch.training.state import create_train_state
from clsr_tpu_torch.training.steps import make_train_step
from clsr_tpu_torch.training.trainer import Trainer


def np_of(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def batch_of(arrays) -> Batch:
    return Batch(**{k: torch.from_numpy(np.array(v)) for k, v in
                    arrays.items()})


def cfg_of(kw) -> object:
    return load_config(None, **kw)


def model_of(cfg, sizes, state_dict=None, graph=None):
    kw = {} if graph is None else {"graph": graph}
    model = get_model_class(cfg.model_type)(cfg, *sizes, device="cpu", **kw)
    if state_dict is not None:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state_dict.items()})
    return model


def logical_state(state, mesh):
    """The model's state_dict, the lazy moments and the dense Adam
    moments ({'exp_avg/<name>', 'exp_avg_sq/<name>'}), logical, as
    numpy."""
    tables = pm.sharded_tables(state.model)
    logical = lambda k, v: np_of(pm.logical_tensor(v, mesh) if k in tables
                                 else v)
    sd = {k: logical(k, v) for k, v in state.model.state_dict().items()}
    moments, adam = {}, state.optimizer
    if isinstance(adam, LazyAdamState):
        moments = {k: logical(k, v) for k, v in adam.moments.items()}
        adam = adam.dense_opt
    dense = {}
    for name, p in state.model.named_parameters():
        for key, v in adam.state.get(p, {}).items():
            if key in ("exp_avg", "exp_avg_sq"):
                dense[f"{key}/{name}"] = logical(name, v)
    return sd, moments, dense


def recording_clip(model, record):
    """training/steps.py's clip_by_norm_each, recording each gradient's
    norms before the clip: {name: (this rank's, the whole tensor's)}."""
    clip = port_steps.clip_by_norm_each

    def wrapped(grads, max_norm, sumsq=None):
        grads = list(grads)
        names = {id(p.grad): n for n, p in model.named_parameters()
                 if p.grad is not None}
        for i, g in enumerate(grads):
            local = (g.float() * g.float()).sum()
            whole = local if sumsq is None else sumsq(local, i)
            record[names[id(g)]] = (float(local.sqrt()), float(whole.sqrt()))
        return clip(grads, max_norm, sumsq)

    return clip, wrapped


def calls_of(calls):
    """collectives.Call's fields as tuples."""
    return [(c.kind, c.group, c.shape, str(c.dtype), c.payload_bytes,
             c.received_bytes) for c in calls]


def parts_of(parts):
    return {f.name: float(getattr(parts, f.name))
            for f in dataclasses.fields(parts)}


# ------------------------------------------------------ test_torch_parallel


def _collective_cases(rank, mesh):
    """all_reduce / all_gather / reduce_scatter, and all_reduce_grad's
    transpose, over the model row and the world, on rank-seeded data."""
    out = {}
    x = torch.from_numpy(np.random.RandomState(rank).randn(4, 3)
                         .astype(np.float32))
    for name, group in (("model", mesh.model_group), ("world", mesh.world)):
        n = col.group_size(group)
        out[f"{name}/all_reduce"] = np_of(col.all_reduce(x, group))
        out[f"{name}/all_reduce_again"] = np_of(col.all_reduce(x, group))
        out[f"{name}/all_gather"] = np_of(col.all_gather(x, group))
        xs = x[:n] if n <= 4 else x
        out[f"{name}/reduce_scatter"] = np_of(col.reduce_scatter(xs, group))
        leaf = xs.clone().requires_grad_()
        y = col.all_reduce_grad(leaf, group)
        w = torch.arange(y.numel(), dtype=torch.float32).reshape(
            y.shape) + rank
        (y * w).sum().backward()
        out[f"{name}/all_reduce_grad/grad"] = np_of(leaf.grad)
    return out


def _gather_case(case, mesh):
    """gather_rows of a logical table's block at this rank's ids; the
    global output and the logical table gradient of sum(out * w)."""
    table = torch.from_numpy(case["table"])
    ids = torch.from_numpy(case["ids"])
    w = torch.from_numpy(case["w"])
    block = pm.local_tensor(table, mesh).requires_grad_()
    local_ids = pm.shard_rows(ids, mesh)
    out = gather_rows(block, local_ids, mesh)
    (out * pm.shard_rows(w, mesh)).sum().backward()
    grad = col.all_reduce(block.grad, mesh.data_group)
    return {"out": np_of(pm.gather_rows_of(out, mesh)),
            "grad": np_of(pm.logical_tensor(grad, mesh))}


def _k3_case(case, mesh):
    """The fused train scorer's plain path with global BN statistics: the
    global output, statistics and input gradients."""
    inputs = [torch.from_numpy(case[k]) for k in (
        "keys", "keys_proj", "query", "mask")]
    params = [torch.from_numpy(case[k]).requires_grad_() for k in (
        "k0", "b0", "scale0", "shift0", "w1", "b1", "scale1", "shift1",
        "w2")]
    local = [pm.shard_rows(t, mesh).clone().requires_grad_()
             for t in inputs[:3]] + [pm.shard_rows(inputs[3], mesh)]
    with pm.use_mesh(mesh):
        att, m0, v0, m1, v1 = fta.fused_train_attention(*local, *params)
        cot = pm.shard_rows(torch.from_numpy(case["cot"]), mesh)
        (att * cot).sum().backward()
    out = {"att": np_of(pm.gather_rows_of(att, mesh)),
           "stats": [np_of(t) for t in (m0, v0, m1, v1)]}
    for name, t in zip(("keys", "keys_proj", "query"), local[:3]):
        out[f"d_{name}"] = np_of(pm.gather_rows_of(t.grad, mesh))
    for name, p in zip(("k0", "b0", "scale0", "shift0", "w1", "b1",
                        "scale1", "shift1", "w2"), params):
        out[f"d_{name}"] = np_of(col.all_reduce(p.grad, mesh.batch_group))
    out["launches"] = (fta.train_stats0.launches, fta.train_stats1.launches)
    return out


def _step_case(case, sizes):
    """One train step on this rank's shard from the given logical state;
    (global loss parts, logical state after, the gradients' norms before
    the dense clip)."""
    cfg = cfg_of(case["cfg"])
    mesh = pm.make_mesh(cfg)
    model = model_of(cfg, sizes, case["state_dict"], case.get("graph"))
    pm.place_model(model, mesh)
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg, mesh)
    batch = pm.shard_batch(batch_of(case["batch"]), mesh)
    norms = {}
    clip, port_steps.clip_by_norm_each = recording_clip(model, norms)
    try:
        with col.count_collectives() as calls:
            state, parts = step(state, batch,
                                torch.Generator().manual_seed(0))
    finally:
        port_steps.clip_by_norm_each = clip
    sd, moments, dense = logical_state(state, mesh)
    return {"parts": parts_of(parts), "state_dict": sd, "moments": moments,
            "dense_moments": dense, "clip_norms": norms,
            "count": int(getattr(state.optimizer, "count", state.step)),
            "calls": calls_of(calls)}


def _eval_case(case, sizes):
    """The mesh eval step on a global batch (K1's plain path), and the
    mesh ScoringService's scores of the requests."""
    cfg = cfg_of(case["cfg"])
    mesh = pm.make_mesh(cfg)
    model = model_of(cfg, sizes, case["state_dict"])
    pm.place_model(model, mesh)
    step = pm.make_sharded_eval_step(cfg, mesh)
    preds, alpha = step(model, batch_of(case["batch"]))
    return {"preds": np_of(preds), "alpha": np_of(alpha)}


def _hist_case(case, sizes):
    """The mesh histogram step on a global batch (steps.py
    `make_histogram_step` with the mesh): {tag: (counts, lo, hi,
    n_nonfinite)}."""
    cfg = cfg_of(case["cfg"])
    mesh = pm.make_mesh(cfg)
    model = model_of(cfg, sizes, case["state_dict"])
    pm.place_model(model, mesh)
    hists = port_steps.make_histogram_step(mesh=mesh)(
        model, batch_of(case["batch"]))
    return {tag: tuple(np_of(t) for t in parts)
            for tag, parts in hists.items()}


def _service(case, sizes, path, **kw):
    return ScoringService(cfg_of(case["cfg"]), *sizes,
                          *(Vocab(m) for m in case["maps"]), checkpoint=path,
                          batch_buckets=(8, 64), cand_buckets=(16, 128),
                          device="cpu", **kw)


def _async_scores(svc, requests, threads):
    """The async frontend over `svc` on every rank: rank 0 submits the
    requests from `threads` threads at once, at most 8 a dispatch.
    (rank 0's scores in request order, or another rank's refusal of
    `submit`; the dispatches; the eval steps' (B, G) this rank ran; the
    synchronous service's scores of the same dispatches, in request
    order)."""
    steps, step, plan = [], svc.step, svc.plan
    groups, index = [], {id(r): i for i, r in enumerate(requests)}
    svc.step = lambda b: (steps.append(tuple(b.items.shape)), step(b))[1]
    svc.plan = lambda reqs: (
        groups.append([index[id(r)] for r in reqs]), plan(reqs))[1]
    front = AsyncScoringService(svc, max_wait_ms=20.0, max_batch=8)
    scores = None
    try:
        if dist_rank() == 0:
            with concurrent.futures.ThreadPoolExecutor(threads) as pool:
                futs = list(pool.map(front.submit, requests))
            scores = [f.result() for f in futs]
        else:
            try:
                front.submit(requests[0])
            except RuntimeError as e:
                scores = str(e)
    finally:
        front.close()
        del svc.step, svc.plan
    shared = [groups]
    torch.distributed.broadcast_object_list(shared, src=0)
    sync = [None] * len(requests)
    for g in shared[0]:
        for i, s in zip(g, svc.score([requests[i] for i in g])):
            sync[i] = s
    return scores, front.dispatches, steps, sync


def _async_faults(svc, requests):
    """The async mesh frontend's failures.  Rank 0 submits a good request
    and a bad one (its candidates' cates one short, in the dispatch's
    second batch) at once: `plan` fails that dispatch and nothing is
    sent.  A good request then runs.  Then every rank's next step
    raises: that stops the frontend.  (rank 0's: the failed dispatch's
    errors, the good request's scores and the synchronous service's,
    the stopping error, the refusal of a later submit; every rank's:
    the dispatches, the step calls, the error kept)."""
    good = min(requests, key=lambda r: len(r.cand_items))
    n = len(good.cand_items) * (16 // len(good.cand_items) + 1)
    bad = dataclasses.replace(
        good, cand_items=list(good.cand_items) * (n // len(good.cand_items)),
        cand_cates=(list(good.cand_cates)
                    * (n // len(good.cand_items)))[:-1])
    calls, step = [0], svc.step

    def failing_step(b):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("injected step failure")
        return step(b)

    svc.step = failing_step
    front = AsyncScoringService(svc, max_wait_ms=200.0)
    out = {}
    try:
        if dist_rank() == 0:
            futs = [front.submit(good), front.submit(bad)]
            out["plan_errors"] = [type(f.exception()).__name__
                                  for f in futs]
            out["good"] = front.submit(good).result()
            out["step_error"] = str(front.submit(good).exception())
            try:
                front.submit(good)
            except RuntimeError as e:
                out["refused"] = str(e)
    finally:
        front.close()
        del svc.step
    out["want"] = svc.score([good])[0]
    out.update(dispatches=front.dispatches, steps=calls[0],
               error=str(front.error))
    return out


def _serve_case(case, sizes):
    """The mesh ScoringService, its weights loaded (logical) before it
    shards them: f32 and int8 scores, the async frontend, and save /
    load of the sharded service (the logical files in case['dir'])."""
    d = case["dir"]
    paths = {}
    for name in ("w", "w2"):
        paths[name] = os.path.join(d, f"{name}_rank{dist_rank()}.pt")
        torch.save({k: torch.from_numpy(v) for k, v in
                    case[name].items()}, paths[name])
    reqs = case["requests"]
    svc = _service(case, sizes, paths["w"])
    out = {"scores": svc.score(reqs),
           "sharded": sorted(pm.sharded_tables(svc.model)),
           "n_batch": svc.mesh.n_batch}
    out["async"] = _async_scores(svc, case["async_requests"], 4)
    out["async_faults"] = _async_faults(svc, case["async_requests"])
    svc.save(os.path.join(d, "mesh.pt"))
    svc8 = _service(case, sizes, paths["w"], int8_tables=True)
    out["scores_int8"] = svc8.score(reqs)
    out["sharded_int8"] = sorted(pm.sharded_tables(svc8.model))
    svc8.save(os.path.join(d, "mesh_int8.pt"))
    # the one-rank services' files of w2, loaded on the mesh, against
    # mesh services built from w2
    out["scores_w2"] = _service(case, sizes, paths["w2"]).score(reqs)
    svc.load(os.path.join(d, "one.pt"))
    out["scores_loaded"] = svc.score(reqs)
    out["scores_w2_int8"] = _service(case, sizes, paths["w2"],
                                     int8_tables=True).score(reqs)
    svc8.load(os.path.join(d, "one_int8.pt"))
    out["scores_loaded_int8"] = svc8.score(reqs)
    return out


def dist_rank():
    return torch.distributed.get_rank()


def parallel_world(rank, device, spec):
    out = {}
    cfg22 = cfg_of(dict(spec["base_cfg"], data_parallel=2, model_parallel=2))
    out["collectives"] = _collective_cases(rank, pm.make_mesh(cfg22))
    for key, case in spec["gather"].items():
        d, m, flat, layout = key
        mesh = pm.make_mesh(cfg_of(dict(
            spec["base_cfg"], data_parallel=d, model_parallel=m,
            mesh_flat_batch="on" if flat else "off",
            mesh_row_layout=layout)))
        out[("gather",) + key] = _gather_case(case, mesh)
    out["k3"] = _k3_case(spec["k3"], pm.make_mesh(cfg_of(dict(
        spec["base_cfg"], data_parallel=2, model_parallel=2))))
    for name, case in spec["steps"].items():
        out[("step", name)] = _step_case(case, spec["sizes"])
    out["eval"] = _eval_case(spec["eval"], spec["sizes"])
    out["hist"] = _hist_case(spec["eval"], spec["sizes"])
    out["serve"] = _serve_case(spec["serve"], spec["sizes"])
    for name, case in spec["static_rows"].items():
        out[("static_rows", name)] = _static_rows_case(
            case, case.get("sizes", spec["sizes"]))
    return out


@torch.no_grad()
def nonzero_reduce_grads(model, mesh, batch=None):
    """training/steps.py's reduce_grads as it was before its row set was
    static: each table block's touched rows found by a host sync
    (`nonzero`), and only those summed."""
    dense = [p for n, p in model.named_parameters()
             if p.grad is not None and getattr(p, "mesh_rows", None) is None]
    if dense:
        flat = col.all_reduce(torch.cat([p.grad.reshape(-1) for p in dense]),
                              mesh.batch_group)
        for p, g in zip(dense, flat.split([p.numel() for p in dense])):
            p.grad.copy_(g.view_as(p.grad))
    for p in pm.sharded_tables(model).values():
        if p.grad is None:
            continue
        touched = col.all_reduce((p.grad != 0).any(1).to(torch.uint8),
                                 mesh.data_group)
        rows = touched.nonzero()[:, 0]
        p.grad[rows] = col.all_reduce(p.grad[rows], mesh.data_group)


def _static_rows_case(case, sizes):
    """One step with the static reduce_grads and one with the nonzero
    one, from the same state: (static, nonzero) `_step_case` results."""
    out = [_step_case(case, sizes)]
    static = port_steps.reduce_grads
    port_steps.reduce_grads = nonzero_reduce_grads
    try:
        out.append(_step_case(case, sizes))
    finally:
        port_steps.reduce_grads = static
    return out


# ---------------------------------------------------- test_torch_mesh_train


def deterministic_negatives(generator, batch, num_ngs):
    """The negatives of row b are the positives of rows b + 1 ... b + k
    (mod the valid rows), as tests/test_torch_trainer.py injects them on
    both sides; on a mesh the steps call it on the global batch."""
    B = batch.items.shape[0]
    n_valid = batch.valid.sum().to(torch.int64).clamp_min(1)
    idx = torch.remainder(torch.arange(B)[:, None]
                          + torch.arange(1, num_ngs + 1)[None, :], n_valid)
    pi, pc = batch.items[:, 0], batch.cates[:, 0]
    items = torch.cat([pi[:, None], pi[idx]], dim=1)
    cates = torch.cat([pc[:, None], pc[idx]], dim=1)
    labels = torch.zeros(items.shape, dtype=torch.float32)
    labels[:, 0] = 1.0
    return dataclasses.replace(batch, items=items, cates=cates,
                               labels=labels)


def loaders_of(spec):
    vocabs = [load_vocab(spec["paths"][f"{n}_vocab"])
              for n in ("user", "item", "cate")]
    return {s: SequenceLoader(parse_file(spec["paths"][s], *vocabs),
                              spec["L"])
            for s in ("train", "valid", "test")}


def _fit(cfg, sizes, loaders, state_dict=None):
    """A mesh Trainer (state_dict: its logical start, else the seed's),
    fitted: its eval history, steps, logical state, and with save_model
    the test metrics of its best epoch's checkpoint, loaded back."""
    model = model_of(cfg, sizes, state_dict)
    t = Trainer(model, cfg, log=lambda *a: None)
    t.fit(loaders["train"], loaders["valid"])
    out = {"history": t.eval_history, "best_epoch": t.best_epoch,
           "steps": [s["steps"] for s in t.epoch_stats],
           "state": logical_state(t.state, t.mesh)}
    if cfg.save_model and cfg.model_dir:    # the best epoch's checkpoint
        t.load_latest(cfg.model_dir)
        out["ckpt_test"] = run_weighted_eval(
            t.eval_step, t.state.model, loaders["test"], cfg,
            cfg.test_num_ngs, calc_mean_alpha=True)
    return out


def train_world(rank, device, spec):
    out = {}
    for name, case in spec["steps"].items():
        out[("step", name)] = _step_case(case, spec["sizes"])
    loaders = loaders_of(spec)
    # a one-device checkpoint, loaded on the mesh
    cfg = cfg_of(spec["loaded"]["cfg"])
    t = Trainer(model_of(cfg, spec["sizes"]), cfg, log=lambda *a: None)
    t.load_latest(spec["loaded"]["model_dir"])
    out["loaded_test"] = run_weighted_eval(
        t.eval_step, t.state.model, loaders["test"], cfg, cfg.test_num_ngs,
        calc_mean_alpha=True)
    # two epochs against JAX's mesh fit, negatives injected
    expand = port_steps.expand_with_negatives
    port_steps.expand_with_negatives = deterministic_negatives
    try:
        out["fit"] = _fit(cfg_of(spec["fit"]["cfg"]), spec["sizes"],
                          loaders, spec["fit"]["state_dict"])
    finally:
        port_steps.expand_with_negatives = expand
    # K = 4 steps a call on a gloo mesh on the CPU: eager, and the
    # Trainer says why
    cfg = cfg_of(spec["own"]["cfgs"][1])
    logs = []
    Trainer(model_of(cfg, spec["sizes"]), cfg,
            log=lambda *a: logs.append(" ".join(map(str, a))))
    mesh = pm.make_mesh(cfg)
    out["eager"] = dict(logs=logs, refusals={
        dev: port_steps.graph_refusal(mesh, torch.device(dev))
        for dev in ("cpu", "cuda")})
    # its own in-batch sampling, against the one-rank port; twice, bit
    # for bit
    for run, kw in zip(("own", "own_again"), spec["own"]["cfgs"]):
        out[run] = _fit(cfg_of(kw), spec["sizes"], loaders,
                        spec["fit"]["state_dict"])
    return out


# -------------------------------------------------- test_torch_owner_routing


def _steps_case(case, sizes=None):
    """len(case['batches']) train steps on this rank's shards from a
    logical state: each step's global loss parts and the overflow
    counter after it, the logical state after the last, and the
    collectives the steps made (as tuples of collectives.Call's
    fields)."""
    cfg = cfg_of(case["cfg"])
    mesh = pm.make_mesh(cfg)
    model = model_of(cfg, case.get("sizes", sizes), case["state_dict"])
    pm.place_model(model, mesh)
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg, mesh)
    parts, overflow, patterns = [], [], []
    pattern = MeshMerge.pattern

    def recorded(merge):    # the owner merge's branches, when read
        patterns.append(pattern(merge))
        return patterns[-1]
    MeshMerge.pattern = recorded
    try:
        with col.count_collectives() as calls:
            for b in case["batches"]:
                state, p = step(state, pm.shard_batch(batch_of(b), mesh),
                                torch.Generator().manual_seed(0))
                parts.append(parts_of(p))
                overflow.append(int(state.optimizer.route_overflow))
    finally:
        MeshMerge.pattern = pattern
    sd, moments, dense = logical_state(state, mesh)
    return {"parts": parts, "overflow": overflow, "state_dict": sd,
            "moments": moments, "flat": mesh.flat, "calls": calls_of(calls),
            "patterns": patterns}


def _group_case(kw):
    """Each of the mesh's groups of cfg `kw`: its label and global ranks."""
    mesh = pm.make_mesh(cfg_of(kw))
    return {name: (col._group_names.get(id(g)),
                   torch.distributed.get_process_group_ranks(g))
            for name, g in (("data", mesh.data_group),
                            ("model", mesh.model_group),
                            ("world", mesh.world))}


def owner_world(rank, device, spec):
    out = {name: _steps_case(case) for name, case in spec["cases"].items()}
    for key, kw in spec["groups"].items():
        out[("groups", key)] = _group_case(kw)
    for key, (kw, sizes) in spec["scaling"].items():
        out[("scaling", key)] = calls_of(scaling_model.count_step_calls(
            cfg_of(kw), sizes))
    return out


# ------------------------------------------------- test_torch_mesh_resident


def _gather_mesh_case(case, flat):
    """gather_batch_mesh of the global rows `idx` from this rank's block
    of the view, the batch shards' blocks gathered back in order."""
    cfg = cfg_of(dict(case["cfg"], mesh_flat_batch="on" if flat
                      else "off"))
    mesh = pm.make_mesh(cfg)
    res = build_resident_mesh(case["view"], mesh, "cpu")
    got = gather_batch_mesh(res, torch.from_numpy(case["idx"]),
                            torch.from_numpy(case["valid"]), mesh)
    return {f.name: np_of(pm.gather_rows_of(getattr(got, f.name), mesh))
            for f in dataclasses.fields(got)}


def _attention_case(case, group):
    """The sequence-parallel merge: this rank's shard of the keys' L
    axis; the output, and the gradients of sum(out * cot) / n_ranks
    (each rank's loss a share) of the keys' shard and (summed over the
    group) of the parameters."""
    n, r = col.group_size(group), torch.distributed.get_rank(group)
    mod = LongTargetAttention(case["dq"], case["dk"], case["layers"],
                              get_initializer("tnormal", 0.1),
                              torch.Generator(), torch.device("cpu"),
                              block_size=case["block"])
    mod.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in case["params"].items()})
    L = case["keys"].shape[1] // n
    keys = torch.from_numpy(case["keys"][:, r * L:(r + 1) * L].copy())
    keys.requires_grad_()
    mask = torch.from_numpy(case["mask"][:, r * L:(r + 1) * L].copy())
    out = mod(torch.from_numpy(case["query"]), keys, mask, axis_name=group)
    ((out * torch.from_numpy(case["cot"])).sum() / n).backward()
    return {"out": np_of(out),
            "d_keys": np_of(col.all_gather(keys.grad, group)),
            "d_params": {k: np_of(col.all_reduce(p.grad, group))
                         for k, p in mod.named_parameters()}}


def _fit_case(cfg, sizes, loaders, state_dict):
    """A mesh fit (negatives injected): _fit's record, whether it took
    the resident path, and its log lines."""
    logs = []
    model = model_of(cfg, sizes, state_dict)
    t = Trainer(model, cfg, log=lambda *a: logs.append(" ".join(
        str(x) for x in a)))
    t.fit(loaders["train"], loaders["valid"])
    return {"history": t.eval_history, "steps": [s["steps"] for s in
                                                 t.epoch_stats],
            "resident": t.feeds is not None, "bucketed": t.bucketed,
            "state": logical_state(t.state, t.mesh), "logs": logs,
            "overflow": int(getattr(t.state.optimizer, "route_overflow",
                                    torch.zeros(()))),
            "uses_resident_small": Trainer(
                model_of(cfg.replace(resident_max_bytes=100), sizes),
                cfg.replace(resident_max_bytes=100),
                log=lambda *a: None)._use_resident(loaders["train"])}


class Killed(Exception):
    pass


def _kill_resume_case(case, sizes, loaders, state_dict):
    """Fit B with an autosave after every call, killed right after its
    case['kill']-th autosave; the autosave copied to case['copy'] (fit C
    removes it when it ends); fit C, a fresh mesh Trainer on B's
    model_dir, resumed.  C's record as _fit_case's, B's logical state at
    the kill, and the lockstep check's refusal of a field that differs
    by rank."""
    cfg = cfg_of(case["cfg"])
    b = Trainer(model_of(cfg, sizes, state_dict), cfg, log=lambda *a: None)
    name = ("_autosave" if b._use_resident(loaders["train"])
            else "_autosave_stream")
    save, seen = getattr(b, name), []

    def kill(*args, **kwargs):
        save(*args, **kwargs)
        seen.append(args[1])
        if len(seen) == case["kill"]:
            raise Killed
    setattr(b, name, kill)
    try:
        b.fit(loaders["train"], loaders["valid"])
    except Killed:
        pass
    out = {"killed_at": seen[-1], "killed_state": logical_state(b.state,
                                                                b.mesh)}
    try:
        b._check_lockstep({"total": float(dist_rank())})
    except RuntimeError as e:
        out["lockstep"] = str(e)
    auto = os.path.join(cfg.model_dir, "autosave")
    if dist_rank() == 0:
        shutil.copytree(auto, case["copy"])
    pm.barrier(b.mesh)
    logs = []
    c = Trainer(model_of(cfg, sizes, state_dict), cfg,
                log=lambda *a: logs.append(" ".join(str(x) for x in a)))
    c.fit(loaders["train"], loaders["valid"], resume=True)
    out.update(history=c.eval_history,
               steps=[st["steps"] for st in c.epoch_stats],
               resident=c.feeds is not None,
               state=logical_state(c.state, c.mesh), logs=logs,
               autosave_left=os.path.exists(auto))
    return out


def resident_world(rank, device, spec):
    out = {}
    for flat in (True, False):
        out[("gather", flat)] = _gather_mesh_case(spec["gather"], flat)
    cfg = cfg_of(spec["gather"]["cfg"])
    out["attention"] = _attention_case(spec["attention"],
                                       pm.make_mesh(cfg).world)
    for name, case in spec["zoo"].items():
        out[("zoo", name)] = _steps_case(case, spec["zoo_sizes"])
    loaders = loaders_of(spec)
    expand = port_steps.expand_with_negatives
    port_steps.expand_with_negatives = deterministic_negatives
    try:
        for name, kw in spec["fits"].items():
            out[("fit", name)] = _fit_case(cfg_of(kw), spec["sizes"],
                                           loaders, spec["state_dict"])
        for name, case in spec["resume"].items():
            out[("resume", name)] = _kill_resume_case(
                case, spec["sizes"], loaders, spec["state_dict"])
    finally:
        port_steps.expand_with_negatives = expand
    return out


# --------------------------------------------------- test_torch_mesh_gpu


def _card_state(state):
    """Every tensor of a train state on the rank (its blocks), as numpy."""
    out = {f"model/{k}": np_of(v) for k, v in
           state.model.state_dict().items()}
    opt = state.optimizer
    if isinstance(opt, LazyAdamState):
        out.update({f"moments/{k}": np_of(v)
                    for k, v in opt.moments.items()})
        out["count"] = np_of(opt.count)
        out["overflow"] = np_of(opt.route_overflow)
        opt = opt.dense_opt
    for i, st in enumerate(opt.state_dict()["state"].values()):
        out.update({f"opt/{i}/{k}": np_of(v) for k, v in st.items()})
    return out


def _card_run(cfg, sizes, state_dict, batches, device, K):
    """len(batches) steps from a logical state on this rank's card: K = 1
    eager single steps, else calls of K steps (`MultiTrainStep`, CUDA
    graphs over nccl).  (loss rows, state, launches, collectives, the
    branch patterns read, capture stats)."""
    from clsr_tpu_torch.ops import launches
    mesh = pm.make_mesh(cfg)
    model = get_model_class(cfg.model_type)(cfg, *sizes, device=device)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()})
    pm.place_model(model, mesh)
    state = create_train_state(model, cfg)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    local = [pm.shard_batch(batch_of(b), mesh).to(device) for b in batches]
    patterns, pattern = [], MeshMerge.pattern

    def recorded(merge):
        patterns.append(pattern(merge))
        return patterns[-1]
    MeshMerge.pattern = recorded
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == \
        "cuda" else (lambda: None)
    sync()
    launches.add(launches.snapshot(), -1)
    rows, stats = [], None
    try:
        with col.count_collectives() as calls:
            if K == 1:
                step = make_train_step(model, cfg, mesh)
                for b in local:
                    state, p = step(state, b, gen)
                    rows.append([float(x) for x in port_steps._row(p)])
            else:
                multi = port_steps.make_multi_train_step(model, cfg, K, mesh)
                for i in range(0, len(local), K):
                    state, p = multi(state, port_steps.stack_batches(
                        local[i:i + K]), gen)
                    rows += np_of(port_steps._row(p).T).tolist()
                stats = multi.capture_stats
            sync()
    finally:
        MeshMerge.pattern = pattern
    return dict(rows=rows, state=_card_state(state), patterns=patterns,
                launches={n: k for n, k in launches.snapshot().items() if k},
                calls=calls_of(calls), stats=stats)


def graphed_world(rank, device, spec):
    """tests/test_torch_mesh_gpu.py's rank: each case's steps eager (K =
    1) and graphed (calls of K) over nccl from one state; then a capture
    that must fail (a host sync inside the step)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, kw in spec["cases"].items():
        cfg = cfg_of(dict(spec["cfg"], **kw))
        out[name] = [_card_run(cfg, spec["sizes"], spec["state_dict"],
                               spec["batches"], device, K)
                     for K in (1, spec["K"])]
    cfg = cfg_of(spec["cfg"])
    synced = port_steps.on_global_batch

    def host_sync(*args, **kwargs):
        int(args[2].users.sum())            # a sync inside the capture
        return synced(*args, **kwargs)
    port_steps.on_global_batch = host_sync
    try:
        _card_run(cfg, spec["sizes"], spec["state_dict"], spec["batches"],
                  device, spec["K"])
        out["failed_capture"] = None
    except RuntimeError as e:
        out["failed_capture"] = str(e)
    finally:
        port_steps.on_global_batch = synced
    return out
