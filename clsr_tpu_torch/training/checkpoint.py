"""Checkpoints of a TrainState.

Counterpart of clsr_tpu/training/checkpoint.py:36-56 (the schema sidecar)
and of the orbax save/restore of clsr_tpu/training/trainer.py:683-732.
Orbax is not available to the port, so a checkpoint directory (the same
`<model_dir>/epoch_<n>/` layout) holds this package's own format:

  * `state.pt` (torch.save, read back with weights_only): the model's
    state_dict (parameters and BN running statistics, bf16 tables as
    bf16); the optimizer, either the dense rule's state_dict under its
    name (`kind`: adam, adagrad, ftrl, ...; training/optimizer.py) or
    every tensor of a LazyAdamState (the f32 table rows in their pmn
    param|mu|nu or split mu|nu layout, the count as an int, the route
    counter and the dense Adam's state_dict); and the step;
  * `clsr_meta.json`: {"schema": SCHEMA_VERSION, "layout": "logical",
    "format": "clsr_tpu_torch"}.

A lazyadam state is restored whole: the table Parameters and the pmn
rows both come from the file, so under the compact engine the tables
equal pmn[:, :D] after a load as after every step.

On a mesh (`mesh`; JAX trainer.py:678-720) a checkpoint holds the
LOGICAL layout all the same: each row-sharded tensor (a table block,
its moment rows, a dense rule's state of it) is gathered over its model
row into the id-ordered table (parallel/mesh.py `logical_tensor`), rank
0 writes, and every rank waits for the write; a load reads the logical
file on every rank and keeps the rank's block (`local_tensor`).  So a
checkpoint moves between a mesh and one device in both directions, and
between layouts and mesh shapes.

Run state for an exact mid-epoch resume (JAX :109-167): `save_run_state`
/ `load_run_state` keep `<dir>/run_state.npz` with JAX's fields: the
epoch, the calls done, the step, the host RandomState's MT19937 state
(keys, position, has_gauss, gauss) as JAX saves it, the epoch's padded
permutation and call layout (n_use, n_calls, n_tail; n_calls = -1 at an
epoch boundary), the loss sums, the best metric and epoch, and the mode
('resident' or 'stream').  Where JAX keeps its PRNG key, the port keeps
the fit's `torch.Generator` state (`rng`, uint8: a CUDA generator's seed
and offset, or the CPU generator's whole state) at the call boundary.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from clsr_tpu_torch.parallel.mesh import (Mesh, barrier, local_tensor,
                                          logical_tensor, sharded_tables)
from clsr_tpu_torch.training.lazy_adam import LazyAdamState
from clsr_tpu_torch.training.state import TrainState

# the JAX package's schema history: 1 LazyAdamState(moments, count,
# dense_opt); 2 + route_overflow.  The port's LazyAdamState has all four.
SCHEMA_VERSION = 2
META_NAME = "clsr_meta.json"
STATE_NAME = "state.pt"
FORMAT = "clsr_tpu_torch"


def _kind(opt: torch.optim.Optimizer) -> str:
    """The dense rule's name: a DenseRule's `rule`, else adam."""
    return getattr(opt, "rule", "adam")


def write_meta(path: str, extra: Optional[Dict[str, Any]] = None) -> None:
    meta = {"schema": SCHEMA_VERSION, "layout": "logical"}
    if extra:
        meta.update(extra)
    with open(os.path.join(path, META_NAME), "w") as f:
        json.dump(meta, f)


def read_meta(path: str) -> Optional[Dict[str, Any]]:
    p = os.path.join(path, META_NAME)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def _relayout(blob: Dict[str, Any], state: TrainState,
              fn: Callable[[torch.Tensor], torch.Tensor]) -> None:
    """Apply fn to every row-sharded tensor of a checkpoint's blob, in
    place: the sharded tables' entries of the model, of the moments and
    of a dense rule's per-parameter state (tensors of the table's
    shape, by the optimizer's parameter order)."""
    tables = sharded_tables(state.model)
    model = blob["model"]
    for name in sorted(tables):
        model[name] = fn(model[name])
    opt = blob["optimizer"]
    if opt["kind"] == "lazyadam":
        for name in sorted(tables):
            opt["moments"][name] = fn(opt["moments"][name])
        return
    dense = state.optimizer
    params = [p for g in dense.param_groups for p in g["params"]]
    ids = {id(p) for p in tables.values()}
    states = opt["state_dict"]["state"]
    for i, p in enumerate(params):
        if id(p) not in ids or i not in states:
            continue
        # a copy: state_dict() hands out the optimizer's own state dicts
        st = states[i] = dict(states[i])
        for k in sorted(st):
            v = st[k]
            if torch.is_tensor(v) and v.dim() and v.shape[1:] == p.shape[1:]:
                st[k] = fn(v)


def save_state(path: str, state: TrainState, mesh: Optional[Mesh] = None
               ) -> None:
    """Write `state` into the directory `path` (made if missing); on a
    mesh every rank calls it, and rank 0 writes the logical layout."""
    opt = state.optimizer
    if isinstance(opt, LazyAdamState):
        optimizer = {"kind": "lazyadam", "moments": dict(opt.moments),
                     "count": int(opt.count),
                     "route_overflow": int(opt.route_overflow),
                     "dense": opt.dense_opt.state_dict()}
    else:
        optimizer = {"kind": _kind(opt), "state_dict": opt.state_dict()}
    blob = {"model": state.model.state_dict(), "optimizer": optimizer,
            "step": state.step}
    if mesh is not None:
        _relayout(blob, state, lambda t: logical_tensor(t, mesh))
    if mesh is None or mesh.rank == 0:
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, f"{STATE_NAME}.{os.getpid()}.tmp")
        torch.save(blob, tmp)
        os.replace(tmp, os.path.join(path, STATE_NAME))
        write_meta(path, {"format": FORMAT})
    barrier(mesh)


def _read(path: str) -> Dict[str, Any]:
    meta = read_meta(path)
    if meta is None or meta.get("format") != FORMAT:
        raise IOError(f"{path} is not a checkpoint of clsr_tpu_torch "
                      f"(meta {meta}); the JAX package's orbax checkpoints "
                      f"are not read here")
    # on the host: load_state_dict puts each tensor where its owner lives
    return torch.load(os.path.join(path, STATE_NAME), map_location="cpu",
                      weights_only=True)


def load_model(path: str, model: torch.nn.Module,
               mesh: Optional[Mesh] = None) -> None:
    """Restore only the model part (parameters and BN statistics); on a
    mesh each rank keeps its blocks of the sharded tables."""
    sd = _read(path)["model"]
    if mesh is not None:
        for name in sharded_tables(model):
            sd[name] = local_tensor(sd[name], mesh)
    model.load_state_dict(sd)


@torch.no_grad()
def load_state(path: str, state: TrainState, mesh: Optional[Mesh] = None
               ) -> TrainState:
    """Restore the checkpoint at `path` into `state`, in place; on a mesh
    each rank keeps its blocks of the row-sharded tensors."""
    blob = _read(path)
    if mesh is not None:
        _relayout(blob, state, lambda t: local_tensor(t, mesh))
    state.model.load_state_dict(blob["model"])
    saved, opt = blob["optimizer"], state.optimizer
    lazy = isinstance(opt, LazyAdamState)
    kind = "lazyadam" if lazy else _kind(opt)
    if saved["kind"] != kind:
        raise ValueError(f"{path} holds a {saved['kind']} state; this run's "
                         f"optimizer is {kind}")
    if lazy:
        if set(saved["moments"]) != set(opt.moments):
            raise ValueError(f"moment tables {sorted(saved['moments'])} do "
                             f"not match {sorted(opt.moments)}")
        for name, rows in saved["moments"].items():
            if rows.shape != opt.moments[name].shape:
                raise ValueError(
                    f"moments of {name} have shape {tuple(rows.shape)} in "
                    f"{path}, {tuple(opt.moments[name].shape)} here (pmn "
                    f"and split layouts do not convert)")
            opt.moments[name].copy_(rows)
        opt.count.fill_(int(saved["count"]))
        opt.route_overflow.fill_(int(saved["route_overflow"]))
        opt.dense_opt.load_state_dict(saved["dense"])
    else:
        opt.load_state_dict(saved["state_dict"])
    state.step = int(blob["step"])
    return state


def latest_epoch_dir(model_dir: str) -> str:
    """The `epoch_<n>` directory of `model_dir` with the largest n, as
    tf.train.latest_checkpoint finds it (sequential.py:352-353)."""
    epochs = ([d for d in os.listdir(model_dir) if d.startswith("epoch_")]
              if os.path.isdir(model_dir) else [])
    if not epochs:
        raise IOError(f"Failed to find any matching files for {model_dir}")
    return os.path.join(model_dir,
                        max(epochs, key=lambda d: int(d.split("_")[1])))


RUN_NAME = "run_state.npz"


def save_run_state(path: str, *, epoch: int, calls_done: int, step: int,
                   generator: torch.Generator,
                   np_rng: np.random.RandomState, perm: np.ndarray,
                   n_use: int, n_calls: int, n_tail: int, total: float,
                   data_total: float, best_metric: float, best_epoch: int,
                   mode: str = "resident") -> None:
    """Persist the epoch loop's position at a call boundary.

    mode 'resident': `np_rng` has drawn this epoch's permutation, which
    is saved as it is.  mode 'stream': the loaders draw their
    permutation inside the epoch's iterator, so `np_rng` holds the
    epoch-start state, and a resume rebuilds the iterator and skips
    `calls_done` items on the host; perm, n_use and n_tail are unused."""
    os.makedirs(path, exist_ok=True)
    mt = np_rng.get_state()      # ('MT19937', keys[624], pos, has_g, g)
    tmp = os.path.join(path, f"{RUN_NAME}.{os.getpid()}.tmp.npz")
    np.savez(
        tmp,
        epoch=np.int64(epoch), calls_done=np.int64(calls_done),
        step=np.int64(step), rng=generator.get_state().numpy(),
        perm=np.asarray(perm), n_use=np.int64(n_use),
        n_calls=np.int64(n_calls), n_tail=np.int64(n_tail),
        total=np.float32(total), data_total=np.float32(data_total),
        best_metric=np.float64(best_metric),
        best_epoch=np.int64(best_epoch),
        mt_keys=mt[1], mt_pos=np.int64(mt[2]),
        mt_has_gauss=np.int64(mt[3]), mt_gauss=np.float64(mt[4]),
        mode=np.bytes_(mode.encode()))
    os.replace(tmp, os.path.join(path, RUN_NAME))


def load_run_state(path: str) -> Optional[Dict[str, Any]]:
    """The run state under `path`, or None: the fields of
    `save_run_state`, with `np_rng` a RandomState in the saved state and
    `rng` the generator state as a uint8 tensor."""
    p = os.path.join(path, RUN_NAME)
    if not os.path.exists(p):
        return None
    with np.load(p) as z:
        np_rng = np.random.RandomState(0)
        np_rng.set_state(("MT19937", z["mt_keys"], int(z["mt_pos"]),
                          int(z["mt_has_gauss"]), float(z["mt_gauss"])))
        return dict(
            epoch=int(z["epoch"]), calls_done=int(z["calls_done"]),
            step=int(z["step"]), rng=torch.from_numpy(z["rng"].copy()),
            np_rng=np_rng, perm=z["perm"], n_use=int(z["n_use"]),
            n_calls=int(z["n_calls"]), n_tail=int(z["n_tail"]),
            total=float(z["total"]), data_total=float(z["data_total"]),
            best_metric=float(z["best_metric"]),
            best_epoch=int(z["best_epoch"]),
            mode=bytes(z["mode"]).decode())
