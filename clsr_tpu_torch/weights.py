"""Weights in and out of the port's modules.

Counterpart of clsr_tpu/training/state.py:21-43 (the state a model
starts from) plus restore.  Orbax checkpoints cannot be read without
JAX, so two ways in:

  * `from_flax(module, params, batch_stats)` loads the flax trees of the
    JAX package (nested dicts or flattened with '/', numpy arrays).
    Names map one to one: the torch name `a.b.leaf` is the flax
    `a/b/leaf`, BN running statistics (`mean`, `var`) come from
    `batch_stats`, and an `nn.Linear`'s `weight` is the transpose of
    the flax Dense `kernel` ([in, out]).  Any name left over or missing
    raises.  Each value is read as f32 and stored in the module's own
    type: a bf16 table given as JAX's bf16 or as its f32 widening lands
    bit for bit (the widening is exact), and a value a bf16 table cannot
    hold exactly raises.
  * `to_flax(module)` is the inverse: (params, batch_stats) as nested
    dicts of numpy arrays under the flax names, so a test can compare
    the port's state with the JAX package's by flax path; bf16 tensors
    come out widened to f32 (numpy has no bf16).
  * `opt_from_flax(state, moments, count, dense_mu, dense_nu)` and
    `opt_to_flax(state)` carry a JAX `LazyAdamState` across: the table
    moment rows (pmn [N, 3D] or split [N, 2D], keyed by flax table path),
    the step count and, going in, the dense Adam moments by flax name,
    so that the port can continue from JAX's state after step k.
  * `save` / `load` of the port's own `state_dict`.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


def flatten_tree(tree: Optional[Mapping], prefix: str = ""
                 ) -> Dict[str, np.ndarray]:
    """Nested or '/'-flattened mapping -> {'a/b/leaf': array}."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in (tree or {}).items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, name + "/"))
        else:
            flat[name] = np.asarray(value)
    return flat


def flax_names(module: nn.Module) -> Dict[str, Tuple[str, str, bool]]:
    """torch state_dict name -> (collection, flax name, transpose)."""
    buffers = {name for name, _ in module.named_buffers()}
    out = {}
    for name in module.state_dict():
        path, _, leaf = name.rpartition(".")
        owner = module.get_submodule(path) if path else module
        transpose = isinstance(owner, nn.Linear) and leaf == "weight"
        flax_leaf = "kernel" if transpose else leaf
        collection = "batch_stats" if name in buffers else "params"
        flax = "/".join(path.split(".") + [flax_leaf]) if path else flax_leaf
        out[name] = (collection, flax, transpose)
    return out


@torch.no_grad()
def from_flax(module: nn.Module, params: Mapping,
              batch_stats: Optional[Mapping] = None) -> None:
    """Load flax `params` / `batch_stats` trees into `module`."""
    trees = {"params": flatten_tree(params),
             "batch_stats": flatten_tree(batch_stats)}
    mapping = flax_names(module)
    wanted = {(c, f) for c, f, _ in mapping.values()}
    given = {(c, f) for c, tree in trees.items() for f in tree}
    missing = sorted(f"{c}/{f}" for c, f in wanted - given)
    leftover = sorted(f"{c}/{f}" for c, f in given - wanted)
    if missing or leftover:
        raise ValueError(f"flax tree does not match the module: missing "
                         f"{missing}, left over {leftover}")
    state = module.state_dict()
    for name, (collection, flax, transpose) in mapping.items():
        value = torch.from_numpy(np.array(trees[collection][flax],
                                          dtype=np.float32))
        if transpose:
            value = value.t()
        if tuple(value.shape) != tuple(state[name].shape):
            raise ValueError(f"{collection}/{flax} has shape "
                             f"{tuple(value.shape)}, {name} needs "
                             f"{tuple(state[name].shape)}")
        cast = value.to(state[name].dtype)
        if not torch.equal(cast.float(), value):
            raise ValueError(f"{collection}/{flax} is not exact in "
                             f"{state[name].dtype} ({name})")
        state[name].copy_(cast)


def to_flax(module: nn.Module) -> Tuple[Dict, Dict]:
    """(params, batch_stats) of `module` as nested flax-named dicts of
    numpy arrays (Dense kernels back in the [in, out] layout)."""
    trees: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    state = module.state_dict()
    for name, (collection, flax, transpose) in flax_names(module).items():
        value = state[name].detach().cpu()
        if value.dtype == torch.bfloat16:
            value = value.float()
        node = trees[collection]
        *parents, leaf = flax.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = (value.t() if transpose else value).numpy().copy()
    return trees["params"], trees["batch_stats"]


@torch.no_grad()
def opt_from_flax(state, moments: Mapping, count: int,
                  dense_mu: Optional[Mapping] = None,
                  dense_nu: Optional[Mapping] = None) -> None:
    """Load a JAX LazyAdamState into the port's lazyadam `state` (a
    training.state.TrainState): the moment arrays replace the port's
    (their layout with them), `count` sets the step count, and the dense
    Adam moments, when given, become torch.optim.Adam's state at step
    `count` (optax's flattened Adam keeps one count for all)."""
    opt = state.optimizer
    params = dict(state.model.named_parameters())
    given = flatten_tree(moments)
    if set(given) != set(opt.moments):
        raise ValueError(f"moment tables {sorted(given)} do not match the "
                         f"port's {sorted(opt.moments)}")
    for name, value in given.items():
        p = params[name]
        if value.shape[0] != p.shape[0] or value.shape[1] not in (
                2 * p.shape[1], 3 * p.shape[1]):
            raise ValueError(f"moments of {name} have shape {value.shape}, "
                             f"table {tuple(p.shape)}")
        opt.moments[name] = torch.from_numpy(
            np.array(value, dtype=np.float32)).to(p.device)
    opt.count.fill_(int(count))
    state.step = int(count)
    if dense_mu is None:
        return
    mus, nus = flatten_tree(dense_mu), flatten_tree(dense_nu)
    mapping = flax_names(state.model)
    names = {id(p): n for n, p in params.items()}
    adam = opt.dense_opt
    for group in adam.param_groups:
        for p in group["params"]:
            _, flax, transpose = mapping[names[id(p)]]
            mu, nu = (torch.from_numpy(np.array(t[flax], dtype=np.float32))
                      for t in (mus, nus))
            if transpose:
                mu, nu = mu.t(), nu.t()
            adam.state[p] = {
                # capturable Adam (on CUDA) keeps its step on the device
                "step": torch.tensor(float(count), device=(
                    p.device if group["capturable"] else "cpu")),
                "exp_avg": mu.to(p.device).contiguous(),
                "exp_avg_sq": nu.to(p.device).contiguous()}


def opt_to_flax(state) -> Tuple[Dict, int]:
    """(moments, count) of the port's lazyadam `state`: the moment rows as
    nested flax-named dicts of numpy arrays, in the port's layout."""
    opt = state.optimizer
    trees: Dict = {}
    for name, mn in opt.moments.items():
        node = trees
        *parents, leaf = name.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = mn.detach().cpu().numpy().copy()
    return trees, int(opt.count)


def save(module: nn.Module, path: str) -> None:
    torch.save(module.state_dict(), path)


def load(module: nn.Module, path: str) -> None:
    """Restore a state_dict written by `save` (strict names)."""
    device = next(module.parameters()).device
    module.load_state_dict(torch.load(path, map_location=device,
                                      weights_only=True))
