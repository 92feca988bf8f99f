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
    raises.
  * `to_flax(module)` is the inverse: (params, batch_stats) as nested
    dicts of numpy arrays under the flax names, so a test can compare
    the port's state with the JAX package's by flax path.
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
        state[name].copy_(value)


def to_flax(module: nn.Module) -> Tuple[Dict, Dict]:
    """(params, batch_stats) of `module` as nested flax-named dicts of
    numpy arrays (Dense kernels back in the [in, out] layout)."""
    trees: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    state = module.state_dict()
    for name, (collection, flax, transpose) in flax_names(module).items():
        value = state[name].detach().cpu()
        node = trees[collection]
        *parents, leaf = flax.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = (value.t() if transpose else value).numpy().copy()
    return trees["params"], trees["batch_stats"]


def save(module: nn.Module, path: str) -> None:
    torch.save(module.state_dict(), path)


def load(module: nn.Module, path: str) -> None:
    """Restore a state_dict written by `save` (strict names)."""
    device = next(module.parameters()).device
    module.load_state_dict(torch.load(path, map_location=device,
                                      weights_only=True))
