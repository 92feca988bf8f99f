"""Train state: the model (parameters and BN running statistics), the
optimizer and the step count.

Counterpart of clsr_tpu/training/state.py.  The port's model is built
with its parameters (from the seed, or loaded through weights.from_flax),
so `create_train_state` only adds the optimizer (training/optimizer.py);
the train step updates the state in place.  Under `optimizer: lazyadam`
the optimizer is a training.lazy_adam.LazyAdamState (JAX :32-40): the
tables' moment rows, in the pmn param|mu|nu layout built from the
model's current tables when the compact row engine runs, else the split
mu|nu layout, and a dense Adam over the other parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

from clsr_tpu_torch.config import Config
from clsr_tpu_torch.models.base import check_not_quantized
from clsr_tpu_torch.training.lazy_adam import LazyAdam, LazyAdamState
from clsr_tpu_torch.training.optimizer import build_optimizer


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Union[torch.optim.Optimizer, LazyAdamState]
    step: int = 0


def create_train_state(model: torch.nn.Module, cfg: Config) -> TrainState:
    """The config's dense optimizer over every parameter of `model`, or
    for lazyadam the lazy state over its tables and dense Adam over the
    rest.  A model with int8 (serving) tables raises."""
    check_not_quantized(model)
    if cfg.optimizer == "lazyadam":
        return TrainState(model=model, optimizer=LazyAdam(cfg).init(model))
    return TrainState(model=model,
                      optimizer=build_optimizer(cfg, model.parameters()))
