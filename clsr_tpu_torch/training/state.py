"""Train state: the model (parameters and BN running statistics), the
optimizer and the step count.

Counterpart of clsr_tpu/training/state.py.  The port's model is built
with its parameters (from the seed, or loaded through weights.from_flax),
so `create_train_state` only adds the optimizer; the train step updates
the state in place.
"""

from __future__ import annotations

import dataclasses

import torch

from clsr_tpu_torch.config import Config
from clsr_tpu_torch.training.optimizer import build_optimizer


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(model: torch.nn.Module, cfg: Config) -> TrainState:
    """The optimizer over every parameter of `model` (dense Adam)."""
    return TrainState(model=model,
                      optimizer=build_optimizer(cfg, model.parameters()))
