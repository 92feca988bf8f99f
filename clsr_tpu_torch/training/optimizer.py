"""Per-tensor gradient clipping and the optimizer.

Counterpart of clsr_tpu/training/optimizer.py:153-202 (reference
base_model.py:249-297): the reference clips EACH gradient tensor to
`max_grad_norm` with tf.clip_by_norm (per variable, not global: this is
not `clip_grad_norm_`) before the optimizer applies it.  Adam follows
optax's math (b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
correction), which `torch.optim.Adam` computes too; its foreach path
updates every tensor in a few launches.  Adam is no Pallas kernel in the
JAX package, so the port keeps PyTorch's.  The other optimizers of the
JAX package wait for their ROADMAP item and raise.
"""

from __future__ import annotations

from typing import Iterable

import torch

from clsr_tpu_torch.config import Config


@torch.no_grad()
def clip_by_norm_each(grads: Iterable[torch.Tensor],
                      max_norm: float) -> None:
    """tf.clip_by_norm per tensor, in place: g * max_norm / ||g|| where
    ||g|| > max_norm, else g."""
    for g in grads:
        norm = torch.linalg.vector_norm(g)
        g.mul_(torch.where(norm > max_norm, max_norm / norm,
                           torch.ones_like(norm)))


def build_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]
                    ) -> torch.optim.Optimizer:
    """Adam with optax's defaults; every other name raises."""
    name = cfg.optimizer
    if name == "adam":
        return torch.optim.Adam(params, lr=cfg.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8, foreach=True)
    if name == "lazyadam":
        raise NotImplementedError(
            "optimizer lazyadam waits for ROADMAP queue 1, LazyAdam and the "
            "compact row engine")
    raise NotImplementedError(
        f"optimizer {name} waits for ROADMAP queue 1, the other optimizers "
        f"(adam is ported)")
