"""Per-tensor gradient clipping and the optimizer.

Counterpart of clsr_tpu/training/optimizer.py:153-202 (reference
base_model.py:249-297): the reference clips EACH gradient tensor to
`max_grad_norm` with tf.clip_by_norm (per variable, not global: this is
not `clip_grad_norm_`) before the optimizer applies it.  Adam follows
optax's math (b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
correction), which `torch.optim.Adam` computes too; its foreach path
updates every tensor in a few launches.  On CUDA it is built with
`capturable=True`: its step counts live on the device, so a train step
reads nothing from the host and a CUDA graph of it (training/steps.py)
does the arithmetic the eager step does.  The CPU keeps the default
Adam, the same math with host step counts.  Adam is no Pallas kernel in the
JAX package, so the port keeps PyTorch's.  Under lazyadam the same Adam
takes the non-table parameters (training/lazy_adam.py updates the
tables).  The other optimizers of the JAX package wait for their
ROADMAP item and raise.
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


def check_optimizer(name: str) -> None:
    """Raise unless optimizer `name` is ported."""
    if name not in ("adam", "lazyadam"):
        raise NotImplementedError(
            f"optimizer {name} waits for ROADMAP queue 1 item 3, the other "
            f"optimizers (adam and lazyadam are ported)")


def build_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]
                    ) -> torch.optim.Optimizer:
    """Adam with optax's defaults (for lazyadam, the dense part over the
    parameters given), capturable when they lie on CUDA; every other
    name raises."""
    check_optimizer(cfg.optimizer)
    params = list(params)
    cuda = any(p.device.type == "cuda" for p in params)
    return torch.optim.Adam(params, lr=cfg.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8, foreach=True,
                            capturable=cuda)
