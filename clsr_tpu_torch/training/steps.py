"""The eval step (counterpart of clsr_tpu/training/steps.py:331-364).

Eval mode: BN running statistics, no dropout (base_model.py:366-392);
preds = sigmoid(logit) for classification (base_model.py:89-109).  The
train steps wait for the training slice.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from clsr_tpu_torch.config import Config
from clsr_tpu_torch.data.batch import Batch


def make_eval_step_fn(cfg: Config) -> Callable[
        [torch.nn.Module, Batch], Tuple[torch.Tensor, torch.Tensor]]:
    """The eval step: (model, batch) -> (preds [B, G], alpha [B, G]).

    The eval scorer kernel follows cfg.use_pallas_eval_attention, which
    the model's attention layers read ('auto' = on for CUDA tensors)."""

    def step(model: torch.nn.Module, batch: Batch):
        model.eval()
        with torch.inference_mode():
            logits, aux = model(batch)
            preds = (torch.sigmoid(logits)
                     if cfg.method == "classification" else logits)
            alpha = aux.get("alpha")
            if alpha is None:
                alpha = torch.zeros_like(preds)
        return preds, alpha

    return step
