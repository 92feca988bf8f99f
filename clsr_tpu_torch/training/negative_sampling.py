"""On-device in-batch negative sampling.

Counterpart of clsr_tpu/training/negative_sampling.py:31-50, 98-110,
which replaces the reference's host-side rejection loop
(sequential_iterator.py:396-412): for each positive row, `num_ngs`
negatives are drawn uniformly from the batch's positive rows (so the
distribution follows in-batch item frequency), and a draw equal to the
row's own positive item is drawn again, in a fixed number of vectorised
rounds.  A collision that survives every round keeps its draw.  Draws
come from [0, n_valid): padding rows sit in a suffix.  The numbers come
from an explicit `torch.Generator` on the batch's device; they differ
from JAX's by design, so parity tests inject negatives.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from clsr_tpu_torch.data.batch import Batch


def _draw(generator: torch.Generator, shape, n_valid: torch.Tensor,
          device) -> torch.Tensor:
    """Uniform integers in [0, n_valid), without a host sync."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float64)
    return torch.minimum((u * n_valid).long(), n_valid - 1)


def sample_in_batch_negatives(generator: torch.Generator,
                              items: torch.Tensor, cates: torch.Tensor,
                              valid: torch.Tensor, num_ngs: int,
                              rounds: int = 8
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw [B, num_ngs] negative (item, cate) pairs from the batch's
    positives; padding rows get draws too (their loss is masked)."""
    B = items.shape[0]
    n_valid = valid.to(torch.int64).sum().clamp_min(1)
    idx = _draw(generator, (B, num_ngs), n_valid, items.device)
    for _ in range(1, rounds):
        collide = items[idx] == items[:, None]
        fresh = _draw(generator, (B, num_ngs), n_valid, items.device)
        idx = torch.where(collide, fresh, idx)
    return items[idx], cates[idx]


def expand_with_negatives(generator: torch.Generator, batch: Batch,
                          num_ngs: int) -> Batch:
    """[B]-row positive batch -> grouped batch with G = 1 + num_ngs
    candidates; column 0 is the positive (labels [1, 0, ..., 0])."""
    pos_items = batch.items[:, 0]
    pos_cates = batch.cates[:, 0]
    neg_items, neg_cates = sample_in_batch_negatives(
        generator, pos_items, pos_cates, batch.valid, num_ngs)
    items = torch.cat([pos_items[:, None], neg_items], dim=1)
    cates = torch.cat([pos_cates[:, None], neg_cates], dim=1)
    labels = torch.zeros(items.shape, dtype=torch.float32,
                         device=items.device)
    labels[:, 0] = 1.0
    return dataclasses.replace(batch, items=items, cates=cates,
                               labels=labels)
