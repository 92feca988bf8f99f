"""On-device in-batch negative sampling.

Counterpart of clsr_tpu/training/negative_sampling.py:31-110,
which replaces the reference's host-side rejection loop
(sequential_iterator.py:396-412): for each positive row, `num_ngs`
negatives are drawn uniformly from the batch's positive rows (so the
distribution follows in-batch item frequency), and a draw equal to the
row's own positive item is drawn again, in a fixed number of vectorised
rounds.  A collision that survives every round keeps its draw.  Draws
come from [0, n_valid): padding rows sit in a suffix.  The numbers come
from an explicit `torch.Generator` on the batch's device; they differ
from JAX's by design, so parity tests inject negatives.

`expand_nextitnet` (JAX :53-94, nextitnet_iterator.py:100-215) builds
NextItNet's per-position targets the same way, drawing per position.

On a mesh the negatives are the global batch's, as GSPMD makes JAX's:
`on_global_batch` all_gathers the shards' positive (item, cate) columns
and valid flags over the batch group, every rank draws the global
[B, num_ngs] negatives from its generator (kept in lockstep: every
rank's is seeded alike and draws alike), and keeps its own rows, so a
W-rank step draws the negatives a one-rank step draws.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.models.nextitnet import right_align
from clsr_tpu_torch.parallel.mesh import (active_mesh, gather_rows_of,
                                          local_rows_of)


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


def expand_nextitnet(generator: torch.Generator, batch: Batch,
                     num_ngs: int, rounds: int = 8) -> Batch:
    """Per-position targets [B, 1 + num_ngs, L] for NextItNet training.

    With the history right-aligned, the positive at position t is the
    next history event, and the line's target at the last position; the
    negatives of each position are drawn from the batch's line-level
    positives, a draw equal to the position's positive drawn again.
    Labels are 1 in the positive copy and 0 in the others, padded
    positions included (the reference does not mask them either)."""
    B, L = batch.item_hist.shape
    hist_r = right_align(batch.item_hist[..., None], batch.mask)[..., 0]
    cate_r = right_align(batch.cate_hist[..., None], batch.mask)[..., 0]
    pos_items = torch.cat([hist_r[:, 1:], batch.items[:, :1]], dim=1)
    pos_cates = torch.cat([cate_r[:, 1:], batch.cates[:, :1]], dim=1)
    line_items, line_cates = batch.items[:, 0], batch.cates[:, 0]
    n_valid = batch.valid.to(torch.int64).sum().clamp_min(1)
    shape = (B, num_ngs, L)
    idx = _draw(generator, shape, n_valid, line_items.device)
    for _ in range(1, rounds):
        collide = line_items[idx] == pos_items[:, None, :]
        fresh = _draw(generator, shape, n_valid, line_items.device)
        idx = torch.where(collide, fresh, idx)
    items = torch.cat([pos_items[:, None, :], line_items[idx]], dim=1)
    cates = torch.cat([pos_cates[:, None, :], line_cates[idx]], dim=1)
    labels = torch.zeros(items.shape, dtype=torch.float32,
                         device=items.device)
    labels[:, 0, :] = 1.0
    return dataclasses.replace(batch, items=items, cates=cates,
                               labels=labels)


def on_global_batch(expand, generator: torch.Generator, batch: Batch,
                    num_ngs: int, history: bool = False) -> Batch:
    """expand(generator, batch, num_ngs) on the global batch's positives
    when a mesh is active, this rank's rows of the result kept; `expand`
    reads the positives' items, cates and valid flags, and with
    `history` (NextItNet's per-position targets, `expand_nextitnet`)
    the histories and the mask too."""
    mesh = active_mesh()
    if mesh is None:
        return expand(generator, batch, num_ngs)
    pos = gather_rows_of(torch.stack([batch.items[:, 0],
                                      batch.cates[:, 0]], 1), mesh)
    glob = dataclasses.replace(batch, items=pos[:, :1], cates=pos[:, 1:],
                               valid=gather_rows_of(batch.valid, mesh))
    if history:
        hist = gather_rows_of(torch.stack([batch.item_hist,
                                           batch.cate_hist], -1), mesh)
        glob = dataclasses.replace(glob, item_hist=hist[..., 0],
                                   cate_hist=hist[..., 1],
                                   mask=gather_rows_of(batch.mask, mesh))
    out = expand(generator, glob, num_ngs)
    return dataclasses.replace(batch, items=local_rows_of(out.items),
                               cates=local_rows_of(out.cates),
                               labels=local_rows_of(out.labels))
