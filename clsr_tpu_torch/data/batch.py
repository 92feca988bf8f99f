"""The batch the model reads: one history per row, G candidate targets.

Counterpart of clsr_tpu/data/batch.py:24-48 (the grouped-target layout
that replaces the reference's feed_dict, sequential_iterator.py:47-70):
a row carries its history ONCE and `items`/`cates`/`labels` are [B, G],
so the encoders run once per row and only the target-conditioned heads
fan out over G.  `valid` marks real rows; padding rows are all zeros.
The model reads tensors; the host loader (data/loader.py) yields the
same dataclass with numpy fields, which data/prefetch.py moves to the
device.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Batch:
    users: torch.Tensor            # [B] int32
    items: torch.Tensor            # [B, G] int32 — candidates, col 0 positive
    cates: torch.Tensor            # [B, G] int32
    labels: torch.Tensor           # [B, G] float32
    item_hist: torch.Tensor        # [B, L] int32, left-aligned, 0-padded
    cate_hist: torch.Tensor        # [B, L] int32
    mask: torch.Tensor             # [B, L] float32 — 1 on valid steps
    time_diff: torch.Tensor        # [B, L] float32 (log-scaled, see parser)
    time_from_first: torch.Tensor  # [B, L] float32
    time_to_now: torch.Tensor      # [B, L] float32
    valid: torch.Tensor            # [B] float32 — 1 on real rows

    @classmethod
    def zeros(cls, B: int, G: int, L: int) -> "Batch":
        """An all-padding host batch of shape (B, G, L)."""
        i32, f32 = torch.int32, torch.float32
        return cls(
            users=torch.zeros(B, dtype=i32),
            items=torch.zeros(B, G, dtype=i32),
            cates=torch.zeros(B, G, dtype=i32),
            labels=torch.zeros(B, G, dtype=f32),
            item_hist=torch.zeros(B, L, dtype=i32),
            cate_hist=torch.zeros(B, L, dtype=i32),
            mask=torch.zeros(B, L, dtype=f32),
            time_diff=torch.zeros(B, L, dtype=f32),
            time_from_first=torch.zeros(B, L, dtype=f32),
            time_to_now=torch.zeros(B, L, dtype=f32),
            valid=torch.zeros(B, dtype=f32),
        )

    def to(self, device) -> "Batch":
        return Batch(**{f.name: getattr(self, f.name).to(device)
                        for f in dataclasses.fields(self)})
