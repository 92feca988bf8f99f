"""NextItNet: stacked dilated causal conv residual blocks over the history.

Counterpart of clsr_tpu/models/nextitnet.py (reference
nextitnet.py:21-225):

  * the history concat(item, cate) is right-aligned first
    (`right_align`; the reference's iterator pads in front,
    nextitnet_iterator.py:146-167);
  * one residual block `resblock_{i}_{d}` a dilation d of cfg.dilations:
    LN -> ReLU -> 1x1 conv (C/2) -> LN -> ReLU -> causal conv of
    cfg.kernel_size at dilation d (C/2) -> LN -> ReLU -> 1x1 conv (C) ->
    + input (nextitnet.py:104-156), the convs `ops/conv.py`'s with
    truncated_normal(0.02) kernels and zero biases;
  * `LayerNorm`: epsilon 1e-8 inside the sqrt, params `beta` / `gamma`
    (nextitnet.py:203-225);
  * 2-D targets read the last position: concat(last, target)
    [B, G, 2C]; per-position targets ([B, G, L], training under
    cfg.nextitnet_per_position, training/negative_sampling.py
    `expand_nextitnet`) read every position: [B, G, L, 2C], and the
    shared head gives [B, G, L] logits.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.models.base import EmbedContext, SequentialModelBase
from clsr_tpu_torch.ops.conv import Conv1d
from clsr_tpu_torch.ops.initializers import (new_param, ones_init,
                                             truncated_normal, zeros_init)


def right_align(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Shift each row's valid prefix to the end: [v1..vn 0..0] ->
    [0..0 v1..vn], for x [B, L, ...] and a prefix mask [B, L].  Row b
    is rolled by L - n_b, a permutation of its positions, so the
    gather's gradient writes each position once (no sum to order), and
    the rolled-in front is zeroed."""
    B, L = mask.shape
    shift = L - mask.sum(1).to(torch.int64)                    # [B]
    t = torch.arange(L, device=x.device)[None, :]
    src = torch.remainder(t - shift[:, None], L)               # [B, L]
    keep = t >= shift[:, None]
    tail = (1,) * (x.dim() - 2)
    rolled = torch.take_along_dim(
        x, src.reshape(B, L, *tail).expand_as(x), dim=1)
    return torch.where(keep.reshape(B, L, *tail), rolled,
                       torch.zeros_like(rolled))


class LayerNorm(nn.Module):
    """tf.contrib-style LN over the last axis, epsilon inside the sqrt."""

    def __init__(self, features: int, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.beta = new_param((features,), zeros_init, generator, device)
        self.gamma = new_param((features,), ones_init, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = torch.square(x - mean).mean(-1, keepdim=True)
        return self.gamma * (x - mean) / torch.sqrt(var + 1e-8) + self.beta


class NextItNetModel(SequentialModelBase):

    def __init__(self, cfg, n_users: int, n_items: int, n_cates: int,
                 device=None, generator=None):
        super().__init__(cfg, n_users, n_items, n_cates, device, generator)
        C = cfg.target_dim
        for layer_id, d in enumerate(cfg.dilations):
            name = f"resblock_{layer_id}_{d}"
            for ln, width in (("ln1", C), ("ln2", C // 2), ("ln3", C // 2)):
                self.add_module(f"{name}_{ln}", LayerNorm(
                    width, self.generator, self.device))
            for conv, cin, cout, k, dil, pad in (
                    ("conv1", C, C // 2, 1, 1, "SAME"),
                    ("dilated", C // 2, C // 2, cfg.kernel_size, d,
                     "CAUSAL"),
                    ("conv2", C // 2, C, 1, 1, "SAME")):
                self.add_module(f"{name}_{conv}", Conv1d(
                    cin, cout, k, self.generator, self.device, dilation=dil,
                    padding=pad, kernel_init=truncated_normal(0.02)))
        self.build_head()

    def head_in_dim(self) -> int:
        return 2 * self.cfg.target_dim

    def _residual_block(self, x: torch.Tensor, name: str) -> torch.Tensor:
        h = x
        for ln, conv in (("ln1", "conv1"), ("ln2", "dilated"),
                         ("ln3", "conv2")):
            h = F.relu(getattr(self, f"{name}_{ln}")(h))
            h = getattr(self, f"{name}_{conv}")(h)
        return x + h

    def seq_graph(self, ctx: EmbedContext, batch: Batch,
                  generator: Optional[torch.Generator] = None,
                  train_kernel: Optional[bool] = None,
                  compact: Optional[Dict[str, Any]] = None):
        hist = right_align(ctx.hist_input, batch.mask)
        for layer_id, d in enumerate(self.cfg.dilations):
            hist = self._residual_block(hist, f"resblock_{layer_id}_{d}")
        if batch.items.dim() == 3:
            # per-position training: every time step is an instance
            B, G, L = batch.items.shape
            return torch.cat([hist[:, None].expand(B, G, L, -1),
                              ctx.target_emb], dim=-1), {}
        B, G = batch.items.shape
        last = hist[:, -1, :]                         # the last real event
        return torch.cat([last[:, None, :].expand(B, G, -1),
                          ctx.target_emb], dim=-1), {}
