"""DIN: target attention over the history beside the masked history sum.

Counterpart of clsr_tpu/models/din.py (reference din.py:16-34): the
target queries `attention_fcn` (ops/attention.py `TargetAttention`) over
concat(item, cate) history embeddings, so K1 scores it at eval with
G >= 8 and K3a + K3b + K1 in training under use_pallas_train_attention;
the history term is a masked SUM, not a mean.  concat(target, history
sum, attention) [B, G, 3T] goes into the shared head.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.models.base import EmbedContext, SequentialModelBase


def masked_sum(hist: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum over L of hist [B, L, D] at the real positions -> [B, D]."""
    return (hist * mask[..., None]).sum(1)


class DINModel(SequentialModelBase):

    def __init__(self, cfg, n_users: int, n_items: int, n_cates: int,
                 device=None, generator=None):
        super().__init__(cfg, n_users, n_items, n_cates, device, generator)
        T = cfg.target_dim
        self.attention_fcn = self.target_attention(T, T)
        self.build_head()

    def head_in_dim(self) -> int:
        return 3 * self.cfg.target_dim

    def seq_graph(self, ctx: EmbedContext, batch: Batch,
                  generator: Optional[torch.Generator] = None,
                  train_kernel: Optional[bool] = None,
                  compact: Optional[Dict[str, Any]] = None):
        B, G = batch.items.shape
        hist, mask = ctx.hist_input, batch.mask
        hist_sum = masked_sum(hist, mask)
        att_fea = self.attention_fcn(ctx.target_emb, hist, mask,
                                     train_kernel=train_kernel)  # [B, G, T]
        return torch.cat([ctx.target_emb,
                          hist_sum[:, None, :].expand(B, G, -1),
                          att_fea], dim=-1), {}
