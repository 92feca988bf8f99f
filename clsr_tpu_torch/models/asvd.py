"""A2SVD: the soft-attention pooled history beside the target.

Counterpart of clsr_tpu/models/asvd.py (reference asvd.py:27-45):
`attention_layer` (ops/attention.py `SoftAttention`, no mask: the
reference's quirk) weights the concat(item, cate) history, its sum over
L [B, T] goes beside the target into the shared head (with
`user_dropout` and dropout [0.3, 0.3] in asvd.yaml).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.models.base import EmbedContext, SequentialModelBase
from clsr_tpu_torch.ops.attention import SoftAttention


class A2SVDModel(SequentialModelBase):

    def __init__(self, cfg, n_users: int, n_items: int, n_cates: int,
                 device=None, generator=None):
        super().__init__(cfg, n_users, n_items, n_cates, device, generator)
        self.attention_layer = SoftAttention(
            cfg.target_dim, cfg.attention_size, self.init, self.generator,
            self.device)
        self.build_head()

    def head_in_dim(self) -> int:
        return 2 * self.cfg.target_dim

    def seq_graph(self, ctx: EmbedContext, batch: Batch,
                  generator: Optional[torch.Generator] = None,
                  train_kernel: Optional[bool] = None,
                  compact: Optional[Dict[str, Any]] = None):
        B, G = batch.items.shape
        pooled = self.attention_layer(ctx.hist_input).sum(1)       # [B, T]
        return torch.cat([pooled[:, None, :].expand(B, G, -1),
                          ctx.target_emb], dim=-1), {}
