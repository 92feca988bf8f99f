"""GRU4Rec: a GRU over the history, its final state beside the target.

Counterpart of clsr_tpu/models/gru4rec.py (reference gru4rec.py:21-76):
the GRU `gru` (no compute dtype, as in JAX) runs over concat(item, cate)
history embeddings, and concat(final state, target) [B, G, H + T] goes
into the shared head.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.models.base import EmbedContext, SequentialModelBase
from clsr_tpu_torch.ops.rnn import GRU


class GRU4RecModel(SequentialModelBase):

    def __init__(self, cfg, n_users: int, n_items: int, n_cates: int,
                 device=None, generator=None):
        super().__init__(cfg, n_users, n_items, n_cates, device, generator)
        self.gru = GRU(cfg.target_dim, cfg.hidden_size, self.generator,
                       self.device)
        self.build_head()

    def head_in_dim(self) -> int:
        return self.cfg.hidden_size + self.cfg.target_dim

    def seq_graph(self, ctx: EmbedContext, batch: Batch,
                  generator: Optional[torch.Generator] = None,
                  train_kernel: Optional[bool] = None,
                  compact: Optional[Dict[str, Any]] = None):
        B, G = batch.items.shape
        _, final = self.gru(ctx.hist_input, batch.mask)
        return torch.cat([final[:, None, :].expand(B, G, -1),
                          ctx.target_emb], dim=-1), {}
