"""DIEN: interest extraction GRU, target attention weights, and an
attention-modulated second GRU.

Counterpart of clsr_tpu/models/dien.py (reference dien.py:21-64):
`gru1` over concat(item, cate) history embeddings; `attention_fcn`
scores its outputs against the G targets and returns its weights (the
plain scorer: no kernel returns weights); `gru2` (`VecAttGRU`) runs G
score streams over one input projection, a [B, G, H] carry.  dien.yaml's
activations are [dice, dice], for the scorer and the head alike, so a
served score depends on the other rows of its dispatch, padding
included, as in JAX.  concat(target, final state, history sum,
target * history sum) [B, G, 3T + H] goes into the shared head.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.models.base import EmbedContext, SequentialModelBase
from clsr_tpu_torch.models.din import masked_sum
from clsr_tpu_torch.ops.rnn import GRU, VecAttGRU


class DIENModel(SequentialModelBase):

    def __init__(self, cfg, n_users: int, n_items: int, n_cates: int,
                 device=None, generator=None):
        super().__init__(cfg, n_users, n_items, n_cates, device, generator)
        T, H = cfg.target_dim, cfg.hidden_size
        self.gru1 = GRU(T, H, self.generator, self.device)
        self.attention_fcn = self.target_attention(T, H)
        self.gru2 = VecAttGRU(H, H, self.generator, self.device)
        self.build_head()

    def head_in_dim(self) -> int:
        return 3 * self.cfg.target_dim + self.cfg.hidden_size

    def seq_graph(self, ctx: EmbedContext, batch: Batch,
                  generator: Optional[torch.Generator] = None,
                  train_kernel: Optional[bool] = None,
                  compact: Optional[Dict[str, Any]] = None):
        B, G = batch.items.shape
        hist, mask = ctx.hist_input, batch.mask
        sum_g = masked_sum(hist, mask)[:, None, :].expand(B, G, -1)
        rnn_outputs, _ = self.gru1(hist, mask)
        _, alphas = self.attention_fcn(ctx.target_emb, rnn_outputs, mask,
                                       return_weights=True)    # [B, G, L]
        _, final = self.gru2(rnn_outputs, alphas, mask)         # [B, G, H]
        return torch.cat([ctx.target_emb, final, sum_g,
                          ctx.target_emb * sum_g], dim=-1), {}
