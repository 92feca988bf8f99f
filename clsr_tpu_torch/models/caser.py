"""Caser: vertical and horizontal convolutions over the history matrices.

Counterpart of clsr_tpu/models/caser.py (reference caser.py:37-106), for
the item and the cate history each (`item_conv_*`, `cate_conv_*`):

  * the "vertical" conv runs over the embedding axis with the history
    positions as channels (caser.py:62-66): the [B, D, L] transpose under
    one window of D, so its kernel is [D, max_seq_length, n_v] and one
    product gives [B, n_v], then ReLU;
  * horizontal convs of heights 1..cfg.L (n_h filters each) over time,
    ReLU, each max-pooled over time (caser.py:67-74);
  * padding is not masked: the padded positions' rows enter both convs,
    as in the reference.

concat(item part, cate part) over the G candidates beside the target
[B, G, 2 (n_v + L n_h) + T] goes into the shared head.  The convs are
`ops/conv.py`'s matmuls.  A history shorter than max_seq_length does not
fit the vertical kernel: the forward raises, as the JAX model fails
there, and the config refuses length buckets for Caser.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.models.base import EmbedContext, SequentialModelBase
from clsr_tpu_torch.ops.conv import Conv1d


class CaserModel(SequentialModelBase):

    def __init__(self, cfg, n_users: int, n_items: int, n_cates: int,
                 device=None, generator=None):
        super().__init__(cfg, n_users, n_items, n_cates, device, generator)
        for scope, dim in (("item", cfg.item_embedding_dim),
                           ("cate", cfg.cate_embedding_dim)):
            self.add_module(f"{scope}_conv_v", Conv1d(
                cfg.max_seq_length, cfg.n_v, dim, self.generator,
                self.device))
            for h in range(1, cfg.L + 1):
                self.add_module(f"{scope}_conv_h{h}", Conv1d(
                    dim, cfg.n_h, h, self.generator, self.device))
        self.build_head()

    def head_in_dim(self) -> int:
        cfg = self.cfg
        return 2 * (cfg.n_v + cfg.L * cfg.n_h) + cfg.target_dim

    def _caser_cnn(self, hist: torch.Tensor, scope: str) -> torch.Tensor:
        """hist [B, L, D] -> [B, n_v + L n_h]."""
        if hist.shape[1] != self.cfg.max_seq_length:
            raise ValueError(
                f"Caser's vertical conv spans max_seq_length = "
                f"{self.cfg.max_seq_length} history positions; got a "
                f"history of {hist.shape[1]} (length buckets cut it)")
        out_v = F.relu(getattr(self, f"{scope}_conv_v")(
            hist.transpose(1, 2)))                          # [B, 1, n_v]
        outs = [out_v.reshape(out_v.shape[0], -1)]
        for h in range(1, self.cfg.L + 1):
            conv = getattr(self, f"{scope}_conv_h{h}")(hist)
            outs.append(F.relu(conv).amax(dim=1))
        return torch.cat(outs, dim=1)

    def seq_graph(self, ctx: EmbedContext, batch: Batch,
                  generator: Optional[torch.Generator] = None,
                  train_kernel: Optional[bool] = None,
                  compact: Optional[Dict[str, Any]] = None):
        B, G = batch.items.shape
        cnn = torch.cat([self._caser_cnn(ctx.item_hist_emb, "item"),
                         self._caser_cnn(ctx.cate_hist_emb, "cate")], 1)
        return torch.cat([cnn[:, None, :].expand(B, G, -1),
                          ctx.target_emb], dim=-1), {}
