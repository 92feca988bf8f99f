"""SLI-Rec: soft-attention long term, Time4LSTM + target attention short
term, fused by a learned alpha (CLSR's closest ancestor).

Counterpart of clsr_tpu/models/sli_rec.py (reference sli_rec.py:25-147):
  * long term: `long_term_asvd` (`SoftAttention`, no mask) over the
    concat(item, cate) history, summed over L -> [B, T];
  * short term: `time4lstm` over the ITEM embeddings only (+ the two
    time features, sli_rec.py:44-58), then `attention_fcn` with the
    target as query (K1 at eval with G >= 8, K3a + K3b + K1 in training
    under use_pallas_train_attention) -> [B, G, H];
  * fusion: `fcn_alpha` over [target, long, short, the LAST column of
    time_to_now] -> sigmoid alpha, user = alpha long + (1 - alpha)
    short, or the fixed manual_alpha_value; aux "alpha";
  * concat(user, target) into the shared head.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.models.base import EmbedContext, SequentialModelBase
from clsr_tpu_torch.ops.attention import SoftAttention
from clsr_tpu_torch.ops.mlp import FcnNet
from clsr_tpu_torch.ops.rnn import Time4LSTM


class SLIRecModel(SequentialModelBase):

    def __init__(self, cfg, n_users: int, n_items: int, n_cates: int,
                 device=None, generator=None):
        super().__init__(cfg, n_users, n_items, n_cates, device, generator)
        T, H = cfg.target_dim, cfg.hidden_size
        self.long_term_asvd = SoftAttention(T, cfg.attention_size,
                                            self.init, self.generator,
                                            self.device)
        self.time4lstm = Time4LSTM(cfg.item_embedding_dim, H,
                                   self.generator, self.device)
        self.attention_fcn = self.target_attention(T, H)
        if not cfg.manual_alpha:
            self.fcn_alpha = FcnNet(
                T + T + H + 1, cfg.att_fcn_layer_sizes, cfg.activation,
                self.init, self.generator, self.device,
                enable_bn=cfg.enable_bn, out_dim=1, dtype=self.dtype)
        self.build_head()

    def head_in_dim(self) -> int:
        return 2 * self.cfg.target_dim

    def seq_graph(self, ctx: EmbedContext, batch: Batch,
                  generator: Optional[torch.Generator] = None,
                  train_kernel: Optional[bool] = None,
                  compact: Optional[Dict[str, Any]] = None):
        cfg = self.cfg
        B, G = batch.items.shape
        hist, mask = ctx.hist_input, batch.mask
        fea1 = self.long_term_asvd(hist).sum(1)                  # [B, T]
        rnn_outputs, _ = self.time4lstm(ctx.item_hist_emb,
                                        batch.time_from_first,
                                        batch.time_to_now, mask)
        att_fea2 = self.attention_fcn(ctx.target_emb, rnn_outputs, mask,
                                      train_kernel=train_kernel)  # [B, G, H]
        fea1_g = fea1[:, None, :].expand(B, G, -1)
        if not cfg.manual_alpha:
            last_time = batch.time_to_now[:, -1][:, None, None].expand(
                B, G, 1)
            alpha = torch.sigmoid(self.fcn_alpha(torch.cat(
                [ctx.target_emb, fea1_g, att_fea2, last_time], dim=-1)))
            user_embed = fea1_g * alpha + att_fea2 * (1.0 - alpha)
            alpha_out = alpha[..., 0]
        else:
            a = cfg.manual_alpha_value
            user_embed = fea1_g * a + att_fea2 * (1.0 - a)
            alpha_out = torch.full((B, G), a, dtype=hist.dtype,
                                   device=hist.device)
        return (torch.cat([user_embed, ctx.target_emb], dim=-1),
                {"alpha": alpha_out})
