"""CLSR: disentangled long/short-term interest model.

Counterpart of clsr_tpu/models/clsr.py:53-221 (the reference CLSRModel,
clsr.py:20-455):

  * per-user LONG and SHORT interest tables besides item/cate
    (clsr.py:84-101);
  * long-term attention with query = user_long_embedding (G = 1, the
    plain path, clsr.py:152-155);
  * the fused encoder: interest-evolve GRU from user_short, Time4LSTM
    over the history, and the "causal2" GRU (clsr.py:160-216, 230);
  * short-term attention with query concat(short_term_intention,
    target) over the Time4LSTM outputs (G >= 8 -> kernel K1,
    clsr.py:219-221);
  * fusion: causal2 state + target + both interests + the LAST column
    of time_to_now (the padded column L-1, 0 unless the history fills
    max_seq_length; clsr.py:239-248, kept verbatim) -> fcn_alpha ->
    sigmoid alpha, user_embed = alpha*long + (1-alpha)*short, or the
    fixed manual_alpha_value (clsr.py:261-274);
  * output concat(user_embed, target) -> logit head (clsr.py:275);
  * in train mode, dropout on the user rows and the aux the losses read
    (clsr.py:22-82): both interests, the masked history mean, the mean
    of the last contrastive_recent_k valid positions (reverse cumsum,
    clsr.py:173-177), seq_len, and the involved users' L2 and
    discrepancy sums over unique rows.

Only the fused time4lstm encoder is ported; the unfused GRU/LSTM
encoders (ops/rnn.py) wait for the model zoo slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.models.base import (EmbedContext, SequentialModelBase,
                                        unique_rows_stats)
from clsr_tpu_torch.ops.attention import TargetAttention
from clsr_tpu_torch.ops.fused_clsr import FusedCLSREncoder
from clsr_tpu_torch.ops.mlp import FcnNet


class CLSRModel(SequentialModelBase):

    def __init__(self, cfg, n_users: int, n_items: int, n_cates: int,
                 device=None, generator=None):
        super().__init__(cfg, n_users, n_items, n_cates, device, generator)
        if not (cfg.use_fused_encoders and cfg.sequential_model == "time4lstm"):
            raise NotImplementedError(
                "only the fused time4lstm encoder is ported; the unfused "
                "GRU/LSTM encoders wait for ROADMAP queue 1, model zoo")
        U, H, T = cfg.user_embedding_dim, cfg.hidden_size, cfg.target_dim
        self.user_long_embedding = self.new_param((n_users, U))
        self.user_short_embedding = self.new_param((n_users, U))

        def attention(query_dim, key_dim):
            return TargetAttention(
                query_dim, key_dim, cfg.att_fcn_layer_sizes, cfg.activation,
                self.init, self.generator, self.device,
                enable_bn=cfg.enable_bn,
                use_kernel=cfg.use_pallas_eval_attention,
                use_train_kernel=cfg.use_pallas_train_attention)

        # creation order follows the flax tree (long, encoder, short, ...)
        self.long_term_att = attention(U, T)
        self.fused_encoders = FusedCLSREncoder(
            T, U, H, self.generator, self.device,
            interest_evolve=cfg.interest_evolve,
            predict_long_short=cfg.predict_long_short,
            use_pallas=cfg.use_pallas_scan)
        self.short_term_att = attention(U + T, H)
        if not cfg.manual_alpha:
            fusion_in = ((H if cfg.predict_long_short else 0)
                         + T + T + H + 1)
            self.fcn_alpha = FcnNet(
                fusion_in, cfg.att_fcn_layer_sizes, cfg.activation,
                self.init, self.generator, self.device,
                enable_bn=cfg.enable_bn, out_dim=1)
        self.build_head()

    def head_in_dim(self) -> int:
        return self.cfg.hidden_size + self.cfg.target_dim

    def seq_graph(self, ctx: EmbedContext, batch: Batch,
                  generator: Optional[torch.Generator] = None,
                  train_kernel: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        cfg = self.cfg
        B, G = batch.items.shape
        user_long = self.dropout(
            F.embedding(batch.users, self.user_long_embedding), generator)
        user_short = self.dropout(
            F.embedding(batch.users, self.user_short_embedding), generator)
        hist = ctx.hist_input                                   # [B, L, T]
        mask = batch.mask

        # ---- long term (clsr.py:152-157) --------------------------------
        att_fea_long = self.long_term_att(
            user_long, hist, mask, train_kernel=train_kernel)   # [B, T]

        # ---- short term (clsr.py:159-222) -------------------------------
        h1, rnn_outputs, causal2_state = self.fused_encoders(
            hist, batch.time_from_first, batch.time_to_now, mask,
            user_short)
        short_term_intention = h1 if cfg.interest_evolve else user_short
        short_query = torch.cat(
            [short_term_intention[:, None, :].expand(B, G, -1),
             ctx.target_emb], dim=-1)                           # [B, G, U+T]
        att_fea_short = self.short_term_att(
            short_query, rnn_outputs, mask,
            train_kernel=train_kernel)                          # [B, G, H]

        # ---- fusion (clsr.py:225-274) -----------------------------------
        long_g = att_fea_long[:, None, :].expand(B, G, -1)
        if not cfg.manual_alpha:
            parts = []
            if cfg.predict_long_short:
                parts.append(causal2_state[:, None, :].expand(B, G, -1))
            last_time = batch.time_to_now[:, -1][:, None, None].expand(
                B, G, 1)
            parts += [ctx.target_emb, long_g, att_fea_short, last_time]
            alpha = torch.sigmoid(self.fcn_alpha(torch.cat(parts, dim=-1)))
            user_embed = long_g * alpha + att_fea_short * (1.0 - alpha)
            alpha_out = alpha[..., 0]
        else:
            a = cfg.manual_alpha_value
            user_embed = long_g * a + att_fea_short * (1.0 - a)
            alpha_out = torch.full((B, G), a, dtype=hist.dtype,
                                   device=hist.device)

        model_output = torch.cat([user_embed, ctx.target_emb], dim=-1)
        aux: Dict[str, Any] = {"alpha": alpha_out}
        if self.training:
            aux.update(self.train_aux(batch, hist, att_fea_long,
                                      att_fea_short))
        return model_output, aux

    def train_aux(self, batch: Batch, hist: torch.Tensor,
                  att_fea_long: torch.Tensor, att_fea_short: torch.Tensor
                  ) -> Dict[str, Any]:
        """What the contrastive, discrepancy and L2 losses read
        (clsr_tpu/models/clsr.py:91-123, 210-220)."""
        mask = batch.mask
        hist_mean = ((hist * mask[..., None]).sum(1)
                     / mask.sum(1, keepdim=True).clamp_min(1.0))
        # recent-k proxy via reverse cumsum (clsr.py:173-177)
        position = torch.flip(torch.cumsum(torch.flip(mask, [1]), 1), [1])
        recent = ((position >= 1)
                  & (position <= self.cfg.contrastive_recent_k)).to(
                      hist.dtype)
        hist_recent = ((hist * recent[..., None]).sum(1)
                       / recent.sum(1, keepdim=True).clamp_min(1.0))
        # involved-user L2 + discrepancy (clsr.py:73-82, 118-127)
        sumsq_l, sumsq_s, sumsq_diff, n_elems = unique_rows_stats(
            self.user_long_embedding, self.user_short_embedding,
            batch.users)
        return {
            "att_fea_long": att_fea_long,           # [B, T]
            "att_fea_short": att_fea_short,         # [B, G, H]
            "hist_mean": hist_mean,                 # [B, T]
            "hist_recent": hist_recent,             # [B, T]
            "seq_len": mask.sum(-1),                # [B]
            "embed_sumsq": sumsq_l + sumsq_s,
            "discrepancy_sumsq": sumsq_diff,
            "discrepancy_count": n_elems,
        }
