"""Shared sequential-model machinery, eval and train mode.

Counterpart of clsr_tpu/models/base.py:99-256 (the reference's
SequentialBaseModel, sequential_base_model.py:18-461):

  * item/cate embedding tables and the history/target lookups
    (sequential_base_model.py:354-452), with embedding dropout in train
    mode (:440-452; masks from the generator passed to `forward`);
  * `target_emb = concat(item, cate)` over the G candidates of a row
    ([B, G, item_dim + cate_dim]), the grouped-target layout;
  * the shared logit head `logit_fcn` (sequential_base_model.py:72);
  * in train mode, the lazy L2 bookkeeping over the UNIQUE rows a batch
    touches (`unique_rows_sumsq`, `unique_rows_stats`: sort, keep the
    first occurrence; :409-433, clsr.py:73-82, 118-127), taken on the raw
    rows before dropout, and the supervised-attention label
    `attn_labels` (sequential_iterator.py:619,682).

Subclasses implement `seq_graph(ctx, batch, train_kernel)` ->
(model_output [B, G, D], aux).  Lookups are dense (`F.embedding`), so a
table's gradient is dense, as `jax.grad` over the full table is.  Compact
rows, int8 tables and a device mesh raise or wait for their ROADMAP
items.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from clsr_tpu_torch.config import Config
from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.ops.initializers import get_initializer, new_param
from clsr_tpu_torch.ops.mlp import FcnNet, dropout
from clsr_tpu_torch.utils.device import resolve_device


def _first_occurrence(ids: torch.Tensor):
    """(sorted flat ids, mask of each id's first occurrence)."""
    flat = torch.sort(ids.reshape(-1)).values
    first = torch.ones_like(flat, dtype=torch.bool)
    first[1:] = flat[1:] != flat[:-1]
    return flat, first


def unique_rows_sumsq(table: torch.Tensor, ids: torch.Tensor
                      ) -> torch.Tensor:
    """sum(||table[id]||^2) over the UNIQUE ids (models/base.py:99-110)."""
    flat, first = _first_occurrence(ids)
    rows = F.embedding(flat, table)
    return ((rows * rows).sum(-1) * first).sum()


def unique_rows_stats(table_a: torch.Tensor, table_b: torch.Tensor,
                      ids: torch.Tensor):
    """(sumsq_a, sumsq_b, sum((a-b)^2), n_unique*dim) over unique ids
    (models/base.py:113-131)."""
    flat, first = _first_occurrence(ids)
    ra, rb = F.embedding(flat, table_a), F.embedding(flat, table_b)
    fa = first[:, None].to(ra.dtype)
    diff = ra - rb
    return ((ra * ra * fa).sum(), (rb * rb * fa).sum(),
            (diff * diff * fa).sum(), first.sum() * table_a.shape[1])


@dataclasses.dataclass
class EmbedContext:
    """Looked-up embeddings handed to seq_graph."""

    item_hist_emb: torch.Tensor     # [B, L, item_dim]
    cate_hist_emb: torch.Tensor     # [B, L, cate_dim]
    target_emb: torch.Tensor        # [B, G, item_dim + cate_dim]

    @property
    def hist_input(self) -> torch.Tensor:
        """concat(item_hist, cate_hist) per clsr.py:145-147."""
        return torch.cat([self.item_hist_emb, self.cate_hist_emb], -1)


def check_supported(cfg: Config) -> None:
    """Raise on settings the port does not run yet, naming the ROADMAP
    item that brings them."""
    if cfg.data_parallel * cfg.model_parallel > 1:
        raise NotImplementedError(
            "a device mesh (data_parallel*model_parallel > 1) waits for "
            "ROADMAP queue 1, int8 and mesh serving")
    if cfg.embedding_dtype != "float32" or cfg.compute_dtype not in (
            "float32", "f32"):
        raise NotImplementedError(
            "bf16 tables or compute wait for ROADMAP queue 1, mixed "
            "precision")
    if cfg.attention_block_size > 0:
        raise NotImplementedError(
            "blockwise long-context attention waits for ROADMAP queue 1, "
            "long context")


class SequentialModelBase(nn.Module):
    """Embeddings + lookups + head.  Subclasses define seq_graph."""

    def __init__(self, cfg: Config, n_users: int, n_items: int,
                 n_cates: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.n_users, self.n_items, self.n_cates = n_users, n_items, n_cates
        self.device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(cfg.seed if cfg.seed is not None else 0)
        self.generator = generator
        self.init = get_initializer(cfg.init_method, cfg.init_value)
        self.item_embedding = self.new_param(
            (n_items, cfg.item_embedding_dim))
        self.cate_embedding = self.new_param(
            (n_cates, cfg.cate_embedding_dim))

    def new_param(self, shape, init=None) -> nn.Parameter:
        return new_param(shape, init or self.init, self.generator,
                         self.device)

    def head_in_dim(self) -> int:
        raise NotImplementedError

    def build_head(self) -> None:
        """The shared logit head (sequential_base_model.py:72); call at
        the end of the subclass constructor, as flax creates it last."""
        cfg = self.cfg
        self.logit_fcn = FcnNet(
            self.head_in_dim(), cfg.layer_sizes, cfg.activation, self.init,
            self.generator, self.device, enable_bn=cfg.enable_bn, out_dim=1,
            dropout_rates=cfg.dropout if cfg.user_dropout else None)

    def dropout(self, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """Embedding dropout, train mode only."""
        if not self.training:
            return x
        return dropout(x, self.cfg.embedding_dropout, generator)

    def forward(self, batch: Batch,
                generator: Optional[torch.Generator] = None,
                train_kernel: Optional[bool] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Logits [B, G] and the aux dict the losses read.  In train mode
        `generator` draws the dropout masks, and `train_kernel`, when
        given, overrides cfg.use_pallas_train_attention."""
        item_hist_emb = F.embedding(batch.item_hist, self.item_embedding)
        cate_hist_emb = F.embedding(batch.cate_hist, self.cate_embedding)
        target_emb = torch.cat(
            [F.embedding(batch.items, self.item_embedding),
             F.embedding(batch.cates, self.cate_embedding)], dim=-1)
        if self.training:
            # lazy L2 bookkeeping BEFORE dropout, on raw table rows
            involved_items = torch.cat([batch.item_hist.reshape(-1),
                                        batch.items.reshape(-1)])
            involved_cates = torch.cat([batch.cate_hist.reshape(-1),
                                        batch.cates.reshape(-1)])
            embed_sumsq = (
                unique_rows_sumsq(self.item_embedding, involved_items)
                + unique_rows_sumsq(self.cate_embedding, involved_cates))
            # fraction of the history sharing the target's category
            denom = batch.mask.sum(-1).clamp_min(1.0)
            same_cate = batch.cate_hist[:, None, :] == batch.cates[:, :, None]
            attn_labels = ((same_cate * batch.mask[:, None, :]).sum(-1)
                           / denom[:, None])
        ctx = EmbedContext(
            item_hist_emb=self.dropout(item_hist_emb, generator),
            cate_hist_emb=self.dropout(cate_hist_emb, generator),
            target_emb=self.dropout(target_emb, generator),
        )
        model_output, aux = self.seq_graph(ctx, batch, generator,
                                           train_kernel)
        logits = self.logit_fcn(model_output,
                                generator=generator)[..., 0]    # [B, G]
        if self.training:
            aux = dict(aux, attn_labels=attn_labels,
                       embed_sumsq=aux.get("embed_sumsq", 0.0) + embed_sumsq)
        return logits, aux

    def seq_graph(self, ctx: EmbedContext, batch: Batch,
                  generator: Optional[torch.Generator],
                  train_kernel: Optional[bool]):
        raise NotImplementedError
