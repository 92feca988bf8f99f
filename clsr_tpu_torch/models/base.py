"""Shared sequential-model machinery, eval mode.

Counterpart of clsr_tpu/models/base.py:150-256 (the reference's
SequentialBaseModel, sequential_base_model.py:18-461):

  * item/cate embedding tables and the history/target lookups
    (sequential_base_model.py:354-452);
  * `target_emb = concat(item, cate)` over the G candidates of a row
    ([B, G, item_dim + cate_dim]), the grouped-target layout;
  * the shared logit head `logit_fcn` (sequential_base_model.py:72).

Subclasses implement `seq_graph(ctx, batch) -> (model_output, aux)`
with model_output [B, G, D].  Eval mode only: dropout is the identity
there, and the lazy-L2 bookkeeping, unique-row statistics and compact
rows feed training losses, which wait for the training slice.  int8
tables and a device mesh raise.
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
from clsr_tpu_torch.ops.mlp import FcnNet
from clsr_tpu_torch.utils.device import resolve_device


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
            self.generator, self.device, enable_bn=cfg.enable_bn, out_dim=1)

    def forward(self, batch: Batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        if self.training:
            raise NotImplementedError(
                "the train-mode forward waits for the training slice "
                "(ROADMAP queue 1); call model.eval()")
        ctx = EmbedContext(
            item_hist_emb=F.embedding(batch.item_hist, self.item_embedding),
            cate_hist_emb=F.embedding(batch.cate_hist, self.cate_embedding),
            target_emb=torch.cat(
                [F.embedding(batch.items, self.item_embedding),
                 F.embedding(batch.cates, self.cate_embedding)], dim=-1),
        )
        model_output, aux = self.seq_graph(ctx, batch)
        logits = self.logit_fcn(model_output)[..., 0]           # [B, G]
        return logits, aux

    def seq_graph(self, ctx: EmbedContext, batch: Batch):
        raise NotImplementedError
