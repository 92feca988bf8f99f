"""NCF: GMF and MLP towers over tables of their own, one bias-free head.

Counterpart of clsr_tpu/models/ncf.py (reference ncf.py:15-103): four
tables `user_gmf`, `user_mlp`, `item_gmf` and `item_mlp` `_embedding`,
all `user_embedding_dim` wide (the reference's quirk, ncf.py:33-43),
looked up through `lookup_rows` (so the sorted-sum gradient and the int8
serving tables apply to them); the GMF product, the `ncf_mlp_{i}` Dense
+ ReLU tower (glorot uniform, f32) over concat(user_mlp, item_mlp), and
the bias-free Dense `ncf_head` over concat(gmf, mlp) in place of the
shared `logit_fcn`.  The history is not read; the base class's item and
cate tables are still looked up, and give the lazy L2 as in JAX.  The
four tables get no lazy L2 (the reference never adds them) and, named
`*_embedding`, no layer L2; with no compact site spec, lazyadam takes
the legacy lazy path for NCF, as JAX does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.models.base import EmbedContext, SequentialModelBase
from clsr_tpu_torch.ops.initializers import tf1_glorot_uniform
from clsr_tpu_torch.ops.mlp import dense


class NCFModel(SequentialModelBase):

    def __init__(self, cfg, n_users: int, n_items: int, n_cates: int,
                 device=None, generator=None):
        super().__init__(cfg, n_users, n_items, n_cates, device, generator)
        d = cfg.user_embedding_dim
        self.user_gmf_embedding = self.new_table((n_users, d))
        self.user_mlp_embedding = self.new_table((n_users, d))
        self.item_gmf_embedding = self.new_table((n_items, d))
        self.item_mlp_embedding = self.new_table((n_items, d))
        width = 2 * d
        for idx, size in enumerate(cfg.ncf_layer_sizes):
            self.add_module(f"ncf_mlp_{idx}", dense(
                width, size, tf1_glorot_uniform, self.generator,
                self.device))
            width = size
        self.ncf_head = dense(d + width, 1, tf1_glorot_uniform,
                              self.generator, self.device, bias=False)

    def seq_graph(self, ctx: EmbedContext, batch: Batch,
                  generator: Optional[torch.Generator] = None,
                  train_kernel: Optional[bool] = None,
                  compact: Optional[Dict[str, Any]] = None):
        B, G = batch.items.shape
        u_gmf = self.lookup_rows("user_gmf_embedding", batch.users)
        u_mlp = self.lookup_rows("user_mlp_embedding", batch.users)
        i_gmf = self.lookup_rows("item_gmf_embedding", batch.items)
        i_mlp = self.lookup_rows("item_mlp_embedding", batch.items)
        gmf = u_gmf[:, None, :] * i_gmf                        # [B, G, d]
        mlp = torch.cat([u_mlp[:, None, :].expand(B, G, -1), i_mlp], -1)
        for idx in range(len(self.cfg.ncf_layer_sizes)):
            mlp = F.relu(getattr(self, f"ncf_mlp_{idx}")(mlp))
        return torch.cat([gmf, mlp], dim=-1), {}

    def head(self, model_output: torch.Tensor,
             generator: Optional[torch.Generator]) -> torch.Tensor:
        return self.ncf_head(model_output)[..., 0]
