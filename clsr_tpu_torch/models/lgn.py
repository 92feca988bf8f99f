"""LGN: LightGCN-style graph-convolved user and item embeddings, scored
by a dot product.

Counterpart of clsr_tpu/models/lgn.py (reference lgn.py:31-556), which
overrides the base forward: no history encoder, no head.

  * item node = concat(item row, cate row of item2cate[item])
    (lgn.py:50-59); ego = concat(user table, item nodes);
  * n_layers rounds of ego <- leaky_relu((D^-1 (A + I)) ego W_k + b_k)
    (slope 0.01), `W_gc_{k}` / `b_gc_{k}` ~ N(0, 0.01); the final
    embedding is the mean over [ego_0 .. ego_n] (lgn.py:107-132);
  * logits = dot(user row, item row) [B, G];
  * lazy L2 on the GCN-OUTPUT item rows the batch involves plus the raw
    cate rows (the reference regularizes the rewritten table,
    lgn.py:46-72); users are never regularized; attn_labels as the base.

The graph comes from data/graph.py (the CLI builds it from the train
file) and lives on the model's device as ops/graph_conv.py `GraphEdges`,
outside the state_dict.  Every sum of the forward and of its gradient
runs in a fixed order: the propagation through ops/graph_conv.py, the
item -> cate gather and the batch's rows through `segment_sum.lookup`,
so two steps from one state give the same bits and the step can be
captured.  The whole graph is recomputed every step and every eval call,
as in JAX.  Requires user_embedding_dim == item_embedding_dim +
cate_embedding_dim.  Only the dense optimizer rules apply (the config
refuses lazyadam).

On a (data, model) mesh (parallel/mesh.py; JAX's GSPMD gathers the
row-sharded tables for its one `segment_sum`) every rank holds the whole
graph (`GraphEdges`, built on each rank from the same edges) and
propagates over the whole tables: `gcn` first all_gathers each
row-sharded table block over the model row, in rank order, into the
logical table (parallel/mesh.py `logical_table`), and the backward
hands each rank its block of the table gradient.  So every rank of a
step runs the one-rank propagation; the batch's rows, the losses and the
lazy L2's globally unique ids are the mesh's as for every model.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.data.graph import InteractionGraph
from clsr_tpu_torch.models.base import (SequentialModelBase,
                                        supervised_attn_labels,
                                        unique_rows_sumsq)
from clsr_tpu_torch.ops.graph_conv import GraphEdges, propagate
from clsr_tpu_torch.ops.initializers import normal
from clsr_tpu_torch.ops.segment_sum import lookup
from clsr_tpu_torch.parallel.mesh import active_mesh, logical_table


class LGNModel(SequentialModelBase):

    reads_whole_tables = True     # the propagation reaches every row

    def __init__(self, cfg, n_users: int, n_items: int, n_cates: int,
                 device=None, generator=None,
                 graph: Optional[InteractionGraph] = None):
        super().__init__(cfg, n_users, n_items, n_cates, device, generator)
        node_dim = cfg.target_dim
        if cfg.user_embedding_dim != node_dim:
            raise ValueError("LGN needs user_embedding_dim == item+cate dim")
        if graph is None:
            raise ValueError(
                "LGN needs the interaction graph of its train set "
                "(data/graph.py build_interaction_graph; the CLI builds "
                "it from the train file)")
        if (graph.n_users, graph.n_items) != (n_users, n_items):
            raise ValueError(
                f"the graph has {graph.n_users} users and {graph.n_items} "
                f"items, the model {n_users} and {n_items}")
        self.user_embedding = self.new_param((n_users, node_dim))
        for k in range(cfg.n_layers):
            setattr(self, f"W_gc_{k}", self.new_param(
                (node_dim, node_dim), normal(0.01)))
            setattr(self, f"b_gc_{k}", self.new_param((node_dim,),
                                                      normal(0.01)))
        self.edges = GraphEdges.build(graph.n_nodes, graph.src, graph.dst,
                                      graph.weight, self.device)
        self.item2cate = torch.from_numpy(graph.item2cate).to(self.device)

    def gcn(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(GCN users [U, D], GCN items [I, D]) over the whole graph; on a
        mesh from the logical tables."""
        mesh = active_mesh()

        def whole(table):
            if mesh is None or getattr(table, "mesh_rows", None) is None:
                return table
            return logical_table(table, mesh)

        item_nodes = torch.cat([whole(self.item_embedding),
                                lookup(whole(self.cate_embedding),
                                       self.item2cate)], dim=1)
        ego = torch.cat([whole(self.user_embedding), item_nodes], dim=0)
        layers = [ego]
        for k in range(self.cfg.n_layers):
            side = propagate(ego, self.edges)
            ego = F.leaky_relu(side @ getattr(self, f"W_gc_{k}")
                               + getattr(self, f"b_gc_{k}"), 0.01)
            layers.append(ego)
        final = torch.stack(layers, dim=1).mean(dim=1)
        return final[:self.n_users], final[self.n_users:]

    def forward(self, batch: Batch,
                generator: Optional[torch.Generator] = None,
                train_kernel: Optional[bool] = None,
                compact: Optional[Dict[str, Any]] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Logits [B, G] and, in train mode, the losses' aux."""
        gcn_users, gcn_items = self.gcn()
        user_emb = lookup(gcn_users, batch.users)              # [B, D]
        item_emb = lookup(gcn_items, batch.items)              # [B, G, D]
        logits = torch.einsum("bd,bgd->bg", user_emb, item_emb)
        if not self.training:
            return logits, {}
        involved_items = torch.cat([batch.item_hist.reshape(-1),
                                    batch.items.reshape(-1)])
        involved_cates = torch.cat([batch.cate_hist.reshape(-1),
                                    batch.cates.reshape(-1)])
        aux = {"embed_sumsq": (
            unique_rows_sumsq(gcn_items, involved_items)
            + unique_rows_sumsq(self.cate_embedding, involved_cates))}
        attn_labels = supervised_attn_labels(batch)
        if attn_labels is not None:
            aux["attn_labels"] = attn_labels
        return logits, aux
