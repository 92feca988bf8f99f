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

Subclasses implement `seq_graph(ctx, batch, generator, train_kernel,
compact)` -> (model_output [B, G, D], aux); a model with a head of its
own overrides `head` (NCF), and LGN overrides `forward`.  Per-position
targets ([B, G, L] items and cates, NextItNet's training) give
[B, G, L, D] model outputs and [B, G, L] logits, and no attn_labels.

Lookups are dense, so a table's gradient is dense, as `jax.grad` over
the full table is; in train mode they go through
`ops.segment_sum.lookup` (`embed`), whose gradient sums a repeated row
in sorted order, the same bits on every call (`F.embedding`'s backward
on the card does not), and eval keeps `F.embedding`.  Under the compact
row engine (training/compact_rows.py, `compact` = {table name:
CompactRows}, JAX models/base.py:177-190) the lookups are the gathered
rows' sites and the lazy L2 comes from them: no table `Parameter` is
read.

Precision (JAX :51-97): under `embedding_dtype: bfloat16` the tables are
bf16 (drawn in f32 from the generator, then rounded), and every lookup
is upcast to f32 right after the gather (`lookup_cast`), so the
gradient a table gets is bf16, each cotangent row rounded, as JAX's is.
`compute_dtype: bfloat16` runs the dense layers, the scorers' plain path
and the recurrence's matmuls in bf16 (`compute_dtype`, passed down to
ops/mlp.py, ops/attention.py and ops/fused_clsr.py); parameters, BN
statistics and the carries stay f32.  A serving model may hold int8
tables with `<name>_scales` [N, 1] f32 beside them (serving.py
`quantize_tables`): `lookup_rows` dequantizes after the gather, and
training refuses such a model (`check_not_quantized`).

On a (data, model) mesh (parallel/mesh.py) a table row-sharded by
`place_model` is looked up through `parallel.embedding.gather_rows`
(train and eval), and the lazy L2 and discrepancy sums count each
globally unique row once, on the rank holding its first occurrence
(`global_first`); the losses add the ranks' shares.  LGN reads its
whole tables through `parallel.mesh.logical_table` (models/lgn.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from clsr_tpu_torch.config import Config
from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.ops.attention import TargetAttention
from clsr_tpu_torch.ops.initializers import get_initializer, new_param
from clsr_tpu_torch.ops.mlp import FcnNet, dropout
from clsr_tpu_torch.ops.segment_sum import lookup
from clsr_tpu_torch.parallel.embedding import gather_rows, global_first
from clsr_tpu_torch.parallel.mesh import active_mesh
from clsr_tpu_torch.utils.device import resolve_device


def bn_stats_mask_active(cfg) -> bool:
    """Resolve cfg.bn_stats_mask (clsr_tpu/models/base.py:40-48): the
    attention scorers' BN batch statistics over real history positions
    only (ops/mlp.py MaskedBatchNorm).  'auto' = on exactly when length
    buckets are, since each bucket pads its rows differently."""
    v = getattr(cfg, "bn_stats_mask", "auto")
    return v == "on" or (v == "auto"
                         and getattr(cfg, "length_buckets", "off") != "off")


def compute_dtype(cfg: Config) -> Optional[torch.dtype]:
    """None for float32 (the default), else the torch dtype of mixed
    precision (clsr_tpu/models/base.py:51-55)."""
    if cfg.compute_dtype in ("float32", "f32", None):
        return None
    return getattr(torch, cfg.compute_dtype)


def lookup_cast(emb: torch.Tensor) -> torch.Tensor:
    """Upcast bf16-stored rows to the f32 compute path (JAX :72-76)."""
    return emb.float() if emb.dtype == torch.bfloat16 else emb


def check_not_quantized(model: nn.Module) -> None:
    """Raise if `model` holds int8 tables: a quantized model serves only
    (clsr_tpu/serving.py:125-133)."""
    int8 = sorted(n for n, p in model.named_parameters()
                  if p.dtype == torch.int8)
    if int8:
        raise ValueError(f"int8 tables {int8} are for serving only; train "
                         f"the float model and quantize it for serving")


def _first_occurrence(ids: torch.Tensor):
    """(sorted flat ids, mask of each id's first occurrence)."""
    flat = torch.sort(ids.reshape(-1)).values
    first = torch.ones_like(flat, dtype=torch.bool)
    first[1:] = flat[1:] != flat[:-1]
    return flat, first


def _unique_rows(table: torch.Tensor, ids: torch.Tensor):
    """(rows, first-occurrence mask) of the ids: sorted, or on a mesh this
    rank's ids with the global first-occurrence mask."""
    mesh = active_mesh()
    if mesh is None:
        flat, first = _first_occurrence(ids)
        return lookup_cast(lookup(table, flat)), first
    flat = ids.reshape(-1)
    rows = (gather_rows(table, flat, mesh)
            if getattr(table, "mesh_rows", None) is not None
            else lookup(table, flat))
    return lookup_cast(rows), global_first(flat, mesh)


def unique_rows_sumsq(table: torch.Tensor, ids: torch.Tensor
                      ) -> torch.Tensor:
    """sum(||table[id]||^2) over the UNIQUE ids (models/base.py:99-110);
    on a mesh this rank's share."""
    rows, first = _unique_rows(table, ids)
    return ((rows * rows).sum(-1) * first).sum()


def unique_rows_stats(table_a: torch.Tensor, table_b: torch.Tensor,
                      ids: torch.Tensor):
    """(sumsq_a, sumsq_b, sum((a-b)^2), n_unique*dim) over unique ids
    (models/base.py:113-131); on a mesh this rank's shares."""
    ra, first = _unique_rows(table_a, ids)
    rb, _ = _unique_rows(table_b, ids)
    fa = first[:, None].to(ra.dtype)
    diff = ra - rb
    return ((ra * ra * fa).sum(), (rb * rb * fa).sum(),
            (diff * diff * fa).sum(), first.sum() * table_a.shape[1])


def supervised_attn_labels(batch: Batch) -> Optional[torch.Tensor]:
    """The supervised-attention label [B, G]: the fraction of the history
    sharing the target's category (sequential_iterator.py:619,682); None
    for per-position targets ([B, G, L] cates), as JAX skips it
    (clsr_tpu/models/base.py:235)."""
    if batch.cates.dim() != 2:
        return None
    denom = batch.mask.sum(-1).clamp_min(1.0)
    same_cate = batch.cate_hist[:, None, :] == batch.cates[:, :, None]
    return (same_cate * batch.mask[:, None, :]).sum(-1) / denom[:, None]


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


class SequentialModelBase(nn.Module):
    """Embeddings + lookups + head.  Subclasses define seq_graph."""

    # True for a model whose forward reads every row of its tables, so
    # that a table's gradient may touch any row (LGN); else a table's
    # gradient touches only the rows at the batch's ids
    # (training/lazy_adam.py `batch_table_ids`)
    reads_whole_tables = False

    def __init__(self, cfg: Config, n_users: int, n_items: int,
                 n_cates: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.n_users, self.n_items, self.n_cates = n_users, n_items, n_cates
        self.device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(cfg.seed if cfg.seed is not None else 0)
        self.generator = generator
        self.init = get_initializer(cfg.init_method, cfg.init_value)
        self.dtype = compute_dtype(cfg)
        self.item_embedding = self.new_table(
            (n_items, cfg.item_embedding_dim))
        self.cate_embedding = self.new_table(
            (n_cates, cfg.cate_embedding_dim))

    def new_param(self, shape, init=None) -> nn.Parameter:
        return new_param(shape, init or self.init, self.generator,
                         self.device)

    def new_table(self, shape) -> nn.Parameter:
        """An embedding table in cfg.embedding_dtype: drawn in f32 and
        rounded to bf16 (JAX `embedding_init`, :58-69)."""
        p = self.new_param(shape)
        if self.cfg.embedding_dtype == "bfloat16":
            p = nn.Parameter(p.detach().to(torch.bfloat16))
        return p

    def target_attention(self, query_dim: int, key_dim: int
                         ) -> TargetAttention:
        """A `TargetAttention` with the config's scorer, kernel gates and
        compute dtype (the models' `attention_fcn`, CLSR's two)."""
        cfg = self.cfg
        return TargetAttention(
            query_dim, key_dim, cfg.att_fcn_layer_sizes, cfg.activation,
            self.init, self.generator, self.device, enable_bn=cfg.enable_bn,
            use_kernel=cfg.use_pallas_eval_attention,
            use_train_kernel=cfg.use_pallas_train_attention,
            bn_stats_mask=bn_stats_mask_active(cfg), dtype=self.dtype)

    def head_in_dim(self) -> int:
        raise NotImplementedError

    def build_head(self) -> None:
        """The shared logit head (sequential_base_model.py:72); call at
        the end of the subclass constructor, as flax creates it last."""
        cfg = self.cfg
        self.logit_fcn = FcnNet(
            self.head_in_dim(), cfg.layer_sizes, cfg.activation, self.init,
            self.generator, self.device, enable_bn=cfg.enable_bn, out_dim=1,
            dropout_rates=cfg.dropout if cfg.user_dropout else None,
            dtype=self.dtype)

    def lookup_rows(self, name: str, ids: torch.Tensor) -> torch.Tensor:
        """Rows of table `name` at `ids`, in f32 (JAX `lookup_rows`,
        :79-97): in train mode through `segment_sum.lookup`, whose
        gradient sums a repeated row in one fixed order, else
        `F.embedding`; bf16 rows upcast, int8 rows dequantized by their
        gathered `<name>_scales`."""
        table = getattr(self, name)
        mesh = active_mesh()
        if mesh is not None and getattr(table, "mesh_rows", None) is not None:
            rows = gather_rows(table, ids, mesh)
            if table.dtype == torch.int8:
                return rows.float() * gather_rows(
                    getattr(self, f"{name}_scales"), ids, mesh)
            return lookup_cast(rows)
        if self.training:
            return lookup_cast(lookup(table, ids))
        rows = F.embedding(ids, table)
        if table.dtype == torch.int8:
            scales = F.embedding(ids, getattr(self, f"{name}_scales"))
            return rows.float() * scales
        return lookup_cast(rows)

    def dropout(self, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """Embedding dropout, train mode only."""
        if not self.training:
            return x
        return dropout(x, self.cfg.embedding_dropout, generator)

    def forward(self, batch: Batch,
                generator: Optional[torch.Generator] = None,
                train_kernel: Optional[bool] = None,
                compact: Optional[Dict[str, Any]] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Logits [B, G] and the aux dict the losses read.  In train mode
        `generator` draws the dropout masks, and `train_kernel`, when
        given, overrides cfg.use_pallas_train_attention.  `compact` holds
        the compact row engine's gathered rows by table name."""
        if compact is not None:
            # lookups and the lazy L2 from the gathered rows
            cr_item = compact["item_embedding"]
            cr_cate = compact["cate_embedding"]
            item_hist_emb = lookup_cast(cr_item.site("hist"))
            cate_hist_emb = lookup_cast(cr_cate.site("hist"))
            target_emb = torch.cat([lookup_cast(cr_item.site("targets")),
                                    lookup_cast(cr_cate.site("targets"))],
                                   dim=-1)
            embed_sumsq = cr_item.sumsq_unique() + cr_cate.sumsq_unique()
        else:
            item_hist_emb = self.lookup_rows("item_embedding",
                                             batch.item_hist)
            cate_hist_emb = self.lookup_rows("cate_embedding",
                                             batch.cate_hist)
            target_emb = torch.cat(
                [self.lookup_rows("item_embedding", batch.items),
                 self.lookup_rows("cate_embedding", batch.cates)], dim=-1)
        if self.training:
            if compact is None:
                # lazy L2 bookkeeping BEFORE dropout, on raw table rows
                involved_items = torch.cat([batch.item_hist.reshape(-1),
                                            batch.items.reshape(-1)])
                involved_cates = torch.cat([batch.cate_hist.reshape(-1),
                                            batch.cates.reshape(-1)])
                embed_sumsq = (
                    unique_rows_sumsq(self.item_embedding, involved_items)
                    + unique_rows_sumsq(self.cate_embedding, involved_cates))
            attn_labels = supervised_attn_labels(batch)
        ctx = EmbedContext(
            item_hist_emb=self.dropout(item_hist_emb, generator),
            cate_hist_emb=self.dropout(cate_hist_emb, generator),
            target_emb=self.dropout(target_emb, generator),
        )
        model_output, aux = self.seq_graph(ctx, batch, generator,
                                           train_kernel, compact)
        logits = self.head(model_output, generator)   # [B, G] ([B, G, L])
        if self.training:
            aux = dict(aux, embed_sumsq=aux.get("embed_sumsq", 0.0)
                       + embed_sumsq)
            if attn_labels is not None:
                aux["attn_labels"] = attn_labels
        else:
            # the pre-head concat the histogram probe reads as
            # 'model_output' (JAX :226-233, eval mode only)
            aux = dict(aux, model_output=model_output)
        return logits, aux

    def head(self, model_output: torch.Tensor,
             generator: Optional[torch.Generator]) -> torch.Tensor:
        """The logits from the model output: the shared `logit_fcn`
        (sequential_base_model.py:72); NCF overrides."""
        return self.logit_fcn(model_output, generator=generator)[..., 0]

    def seq_graph(self, ctx: EmbedContext, batch: Batch,
                  generator: Optional[torch.Generator],
                  train_kernel: Optional[bool],
                  compact: Optional[Dict[str, Any]] = None):
        raise NotImplementedError
