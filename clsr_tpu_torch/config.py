"""Typed configuration for the PyTorch port's models, serving, train
step, fit loop, evaluation and CLI.

Counterpart of clsr_tpu/config.py, cut to the fields the ported models
(all ten of the JAX registry: CLSR, SLI-Rec, GRU4Rec, Caser, A2SVD,
DIN, DIEN, NCF, NextItNet, LGN), `ScoringService`, the train step,
`Trainer.fit`, the evaluator and the CLI read.  Semantics kept
from there (and so from the reference's deeprec_utils.py:25-534):

  * YAML files are sectioned (data/model/train/info) and flattened,
    section names dropped, last key wins (`flat_config`).
  * Keyword overrides win over YAML values; unknown keys are ignored
    (`prepare_hparams`).
  * Per-model required keys and type checks (`check_nn_config`,
    `check_type`), for the fields this package keeps.

The port keeps its own copies of the models' yaml files
(configs/{clsr,sli_rec,gru4rec,caser,asvd,din,dien,ncf,nextitnet,lgn}.yaml).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs")


def _flatten_yaml(loaded: Dict[str, Any]) -> Dict[str, Any]:
    """{section: {k: v}} -> {k: v}; section names dropped, last wins."""
    flat: Dict[str, Any] = {}
    for _, section in (loaded or {}).items():
        if isinstance(section, dict):
            flat.update(section)
    return flat


_INT_FIELDS = frozenset({
    "epochs", "show_step", "max_seq_length", "hidden_size",
    "attention_size", "item_embedding_dim", "cate_embedding_dim",
    "user_embedding_dim", "contrastive_length_threshold",
    "contrastive_recent_k", "batch_size", "train_num_ngs", "min_seq_length",
    "early_stop", "kernel_size", "L", "T", "n_v", "n_h",
})
_FLOAT_FIELDS = frozenset({
    "init_value", "manual_alpha_value", "learning_rate", "embed_l2",
    "embed_l1", "layer_l2", "layer_l1", "attn_loss_weight",
    "triplet_margin", "discrepancy_loss_weight", "contrastive_loss_weight",
    "embedding_dropout", "max_grad_norm",
})
_STR_FIELDS = frozenset({
    "method", "loss", "optimizer", "init_method", "model_type",
    "sequential_model", "contrastive_loss", "time_unit", "user_vocab",
    "item_vocab", "cate_vocab", "compact_rows",
})
_LIST_FIELDS = frozenset({"layer_sizes", "att_fcn_layer_sizes", "activation",
                          "dropout", "metrics", "pairwise_metrics",
                          "weighted_metrics", "dilations",
                          "ncf_layer_sizes"})

# Required keys per model family (clsr_tpu/config.py:68-117).
_REQUIRED_BY_MODEL: Dict[str, Tuple[str, ...]] = {
    "clsr": (
        "item_embedding_dim", "cate_embedding_dim", "user_embedding_dim",
        "max_seq_length", "loss", "method", "user_vocab", "item_vocab",
        "cate_vocab", "hidden_size", "att_fcn_layer_sizes",
        "contrastive_length_threshold", "contrastive_recent_k",
    ),
    "sli_rec": (
        "item_embedding_dim", "cate_embedding_dim", "max_seq_length", "loss",
        "method", "user_vocab", "item_vocab", "cate_vocab", "hidden_size",
        "att_fcn_layer_sizes",
    ),
    "gru4rec": (
        "item_embedding_dim", "cate_embedding_dim", "max_seq_length", "loss",
        "method", "user_vocab", "item_vocab", "cate_vocab", "hidden_size",
    ),
    "asvd": (
        "item_embedding_dim", "cate_embedding_dim", "max_seq_length", "loss",
        "method", "user_vocab", "item_vocab", "cate_vocab",
    ),
    "din": (
        "item_embedding_dim", "cate_embedding_dim", "max_seq_length", "loss",
        "method", "user_vocab", "item_vocab", "cate_vocab",
        "att_fcn_layer_sizes",
    ),
    "dien": (
        "item_embedding_dim", "cate_embedding_dim", "max_seq_length", "loss",
        "method", "user_vocab", "item_vocab", "cate_vocab", "hidden_size",
    ),
    "caser": (
        "item_embedding_dim", "cate_embedding_dim", "max_seq_length", "loss",
        "method", "user_vocab", "item_vocab", "cate_vocab", "L", "T", "n_v",
        "n_h",
    ),
    "ncf": (
        "item_embedding_dim", "cate_embedding_dim", "user_embedding_dim",
        "max_seq_length", "loss", "method", "user_vocab", "item_vocab",
        "cate_vocab",
    ),
    "nextitnet": (
        "item_embedding_dim", "cate_embedding_dim", "max_seq_length", "loss",
        "method", "user_vocab", "item_vocab", "cate_vocab", "dilations",
        "kernel_size",
    ),
    "lgn": (
        "item_embedding_dim", "cate_embedding_dim", "user_embedding_dim",
        "max_seq_length", "loss", "method", "user_vocab", "item_vocab",
        "cate_vocab",
    ),
}


@dataclass(frozen=True)
class Config:
    """The hyperparameters the ported models, serving and the train step
    read.

    Defaults are those of clsr_tpu/config.py:Config for the same fields.
    """

    # --- data -------------------------------------------------------------
    user_vocab: Optional[str] = None
    item_vocab: Optional[str] = None
    cate_vocab: Optional[str] = None
    time_unit: str = "s"               # 's' (taobao) or 'ms' (kuaishou)

    # --- model ------------------------------------------------------------
    model_type: str = "clsr"
    method: str = "classification"
    loss: str = "softmax"
    layer_sizes: Tuple[int, ...] = (100, 64)
    att_fcn_layer_sizes: Tuple[int, ...] = (80, 40)
    activation: Tuple[str, ...] = ("relu", "relu")
    user_dropout: bool = False
    dropout: Tuple[float, ...] = (0.0, 0.0)
    embedding_dropout: float = 0.0
    item_embedding_dim: int = 32
    cate_embedding_dim: int = 8
    user_embedding_dim: int = 40
    hidden_size: int = 40
    attention_size: int = 40           # SoftAttention's query (A2SVD,
                                       # SLI-Rec); must equal its input
                                       # width, as in JAX
    max_seq_length: int = 50
    min_seq_length: int = 1
    enable_bn: bool = True

    # CLSR (the contrastive_* keys are required; the losses read them)
    sequential_model: str = "time4lstm"
    interest_evolve: bool = True
    predict_long_short: bool = True
    manual_alpha: bool = False
    manual_alpha_value: float = 0.5
    contrastive_loss: str = "triplet"     # 'bpr' | 'triplet'
    triplet_margin: float = 1.0
    contrastive_loss_weight: float = 0.1
    discrepancy_loss_weight: float = 0.01
    contrastive_length_threshold: int = 5
    contrastive_recent_k: int = 3
    attn_loss_weight: float = 0.001
    use_attn_loss: bool = False   # opt-in supervised fusion loss
                                  # mse(alpha, attn_labels)

    # Caser: horizontal filters of heights 1..L, n_h each; the vertical
    # conv's n_v filters span the whole history (T is read by nothing)
    L: int = 3
    T: int = 1
    n_v: int = 128
    n_h: int = 128
    # NextItNet: one residual block a dilation
    dilations: Tuple[int, ...] = (1, 2, 4, 1, 2, 4)
    kernel_size: int = 3
    nextitnet_per_position: bool = True  # train every history position
                                         # as an instance ([B, G, L]
                                         # targets, training/
                                         # negative_sampling.py)
    # NCF: the MLP tower's widths
    ncf_layer_sizes: Tuple[int, ...] = (80, 40)
    # LGN: graph convolution rounds
    n_layers: int = 2

    # --- train ------------------------------------------------------------
    init_method: str = "tnormal"
    init_value: float = 0.01
    embed_l2: float = 1e-6
    embed_l1: float = 0.0
    layer_l2: float = 1e-6
    layer_l1: float = 0.0
    learning_rate: float = 0.001
    optimizer: str = "adam"
    epochs: int = 100
    batch_size: int = 500
    is_clip_norm: bool = True
    max_grad_norm: float = 2.0
    need_sample: bool = True
    train_num_ngs: int = 4
    valid_num_ngs: int = 4
    test_num_ngs: int = 99
    early_stop: int = 5
    eval_metric: str = "wauc"
    seed: Optional[int] = None

    # --- info / io ---------------------------------------------------------
    show_step: int = 500
    save_model: bool = True
    model_dir: Optional[str] = None
    summaries_dir: Optional[str] = None
    write_tfevents: bool = False        # TensorBoard event files
    write_histograms: bool = False      # device histograms, show_step
    metrics: Tuple[str, ...] = ("auc", "logloss")
    pairwise_metrics: Tuple[str, ...] = ("mean_mrr", "ndcg@2;4;6",
                                         "hit@2;4;6", "group_auc")
    weighted_metrics: Tuple[str, ...] = ("wauc",)

    # --- execution --------------------------------------------------------
    compute_dtype: str = "float32"
    embedding_dtype: str = "float32"
    use_fused_encoders: bool = True
    attention_block_size: int = 0
    use_pallas_scan: bool = False            # K2, the recurrence kernel
    use_pallas_eval_attention: str = "auto"  # K1: 'auto' = on for CUDA
                                             # tensors, 'on', 'off'
    use_pallas_train_attention: str = "off"  # K3a + K3b + K1 in train
                                             # mode: 'auto' = on for CUDA
                                             # tensors, 'on', 'off'
    compact_rows: str = "auto"      # 'auto' | 'off': the compact row
                                    # engine of lazyadam (one sorted
                                    # gather and one row write per table
                                    # per step, training/compact_rows.py)
    # the (data, model) mesh of ranks (parallel/mesh.py): the batch over
    # 'data' (or over both axes under mesh_flat_batch), the tables
    # row-sharded over 'model'
    data_parallel: int = 1
    model_parallel: int = 1
    mesh_flat_batch: str = "auto"   # 'auto' | 'on' | 'off': 'auto' = on
                                    # when model_parallel > 1 and the
                                    # batch divides data*model
    mesh_update_routing: str = "broadcast"  # 'broadcast' | 'owner': the
                                    # compact merge all_gathers the whole
                                    # (id, gradient) stream, or routes
                                    # each unique row's summed gradient
                                    # to its owner in static buckets
                                    # (training/lazy_adam.py)
    mesh_owner_capacity: float = 4.0  # owner buckets' slots: ceil(f * Mi
                                    # / m) clamped to [1, Mi]
    mesh_owner_overflow: str = "fallback"  # 'fallback' | 'drop': a step
                                    # whose buckets overflow takes the
                                    # broadcast merge for that table, or
                                    # drops the overflowed entries; both
                                    # count them in route_overflow
    mesh_row_layout: str = "auto"   # 'auto' | 'interleaved' |
                                    # 'contiguous' (parallel/rowmap.py)
    # K train steps a host call: on the card one captured train step
    # replayed K times (training/steps.py MultiTrainStep,
    # ResidentMultiStep); the same math as K single steps
    train_steps_per_call: int = 32
    autosave_every_calls: int = 0   # > 0: the run state to
                                    # <model_dir>/autosave every N calls
                                    # (fit(resume=True) continues it)
    prefetch_batches: int = 2       # host->device batches in flight
    resident_data: str = "auto"     # 'auto' | 'on' | 'off': upload the
                                    # padded train set to the device once
                                    # and gather each batch there
                                    # (data/resident.py); 'auto' is on
                                    # when it fits resident_max_bytes
    resident_max_bytes: int = 6_000_000_000
    resident_round_rows: int = 0    # > 1: round the resident dataset's
                                    # (or each length bucket's) rows up
                                    # to this multiple with never-
                                    # eligible zero rows
                                    # (data/resident.py pad_view_rows)
    length_buckets: str = "off"     # 'off' | 'auto' | comma edges ('16'):
                                    # on the resident path, rows split by
                                    # history length into buckets, each
                                    # padded to its own Lb and trained by
                                    # its own captured step; 'auto' picks
                                    # edges over the length histogram
                                    # (data/resident.py)
    bn_refresh_batches: int = 64    # bucketed path: forward-only batches,
                                    # round-robin over the buckets, that
                                    # re-estimate the BN running
                                    # statistics at each epoch's end
    bn_stats_mask: str = "auto"     # 'auto' | 'on' | 'off': the scorers'
                                    # BN batch statistics over real
                                    # history positions only
                                    # (ops/mlp.py MaskedBatchNorm); 'auto'
                                    # = on exactly when length_buckets is
    drop_remainder_min: int = 5     # the reference drops train batches
                                    # of < 5 rows (sequential_iterator.py
                                    # :338-339)

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)

    @property
    def target_dim(self) -> int:
        """Width of concat(item, cate) (sequential_base_model.py:435-437)."""
        return self.item_embedding_dim + self.cate_embedding_dim

    def validate(self) -> "Config":
        """Fail fast on missing or mistyped fields."""
        model = self.model_type.lower()
        required = _REQUIRED_BY_MODEL.get(model, ())
        flat = dataclasses.asdict(self)
        for key in required:
            if flat.get(key) is None:
                raise ValueError(
                    f"Parameter {key} must be set for model {model}")
        for key, val in flat.items():
            if val is None:
                continue
            if key in _INT_FIELDS and not isinstance(val, int):
                raise TypeError(
                    f"Parameter {key} must be int, got {type(val)}")
            if key in _FLOAT_FIELDS and not isinstance(val, (int, float)):
                raise TypeError(
                    f"Parameter {key} must be float, got {type(val)}")
            if key in _STR_FIELDS and not isinstance(val, str):
                raise TypeError(
                    f"Parameter {key} must be str, got {type(val)}")
            if key in _LIST_FIELDS and not isinstance(val, (list, tuple)):
                raise TypeError(
                    f"Parameter {key} must be a sequence, got {type(val)}")
        if self.method not in ("classification", "regression"):
            raise ValueError(
                f"method must be classification or regression, got "
                f"{self.method}")
        if self.loss not in ("softmax", "cross_entropy_loss", "square_loss",
                             "log_loss"):
            raise ValueError(f"loss not defined: {self.loss}")
        if self.contrastive_loss not in ("bpr", "triplet"):
            raise ValueError(
                f"contrastive_loss must be bpr or triplet, got "
                f"{self.contrastive_loss}")
        if self.sequential_model not in ("gru", "lstm", "time4lstm"):
            raise ValueError(
                f"sequential_model not defined: {self.sequential_model}")
        if self.attention_block_size > 0 and self.enable_bn:
            raise ValueError(
                "attention_block_size requires enable_bn: False (the "
                "blockwise scorer is BN-free, ops/long_context.py)")
        if self.embedding_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"embedding_dtype must be float32 or bfloat16, got "
                f"{self.embedding_dtype}")
        if (self.embedding_dtype == "bfloat16"
                and self.optimizer != "lazyadam"):
            # the dense optimizers keep no f32 update path for bf16
            # tables (clsr_tpu/config.py:464-469)
            raise ValueError(
                "embedding_dtype=bfloat16 requires optimizer=lazyadam")
        for key in ("use_pallas_eval_attention", "use_pallas_train_attention"):
            if getattr(self, key) not in ("auto", "on", "off"):
                raise ValueError(
                    f"{key} must be auto/on/off, got {getattr(self, key)}")
        if self.compact_rows not in ("auto", "off"):
            raise ValueError(
                f"compact_rows must be auto/off, got {self.compact_rows}")
        if self.mesh_flat_batch not in ("auto", "on", "off"):
            raise ValueError(
                f"mesh_flat_batch must be auto/on/off, "
                f"got {self.mesh_flat_batch}")
        n_dev = self.data_parallel * self.model_parallel
        if self.mesh_flat_batch == "on" and self.batch_size % n_dev:
            raise ValueError(
                f"mesh_flat_batch='on' needs batch_size divisible by "
                f"data_parallel*model_parallel ({self.batch_size} % "
                f"{n_dev} != 0)")
        if self.mesh_update_routing not in ("broadcast", "owner"):
            raise ValueError(
                f"mesh_update_routing must be broadcast/owner, got "
                f"{self.mesh_update_routing}")
        if self.mesh_owner_capacity <= 0:
            raise ValueError(
                f"mesh_owner_capacity must be > 0, got "
                f"{self.mesh_owner_capacity}")
        if self.mesh_owner_overflow not in ("fallback", "drop"):
            raise ValueError(
                f"mesh_owner_overflow must be fallback/drop, got "
                f"{self.mesh_owner_overflow}")
        if self.mesh_row_layout not in ("auto", "interleaved", "contiguous"):
            raise ValueError(
                f"mesh_row_layout must be auto/interleaved/contiguous, "
                f"got {self.mesh_row_layout}")
        if self.resident_data not in ("auto", "on", "off"):
            raise ValueError(
                f"resident_data must be auto/on/off, got {self.resident_data}")
        if self.length_buckets not in ("off", "auto"):
            try:
                edges = [int(e) for e in self.length_buckets.split(",")]
            except ValueError:
                raise ValueError(
                    f"length_buckets must be off/auto or comma-separated "
                    f"ints, got {self.length_buckets!r}")
            if (sorted(edges) != edges or len(set(edges)) != len(edges)
                    or any(e < 1 or e >= self.max_seq_length
                           for e in edges)):
                raise ValueError(
                    f"length_buckets edges must be strictly ascending and "
                    f"in [1, max_seq_length), got {self.length_buckets!r}")
        if self.bn_stats_mask not in ("auto", "on", "off"):
            raise ValueError(
                f"bn_stats_mask must be auto/on/off, got "
                f"{self.bn_stats_mask}")
        if self.length_buckets != "off" and self.autosave_every_calls > 0:
            raise ValueError(
                "autosave_every_calls (mid-epoch resume) is not supported "
                "with length_buckets — the run state stores a single "
                "epoch permutation")
        if self.autosave_every_calls < 0:
            raise ValueError(
                f"autosave_every_calls must be >= 0, got "
                f"{self.autosave_every_calls}")
        if self.autosave_every_calls > 0 and not self.model_dir:
            raise ValueError("autosave_every_calls > 0 requires model_dir")
        if model == "lgn" and self.optimizer == "lazyadam":
            # the graph convolution gives every table row a gradient; lazy
            # row updates would drop most of them (clsr_tpu/config.py:
            # 545-549)
            raise ValueError("lazyadam is not valid for lgn (dense table "
                             "gradients from the graph convolution)")
        if model == "caser" and self.length_buckets != "off":
            # the vertical conv's kernel is [D, max_seq_length, n_v]: a
            # bucket's shorter history does not fit it (the JAX package
            # fails there too, a flax ScopeParamShapeError at the first
            # bucketed step)
            raise ValueError(
                "caser needs every history max_seq_length long (its "
                "vertical conv spans the whole history); set "
                "length_buckets: off")
        if model == "clsr" and self.hidden_size != self.target_dim:
            # the alpha fusion adds att_fea_long (item+cate wide) to
            # att_fea_short (hidden wide), clsr.py:265
            raise ValueError(
                "CLSR requires hidden_size == item_embedding_dim + "
                f"cate_embedding_dim (got {self.hidden_size} vs "
                f"{self.target_dim})")
        return self


# YAML keys (reference spelling) -> Config field names.
_KEY_ALIASES = {
    "EARLY_STOP": "early_stop",
    "MODEL_DIR": "model_dir",
    "SUMMARIES_DIR": "summaries_dir",
    "enable_BN": "enable_bn",
}


def _coerce(key: str, value: Any) -> Any:
    if key in _LIST_FIELDS and isinstance(value, list):
        return tuple(value)
    if key == "is_clip_norm":
        return bool(value)
    if key in ("bn_stats_mask", "length_buckets") and isinstance(value,
                                                                 bool):
        return "on" if value else "off"   # YAML's unquoted on / off
    return value


def load_config(yaml_file: Optional[str] = None, **overrides) -> Config:
    """A validated Config from an optional YAML file plus overrides.

    YAML values first, keyword overrides win, unknown keys ignored,
    then validation (clsr_tpu/config.py:583-604).  YAML reads an
    unquoted on / off as a bool; for bn_stats_mask and length_buckets it
    means the word.
    """
    flat: Dict[str, Any] = {}
    if yaml_file is not None:
        import yaml   # only YAML reads need PyYAML
        with open(yaml_file, "r") as f:
            flat.update(_flatten_yaml(yaml.safe_load(f)))
    flat.update(overrides)

    known = {f.name for f in dataclasses.fields(Config)}
    kwargs: Dict[str, Any] = {}
    for key, value in flat.items():
        name = _KEY_ALIASES.get(key, key)
        if name in known:
            kwargs[name] = _coerce(name, value)
    return Config(**kwargs).validate()
