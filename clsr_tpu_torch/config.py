"""Typed configuration for the PyTorch port's CLSR model, serving and
train step.

Counterpart of clsr_tpu/config.py, cut to the fields the CLSR forward,
`ScoringService` and the train step read.  Semantics kept from there
(and so from the reference's deeprec_utils.py:25-534):

  * YAML files are sectioned (data/model/train/info) and flattened,
    section names dropped, last key wins (`flat_config`).
  * Keyword overrides win over YAML values; unknown keys are ignored
    (`prepare_hparams`).
  * Per-model required keys and type checks (`check_nn_config`,
    `check_type`), for the fields this package keeps.

The port keeps its own copy of configs/clsr.yaml.
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
    "max_seq_length", "hidden_size", "item_embedding_dim",
    "cate_embedding_dim", "user_embedding_dim",
    "contrastive_length_threshold", "contrastive_recent_k", "batch_size",
    "train_num_ngs",
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
    "item_vocab", "cate_vocab",
})
_LIST_FIELDS = frozenset({"layer_sizes", "att_fcn_layer_sizes", "activation",
                          "dropout"})

# Required keys per model family (clsr_tpu/config.py:68-117).  Only CLSR
# is ported; the registry refuses the other names.
_REQUIRED_BY_MODEL: Dict[str, Tuple[str, ...]] = {
    "clsr": (
        "item_embedding_dim", "cate_embedding_dim", "user_embedding_dim",
        "max_seq_length", "loss", "method", "user_vocab", "item_vocab",
        "cate_vocab", "hidden_size", "att_fcn_layer_sizes",
        "contrastive_length_threshold", "contrastive_recent_k",
    ),
}


@dataclass(frozen=True)
class Config:
    """The hyperparameters the CLSR model, serving and the train step read.

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
    max_seq_length: int = 50
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

    # --- train ------------------------------------------------------------
    init_method: str = "tnormal"
    init_value: float = 0.01
    embed_l2: float = 1e-6
    embed_l1: float = 0.0
    layer_l2: float = 1e-6
    layer_l1: float = 0.0
    learning_rate: float = 0.001
    optimizer: str = "adam"
    batch_size: int = 500
    is_clip_norm: bool = True
    max_grad_norm: float = 2.0
    need_sample: bool = True
    train_num_ngs: int = 4
    seed: Optional[int] = None

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
    data_parallel: int = 1
    model_parallel: int = 1

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
                "blockwise scorer is BN-free)")
        if self.embedding_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"embedding_dtype must be float32 or bfloat16, got "
                f"{self.embedding_dtype}")
        for key in ("use_pallas_eval_attention", "use_pallas_train_attention"):
            if getattr(self, key) not in ("auto", "on", "off"):
                raise ValueError(
                    f"{key} must be auto/on/off, got {getattr(self, key)}")
        if model == "clsr" and self.hidden_size != self.target_dim:
            # the alpha fusion adds att_fea_long (item+cate wide) to
            # att_fea_short (hidden wide), clsr.py:265
            raise ValueError(
                "CLSR requires hidden_size == item_embedding_dim + "
                f"cate_embedding_dim (got {self.hidden_size} vs "
                f"{self.target_dim})")
        return self


# YAML keys (reference spelling) -> Config field names.
_KEY_ALIASES = {"enable_BN": "enable_bn"}


def _coerce(key: str, value: Any) -> Any:
    if key in _LIST_FIELDS and isinstance(value, list):
        return tuple(value)
    if key == "is_clip_norm":
        return bool(value)
    return value


def load_config(yaml_file: Optional[str] = None, **overrides) -> Config:
    """A validated Config from an optional YAML file plus overrides.

    YAML values first, keyword overrides win, unknown keys ignored,
    then validation (clsr_tpu/config.py:583-604).
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
