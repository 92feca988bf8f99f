"""Model factory (counterpart of clsr_tpu/models/registry.py).

Names accept the reference's flag spellings and lowercase.  Only CLSR is
ported; the other models of the JAX registry raise until the model zoo
slice (ROADMAP queue 1) brings them.
"""

from __future__ import annotations

from typing import Dict, Type

from clsr_tpu_torch.models.base import SequentialModelBase
from clsr_tpu_torch.models.clsr import CLSRModel

MODEL_REGISTRY: Dict[str, Type[SequentialModelBase]] = {"clsr": CLSRModel}

# in the JAX registry, not ported yet
_NOT_PORTED = frozenset({
    "sli_rec", "slirec", "gru4rec", "caser", "a2svd", "asvd", "din",
    "dien", "ncf", "nextitnet", "lgn",
})


def get_model_class(name: str) -> Type[SequentialModelBase]:
    key = name.lower()
    if key in MODEL_REGISTRY:
        return MODEL_REGISTRY[key]
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name} is not yet ported to PyTorch (ROADMAP queue 1 "
            f"item 8, model zoo); ported: {sorted(MODEL_REGISTRY)}")
    raise ValueError(
        f"Unknown model {name}; available: {sorted(MODEL_REGISTRY)}")
