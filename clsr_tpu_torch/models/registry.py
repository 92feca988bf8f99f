"""Model factory (counterpart of clsr_tpu/models/registry.py).

Names accept the reference's flag spellings (CLSR, SLIREC, GRU4REC,
A2SVD, DIN, DIEN) and lowercase.  The JAX registry's other models raise
until ROADMAP queue 1 item 8b brings them.
"""

from __future__ import annotations

from typing import Dict, Type

from clsr_tpu_torch.models.asvd import A2SVDModel
from clsr_tpu_torch.models.base import SequentialModelBase
from clsr_tpu_torch.models.clsr import CLSRModel
from clsr_tpu_torch.models.dien import DIENModel
from clsr_tpu_torch.models.din import DINModel
from clsr_tpu_torch.models.gru4rec import GRU4RecModel
from clsr_tpu_torch.models.sli_rec import SLIRecModel

MODEL_REGISTRY: Dict[str, Type[SequentialModelBase]] = {
    "clsr": CLSRModel,
    "sli_rec": SLIRecModel,
    "slirec": SLIRecModel,
    "gru4rec": GRU4RecModel,
    "a2svd": A2SVDModel,
    "asvd": A2SVDModel,
    "din": DINModel,
    "dien": DIENModel,
}

# in the JAX registry, not ported yet
_NOT_PORTED = frozenset({"caser", "ncf", "nextitnet", "lgn"})


def get_model_class(name: str) -> Type[SequentialModelBase]:
    key = name.lower()
    if key in MODEL_REGISTRY:
        return MODEL_REGISTRY[key]
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name} is not yet ported to PyTorch (ROADMAP queue 1 "
            f"item 8b, the rest of the model zoo); ported: "
            f"{sorted(MODEL_REGISTRY)}")
    raise ValueError(
        f"Unknown model {name}; available: {sorted(MODEL_REGISTRY)}")
