"""Model factory (counterpart of clsr_tpu/models/registry.py).

Names accept the reference's flag spellings (CLSR, SLIREC, GRU4REC,
CASER, A2SVD, DIN, DIEN, NCF, NEXTITNET, LGN) and lowercase.  LGN's
constructor also takes its interaction graph (`graph=`, data/graph.py).
"""

from __future__ import annotations

from typing import Dict, Type

from clsr_tpu_torch.models.asvd import A2SVDModel
from clsr_tpu_torch.models.base import SequentialModelBase
from clsr_tpu_torch.models.caser import CaserModel
from clsr_tpu_torch.models.clsr import CLSRModel
from clsr_tpu_torch.models.dien import DIENModel
from clsr_tpu_torch.models.din import DINModel
from clsr_tpu_torch.models.gru4rec import GRU4RecModel
from clsr_tpu_torch.models.lgn import LGNModel
from clsr_tpu_torch.models.ncf import NCFModel
from clsr_tpu_torch.models.nextitnet import NextItNetModel
from clsr_tpu_torch.models.sli_rec import SLIRecModel

MODEL_REGISTRY: Dict[str, Type[SequentialModelBase]] = {
    "clsr": CLSRModel,
    "sli_rec": SLIRecModel,
    "slirec": SLIRecModel,
    "gru4rec": GRU4RecModel,
    "caser": CaserModel,
    "a2svd": A2SVDModel,
    "asvd": A2SVDModel,
    "din": DINModel,
    "dien": DIENModel,
    "ncf": NCFModel,
    "nextitnet": NextItNetModel,
    "lgn": LGNModel,
}


def get_model_class(name: str) -> Type[SequentialModelBase]:
    key = name.lower()
    if key not in MODEL_REGISTRY:
        raise ValueError(
            f"Unknown model {name}; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[key]
