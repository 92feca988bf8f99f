"""Device choice for the port's entry points.

Entry points take `device=None` and run on the card: without one they
raise rather than quietly run on the CPU.  Callers that want the CPU
(the tests) say so with `device="cpu"`.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None -> cuda; raise if CUDA is asked for and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev
