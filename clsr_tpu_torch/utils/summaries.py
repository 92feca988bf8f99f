"""Training observability: a JSONL scalar log.

Counterpart of clsr_tpu/utils/summaries.py:18-44, which replaces the
reference's tf.summary scalar stream (clsr.py:448-455,
sequential_base_model.py:140-146) with `<log_dir>/scalars.jsonl`, one
record a call: {"step", "time", name: value, ...}.  TensorBoard event
files and the activation histograms wait for ROADMAP queue 1 item 11 and
raise.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class SummaryWriter:
    def __init__(self, log_dir: Optional[str], write_tfevents: bool = False):
        if write_tfevents:
            raise NotImplementedError(
                "TensorBoard event files wait for ROADMAP queue 1 item 11 "
                "(host remainder)")
        self.log_dir = log_dir
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        if self._jsonl is not None:
            rec = {"step": step, "time": time.time()}
            rec.update({k: float(v) for k, v in values.items()})
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()

    def histograms(self, step: int, hists) -> None:
        raise NotImplementedError(
            "activation histograms wait for ROADMAP queue 1 item 11 (host "
            "remainder)")

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
