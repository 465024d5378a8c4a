"""Experiment summary writer (a copy of
``transformer_explainability_tpu/utils/summaries.py``; the reference's
``utils/summaries.py`` is a thin TensorBoard wrapper): a dependency-free
JSONL scalar logger, mirrored to TensorBoard where it imports."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class SummaryWriter:
    """Append scalar metrics to ``<directory>/scalars.jsonl``; mirrors to
    TensorBoard when the optional dependency exists."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._f = open(os.path.join(directory, "scalars.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter as TB
            self._tb = TB(log_dir=directory)
        except Exception:
            pass

    def add_scalar(self, tag: str, value: float, step: Optional[int] = None):
        rec = {"tag": tag, "value": float(value), "step": step,
               "time": time.time()}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
