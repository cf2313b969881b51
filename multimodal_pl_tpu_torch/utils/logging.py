"""Structured metrics logging (reference: tensorboardX scalars + stdout log,
utils.py:42-51, train:428-429), a copy of ``multimodal_pl_tpu/utils/logging.py``.

Writes JSONL always and tensorboard event files when tensorboardX is
importable.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, log_dir: str, name: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self._file = open(self.path, "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except ImportError:
            pass

    def log(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            key = f"{prefix}{k}"
            try:
                rec[key] = float(v)
            except (TypeError, ValueError):
                rec[key] = v
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time") and isinstance(v, float):
                    self._tb.add_scalar(k, v, step)

    def close(self):
        self._file.close()
        if self._tb is not None:
            self._tb.close()
