"""Metric logging (port of ``litehandnet_tpu/utils/logging_.py``): JSONL
always, TensorBoard where ``torch.utils.tensorboard`` imports.

Scalars go to ``<dir>/metrics.jsonl`` and, when TensorBoard is installed,
to event files under ``<dir>/tb`` (reference dist_train.py:131-143). Only
the chief writes: other ranks build the logger with ``enabled=False``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping


class MetricLogger:
    def __init__(self, log_dir: str, enabled: bool = True):
        self.enabled = enabled
        self.log_dir = log_dir
        self._tb = None
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(log_dir=os.path.join(log_dir, "tb"))

    def log(self, step: int, scalars: Mapping[str, float],
            prefix: str = "") -> None:
        if not self.enabled:
            return
        record = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            key = f"{prefix}{k}" if prefix else k
            record[key] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(key, float(v), int(step))
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        if not self.enabled:
            return
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
