"""Scalar logging: ``scalars.jsonl`` always, TensorBoard where
``torch.utils.tensorboard`` imports; ``metrics.jsonl`` for epoch records.
The port's own copy of ``vsta_tpu/utils/logging.py``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class ScalarLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "scalars.jsonl")
        self._f = open(self.path, "a", buffering=1)
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print(f"[log] TensorBoard unavailable ({e}); scalars go to {self.path} only")
            else:
                self._tb = SummaryWriter(log_dir=os.path.join(log_dir, "tb"))

    def log(self, tag: str, value: float, step: int):
        self._f.write(
            json.dumps({"tag": tag, "value": float(value), "step": int(step), "t": time.time()})
            + "\n"
        )
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def log_dict(self, scalars: Dict[str, float], step: int, prefix: str = ""):
        for k, v in scalars.items():
            self.log(prefix + k, v, step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class MetricWriter:
    """Append structured epoch records to metrics.jsonl."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")

    def write(self, record: Dict):
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
