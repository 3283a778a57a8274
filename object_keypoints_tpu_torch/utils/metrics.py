"""Metrics logging: JSONL stream + optional TensorBoard event file.

The port's copy of ``object_keypoints_tpu/utils/metrics.py``: the same
records and printed lines. The reference logs scalars through Lightning's
TensorBoard logger (its scripts/train.py:67-91); the durable sink here is
JSONL (one object per call, with ``"step"`` and ``"time"``, seconds since
the logger was made), with the metric names the reference logs;
``tensorboard=True`` also writes an event file (``utils.tb_events``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping, Optional


class MetricsLogger:
    def __init__(self, log_dir: str, filename: str = "metrics.jsonl",
                 tensorboard: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._file = open(self.path, "at", buffering=1)
        self._t0 = time.time()
        self._tb = None
        if tensorboard:
            from object_keypoints_tpu_torch.utils.tb_events import EventFileWriter

            self._tb = EventFileWriter(log_dir)

    def log(self, step: int, metrics: Mapping[str, float], prefix: str = ""):
        record = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        scalars = {}
        for k, v in metrics.items():
            record[prefix + k] = scalars[prefix + k] = float(v)
        self._file.write(json.dumps(record) + "\n")
        if self._tb is not None:
            self._tb.add_scalars(step, scalars)
            self._tb.flush()

    def close(self):
        self._file.close()
        if self._tb is not None:
            self._tb.close()


def print_metrics(step: int, metrics: Mapping[str, float], every: int = 1,
                  extra: Optional[str] = None):
    if step % every:
        return
    parts = [f"step {step:>7d}"]
    for k, v in metrics.items():
        parts.append(f"{k}={float(v):.5g}")
    if extra:
        parts.append(extra)
    print("  ".join(parts), flush=True)
