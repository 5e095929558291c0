"""Event writers, port of ``unigeo_tpu/utils/writers.py``: a JSONL sink of
scalars, an optional TensorBoard sink (``torch.utils.tensorboard``, imported
only when it is asked for, and an error then if it is missing), and a step
timer.  The JAX package's W&B sink and the timer's ETA are not ported."""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Dict, Optional


class EventWriter:
    """Appends one JSON line per scalar to ``<log_dir>/events.jsonl``, and
    with ``use_tensorboard`` writes each to TensorBoard's event files in
    ``log_dir`` too."""

    def __init__(self, log_dir: str, use_tensorboard: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, "events.jsonl")
        self._tb = None
        if use_tensorboard:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir)

    def put_scalar(self, name: str, value: float, step: int) -> None:
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps({"t": time.time(), "step": step, "name": name,
                                "value": float(value)}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(name, value, step)

    def put_scalars(self, scalars: Dict[str, float], step: int) -> None:
        for name, value in scalars.items():
            self.put_scalar(name, value, step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()


class TimeWriter:
    """Context manager keeping a running average of its blocks' wall time
    over the last ``window``, each block's seconds also written as a scalar."""

    def __init__(self, writer: Optional[EventWriter] = None, name: str = "time",
                 window: int = 20):
        self.writer = writer
        self.name = name
        self.times = deque(maxlen=window)
        self.step = 0
        self.last = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.last = time.perf_counter() - self._t0
        self.times.append(self.last)
        self.step += 1
        if self.writer is not None:
            self.writer.put_scalar(self.name, self.last, self.step)
        return False

    @property
    def avg(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0
