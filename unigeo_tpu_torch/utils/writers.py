"""Event writers, port of ``unigeo_tpu/utils/writers.py`` as far as the
training loop uses them: a JSONL sink of scalars and a step timer.  The JAX
package's optional TensorBoard / W&B sinks, ``put_scalars`` and the ETA are
not ported."""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Optional


class EventWriter:
    """Appends one JSON line per scalar to ``<log_dir>/events.jsonl``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, "events.jsonl")

    def put_scalar(self, name: str, value: float, step: int) -> None:
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps({"t": time.time(), "step": step, "name": name,
                                "value": float(value)}) + "\n")


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
