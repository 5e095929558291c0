"""Per-clip timing of the evaluator, port of
``unigeo_tpu/utils/profiling.py::ClipTimer``.

``ClipTimer`` keeps each clip's wall seconds and the running frames per
second, and appends one JSON line per clip when given a path.  The caller
makes the timed block end on finished device work: the port's models
return host arrays, which waits for the card.  The JAX package's xprof
hooks (``trace_annotation``, ``start_trace``) have no counterpart here:
``torch.profiler`` is used directly where a trace is wanted.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Optional


class ClipTimer:
    """Wall-clock per clip, frames/s running stats, optional JSONL log."""

    def __init__(self, jsonl_path: Optional[str] = None):
        self.jsonl_path = jsonl_path
        self.count = 0
        self.total_s = 0.0
        self.total_frames = 0
        self.last_s = 0.0

    @contextlib.contextmanager
    def clip(self, num_frames: int):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.count += 1
        self.total_s += dt
        self.total_frames += num_frames
        self.last_s = dt
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps({"clip": self.count, "seconds": dt, "frames": num_frames,
                                    "fps": num_frames / dt if dt > 0 else 0.0}) + "\n")

    @property
    def fps(self) -> float:
        return self.total_frames / self.total_s if self.total_s > 0 else 0.0

    def summary(self) -> str:
        return f"clip {self.count}: {self.last_s:.2f}s, avg {self.fps:.2f} frames/s"
