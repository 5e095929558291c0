"""Tracing and per-clip timing, port of ``unigeo_tpu/utils/profiling.py``.

* ``ClipTimer``: each clip's wall seconds and the running frames per
  second, one JSON line per clip appended when given a path.  The caller
  makes the timed block end on finished device work: the port's models
  return host arrays, which waits for the card.
* ``trace_annotation``: a named range (``torch.profiler.record_function``),
  the counterpart of ``jax.profiler.TraceAnnotation``, so stages show up by
  name in a trace.
* ``start_trace`` / ``stop_trace``: a ``torch.profiler.profile`` of the CPU
  and, where there is one, the card around a region, written as a Chrome
  trace (``trace.json``, for chrome://tracing or Perfetto) into ``logdir``,
  the counterpart of ``jax.profiler.start_trace`` / ``stop_trace``.  One
  trace at a time.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

_TRACE = {}  # the running profile and its logdir


@contextlib.contextmanager
def trace_annotation(name: str):
    import torch.profiler

    with torch.profiler.record_function(name):
        yield


def start_trace(logdir: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if _TRACE:
        raise RuntimeError(f"a trace into {_TRACE['logdir']} is running")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _TRACE.update(prof=prof, logdir=logdir)


def stop_trace() -> str:
    """Stops the running trace; returns the path of its ``trace.json``."""
    if not _TRACE:
        raise RuntimeError("no trace is running")
    prof, logdir = _TRACE.pop("prof"), _TRACE.pop("logdir")
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    return path


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
