"""Online inference serving, port of ``unigeo_tpu/serving.py``.

Stdlib ``http.server`` and the numpy npz wire format, no other dependency:

  * ``InferenceServer``: a micro-batching executor around any registered
    model.  Requests queue up; one dispatch thread coalesces up to
    ``max_batch`` clips inside a ``batch_window_ms`` window and runs a batch
    of more than one clip through the model's ``forward_batch`` when it has
    one (on the card, one batched denoise: ``pipeline.run_clips_staged``),
    every caller of that batch sharing its failure; otherwise the clips go
    one by one through ``forward``, each failure its own caller's.  One
    dispatch thread by design: the card's work is serialised anyway, and
    the thread runs the model under ``torch.inference_mode()`` (grad mode is
    thread-local, so the caller's setting does not reach it).
  * ``HTTPInferenceServer``: a ThreadingHTTPServer exposing
      POST /v1/predict   npz body (the unified sample arrays) -> npz preds
      GET  /healthz      liveness and the model's name
      GET  /stats        clips served, latency percentiles, batch sizes
  * ``warmup_clip``: a small synthetic clip (the port's
    ``SyntheticBoxDataset``) to push through the model before the socket
    opens, so the first request does not pay for the kernels' build and
    cuDNN's first use.

Wire format: ``np.savez`` both ways.  Every array of a request becomes a key
of the model's input dict (0-d arrays come back as python scalars, so
``keyview_idx`` round-trips); every ``pred_*`` array of the model's output
goes back in the response.  No pickle anywhere: nothing executable crosses
the wire.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from unigeo_tpu_torch.device import to_host


class _Request:
    __slots__ = ("data", "event", "result", "error", "t_enqueue")

    def __init__(self, data: Dict[str, Any]):
        self.data = data
        self.event = threading.Event()
        self.result: Optional[Dict[str, Any]] = None
        self.error: Optional[str] = None
        self.t_enqueue = time.perf_counter()


class InferenceServer:
    """Micro-batching model executor (the transport-agnostic core)."""

    def __init__(self, model, max_batch: int = 0, batch_window_ms: float = 5.0,
                 max_queue: int = 256):
        self.model = model
        # the model's own batch (DepthCrafter's clips_per_step) unless given
        self.max_batch = max_batch or int(getattr(model, "eval_batch_size", 1))
        self.batch_window_ms = batch_window_ms
        self._queue: "queue.Queue[_Request]" = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._lat = deque(maxlen=1000)  # seconds, end to end
        self._batches = deque(maxlen=1000)
        self._served = 0
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def predict(self, data: Dict[str, Any], timeout: float = 300.0) -> Dict[str, Any]:
        """Blocking single-clip inference (thread-safe)."""
        if self._stop.is_set():
            raise RuntimeError("server is shut down")
        req = _Request(data)
        self._queue.put(req, timeout=5.0)
        if not req.event.wait(timeout):
            raise TimeoutError("inference timed out")
        if req.error is not None:
            raise RuntimeError(req.error)
        return req.result

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            lats = sorted(self._lat)
            batches = list(self._batches)
        pct = lambda q: (lats[min(int(q * len(lats)), len(lats) - 1)] if lats else 0.0)
        return {
            "served": self._served,
            "queue_depth": self._queue.qsize(),
            "latency_p50_s": round(pct(0.50), 4),
            "latency_p90_s": round(pct(0.90), 4),
            "latency_p99_s": round(pct(0.99), 4),
            "mean_batch": round(float(np.mean(batches)), 2) if batches else 0.0,
            "max_batch": self.max_batch,
        }

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
        # fail whatever is still queued, so blocked predict() callers return
        # now rather than at their timeout
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            req.error = "server shut down before the request was dispatched"
            req.event.set()

    def _collect(self) -> List[_Request]:
        """One blocking get, then up to max_batch within the window."""
        try:
            first = self._queue.get(timeout=0.25)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.batch_window_ms / 1000.0
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _run(self):
        with torch.inference_mode():
            while not self._stop.is_set():
                batch = self._collect()
                if batch:
                    self._dispatch(batch)

    def _dispatch(self, batch: List[_Request]):
        if len(batch) > 1 and callable(getattr(self.model, "forward_batch", None)):
            try:
                outs = self.model.forward_batch([r.data for r in batch])
                for req, out in zip(batch, outs):
                    req.result = out
            except Exception as exc:  # noqa: BLE001 — to the callers
                # one batched run served them all: every caller shares its failure
                for req in batch:
                    req.error = f"{type(exc).__name__}: {exc}"
        else:
            # one by one: a malformed request cannot fail the others
            for req in batch:
                try:
                    req.result = self.model.forward(req.data)
                except Exception as exc:  # noqa: BLE001 — to the caller
                    req.error = f"{type(exc).__name__}: {exc}"
        now = time.perf_counter()
        with self._lock:
            self._served += len(batch)
            self._batches.append(len(batch))
            for req in batch:
                self._lat.append(now - req.t_enqueue)
        for req in batch:
            req.event.set()


# ---------------------------------------------------------------------------
# npz wire helpers
# ---------------------------------------------------------------------------


def encode_arrays(arrays: Dict[str, Any]) -> bytes:
    """npz-encode every numeric entry.  Anything array-coercible (numpy,
    tensors on the card or the CPU, scalars, nested lists) is kept; only
    object-dtype values (dicts, ragged lists) are dropped: a model returning
    device tensors must not lose its predictions silently."""
    out = {}
    for k, v in arrays.items():
        try:
            a = to_host(v)
        except Exception:  # noqa: BLE001 — not coercible, skipped
            continue
        if a.dtype != object:
            out[k] = a
    buf = io.BytesIO()
    np.savez(buf, **out)
    return buf.getvalue()


def decode_arrays(payload: bytes) -> Dict[str, Any]:
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        out = {}
        for k in z.files:
            a = z[k]
            out[k] = a.item() if a.ndim == 0 else a
    return out


# ---------------------------------------------------------------------------
# HTTP transport
# ---------------------------------------------------------------------------


class HTTPInferenceServer:
    """Serve a model over HTTP (stdlib only).

        srv = HTTPInferenceServer(model, port=8080)
        srv.start()            # returns at once; .port is bound
        ...
        srv.shutdown()
    """

    def __init__(self, model, host: str = "0.0.0.0", port: int = 8080, max_batch: int = 0,
                 batch_window_ms: float = 5.0, model_name: str = ""):
        self.core = InferenceServer(model, max_batch=max_batch,
                                    batch_window_ms=batch_window_ms)
        self.model_name = model_name or type(model).__name__
        core = self.core
        name = self.model_name

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet by default
                pass

            def _send(self, code, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    body = json.dumps({"status": "ok", "model": name}).encode()
                    self._send(200, body, "application/json")
                elif self.path == "/stats":
                    self._send(200, json.dumps(core.stats()).encode(), "application/json")
                else:
                    self._send(404, b"{}", "application/json")

            def do_POST(self):
                if self.path != "/v1/predict":
                    self._send(404, b"{}", "application/json")
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    data = decode_arrays(self.rfile.read(n))
                    out = core.predict(data)
                    preds = {k: v for k, v in out.items() if k.startswith("pred_")}
                    self._send(200, encode_arrays(preds), "application/octet-stream")
                except Exception as exc:  # noqa: BLE001 — surfaces as a 400
                    body = json.dumps({"error": f"{type(exc).__name__}: {exc}"}).encode()
                    self._send(400, body, "application/json")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def serve_forever(self):
        self._httpd.serve_forever()

    def shutdown(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self.core.close()


def warmup_clip(num_frames: int = 2, hw=(64, 64)) -> Dict[str, Any]:
    """A small synthetic clip with the unified sample's full key set, pushed
    through the model before serving (the kernels' build, cuDNN's first
    use)."""
    from unigeo_tpu_torch.data.synthetic import SyntheticBoxDataset

    ds = SyntheticBoxDataset(clip_length=num_frames, clip_overlap=0, num_scenes=1,
                             frames_per_scene=num_frames, render_size=hw)
    return ds[0]
