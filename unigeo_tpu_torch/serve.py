"""Serve a model of the port for online inference, the counterpart of the
repository's ``serve.py``:

    python -m unigeo_tpu_torch.serve --config configs/depthcrafter_scannetpp.yaml --port 8080
    python -m unigeo_tpu_torch.serve --model IdentityModel --device cpu --port 0

Endpoints:
    POST /v1/predict   body: npz of the unified sample arrays
                       (images [Nf,3,H,W] f32 0..255, intrinsics [Nf,3,3],
                       plus whatever else the model consumes)
                       -> npz of the model's pred_* arrays
    GET  /healthz      liveness
    GET  /stats        latency percentiles / batch sizes / queue depth

The model runs on ``--device`` (default ``cuda``; a missing card is an
error, the CPU only when asked for), built from the port's registry with
that device, as ``python -m unigeo_tpu_torch.eval`` builds it.  Requests are
micro-batched onto the model's ``forward_batch`` (when it has one; on the
card DepthCrafter's batched denoise, ``clips_per_step`` clips a batch unless
``--max-batch`` says otherwise) inside a short window.  A warmup clip runs
before the socket opens, which on the card pays for the kernels' build and
cuDNN's first use.  The bound port is printed (``--port 0`` picks a free
one).

Example client:

    import numpy as np, urllib.request, io
    buf = io.BytesIO(); np.savez(buf, images=imgs, intrinsics=K)
    req = urllib.request.Request("http://host:8080/v1/predict",
                                 data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req) as r:
        preds = dict(np.load(io.BytesIO(r.read())))
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", help="experiment YAML (its model block is used)")
    ap.add_argument("--model", help="registered model name (overrides the config)")
    ap.add_argument("--params", default="{}", help="JSON model_params (with --model)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-batch", type=int, default=0,
                    help="0 = the model's own eval_batch_size")
    ap.add_argument("--batch-window-ms", type=float, default=5.0)
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--warmup-frames", type=int, default=2)
    ap.add_argument("--warmup-hw", type=int, nargs=2, default=(64, 64))
    ap.add_argument("--device", default="cuda", help="the model's device (cuda or cpu)")
    args = ap.parse_args(argv)
    if not (args.model or args.config):
        ap.error("need --config or --model")
    return args


def build_server(args: argparse.Namespace):
    """The model named by ``args`` on its device, warmed up, behind an
    ``HTTPInferenceServer`` bound to its port (not yet serving)."""
    from unigeo_tpu_torch.device import resolve_device
    from unigeo_tpu_torch.registry import get_model_cls
    from unigeo_tpu_torch.serving import HTTPInferenceServer, warmup_clip

    resolve_device(args.device)
    if args.model:
        name, params = args.model, json.loads(args.params)
    else:
        from unigeo_tpu_torch.config import EvalConfig

        cfg = EvalConfig.from_yaml(args.config)
        name, params = cfg.model_name, cfg.model_params
    print(f"loading model {name} on {args.device} ...", flush=True)
    model = get_model_cls(name)(**{**params, "device": args.device})
    if not args.no_warmup:
        print(f"warmup: {args.warmup_frames} frames @ {tuple(args.warmup_hw)}", flush=True)
        import torch

        with torch.inference_mode():
            model.forward(warmup_clip(args.warmup_frames, tuple(args.warmup_hw)))
    return HTTPInferenceServer(model, host=args.host, port=args.port,
                               max_batch=args.max_batch,
                               batch_window_ms=args.batch_window_ms, model_name=name)


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    srv = build_server(args)
    print(f"serving {srv.model_name} on http://{args.host}:{srv.port}  "
          "(POST /v1/predict, GET /healthz, GET /stats)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
        sys.exit(0)


if __name__ == "__main__":
    main()
