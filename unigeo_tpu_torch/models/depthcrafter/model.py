"""DepthCrafter adapter: clip sample -> depth + normals.

Port of ``unigeo_tpu/models/depthcrafter/model.py`` on the whole-clip path
(window == clip):

  input    images [Nf,3,H,W] 0..255 -> frames [Nf,H,W,3] 0..1 (host /255)
  infer    the staged pipeline, 5 Euler steps
  postproc mean over the decoded channels -> min-max over the whole clip ->
           depth = 1/(x + 0.1)
  output   backproject with the GT intrinsics -> 5x5 plane-fit normals ->
           flip y, z to OpenGL

The noise is drawn on the device from a ``torch.Generator`` seeded with
``seed``; ``forward`` also takes explicit draws (parity tests pass the JAX
package's).  Every clip runs as one window (window == clip, as the eval
configs run it); windowed clips and ``forward_batch`` are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from unigeo_tpu_torch.models.depthcrafter.pipeline import DepthCrafterPipeline
from unigeo_tpu_torch.ops.backproject import backproject_to_cv_position
from unigeo_tpu_torch.ops.normals import surface_normals_from_points


def _postprocess(decoded: torch.Tensor, intrinsics: torch.Tensor):
    """decoded [Nf,H,W,3] 0..1 -> (depths [Nf,H,W], normals_gl [Nf,H,W,3])."""
    res = decoded.float().mean(dim=-1)
    rmin, rmax = res.min(), res.max()
    res = (res - rmin) / torch.clamp(rmax - rmin, min=1e-8)
    depths = 1.0 / (res + 0.1)
    pts = backproject_to_cv_position(depths, intrinsics.float())
    normals_cv = surface_normals_from_points(pts)
    sign = torch.tensor([1.0, -1.0, -1.0], device=normals_cv.device)
    return depths, normals_cv * sign


class DepthCrafter:
    def __init__(
        self,
        pipeline: DepthCrafterPipeline,
        num_inference_steps: int = 5,
        seed: int = 42,
    ):
        self.pipeline = pipeline
        self.num_inference_steps = num_inference_steps
        self.seed = seed
        self.last_stage_ms: Dict[str, float] = {}

    def forward(self, data: Dict[str, Any], noise=None, aug_noise=None,
                time_stages: bool = False) -> Dict[str, Any]:
        """Score-ready predictions for one clip.

        noise [T,h,w,4] / aug_noise [T,H,W,3]: explicit draws; when ``noise``
        is None both are drawn from a generator seeded with ``self.seed``.
        time_stages: record each stage's ms in ``self.last_stage_ms``.
        """
        images = np.asarray(data["images"])
        t, h, w = images.shape[0], images.shape[2], images.shape[3]
        pipe = self.pipeline
        frames = pipe.prepare_clip(images)
        if noise is None:
            gen = torch.Generator(device=pipe.device).manual_seed(self.seed)
            noise, aug_noise = pipe.draw_clip_noise(gen, t, h, w)
        stage_ms: Optional[Dict[str, float]] = {} if time_stages else None
        out = pipe.run_window_staged(
            frames, torch.as_tensor(noise), self.num_inference_steps,
            aug_noise=None if aug_noise is None else torch.as_tensor(aug_noise),
            stage_ms=stage_ms,
        )
        if stage_ms is not None:
            self.last_stage_ms = stage_ms
        intrinsics = torch.from_numpy(np.asarray(data["intrinsics"], np.float32)).to(pipe.device)
        depths, normals = _postprocess((out + 1.0) / 2.0, intrinsics)
        return {
            "pred_depths": depths.cpu().numpy(),
            "pred_normals": normals.cpu().numpy(),
        }
