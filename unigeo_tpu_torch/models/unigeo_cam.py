"""UniGeoCam: the paper's unified video-geometry model, port of
``unigeo_tpu/models/unigeo_cam.py`` (registered as ``UniGeoCam`` and
``UniGeo``).

One pass of the SVD pipeline over the clip (``pipeline(...)``: one window,
the crossfaded windows past ``window_size``) decodes a geometry triplet:

  depth    channel mean -> clip min-max -> 1 / (x + 0.1)
  normals  the triplet as x * 2 - 1, x flipped, unit-normalised

With ``geometry_branch`` the Spann3R pointmap network runs on the same clip
and the model emits all four families: the diffusion depth aligned to the
pointmap depth by least squares (``lstsq_scale_shift``; no valid pixel, a
non-finite fit or |s| < 1e-8 keeps s, t = 1, 0), clamped at 1e-3,
backprojected with the GT intrinsics and carried into the pointmap's world
frame by its c2w poses.  Without it, depth and normals only (per-frame
backprojections would give identity poses by construction).

The noise is one draw from a generator seeded with ``seed`` (``forward``
takes explicit draws too).  The pipeline is built in bf16 on ``device`` when
none is given; the pointmap branch computes in f32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from unigeo_tpu_torch.metrics.alignment import lstsq_scale_shift
from unigeo_tpu_torch.models.depthcrafter.model import intrinsics_of, minmax_inverse_depth
from unigeo_tpu_torch.models.depthcrafter.pipeline import (
    DepthCrafterPipeline,
    adapter_pipeline,
)
from unigeo_tpu_torch.models.stablenormal import normals_from_decoded
from unigeo_tpu_torch.ops.backproject import backproject_to_cv_position
from unigeo_tpu_torch.registry import MODELS


@MODELS.register("UniGeoCam")
@MODELS.register("UniGeo")
class UniGeoCam:
    def __init__(
        self,
        unet_config: Optional[Dict[str, Any]] = None,
        vae_config: Optional[Dict[str, Any]] = None,
        clip_config: Optional[Dict[str, Any]] = None,
        checkpoint_path: Optional[str] = None,
        num_inference_steps: int = 5,
        seed: int = 42,
        init_height: int = 384,
        init_width: int = 512,
        init_frames: int = 25,
        pipeline: Optional[DepthCrafterPipeline] = None,
        geometry_branch: bool = False,
        pointmap_config: Optional[Dict[str, Any]] = None,
        pointmap_checkpoint: Optional[str] = None,
        pointmap_model=None,
        device="cuda",
        **_: Dict,
    ):
        """The JAX adapter's keywords and the ``device`` of the pipeline and
        pointmap network built here (random weights from ``seed``, and seed
        0 for the network, as the JAX adapter's)."""
        self.pipeline = adapter_pipeline(pipeline, checkpoint_path, unet_config, vae_config,
                                         clip_config, seed=seed, device=device)
        self.num_inference_steps = num_inference_steps
        self.seed = seed
        self.pointmap = None
        if geometry_branch:
            from unigeo_tpu_torch.models.pointmap.spann3r import Spann3R

            self.pointmap = pointmap_model or Spann3R(
                network_config=pointmap_config, checkpoint_path=pointmap_checkpoint,
                device=self.pipeline.device)

    def forward(self, data: Dict[str, Any], noise=None, aug_noise=None) -> Dict[str, Any]:
        """noise [T,h,w,4] / aug_noise [T,H,W,3]: the clip's draws (from a
        generator seeded with ``seed`` when ``noise`` is None)."""
        pipe = self.pipeline
        frames = pipe.prepare_clip(data["images"])
        draws = None if noise is None else [(noise, aug_noise)]
        decoded = pipe(frames, num_inference_steps=self.num_inference_steps, seed=self.seed,
                       window_noise=draws)  # [T,H,W,3] 0..1
        depths = minmax_inverse_depth(decoded)
        out = {"pred_depths": depths, "pred_normals": normals_from_decoded(decoded)}
        if self.pointmap is not None:
            out.update(self._geometry_branch(data, depths))
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _geometry_branch(self, data: Dict[str, Any], depths: torch.Tensor):
        """The pointmap branch's world frame for the diffusion depth, on the
        device (unigeo_cam.py:126-172 of the JAX package)."""
        pm = self.pointmap.forward_tensors(data)
        pm_depth = pm["pred_depths"].float().to(depths.device)
        valid = pm_depth > 1e-6
        s, t = (float(v) for v in lstsq_scale_shift(depths, pm_depth, valid))
        # degenerate fit: no valid pointmap depth, a non-finite fit, or s
        # about 0 (every pixel on the clamp) keep the raw diffusion depth; a
        # negative s is the least-squares optimum and stays
        if int(valid.sum()) == 0 or not (math.isfinite(s) and math.isfinite(t)) or abs(s) < 1e-8:
            s, t = 1.0, 0.0
        aligned = (s * depths + t).clamp_min(1e-3)
        cam = backproject_to_cv_position(aligned, intrinsics_of(data, depths.device))
        poses = pm["pred_poses"].float().to(depths.device)  # c2w, OpenCV
        # R p + t elementwise (3-term sums in f32 whatever the TF32 flags)
        world = ((poses[:, None, None, :3, :3] * cam[..., None, :]).sum(-1)
                 + poses[:, None, None, :3, 3])
        return {"pred_depths": aligned, "pred_world_pts": world, "pred_poses": poses}
