"""ChronoDepth-class SVD video depth with sequential in-context windows,
port of ``unigeo_tpu/models/chronodepth.py``.

Windows of ``window_size`` frames start every ``window_size - overlap``
frames (``range(0, max(t - ov, 1), stride)``, the last moved back to end at
the clip's end).  Each is encoded without aug noise and denoised by
``pipeline._denoise_stage_known`` with its first ``prev_end - start`` frames
clamped to the f32 latents the earlier windows left, so those come out
unchanged and the new frames are denoised in their context.  One temporal
decode runs over the whole clip; depth is the decoded (x + 1) / 2 channel
mean clipped at 1e-3 (affine-invariant), normals backproject it with the GT
intrinsics (``_postprocess``, shared with DepthAnyVideo).

Window ``wi`` draws its N(0, 1) noise from ``pipeline.window_generator(seed,
wi)``; ``forward`` also takes the draws (parity tests pass the JAX
package's ``fold_in(rng, wi)`` ones).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from unigeo_tpu_torch.models.depthcrafter.model import intrinsics_of, normals_from_depths
from unigeo_tpu_torch.models.depthcrafter.pipeline import (
    DepthCrafterPipeline,
    adapter_pipeline,
)
from unigeo_tpu_torch.registry import MODELS

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _postprocess(decoded: torch.Tensor, intrinsics: torch.Tensor):
    """decoded [Nf,H,W,3] 0..1 -> (depths = clip(channel mean, 1e-3),
    OpenGL normals)."""
    depths = decoded.float().mean(dim=-1).clamp_min(1e-3)
    return depths, normals_from_depths(depths, intrinsics)


def draw_latent_noise(pipe: DepthCrafterPipeline, generator: torch.Generator,
                      t: int, h: int, w: int) -> torch.Tensor:
    """N(0, 1) latent noise [t, h/8, w/8, 4] f32 on the pipeline's device."""
    return torch.randn((t, h // 8, w // 8, 4), generator=generator, device=pipe.device)


def to_output(depths: torch.Tensor, normals: torch.Tensor) -> Dict[str, Any]:
    return {"pred_depths": depths.cpu().numpy(), "pred_normals": normals.cpu().numpy()}


@MODELS.register("ChronoDepth")
class ChronoDepth:
    def __init__(
        self,
        unet_config: Optional[Dict[str, Any]] = None,
        vae_config: Optional[Dict[str, Any]] = None,
        clip_config: Optional[Dict[str, Any]] = None,
        checkpoint_path: Optional[str] = None,
        num_inference_steps: int = 5,
        window_size: Optional[int] = None,
        overlap: int = 5,
        seed: int = 42,
        dtype: str = "bfloat16",
        _pipeline: Optional[DepthCrafterPipeline] = None,
        unet_path: Optional[str] = None,
        pre_train_path: Optional[str] = None,
        device="cuda",
        **_: Dict,
    ):
        """The JAX adapter's keywords (a given ``_pipeline`` is used as it is)
        and the ``device`` of a pipeline built here (in ``dtype``, random
        weights from seed 0 as the JAX adapter's lazy init)."""
        self.pipe = adapter_pipeline(_pipeline, checkpoint_path, unet_config, vae_config,
                                     clip_config, seed=0, dtype=DTYPES[dtype], device=device)
        self.num_inference_steps = num_inference_steps
        self.window_size = window_size
        self.overlap = overlap
        self.seed = seed

    def forward(self, data: Dict[str, Any],
                window_noise: Optional[Sequence[Any]] = None) -> Dict[str, Any]:
        """window_noise: each window's noise [win, h/8, w/8, 4] (drawn from
        ``window_generator(seed, wi)`` when None)."""
        pipe = self.pipe
        images = np.asarray(data["images"])
        t, h, w = images.shape[0], images.shape[2], images.shape[3]
        win = min(self.window_size or t, t)
        ov = min(self.overlap, win - 1) if win < t else 0
        frames = pipe.prepare_clip(images).permute(0, 3, 1, 2)  # [T,3,H,W]
        lat = torch.zeros((t, 4, h // 8, w // 8), dtype=torch.float32, device=pipe.device)
        prev_end = 0
        for wi, start in enumerate(range(0, max(t - ov, 1), win - ov)):
            end = min(start + win, t)
            start = end - win  # full windows only (the last one re-covers)
            cond, ctx = pipe._encode_stage(frames[start:end], None)
            noise = (draw_latent_noise(pipe, pipe.window_generator(self.seed, wi), win, h, w)
                     if window_noise is None else torch.as_tensor(window_noise[wi]))
            n_known = max(prev_end - start, 0) if wi > 0 else 0
            mask = (torch.arange(win) < n_known).float()
            lat[start:end] = pipe._denoise_stage_known(
                cond, ctx, noise.to(pipe.device).permute(0, 3, 1, 2), lat[start:end], mask,
                self.num_inference_steps)
            prev_end = end
        decoded = (pipe._decode_stage(lat).permute(0, 2, 3, 1) + 1.0) / 2.0
        return to_output(*_postprocess(decoded, intrinsics_of(data, pipe.device)))
