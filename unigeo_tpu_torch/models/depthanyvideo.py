"""DepthAnyVideo-class hierarchical video-diffusion depth, port of
``unigeo_tpu/models/depthanyvideo.py``.

Key frames are every ``keyframe_gap``-th frame plus the last.  Phase 1
denoises the key frames alone (a plain denoise of their own clip); phase 2
denoises the whole clip with the key frames clamped to their phase-1
latents (``pipeline._denoise_stage_known``), so the frames between are
interpolated inside the diffusion.  One decode, then ChronoDepth's
``_postprocess``.  The phases draw from ``pipeline.window_generator(seed,
0)`` and ``(seed, 1)``; ``forward`` also takes the draws.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from unigeo_tpu_torch.models.chronodepth import (
    DTYPES,
    _postprocess,
    draw_latent_noise,
    to_output,
)
from unigeo_tpu_torch.models.depthcrafter.model import intrinsics_of
from unigeo_tpu_torch.models.depthcrafter.pipeline import (
    DepthCrafterPipeline,
    adapter_pipeline,
)
from unigeo_tpu_torch.registry import MODELS


@MODELS.register("DepthAnyVideo")
class DepthAnyVideo:
    def __init__(
        self,
        unet_config: Optional[Dict[str, Any]] = None,
        vae_config: Optional[Dict[str, Any]] = None,
        clip_config: Optional[Dict[str, Any]] = None,
        checkpoint_path: Optional[str] = None,
        num_inference_steps: int = 5,
        keyframe_gap: int = 4,
        seed: int = 42,
        dtype: str = "bfloat16",
        _pipeline: Optional[DepthCrafterPipeline] = None,
        unet_path: Optional[str] = None,
        pre_train_path: Optional[str] = None,
        device="cuda",
        **_: Dict,
    ):
        self.pipe = adapter_pipeline(_pipeline, checkpoint_path, unet_config, vae_config,
                                     clip_config, seed=0, dtype=DTYPES[dtype], device=device)
        self.num_inference_steps = num_inference_steps
        self.keyframe_gap = max(1, keyframe_gap)
        self.seed = seed

    def keyframe_indices(self, t: int) -> np.ndarray:
        """Every k-th frame, always including the last."""
        idx = list(range(0, t, self.keyframe_gap))
        if idx[-1] != t - 1:
            idx.append(t - 1)
        return np.asarray(idx)

    def forward(self, data: Dict[str, Any], key_noise=None, clip_noise=None) -> Dict[str, Any]:
        """key_noise [K, h/8, w/8, 4] / clip_noise [T, h/8, w/8, 4]: the two
        phases' draws (from windows 0 and 1 of the seed when None)."""
        pipe = self.pipe
        images = np.asarray(data["images"])
        t, h, w = images.shape[0], images.shape[2], images.shape[3]
        key_idx = torch.from_numpy(self.keyframe_indices(t))
        frames = pipe.prepare_clip(images).permute(0, 3, 1, 2)  # [T,3,H,W]
        nchw = lambda a: torch.as_tensor(a).to(pipe.device).permute(0, 3, 1, 2)

        cond_k, ctx_k = pipe._encode_stage(frames[key_idx.to(pipe.device)], None)
        if key_noise is None:
            key_noise = draw_latent_noise(pipe, pipe.window_generator(self.seed, 0),
                                          len(key_idx), h, w)
        lat_k = pipe._denoise_loop(cond_k[None], ctx_k[None], nchw(key_noise)[None],
                                   self.num_inference_steps)[0]
        if len(key_idx) == t:
            lat = lat_k  # every frame is a key frame: one level
        else:
            cond, ctx = pipe._encode_stage(frames, None)
            if clip_noise is None:
                clip_noise = draw_latent_noise(pipe, pipe.window_generator(self.seed, 1), t, h, w)
            known = torch.zeros((t, 4, h // 8, w // 8), dtype=torch.float32, device=pipe.device)
            known[key_idx.to(pipe.device)] = lat_k
            mask = torch.zeros(t)
            mask[key_idx] = 1.0
            lat = pipe._denoise_stage_known(cond, ctx, nchw(clip_noise), known, mask,
                                            self.num_inference_steps)
        decoded = (pipe._decode_stage(lat).permute(0, 2, 3, 1) + 1.0) / 2.0
        return to_output(*_postprocess(decoded, intrinsics_of(data, pipe.device)))
