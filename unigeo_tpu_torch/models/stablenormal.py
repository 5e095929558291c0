"""StableNormal-class diffusion normal estimator, port of
``unigeo_tpu/models/stablenormal.py``.

Every frame is an independent T = 1 sample on the SVD stack: all N frames
are encoded at once, denoised as one batch of N clips of one frame, and
decoded with ``num_frames = 1`` (``pipeline._decode_frames``), so no frame
sees another.  The per-image reference re-seeds for every image, so every
frame gets the same draw: one [1, h, w, 4] noise and one [1, H, W, 3] aug
draw, broadcast over the frames.  The decoded map is the normal as
(x * 2 - 1) with x flipped and unit-normalised; ``pred_depths`` is zeros
(the model predicts normals only).

``forward_batch`` concatenates the clips' frames (only H and W must agree).
On one GPU ``eval_batch_size`` is 1.  Given a ``mesh`` whose dp dim is above
1, ``_run_frames_dp`` runs the N frames as N clips of T = 1 through
``parallel/executor.py``'s ``ShardedClipExecutor`` (an SPMD entry point:
every rank calls it with the same frames), and ``eval_batch_size`` is the dp
width.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from unigeo_tpu_torch.models.depthcrafter.pipeline import (
    DepthCrafterPipeline,
    adapter_pipeline,
)
from unigeo_tpu_torch.parallel.executor import DataParallelAdapter
from unigeo_tpu_torch.registry import MODELS


def normals_from_decoded(decoded: torch.Tensor) -> torch.Tensor:
    """decoded [N,H,W,3] in 0..1 -> unit normals (x * 2 - 1, x flipped)."""
    normals = decoded.float() * 2.0 - 1.0
    normals = normals * torch.tensor([-1.0, 1.0, 1.0], device=normals.device)
    return normals / torch.linalg.vector_norm(normals, dim=-1, keepdim=True).clamp_min(1e-6)


@MODELS.register("StableNormal")
class StableNormal(DataParallelAdapter):
    def __init__(
        self,
        unet_config: Optional[Dict[str, Any]] = None,
        vae_config: Optional[Dict[str, Any]] = None,
        clip_config: Optional[Dict[str, Any]] = None,
        checkpoint_path: Optional[str] = None,
        num_inference_steps: int = 4,
        seed: int = 7,
        init_height: int = 384,
        init_width: int = 512,
        model_dir: Optional[str] = None,
        pipeline: Optional[DepthCrafterPipeline] = None,
        device="cuda",
        mesh=None,
        **_: Dict,
    ):
        """The JAX adapter's keywords, the ``device`` of a pipeline built
        here (bf16, random weights from ``seed``) and a ``mesh``
        (``parallel.mesh.make_mesh``) whose dp ranks share the frames."""
        self.pipeline = adapter_pipeline(pipeline, checkpoint_path, unet_config, vae_config,
                                         clip_config, seed=seed, device=device)
        self.num_inference_steps = num_inference_steps
        self.seed = seed
        self.mesh = mesh

    @property
    def eval_batch_size(self) -> int:
        return self.dp_size

    def frame_noise(self, h: int, w: int):
        """(noise [1,h/8,w/8,4], aug [1,H,W,3] or None): the one draw every
        frame shares, from a generator seeded with ``seed``."""
        gen = torch.Generator(device=self.pipeline.device).manual_seed(self.seed)
        return self.pipeline.draw_clip_noise(gen, 1, h, w)

    def _run_frames(self, frames: torch.Tensor, noise=None, aug_noise=None) -> torch.Tensor:
        """frames [N,H,W,3] 0..1 -> decoded [N,H,W,3] 0..1, N independent frames.
        noise [1,h,w,4] / aug_noise [1,H,W,3]: the shared draw (drawn here
        when ``noise`` is None).  Over the mesh's dp ranks when dp > 1."""
        if self.dp_size > 1:
            return self._run_frames_dp(frames, noise, aug_noise)
        return self._run_frames_single(frames, noise, aug_noise)

    def _run_frames_dp(self, frames: torch.Tensor, noise=None, aug_noise=None) -> torch.Tensor:
        """The N frames as N clips of T = 1 through ``ShardedClipExecutor``,
        each with the shared draw (JAX ``stablenormal.py:107-124``)."""
        n, h, w, _ = frames.shape
        if noise is None:
            noise, aug_noise = self.frame_noise(h, w)
        dev = self.pipeline.device
        noise = torch.as_tensor(noise).to(dev)[None].expand(n, -1, -1, -1, -1)
        if aug_noise is not None:
            aug_noise = torch.as_tensor(aug_noise).to(dev)[None].expand(n, -1, -1, -1, -1)
        decoded = self._get_executor()(frames[:, None], noise=noise, aug_noise=aug_noise)
        return decoded[:, 0]

    def _run_frames_single(self, frames: torch.Tensor, noise=None, aug_noise=None):
        pipe = self.pipeline
        n, h, w, _ = frames.shape
        if noise is None:
            noise, aug_noise = self.frame_noise(h, w)
        nchw = lambda a: torch.as_tensor(a).to(pipe.device).permute(0, 3, 1, 2)
        aug = None if aug_noise is None else nchw(aug_noise).expand(n, -1, -1, -1)
        cond, ctx = pipe._encode_stage(nchw(frames), aug)
        noise = nchw(noise)[None].expand(n, -1, -1, -1, -1)  # [N, 1, 4, h, w]
        x = pipe._denoise_loop(cond[:, None], ctx[:, None], noise, self.num_inference_steps)
        decoded = pipe._decode_frames(x[:, 0])
        return (decoded.permute(0, 2, 3, 1) + 1.0) / 2.0

    def _finalize(self, decoded: torch.Tensor) -> Dict[str, Any]:
        nf, h, w, _ = decoded.shape
        return {"pred_normals": normals_from_decoded(decoded).cpu().numpy(),
                "pred_depths": np.zeros((nf, h, w), np.float32)}

    def forward(self, data: Dict[str, Any], noise=None, aug_noise=None) -> Dict[str, Any]:
        frames = self.pipeline.prepare_clip(data["images"])
        return self._finalize(self._run_frames(frames, noise, aug_noise))

    def forward_batch(self, datas, noise=None, aug_noise=None) -> List[Dict[str, Any]]:
        """Every frame of every clip is an independent sample, so clips of
        one H and W concatenate on the frame axis into one pass."""
        frames = [self.pipeline.prepare_clip(d["images"]) for d in datas]
        if len({tuple(f.shape[1:]) for f in frames}) > 1:
            return [self._finalize(self._run_frames(f, noise, aug_noise)) for f in frames]
        decoded = self._run_frames(torch.cat(frames), noise, aug_noise)
        outs, off = [], 0
        for f in frames:
            outs.append(self._finalize(decoded[off:off + len(f)]))
            off += len(f)
        return outs
