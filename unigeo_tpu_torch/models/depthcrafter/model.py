"""DepthCrafter adapter: clip sample -> depth + normals.

Port of ``unigeo_tpu/models/depthcrafter/model.py``:

  input    images [Nf,3,H,W] 0..255 -> frames [Nf,H,W,3] 0..1 (host /255)
  infer    the staged pipeline, 5 Euler (or Heun) steps
  postproc mean over the decoded channels -> min-max over the whole clip ->
           depth = 1/(x + 0.1)
  output   backproject with the GT intrinsics -> 5x5 plane-fit normals ->
           flip y, z to OpenGL

The noise is drawn on the device from a ``torch.Generator`` seeded with
``seed``; ``forward`` also takes explicit draws (parity tests pass the JAX
package's).  A clip runs as one window (window == clip, as the eval configs
run it) unless ``window_size`` is shorter than it: then it runs as the
pipeline's crossfaded windows (``DepthCrafterPipeline.__call__``).
``forward_batch`` scores equally-shaped clips with one batched denoise
(``clips_per_step`` at a time, through the evaluator's ``eval_batch_size``);
given a ``mesh`` whose dp dim is above 1 it is an SPMD entry point instead:
every rank calls it with the same clips, and ``parallel/executor.py``'s
``ShardedClipExecutor`` runs one clip a dp rank and gathers them.  The
decoded frames stay on the device into the post-processing on every path.

The constructor takes the JAX adapter's keywords, so a config's
``model_params`` build it (registered as ``DepthCrafter``).  Without a
``pipeline`` it builds one at the given (default SVD-XT) configs, in bf16 on
``device``, with the weights of ``checkpoint_path`` (the {"unet", "vae",
"clip"} layout of ``utils/checkpoint.py``) or random ones made there from a
generator seeded with ``seed``; ``solver`` is that pipeline's (a given
pipeline keeps its own, as in the JAX package, and takes the checkpoint's
weights when a path is given).  What is not ported raises, naming its ROADMAP item,
instead of doing something else.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from unigeo_tpu_torch.models.depthcrafter.pipeline import (
    DepthCrafterPipeline,
    adapter_pipeline,
)
from unigeo_tpu_torch.models.depthcrafter.scheduler import SOLVERS, EulerDiscreteConfig
from unigeo_tpu_torch.ops.backproject import backproject_to_cv_position
from unigeo_tpu_torch.parallel.executor import DataParallelAdapter
from unigeo_tpu_torch.ops.normals import surface_normals_from_points
from unigeo_tpu_torch.registry import MODELS


def minmax_inverse_depth(decoded: torch.Tensor) -> torch.Tensor:
    """decoded [Nf,H,W,3] 0..1 -> depths [Nf,H,W]: the channel mean, min-max
    over the whole clip, depth = 1/(x + 0.1)."""
    res = decoded.float().mean(dim=-1)
    rmin, rmax = res.min(), res.max()
    res = (res - rmin) / torch.clamp(rmax - rmin, min=1e-8)
    return 1.0 / (res + 0.1)


def normals_from_depths(depths: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """depths [Nf,H,W] + K [Nf,3,3] -> OpenGL normals [Nf,H,W,3]: backproject,
    5x5 plane fit, flip y and z."""
    normals_cv = surface_normals_from_points(backproject_to_cv_position(depths,
                                                                        intrinsics.float()))
    return normals_cv * torch.tensor([1.0, -1.0, -1.0], device=normals_cv.device)


def _postprocess(decoded: torch.Tensor, intrinsics: torch.Tensor):
    """decoded [Nf,H,W,3] 0..1 -> (depths [Nf,H,W], normals_gl [Nf,H,W,3])."""
    depths = minmax_inverse_depth(decoded)
    return depths, normals_from_depths(depths, intrinsics)


def intrinsics_of(data: Dict[str, Any], device) -> torch.Tensor:
    """data["intrinsics"] as an f32 tensor [Nf,3,3] on ``device``."""
    return torch.from_numpy(np.asarray(data["intrinsics"], np.float32)).to(device)


def scheduler_config_of(cfg) -> Optional[EulerDiscreteConfig]:
    """None, an ``EulerDiscreteConfig``, a dict or the path of a diffusers
    ``scheduler_config.json`` (unknown keys ignored, missing keys at the SVD
    defaults), as the JAX pipeline takes it."""
    if cfg is None or isinstance(cfg, EulerDiscreteConfig):
        return cfg
    if not isinstance(cfg, dict):
        with open(cfg) as f:
            cfg = json.load(f)
    fields = {f.name for f in dataclasses.fields(EulerDiscreteConfig)}
    return EulerDiscreteConfig(**{k: v for k, v in cfg.items() if k in fields})


@MODELS.register("DepthCrafter")
class DepthCrafter(DataParallelAdapter):
    def __init__(
        self,
        pipeline: Optional[DepthCrafterPipeline] = None,
        num_inference_steps: int = 5,
        seed: int = 42,
        unet_config: Optional[Dict[str, Any]] = None,
        vae_config: Optional[Dict[str, Any]] = None,
        clip_config: Optional[Dict[str, Any]] = None,
        checkpoint_path: Optional[str] = None,
        overlap: int = 25,
        window_size: Optional[int] = None,
        init_height: int = 384,
        init_width: int = 512,
        init_frames: int = 25,
        scheduler_config: Optional[Any] = None,
        solver: str = "euler",
        clips_per_step: int = 1,
        mesh=None,
        # reference-config keys, accepted and ignored as the JAX adapter does
        model_dir: Optional[str] = None,
        unet_path: Optional[str] = None,
        pre_train_path: Optional[str] = None,
        device="cuda",
        **_: Dict,
    ):
        """The JAX adapter's keywords (``unigeo_tpu/models/depthcrafter/model.py``),
        plus the ``device`` of a pipeline built here (in bf16, as the JAX
        adapter builds it).  ``init_*`` size the JAX package's parameter
        init; the port's random weights do not depend on them.  ``mesh``: a
        ``parallel.mesh.make_mesh`` mesh; with dp > 1, ``forward_batch``
        runs over its dp ranks."""
        if solver not in SOLVERS:
            raise ValueError(f"unknown solver {solver!r}")
        kwargs = {} if pipeline is not None else dict(
            scheduler_config=scheduler_config_of(scheduler_config), solver=solver)
        self.pipeline = adapter_pipeline(pipeline, checkpoint_path, unet_config, vae_config,
                                         clip_config, seed=seed, device=device, **kwargs)
        self.num_inference_steps = num_inference_steps
        self.overlap = overlap
        self.window_size = window_size
        self.seed = seed
        # clips per batched denoise on one GPU (the evaluator's batch)
        self.clips_per_step = max(1, clips_per_step)
        self.mesh = mesh
        self.last_stage_ms: Dict[str, float] = {}

    @property
    def eval_batch_size(self) -> int:
        """Clips the evaluator hands to ``forward_batch`` at once: the dp
        width on a mesh with dp > 1, else ``clips_per_step``.  (Under an eval
        over several processes each rank scores its own clips on its own
        device, so this stays per rank.)"""
        return self.dp_size if self.dp_size > 1 else self.clips_per_step

    def forward(self, data: Dict[str, Any], noise=None, aug_noise=None,
                time_stages: bool = False) -> Dict[str, Any]:
        """Score-ready predictions for one clip.

        noise [T,h,w,4] / aug_noise [T,H,W,3]: explicit draws; when ``noise``
        is None both are drawn from a generator seeded with ``self.seed``.
        A clip longer than ``window_size`` ignores them: each window draws
        from ``pipeline.window_generator(self.seed, wi)``.
        time_stages: record each stage's ms in ``self.last_stage_ms`` (the
        whole-clip window only).
        """
        images = np.asarray(data["images"])
        t, h, w = images.shape[0], images.shape[2], images.shape[3]
        pipe = self.pipeline
        frames = pipe.prepare_clip(images)
        if self.window_size and self.window_size < t:
            decoded = pipe(frames, num_inference_steps=self.num_inference_steps,
                           window_size=self.window_size, overlap=self.overlap, seed=self.seed)
            return self._finalize(decoded, data)
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
        return self._finalize((out + 1.0) / 2.0, data)

    def _finalize(self, decoded: torch.Tensor, data: Dict[str, Any]) -> Dict[str, Any]:
        """decoded [T,H,W,3] 0..1 on the device -> host depths and normals."""
        depths, normals = _postprocess(decoded, intrinsics_of(data, decoded.device))
        return {
            "pred_depths": depths.cpu().numpy(),
            "pred_normals": normals.cpu().numpy(),
        }

    def forward_batch(self, datas, noise=None, aug_noise=None) -> List[Dict[str, Any]]:
        """Score a list of clips; equally-shaped whole-clip windows go through
        one batched denoise (``pipeline.run_clips_staged``).

        Clips of different shapes, and clips longer than ``window_size``, take
        the serial ``forward``, as in the JAX package.  Every clip gets the
        draws the serial path makes (one generator seeded with ``seed``, or
        the explicit noise [T,h,w,4] / aug_noise [T,H,W,3]), broadcast over
        the batch.  On a mesh with dp > 1 (every rank calling with the same
        clips) the clips go through ``ShardedClipExecutor``, one a dp rank.
        """
        images = [np.asarray(d["images"]) for d in datas]
        if len({im.shape for im in images}) > 1:
            return [self.forward(d) for d in datas]
        t, h, w = images[0].shape[0], images[0].shape[2], images[0].shape[3]
        if self.window_size and self.window_size < t:
            return [self.forward(d) for d in datas]
        pipe = self.pipeline
        frames = torch.stack([pipe.prepare_clip(im) for im in images])
        if noise is None:
            gen = torch.Generator(device=pipe.device).manual_seed(self.seed)
            noise, aug_noise = pipe.draw_clip_noise(gen, t, h, w)
        b = len(datas)
        noise = torch.as_tensor(noise).to(pipe.device).expand(b, *noise.shape)
        if aug_noise is not None:
            aug_noise = torch.as_tensor(aug_noise).to(pipe.device).expand(b, *aug_noise.shape)
        if self.dp_size > 1:
            decoded = self._get_executor()(frames, noise=noise, aug_noise=aug_noise)
            return [self._finalize(decoded[i], d) for i, d in enumerate(datas)]
        out = pipe.run_clips_staged(frames, noise, self.num_inference_steps, aug_noise=aug_noise)
        return [self._finalize((out[i] + 1.0) / 2.0, d) for i, d in enumerate(datas)]
