"""Data-parallel clip executor, port of ``unigeo_tpu/parallel/executor.py``.

A batch of clips [B, T, H, W, 3] fans out over the mesh's ``dp`` dim: each
step takes ``dp`` clips, dp rank i runs clip i of the step through
``pipeline.run_clips_staged`` on its own device, and an all-gather over dp
gives every rank the whole [B, T, H, W, 3] in 0..1.  The last step is padded
by repeating the last clip, and the padding is dropped after.  SPMD: every
rank calls it with the same arguments.  Ranks that differ only in sp (or tp)
run the same clip.

The JAX package's ``staged=False`` (one fused program a batch) has no
meaning without a compiler: the flag is taken and the same code runs.  With
tp > 1 the pipeline's UNet, VAE and CLIP are placed on the tp dim
(``sharding.parallelize``, in place, as JAX's executor places
``shard_params(pipeline.params)``) and every clip runs inside
``tensor_parallel``: the ranks that differ only in tp run the same clip,
each on its shards.
"""

from __future__ import annotations

import contextlib

import torch

from unigeo_tpu_torch.models.layers import tensor_parallel
from unigeo_tpu_torch.parallel.comm import all_gather
from unigeo_tpu_torch.parallel.mesh import axis_size


class ShardedClipExecutor:
    def __init__(self, pipeline, mesh, num_inference_steps: int = 5, staged: bool = True):
        self.pipeline = pipeline
        self.mesh = mesh
        self.num_inference_steps = num_inference_steps
        self.staged = staged
        dp = mesh["dp"]
        self.group, self.index = dp.get_group(), dp.get_local_rank()
        self.tp_group = None
        if axis_size(mesh, "tp") > 1:
            from unigeo_tpu_torch.parallel.sharding import parallelize

            for module in (pipeline.unet, pipeline.vae, pipeline.clip):
                parallelize(module, mesh)
            self.tp_group = mesh.get_group("tp")

    @property
    def batch_size(self) -> int:
        """Clips per step = size of the dp dim."""
        return axis_size(self.mesh, "dp")

    def __call__(self, frames_batch, seed: int = 42, noise=None, aug_noise=None) -> torch.Tensor:
        """[B, T, H, W, 3] 0..1 -> [B, T, H, W, 3] decoded 0..1 (f32, on the
        pipeline's device, on every rank).

        noise [B, T, h, w, 4] / aug_noise [B, T, H, W, 3]: explicit draws;
        when ``noise`` is None every clip gets the one draw the serial
        adapter makes (``draw_clip_noise`` from a generator seeded with
        ``seed``: the denoise noise, then the aug noise), so batched clips
        equal serial ones."""
        pipe = self.pipeline
        frames_batch = torch.as_tensor(frames_batch)
        b, t, h, w, _ = frames_batch.shape
        if noise is None:
            gen = torch.Generator(device=pipe.device).manual_seed(seed)
            noise1, aug1 = pipe.draw_clip_noise(gen, t, h, w)
            noise = noise1.expand(b, *noise1.shape)
            aug_noise = None if aug1 is None else aug1.expand(b, *aug1.shape)
        noise = torch.as_tensor(noise)
        aug_noise = None if aug_noise is None else torch.as_tensor(aug_noise)

        step, outs = self.batch_size, []
        for start in range(0, b, step):
            i = min(start + self.index, b - 1)  # past the end: the last clip again
            with (contextlib.nullcontext() if self.tp_group is None
                  else tensor_parallel(self.tp_group)):
                out = pipe.run_clips_staged(
                    frames_batch[i:i + 1], noise[i:i + 1], self.num_inference_steps,
                    aug_noise=None if aug_noise is None else aug_noise[i:i + 1])
            gathered = all_gather(out.contiguous(), self.group, dim=0)
            outs.append(gathered[:min(step, b - start)])
        return (torch.cat(outs) + 1.0) / 2.0


class DataParallelAdapter:
    """The dp path of the SVD-family adapters (DepthCrafter, StableNormal):
    given a ``mesh`` whose dp dim is above 1 (``self.mesh``), their batches
    go through one ``ShardedClipExecutor`` over ``self.pipeline``, built on
    first use (JAX ``model.py:158-167``)."""

    mesh = None
    _executor = None

    @property
    def dp_size(self) -> int:
        return 1 if self.mesh is None else axis_size(self.mesh, "dp")

    def _get_executor(self) -> ShardedClipExecutor:
        if self._executor is None:
            self._executor = ShardedClipExecutor(self.pipeline, self.mesh,
                                                 num_inference_steps=self.num_inference_steps)
        return self._executor

