"""Pipeline parallelism: encode / denoise / decode on disjoint ranks, port of
``unigeo_tpu/parallel/staged.py``.

One process a stage:

  * rank 0 encodes (VAE encoder + CLIP; it keeps only ``vae`` and ``clip``),
  * rank 1 decodes (it keeps only ``vae``),
  * ranks 2.. denoise (they keep only ``unet``), the frames split over the
    first ``_largest_divisor_leq(T, n_middle)`` of them
    (``context.denoise_local_frames``); the middle ranks past those idle.

The hand-offs are ``isend`` / ``irecv`` (each denoise rank gets its block
of the frames' conditioning latents and context, the decode rank every
block of the denoised latents), so the encode rank runs clip i + 1 while
the middle ranks denoise clip i: the overlap the JAX package gets from
async dispatch.  At the end the decode rank broadcasts the stacked
[B, T, H, W, 3] in 0..1 to every rank.  SPMD: every rank calls the executor
with the same arguments.

When to use which executor (as in the JAX package): ``ShardedClipExecutor``
for throughput (B clips a step over dp), this one for a clip's latency with
the stages overlapped, or when a whole batch's activations would not fit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from unigeo_tpu_torch.parallel.comm import FrameShard, Recv, Send, broadcast, new_groups
from unigeo_tpu_torch.parallel.context import denoise_local_frames

ENC_RANK, DEC_RANK = 0, 1


def _largest_divisor_leq(n: int, k: int) -> int:
    for d in range(min(n, k), 0, -1):
        if n % d == 0:
            return d
    return 1


class PipelinedStageExecutor:
    def __init__(self, pipeline, num_frames: int, num_inference_steps: int = 5):
        """num_frames: the clip length (fixed per executor); the denoise
        group is the largest divisor of it that the middle ranks hold, so the
        frames split evenly.  This rank's copies of the modules its stage
        does not run go to the meta device: the pipeline is then this
        stage's only."""
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world < 3:
            raise ValueError("pipeline parallelism needs >= 3 devices")
        self.pipe = pipeline
        self.steps = num_inference_steps
        self.rank = dist.get_rank()
        middle = list(range(2, world))
        self.sp = _largest_divisor_leq(num_frames, len(middle))
        self.denoise_ranks = middle[:self.sp]
        group = new_groups([self.denoise_ranks])  # every rank takes part
        self.shard = FrameShard(group) if self.rank in self.denoise_ranks else None
        self.context_dim = pipeline.unet.cross_attention_dim
        keep = {ENC_RANK: ("vae", "clip"), DEC_RANK: ("vae",)}.get(
            self.rank, ("unet",) if self.rank in self.denoise_ranks else ())
        for name in ("unet", "vae", "clip"):
            if name not in keep:
                getattr(pipeline, name).to("meta")

    def _tag(self, clip: int, what: int) -> int:
        return 4 * clip + what

    def __call__(self, clips, seed: int = 42, noise=None, aug_noise=None) -> torch.Tensor:
        """[B, T, H, W, 3] 0..1 -> [B, T, H, W, 3] decoded 0..1 (f32, on
        the pipeline's device, on every rank), all clips in flight at once.
        noise [B, T, h, w, 4] / aug_noise [B, T, H, W, 3]: explicit draws;
        when ``noise`` is None every clip gets the serial adapter's one draw
        from a generator seeded with ``seed``, as ``ShardedClipExecutor``."""
        pipe, dev = self.pipe, self.pipe.device
        clips = torch.as_tensor(clips)
        b, t, h, w, _ = clips.shape
        if noise is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            noise1, aug1 = pipe.draw_clip_noise(gen, t, h, w)
            noise = noise1.expand(b, *noise1.shape)
            aug_noise = None if aug1 is None else aug1.expand(b, *aug1.shape)
        noise = torch.as_tensor(noise)
        aug_noise = None if aug_noise is None else torch.as_tensor(aug_noise)
        lh, lw, c_lat = noise.shape[2:]
        n_loc = t // self.sp
        pending = []
        result = torch.empty((b, t, h, w, 3), dtype=torch.float32, device=dev)
        nchw = lambda a: a.to(dev).permute(0, 3, 1, 2).contiguous()
        if self.rank == ENC_RANK:
            for i in range(b):
                cond, ctx = pipe._encode_stage(
                    nchw(clips[i]), None if aug_noise is None else nchw(aug_noise[i]))
                for j, dst in enumerate(self.denoise_ranks):
                    block = slice(j * n_loc, (j + 1) * n_loc)
                    pending.append(Send(cond[block], dst, self._tag(i, 0)))
                    pending.append(Send(ctx[block], dst, self._tag(i, 1)))
        elif self.shard is not None:
            for i in range(b):
                cond = Recv((n_loc, c_lat, lh, lw), pipe.dtype, dev, ENC_RANK,
                            self._tag(i, 0)).wait()
                ctx = Recv((n_loc, 1, self.context_dim), pipe.dtype, dev, ENC_RANK,
                           self._tag(i, 1)).wait()
                block = slice(self.shard.index * n_loc, (self.shard.index + 1) * n_loc)
                x = denoise_local_frames(
                    pipe, cond, ctx, noise[i].to(dev).contiguous().permute(0, 3, 1, 2)[block],
                    self.steps, self.shard)
                pending.append(Send(x, DEC_RANK, self._tag(i, 2)))
        elif self.rank == DEC_RANK:
            for i in range(b):
                blocks = [Recv((n_loc, c_lat, lh, lw), torch.float32, dev, src, self._tag(i, 2))
                          for src in self.denoise_ranks]
                x = torch.cat([r.wait() for r in blocks])
                result[i] = (pipe._decode_stage(x).permute(0, 2, 3, 1) + 1.0) / 2.0
        for s in pending:
            s.wait()
        return broadcast(result, DEC_RANK)
