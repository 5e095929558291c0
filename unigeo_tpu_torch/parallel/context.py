"""Context parallelism: a clip's FRAME axis split over ranks, port of
``unigeo_tpu/parallel/context.py``.

Each rank of the mesh's ``sp`` dim holds T / sp consecutive frames (T must
divide, as the JAX package's ``P("sp")`` requires).  In JAX, XLA derives
the collectives from the shardings; here the layers that see other frames
reach them through the ``comm.FrameShard`` that ``layers.frames_sharded``
puts in scope, and the model code keeps its shapes:

  * the UNet's temporal attention gathers the normed input over sp for its
    keys and values (queries stay local), with the GLOBAL frame indices in
    its position embedding and the global frame 0's context (broadcast
    from the rank that holds it);
  * the temporal resnets' group norms reduce their statistics over sp,
    and their (3, 1, 1) convs read a one-frame halo from each neighbour
    (zeros at the clip's ends);
  * the Aether DiT's attention gathers its keys and values over sp (its
    tokens are frame-major, so a latent frame block is a token block);
    every other op of both networks is per frame or per token.

Both functions are SPMD: every rank of the group calls them with the whole
inputs and gets the whole result.
"""

from __future__ import annotations

import contextlib

import torch

from unigeo_tpu_torch.models.layers import frames_sharded
from unigeo_tpu_torch.parallel.comm import FrameShard, split_frames


def frame_shard_of(mesh, axis_name: str = "sp") -> FrameShard:
    """The ``FrameShard`` over ``mesh``'s dim ``axis_name`` (a ``FrameShard``
    as it is)."""
    return mesh if isinstance(mesh, FrameShard) else FrameShard(mesh.get_group(axis_name))


@torch.no_grad()
def denoise_context_parallel(pipeline, cond_latents, context, noise, num_inference_steps: int,
                             mesh, axis_name: str = "sp"):
    """The pipeline's denoise loop with the frames split over ``axis_name``.

    cond_latents [T, 4, h, w] and context [T, 1, C] as ``_encode_stage``
    returns them, noise [T, 4, h, w] -> the denoised latents [T, 4, h, w]
    in f32 on every rank, what ``pipeline._denoise_loop`` computes for the
    clip unsplit (up to the order of the statistics' sums)."""
    shard = frame_shard_of(mesh, axis_name)
    local = [split_frames(a, shard) for a in (cond_latents, context, noise)]
    x = denoise_local_frames(pipeline, *local, num_inference_steps, shard)
    return shard.gather(x, dim=0)


@torch.no_grad()
def denoise_local_frames(pipeline, cond_latents, context, noise, num_inference_steps: int,
                         shard: FrameShard):
    """The denoise loop over this rank's block of a clip's frames (each
    argument its block of T / sp frames) -> this rank's block of the
    denoised latents [T / sp, 4, h, w], f32.  A one-rank shard holds every
    frame and runs the plain loop."""
    with frames_sharded(shard) if shard.size > 1 else contextlib.nullcontext():
        x = pipeline._denoise_loop(cond_latents[None], context[None], noise[None],
                                   num_inference_steps)[0]
    return x.contiguous()


@torch.no_grad()
def flow_sample_context_parallel(network, cond_latents, noise, steps: int, mesh,
                                 axis_name: str = "sp"):
    """Aether's flow sampler with the latent frames split over ``axis_name``.

    network: an ``AetherNetwork`` (its ``dit``); cond_latents [T', z, h, w]
    and noise [T', target, h, w] as ``AetherNetwork.sample`` takes them ->
    the sampled [T', target, h, w] on every rank.  Each rank runs the DiT on
    its latent frames with its rows of the position table; in each block's
    attention its queries meet every rank's keys and values."""
    from unigeo_tpu_torch.models.aether import flow_sample

    shard = frame_shard_of(mesh, axis_name)
    dit = network.dit
    tl, _, h, w = cond_latents.shape
    gh, gw = h // dit.patch, w // dit.patch
    cond, x = split_frames(cond_latents, shard), split_frames(noise, shard)
    rows = cond.shape[0] * gh * gw
    pos = dit.positions(tl, gh, gw, cond_latents.device)
    pos = pos[shard.index * rows:(shard.index + 1) * rows]
    with frames_sharded(shard):
        out = flow_sample(lambda xi, t: dit(xi, t, pos), cond, x, steps)
    return shard.gather(out.contiguous(), dim=0)
