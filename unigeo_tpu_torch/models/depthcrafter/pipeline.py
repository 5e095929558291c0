"""DepthCrafter inference pipeline: VAE encode -> denoise loop -> decode.

Port of ``unigeo_tpu/models/depthcrafter/pipeline.py``.  One window (a
whole clip, the path the eval configs use):

    frames [T,H,W,3] 0..1
      -> x2-1 -> + noise_aug_strength * aug_noise -> VAE.encode per frame
         -> conditioning latents (UNSCALED)
      -> CLIP-embed per frame -> context [T,1,1024]
      -> x = noise * sqrt(sigma_max^2 + 1)
      -> Euler over the Karras sigmas with EDM v-prediction
      -> VAE.decode(x / 0.18215) -> [T,H,W,3] in about [-1, 1]

Public functions keep the JAX package's NHWC layout; the stages run NCHW
inside.  The noise comes in as arguments: a torch generator cannot draw the
JAX package's ``jax.random`` streams, so parity tests pass the JAX draws in
and production callers draw from a ``torch.Generator`` on the device
(``draw_clip_noise``).

Longer clips run as overlapping windows crossfaded on the overlap
(``__call__``), and ``run_clips_staged`` runs B equally-shaped clips with
one batched denoise loop between per-clip encodes and decodes.
"""

from __future__ import annotations

import contextlib
import hashlib
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from unigeo_tpu_torch.device import PRODUCTION_DTYPE, resolve_device
from unigeo_tpu_torch.models.depthcrafter.scheduler import (
    EulerDiscreteConfig,
    EulerDiscreteScheduler,
)
from unigeo_tpu_torch.models.depthcrafter.unet import UNetSpatioTemporal
from unigeo_tpu_torch.models.depthcrafter.vae import AutoencoderKLTemporal
from unigeo_tpu_torch.models.layers import AlphaBlender
from unigeo_tpu_torch.models.vit import ClipImageEmbedder


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights in place, drawn from ``generator`` on the module's
    device, with the JAX package's initialisers: lecun-normal kernels,
    zero biases, unit norm scales, N(0, 0.02) class and position tables and
    the AlphaBlenders' constant merge factors."""
    for name, mod in module.named_modules():
        if isinstance(mod, AlphaBlender):
            mod.mix_factor.fill_(mod.merge_factor)
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            fan_in = mod.weight[0].numel()
            mod.weight.normal_(0.0, fan_in**-0.5, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        for pname, p in mod.named_parameters(recurse=False):
            if pname == "class_embedding":
                p.normal_(0.0, 0.02, generator=generator)
    return module


class DepthCrafterPipeline:
    """The three SVD modules on one device at one dtype, and the staged
    whole-clip forward."""

    def __init__(
        self,
        unet_config: Optional[Dict[str, Any]] = None,
        vae_config: Optional[Dict[str, Any]] = None,
        clip_config: Optional[Dict[str, Any]] = None,
        dtype: torch.dtype = PRODUCTION_DTYPE,
        device="cuda",
        fps: float = 7.0,
        motion_bucket_id: float = 127.0,
        noise_aug_strength: float = 0.02,
        scheduler_config: Optional[EulerDiscreteConfig] = None,
    ):
        self.device = resolve_device(device)
        self.dtype = dtype
        # built on the meta device and then given storage where they run, so
        # no full-size copy of the weights is ever made on the host
        with torch.device("meta"):
            self.unet = UNetSpatioTemporal(**(unet_config or {}))
            self.vae = AutoencoderKLTemporal(**(vae_config or {}))
            self.clip = ClipImageEmbedder(**(clip_config or {}))
        for m in self.modules():
            m.to(dtype=dtype).to_empty(device=self.device).eval().requires_grad_(False)
        self.scheduler = EulerDiscreteScheduler(scheduler_config or EulerDiscreteConfig())
        self.noise_aug_strength = noise_aug_strength
        self.added_time_ids = np.array(
            [[fps - 1.0, motion_bucket_id, noise_aug_strength]], np.float32
        )

    def modules(self):
        return (self.unet, self.vae, self.clip)

    def init_random(self, generator: torch.Generator) -> "DepthCrafterPipeline":
        for m in self.modules():
            init_random_(m, generator)
        return self

    def load_state_dicts(self, unet_sd, vae_sd, clip_sd) -> "DepthCrafterPipeline":
        """Load the three state dicts strictly (upstream key names), casting
        every float tensor to the pipeline dtype."""
        for m, sd in zip(self.modules(), (unet_sd, vae_sd, clip_sd)):
            m.load_state_dict(sd, strict=True)
        return self.cast_params_to_dtype()

    def cast_params_to_dtype(self) -> "DepthCrafterPipeline":
        """Every float parameter at the compute dtype (pipeline.py:144-161):
        f32 parameters on a bf16 path would change the numerics."""
        for m in self.modules():
            for p in m.parameters():
                if p.is_floating_point() and p.dtype != self.dtype:
                    p.data = p.data.to(self.dtype)
        return self

    # ------------------------------------------------------------------

    def prepare_clip(self, images) -> torch.Tensor:
        """images [Nf,3,H,W] 0..255 -> frames [Nf,H,W,3] 0..1 on the device.

        The /255 happens on the host in f32, before the transfer, so frame
        values are the JAX package's bit for bit; the NHWC result is a view
        of the contiguous NCHW upload."""
        raw01 = np.asarray(images, np.float32) / np.float32(255.0)
        return torch.from_numpy(raw01).to(self.device).permute(0, 2, 3, 1)

    def draw_clip_noise(self, generator: torch.Generator, t: int, h: int, w: int):
        """(denoise noise [t,h/8,w/8,4], aug noise [t,h,w,3] | None), N(0,1)
        f32 draws from ``generator`` on the device."""
        noise = torch.randn(
            (t, h // 8, w // 8, 4), generator=generator, device=self.device
        )
        aug = (
            torch.randn((t, h, w, 3), generator=generator, device=self.device)
            if self.noise_aug_strength > 0
            else None
        )
        return noise, aug

    # ------------------------------------------------------------------

    @torch.no_grad()
    def _encode_stage(self, frames, aug_noise=None):
        """frames [T,3,H,W] 0..1 -> (cond latents [T,4,h,w], context [T,1,C])."""
        frames_pm1 = frames * 2.0 - 1.0
        if aug_noise is not None and self.noise_aug_strength > 0:
            frames_pm1 = frames_pm1 + self.noise_aug_strength * aug_noise
        cond = self.vae.encode(frames_pm1.to(self.dtype)).to(self.dtype)
        context = self.clip(frames.to(self.dtype)).to(self.dtype)
        return cond, context

    @torch.no_grad()
    def _denoise_loop(self, cond, context, noise, num_inference_steps: int):
        """Euler over B clips: cond [B,T,4,h,w], context [B,T,1,C], noise
        [B,T,4,h,w] -> denoised latents [B,T,4,h,w] in f32."""
        b, t = cond.shape[:2]
        sigmas = self.scheduler.inference_sigmas(num_inference_steps)
        timesteps = self.scheduler.timesteps_for_sigmas(sigmas[:-1])
        x = noise.float() * float(np.sqrt(np.float32(sigmas[0]) ** 2 + 1.0))
        added = torch.from_numpy(np.repeat(self.added_time_ids, b, axis=0)).to(self.device)
        cond_flat = cond.reshape(b * t, *cond.shape[2:])
        ctx_flat = context.reshape(b * t, *context.shape[2:])
        for i in range(num_inference_steps):
            sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
            x_in = self.scheduler.scale_model_input(x, sigma).to(self.dtype)
            unet_in = torch.cat([x_in.reshape(b * t, *x_in.shape[2:]), cond_flat], dim=1)
            ts = torch.full((b,), float(timesteps[i]), device=self.device)
            v = self.unet(unet_in, ts, ctx_flat, added, t).float().reshape(x.shape)
            denoised = self.scheduler.denoised_from_v(x, v, sigma)
            x = self.scheduler.euler_step(x, denoised, sigma, sigma_next)
        return x

    @torch.no_grad()
    def _decode_stage(self, latents):
        """[T,4,h,w] -> [T,3,H,W] f32."""
        t = latents.shape[0]
        return self.vae.decode(latents.to(self.dtype), t).float()

    def run_window_staged(self, frames, noise, num_inference_steps: int,
                          aug_noise=None, stage_ms: Optional[Dict[str, float]] = None):
        """The whole-clip forward.  frames [T,H,W,3] 0..1, noise [T,h,w,4],
        aug_noise [T,H,W,3] or None -> decoded [T,H,W,3] f32 in about [-1, 1].

        ``stage_ms``: if given a dict, each stage's wall time in ms is written
        into it (the device is synchronised around every stage)."""
        nchw = lambda a: a.to(self.device).permute(0, 3, 1, 2)
        with _timed(stage_ms, "encode", self.device):
            cond, context = self._encode_stage(
                nchw(frames), None if aug_noise is None else nchw(aug_noise)
            )
        with _timed(stage_ms, "denoise", self.device):
            x = self._denoise_loop(
                cond[None], context[None], nchw(noise)[None], num_inference_steps
            )[0]
        with _timed(stage_ms, "decode", self.device):
            out = self._decode_stage(x)
        return out.permute(0, 2, 3, 1)

    def run_clips_staged(self, frames, noise, num_inference_steps: int, aug_noise=None):
        """B clips at once: frames [B,T,H,W,3], noise [B,T,h,w,4], aug_noise
        [B,T,H,W,3] or None -> decoded [B,T,H,W,3] f32.

        Encode and decode run per clip (the decoder is the stage with the
        largest activations); the denoise loop runs once over all B clips,
        so every UNet product has B times the rows.  Each clip's group
        norms and attentions see only that clip, so a clip computes what
        ``run_window_staged`` computes for it, up to the order of sums the
        products' kernels choose at the larger M."""
        # each clip laid out as run_window_staged lays it out: NCHW frames,
        # and noise in a dense NHWC tensor read through a permuted view
        nchw = lambda a: a.to(self.device).permute(0, 3, 1, 2).contiguous()
        encoded = [self._encode_stage(nchw(frames[i]),
                                      None if aug_noise is None else nchw(aug_noise[i]))
                   for i in range(frames.shape[0])]
        cond = torch.stack([c for c, _ in encoded])
        context = torch.stack([c for _, c in encoded])
        noise = torch.as_tensor(noise).to(self.device).contiguous().permute(0, 1, 4, 2, 3)
        x = self._denoise_loop(cond, context, noise, num_inference_steps)
        return torch.stack([self._decode_stage(xi).permute(0, 2, 3, 1) for xi in x])

    # ------------------------------------------------------------------

    def window_generator(self, seed: int, wi: int) -> torch.Generator:
        """The generator on the device that draws window ``wi``'s noise when
        none is given: seeded with the first 8 bytes (big-endian, top bit
        cleared) of sha256(f"{seed}/{wi}"), so each (seed, window) pair has
        its own stream, the same on every run."""
        digest = hashlib.sha256(f"{seed}/{wi}".encode()).digest()
        return torch.Generator(device=self.device).manual_seed(
            int.from_bytes(digest[:8], "big") & (2**63 - 1))

    def __call__(
        self,
        frames,
        num_inference_steps: int = 5,
        window_size: Optional[int] = None,
        overlap: int = 0,
        seed: int = 42,
        window_noise: Optional[Sequence[Tuple[Any, Any]]] = None,
    ) -> torch.Tensor:
        """frames [T,H,W,3] 0..1 -> [T,H,W,3] decoded output in 0..1, f32 on
        the device.

        A clip longer than ``window_size`` runs as windows of that size
        starting every ``window_size - overlap`` frames (``range(0, t -
        overlap, stride)``), the last moved back so that it ends at the
        clip's end (every window is full).  Over the frames a window shares
        with those already written, the old output ramps 1 -> 0 and the new
        one 0 -> 1 (``np.linspace(0, 1, ov, endpoint=False)``, blended in
        f64 as the JAX package's numpy does), and the new window is at full
        weight after them.

        window_noise: per window, (noise [W,h,w,4], aug_noise [W,H,W,3] or
        None).  When it is None, window ``wi`` draws both from
        ``window_generator(seed, wi)`` (noise first); a single window (the
        whole clip) draws from a generator seeded with ``seed``, as
        ``DepthCrafter.forward`` does.
        """
        frames = torch.as_tensor(frames)
        t, h, w, _ = frames.shape
        window_size = window_size or t
        if window_size >= t:
            if window_noise is not None:
                noise, aug = window_noise[0]
            else:
                gen = torch.Generator(device=self.device).manual_seed(seed)
                noise, aug = self.draw_clip_noise(gen, t, h, w)
            out = self.run_window_staged(frames, torch.as_tensor(noise), num_inference_steps,
                                         aug_noise=None if aug is None else torch.as_tensor(aug))
            return (out + 1.0) / 2.0

        stride = window_size - overlap
        if stride <= 0:
            raise ValueError(
                f"overlap ({overlap}) must be smaller than window_size "
                f"({window_size}) when the clip is longer than one window"
            )
        acc = torch.zeros((t, h, w, 3), dtype=torch.float32, device=self.device)
        prev_end = 0
        for wi, start in enumerate(range(0, t - overlap, stride)):
            end = min(start + window_size, t)
            start = end - window_size  # full windows only (the last one re-covers)
            if window_noise is not None:
                noise, aug = window_noise[wi]
            else:
                noise, aug = self.draw_clip_noise(self.window_generator(seed, wi),
                                                  window_size, h, w)
            out = self.run_window_staged(frames[start:end], torch.as_tensor(noise),
                                         num_inference_steps,
                                         aug_noise=None if aug is None else torch.as_tensor(aug))
            ov = min(prev_end, end) - start  # frames already written
            if wi > 0 and ov > 0:
                r = torch.from_numpy(np.linspace(0.0, 1.0, ov, endpoint=False))
                r = r.to(self.device).reshape(-1, 1, 1, 1)
                acc[start:start + ov] = ((1.0 - r) * acc[start:start + ov].double()
                                         + r * out[:ov].double()).float()
                acc[start + ov:end] = out[ov:]
            else:
                acc[start:end] = out
            prev_end = end
        return (acc + 1.0) / 2.0


@contextlib.contextmanager
def _timed(out: Optional[Dict[str, float]], name: str, device: torch.device):
    """Record the wall ms of the block under ``name`` in ``out`` (the device
    synchronised on both sides); nothing when ``out`` is None."""
    if out is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out[name] = (time.perf_counter() - t0) * 1e3


def tiny_pipeline(device="cuda", dtype=torch.float32) -> DepthCrafterPipeline:
    """A miniature pipeline (the JAX package's tiny configs), weights unset."""
    from unigeo_tpu_torch.models.depthcrafter.unet import tiny_unet_config
    from unigeo_tpu_torch.models.depthcrafter.vae import tiny_vae_config
    from unigeo_tpu_torch.models.vit import tiny_clip_config

    unet_cfg = tiny_unet_config()
    return DepthCrafterPipeline(
        unet_config=unet_cfg,
        vae_config=tiny_vae_config(),
        clip_config=dict(tiny_clip_config(), projection_dim=unet_cfg["cross_attention_dim"]),
        dtype=dtype,
        device=device,
    )
