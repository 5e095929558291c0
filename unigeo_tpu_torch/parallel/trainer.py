"""Diffusion training step for the UNet, on one device.

Port of ``unigeo_tpu/parallel/trainer.py::DiffusionTrainer`` (the mesh and
its sharding are not ported yet).  One ``train_step`` is the EDM denoising
loss, its backward and one AdamW update:

  sigma = exp(P_mean + P_std * n), n ~ N(0, 1) per clip
  x = x0 + sigma * noise;  v target;  x_in = x / sqrt(sigma^2 + 1)
  UNet([x_in | cond], timestep(sigma), context, added ids [6, 127, 0.02])
  loss = mean((v_pred - v_target)^2)

Batches keep the JAX package's layout: latents and cond_latents
[B, T, h, w, 4], context [B, T, 1, C].  The draws n and noise may be passed
in (the parity tests pass the JAX package's); otherwise they come from the
trainer's ``torch.Generator`` on its device.

The optimizer is ``torch.optim.AdamW`` with optax ``adamw``'s defaults (b1
0.9, b2 0.999, eps 1e-8 outside the square root) and its decoupled decay.
optax decays every parameter, also one the loss does not reach (its
gradient is zero there); torch skips a parameter whose ``.grad`` is None, so
such gradients are set to zeros before the step.  The moments are kept in
the parameter dtype, as optax keeps them.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from unigeo_tpu_torch.models.depthcrafter.scheduler import EulerDiscreteScheduler

ADDED_TIME_IDS = (6.0, 127.0, 0.02)  # fps - 1, motion bucket, noise aug (trainer.py:105)


class DiffusionTrainer:
    """Owns the UNet's AdamW state and the train step."""

    def __init__(
        self,
        unet: nn.Module,
        learning_rate: float = 1e-5,
        weight_decay: float = 1e-2,
        sigma_p_mean: float = 0.7,
        sigma_p_std: float = 1.6,
    ):
        self.unet = unet
        self.params = [p for p in unet.parameters() if p.requires_grad]
        if not self.params:
            raise ValueError("the UNet has no parameter that requires grad")
        self.device = self.params[0].device
        self.dtype = self.params[0].dtype
        self.scheduler = EulerDiscreteScheduler()
        self.optimizer = torch.optim.AdamW(
            self.params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay,
        )
        self.p_mean = sigma_p_mean
        self.p_std = sigma_p_std
        # the draws when none are passed in (the JAX driver's PRNGKey(1) has
        # no torch counterpart; the seed is the same number)
        self.generator = torch.Generator(device=self.device).manual_seed(1)
        self.step = 0

    def loss(self, batch: Dict[str, torch.Tensor], log_sigma_normal=None, noise=None):
        """The EDM loss of ``trainer.py:75-114``; f32 scalar."""
        dev = self.device
        latents = torch.as_tensor(batch["latents"], device=dev).float()
        cond = torch.as_tensor(batch["cond_latents"], device=dev).float()
        ctx = torch.as_tensor(batch["context"], device=dev)
        b, t = latents.shape[:2]
        if log_sigma_normal is None:
            log_sigma_normal = torch.randn((b, 1, 1, 1, 1), generator=self.generator, device=dev)
        if noise is None:
            noise = torch.randn(latents.shape, generator=self.generator, device=dev)
        n = torch.as_tensor(log_sigma_normal, device=dev).float().reshape(b, 1, 1, 1, 1)
        noise = torch.as_tensor(noise, device=dev).float()

        sigma = torch.exp(self.p_mean + self.p_std * n)
        sched = self.scheduler
        noisy = sched.add_noise(latents, noise, sigma)
        v_tgt = sched.v_target(latents, noise, sigma)
        x_in = sched.scale_model_input(noisy, sigma)

        # [B, T, h, w, 8] -> [B*T, 8, h, w] for the NCHW UNet
        unet_in = torch.cat([x_in, cond], dim=-1).reshape(b * t, *latents.shape[2:-1], 8)
        unet_in = unet_in.permute(0, 3, 1, 2).to(self.dtype)
        timesteps = sched.train_timesteps(sigma[:, 0, 0, 0, 0])
        added = torch.tensor([ADDED_TIME_IDS], dtype=torch.float32, device=dev).repeat(b, 1)
        v_pred = self.unet(unet_in, timesteps, ctx.reshape(b * t, *ctx.shape[2:]).to(self.dtype),
                           added, t)
        v_pred = v_pred.permute(0, 2, 3, 1).reshape(v_tgt.shape).float()
        return torch.mean((v_pred - v_tgt) ** 2)

    def train_step(self, batch: Dict[str, torch.Tensor], log_sigma_normal=None, noise=None):
        """Loss, backward, one AdamW update; returns the loss (detached)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(batch, log_sigma_normal, noise)
        loss.backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.step += 1
        return loss.detach()
