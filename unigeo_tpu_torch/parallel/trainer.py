"""The trainers of the port, on one device: counterparts of
``unigeo_tpu/parallel/trainer.py``'s five (the mesh and its sharding are not
ported yet).  Each ``train_step`` is the family's loss, its backward and one
AdamW update (``Trainer``, shared by all five):

  DiffusionTrainer     EDM v-prediction of the SVD UNet on VAE latents
                       (DepthCrafter and its siblings)
  FlowMatchingTrainer  rectified flow of Aether's DiT on [depth latents |
                       raymaps], t ~ logit-normal
  PointmapTrainer      confidence-weighted world-pointmap regression (+ the
                       7-DoF pose loss where the network has a pose head):
                       Spann3R, Cut3R
  Dust3RTrainer        the same in pair mode: (frame 0, frame i) pairs, one
                       normalisation over both views
  DisparityTrainer     scale-shift-invariant disparity + temporal gradient
                       matching (VideoDepthAnything)

Batches keep the JAX package's layout ([B, T, H, W, ...], channels last).
The random draws (the diffusion trainer's n and noise, the flow trainer's
logit-normal t and eps) may be passed in (the parity tests pass the JAX
package's); otherwise they come from the trainer's ``torch.Generator`` on
its device.

The optimizer is ``torch.optim.AdamW`` with optax ``adamw``'s defaults (b1
0.9, b2 0.999, eps 1e-8 outside the square root) and its decoupled decay.
optax decays every parameter, also one the loss does not reach (its
gradient is zero there); torch skips a parameter whose ``.grad`` is None, so
such gradients are set to zeros before the step.  The moments are kept in
the parameter dtype, as optax keeps them.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn as nn

from unigeo_tpu_torch.metrics.alignment import lstsq_scale_shift
from unigeo_tpu_torch.models.depthcrafter.scheduler import EulerDiscreteScheduler
from unigeo_tpu_torch.models.pointmap.losses import (
    normalize_by_avg_dis,
    pointmap_regression_loss,
    pose_loss,
)

ADDED_TIME_IDS = (6.0, 127.0, 0.02)  # fps - 1, motion bucket, noise aug (trainer.py:105)


class Trainer:
    """A module's trainable parameters, their AdamW state and the train
    step; a family defines ``loss(batch, *draws)``."""

    def __init__(self, module: nn.Module, learning_rate: float, weight_decay: float):
        self.module = module
        self.params = [p for p in module.parameters() if p.requires_grad]
        if not self.params:
            raise ValueError(f"{type(module).__name__} has no parameter that requires grad")
        self.device = self.params[0].device
        self.dtype = self.params[0].dtype
        self.optimizer = torch.optim.AdamW(
            self.params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay,
        )
        # the draws when none are passed in (the JAX driver's PRNGKey(1) has
        # no torch counterpart; the seed is the same number)
        self.generator = torch.Generator(device=self.device).manual_seed(1)
        self.step = 0

    def tensor(self, batch: Mapping, key: str) -> torch.Tensor:
        """``batch[key]`` (numpy or torch) as f32 on the trainer's device."""
        return torch.as_tensor(batch[key], device=self.device).float()

    def loss(self, batch: Mapping, *draws) -> torch.Tensor:
        raise NotImplementedError

    def train_step(self, batch: Mapping, *draws):
        """Loss, backward, one AdamW update; returns the loss (detached)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(batch, *draws)
        loss.backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.step += 1
        return loss.detach()


class DiffusionTrainer(Trainer):
    """EDM denoising of the UNet (``trainer.py:75-114``)."""

    def __init__(
        self,
        unet: nn.Module,
        learning_rate: float = 1e-5,
        weight_decay: float = 1e-2,
        sigma_p_mean: float = 0.7,
        sigma_p_std: float = 1.6,
    ):
        super().__init__(unet, learning_rate, weight_decay)
        self.unet = unet
        self.scheduler = EulerDiscreteScheduler()
        self.p_mean = sigma_p_mean
        self.p_std = sigma_p_std

    def loss(self, batch: Dict[str, torch.Tensor], log_sigma_normal=None, noise=None):
        """The EDM loss of ``trainer.py:75-114``; f32 scalar."""
        dev = self.device
        latents, cond = self.tensor(batch, "latents"), self.tensor(batch, "cond_latents")
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


class FlowMatchingTrainer(Trainer):
    """Rectified flow of the Aether DiT: t = sigmoid(n), n ~ N(0, 1) per
    clip; x_t = (1 - t) x0 + t eps; the DiT regresses the path's velocity
    eps - x0 from [cond | x_t] at time t.  Batch: target_latents [B, T', h,
    w, Ct], cond_latents [B, T', h, w, Cc]."""

    def __init__(self, dit: nn.Module, learning_rate: float = 1e-4,
                 weight_decay: float = 1e-2):
        super().__init__(dit, learning_rate, weight_decay)
        self.dit = dit

    def loss(self, batch, t_normal=None, eps=None):
        x0 = self.tensor(batch, "target_latents")
        cond = self.tensor(batch, "cond_latents")
        b = x0.shape[0]
        if t_normal is None:
            t_normal = torch.randn((b,), generator=self.generator, device=self.device)
        if eps is None:
            eps = torch.randn(x0.shape, generator=self.generator, device=self.device)
        t = torch.sigmoid(torch.as_tensor(t_normal, device=self.device).float().reshape(b))
        eps = torch.as_tensor(eps, device=self.device).float()
        tb = t[:, None, None, None, None]
        x_t = (1.0 - tb) * x0 + tb * eps
        v_tgt = eps - x0
        # the DiT runs one clip at a time on [T', C, h, w]
        v_pred = torch.stack([
            self.dit(torch.cat([c, x], dim=-1).permute(0, 3, 1, 2), ti).permute(0, 2, 3, 1)
            for c, x, ti in zip(cond, x_t, t)])
        return torch.mean((v_pred.float() - v_tgt) ** 2)


class PointmapTrainer(Trainer):
    """Confidence-weighted regression of the world pointmaps over the whole
    batch (``models/pointmap/losses.py``), plus ``pose_weight`` times the
    pose loss for a network with a pose head (Cut3R).  Batch: frames [B, T,
    H, W, 3] in 0..1, gt_world_pts [B, T, H, W, 3], mask [B, T, H, W],
    gt_poses [B, T, 4, 4]; the clips run one by one (the recurrences are
    sequential in T)."""

    def __init__(self, network: nn.Module, learning_rate: float = 1e-4,
                 weight_decay: float = 5e-2, conf_alpha: float = 0.2, pose_weight: float = 1.0):
        super().__init__(network, learning_rate, weight_decay)
        self.network = network
        self.conf_alpha = conf_alpha
        self.pose_weight = pose_weight

    def clip_outputs(self, frames):
        """One clip -> (world points, confidences, pose encoding or None)."""
        out = self.network(frames.to(self.dtype))
        if isinstance(out, dict):
            return out["world_pts"], out["world_conf"], out.get("pose_enc")
        pts, conf = out
        return pts, conf, None

    def loss(self, batch):
        frames = self.tensor(batch, "frames")
        pts, conf, pose_enc = zip(*(self.clip_outputs(f) for f in frames))
        loss = pointmap_regression_loss(
            torch.stack(pts).float(), self.tensor(batch, "gt_world_pts"),
            self.tensor(batch, "mask"), torch.stack(conf).float(), self.conf_alpha)
        if pose_enc[0] is not None and "gt_poses" in batch:
            loss = loss + self.pose_weight * pose_loss(torch.stack(pose_enc).float(),
                                                       self.tensor(batch, "gt_poses"))
        return loss


class Dust3RTrainer(PointmapTrainer):
    """Pair-mode training of the DUSt3R two-view network, clip by clip as
    the adapter infers: frame 0 (encoded once, its tokens broadcast over
    the T - 1 pairs) against each frame i, frame 0 the world, so the GT
    world points supervise both views.  One normalisation factor over both
    views (DUSt3R's Regr3D): per-view factors would leave the heads'
    relative scale free.  The loss is the mean over the clips."""

    def loss(self, batch):
        frames = self.tensor(batch, "frames")
        gts, valids = self.tensor(batch, "gt_world_pts"), self.tensor(batch, "mask")
        losses = []
        for f, g, v in zip(frames, gts, valids):
            f = f.to(self.dtype)
            pts1, pts2, conf1, conf2 = self.network(f[:1], f[1:])
            pred = torch.cat([pts1, pts2]).float()
            gt = torch.cat([g[:1].expand_as(g[1:]), g[1:]])
            va = torch.cat([v[:1].expand_as(v[1:]), v[1:]])
            pred_n, _ = normalize_by_avg_dis(pred, va)
            gt_n, _ = normalize_by_avg_dis(gt, va)
            losses.append(pointmap_regression_loss(
                pred_n, gt_n, va, torch.cat([conf1, conf2]).float(), self.conf_alpha,
                normalize=False))
        return torch.stack(losses).mean()


class DisparityTrainer(Trainer):
    """Scale-shift-invariant disparity plus temporal gradient matching
    (VideoDepthAnything): per frame, the least-squares (s, b) of the
    prediction onto the GT disparity (``metrics/alignment.py``), the masked
    L1 of the aligned prediction, and ``temporal_weight`` times the masked
    L1 between consecutive frames' differences.  Batch: frames [B, T, H, W,
    3], gt_disp [B, T, H, W], mask [B, T, H, W]; the loss is the mean over
    the clips."""

    def __init__(self, network: nn.Module, learning_rate: float = 1e-4,
                 weight_decay: float = 1e-2, temporal_weight: float = 1.0):
        super().__init__(network, learning_rate, weight_decay)
        self.network = network
        self.temporal_weight = temporal_weight

    def clip_loss(self, pred, g, m):
        """The loss of one clip's prediction [T, H, W] against g, m [T, H, W]."""
        s, b = (torch.stack(x) for x in zip(*(lstsq_scale_shift(p, gf, mf)
                                               for p, gf, mf in zip(pred, g, m))))
        aligned = s[:, None, None] * pred + b[:, None, None]
        ssi = (m * (aligned - g).abs()).sum() / m.sum().clamp_min(1.0)
        dp, dg = aligned[1:] - aligned[:-1], g[1:] - g[:-1]
        mt = m[1:] * m[:-1]
        tgm = (mt * (dp - dg).abs()).sum() / mt.sum().clamp_min(1.0)
        return ssi + self.temporal_weight * tgm

    def loss(self, batch):
        frames = self.tensor(batch, "frames")
        return torch.stack([
            self.clip_loss(self.network(f.to(self.dtype)).float(), g, m)
            for f, g, m in zip(frames, self.tensor(batch, "gt_disp"), self.tensor(batch, "mask"))
        ]).mean()
