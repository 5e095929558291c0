"""The trainers of the port, counterparts of ``unigeo_tpu/parallel/trainer.py``'s
five, on one device or on a dp / sp / tp mesh.  Each ``train_step`` is the
family's loss, its backward and one AdamW update (``Trainer``, shared by all
five):

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

On a mesh (``mesh=``, ``parallel/mesh.py::make_mesh``; one process a rank):

  * the module is placed through ``sharding.parallelize``: tp shards the
    weights the rules name, and AdamW holds this rank's shards and their
    moments;
  * dp splits the clips (B) and, in ``DiffusionTrainer``, sp the frames (T)
    in equal consecutive blocks (``local_batch``; B must divide by dp and
    T by sp, as JAX's ``P("dp", "sp")`` requires); the other families keep
    each clip whole, their sp ranks replicas;
  * every rank draws the whole batch's draws from its generator (seed 1 on
    every rank) and takes its block, so a mesh step computes the
    one-device step of the same seed; passed-in draws are the whole batch's
    too;
  * ``train_step`` averages the gradients over the dp x sp ranks that hold
    the same tp shard, one flattened bucket per dtype, summed in f32 (the
    JAX package's psum may add bf16 gradients in bf16; the port does not);
    over tp the sharded leaves need nothing and the replicated ones are
    equal on every rank by the collectives' backwards (``comm.py``);
  * the losses are means of equal per-rank shares, so the mean of the
    ranks' losses is the global one, except ``PointmapTrainer``'s
    regression, whose normalisation and masked mean run over the whole
    batch: their sums are all-reduced over dp (``comm.AllReduceSum``).

JAX gets the collectives from one jitted SPMD program; here each forward
collective has its backward written out (``comm.py``) and the gradient
mean is explicit.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping

import torch
import torch.nn as nn

from unigeo_tpu_torch.metrics.alignment import lstsq_scale_shift
from unigeo_tpu_torch.models.layers import frames_sharded, tensor_parallel
from unigeo_tpu_torch.models.depthcrafter.scheduler import EulerDiscreteScheduler
from unigeo_tpu_torch.models.pointmap.losses import (
    normalize_by_avg_dis,
    pointmap_regression_loss,
    pose_loss,
)

ADDED_TIME_IDS = (6.0, 127.0, 0.02)  # fps - 1, motion bucket, noise aug (trainer.py:105)


class MeshPlace:
    """This rank's place on a trainer's mesh: each dim's size, this rank's
    index and group, and the group over which the gradients are averaged
    (the dp x sp ranks that hold this rank's tp shard; None when that is
    this rank alone).  ``MeshPlace(None)`` is one device."""

    def __init__(self, mesh=None):
        from unigeo_tpu_torch.parallel.comm import FrameShard, new_groups
        from unigeo_tpu_torch.parallel.mesh import axis_size

        self.mesh = mesh
        self.sizes = {a: 1 if mesh is None else axis_size(mesh, a) for a in ("dp", "sp", "tp")}
        self.index = {a: 0 if self.sizes[a] == 1 else mesh[a].get_local_rank()
                      for a in self.sizes}
        self.group = {a: None if self.sizes[a] == 1 else mesh.get_group(a) for a in self.sizes}
        self.shard = FrameShard(self.group["sp"]) if self.sizes["sp"] > 1 else None
        self.grad_group = None
        if self.sizes["dp"] * self.sizes["sp"] > 1:
            ranks = mesh.mesh.reshape(-1, self.sizes["tp"])
            self.grad_group = new_groups([ranks[:, t].tolist() for t in range(ranks.shape[1])])

    def span(self, n: int, axis: str) -> range:
        """This rank's block of ``range(n)`` split over ``axis``; raises,
        naming the sizes, where it does not divide."""
        size = self.sizes[axis]
        if n % size:
            what = {"dp": "clips (B)", "sp": "frames (T)"}[axis]
            raise ValueError(f"{n} {what} do not split over {axis} = {size}")
        m = n // size
        return range(self.index[axis] * m, (self.index[axis] + 1) * m)

    def block(self, x, axis: str, dim: int):
        """This rank's block of x along ``dim`` (x's whole length split over
        ``axis``; ``span``)."""
        r = self.span(x.shape[dim], axis)
        return x.narrow(dim, r.start, len(r))


class Trainer:
    """A module's trainable parameters, their AdamW state and the train
    step; a family defines ``loss(batch, *draws)`` on this rank's block of
    the batch (``local_batch``)."""

    # whether ``local_batch`` also splits each clip's frames (dim 1) over sp
    frame_split = False

    def __init__(self, module: nn.Module, learning_rate: float, weight_decay: float,
                 mesh=None):
        self.place = MeshPlace(mesh)
        if mesh is not None:
            from unigeo_tpu_torch.parallel.sharding import parallelize

            parallelize(module, mesh)
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

    def local_batch(self, batch: Mapping) -> Dict:
        """This rank's block of a whole batch: its dp block of the clips
        and, where the family splits frames (``frame_split``), its sp block
        of each clip's frames."""
        out = {}
        for key, value in batch.items():
            x = self.place.block(torch.as_tensor(value), "dp", 0)
            out[key] = self.place.block(x, "sp", 1) if self.frame_split else x
        return out

    def draw_block(self, x, frames: bool = False):
        """This rank's block of a whole batch's draw: the dp block of dim 0
        (and with ``frames`` the sp block of dim 1)."""
        x = self.place.block(torch.as_tensor(x, device=self.device).float(), "dp", 0)
        return self.place.block(x, "sp", 1) if frames else x

    def tensor(self, batch: Mapping, key: str) -> torch.Tensor:
        """``batch[key]`` (numpy or torch) as f32 on the trainer's device."""
        return torch.as_tensor(batch[key], device=self.device).float()

    def loss(self, batch: Mapping, *draws) -> torch.Tensor:
        raise NotImplementedError

    def parallel_context(self):
        """The contexts the loss's forward and backward run in: tp over the
        mesh's tp group."""
        stack = contextlib.ExitStack()
        if self.place.sizes["tp"] > 1:
            stack.enter_context(tensor_parallel(self.place.group["tp"]))
        return stack

    def backward(self, batch: Mapping, *draws) -> torch.Tensor:
        """The loss of this rank's ``batch`` and its backward; on a mesh each
        gradient and the loss end as their means over the dp x sp ranks.
        Returns the loss (detached)."""
        self.optimizer.zero_grad(set_to_none=True)
        with self.parallel_context():
            loss = self.loss(batch, *draws)
            loss.backward()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss = loss.detach().float().clone()
        if self.place.grad_group is not None:
            from unigeo_tpu_torch.parallel.comm import all_reduce_mean_

            all_reduce_mean_([p.grad for p in self.params] + [loss], self.place.grad_group)
        return loss

    def train_step(self, batch: Mapping, *draws):
        """Loss, backward, one AdamW update; returns the loss (detached).
        ``batch`` is this rank's block (``local_batch``)."""
        loss = self.backward(batch, *draws)
        self.optimizer.step()
        self.step += 1
        return loss


class DiffusionTrainer(Trainer):
    """EDM denoising of the UNet (``trainer.py:75-114``).  Under sp each rank
    holds T / sp consecutive frames of every clip, and the loss's forward
    and backward run inside ``frames_sharded``: the UNet's temporal layers
    reach the other frames through the sp group."""

    frame_split = True

    def parallel_context(self):
        stack = super().parallel_context()
        if self.place.shard is not None:
            stack.enter_context(frames_sharded(self.place.shard))
        return stack

    def __init__(
        self,
        unet: nn.Module,
        learning_rate: float = 1e-5,
        weight_decay: float = 1e-2,
        sigma_p_mean: float = 0.7,
        sigma_p_std: float = 1.6,
        mesh=None,
    ):
        super().__init__(unet, learning_rate, weight_decay, mesh)
        self.unet = unet
        self.scheduler = EulerDiscreteScheduler()
        self.p_mean = sigma_p_mean
        self.p_std = sigma_p_std

    def loss(self, batch: Dict[str, torch.Tensor], log_sigma_normal=None, noise=None):
        """The EDM loss of ``trainer.py:75-114`` over this rank's clips and
        frames; f32 scalar.  The draws are the whole batch's ([B, 1, 1, 1,
        1], [B, T, h, w, 4]), passed in or drawn here."""
        dev = self.device
        latents, cond = self.tensor(batch, "latents"), self.tensor(batch, "cond_latents")
        ctx = torch.as_tensor(batch["context"], device=dev)
        b, t = latents.shape[:2]
        whole = (b * self.place.sizes["dp"], t * self.place.sizes["sp"])
        if log_sigma_normal is None:
            log_sigma_normal = torch.randn((whole[0], 1, 1, 1, 1), generator=self.generator,
                                           device=dev)
        if noise is None:
            noise = torch.randn((*whole, *latents.shape[2:]), generator=self.generator,
                                device=dev)
        n = self.draw_block(torch.as_tensor(log_sigma_normal).reshape(whole[0], 1, 1, 1, 1))
        noise = self.draw_block(noise, frames=True)

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
                 weight_decay: float = 1e-2, mesh=None):
        super().__init__(dit, learning_rate, weight_decay, mesh)
        self.dit = dit

    def loss(self, batch, t_normal=None, eps=None):
        """Over this rank's clips; the draws are the whole batch's ([B], [B,
        T', h, w, Ct])."""
        x0 = self.tensor(batch, "target_latents")
        cond = self.tensor(batch, "cond_latents")
        b = x0.shape[0]
        whole = b * self.place.sizes["dp"]
        if t_normal is None:
            t_normal = torch.randn((whole,), generator=self.generator, device=self.device)
        if eps is None:
            eps = torch.randn((whole, *x0.shape[1:]), generator=self.generator,
                              device=self.device)
        t = torch.sigmoid(self.draw_block(torch.as_tensor(t_normal).reshape(whole)))
        eps = self.draw_block(eps)
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
                 weight_decay: float = 5e-2, conf_alpha: float = 0.2, pose_weight: float = 1.0,
                 mesh=None):
        super().__init__(network, learning_rate, weight_decay, mesh)
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
        # over dp the normalisation and the masked mean take the whole
        # batch's sums, as the one-device loss does
        loss = pointmap_regression_loss(
            torch.stack(pts).float(), self.tensor(batch, "gt_world_pts"),
            self.tensor(batch, "mask"), torch.stack(conf).float(), self.conf_alpha,
            group=self.place.group["dp"])
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
                 weight_decay: float = 1e-2, temporal_weight: float = 1.0, mesh=None):
        super().__init__(network, learning_rate, weight_decay, mesh)
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
