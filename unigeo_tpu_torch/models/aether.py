"""AETHER-class geometry-aware world model (DiT + rectified flow), port of
``unigeo_tpu/models/aether.py``.

  CausalVAE3D  a causal 3D video VAE: temporal convolutions pad only on the
               past (copies of frame 0), so a clip's prefix encodes to the
               prefix of its encoding; spatial cs = 2^len(mults), temporal
               ct = 2^sum(temporal_down) compression.  Activations are
               [T, C, H, W] (frames as the batch), so GroupNorm normalises
               each frame on its own, as flax's GroupNorm does on the JAX
               package's [T, H, W, C].  The decoder's nearest x2 upsample
               is folded into the conv after it (one 2x2 kernel per output
               phase).
  AetherDiT    a diffusion transformer with adaLN-zero conditioning: the
               modulation projections and the output projection start at
               zero, so the random network outputs exactly 0; one sequence
               over all space-time patch tokens (3D attention through
               ``layers.attend``: the flash kernel from 128 tokens on).
  flow sampler rectified-flow Euler, t = 1 - i/N, x <- x - v/N.

The adapter (registered as ``Aether``) encodes the clip, denoises
[depth latents | raymap] conditioned on the RGB latents, decodes the depth
latents, and recovers the cameras from the raymaps on the host in f64
(closed form: mean origin, Kabsch on the directions), frame 0 as the world.
Module names are the JAX package's (``encoder.enc_res0.conv1.conv``,
``dit.stack.blocks.N.adaLN_modulation``: its scan over the DiT blocks is a
layer list here), so ``utils/weights.py::aether_state_dicts`` carries its
parameters over structurally.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from unigeo_tpu_torch.device import exact_f32
from unigeo_tpu_torch.metrics.camera import matrix_to_quaternion, quaternion_to_matrix
from unigeo_tpu_torch.models.layers import (Attention, GroupNorm, frame_shard,
                                             sinusoidal_embedding)
from unigeo_tpu_torch.models.pointmap import adapter
from unigeo_tpu_torch.models.vit import MLP, sincos_2d_pos_embed
from unigeo_tpu_torch.ops.backproject import backproject_to_cv_position
from unigeo_tpu_torch.ops.normals import surface_normals_from_points
from unigeo_tpu_torch.registry import MODELS

RAYMAP_CHANNELS = 6

# ---------------------------------------------------------------------------
# Causal 3D video VAE, on [T, C, H, W]
# ---------------------------------------------------------------------------


class CausalConv3d(nn.Module):
    """Conv3d over [T, C, H, W]: 'same' spatial zero padding, kt - st copies
    of frame 0 before the clip (the past only), strides (st, sh, sw)."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int, int] = (3, 3, 3),
                 strides: Tuple[int, int, int] = (1, 1, 1)):
        super().__init__()
        kt, kh, kw = kernel
        self.kt, self.st = kt, strides[0]
        self.conv = nn.Conv3d(cin, cout, kernel, stride=strides, padding=(0, kh // 2, kw // 2))

    def pad(self, x):
        if self.kt - self.st > 0:
            x = torch.cat([x[:1].expand(self.kt - self.st, *x.shape[1:]), x])
        return x.transpose(0, 1)[None]  # [1, C, T, H, W]

    def forward(self, x):
        return self.conv(self.pad(x))[0].transpose(0, 1)


# output phase a (row 2i + a) of a 3-tap kernel over the nearest x2 input
# reads the input's rows (i - 1, i) for a = 0 and (i, i + 1) for a = 1, the
# taps summed as these rows say
_PHASE_TAPS = (((1.0, 0.0, 0.0), (0.0, 1.0, 1.0)),
               ((1.0, 1.0, 0.0), (0.0, 0.0, 1.0)))


def upsample2x_conv3d(x5, weight, bias):
    """conv3d(nearest_up2_spatial(x5)) with 'same' spatial padding, valid in
    time, for x5 [1, C, T, H, W] and a 3x3-spatial weight [out, in, kt, 3,
    3] -> [T - kt + 1, out, 2H, 2W], computed on x5 as it is: one conv3d
    whose 4 x out channels hold a 2x2 spatial kernel per output phase (the
    3x3 taps summed per phase; 4 products an output pixel where the
    upsampled conv takes 9), the phases then interleaved."""
    m = torch.tensor(_PHASE_TAPS, dtype=weight.dtype, device=weight.device)
    k = torch.einsum("aui,bvj,octij->aboctuv", m, m, weight)  # [2, 2, out, in, kt, 2, 2]
    cout = weight.shape[0]
    y = F.conv3d(x5, k.reshape(4 * cout, *weight.shape[1:3], 2, 2), bias.repeat(4),
                 padding=(0, 1, 1))[0]
    t, h, w = y.shape[1], y.shape[2] - 1, y.shape[3] - 1
    y = y.view(2, 2, cout, t, h + 1, w + 1)
    out = y.new_empty(t, cout, 2 * h, 2 * w)
    for a in range(2):
        for b in range(2):
            out[:, :, a::2, b::2] = y[a, b, :, :, a:a + h, b:b + w].transpose(0, 1)
    return out


class Upsample2xConv3d(CausalConv3d):
    """The 3x3x3 ``CausalConv3d`` of a nearest x2 spatial upsample, on the
    input before the upsample (``upsample2x_conv3d``); the JAX package's
    fused and plain decoders both compute it.  Same parameters (``conv``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout)

    def forward(self, x):
        return upsample2x_conv3d(self.pad(x), self.conv.weight, self.conv.bias)


class CausalResBlock3d(nn.Module):
    """GroupNorm -> silu -> conv, twice, plus the input (through ``skip``, a
    dense layer on the channels, where the width changes)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = GroupNorm(cin)
        self.conv1 = CausalConv3d(cin, cout)
        self.norm2 = GroupNorm(cout)
        self.conv2 = CausalConv3d(cout, cout)
        if cin != cout:
            self.skip = nn.Linear(cin, cout)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "skip"):
            x = self.skip(x.transpose(1, -1)).transpose(1, -1)
        return x + h


class VAEEncoder3D(nn.Module):
    """frames [T, 3, H, W] -> mean latents [T/ct, z, H/cs, W/cs]."""

    def __init__(self, base_width: int, mults: Sequence[int], temporal_down: Sequence[bool],
                 z_channels: int):
        super().__init__()
        self.z_channels = z_channels
        self.stem = CausalConv3d(3, base_width)
        c = base_width
        for i, m in enumerate(mults):
            w = base_width * m
            self.add_module(f"enc_res{i}", CausalResBlock3d(c, w))
            ts = 2 if temporal_down[i] else 1
            self.add_module(f"enc_down{i}", CausalConv3d(w, w, strides=(ts, 2, 2)))
            c = w
        self.depth = len(mults)
        self.enc_mid = CausalResBlock3d(c, c)
        self.enc_norm = GroupNorm(c)
        self.enc_out = CausalConv3d(c, 2 * z_channels, kernel=(1, 1, 1))

    def forward(self, frames):
        x = self.stem(frames)
        for i in range(self.depth):
            x = getattr(self, f"enc_down{i}")(getattr(self, f"enc_res{i}")(x))
        x = self.enc_mid(x)
        moments = self.enc_out(F.silu(self.enc_norm(x)))
        return moments[:, :self.z_channels]  # the posterior's mean (eval mode)


class VAEDecoder3D(nn.Module):
    """latents [T', z, h, w] -> frames [T, 3, H, W] (unbounded; trained to
    [-1, 1]).  A temporal upsample repeats each frame (latent k -> frames
    2k and 2k+1); the spatial one is nearest x2 before the conv, computed
    by ``Upsample2xConv3d``."""

    def __init__(self, base_width: int, mults: Sequence[int], temporal_down: Sequence[bool],
                 z_channels: int):
        super().__init__()
        self.temporal_down = tuple(temporal_down)
        c = base_width * mults[-1]
        self.dec_in = CausalConv3d(z_channels, c, kernel=(1, 1, 1))
        self.dec_mid = CausalResBlock3d(c, c)
        for i in reversed(range(len(mults))):
            w = base_width * mults[i]
            self.add_module(f"dec_up{i}", Upsample2xConv3d(c, w))
            self.add_module(f"dec_res{i}", CausalResBlock3d(w, w))
            c = w
        self.dec_norm = GroupNorm(c)
        self.dec_out = CausalConv3d(c, 3)

    def forward(self, z):
        x = self.dec_mid(self.dec_in(z))
        for i in reversed(range(len(self.temporal_down))):
            if self.temporal_down[i]:
                x = x.repeat_interleave(2, dim=0)
            x = getattr(self, f"dec_res{i}")(getattr(self, f"dec_up{i}")(x))
        return self.dec_out(F.silu(self.dec_norm(x)))


class CausalVAE3D(nn.Module):
    """[T, 3, H, W] in [-1, 1] <-> latents [T/ct, z, H/cs, W/cs]."""

    def __init__(self, base_width: int = 64, mults: Sequence[int] = (1, 2, 4),
                 temporal_down: Sequence[bool] = (False, True, True), z_channels: int = 8,
                 fused_upsample: bool = True):
        """``fused_upsample``, the JAX package's choice between two ways of
        one function, is accepted for its configs and has no effect."""
        super().__init__()
        self.z_channels = z_channels
        self.ct = int(2 ** sum(bool(b) for b in temporal_down))
        self.cs = int(2 ** len(mults))
        self.encoder = VAEEncoder3D(base_width, mults, temporal_down, z_channels)
        self.decoder = VAEDecoder3D(base_width, mults, temporal_down, z_channels)

    def encode(self, frames):
        return self.encoder(frames)

    def decode(self, z):
        return self.decoder(z)


# ---------------------------------------------------------------------------
# DiT with adaLN-zero, on tokens [1, S, C]
# ---------------------------------------------------------------------------


def layer_norm(x):
    """flax's parameter-free ``nn.LayerNorm`` (epsilon 1e-6)."""
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


def modulate(x, shift, scale):
    """x [B, S, C]; shift, scale [B, C]."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class DiTBlock(nn.Module):
    """Pre-LN block whose norms are modulated by shift / scale / gate vectors
    regressed from the condition through ``adaLN_modulation`` (zero at
    init: the block is then the identity)."""

    def __init__(self, width: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.adaLN_modulation = nn.Linear(width, 6 * width)
        self.attn = Attention(width, num_heads)
        self.mlp = MLP(width, mlp_ratio)

    def forward(self, x, cond):
        (sa_shift, sa_scale, sa_gate,
         mlp_shift, mlp_scale, mlp_gate) = self.adaLN_modulation(F.silu(cond)).chunk(6, dim=-1)
        h = modulate(layer_norm(x), sa_shift, sa_scale)
        # tokens split over ranks by latent frame: the local queries meet
        # every rank's keys and values
        shard = frame_shard()
        x = x + sa_gate[:, None, :] * self.attn(h, None if shard is None else shard.gather(h, 1))
        return x + mlp_gate[:, None, :] * self.mlp(modulate(layer_norm(x), mlp_shift, mlp_scale))


class DiTStack(nn.Module):
    def __init__(self, depth: int, width: int, num_heads: int, mlp_ratio: int):
        super().__init__()
        self.blocks = nn.ModuleList([DiTBlock(width, num_heads, mlp_ratio) for _ in range(depth)])

    def forward(self, x, cond):
        for block in self.blocks:
            x = block(x, cond)
        return x


class AetherDiT(nn.Module):
    """Velocity network: ([T', Cin, h, w], t) -> [T', out_channels, h, w].

    Tokens are the p x p latent patches of all frames in one sequence;
    positions the spatial 2D sin-cos table plus a temporal 1D sinusoid
    (sin first), summed."""

    def __init__(self, in_channels: int, out_channels: int, width: int = 384, depth: int = 12,
                 num_heads: int = 6, patch: int = 2, mlp_ratio: int = 4):
        super().__init__()
        self.width, self.patch, self.out_channels = width, patch, out_channels
        self.patchify = nn.Conv2d(in_channels, width, patch, stride=patch)
        self.t_embed1 = nn.Linear(256, width)
        self.t_embed2 = nn.Linear(width, width)
        self.stack = DiTStack(depth, width, num_heads, mlp_ratio)
        self.final_modulation = nn.Linear(width, 2 * width)
        self.final_proj = nn.Linear(width, patch * patch * out_channels)

    @torch.no_grad()
    def zero_init_(self) -> "AetherDiT":
        """adaLN-zero: the modulations (kernel and bias) and the output
        projection's kernel (its bias is zero already) at 0."""
        for block in self.stack.blocks:
            block.adaLN_modulation.weight.zero_()
            block.adaLN_modulation.bias.zero_()
        self.final_modulation.weight.zero_()
        self.final_modulation.bias.zero_()
        self.final_proj.weight.zero_()
        return self

    def positions(self, tl: int, gh: int, gw: int, device) -> torch.Tensor:
        """[tl * gh * gw, width] f32: spatial table + temporal sinusoid."""
        spatial = sincos_2d_pos_embed(self.width, gh, gw, device=device)
        temporal = sinusoidal_embedding(torch.arange(tl, device=device), self.width,
                                        flip_sin_to_cos=False)
        return (spatial[None] + temporal[:, None, :]).reshape(tl * gh * gw, self.width)

    def forward(self, x, t, pos: Optional[torch.Tensor] = None):
        tl, _, h, w = x.shape
        p = self.patch
        gh, gw = h // p, w // p
        dtype = self.patchify.weight.dtype
        tokens = self.patchify(x.to(dtype)).flatten(2).transpose(1, 2)  # [T', gh*gw, C]
        if pos is None:
            pos = self.positions(tl, gh, gw, x.device)
        tokens = (tokens.reshape(tl * gh * gw, self.width) + pos.to(dtype))[None]
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(1)
        temb = sinusoidal_embedding(t, 256).to(dtype)
        cond = self.t_embed2(F.silu(self.t_embed1(temb)))  # [1, C]
        tokens = self.stack(tokens, cond)
        shift, scale = self.final_modulation(F.silu(cond)).chunk(2, dim=-1)
        out = self.final_proj(modulate(layer_norm(tokens), shift, scale))
        # the projection's channels are (patch row, patch column, C)
        out = out.reshape(tl, gh, gw, p, p, self.out_channels)
        return out.permute(0, 5, 1, 3, 2, 4).reshape(tl, self.out_channels, h, w)


def flow_sample(velocity, cond_lat, noise, steps: int):
    """Rectified-flow Euler from t = 1 to 0: x_t = (1 - t) x0 + t eps has the
    constant velocity eps - x0, which ``velocity([cond | x], t)`` regresses;
    x <- x - v / steps at t = 1 - i / steps (f32), the carry in its dtype."""
    x = noise
    for i in range(steps):
        t = torch.tensor(1.0, dtype=torch.float32) - torch.tensor(float(i)) / steps
        v = velocity(torch.cat([cond_lat, x], dim=1), t)
        x = x - (1.0 / steps) * v.to(x.dtype)
    return x


class AetherNetwork(CausalVAE3D):
    """The VAE (``encoder``, ``decoder``) and the velocity DiT (``dit``) in
    one module: the DiT reads [RGB latents | target] and regresses the
    target's velocity, the target being [depth latents | raymap]."""

    def __init__(self, vae_config: Optional[Dict[str, Any]] = None,
                 network_config: Optional[Dict[str, Any]] = None):
        super().__init__(**(vae_config or {}))
        self.target_channels = self.z_channels + RAYMAP_CHANNELS
        self.dit = AetherDiT(self.z_channels + self.target_channels, self.target_channels,
                             **(network_config or {}))

    def sample(self, cond_lat, noise, steps: int):
        """The flow sampler over the DiT, positions computed once."""
        tl, _, h, w = cond_lat.shape
        pos = self.dit.positions(tl, h // self.dit.patch, w // self.dit.patch, cond_lat.device)
        return flow_sample(lambda x, t: self.dit(x, t, pos), cond_lat, noise, steps)


# ---------------------------------------------------------------------------
# Raymaps and camera recovery (host, numpy f64)
# ---------------------------------------------------------------------------


def camera_rays(intrinsic, h: int, w: int) -> np.ndarray:
    """Unit OpenCV camera rays [h, w, 3] through pixel (u, v): z = 1 at
    x = (u - cx) / fx, normalised; f64."""
    intrinsic = np.asarray(intrinsic, dtype=np.float64)
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64),
                         indexing="xy")
    d = np.stack([(uu - intrinsic[0, 2]) / intrinsic[0, 0],
                  (vv - intrinsic[1, 2]) / intrinsic[1, 1], np.ones_like(uu)], axis=-1)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def raymap_from_pose(c2w, intrinsic, h: int, w: int) -> np.ndarray:
    """The raymap [h, w, 6] of a c2w pose: world unit directions, then the
    camera origin."""
    c2w = np.asarray(c2w, dtype=np.float64)
    d_world = camera_rays(intrinsic, h, w) @ c2w[:3, :3].T
    origin = np.broadcast_to(c2w[:3, 3], d_world.shape)
    return np.concatenate([d_world, origin], axis=-1)


def pose_from_raymap(raymap, intrinsic) -> np.ndarray:
    """A c2w pose [4, 4] from a raymap [h, w, 6]: the mean origin, and the
    rotation by Kabsch between the intrinsics' camera rays and the
    directions."""
    raymap = np.asarray(raymap, dtype=np.float64)
    h, w, _ = raymap.shape
    d_world = raymap[..., :3]
    d_world = d_world / np.maximum(np.linalg.norm(d_world, axis=-1, keepdims=True), 1e-8)
    a = camera_rays(intrinsic, h, w).reshape(-1, 3)
    m = d_world.reshape(-1, 3).T @ a  # R with b = R a
    u, _, vt = np.linalg.svd(m)
    pose = np.eye(4)
    pose[:3, :3] = u @ np.diag([1.0, 1.0, np.linalg.det(u @ vt)]) @ vt
    pose[:3, 3] = raymap[..., 3:].reshape(-1, 3).mean(axis=0)
    return pose


def latent_key_times(tl: int, ct: int, pad: int, t: int) -> np.ndarray:
    """The time of each latent keyframe: latent i covers input frames
    [i ct - pad, (i + 1) ct - pad) and is anchored at the last of them."""
    return np.minimum((np.arange(tl) + 1) * ct - 1 - pad, t - 1).astype(np.float64)


def interpolate_poses(key_poses, key_times, query_times) -> np.ndarray:
    """Per-frame poses from keyframe poses: slerp of the rotations'
    quaternions (f32, as the JAX package takes them), linear translations."""
    key_poses = np.asarray(key_poses)
    key_times = np.asarray(key_times, dtype=np.float64)
    quats = matrix_to_quaternion(torch.from_numpy(np.ascontiguousarray(key_poses[:, :3, :3])))
    quats = quats.numpy().copy()
    for i in range(1, len(quats)):  # the short arc
        if np.dot(quats[i], quats[i - 1]) < 0:
            quats[i] = -quats[i]
    out = []
    for t in np.asarray(query_times, dtype=np.float64):
        if len(key_times) == 1:
            out.append(key_poses[0])
            continue
        i = int(np.clip(np.searchsorted(key_times, t, side="right") - 1, 0, len(key_times) - 2))
        t0, t1 = key_times[i], key_times[i + 1]
        a = 0.0 if t1 == t0 else float(np.clip((t - t0) / (t1 - t0), 0, 1))
        q0, q1 = quats[i], quats[i + 1]
        dot = float(np.clip(np.dot(q0, q1), -1.0, 1.0))
        if dot > 0.9995:  # nearly parallel: lerp
            q = (1 - a) * q0 + a * q1
        else:
            th = np.arccos(dot)
            q = (np.sin((1 - a) * th) * q0 + np.sin(a * th) * q1) / np.sin(th)
        q = q / np.linalg.norm(q)
        pose = np.eye(4)
        pose[:3, :3] = quaternion_to_matrix(torch.from_numpy(np.asarray(q))).numpy()
        pose[:3, 3] = (1 - a) * key_poses[i, :3, 3] + a * key_poses[i + 1, :3, 3]
        out.append(pose)
    return np.stack(out)


def poses_from_raymaps(raymaps, intrinsic, t: int, ct: int, cs: int) -> np.ndarray:
    """Sampled raymaps [T', h, w, 6] -> c2w poses [t, 4, 4] (f64), frame 0
    the world: each keyframe's pose on the latent grid (the intrinsics
    scaled by 1 / cs, no half-pixel shift), interpolated to every frame."""
    tl = raymaps.shape[0]
    intr_lat = np.diag([1.0 / cs, 1.0 / cs, 1.0]) @ np.asarray(intrinsic)
    key_poses = np.stack([pose_from_raymap(raymaps[i], intr_lat) for i in range(tl)])
    poses = interpolate_poses(key_poses, latent_key_times(tl, ct, (-t) % ct, t), np.arange(t))
    return np.linalg.inv(poses[0])[None] @ poses


# ---------------------------------------------------------------------------
# Adapter
# ---------------------------------------------------------------------------


@MODELS.register("Aether")
class Aether(adapter.RandomInitAdapter):
    """clip -> RGB latents -> rectified-flow denoise of [depth | raymap] ->
    all four prediction families."""

    network_cls = AetherNetwork

    def __init__(
        self,
        network_config: Optional[Dict[str, Any]] = None,
        vae_config: Optional[Dict[str, Any]] = None,
        checkpoint_path: Optional[str] = None,
        num_steps: int = 4,
        seed: int = 0,
        init_height: int = 384,
        init_width: int = 512,
        init_frames: int = 8,
        compute_dtype: Optional[str] = None,
        transfer_dtype: Optional[str] = None,
        # reference-config keys, accepted and ignored as the JAX adapter does
        model_dir: Optional[str] = None,
        device="cuda",
        **_: Dict,
    ):
        """The JAX adapter's keywords (``init_*`` only shaped its init) and
        the ``device`` the network is built on."""
        self.num_steps, self.seed = int(num_steps), seed
        self._build(dict(vae_config=vae_config, network_config=network_config),
                    checkpoint_path, seed, compute_dtype, transfer_dtype, device)
        if not checkpoint_path:
            self.network.dit.zero_init_()

    @staticmethod
    def state_dict_of(params):
        """The checkpoint layout {"vae", "dit"} (the JAX adapter's) -> the
        network's state dict, the DiT's keys under ``dit.``."""
        if set(params) != {"vae", "dit"}:
            raise KeyError(f"checkpoint keys {sorted(params)}, Aether loads ['dit', 'vae']")
        return {**params["vae"], **{f"dit.{k}": v for k, v in params["dit"].items()}}

    @staticmethod
    def checkpoint_of(network: nn.Module):
        sd = network.state_dict()
        return {"vae": {k: v for k, v in sd.items() if not k.startswith("dit.")},
                "dit": network.dit.state_dict()}

    def denoise(self, raw: torch.Tensor, noise: Optional[torch.Tensor] = None):
        """raw [T, 3, H, W] 0..255 on the device -> (decoded frames [T, 3, H,
        W] f32, raymaps [T', h, w, 6] f32): x2 - 1, a left pad to a multiple
        of ct with copies of frame 0, encode, sample from ``noise`` [T',
        target, h, w] (drawn from a generator seeded with ``seed`` when not
        given), decode the depth latents, crop the pad."""
        net = self.network
        t = raw.shape[0]
        inp = raw / 255.0 * 2.0 - 1.0
        pad = (-t) % net.ct
        if pad:
            inp = torch.cat([inp[:1].expand(pad, *inp.shape[1:]), inp])
        if self.compute_dtype is not None:
            inp = inp.to(self.compute_dtype)
        cond_lat = net.encode(inp)
        if noise is None:
            tl, _, h, w = cond_lat.shape
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            noise = torch.randn((tl, net.target_channels, h, w), generator=gen,
                                device=self.device, dtype=self.compute_dtype or torch.float32)
        sampled = net.sample(cond_lat, noise.to(self.device), self.num_steps)
        raymaps = sampled[:, net.z_channels:].float().permute(0, 2, 3, 1)
        decoded = net.decode(sampled[:, :net.z_channels])[pad:].float()
        return decoded, raymaps

    @torch.no_grad()
    def forward_tensors(self, data: Dict[str, Any],
                        noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One clip -> {pred_depths, pred_normals, pred_world_pts, pred_poses}
        as f32 tensors on the device (the poses through the host's f64
        recovery), and the sampled raymaps under "raymaps"."""
        raw = torch.from_numpy(adapter.raw_clip(data)).to(self.device)
        t = raw.shape[0]
        intr = np.stack(np.asarray(data["intrinsics"])).astype(np.float32)
        intr_dev = torch.from_numpy(intr).to(self.device)
        f32 = exact_f32() if self.compute_dtype is None else contextlib.nullcontext()
        with f32:
            decoded, raymaps = self.denoise(raw, noise)
        with exact_f32():
            depths = ((decoded.mean(dim=1) + 1.0) / 2.0).clamp_min(1e-3)
            pts_cam = backproject_to_cv_position(depths, intr_dev)
            flip = torch.tensor(adapter.OPENGL_FLIP, device=self.device)
            normals = surface_normals_from_points(pts_cam) * flip
            poses = poses_from_raymaps(raymaps.cpu().double().numpy(), intr[0], t,
                                       self.network.ct, self.network.cs)
            poses = torch.from_numpy(poses.astype(np.float32)).to(self.device)
            pts_world = (torch.einsum("nij,nhwj->nhwi", poses[:, :3, :3], pts_cam)
                         + poses[:, None, None, :3, 3])
        return {"pred_depths": depths, "pred_normals": normals, "pred_world_pts": pts_world,
                "pred_poses": poses, "raymaps": raymaps}

    def forward(self, data: Dict[str, Any]) -> Dict[str, Any]:
        outs = self.forward_tensors(data)
        outs.pop("raymaps")
        return adapter.fetch_outputs(outs, self.transfer_dtype)


def tiny_aether_configs():
    """(network_config, vae_config) of the JAX package's ``tiny_aether``:
    spatial 8x, temporal 2x compression."""
    return (dict(width=32, depth=2, num_heads=2, patch=2, mlp_ratio=2),
            dict(base_width=8, mults=(1, 1, 2), temporal_down=(False, True, False),
                 z_channels=4))


def tiny_aether(num_steps: int = 2, device="cuda", **kw) -> Aether:
    network_config, vae_config = tiny_aether_configs()
    return Aether(network_config=network_config, vae_config=vae_config, num_steps=num_steps,
                  device=device, **kw)

