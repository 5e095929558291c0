"""VAE with temporal decoder (SVD ``AutoencoderKLTemporalDecoder``), NCHW.

Port of ``unigeo_tpu/models/depthcrafter/vae.py`` with the diffusers module
tree (``encoder.down_blocks.0.resnets.0.conv1``, ``decoder.mid_block...``):

* ``Encoder``: SD-VAE encoder, per frame, mid block with single-head
  attention (d = 512 at SVD width, through the flash kernel).
* ``TemporalDecoder``: spatio-temporal resnets blended with a switched
  AlphaBlender (merge factor 0.0), mid attention, and a final frame-axis
  ``time_conv_out``.
* ``AutoencoderKLTemporal.encode`` returns the latent mode UNSCALED;
  ``decode`` divides by the 0.18215 scaling first.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from unigeo_tpu_torch.models.layers import (
    AlphaBlender,
    Conv2d,
    GroupNorm,
    TemporalConv,
    attend,
)

SVD_VAE_SCALING = 0.18215


class _Block(nn.Module):
    """Bare container, so children render as ``resnets.N`` / ``attentions.N``."""


class ResnetBlock2D(nn.Module):
    """diffusers ResnetBlock2D; ``temb_ch`` adds the time-embedding projection
    (the UNet flavour), None leaves it out (the VAE flavour)."""

    def __init__(self, cin: int, cout: int, temb_ch=None, eps: float = 1e-6):
        super().__init__()
        self.norm1 = GroupNorm(cin, eps)
        self.conv1 = Conv2d(cin, cout)
        if temb_ch:
            self.time_emb_proj = nn.Linear(temb_ch, cout)
        self.norm2 = GroupNorm(cout, eps)
        self.conv2 = Conv2d(cout, cout)
        self.conv_shortcut = Conv2d(cin, cout, kernel=1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        sc = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return sc + h


class TemporalResnetBlock(nn.Module):
    """Resnet over the frame axis of [B, C, T, H, W] with (3,1,1) convs."""

    def __init__(self, ch: int, temb_ch=None, eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(ch, eps)
        self.conv1 = TemporalConv(ch, ch)
        if temb_ch:
            self.time_emb_proj = nn.Linear(temb_ch, ch)
        self.norm2 = GroupNorm(ch, eps)
        self.conv2 = TemporalConv(ch, ch)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:  # [B, T, temb_ch] -> [B, C, T, 1, 1]
            h = h + self.time_emb_proj(F.silu(temb)).permute(0, 2, 1)[..., None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return x + h


class SpatioTemporalResBlock(nn.Module):
    """A spatial resnet per frame, a temporal resnet over the frames, and
    their AlphaBlender mix.  x [B*T, C, H, W]."""

    def __init__(self, cin: int, cout: int, temb_ch=None, eps: float = 1e-5,
                 temporal_eps: float = 1e-5, merge_factor: float = 0.5,
                 switch: bool = False):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(cin, cout, temb_ch, eps)
        self.temporal_res_block = TemporalResnetBlock(cout, temb_ch, temporal_eps)
        self.time_mixer = AlphaBlender(merge_factor, switch)

    def forward(self, x, temb, num_frames: int):
        s = self.spatial_res_block(x, temb)
        bt, c, hh, ww = s.shape
        b = bt // num_frames
        s5 = s.view(b, num_frames, c, hh, ww).permute(0, 2, 1, 3, 4)
        t_in = None if temb is None else temb.view(b, num_frames, -1)
        t5 = self.temporal_res_block(s5, t_in)
        out = self.time_mixer(s5, t5)
        return out.permute(0, 2, 1, 3, 4).reshape(bt, c, hh, ww)


class VaeAttnBlock(nn.Module):
    """Single-head attention with residual (diffusers Attention with
    bias on q/k/v/out); head width = channels."""

    def __init__(self, ch: int):
        super().__init__()
        self.group_norm = GroupNorm(ch, 1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        b, c, hh, ww = x.shape
        y = self.group_norm(x).flatten(2).transpose(1, 2)  # [B, HW, C]
        y = attend(self.to_q(y), self.to_k(y), self.to_v(y), 1, c)
        y = self.to_out[0](y)
        return x + y.transpose(1, 2).reshape(b, c, hh, ww)


class Encoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4):
        super().__init__()
        bocs = list(block_out_channels)
        self.conv_in = Conv2d(3, bocs[0])
        self.down_blocks = nn.ModuleList()
        ch = bocs[0]
        for i, out in enumerate(bocs):
            blk = _Block()
            resnets = []
            for _ in range(layers_per_block):
                resnets.append(ResnetBlock2D(ch, out))
                ch = out
            blk.resnets = nn.ModuleList(resnets)
            if i < len(bocs) - 1:
                down = _Block()
                down.conv = Conv2d(out, out, stride=2, padding=0)
                blk.downsamplers = nn.ModuleList([down])
            self.down_blocks.append(blk)
        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList([ResnetBlock2D(ch, ch), ResnetBlock2D(ch, ch)])
        self.mid_block.attentions = nn.ModuleList([VaeAttnBlock(ch)])
        self.conv_norm_out = GroupNorm(ch, 1e-6)
        self.conv_out = Conv2d(ch, 2 * latent_channels)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for resnet in blk.resnets:
                h = resnet(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block.resnets[0](h)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))  # mean ++ logvar


class TemporalDecoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 out_channels: int = 3):
        super().__init__()
        bocs = list(block_out_channels)
        top = bocs[-1]

        def st_block(cin, cout):
            return SpatioTemporalResBlock(cin, cout, None, 1e-6, 1e-5, 0.0, True)

        self.conv_in = Conv2d(latent_channels, top)
        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList([st_block(top, top), st_block(top, top)])
        self.mid_block.attentions = nn.ModuleList([VaeAttnBlock(top)])
        self.up_blocks = nn.ModuleList()
        prev = top
        for i, out in enumerate(reversed(bocs)):
            blk = _Block()
            resnets = []
            for _ in range(layers_per_block + 1):
                resnets.append(st_block(prev, out))
                prev = out
            blk.resnets = nn.ModuleList(resnets)
            if i < len(bocs) - 1:
                up = _Block()
                up.conv = Conv2d(out, out, fuse_upsample2x=True)
                blk.upsamplers = nn.ModuleList([up])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(bocs[0], 1e-6)
        self.conv_out = Conv2d(bocs[0], out_channels)
        self.time_conv_out = TemporalConv(out_channels, out_channels)

    def forward(self, z, num_frames: int):
        h = self.conv_in(z)
        h = self.mid_block.resnets[0](h, None, num_frames)
        h = self.mid_block.attentions[0](h)
        h = self.mid_block.resnets[1](h, None, num_frames)
        for blk in self.up_blocks:
            for resnet in blk.resnets:
                h = resnet(h, None, num_frames)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(h)
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        bt, c, hh, ww = h.shape
        b = bt // num_frames
        h5 = h.view(b, num_frames, c, hh, ww).permute(0, 2, 1, 3, 4)
        h5 = self.time_conv_out(h5)
        return h5.permute(0, 2, 1, 3, 4).reshape(bt, c, hh, ww)


class AutoencoderKLTemporal(nn.Module):
    """encode(frames) -> UNSCALED latent mode; decode(scaled latents) -> frames."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 scaling_factor: float = SVD_VAE_SCALING):
        super().__init__()
        self.latent_channels = latent_channels
        self.scaling_factor = scaling_factor
        self.encoder = Encoder(block_out_channels, layers_per_block, latent_channels)
        self.quant_conv = Conv2d(2 * latent_channels, 2 * latent_channels, kernel=1)
        self.decoder = TemporalDecoder(block_out_channels, layers_per_block, latent_channels)

    def encode(self, frames):
        """[N, 3, H, W] in [-1, 1] -> latent mode [N, 4, H/8, W/8], unscaled."""
        return self.quant_conv(self.encoder(frames))[:, : self.latent_channels]

    def decode(self, latents, num_frames: int):
        """Scaled latents [N, 4, h, w] -> frames [N, 3, H, W] (about [-1, 1])."""
        return self.decoder(latents / self.scaling_factor, num_frames)


def tiny_vae_config():
    return dict(block_out_channels=(16, 24, 32, 32), layers_per_block=1)
