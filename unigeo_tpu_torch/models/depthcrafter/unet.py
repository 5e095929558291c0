"""Spatio-temporal UNet (SVD-XT), NCHW.  Port of
``unigeo_tpu/models/depthcrafter/unet.py`` with the diffusers
``UNetSpatioTemporalConditionModel`` module tree.

Every stage interleaves spatial resnets and spatial transformers (frames
folded into the batch) with temporal resnets and temporal transformers (the
spatial grid folded into the batch), blended by AlphaBlenders.  Spatial
self-attention of at least 128 tokens per frame goes to the packed flash
kernel; temporal self-attention (25 tokens) and the single-key
cross-attentions do not.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from unigeo_tpu_torch.models.depthcrafter.vae import SpatioTemporalResBlock, _Block
from unigeo_tpu_torch.models.layers import (
    AlphaBlender,
    Attention,
    Conv2d,
    clips_in_batch,
    FeedForward,
    GroupNorm,
    TimestepEmbedding,
    sinusoidal_embedding,
)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, ctx_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads, head_dim)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, head_dim, context_dim=ctx_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class TemporalBasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, ctx_dim: int):
        super().__init__()
        self.norm_in = nn.LayerNorm(dim)
        self.ff_in = FeedForward(dim)
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads, head_dim)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, head_dim, context_dim=ctx_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):  # x [B*HW, T, C]
        x = x + self.ff_in(self.norm_in(x))
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class TransformerSpatioTemporal(nn.Module):
    def __init__(self, ch: int, heads: int, head_dim: int, ctx_dim: int):
        super().__init__()
        # tokens keep the channel width (SVD has heads*head_dim == channels;
        # the tiny test config does not, and the JAX package projects c -> c)
        self.norm = GroupNorm(ch, 1e-6)
        self.proj_in = nn.Linear(ch, ch)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(ch, heads, head_dim, ctx_dim)]
        )
        self.temporal_transformer_blocks = nn.ModuleList(
            [TemporalBasicTransformerBlock(ch, heads, head_dim, ctx_dim)]
        )
        self.time_pos_embed = TimestepEmbedding(ch, ch, hidden_dim=4 * ch)
        self.time_mixer = AlphaBlender(0.5)
        self.proj_out = nn.Linear(ch, ch)

    def forward(self, x, context, num_frames: int):
        bt, c, hh, ww = x.shape
        b = bt // num_frames
        hw = hh * ww
        residual = x
        h = self.norm(x).permute(0, 2, 3, 1).reshape(bt, hw, c)
        h = self.proj_in(h)
        h = self.transformer_blocks[0](h, context)

        # temporal pass over [B*HW, T, C]
        ht = h.view(b, num_frames, hw, c).transpose(1, 2).reshape(b * hw, num_frames, c)
        frames = torch.arange(num_frames, device=x.device)
        frame_emb = self.time_pos_embed(sinusoidal_embedding(frames, c))
        ht = ht + frame_emb[None]
        # first-frame context, shared by every spatial position (unet.py:152-172)
        ctx_first = context.view(b, num_frames, *context.shape[1:])[:, 0]
        ctx_t = ctx_first[:, None].expand(b, hw, *ctx_first.shape[1:])
        ctx_t = ctx_t.reshape(b * hw, *ctx_first.shape[1:])
        ht = self.temporal_transformer_blocks[0](ht, ctx_t)
        ht = ht.view(b, hw, num_frames, c).transpose(1, 2).reshape(bt, hw, c)

        h = self.time_mixer(h, ht)
        h = self.proj_out(h)
        return h.view(bt, hh, ww, c).permute(0, 3, 1, 2) + residual


class UNetSpatioTemporal(nn.Module):
    """forward(sample [B*T, in, h, w], timesteps [B], context [B*T, 1, ctx],
    added_time_ids [B, 3], num_frames) -> [B*T, out, h, w]."""

    def __init__(
        self,
        in_channels: int = 8,
        out_channels: int = 4,
        block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
        layers_per_block: int = 2,
        num_attention_heads: Sequence[int] = (5, 10, 20, 20),
        cross_attention_dim: int = 1024,
        addition_time_embed_dim: int = 256,
        head_dim: int = 64,
    ):
        super().__init__()
        bocs = list(block_out_channels)
        heads = list(num_attention_heads)
        ch0 = bocs[0]
        tdim = 4 * ch0
        self.ch0 = ch0
        self.add_dim = addition_time_embed_dim
        self.cross_attention_dim = cross_attention_dim
        ctx = cross_attention_dim

        self.conv_in = Conv2d(in_channels, ch0)
        self.time_embedding = TimestepEmbedding(ch0, tdim)
        self.add_embedding = TimestepEmbedding(3 * addition_time_embed_dim, tdim)

        n = len(bocs)
        skip_chs = [ch0]
        self.down_blocks = nn.ModuleList()
        ch = ch0
        for i, out in enumerate(bocs):
            blk = _Block()
            has_attn = i < n - 1
            resnets, attns = [], []
            for _ in range(layers_per_block):
                resnets.append(SpatioTemporalResBlock(ch, out, tdim))
                ch = out
                if has_attn:
                    attns.append(TransformerSpatioTemporal(out, heads[i], head_dim, ctx))
                skip_chs.append(out)
            blk.resnets = nn.ModuleList(resnets)
            if has_attn:
                blk.attentions = nn.ModuleList(attns)
            if i < n - 1:
                down = _Block()
                down.conv = Conv2d(out, out, stride=2, padding=1)
                blk.downsamplers = nn.ModuleList([down])
                skip_chs.append(out)
            self.down_blocks.append(blk)

        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList(
            [SpatioTemporalResBlock(ch, ch, tdim), SpatioTemporalResBlock(ch, ch, tdim)]
        )
        self.mid_block.attentions = nn.ModuleList(
            [TransformerSpatioTemporal(ch, heads[-1], head_dim, ctx)]
        )

        self.up_blocks = nn.ModuleList()
        prev = bocs[-1]
        for i, out in enumerate(reversed(bocs)):
            stage = n - 1 - i
            has_attn = stage < n - 1
            blk = _Block()
            resnets, attns = [], []
            for _ in range(layers_per_block + 1):
                skip = skip_chs.pop()
                resnets.append(SpatioTemporalResBlock(prev + skip, out, tdim))
                prev = out
                if has_attn:
                    attns.append(TransformerSpatioTemporal(out, heads[stage], head_dim, ctx))
            blk.resnets = nn.ModuleList(resnets)
            if has_attn:
                blk.attentions = nn.ModuleList(attns)
            if stage > 0:
                up = _Block()
                up.conv = Conv2d(out, out, fuse_upsample2x=True)
                blk.upsamplers = nn.ModuleList([up])
            self.up_blocks.append(blk)

        self.conv_norm_out = GroupNorm(ch0)
        self.conv_out = Conv2d(ch0, out_channels)

    def forward(self, sample, timesteps, context, added_time_ids, num_frames: int):
        # the convolutions run one clip at a time (layers.clipwise), so a
        # clip's output does not depend on its slot in a batch of clips
        with clips_in_batch(timesteps.shape[0]):
            return self._forward(sample, timesteps, context, added_time_ids, num_frames)

    def _forward(self, sample, timesteps, context, added_time_ids, num_frames: int):
        b = timesteps.shape[0]
        dtype = self.conv_in.weight.dtype
        # the embeddings start in f32 (sinusoids) and enter the MLPs at the
        # parameter dtype
        emb = self.time_embedding(sinusoidal_embedding(timesteps, self.ch0))
        add = sinusoidal_embedding(added_time_ids.reshape(-1), self.add_dim).reshape(b, -1)
        emb = (emb + self.add_embedding(add)).to(dtype)
        emb_bt = emb.repeat_interleave(num_frames, dim=0)

        h = self.conv_in(sample)
        skips = [h]
        for blk in self.down_blocks:
            for idx, resnet in enumerate(blk.resnets):
                h = resnet(h, emb_bt, num_frames)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[idx](h, context, num_frames)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(h)
                skips.append(h)

        h = self.mid_block.resnets[0](h, emb_bt, num_frames)
        h = self.mid_block.attentions[0](h, context, num_frames)
        h = self.mid_block.resnets[1](h, emb_bt, num_frames)

        for blk in self.up_blocks:
            for idx, resnet in enumerate(blk.resnets):
                h = torch.cat([h, skips.pop()], dim=1)
                h = resnet(h, emb_bt, num_frames)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[idx](h, context, num_frames)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(h)

        return self.conv_out(F.silu(self.conv_norm_out(h)))


def tiny_unet_config():
    """Small config for tests and CPU dry-runs (same as the JAX package's)."""
    return dict(
        block_out_channels=(32, 48, 64, 64),
        num_attention_heads=(1, 2, 2, 2),
        cross_attention_dim=32,
        addition_time_embed_dim=16,
        head_dim=16,
        layers_per_block=1,
    )
