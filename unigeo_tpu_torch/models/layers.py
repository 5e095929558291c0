"""Shared building blocks, PyTorch port of ``unigeo_tpu/models/layers.py``.

Module and parameter names follow diffusers (``to_q``, ``to_out.0``,
``ff.net.0.proj``, ``time_mixer.mix_factor``), so a state dict of the port has
the upstream key names.  Convolutions run NCHW; token sequences are
``[B, S, C]`` as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from unigeo_tpu_torch.ops.attention import (
    MIN_KERNEL_SEQ,
    attention_packed_reference,
    flash_attention_packed,
)


def sinusoidal_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Transformer sinusoidal timestep embedding ([N] -> [N, dim]), in f32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    )
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """linear_1 -> silu -> linear_2 (diffusers TimestepEmbedding)."""

    def __init__(self, in_dim: int, dim: int, hidden_dim: Optional[int] = None):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, hidden_dim or dim)
        self.linear_2 = nn.Linear(hidden_dim or dim, dim)

    def forward(self, x):
        x = x.to(self.linear_1.weight.dtype)
        return self.linear_2(F.silu(self.linear_1(x)))


def group_count(channels: int, num_groups: int = 32) -> int:
    """The JAX package's group count: the largest divisor of C that is at
    most ``num_groups`` (``torch.nn.GroupNorm`` raises instead)."""
    groups = min(num_groups, channels)
    while channels % groups:
        groups -= 1
    return groups


class GroupNorm(nn.GroupNorm):
    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(group_count(channels), channels, eps=eps)


def attend(q, k, v, num_heads: int, head_dim: int):
    """Packed attention dispatch, as ``layers.py::Attention`` does it: query
    sequences of at least 128 tokens go to the flash kernel, shorter ones
    (the 25-frame temporal attention) to the plain version in their dtype."""
    scale = head_dim**-0.5
    if q.shape[1] >= MIN_KERNEL_SEQ:
        return flash_attention_packed(q, k, v, num_heads, scale)
    return attention_packed_reference(q, k, v, num_heads, scale, upcast=False)


class Attention(nn.Module):
    """Multi-head attention over [B, S, C] with an optional cross context."""

    def __init__(
        self,
        query_dim: int,
        num_heads: int,
        head_dim: Optional[int] = None,
        context_dim: Optional[int] = None,
        qkv_bias: bool = False,
        out_bias: bool = True,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim or query_dim // num_heads
        inner = self.head_dim * num_heads
        ctx = context_dim or query_dim
        self.to_q = nn.Linear(query_dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(ctx, inner, bias=qkv_bias)
        self.to_v = nn.Linear(ctx, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim, bias=out_bias)])

    def forward(self, x, context=None):
        b, s, c = x.shape
        if context is not None and context.shape[1] == 1:
            # single-key cross-attention: softmax over one logit is 1, so
            # every query receives v (layers.py:111-120); q and k are not
            # computed at all
            out = self.to_out[0](self.to_v(context))
            return out.expand(b, s, out.shape[-1])
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        out = attend(q, k, v, self.num_heads, self.head_dim)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        # erf gelu in f32, tanh gelu in bf16 (layers.py:180)
        approx = "tanh" if gate.dtype == torch.bfloat16 else "none"
        return h * F.gelu(gate, approximate=approx)


class FeedForward(nn.Module):
    """GEGLU feed-forward: net.0 (GEGLU), net.1 (dropout slot), net.2."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList(
            [GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)]
        )

    def forward(self, x):
        for m in self.net:
            x = m(x)
        return x


class AlphaBlender(nn.Module):
    """alpha = sigmoid(mix_factor); alpha*spatial + (1-alpha)*temporal, with
    alpha flipped by ``switch`` (the temporal VAE decoder)."""

    def __init__(self, merge_factor: float = 0.5, switch: bool = False):
        super().__init__()
        self.merge_factor = merge_factor
        self.switch = switch
        self.mix_factor = nn.Parameter(torch.full((1,), float(merge_factor)))

    def forward(self, x_spatial, x_temporal):
        alpha = torch.sigmoid(self.mix_factor)[0]
        if self.switch:
            alpha = 1.0 - alpha
        return alpha * x_spatial + (1.0 - alpha) * x_temporal


class Conv2d(nn.Conv2d):
    """3x3 / 1x1 conv, 'same' padding by default.

    ``fuse_upsample2x``: computes ``conv3x3(nearest_up2(x))`` as one
    stride-2 transposed conv on the low-resolution input, the counterpart of
    the JAX package's lhs-dilated conv (layers.py:288-324).  The 3x3 kernel
    summed over a 2x2 window gives a 4x4 kernel K'; a transposed conv
    correlates the dilated input with its kernel flipped, so it is given K'
    flipped.  Same parameters as the plain conv.
    """

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: Optional[int] = None, fuse_upsample2x: bool = False):
        pad = kernel // 2 if padding is None else padding
        super().__init__(cin, cout, kernel, stride=stride, padding=pad)
        if fuse_upsample2x and (kernel != 3 or stride != 1 or padding is not None):
            raise ValueError("fuse_upsample2x takes a 3x3, stride-1, same conv")
        self.fuse_upsample2x = fuse_upsample2x

    def forward(self, x):
        if not self.fuse_upsample2x:
            return super().forward(x)
        w = self.weight  # [out, in, 3, 3]
        kp = w.new_zeros(w.shape[0], w.shape[1], 4, 4)
        for u in range(2):
            for v in range(2):
                kp[:, :, u:u + 3, v:v + 3] += w
        wt = kp.flip(-1, -2).transpose(0, 1)  # [in, out, 4, 4]
        return F.conv_transpose2d(x, wt, self.bias, stride=2, padding=1)


class TemporalConv(nn.Conv3d):
    """Conv over the frame axis only: kernel (k, 1, 1) on [B, C, T, H, W]."""

    def __init__(self, cin: int, cout: int, kernel: int = 3):
        super().__init__(cin, cout, (kernel, 1, 1), padding=(kernel // 2, 0, 0))
