"""Shared building blocks, PyTorch port of ``unigeo_tpu/models/layers.py``.

Module and parameter names follow diffusers (``to_q``, ``to_out.0``,
``ff.net.0.proj``, ``time_mixer.mix_factor``), so a state dict of the port has
the upstream key names.  Convolutions run NCHW; token sequences are
``[B, S, C]`` as in the JAX package.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from unigeo_tpu_torch.ops.attention import (
    MIN_KERNEL_SEQ,
    FlashAttentionPacked,
    attention_packed_reference,
    flash_attention,
    flash_attention_packed,
    use_packed_attention,
)
from unigeo_tpu_torch.ops.geglu import GegluFFN, geglu_ffn, use_fused_geglu
from unigeo_tpu_torch.ops.rope import apply_rope_2d, rope_2d_cos_sin


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
    """``nn.GroupNorm`` with the JAX package's group count.  Inside
    ``frames_sharded`` a 5-D [B, C, T, H, W] input holds this rank's block
    of the frames, and its group statistics are taken over every rank's
    frames (``sharded_group_norm``)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(group_count(channels), channels, eps=eps)

    def forward(self, x):
        shard = _FRAMES.get()
        if shard is not None and x.dim() == 5:
            return sharded_group_norm(x, self.num_groups, self.weight, self.bias, self.eps,
                                      shard)
        return super().forward(x)


def sharded_group_norm(x, groups: int, weight, bias, eps: float, shard):
    """Group norm of [B, C, T, H, W] whose frame axis is split over
    ``shard``'s ranks: each rank's per-(clip, group) mean and sum of squared
    deviations in f32, gathered and merged (Chan's formula over equal
    counts), then x normalised by the whole clip's statistics."""
    b = x.shape[0]
    xs = x.float().reshape(b, groups, -1)
    n = xs.shape[-1]
    mean = xs.mean(-1)
    m2 = (xs - mean[..., None]).square().sum(-1)
    both = shard.stacked(torch.stack([mean, m2]))  # [ranks, 2, B, G]
    means, m2s = both[:, 0], both[:, 1]
    mean = means.mean(0)
    var = (m2s.sum(0) + n * (means - mean).square().sum(0)) / (n * both.shape[0])
    y = (xs - mean[..., None]) * torch.rsqrt(var[..., None] + eps)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = y.reshape(x.shape) * weight.float().reshape(shape) + bias.float().reshape(shape)
    return y.to(x.dtype)


def attend(q, k, v, num_heads: int, head_dim: int):
    """Attention dispatch over packed [B, S, H*D] q, k, v, as
    ``layers.py::Attention`` does it: query sequences of at least 128 tokens
    go to the flash kernels, shorter ones (the 25-frame temporal attention)
    to the plain version in their dtype, differentiated by autograd.

    Under autograd (grad mode on and q, k or v requiring grad) the kernels
    are ``FlashAttentionPacked``: the forward with logsumexp, then the dq and
    dk/dv kernels, as the JAX package's ``attention_packed`` and
    ``_attention_tpu`` custom_vjps, in either layout.  Otherwise the forward
    kernel alone, which leaves no graph: the packed one, or under
    ``UNIGEO_PACKED_ATTN=0`` (read at each call) the head-split one on the
    [B, S, H, D] view."""
    scale = head_dim**-0.5
    if q.shape[1] >= MIN_KERNEL_SEQ:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return FlashAttentionPacked.apply(q, k, v, num_heads, scale)
        if use_packed_attention():
            return flash_attention_packed(q, k, v, num_heads, scale)
        split = lambda t: t.reshape(t.shape[0], t.shape[1], num_heads, head_dim)
        return flash_attention(split(q), split(k), split(v), scale).reshape(q.shape)
    return attention_packed_reference(q, k, v, num_heads, scale, upcast=False)


def masked_attention(q, k, v, ctx_mask, num_heads: int, head_dim: int):
    """Dense attention over packed [B, S, H*D] q, k, v in which keys with
    ctx_mask [Sk] or [B, Sk] false (or 0) get no weight, with the JAX
    package's formula (layers.py:139-154): logits -1e30 where masked,
    p = exp(logits - max), out = p v / max(sum p, 1e-30).  It never reaches
    a kernel (the flash kernels take no key mask); the ring-memory contexts
    it serves are a few thousand keys."""
    b, s, inner = q.shape
    sk = k.shape[1]
    qh = q.reshape(b, s, num_heads, head_dim)
    kh = k.reshape(b, sk, num_heads, head_dim)
    vh = v.reshape(b, sk, num_heads, head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * head_dim**-0.5
    valid = torch.as_tensor(ctx_mask, device=q.device).bool().reshape(-1, sk).expand(b, sk)
    logits = torch.where(valid[:, None, None, :], logits, torch.full_like(logits, -1e30))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True).clamp_min(1e-30).transpose(1, 2)
    return (torch.einsum("bhqk,bkhd->bqhd", p, vh) / denom).reshape(b, s, inner)


class Attention(nn.Module):
    """Multi-head attention over [B, S, C] with an optional cross context.

    ``rope_freq`` (the pointmap backbones' 2D RoPE base): q is rotated by
    ``pos`` and k by ``ctx_pos`` (``pos`` for self-attention) before the
    dispatch, as layers.py:122-137 of the JAX package does.  ``ctx_mask``
    sends the call to ``masked_attention``; everything else goes through
    ``attend``."""

    def __init__(
        self,
        query_dim: int,
        num_heads: int,
        head_dim: Optional[int] = None,
        context_dim: Optional[int] = None,
        qkv_bias: bool = False,
        out_bias: bool = True,
        rope_freq: Optional[float] = None,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim or query_dim // num_heads
        self.rope_freq = rope_freq
        inner = self.head_dim * num_heads
        ctx = context_dim or query_dim
        self.to_q = nn.Linear(query_dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(ctx, inner, bias=qkv_bias)
        self.to_v = nn.Linear(ctx, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim, bias=out_bias)])

    def _rope(self, t, pos):
        b, s, inner = t.shape
        cos, sin = rope_2d_cos_sin(self.head_dim, pos, self.rope_freq, t.dtype)
        th = t.reshape(b, s, self.num_heads, self.head_dim)
        return apply_rope_2d(th, cos, sin).reshape(b, s, inner)

    def forward(self, x, context=None, pos=None, ctx_pos=None, ctx_mask=None):
        b, s, c = x.shape
        if context is not None and context.shape[1] == 1:
            # single-key cross-attention: softmax over one logit is 1, so
            # every query receives v (layers.py:111-120); q and k are not
            # computed at all
            out = self.to_out[0](self.to_v(context))
            return out.expand(b, s, out.shape[-1])
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        if self.rope_freq is not None and pos is not None:
            q = self._rope(q, pos)
            kpos = pos if context is None else ctx_pos
            if kpos is not None:
                k = self._rope(k, kpos)
        if ctx_mask is not None:
            out = masked_attention(q, k, v, ctx_mask, self.num_heads, self.head_dim)
        else:
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
    """GEGLU feed-forward: net.0 (GEGLU), net.1 (dropout slot), net.2.

    Under ``UNIGEO_FUSED_GEGLU=1`` (read at each call) with bf16 input and
    weights it is one fused kernel (``ops/geglu.py``; ``GegluFFN`` under
    autograd) plus b2 in bf16, as the JAX package's ``FeedForward``;
    otherwise the unfused layers.  The parameters are the same either way."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList(
            [GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)]
        )

    def forward(self, x):
        w1, b1 = self.net[0].proj.weight, self.net[0].proj.bias
        if use_fused_geglu(x.dtype, w1.dtype):
            w2, b2 = self.net[2].weight, self.net[2].bias
            x = x.contiguous()
            if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2)):
                out = GegluFFN.apply(x, w1, b1, w2)
            else:
                out = geglu_ffn(x, w1, b1, w2)
            return out + b2.to(x.dtype)
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


# The clips of the batch a UNet evaluation runs (the frames of each clip
# consecutive along the batch): cuDNN computes a clip's rows of a
# convolution over several clips in another order by the clip's place in
# the batch (measured on the H100 in bf16 at SVD-XT width: the stride-2
# downsampler at 24 x 32 and 640 channels is the first op whose output for a
# clip changes with its slot; unigeo_tpu_torch/tools/order_bisect.py), so
# the convolutions run one clip at a time (``clipwise``): each clip then
# gets the bits of its own serial forward in any order.
_CLIPS = contextvars.ContextVar("unigeo_clips_in_batch", default=1)


@contextlib.contextmanager
def clips_in_batch(n: int):
    """Inside the block, ``clipwise`` ops split their batch into ``n`` clips."""
    token = _CLIPS.set(int(n))
    try:
        yield
    finally:
        _CLIPS.reset(token)


# The frame axis split over ranks (context parallelism, ``parallel/context.py``):
# a ``parallel.comm.FrameShard`` (None: every frame here).  Inside the block
# each clip's tensors hold this rank's consecutive block of its frames, and
# the layers that see other frames reach them through the shard: the
# temporal convolutions a one-frame halo from each neighbour, the temporal
# group norms statistics over every rank's frames, the temporal attention
# (and the Aether DiT's attention) every rank's keys and values.
_FRAMES = contextvars.ContextVar("unigeo_frames_sharded", default=None)


@contextlib.contextmanager
def frames_sharded(shard):
    """Inside the block the frame axis is split over ``shard``'s ranks."""
    token = _FRAMES.set(shard)
    try:
        yield
    finally:
        _FRAMES.reset(token)


def frame_shard():
    """The ``FrameShard`` of the enclosing ``frames_sharded``, or None."""
    return _FRAMES.get()


def clipwise(fn, x):
    """``fn(x)``, one call per clip of the current batch (``clips_in_batch``;
    x's leading dimension split into that many equal parts), concatenated."""
    n = _CLIPS.get()
    if n <= 1:
        return fn(x)
    return torch.cat([fn(xi) for xi in x.chunk(n)])


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
        return clipwise(self._forward, x)

    def _forward(self, x):
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
    """Conv over the frame axis only: kernel (k, 1, 1) on [B, C, T, H, W]
    (one clip at a time inside ``clips_in_batch``).  Inside
    ``frames_sharded`` the zero padding becomes the neighbours' k // 2
    frames (zeros at the clip's ends) and the conv runs unpadded."""

    def __init__(self, cin: int, cout: int, kernel: int = 3):
        super().__init__(cin, cout, (kernel, 1, 1), padding=(kernel // 2, 0, 0))

    def forward(self, x):
        shard = _FRAMES.get()
        if shard is None:
            return clipwise(super().forward, x)
        x = shard.halo(x, dim=2, width=self.kernel_size[0] // 2)
        return clipwise(lambda xi: F.conv3d(xi, self.weight, self.bias), x)
