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
from dataclasses import dataclass
from typing import Optional, Sequence

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
from unigeo_tpu_torch.parallel import comm


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
        return mlp_pair(self.linear_1, self.linear_2, x, F.silu)


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

    def takes_channel_block(self, spec: "TPSpec") -> bool:
        """Whether ``spec``'s equal channel blocks hold whole groups."""
        return self.num_groups % spec.size == 0

    def channel_block(self, x, spec: "TPSpec"):
        """The norm of x, which holds this tp rank's block of the channels
        (``takes_channel_block``): its groups, its slice of the affine (an
        all-gather of the slices' gradients in the backward, so the
        replicated affine gets the whole gradient on every rank)."""
        groups = self.num_groups // spec.size
        weight = scatter_to_group(self.weight, spec.group, 0)
        bias = scatter_to_group(self.bias, spec.group, 0)
        shard = _FRAMES.get()
        if shard is not None and x.dim() == 5:
            return sharded_group_norm(x, groups, weight, bias, self.eps, shard)
        return F.group_norm(x, groups, weight, bias, self.eps)


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
        th = t.reshape(b, s, inner // self.head_dim, self.head_dim)
        return apply_rope_2d(th, cos, sin).reshape(b, s, inner)

    def forward(self, x, context=None, pos=None, ctx_pos=None, ctx_mask=None):
        b, s, c = x.shape
        out_proj = self.to_out[0]
        if context is not None and context.shape[1] == 1:
            # single-key cross-attention: softmax over one logit is 1, so
            # every query receives v (layers.py:111-120); q and k are not
            # computed at all
            if tp_pair([self.to_v], out_proj) is not None:
                out = out_proj.row_from_local(self.to_v.column_local(context))
            else:
                out = out_proj(self.to_v(context))
            return out.expand(b, s, out.shape[-1])
        ctx = x if context is None else context
        spec = tp_pair([self.to_q, self.to_k, self.to_v], out_proj)
        if spec is None:
            q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
            return out_proj(self._attend(q, k, v, self.num_heads, context, pos, ctx_pos,
                                         ctx_mask))
        # tensor parallel: this rank's columns of q, k, v (its heads where tp
        # divides the heads), one reduce after to_out
        xc = copy_to_group(x, spec.group)
        cc = xc if context is None else copy_to_group(ctx, spec.group)
        q, k, v = (m.column_local(t, copied=True)
                   for m, t in ((self.to_q, xc), (self.to_k, cc), (self.to_v, cc)))
        if self.num_heads % spec.size == 0:
            out = self._attend(q, k, v, self.num_heads // spec.size, context, pos, ctx_pos,
                               ctx_mask)
        else:
            # heads cut by the shard boundary: every head here, then this
            # rank's slice of the features for to_out
            q, k, v = (gather_from_group(t, spec.group, -1) for t in (q, k, v))
            out = self._attend(q, k, v, self.num_heads, context, pos, ctx_pos, ctx_mask)
            out = scatter_to_group(out, spec.group, -1)
        return out_proj.row_from_local(out)

    def _attend(self, q, k, v, heads, context, pos, ctx_pos, ctx_mask):
        if self.rope_freq is not None and pos is not None:
            q = self._rope(q, pos)
            kpos = pos if context is None else ctx_pos
            if kpos is not None:
                k = self._rope(k, kpos)
        if ctx_mask is not None:
            return masked_attention(q, k, v, ctx_mask, heads, self.head_dim)
        return attend(q, k, v, heads, self.head_dim)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        return self.gate(self.proj(x))

    @staticmethod
    def gate(projected):
        """[..., 2 I] (value, gate) -> [..., I]."""
        h, gate = projected.chunk(2, dim=-1)
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
        proj, out_proj = self.net[0].proj, self.net[2]
        w1, b1 = proj.weight, proj.bias
        # tensor parallel: net.0's interleaved shard (this rank's value and
        # gate blocks) makes this rank's hidden block; one reduce after net.2
        spec = tp_pair([proj], out_proj)
        if spec is None and is_tensor_parallel(proj, out_proj):
            for m in self.net:  # one of the two sharded alone: each layer by itself
                x = m(x)
            return x
        if spec is not None:
            x = copy_to_group(x, spec.group)
        if use_fused_geglu(x.dtype, w1.dtype):
            w2, b2 = out_proj.weight, out_proj.bias
            x = x.contiguous()
            if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2)):
                out = GegluFFN.apply(x, w1, b1, w2)
            else:
                out = geglu_ffn(x, w1, b1, w2)
            if spec is not None:
                out = reduce_from_group(out, spec.group)
            return out + b2.to(x.dtype)
        if spec is None:
            for m in self.net:
                x = m(x)
            return x
        return out_proj.row_from_local(self.net[0].gate(proj.column_local(x, copied=True)))


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


# Tensor parallelism (``parallel/sharding.py::parallelize``): a weight the
# tp rules shard is replaced by this rank's block, and its ``nn.Linear`` /
# ``nn.Conv*`` gets a ``TPSpec`` and the ``TensorParallel`` forward.  Inside
# ``tensor_parallel(group)`` the generic rule runs every such layer alone:
#
#   column-parallel (output features / channels):  copy-to-tp, the local
#       product with the local bias, gather-from-tp
#   row-parallel (input features / channels):      scatter-to-tp, the local
#       partial product, reduce-from-tp, the bias once after the sum
#
# and the modules that know a column layer's consumer (``tp_pair``) skip the
# gather and the scatter between them, as Megatron does: the attention (its
# heads a rank where tp divides them), the GEGLU feed-forward, the MLPs, the
# resnets (their second norm on the rank's channel block where tp divides
# its groups) and the timestep MLPs.  ``torch.distributed.tensor``'s
# ``DTensor`` is not used: on the one-card machine the ranks talk over gloo
# through ``parallel/comm.py``'s host staging, where a CUDA ``DTensor`` does
# not run, and the flash and GEGLU kernels take plain local tensors.
_TP = contextvars.ContextVar("unigeo_tensor_parallel", default=None)


@contextlib.contextmanager
def tensor_parallel(group):
    """Inside the block, modules placed by ``parallelize`` over ``group``
    (a tp process group) run tensor-parallel; outside it they raise."""
    token = _TP.set(group)
    try:
        yield
    finally:
        _TP.reset(token)


@dataclass(frozen=True)
class TPSpec:
    """A sharded layer's place: ``dim`` 0 column-parallel (its output
    features / channels split), 1 row-parallel (its input); the tp group,
    its size and this rank's index; ``geglu``: GEGLU's projection, whose
    shard is value block ``index`` followed by gate block ``index``."""

    dim: int
    group: object
    size: int
    index: int
    geglu: bool = False


def copy_to_group(x, group):
    """copy-to-tp: x; its backward sums the gradient over the group."""
    return comm.CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    """reduce-from-tp: the sum of every rank's x (backward: identity)."""
    return comm.ReduceFromGroup.apply(x, group)


def gather_from_group(x, group, dim: int):
    """gather-from-tp: every rank's x along ``dim`` (backward: this rank's
    slice, not summed)."""
    return comm.GatherFromGroup.apply(x, group, dim)


def scatter_to_group(x, group, dim: int):
    """scatter-to-tp: this rank's equal slice of x along ``dim`` (backward:
    the slices' gradients gathered)."""
    return comm.ScatterToGroup.apply(x, group, dim)


def is_tensor_parallel(*modules) -> bool:
    """Whether any of ``modules`` holds a tp shard."""
    return any(getattr(m, "tp_spec", None) is not None for m in modules)


def tp_pair(columns: Sequence[nn.Module], row: nn.Module) -> Optional[TPSpec]:
    """The row layer's ``TPSpec`` when every layer of ``columns`` is
    column-parallel and ``row`` row-parallel over the enclosing
    ``tensor_parallel`` group (the paired form applies), else None."""
    group = _TP.get()
    if group is None:
        return None
    spec = getattr(row, "tp_spec", None)
    if spec is None or spec.dim != 1 or spec.group is not group:
        return None
    for m in columns:
        s = getattr(m, "tp_spec", None)
        if s is None or s.dim != 0 or s.group is not group:
            return None
    return spec


def mlp_pair(fc1: nn.Module, fc2: nn.Module, x, act):
    """fc2(act(fc1(x))).  Tensor-parallel (fc1 column-, fc2 row-parallel):
    the hidden stays this rank's block, one reduce after fc2."""
    if tp_pair([fc1], fc2) is not None:
        return fc2.row_from_local(act(fc1.column_local(x)))
    return fc2(act(fc1(x)))


class TensorParallel:
    """The forward of a sharded ``nn.Linear`` / ``nn.Conv*``, put in front
    of its class by ``parallelize`` (``tensor_parallel_class``); its
    ``tp_spec`` says how it is split.  ``column_local`` and
    ``row_from_local`` are the halves the paired forms call."""

    tp_spec: TPSpec

    def _checked_spec(self) -> TPSpec:
        spec = self.tp_spec
        if _TP.get() is not spec.group:
            raise RuntimeError(f"a tensor-parallel {type(self).__name__} (weight "
                               f"{tuple(self.weight.shape)}, a shard of {spec.size}) runs "
                               f"inside tensor_parallel(its tp group) only")
        return spec

    @property
    def channel_dim(self) -> int:
        return -1 if isinstance(self, nn.Linear) else 1

    def forward(self, x):
        spec = self._checked_spec()
        if spec.dim == 1:
            return self.row_from_local(scatter_to_group(x, spec.group, self.channel_dim))
        out = gather_from_group(self.column_local(x), spec.group, self.channel_dim)
        if spec.geglu:  # [v0 g0 v1 g1 ...] -> [v0 v1 ... g0 g1 ...]
            blocks = [b.chunk(2, self.channel_dim) for b in out.chunk(spec.size,
                                                                       self.channel_dim)]
            out = torch.cat([b[0] for b in blocks] + [b[1] for b in blocks], self.channel_dim)
        return out

    def column_local(self, x, copied: bool = False):
        """This rank's output features / channels (its bias block added) of
        the whole input x (through copy-to-tp unless ``copied``)."""
        spec = self._checked_spec()
        if not copied:
            x = copy_to_group(x, spec.group)
        return super().forward(x)

    def row_from_local(self, x):
        """The whole output from this rank's block of the input features /
        channels: the partial product, summed over the group, the bias added
        once after the sum."""
        spec = self._checked_spec()
        bias = self._parameters["bias"]
        self._parameters["bias"] = None  # the partial product without it
        try:
            partial = super().forward(x)
        finally:
            self._parameters["bias"] = bias
        out = reduce_from_group(partial, spec.group)
        if bias is None:
            return out
        if self.channel_dim == 1:
            return out + bias.reshape(-1, *([1] * (out.dim() - 2)))
        return out + bias


_TP_CLASSES = {}


def tensor_parallel_class(cls):
    """``cls`` with ``TensorParallel``'s forward in front (one class per
    ``cls``; ``isinstance(m, cls)`` still holds)."""
    if issubclass(cls, TensorParallel):
        return cls
    if cls not in _TP_CLASSES:
        _TP_CLASSES[cls] = type(f"TensorParallel{cls.__name__}", (TensorParallel, cls), {})
    return _TP_CLASSES[cls]


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
