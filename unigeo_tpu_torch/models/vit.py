"""Vision transformers: the CLIP image embedder (SVD's conditioning tower)
and the blocks of the pointmap backbones.

Port of ``unigeo_tpu/models/vit.py``.  ``ClipImageEmbedder`` and the
``VisionTransformer`` it uses keep the transformers
``CLIPVisionModelWithProjection`` module tree (``vision_model.embeddings``,
``vision_model.encoder.layers.N.self_attn.q_proj``, ``visual_projection``).
``MLP``, ``ViTBlock``, ``ScannedViTBlocks``, ``PatchEmbed`` and
``sincos_2d_pos_embed`` serve the pointmap networks, with the JAX package's
module names (``blocks.layers.N.attn.to_q``: its ``nn.scan`` over blocks is
a plain layer list here, layer N its stacked leaves' index N).

The input resize reproduces ``jax.image.resize(method="bicubic")`` — Keys
cubic kernel (a = -0.5), half-pixel centres, antialiased when downsampling —
as one weight-matrix product per axis, since ``F.interpolate``'s bicubic
differs (a = -0.75, no antialiasing unless asked, another edge rule).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from unigeo_tpu_torch.models.layers import Attention, attend, mlp_pair

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - x)


def resize_weights(in_size: int, out_size: int, kernel=_keys_cubic) -> np.ndarray:
    """[out, in] f32 weights of jax.image.resize's antialiased resize along
    one axis (jax/_src/image/scale.py::compute_weight_mat, translation 0):
    ``kernel`` is the Keys cubic (bicubic) or ``_triangle`` (bilinear)."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(out_size, dtype=np.float32) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = kernel(x).astype(np.float32)  # [in, out]
    total = w.sum(axis=0, keepdims=True)
    w = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / np.where(total != 0, total, 1),
        0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, 0)
    return np.ascontiguousarray(w.T.astype(np.float32))


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int, kernel=_keys_cubic) -> torch.Tensor:
    """[N, C, H, W] -> [N, C, out_h, out_w], as jax.image.resize bicubic (or,
    with ``kernel=_triangle``, bilinear), in f32."""
    wh = torch.from_numpy(resize_weights(x.shape[2], out_h, kernel)).to(x.device)
    ww = torch.from_numpy(resize_weights(x.shape[3], out_w, kernel)).to(x.device)
    return torch.einsum("oh,nchw,pw->ncop", wh, x.float(), ww)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[N, C, H, W] -> [N, C, out_h, out_w], as jax.image.resize "bilinear"
    (half-pixel centres, antialiased when it shrinks), in f32."""
    return resize_bicubic(x, out_h, out_w, kernel=_triangle)


class CLIPAttention(nn.Module):
    def __init__(self, width: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = width // num_heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x):
        out = attend(self.q_proj(x), self.k_proj(x), self.v_proj(x),
                     self.num_heads, self.head_dim)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, width: int, mult: int = 4):
        super().__init__()
        self.fc1 = nn.Linear(width, width * mult)
        self.fc2 = nn.Linear(width * mult, width)

    def forward(self, x):
        return mlp_pair(self.fc1, self.fc2, x, lambda h: h * torch.sigmoid(1.702 * h))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, width: int, num_heads: int):
        super().__init__()
        self.self_attn = CLIPAttention(width, num_heads)
        self.layer_norm1 = nn.LayerNorm(width)
        self.mlp = CLIPMLP(width)
        self.layer_norm2 = nn.LayerNorm(width)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Container(nn.Module):
    pass


class VisionTransformer(nn.Module):
    """Pre-LN ViT with a class token and a learned position table (the
    configuration ClipImageEmbedder uses).  [N, 3, S, S] -> [N, 1+P, width]."""

    def __init__(self, width: int, depth: int, num_heads: int, patch_size: int,
                 image_size: int):
        super().__init__()
        grid = image_size // patch_size
        self.embeddings = _Container()
        self.embeddings.class_embedding = nn.Parameter(torch.empty(width))
        self.embeddings.patch_embedding = nn.Conv2d(
            3, width, patch_size, stride=patch_size, bias=False
        )
        self.embeddings.position_embedding = nn.Embedding(grid * grid + 1, width)
        self.pre_layrnorm = nn.LayerNorm(width)
        self.encoder = _Container()
        self.encoder.layers = nn.ModuleList(
            [CLIPEncoderLayer(width, num_heads) for _ in range(depth)]
        )
        self.post_layernorm = nn.LayerNorm(width)

    def forward(self, images):
        emb = self.embeddings
        tokens = emb.patch_embedding(images).flatten(2).transpose(1, 2)  # [N, P, W]
        cls = emb.class_embedding.to(tokens.dtype).expand(tokens.shape[0], 1, -1)
        tokens = torch.cat([cls, tokens], dim=1) + emb.position_embedding.weight[None]
        tokens = self.pre_layrnorm(tokens)
        for layer in self.encoder.layers:
            tokens = layer(tokens)
        return self.post_layernorm(tokens)


class ClipImageEmbedder(nn.Module):
    """Frames -> one projected token per frame.  Defaults are CLIP ViT-H/14
    (width 1280, 32 layers, 16 heads, projection 1024)."""

    def __init__(self, width: int = 1280, depth: int = 32, num_heads: int = 16,
                 patch_size: int = 14, projection_dim: int = 1024,
                 image_size: int = 224):
        super().__init__()
        self.image_size = image_size
        self.vision_model = VisionTransformer(width, depth, num_heads, patch_size, image_size)
        self.visual_projection = nn.Linear(width, projection_dim, bias=False)

    def forward(self, frames01):
        """[N, 3, H, W] in [0, 1] -> [N, 1, projection_dim]."""
        dtype = self.visual_projection.weight.dtype
        x = resize_bicubic(frames01, self.image_size, self.image_size)
        mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device).view(1, 3, 1, 1)
        std = torch.tensor(CLIP_IMAGE_STD, device=x.device).view(1, 3, 1, 1)
        x = ((x - mean) / std).to(dtype)
        tokens = self.vision_model(x)
        return self.visual_projection(tokens[:, 0])[:, None, :]


# --- the pointmap backbones' blocks (vit.py:26-175 of the JAX package) ---


class MLP(nn.Module):
    """fc1 -> exact (erf) gelu, or quick_gelu -> fc2."""

    def __init__(self, width: int, mult: int = 4, act: str = "gelu"):
        super().__init__()
        self.act = act
        self.fc1 = nn.Linear(width, width * mult)
        self.fc2 = nn.Linear(width * mult, width)

    def forward(self, x):
        act = (lambda h: h * torch.sigmoid(1.702 * h)) if self.act == "quick_gelu" else F.gelu
        return mlp_pair(self.fc1, self.fc2, x, act)


class ViTBlock(nn.Module):
    """Pre-LN block: self-attention, an optional cross-attention to a
    context (``norm_context``: the CroCo decoder's LayerNorm of the context),
    then the MLP."""

    def __init__(self, width: int, num_heads: int, qkv_bias: bool = False, act: str = "gelu",
                 rope_freq: Optional[float] = None, norm_context: bool = False,
                 with_cross: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(width)
        self.attn = Attention(width, num_heads, qkv_bias=qkv_bias, rope_freq=rope_freq)
        if with_cross:
            if norm_context:
                self.norm_context = nn.LayerNorm(width)
            self.norm_cross = nn.LayerNorm(width)
            self.cross_attn = Attention(width, num_heads, qkv_bias=qkv_bias, rope_freq=rope_freq)
        self.norm2 = nn.LayerNorm(width)
        self.mlp = MLP(width, act=act)

    def forward(self, x, context=None, pos=None, ctx_pos=None, ctx_mask=None):
        x = x + self.attn(self.norm1(x), pos=pos)
        if context is not None:
            ctx = self.norm_context(context) if hasattr(self, "norm_context") else context
            x = x + self.cross_attn(self.norm_cross(x), ctx, pos=pos, ctx_pos=ctx_pos,
                                    ctx_mask=ctx_mask)
        return x + self.mlp(self.norm2(x))


class ScannedViTBlocks(nn.Module):
    """``depth`` ViT blocks in a layer list; with ``return_layers`` also each
    layer's output."""

    def __init__(self, depth: int, width: int, num_heads: int, with_cross: bool = False,
                 qkv_bias: bool = False, act: str = "gelu", return_layers: bool = False,
                 rope_freq: Optional[float] = None, norm_context: bool = False):
        super().__init__()
        self.with_cross = with_cross
        self.return_layers = return_layers
        self.layers = nn.ModuleList([
            ViTBlock(width, num_heads, qkv_bias, act, rope_freq, norm_context, with_cross)
            for _ in range(depth)])

    def forward(self, x, context=None, pos=None, ctx_pos=None, ctx_mask=None):
        outs = []
        for layer in self.layers:
            x = layer(x, context if self.with_cross else None, pos, ctx_pos, ctx_mask)
            outs.append(x)
        return (x, outs) if self.return_layers else x


class PatchEmbed(nn.Module):
    """[B, H, W, 3] -> ([B, H/p * W/p, width], (H/p, W/p)) by a p x p,
    stride-p convolution."""

    def __init__(self, width: int, patch_size: int, use_bias: bool = True, in_ch: int = 3):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, width, patch_size, stride=patch_size, bias=use_bias)

    def forward(self, images):
        h = self.proj(images.permute(0, 3, 1, 2))
        b, c, gh, gw = h.shape
        return h.flatten(2).transpose(1, 2), (gh, gw)


def sincos_2d_pos_embed(width: int, gh: int, gw: int, device=None) -> torch.Tensor:
    """Fixed 2D sin-cos position table [gh*gw, width] (f64 math, f32 out):
    the first half of the channels embeds y, the second x."""

    def emb_1d(pos, dim):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
        out = np.einsum("m,d->md", pos, omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    ys, xs = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    emb = np.concatenate(
        [emb_1d(ys.reshape(-1), width // 2), emb_1d(xs.reshape(-1), width // 2)], axis=1)
    return torch.from_numpy(emb.astype(np.float32)).to(device)


def tiny_clip_config():
    return dict(width=32, depth=2, num_heads=2, patch_size=16, projection_dim=32,
                image_size=64)
