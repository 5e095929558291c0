"""CLIP ViT image embedder (SVD's conditioning tower).

Port of ``unigeo_tpu/models/vit.py::ClipImageEmbedder`` and the
``VisionTransformer`` it uses, with the transformers
``CLIPVisionModelWithProjection`` module tree (``vision_model.embeddings``,
``vision_model.encoder.layers.N.self_attn.q_proj``, ``visual_projection``).
The JAX package's ``nn.scan`` over blocks is a plain layer list here.

The input resize reproduces ``jax.image.resize(method="bicubic")`` — Keys
cubic kernel (a = -0.5), half-pixel centres, antialiased when downsampling —
as one weight-matrix product per axis, since ``F.interpolate``'s bicubic
differs (a = -0.75, no antialiasing unless asked, another edge rule).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from unigeo_tpu_torch.models.layers import attend

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] f32 weights of jax.image.resize's antialiased bicubic along
    one axis (jax/_src/image/scale.py::compute_weight_mat, translation 0)."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(out_size, dtype=np.float32) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = _keys_cubic(x).astype(np.float32)  # [in, out]
    total = w.sum(axis=0, keepdims=True)
    w = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / np.where(total != 0, total, 1),
        0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, 0)
    return np.ascontiguousarray(w.T.astype(np.float32))


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[N, C, H, W] -> [N, C, out_h, out_w], as jax.image.resize bicubic, in f32."""
    wh = torch.from_numpy(resize_weights(x.shape[2], out_h)).to(x.device)
    ww = torch.from_numpy(resize_weights(x.shape[3], out_w)).to(x.device)
    return torch.einsum("oh,nchw,pw->ncop", wh, x.float(), ww)


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
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))  # quick_gelu


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


def tiny_clip_config():
    return dict(width=32, depth=2, num_heads=2, patch_size=16, projection_dim=32,
                image_size=64)
