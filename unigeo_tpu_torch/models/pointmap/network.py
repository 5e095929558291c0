"""Shared backbone of the feed-forward pointmap regressors (CroCo/DUSt3R
lineage), port of ``unigeo_tpu/models/pointmap/network.py``: a ViT patch
encoder, a decoder whose blocks self-attend within a frame and
cross-attend to context tokens, a linear patch head (points + confidence)
and the pose head (a pooled 7-DoF absT_quaR encoding, in f32).

Module names follow the JAX package's flax tree (``patch_embed.proj``,
``blocks.layers.N.attn.to_q``, ``proj_in``, ``norm``), so
``utils/weights.py::pointmap_state_dict`` maps its leaves by name.  Images
are [B, H, W, 3] as in the JAX package; ``PatchEmbed`` runs the conv NCHW.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from unigeo_tpu_torch.models.layers import mlp_pair
from unigeo_tpu_torch.models.vit import PatchEmbed, ScannedViTBlocks, sincos_2d_pos_embed
from unigeo_tpu_torch.ops.rope import grid_positions


def _rope_freq(pos_embed: str) -> Optional[float]:
    """'RoPE100' / 'rope100' -> 100.0; 'sincos' -> None (additive sin-cos)."""
    if pos_embed.lower().startswith("rope"):
        return float(pos_embed[4:] or 100.0)
    return None


def normalize_images(images01: torch.Tensor) -> torch.Tensor:
    """0..1 images -> [-1, 1] (DUSt3R's ImgNorm)."""
    return (images01 - 0.5) / 0.5


class PointmapEncoder(nn.Module):
    def __init__(self, width: int = 768, depth: int = 8, num_heads: int = 12,
                 patch_size: int = 16, pos_embed: str = "sincos", qkv_bias: bool = False):
        super().__init__()
        self.width = width
        self.patch_size = patch_size
        self.freq = _rope_freq(pos_embed)
        self.patch_embed = PatchEmbed(width, patch_size)
        self.blocks = ScannedViTBlocks(depth, width, num_heads, qkv_bias=qkv_bias,
                                       rope_freq=self.freq)
        self.norm = nn.LayerNorm(width)

    def forward(self, images):
        """[B, H, W, 3] (about [-1, 1]) -> (tokens [B, N, width], (gh, gw))."""
        h, w = images.shape[1:3]
        if h % self.patch_size or w % self.patch_size:
            raise ValueError(
                f"input {h}x{w} is not divisible by patch_size={self.patch_size}; "
                "resize or crop the clip")
        tokens, (gh, gw) = self.patch_embed(images)
        pos = None
        if self.freq is None:
            table = sincos_2d_pos_embed(self.width, gh, gw, device=tokens.device)
            tokens = tokens + table.to(tokens.dtype)[None]
        else:
            pos = grid_positions(gh, gw, device=tokens.device)[None]
        return self.norm(self.blocks(tokens, pos=pos)), (gh, gw)


class PointmapDecoder(nn.Module):
    def __init__(self, in_width: int, width: int = 512, depth: int = 6, num_heads: int = 8,
                 return_hooks: bool = False, pos_embed: str = "sincos", qkv_bias: bool = False,
                 norm_context: bool = False):
        super().__init__()
        self.depth = depth
        self.return_hooks = return_hooks
        self.proj_in = nn.Linear(in_width, width)
        self.blocks = ScannedViTBlocks(depth, width, num_heads, with_cross=True,
                                       qkv_bias=qkv_bias, return_layers=return_hooks,
                                       rope_freq=_rope_freq(pos_embed),
                                       norm_context=norm_context)
        self.norm = nn.LayerNorm(width)

    def forward(self, tokens, context, pos=None, ctx_pos=None, ctx_mask=None):
        """tokens [B, N, C_enc] cross-attend to context [B, M, width].

        With ``return_hooks``: (final, hooks), hooks in the dust3r order
        [encoder tokens, block 2L/4, block 3L/4, final]."""
        out = self.blocks(self.proj_in(tokens), context, pos=pos, ctx_pos=ctx_pos,
                          ctx_mask=ctx_mask)
        if not self.return_hooks:
            return self.norm(out)
        h, layers = out
        final = self.norm(h)
        return final, [tokens, layers[self.depth * 2 // 4 - 1],
                       layers[self.depth * 3 // 4 - 1], final]


def _points_and_conf(out: torch.Tensor):
    """[..., 4] head output -> (points with z = exp(clip(z, -10, 8)),
    confidence 1 + exp(clip(c, -10, 8)))."""
    z = torch.exp(out[..., 2:3].clamp(-10.0, 8.0))
    pts = torch.cat([out[..., :2], z], dim=-1)
    return pts, 1.0 + torch.exp(out[..., 3].clamp(-10.0, 8.0))


class PointmapHead(nn.Module):
    """Linear patch head: tokens -> [B, H, W, 3] points + [B, H, W] confidence."""

    def __init__(self, width: int, patch_size: int = 16):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Linear(width, patch_size * patch_size * 4)

    def forward(self, tokens, grid: Tuple[int, int]):
        gh, gw = grid
        p = self.patch_size
        b = tokens.shape[0]
        out = self.proj(tokens).reshape(b, gh, gw, p, p, 4)
        out = out.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * p, gw * p, 4)
        return _points_and_conf(out)


class PoseHead(nn.Module):
    """Mean-pooled tokens -> fc1 (256), gelu, fc2 (7): the absT_quaR encoding
    with (1, 0, 0, 0) added to the quaternion, normalised (floor 1e-8).  The
    gelu is the tanh form, flax's ``nn.gelu`` default."""

    def __init__(self, width: int):
        super().__init__()
        self.fc1 = nn.Linear(width, 256)
        self.fc2 = nn.Linear(256, 7)

    def forward(self, tokens):
        # the bias and what follows in f32, as the JAX package's f32 constant
        # promotes a bf16 encoding
        enc = mlp_pair(self.fc1, self.fc2, tokens.mean(dim=1),
                       lambda h: F.gelu(h, approximate="tanh")).float()
        quat = enc[..., 3:] + torch.tensor([1.0, 0.0, 0.0, 0.0], device=enc.device)
        quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True).clamp_min(1e-8)
        return torch.cat([enc[..., :3], quat], dim=-1)
