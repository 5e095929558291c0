"""DUSt3R-class two-view pointmap regression, port of
``unigeo_tpu/models/pointmap/dust3r.py``.

A siamese ViT encoder over both views, then DUSt3R's two entangled
decoders: at every layer, stream 1 cross-attends to stream 2's
previous-layer tokens and stream 2 to stream 1's, each with its own weights
(``layers.N.block1`` / ``block2``: the JAX package's scan over depth as a
layer list).  Two heads emit both views' pointmaps in view 1's frame, with
confidences.

The adapter (registered as ``Dust3R``) pairs frame 0 with every other frame
of the clip in one batch: the reference view is encoded once and broadcast
over the pairs, so the encoder runs over T frames.  Frame 0's map is the
mean of the pairs' view-1 maps, frames 1..T-1 come from head 2, and depths
and cameras are recovered from these world pointmaps
(``adapter.outputs_from_world_pts``).  A one-frame clip is paired with itself.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from unigeo_tpu_torch.models.pointmap import adapter
from unigeo_tpu_torch.models.pointmap.dpt import DPTPointmapHead
from unigeo_tpu_torch.models.pointmap.network import (
    PointmapEncoder,
    PointmapHead,
    _rope_freq,
    normalize_images,
)
from unigeo_tpu_torch.models.vit import ViTBlock
from unigeo_tpu_torch.ops.rope import grid_positions
from unigeo_tpu_torch.registry import MODELS


class EntangledStep(nn.Module):
    """One layer of both decoders: each stream's block reads the other
    stream's previous-layer tokens as its context."""

    def __init__(self, width: int, num_heads: int, qkv_bias: bool = False,
                 rope_freq: Optional[float] = None, norm_context: bool = False):
        super().__init__()
        kw = dict(qkv_bias=qkv_bias, rope_freq=rope_freq, norm_context=norm_context,
                  with_cross=True)
        self.block1 = ViTBlock(width, num_heads, **kw)
        self.block2 = ViTBlock(width, num_heads, **kw)

    def forward(self, x1, x2, pos):
        return self.block1(x1, x2, pos, pos), self.block2(x2, x1, pos, pos)


class EntangledDecoder(nn.Module):
    """``decoder_embed`` shared by both streams, ``dec_depth`` entangled
    layers, a final norm per stream (``norm1``, ``norm2``).  Returns (f1, f2)
    and, with ``collect``, each stream's per-layer outputs (DPT hooks)."""

    def __init__(self, enc_width: int, dec_width: int, dec_depth: int, dec_heads: int,
                 qkv_bias: bool = False, rope_freq: Optional[float] = None,
                 norm_context: bool = False, collect: bool = False):
        super().__init__()
        self.collect = collect
        self.decoder_embed = nn.Linear(enc_width, dec_width)
        self.layers = nn.ModuleList([
            EntangledStep(dec_width, dec_heads, qkv_bias, rope_freq, norm_context)
            for _ in range(dec_depth)])
        self.norm1 = nn.LayerNorm(dec_width)
        self.norm2 = nn.LayerNorm(dec_width)

    def forward(self, e1, e2, pos=None):
        x1, x2 = self.decoder_embed(e1), self.decoder_embed(e2)
        l1, l2 = [], []
        for layer in self.layers:
            x1, x2 = layer(x1, x2, pos)
            l1.append(x1)
            l2.append(x2)
        f1, f2 = self.norm1(x1), self.norm2(x2)
        return (f1, f2, (l1, l2)) if self.collect else (f1, f2)


class Dust3RNetwork(nn.Module):
    """Two views [B, H, W, 3] in 0..1 -> (pts1, pts2, conf1, conf2), both
    pointmaps in view 1's frame.  img1 may hold one frame against a larger
    img2 batch (one-ref pairing): its tokens are broadcast over the pairs."""

    def __init__(self, enc_width: int = 1024, enc_depth: int = 24, enc_heads: int = 16,
                 dec_width: int = 768, dec_depth: int = 12, dec_heads: int = 12,
                 patch_size: int = 16, head_type: str = "linear", pos_embed: str = "sincos",
                 qkv_bias: bool = False, norm_context: bool = False):
        super().__init__()
        if head_type not in ("linear", "dpt"):
            raise ValueError(f"unknown head_type {head_type!r}")
        self.dec_depth = dec_depth
        self.use_dpt = head_type == "dpt"
        self.freq = _rope_freq(pos_embed)
        self.encoder = PointmapEncoder(enc_width, enc_depth, enc_heads, patch_size,
                                       pos_embed=pos_embed, qkv_bias=qkv_bias)
        self.decoder = EntangledDecoder(enc_width, dec_width, dec_depth, dec_heads, qkv_bias,
                                        self.freq, norm_context, collect=self.use_dpt)
        if self.use_dpt:
            dims = (enc_width, dec_width, dec_width, dec_width)
            self.head1 = DPTPointmapHead(dims, patch_size)
            self.head2 = DPTPointmapHead(dims, patch_size)
        else:
            self.head1 = PointmapHead(dec_width, patch_size)
            self.head2 = PointmapHead(dec_width, patch_size)

    def forward(self, img1, img2):
        tokens, grid = self.encoder(normalize_images(torch.cat([img1, img2], dim=0)))
        b = img1.shape[0]
        e1, e2 = tokens[:b], tokens[b:]
        if b == 1 and img2.shape[0] > 1:
            e1 = e1.expand((img2.shape[0],) + e1.shape[1:])
        pos = None if self.freq is None else grid_positions(*grid, device=tokens.device)[None]
        out = self.decoder(e1, e2, pos)
        if self.use_dpt:
            f1, f2, (l1, l2) = out
            # the dust3r hooks: encoder tokens, blocks 2L/4 and 3L/4, final
            i, j = self.dec_depth * 2 // 4 - 1, self.dec_depth * 3 // 4 - 1
            pts1, conf1 = self.head1([e1, l1[i], l1[j], f1], grid)
            pts2, conf2 = self.head2([e2, l2[i], l2[j], f2], grid)
        else:
            f1, f2 = out
            pts1, conf1 = self.head1(f1, grid)
            pts2, conf2 = self.head2(f2, grid)
        return pts1, pts2, conf1, conf2


@MODELS.register("Dust3R")
class Dust3R(adapter.RandomInitAdapter):
    network_cls = Dust3RNetwork

    def __init__(
        self,
        network_config: Optional[Dict[str, Any]] = None,
        checkpoint_path: Optional[str] = None,
        seed: int = 0,
        init_height: int = 384,
        init_width: int = 512,
        compute_dtype: Optional[str] = None,
        transfer_dtype: Optional[str] = None,
        # reference-config keys, accepted and ignored as the JAX adapter does
        model_dir: Optional[str] = None,
        ckpt_path: Optional[str] = None,
        device="cuda",
        **_: Dict,
    ):
        """The JAX adapter's keywords and the ``device`` the network is built
        on.  ``init_*`` size the JAX package's parameter init; the port's
        random weights do not depend on them."""
        self._build(network_config, checkpoint_path, seed, compute_dtype, transfer_dtype, device)

    @torch.no_grad()
    def forward_tensors(self, data: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One clip -> the output dict as f32 tensors on the device."""
        frames = self.frames(data)
        if frames.shape[0] < 2:  # a one-frame clip: paired with itself
            frames = torch.cat([frames, frames], dim=0)
        pts1, pts2, conf1, conf2 = self.network(frames[:1], frames[1:])
        pts = torch.cat([pts1.float().mean(0, keepdim=True), pts2.float()])
        conf = torch.cat([conf1.float().mean(0, keepdim=True), conf2.float()])
        return adapter.outputs_from_world_pts(pts, conf)


def tiny_dust3r_config():
    return dict(enc_width=64, enc_depth=2, enc_heads=2, dec_width=48, dec_depth=2, dec_heads=2,
                patch_size=16)
