"""Spann3R-class sequential pointmap regression with a spatial memory, port
of ``unigeo_tpu/models/pointmap/spann3r.py``.

Each frame's pointmap is predicted in the frame-0 (world) coordinates: the
encoder runs over all T frames at once, then a Python loop over the frames
(the JAX package's ``nn.scan``) decodes each frame against [its own
projection ++ a ring memory of the earlier frames' decoder tokens]:
``memory_frames`` slots of N tokens, slot ``f % memory_frames`` written by
frame f, empty slots masked out of the attention (zero values alone would
still take softmax mass).  Depths and cameras are then recovered from the
pointmaps (``adapter.outputs_from_world_pts``).

The adapter (registered as ``Spann3R``) builds its network on the device
with the weights of ``checkpoint_path`` or random ones from a generator
seeded with ``seed``, computes in f32 unless ``compute_dtype`` (or
``UNIGEO_COMPUTE_DTYPE``) says bfloat16, and runs the geometry in f32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from unigeo_tpu_torch.models.pointmap import adapter
from unigeo_tpu_torch.models.pointmap.dpt import DPTPointmapHead
from unigeo_tpu_torch.models.pointmap.network import (
    PointmapDecoder,
    PointmapEncoder,
    PointmapHead,
    _rope_freq,
    normalize_images,
)
from unigeo_tpu_torch.ops.rope import grid_positions
from unigeo_tpu_torch.registry import MODELS


class MemoryStep(nn.Module):
    """One frame through the memory decoder; its weights are shared by every
    frame (the JAX package broadcasts them over its scan)."""

    def __init__(self, enc_width: int, dec_width: int, dec_depth: int, dec_heads: int,
                 memory_frames: int, return_hooks: bool = False, pos_embed: str = "sincos",
                 qkv_bias: bool = False, norm_context: bool = False):
        super().__init__()
        self.memory_frames = memory_frames
        self.return_hooks = return_hooks
        self.memory_proj = nn.Linear(enc_width, dec_width)
        self.decoder = PointmapDecoder(enc_width, dec_width, dec_depth, dec_heads,
                                       return_hooks=return_hooks, pos_embed=pos_embed,
                                       qkv_bias=qkv_bias, norm_context=norm_context)

    def forward(self, carry, tok, pos, ctx_pos):
        """carry (memory [M*N, C], mask [M*N], slot), tok [N, C_enc] ->
        (carry, decoder tokens [N, C] or (tokens, hooks)): the new frame's
        tokens written into the memory's oldest slot."""
        mem, mem_mask, slot = carry
        n = tok.shape[0]
        ctx = torch.cat([self.memory_proj(tok), mem * mem_mask.to(mem.dtype)[:, None]], dim=0)
        ctx_mask = torch.cat([torch.ones(n, device=tok.device), mem_mask], dim=0)
        out = self.decoder(tok[None], ctx[None], pos=pos, ctx_pos=ctx_pos, ctx_mask=ctx_mask)
        if self.return_hooks:
            dec, hooks = out[0][0], [h[0] for h in out[1]]
        else:
            dec, hooks = out[0], None
        start = (slot % self.memory_frames) * n
        # out of place, so that autograd keeps the memory each step read
        mem = mem.slice_scatter(dec, start=start, end=start + n)
        mem_mask = mem_mask.slice_scatter(torch.ones_like(mem_mask[:n]), start=start,
                                          end=start + n)
        return (mem, mem_mask, slot + 1), ((dec, hooks) if self.return_hooks else dec)


class Spann3RNetwork(nn.Module):
    """frames [T, H, W, 3] in 0..1 -> (world points [T, H, W, 3], conf [T, H, W])."""

    def __init__(self, enc_width: int = 768, enc_depth: int = 8, enc_heads: int = 12,
                 dec_width: int = 512, dec_depth: int = 6, dec_heads: int = 8,
                 patch_size: int = 16, memory_frames: int = 4, head_type: str = "linear",
                 pos_embed: str = "sincos", qkv_bias: bool = False, norm_context: bool = False):
        super().__init__()
        if head_type not in ("linear", "dpt"):
            raise ValueError(f"unknown head_type {head_type!r}")
        self.memory_frames = memory_frames
        self.dec_width = dec_width
        self.use_dpt = head_type == "dpt"
        self.freq = _rope_freq(pos_embed)
        self.encoder = PointmapEncoder(enc_width, enc_depth, enc_heads, patch_size,
                                       pos_embed=pos_embed, qkv_bias=qkv_bias)
        self.memory_step = MemoryStep(enc_width, dec_width, dec_depth, dec_heads, memory_frames,
                                      self.use_dpt, pos_embed, qkv_bias, norm_context)
        if self.use_dpt:
            self.head = DPTPointmapHead((enc_width, dec_width, dec_width, dec_width), patch_size)
        else:
            self.head = PointmapHead(dec_width, patch_size)

    def forward(self, frames):
        t = frames.shape[0]
        enc, grid = self.encoder(normalize_images(frames))  # [T, N, C]
        n = enc.shape[1]
        pos = ctx_pos = None
        if self.freq is not None:
            pos = grid_positions(*grid, device=enc.device)
            ctx_pos = torch.cat([pos, pos.repeat(self.memory_frames, 1)], dim=0)
        carry = (torch.zeros((self.memory_frames * n, self.dec_width), dtype=enc.dtype,
                             device=enc.device),
                 torch.zeros(self.memory_frames * n, device=enc.device), 0)
        ys = []
        for f in range(t):
            carry, y = self.memory_step(carry, enc[f], pos, ctx_pos)
            ys.append(y)
        if self.use_dpt:
            hooks = [torch.stack([h[k] for _, h in ys]) for k in range(4)]
            return self.head(hooks, grid)
        return self.head(torch.stack(ys), grid)


@MODELS.register("Spann3R")
class Spann3R(adapter.RandomInitAdapter):
    network_cls = Spann3RNetwork

    def __init__(
        self,
        network_config: Optional[Dict[str, Any]] = None,
        checkpoint_path: Optional[str] = None,
        seed: int = 0,
        init_height: int = 384,
        init_width: int = 512,
        init_frames: int = 2,
        compute_dtype: Optional[str] = None,
        transfer_dtype: Optional[str] = None,
        # reference-config keys, accepted and ignored as the JAX adapter does
        model_dir: Optional[str] = None,
        ckpt_path: Optional[str] = None,
        dust3r_path: Optional[str] = None,
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
        pts, conf = self.network(self.frames(data))
        return adapter.outputs_from_world_pts(pts.float(), conf.float())


def tiny_spann3r_config():
    return dict(enc_width=64, enc_depth=2, enc_heads=2, dec_width=48, dec_depth=2, dec_heads=2,
                patch_size=16, memory_frames=2)
