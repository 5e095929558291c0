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
with random weights from a generator seeded with ``seed`` (checkpoints are
ROADMAP queue 1 item 9), computes in f32 unless ``compute_dtype`` (or
``UNIGEO_COMPUTE_DTYPE``) says bfloat16, and runs the geometry in f32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from unigeo_tpu_torch.device import resolve_device
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
        (carry, decoder tokens [N, C] or (tokens, hooks)).  The memory and
        its mask are written in place."""
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
        mem[start:start + n] = dec
        mem_mask[start:start + n] = 1.0
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


def init_network_(network: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights in place with the JAX package's initialisers
    (lecun-normal kernels, zero biases, unit LayerNorm scales); a transposed
    conv's fan-in is in_channels x kh x kw, as flax counts it."""
    from unigeo_tpu_torch.models.depthcrafter.pipeline import init_random_

    init_random_(network, generator)
    with torch.no_grad():
        for mod in network.modules():
            if isinstance(mod, nn.ConvTranspose2d):
                w = mod.weight  # [in, out, kh, kw]
                w.normal_(0.0, (w.shape[0] * w.shape[2] * w.shape[3]) ** -0.5,
                          generator=generator)
                mod.bias.zero_()
    return network


@MODELS.register("Spann3R")
class Spann3R(adapter.BatchedPointmapForward):
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
        if checkpoint_path:
            raise NotImplementedError(
                f"checkpoint_path={checkpoint_path!r}: checkpoint IO is not ported yet "
                "(ROADMAP queue 1 item 9); leave it null for random weights")
        self.device = resolve_device(device)
        self.compute_dtype = adapter.resolve_compute_dtype(compute_dtype)
        self.transfer_dtype = adapter.resolve_transfer_dtype(transfer_dtype)
        with torch.device("meta"):
            self.network = Spann3RNetwork(**(network_config or {}))
        self.network.to_empty(device=self.device).eval().requires_grad_(False)
        init_network_(self.network, torch.Generator(device=self.device).manual_seed(seed))
        self._cast()

    def _cast(self):
        if self.compute_dtype is not None:
            self.network.to(self.compute_dtype)

    def load_state_dict(self, state_dict) -> "Spann3R":
        """Load the network's weights strictly (e.g. from
        ``utils/weights.py::pointmap_state_dict``), at the compute dtype."""
        self.network.load_state_dict(state_dict, strict=True)
        self._cast()
        return self

    @torch.no_grad()
    def forward_tensors(self, data: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One clip -> the output dict as f32 tensors on the device."""
        raw = torch.from_numpy(adapter.raw_clip(data)).to(self.device)
        frames = adapter.frames_from_raw(raw)
        if self.compute_dtype is not None:
            frames = frames.to(self.compute_dtype)
        pts, conf = self.network(frames)
        return adapter.outputs_from_world_pts(pts.float(), conf.float())

    def forward(self, data: Dict[str, Any]) -> Dict[str, Any]:
        return adapter.fetch_outputs(self.forward_tensors(data), self.transfer_dtype)


def tiny_spann3r_config():
    return dict(enc_width=64, enc_depth=2, enc_heads=2, dec_width=48, dec_depth=2, dec_heads=2,
                patch_size=16, memory_frames=2)
