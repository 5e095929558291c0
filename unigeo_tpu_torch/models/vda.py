"""VideoDepthAnything-class feed-forward video depth, port of
``unigeo_tpu/models/vda.py``.

  encoder   a per-frame ViT (frames in the batch), hooked at the blocks
            L/4, L/2, 3L/4 and L; DINOv2-compatible switches for qkv
            biases, a class token, a learned position table (sliced
            top-left) and the final norm on every hook;
  temporal  at every hook a ViT block over the frame axis: [T, N, C] seen
            as [N, T, C], each token location attending across time;
  head      one DPT head (out_channels 1) shared by the hooks' maps, run
            ``head_chunk`` frames at a time to bound its feature maps'
            memory, then ReLU and the resize to the frame size.

The adapter (registered as ``VideoDepthAnything``) turns the relative
disparity into depth over the clip (min-max, 1 / (x + 0.1)), backprojects
it with the GT intrinsics and fits the normals (OpenGL flip).  Like the JAX
adapter it runs in f32 and returns depths and normals only.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from unigeo_tpu_torch.models.pointmap import adapter
from unigeo_tpu_torch.models.pointmap.dpt import DPTHead
from unigeo_tpu_torch.models.vit import (
    PatchEmbed,
    ScannedViTBlocks,
    ViTBlock,
    resize_bilinear,
    sincos_2d_pos_embed,
)
from unigeo_tpu_torch.ops.backproject import backproject_to_cv_position
from unigeo_tpu_torch.ops.normals import surface_normals_from_points
from unigeo_tpu_torch.registry import MODELS


class VDANetwork(nn.Module):
    """frames [T, H, W, 3] in 0..1 -> disparity [T, H, W] (>= 0, relative)."""

    def __init__(self, width: int = 384, depth: int = 12, num_heads: int = 6,
                 patch_size: int = 14, temporal_heads: int = 6, qkv_bias: bool = False,
                 use_class_token: bool = False, learned_pos_embed: bool = False,
                 max_grid: int = 37, hook_norm: bool = False, head_chunk: int = 8):
        super().__init__()
        self.width, self.depth, self.head_chunk = width, depth, head_chunk
        self.max_grid = max_grid
        self.n_cls = 1 if use_class_token else 0
        self.patch_embed = PatchEmbed(width, patch_size)
        if use_class_token:
            self.cls_token = nn.Parameter(torch.empty(width))
        if learned_pos_embed:
            self.pos_embed = nn.Parameter(torch.empty(max_grid * max_grid + self.n_cls, width))
        self.blocks = ScannedViTBlocks(depth, width, num_heads, qkv_bias=qkv_bias,
                                       return_layers=True)
        if hook_norm:
            self.hook_norm = nn.LayerNorm(width)
        for h in range(4):
            self.add_module(f"temporal_{h}", ViTBlock(width, temporal_heads, qkv_bias=qkv_bias))
        self.head = DPTHead((width,) * 4, out_channels=1,
                            layer_dims=(width // 4, width // 2, width, width))

    def _positions(self, gh, gw, device):
        """The position table of a gh x gw grid (and the class token's row)."""
        if hasattr(self, "pos_embed"):
            pos = self.pos_embed
            grid = pos[self.n_cls:].reshape(self.max_grid, self.max_grid, self.width)
            table = grid[:gh, :gw].reshape(gh * gw, self.width)
            return torch.cat([pos[:self.n_cls], table]) if self.n_cls else table
        table = sincos_2d_pos_embed(self.width, gh, gw, device=device)
        if self.n_cls:
            table = torch.cat([table.new_zeros(1, self.width), table])
        return table

    def forward(self, frames):
        t = frames.shape[0]
        tokens, (gh, gw) = self.patch_embed((frames - 0.5) / 0.5)
        if self.n_cls:
            cls = self.cls_token.to(tokens.dtype).expand(t, 1, self.width)
            tokens = torch.cat([cls, tokens], dim=1)
        tokens = tokens + self._positions(gh, gw, tokens.device).to(tokens.dtype)[None]
        _, layers = self.blocks(tokens)
        hooks = []
        for h in range(4):  # the DepthAnything hooks: blocks L/4, L/2, 3L/4, L
            x = layers[self.depth * (h + 1) // 4 - 1][:, self.n_cls:]
            if hasattr(self, "hook_norm"):
                x = self.hook_norm(x)
            xt = getattr(self, f"temporal_{h}")(x.transpose(0, 1))  # [N, T, C]
            hooks.append(xt.transpose(0, 1))
        # the head is frame-independent: chunks bound its peak memory only
        chunk = min(max(1, self.head_chunk), t)
        disp = torch.cat([self.head([hk[i:i + chunk] for hk in hooks], (gh, gw))[..., 0]
                          for i in range(0, t, chunk)])
        disp = torch.relu(disp)
        if disp.shape[1:] != frames.shape[1:3]:  # patches that do not tile the frame
            disp = resize_bilinear(disp[:, None], *frames.shape[1:3])[:, 0].to(disp.dtype)
        return disp


def postprocess(disp: torch.Tensor, intrinsics: torch.Tensor):
    """disp [T, H, W] >= 0 -> (depths, OpenGL normals): the clip's min-max,
    1 / (x + 0.1), backprojection with ``intrinsics`` [T, 3, 3], plane-fit
    normals."""
    lo, hi = disp.min(), disp.max()
    depths = 1.0 / ((disp - lo) / (hi - lo).clamp_min(1e-8) + 0.1)
    normals = surface_normals_from_points(backproject_to_cv_position(depths, intrinsics))
    return depths, normals * torch.tensor(adapter.OPENGL_FLIP, device=depths.device)


@MODELS.register("VideoDepthAnything")
class VideoDepthAnything(adapter.RandomInitAdapter):
    network_cls = VDANetwork
    takes_dtypes = False

    def __init__(
        self,
        network_config: Optional[Dict[str, Any]] = None,
        checkpoint_path: Optional[str] = None,
        seed: int = 0,
        init_height: int = 384,
        init_width: int = 512,
        init_frames: int = 2,
        # reference-config keys, accepted and ignored as the JAX adapter does
        model_dir: Optional[str] = None,
        ckpt_path: Optional[str] = None,
        device="cuda",
        **_: Dict,
    ):
        """The JAX adapter's keywords and the ``device`` the network is built
        on.  The network runs in f32 as the JAX adapter's does
        (``compute_dtype`` and ``transfer_dtype`` are accepted and ignored,
        as there, and so is ``UNIGEO_COMPUTE_DTYPE``)."""
        self._build(network_config, checkpoint_path, seed, None, None, device)

    @torch.no_grad()
    def forward_tensors(self, data: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One clip -> {pred_depths, pred_normals} as f32 tensors on the device."""
        disp = self.network(self.frames(data))
        intr = torch.as_tensor(np.asarray(data["intrinsics"]), dtype=torch.float32,
                               device=self.device)
        depths, normals = postprocess(disp.float(), intr)
        return {"pred_depths": depths, "pred_normals": normals}


def tiny_vda_config():
    return dict(width=32, depth=4, num_heads=2, patch_size=16, temporal_heads=2)
