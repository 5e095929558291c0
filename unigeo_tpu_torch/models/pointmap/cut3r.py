"""CUT3R-class recurrent pointmap regression with a persistent state, port
of ``unigeo_tpu/models/pointmap/cut3r.py``.

The state is a bank of learnable tokens.  The encoder runs over all T
frames at once; then a Python loop over the frames (the JAX package's
``nn.scan``) lets each frame's tokens read the state through a
``PointmapDecoder`` (the state has no grid positions, so in RoPE mode its
keys stay unrotated), and the state read the decoded frame through
``state_update_depth`` ViT blocks.  Per frame the heads emit a self-view
pointmap (its z is the depth), a world-view pointmap and a 7-DoF pose
encoding.

The adapter (registered as ``Cut3R``) decodes the pose encodings to
camera-to-world matrices, recovers the focal from frame 0's self-view
points by Weiszfeld and the normals from the self-view points (OpenGL
flip), all in f32 on the device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from unigeo_tpu_torch.models.camera_solver import estimate_focal_weiszfeld
from unigeo_tpu_torch.models.pointmap import adapter
from unigeo_tpu_torch.models.pointmap.dpt import DPTPointmapHead
from unigeo_tpu_torch.models.pointmap.network import (
    PointmapDecoder,
    PointmapEncoder,
    PointmapHead,
    PoseHead,
    _rope_freq,
    normalize_images,
)
from unigeo_tpu_torch.models.posecodec import pose_encoding_to_camera
from unigeo_tpu_torch.models.vit import ViTBlock
from unigeo_tpu_torch.ops.normals import surface_normals_from_points
from unigeo_tpu_torch.ops.rope import grid_positions
from unigeo_tpu_torch.registry import MODELS


class RecurrentStep(nn.Module):
    """One frame against the state; its weights are shared by every frame
    (the JAX package broadcasts them over its scan)."""

    def __init__(self, enc_width: int, dec_width: int, dec_depth: int, dec_heads: int,
                 state_update_depth: int = 2, return_hooks: bool = False,
                 pos_embed: str = "sincos", qkv_bias: bool = False, norm_context: bool = False):
        super().__init__()
        self.return_hooks = return_hooks
        self.decoder = PointmapDecoder(enc_width, dec_width, dec_depth, dec_heads,
                                       return_hooks=return_hooks, pos_embed=pos_embed,
                                       qkv_bias=qkv_bias, norm_context=norm_context)
        for i in range(state_update_depth):
            self.add_module(f"state_block_{i}", ViTBlock(dec_width, dec_heads, with_cross=True))
        self.state_update_depth = state_update_depth

    def forward(self, state, tok, pos):
        """state [S, C], tok [N, C_enc] -> (new state, decoder tokens [N, C]
        or (tokens, hooks))."""
        out = self.decoder(tok[None], state[None], pos=pos)
        if self.return_hooks:
            dec, hooks = out[0][0], [h[0] for h in out[1]]
        else:
            dec, hooks = out[0], None
        new_state = state
        for i in range(self.state_update_depth):
            new_state = getattr(self, f"state_block_{i}")(new_state[None], dec[None])[0]
        return new_state, ((dec, hooks) if self.return_hooks else dec)


class Cut3RNetwork(nn.Module):
    """frames [T, H, W, 3] in 0..1 -> dict(self_pts, world_pts, conf,
    world_conf, pose_enc)."""

    def __init__(self, enc_width: int = 768, enc_depth: int = 8, enc_heads: int = 12,
                 dec_width: int = 512, dec_depth: int = 6, dec_heads: int = 8,
                 patch_size: int = 16, num_state_tokens: int = 64, head_type: str = "linear",
                 pos_embed: str = "sincos", qkv_bias: bool = False, norm_context: bool = False):
        super().__init__()
        if head_type not in ("linear", "dpt"):
            raise ValueError(f"unknown head_type {head_type!r}")
        self.use_dpt = head_type == "dpt"
        self.freq = _rope_freq(pos_embed)
        self.encoder = PointmapEncoder(enc_width, enc_depth, enc_heads, patch_size,
                                       pos_embed=pos_embed, qkv_bias=qkv_bias)
        self.state_tokens = nn.Parameter(torch.empty(num_state_tokens, dec_width))
        self.recurrent_step = RecurrentStep(enc_width, dec_width, dec_depth, dec_heads,
                                            return_hooks=self.use_dpt, pos_embed=pos_embed,
                                            qkv_bias=qkv_bias, norm_context=norm_context)
        if self.use_dpt:
            dims = (enc_width, dec_width, dec_width, dec_width)
            self.head_self = DPTPointmapHead(dims, patch_size)
            self.head_world = DPTPointmapHead(dims, patch_size)
        else:
            self.head_self = PointmapHead(dec_width, patch_size)
            self.head_world = PointmapHead(dec_width, patch_size)
        self.head_pose = PoseHead(dec_width)

    def forward(self, frames):
        enc, grid = self.encoder(normalize_images(frames))  # [T, N, C]
        pos = None if self.freq is None else grid_positions(*grid, device=enc.device)
        state, ys = self.state_tokens, []
        for f in range(enc.shape[0]):
            state, y = self.recurrent_step(state, enc[f], pos)
            ys.append(y)
        if self.use_dpt:
            dec = torch.stack([d for d, _ in ys])
            hooks = [torch.stack([h[k] for _, h in ys]) for k in range(4)]
            self_pts, self_conf = self.head_self(hooks, grid)
            world_pts, world_conf = self.head_world(hooks, grid)
        else:
            dec = torch.stack(ys)
            self_pts, self_conf = self.head_self(dec, grid)
            world_pts, world_conf = self.head_world(dec, grid)
        return {"self_pts": self_pts, "world_pts": world_pts, "conf": self_conf,
                "world_conf": world_conf, "pose_enc": self.head_pose(dec)}


@MODELS.register("Cut3R")
class Cut3R(adapter.RandomInitAdapter):
    network_cls = Cut3RNetwork

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
        device="cuda",
        **_: Dict,
    ):
        """The JAX adapter's keywords and the ``device`` the network is built
        on.  ``init_*`` size the JAX package's parameter init; the port's
        random weights do not depend on them."""
        self._build(network_config, checkpoint_path, seed, compute_dtype, transfer_dtype, device)

    @torch.no_grad()
    def forward_tensors(self, data: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One clip -> the output dict as f32 tensors on the device (the
        focal a 0-d tensor)."""
        out = {k: v.float() for k, v in self.network(self.frames(data)).items()}
        self_pts = out["self_pts"]
        flip = torch.tensor(adapter.OPENGL_FLIP, device=self_pts.device)
        return {
            "pred_world_pts": out["world_pts"],
            "pred_depths": self_pts[..., 2],
            "pred_normals": surface_normals_from_points(self_pts) * flip,
            "pred_poses": pose_encoding_to_camera(out["pose_enc"]),  # c2w, OpenCV
            "pred_conf": out["conf"],
            "pred_focal": estimate_focal_weiszfeld(self_pts[0]),
        }

    def forward(self, data: Dict[str, Any]) -> Dict[str, Any]:
        host = super().forward(data)
        host["pred_focal"] = float(host["pred_focal"])
        return host


def tiny_cut3r_config():
    return dict(enc_width=64, enc_depth=2, enc_heads=2, dec_width=48, dec_depth=2, dec_heads=2,
                patch_size=16, num_state_tokens=8)
