"""Device-resident plumbing of the pointmap adapters, port of
``unigeo_tpu/models/pointmap/adapter.py``: raw frames in, the network's world
pointmaps through camera recovery, depths, OpenGL normals and c2w poses, all
on the device; the host sees the clip once on the way in (``raw_clip``) and
the output dict once on the way out (``fetch_outputs``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from unigeo_tpu_torch import coords
from unigeo_tpu_torch.models.camera_solver import solve_depth_and_camera_from_pointmaps
from unigeo_tpu_torch.ops.normals import surface_normals_from_points

# OpenCV -> OpenGL normal flip (normals stay OpenGL in the output contract)
OPENGL_FLIP = (1.0, -1.0, -1.0)
# the bulky fields an f16 transfer narrows (depths and poses stay f32)
TRANSFER_DOWNCAST_KEYS = ("pred_world_pts", "pred_normals", "pred_conf")


def raw_clip(data: Dict[str, Any]) -> np.ndarray:
    """data["images"] -> contiguous f32 [T, 3, H, W] 0..255."""
    return np.ascontiguousarray(np.asarray(data["images"], dtype=np.float32))


def frames_from_raw(raw: torch.Tensor) -> torch.Tensor:
    """raw [T, 3, H, W] f32 0..255 -> [T, H, W, 3] in 0..1, on raw's device."""
    return raw.permute(0, 2, 3, 1) / 255.0


def outputs_from_world_pts(pts: torch.Tensor, conf: torch.Tensor) -> Dict[str, torch.Tensor]:
    """World pointmaps [T, H, W, 3] (+ conf) -> the adapter's output dict:
    camera recovery, depths, OpenGL normals and c2w (OpenCV) poses, in f32."""
    cam_pts, extrinsics, _ = solve_depth_and_camera_from_pointmaps(pts)
    flip = torch.tensor(OPENGL_FLIP, dtype=cam_pts.dtype, device=cam_pts.device)
    return {
        "pred_world_pts": pts,
        "pred_depths": cam_pts[..., 2],
        "pred_normals": surface_normals_from_points(cam_pts) * flip,
        "pred_poses": coords.se3_inverse(extrinsics),
        "pred_conf": conf,
    }


def resolve_compute_dtype(arg: Optional[str]):
    """The network's dtype: None (f32, the default) or torch.bfloat16, from
    ``UNIGEO_COMPUTE_DTYPE`` if set, else ``arg``.  The geometry after the
    network always runs in f32."""
    val = os.environ.get("UNIGEO_COMPUTE_DTYPE") or arg
    if val in (None, "", "float32", "f32"):
        return None
    if val in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"compute_dtype must be float32 or bfloat16, got {val!r}")


def resolve_transfer_dtype(arg: Optional[str]):
    """None (f32 transfers) or torch.float16, from ``UNIGEO_TRANSFER_DTYPE``
    if set, else ``arg``: the bulky fields cross to the host in f16 and are
    widened back to f32 there, as in the JAX package."""
    val = os.environ.get("UNIGEO_TRANSFER_DTYPE") or arg
    if val in (None, "", "float32", "f32"):
        return None
    if val in ("float16", "f16"):
        return torch.float16
    raise ValueError(f"transfer_dtype must be float32 or float16, got {val!r}")


def fetch_outputs(outs: Dict[str, torch.Tensor], transfer_dtype=None) -> Dict[str, np.ndarray]:
    """The output dict on the host, the bulky fields through
    ``transfer_dtype`` (f16 widened back to f32) when one is given."""
    host = {}
    for k, v in outs.items():
        if transfer_dtype is not None and k in TRANSFER_DOWNCAST_KEYS:
            v = v.to(transfer_dtype)
        host[k] = v.cpu().numpy().astype(np.float32, copy=False)
    return host


class BatchedPointmapForward:
    """``forward_batch`` of the pointmap adapters.  On one GPU the evaluator
    hands over one clip at a time (the data-parallel executor over several
    GPUs is ROADMAP queue 1 item 11), and a list of clips is scored one by
    one."""

    @property
    def eval_batch_size(self) -> int:
        return 1

    def forward_batch(self, datas):
        return [self.forward(d) for d in datas]
