"""Pinhole backprojection, port of ``unigeo_tpu/ops/backproject.py``."""

from __future__ import annotations

import torch


def backproject_to_cv_position(depth: torch.Tensor, intrinsic: torch.Tensor) -> torch.Tensor:
    """[..., H, W] depth + [..., 3, 3] K -> [..., H, W, 3] OpenCV camera points.

    x = (u - cx) z / fx, y = (v - cy) z / fy, z = depth.
    """
    h, w = depth.shape[-2:]
    u = torch.arange(w, dtype=depth.dtype, device=depth.device)
    v = torch.arange(h, dtype=depth.dtype, device=depth.device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    k = intrinsic.to(depth.dtype)[..., None, None, :, :]  # [..., 1, 1, 3, 3]
    z = depth
    x = (uu - k[..., 0, 2]) * z / k[..., 0, 0]
    y = (vv - k[..., 1, 2]) * z / k[..., 1, 1]
    return torch.stack((x, y, z), dim=-1)
