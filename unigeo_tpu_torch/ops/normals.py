"""Surface normals by a least-squares plane fit over 5x5 patches.

Port of ``unigeo_tpu/ops/normals.py``: zero-padded box sums of the point
moments, the closed-form plane direction adj(C_reg) p_bar of the centred
scatter C (batched 3x3 solves by the adjugate), normalise, and orient toward
the camera.  The box sums are shifted-slice additions in f32, so no
convolution (and no TF32) is involved.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _box_filter(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Sum over a patch_size x patch_size window, zero-padded. x [..., H, W]."""
    pad = patch_size // 2
    h, w = x.shape[-2:]
    xp = F.pad(x, (pad, pad, pad, pad))
    rows = sum(xp[..., :, j : j + w] for j in range(patch_size))
    return sum(rows[..., i : i + h, :] for i in range(patch_size))


def _plane_normal_direction(sums, n_count: float) -> torch.Tensor:
    """Un-normalised plane normal adj(C_reg) p_bar (normals.py:40-99)."""
    mx = sums["x"] / n_count
    my = sums["y"] / n_count
    mz = sums["z"] / n_count
    cxx = sums["xx"] - n_count * mx * mx
    cyy = sums["yy"] - n_count * my * my
    czz = sums["zz"] - n_count * mz * mz
    cxy = sums["xy"] - n_count * mx * my
    cxz = sums["xz"] - n_count * mx * mz
    cyz = sums["yz"] - n_count * my * mz
    reg = 1e-6 * (cxx + cyy + czz) + 1e-12
    cxx = cxx + reg
    cyy = cyy + reg
    czz = czz + reg
    a00 = cyy * czz - cyz * cyz
    a01 = cxz * cyz - cxy * czz
    a02 = cxy * cyz - cxz * cyy
    a11 = cxx * czz - cxz * cxz
    a12 = cxy * cxz - cxx * cyz
    a22 = cxx * cyy - cxy * cxy
    x0 = a00 * mx + a01 * my + a02 * mz
    x1 = a01 * mx + a11 * my + a12 * mz
    x2 = a02 * mx + a12 * my + a22 * mz
    return torch.stack([x0, x1, x2], dim=-1)


def surface_normals_from_points(xyz: torch.Tensor, patch_size: int = 5) -> torch.Tensor:
    """[..., H, W, 3] camera points -> [..., H, W, 3] unit normals with
    dot(normal, point) <= 0."""
    xyz = xyz.float()
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    sums = {
        "xx": _box_filter(x * x, patch_size),
        "yy": _box_filter(y * y, patch_size),
        "zz": _box_filter(z * z, patch_size),
        "xy": _box_filter(x * y, patch_size),
        "xz": _box_filter(x * z, patch_size),
        "yz": _box_filter(y * z, patch_size),
        "x": _box_filter(x, patch_size),
        "y": _box_filter(y, patch_size),
        "z": _box_filter(z, patch_size),
    }
    n = _plane_normal_direction(sums, float(patch_size * patch_size))
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-12)
    flip = (n * xyz).sum(-1, keepdim=True) > 0
    return torch.where(flip, -n, n)


def fix_normal(normal: torch.Tensor, position: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Flip normals that point away from the camera (normals.py:120-134)."""
    direction = position / (torch.linalg.norm(position, dim=-1, keepdim=True) + eps)
    flip = (normal * direction).sum(-1, keepdim=True) > 0.01
    return torch.where(flip, -normal, normal)
