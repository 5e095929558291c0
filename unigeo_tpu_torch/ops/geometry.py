"""Geometry utility ops, port of ``unigeo_tpu/ops/geometry.py``.

The pixel grid, the polymorphic SE(3) / homography transform ``geotrf``,
depth to camera points, the principal-point offset helpers, mutually
nearest neighbours, weighted Procrustes / Kabsch, and two numpy helpers of
the data pipeline (``crop_intrinsics``, ``pose_distance``).  Tensor
functions run on the device of their inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from unigeo_tpu_torch.ops.knn import nearest_neighbor


def xy_grid(w: int, h: int, homogeneous: bool = False, dtype=torch.float32, device=None):
    """Pixel-centre grid [H, W, 2] (u right, v down); optionally [H, W, 3]."""
    v, u = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                          torch.arange(w, dtype=dtype, device=device), indexing="ij")
    if homogeneous:
        return torch.stack([u, v, torch.ones_like(u)], dim=-1)
    return torch.stack([u, v], dim=-1)


def geotrf(T, pts, ncol=None, norm: bool = False):
    """Apply a [..., 4, 4] (or [..., 3, 3] / [..., 3, 4]) transform to points
    [..., N, 3] (or pixel coordinates [..., N, 2] under a homography)."""
    T, pts = torch.as_tensor(T), torch.as_tensor(pts)
    d = pts.shape[-1]
    out = torch.einsum("...ij,...nj->...ni", T[..., :d, :d], pts)
    if T.shape[-1] > d:
        out = out + T[..., :d, d][..., None, :]
    if norm:  # homogeneous normalization (homography)
        w_ = torch.einsum("...j,...nj->...n", T[..., -1, :d], pts) + T[..., -1, -1][..., None]
        out = out / w_[..., None]
    if ncol is not None:
        out = out[..., :ncol]
    return out


def depthmap_to_pts3d(depth, intrinsics):
    """[..., H, W] depth + [..., 3, 3] K -> [..., H, W, 3] camera points."""
    depth, intrinsics = torch.as_tensor(depth), torch.as_tensor(intrinsics)
    h, w = depth.shape[-2:]
    grid = xy_grid(w, h, dtype=depth.dtype, device=depth.device)
    k = intrinsics[..., None, None, :, :]
    x = (grid[..., 0] - k[..., 0, 2]) * depth / k[..., 0, 0]
    y = (grid[..., 1] - k[..., 1, 2]) * depth / k[..., 1, 1]
    return torch.stack([x, y, depth], dim=-1)


def colmap_to_opencv_intrinsics(K):
    """COLMAP pixel-corner origin -> OpenCV pixel-centre origin."""
    K = torch.as_tensor(K).clone()
    K[..., :2, 2] -= 0.5
    return K


def opencv_to_colmap_intrinsics(K):
    K = torch.as_tensor(K).clone()
    K[..., :2, 2] += 0.5
    return K


def reciprocal_nn_matches(pts_a, pts_b):
    """(mutual [Na] bool, a_to_b [Na]): whether a's nearest b has a as its
    nearest, and a's nearest b."""
    _, a_to_b = nearest_neighbor(pts_a, pts_b)
    _, b_to_a = nearest_neighbor(pts_b, pts_a)
    mutual = b_to_a[a_to_b] == torch.arange(pts_a.shape[0], device=a_to_b.device)
    return mutual, a_to_b


def reflection_fix(d):
    """diag(1, 1, d): with d the sign of a rotation candidate's determinant,
    it turns Kabsch's reflection into a rotation."""
    one = torch.ones_like(d)
    return torch.diag(torch.stack([one, one, d]))


def weighted_procrustes(src, dst, weights=None, with_scale: bool = False):
    """Weighted rigid (or similarity) alignment src -> dst by SVD; [4, 4]."""
    src, dst = torch.as_tensor(src).float(), torch.as_tensor(dst).float().to(src.device)
    n = src.shape[0]
    w = (torch.ones((n,), device=src.device) if weights is None
         else torch.as_tensor(weights).float().to(src.device))
    w = w / w.sum().clamp_min(1e-12)
    mu_s = (src * w[:, None]).sum(dim=0)
    mu_d = (dst * w[:, None]).sum(dim=0)
    sc, dc = src - mu_s, dst - mu_d
    cov = (dc * w[:, None]).T @ sc
    U, D, Vt = torch.linalg.svd(cov)
    S = reflection_fix(torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt)))
    R = U @ S @ Vt
    if with_scale:
        var = (w * (sc * sc).sum(dim=-1)).sum()
        c = torch.trace(torch.diag(D) @ S) / var.clamp_min(1e-12)
    else:
        c = torch.ones((), device=src.device)
    out = torch.eye(4, device=src.device)
    out[:3, :3] = c * R
    out[:3, 3] = mu_d - c * (R @ mu_s)
    return out


def crop_intrinsics(K, crop_xy):
    """Shift the principal point after a crop at (x1, y1)."""
    K = np.array(K, copy=True)
    K[0, 2] -= crop_xy[0]
    K[1, 2] -= crop_xy[1]
    return K


def pose_distance(reference_pose, measurement_pose):
    """(combined, rotation, translation) distance between two c2w poses."""
    rel = np.linalg.inv(np.asarray(reference_pose)) @ np.asarray(measurement_pose)
    R = rel[:3, :3]
    t = rel[:3, 3]
    r_measure = np.sqrt(2 * (1 - min(3.0, np.trace(R)) / 3))
    t_measure = float(np.linalg.norm(t))
    return float(np.sqrt(t_measure**2 + r_measure**2)), float(r_measure), t_measure
