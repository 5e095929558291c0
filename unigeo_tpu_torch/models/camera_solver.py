"""Camera recovery from pointmaps, port of ``unigeo_tpu/models/camera_solver.py``.

* ``estimate_focal_weiszfeld``: the focal of a frame-0 pointmap with a
  central principal point, by 10 fixed IRLS steps.
* ``_dlt_pose`` / ``solve_pnp_batch``: per frame, a weighted DLT for
  P = [R|t] from every pixel (the smallest eigenvector of the 12 x 12
  normal matrix of the Hartley-normalised system), the depth-sign fix and
  the projection onto a rotation, with one IRLS reweighting by the
  reprojection error; all frames at once.
* ``solve_depth_and_camera_from_pointmaps``: the focal from frame 0, the
  poses, and each frame's points in its camera.

World frame = frame-0 camera (OpenCV); extrinsics are world-to-camera.
Everything runs in f32 on the pointmaps' device, with TF32 off for every
product whatever the process's flags (``device.exact_f32``): the DLT squares
a system of 2 H W rows, and its smallest eigenvector is only as good as
that f32 product.
"""

from __future__ import annotations

import math

import torch

from unigeo_tpu_torch.device import exact_f32


def estimate_focal_weiszfeld(pts3d: torch.Tensor, pp=None, iters: int = 10) -> torch.Tensor:
    """Focal minimising sum_i || pixel_i - f (x, y)_i / z_i || over a pointmap
    [H, W, 3] by IRLS from the least-squares start."""
    pts3d = pts3d.float()
    h, w, _ = pts3d.shape
    dev = pts3d.device
    ppx, ppy = (w / 2.0, h / 2.0) if pp is None else (float(pp[0]), float(pp[1]))
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :] - ppx
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - ppy
    pixels = torch.stack([u.expand(h, w), v.expand(h, w)], dim=-1).reshape(-1, 2)
    xy = pts3d[..., :2].reshape(-1, 2)
    z = pts3d[..., 2].reshape(-1, 1)
    xy_over_z = torch.where(z.abs() > 1e-8, xy / z, 0.0)
    xy_over_z = torch.nan_to_num(xy_over_z, posinf=0.0, neginf=0.0)
    dot_xy_px = (xy_over_z * pixels).sum(-1)
    dot_xy_xy = (xy_over_z * xy_over_z).sum(-1)
    focal = dot_xy_px.mean() / dot_xy_xy.mean().clamp_min(1e-12)
    for _ in range(iters):
        dis = torch.linalg.vector_norm(pixels - focal * xy_over_z, dim=-1)
        wgt = 1.0 / dis.clamp_min(1e-8)
        focal = (wgt * dot_xy_px).mean() / (wgt * dot_xy_xy).mean().clamp_min(1e-12)
    return focal


def _dlt_pose(pts3d: torch.Tensor, pts2d_norm: torch.Tensor, weights: torch.Tensor):
    """Weighted DLT per frame: pts3d [F, N, 3], pts2d_norm [N, 2] (K^-1
    pixels), weights [F, N] -> (R [F, 3, 3], t [F, 3]).

    P's 12 entries (up to scale) are the eigenvector of A^T A with the
    smallest eigenvalue (``eigh`` sorts them ascending, as ``jnp.linalg.eigh``
    does), A built from Hartley-normalised points (centroid 0, RMS radius
    sqrt 3), un-normalised after.  P's sign makes most depths positive,
    whatever sign the solver gave the eigenvector; R = U D V^T with D =
    diag(1, 1, det sign) is the nearest rotation, and t is scaled by the
    mean of the first two singular values."""
    f, n, _ = pts3d.shape
    dev = pts3d.device
    ones = torch.ones((f, n, 1), device=dev)
    centroid = pts3d.mean(dim=1)  # [F, 3]
    d = pts3d - centroid[:, None]
    scale = math.sqrt(3.0) / torch.sqrt((d * d).sum(-1).mean(-1)).clamp_min(1e-12)  # [F]
    x = torch.cat([d * scale[:, None, None], ones], dim=-1)  # [F, N, 4]
    zeros = torch.zeros_like(x)
    u, v = pts2d_norm[:, :1], pts2d_norm[:, 1:2]
    rows_u = torch.cat([x, zeros, -u * x], dim=-1)  # [F, N, 12]
    rows_v = torch.cat([zeros, x, -v * x], dim=-1)
    wgt = weights[..., None]
    a = torch.cat([rows_u * wgt, rows_v * wgt], dim=1)  # [F, 2N, 12]
    m = a.transpose(1, 2) @ a  # [F, 12, 12]
    _, vecs = torch.linalg.eigh(m)
    p = vecs[..., 0].reshape(f, 3, 4)
    t_norm = torch.eye(4, device=dev).repeat(f, 1, 1)
    t_norm[:, :3, :3] *= scale[:, None, None]
    t_norm[:, :3, 3] = -scale[:, None] * centroid
    p = p @ t_norm
    depths = (torch.cat([pts3d, ones], dim=-1) * p[:, None, 2, :]).sum(-1)  # [F, N]
    flip = torch.sign(depths).sum(-1) < 0
    p = torch.where(flip[:, None, None], -p, p)
    uu, s, vt = torch.linalg.svd(p[:, :, :3])
    det_sign = torch.sign(torch.linalg.det(uu @ vt))
    dm = torch.diag_embed(torch.stack([torch.ones_like(det_sign), torch.ones_like(det_sign),
                                       det_sign], dim=-1))
    r = uu @ dm @ vt
    t = p[:, :, 3] / s[:, :2].mean(-1, keepdim=True).clamp_min(1e-12)
    return r, t


def solve_pnp_batch(pts3d: torch.Tensor, intrinsics: torch.Tensor, irls_iters: int = 2):
    """World pointmaps [F, H, W, 3] + K [3, 3] -> extrinsics [F, 4, 4]
    (world-to-camera): the weighted DLT, reweighted by 1 / (reprojection
    error + 1e-4) (normalised to mean 1) between ``irls_iters`` solves."""
    with exact_f32():
        pts3d = pts3d.float()
        f, h, w, _ = pts3d.shape
        dev = pts3d.device
        k = intrinsics.float().to(dev)
        vv, uu = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                                torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
        pix = torch.stack([(uu - k[0, 2]) / k[0, 0], (vv - k[1, 2]) / k[1, 1]],
                          dim=-1).reshape(-1, 2)
        pts = pts3d.reshape(f, -1, 3)
        wgt = torch.ones(pts.shape[:2], device=dev)
        r = torch.eye(3, device=dev).repeat(f, 1, 1)
        t = torch.zeros((f, 3), device=dev)
        for _ in range(irls_iters):
            r, t = _dlt_pose(pts, pix, wgt)
            cam = pts @ r.transpose(1, 2) + t[:, None]
            proj = cam[..., :2] / cam[..., 2:3].clamp_min(1e-6)
            err = torch.linalg.vector_norm(proj - pix, dim=-1)
            wgt = 1.0 / (err + 1e-4)
            wgt = wgt / wgt.mean(-1, keepdim=True)
        ext = torch.eye(4, device=dev).repeat(f, 1, 1)
        ext[:, :3, :3] = r
        ext[:, :3, 3] = t
        return ext


def solve_depth_and_camera_from_pointmaps(pts3d: torch.Tensor):
    """World pointmaps [F, H, W, 3] -> (camera points [F, H, W, 3],
    extrinsics [F, 4, 4] world-to-camera, intrinsics [F, 3, 3]): the focal
    from frame 0, shared by every frame, the principal point at the centre."""
    with exact_f32():
        pts3d = pts3d.float()
        f, h, w, _ = pts3d.shape
        focal = estimate_focal_weiszfeld(pts3d[0])
        k = torch.eye(3, device=pts3d.device)
        k[0, 0] = focal
        k[1, 1] = focal
        k[0, 2] = w / 2.0
        k[1, 2] = h / 2.0
        ext = solve_pnp_batch(pts3d, k)
        r, t = ext[:, :3, :3], ext[:, :3, 3]
        cam = torch.einsum("nij,nhwj->nhwi", r, pts3d) + t[:, None, None, :]
        return cam, ext, k.expand(f, 3, 3)
