"""Camera-trajectory evaluation, port of ``unigeo_tpu/metrics/camera.py``:
ATE and RPE without evo, and the quaternion / TUM helpers.

* ATE: Sim(3) Umeyama alignment of the estimated positions onto the
  reference ones (evo's align + correct_scale), then the RMSE of the
  position errors.
* RPE translation and rotation over consecutive pairs (delta 1, all pairs),
  RMSE.  A global Sim(3) changes relative translations only by its scale
  and relative rotations not at all, so RPE uses the ATE scale.

``camera_pose_evaluation`` solves in numpy f64 on the host, as the JAX
package does (evo aligns in double precision; at a clip's poses the solve is
far below a kernel launch).  ``umeyama_alignment`` and the quaternion
helpers are torch functions on the device of their input (f32, as the JAX
package computes them); ``c2w_to_tumpose`` and ``get_tum_poses`` return
numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from unigeo_tpu_torch.ops.geometry import reflection_fix


def umeyama_alignment(src, dst, with_scale: bool = True):
    """(R [3,3], t [3], c) minimizing sum ||dst_i - (c R src_i + t)||^2 for
    src, dst [N, 3] (Umeyama 1991; c = 1 without ``with_scale``)."""
    src = torch.as_tensor(src).float()
    dst = torch.as_tensor(dst).float().to(src.device)
    n = src.shape[0]
    mu_s, mu_d = src.mean(dim=0), dst.mean(dim=0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / n
    var_s = (sc * sc).sum(dim=-1).mean()
    U, D, Vt = torch.linalg.svd(cov)
    S = reflection_fix(torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt)))
    R = U @ S @ Vt
    if with_scale:
        c = torch.trace(torch.diag(D) @ S) / var_s.clamp_min(1e-12)
    else:
        c = torch.ones((), device=src.device)
    return R, mu_d - c * (R @ mu_s), c


def _umeyama_np(src, dst):
    """Umeyama in numpy f64 on the host."""
    n = src.shape[0]
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / n
    var_s = np.mean(np.sum(sc * sc, axis=-1))
    U, D, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U) * np.linalg.det(Vt))
    S = np.diag([1.0, 1.0, d])
    R = U @ S @ Vt
    c = np.trace(np.diag(D) @ S) / max(var_s, 1e-18)
    t = mu_d - c * (R @ mu_s)
    return R, t, c


def camera_pose_evaluation(pred_pose, gt_pose):
    """(ate, rpe_trans, rpe_rot) Python floats for camera-to-world poses
    [N, 4, 4] (RPE rotation in degrees)."""
    pred = np.asarray(pred_pose, dtype=np.float64)
    gt = np.asarray(gt_pose, dtype=np.float64)
    t_est, t_ref = pred[:, :3, 3], gt[:, :3, 3]
    R_est, R_ref = pred[:, :3, :3], gt[:, :3, :3]

    R, t, c = _umeyama_np(t_est, t_ref)
    t_aligned = c * t_est @ R.T + t
    err = np.linalg.norm(t_ref - t_aligned, axis=-1)
    ate = float(np.sqrt(np.mean(err * err)))

    # relative pose i -> i+1 of the aligned estimate: rotation
    # R_est_i^T R_est_{i+1} (the alignment cancels), translation
    # c R_est_i^T (t_est_{i+1} - t_est_i); the error's translation norm does
    # not see rel_R_ref^T, so only the ATE scale c enters
    RtT_est = np.swapaxes(R_est[:-1], -1, -2)
    RtT_ref = np.swapaxes(R_ref[:-1], -1, -2)
    rel_R_est = RtT_est @ R_est[1:]
    rel_R_ref = RtT_ref @ R_ref[1:]
    rel_t_est = np.einsum("nij,nj->ni", RtT_est, t_est[1:] - t_est[:-1])
    rel_t_ref = np.einsum("nij,nj->ni", RtT_ref, t_ref[1:] - t_ref[:-1])

    trans_err = np.linalg.norm(c * rel_t_est - rel_t_ref, axis=-1)
    rpe_trans = float(np.sqrt(np.mean(trans_err * trans_err)))

    E = np.swapaxes(rel_R_ref, -1, -2) @ rel_R_est
    tr = np.trace(E, axis1=-2, axis2=-1)
    rot_err = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
    rpe_rot = float(np.sqrt(np.mean(rot_err * rot_err)))
    return ate, rpe_trans, rpe_rot


# ---------------------------------------------------------------------------
# quaternions and TUM poses
# ---------------------------------------------------------------------------

def matrix_to_quaternion(R):
    """Rotation matrices [..., 3, 3] -> unit quaternions [..., 4] (w, x, y,
    z), f32, branch-free (each component from the diagonal, its sign from
    the off-diagonal differences)."""
    R = torch.as_tensor(R).float()
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    half_sqrt = lambda v: torch.sqrt(v.clamp_min(0.0)) / 2.0
    qw = half_sqrt(1.0 + m00 + m11 + m22)
    qx = torch.copysign(half_sqrt(1.0 + m00 - m11 - m22), m21 - m12)
    qy = torch.copysign(half_sqrt(1.0 - m00 + m11 - m22), m02 - m20)
    qz = torch.copysign(half_sqrt(1.0 - m00 - m11 + m22), m10 - m01)
    q = torch.stack([qw, qx, qy, qz], dim=-1)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quaternion_to_matrix(q):
    """Quaternions [..., 4] (w, x, y, z) -> rotation matrices [..., 3, 3], f32."""
    q = torch.as_tensor(q).float()
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def c2w_to_tumpose(c2w):
    """A 4x4 camera-to-world pose -> numpy (x y z qw qx qy qz)."""
    c2w = np.asarray(c2w)
    q = matrix_to_quaternion(torch.from_numpy(np.ascontiguousarray(c2w[:3, :3]))).numpy()
    return np.concatenate([c2w[:3, 3], q])


def get_tum_poses(poses):
    """[N, 4, 4] (or a list of) c2w -> [[N, 7] TUM poses, [N] frame-index
    timestamps]."""
    poses = np.asarray(poses)
    tt = np.arange(len(poses)).astype(float)
    return [np.stack([c2w_to_tumpose(p) for p in poses], 0), tt]
