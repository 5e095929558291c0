"""Point-cloud evaluation, port of ``unigeo_tpu/metrics/pointcloud.py``:
scale/shift-invariant alignment, point-to-point ICP, 30-NN PCA normals,
accuracy / completion / normal consistency (no open3d, no scipy).

The chain of the reference (``Regr3D_t_ScaleShiftInv`` with
``norm_mode=False, gt_scale=True``), as in the JAX package:

  1. shift: each cloud's median z over valid pixels (lower-middle median),
     subtracted from pred and gt;
  2. scale: median distance to the per-coordinate median centre; pred is
     rescaled by gt_scale / pred_scale, pred_scale clipped to [1e-3, 1e3];
  3. the gt z-shift is added back to both (gt is restored exactly);
  4. masked pixels gathered on the host, optionally downsampled to
     ``downsample_num`` points with ``np.random.default_rng(seed)`` (the
     same draw as the JAX package, so both pick the same points);
  5. ICP pred -> gt, threshold 0.1, identity start, 30 fixed sweeps;
  6. normals of both clouds by 30-NN PCA;
  7. accuracy = NN distance pred -> gt (and |normal dot|), completion =
     gt -> pred; means in f64, medians with numpy semantics.

Steps 1-3 and 5-7 run on ``device`` (the card unless the caller asks for
the CPU), with TF32 off on the card: the distance expansion needs full f32.
"""

from __future__ import annotations

import numpy as np
import torch

from unigeo_tpu_torch.device import resolve_device, set_exact_f32
from unigeo_tpu_torch.metrics._masked import masked_mean, masked_median
from unigeo_tpu_torch.ops.geometry import reflection_fix
from unigeo_tpu_torch.ops.knn import knn, nearest_neighbor

PCD_METRIC_KEYS = (
    "acc", "comp", "nc1", "nc2", "acc_med", "comp_med", "nc1_med", "nc2_med",
)


def scale_shift_align(pred_pts, gt_pts, masks):
    """(pred_aligned [Nf,H,W,3], gt [Nf,H,W,3], monitoring dict of 0-d
    tensors gt_shift_z, pred_shift_z, gt_scale, pred_scale) for world-space
    pointmaps [Nf,H,W,3] and validity masks [Nf,H,W]."""
    pred_pts, gt_pts = pred_pts.float(), gt_pts.float()
    valid = masks > 0
    gt_shift_z = masked_median(gt_pts[..., 2], valid)
    pred_shift_z = masked_median(pred_pts[..., 2], valid)
    zero = torch.zeros_like(gt_shift_z)
    shift_gt = torch.stack([zero, zero, gt_shift_z])
    shift_pred = torch.stack([zero, zero, pred_shift_z])
    gt_shifted = gt_pts - shift_gt
    pred_shifted = pred_pts - shift_pred

    def median_center_scale(pts):
        center = torch.stack([masked_median(pts[..., i], valid) for i in range(3)])
        return masked_median(torch.linalg.norm(pts - center, dim=-1), valid)

    gt_scale = median_center_scale(gt_shifted)
    pred_scale = median_center_scale(pred_shifted).clamp(1e-3, 1e3)
    pred_aligned = pred_shifted * (gt_scale / pred_scale) + shift_gt
    monitoring = {"gt_shift_z": gt_shift_z, "pred_shift_z": pred_shift_z,
                  "gt_scale": gt_scale, "pred_scale": pred_scale}
    return pred_aligned, gt_pts, monitoring


def icp_point_to_point(src, dst, threshold: float = 0.1, max_iterations: int = 30):
    """Rigid ICP aligning src [N, 3] onto dst [M, 3]: (T [4, 4], moved src).

    Each sweep pairs every src point with its nearest dst point, keeps the
    pairs closer than ``threshold``, and composes the Kabsch rotation of
    the inliers (with the reflection fixed by the sign of the determinant)
    onto the transform; identity start, ``max_iterations`` sweeps (no early
    stop, as in the JAX package); a sweep without inliers leaves the
    transform as it was."""
    src, dst = src.float(), dst.float()
    R = torch.eye(3, device=src.device)
    t = torch.zeros(3, device=src.device)
    for _ in range(max_iterations):
        cur = src @ R.T + t
        dist, idx = nearest_neighbor(cur, dst)
        corr = dst[idx]
        w = (dist < threshold).float()
        wsum = w.sum().clamp_min(1.0)
        mu_s = (cur * w[:, None]).sum(dim=0) / wsum
        mu_d = (corr * w[:, None]).sum(dim=0) / wsum
        H = ((cur - mu_s) * w[:, None]).T @ (corr - mu_d)
        U, _, Vt = torch.linalg.svd(H)
        S = reflection_fix(torch.sign(torch.linalg.det(Vt.T @ U.T)))
        R_step = Vt.T @ S @ U.T
        t_step = mu_d - R_step @ mu_s
        has = w.sum() > 0
        R = torch.where(has, R_step @ R, R)
        t = torch.where(has, R_step @ t + t_step, t)
    T = torch.eye(4, device=src.device)
    T[:3, :3] = R
    T[:3, 3] = t
    return T, src @ R.T + t


def estimate_normals(points, k: int = 30):
    """Per-point normals [N, 3]: the eigenvector of the smallest eigenvalue
    of the k-NN patch's covariance (``eigh`` orders eigenvalues ascending).
    Their sign is arbitrary; the metrics take |dot|."""
    pts = points.float()
    _, idx = knn(pts, pts, k=k)
    centered = pts[idx] - pts[idx].mean(dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", centered, centered) / k
    return torch.linalg.eigh(cov)[1][..., 0]


def accuracy_completion(pred_pts, gt_pts, pred_normals, gt_normals):
    """NN-distance and normal-consistency statistics both ways (accuracy
    pred -> gt, completion gt -> pred), medians with numpy semantics."""
    ones_p = torch.ones(pred_pts.shape[0], dtype=torch.bool, device=pred_pts.device)
    ones_g = torch.ones(gt_pts.shape[0], dtype=torch.bool, device=gt_pts.device)
    dist_a, idx_a = nearest_neighbor(pred_pts, gt_pts)
    nc1_vals = (gt_normals[idx_a] * pred_normals).sum(dim=-1).abs()
    dist_c, idx_c = nearest_neighbor(gt_pts, pred_pts)
    nc2_vals = (gt_normals * pred_normals[idx_c]).sum(dim=-1).abs()
    return {
        "acc": masked_mean(dist_a, ones_p), "acc_med": masked_median(dist_a, ones_p, "numpy"),
        "nc1": masked_mean(nc1_vals, ones_p),
        "nc1_med": masked_median(nc1_vals, ones_p, "numpy"),
        "comp": masked_mean(dist_c, ones_g), "comp_med": masked_median(dist_c, ones_g, "numpy"),
        "nc2": masked_mean(nc2_vals, ones_g),
        "nc2_med": masked_median(nc2_vals, ones_g, "numpy"),
    }


def pcd_evaluation(predicted_pcd, ground_truth_pcd, masks, rgbs=None, threshold: float = 0.1,
                   downsample_num: int = -1, seed: int = 0, icp_iterations: int = 30,
                   device="cuda"):
    """Score predicted world-space pointmaps [Nf, H, W, 3] against GT.

    masks: [Nf, H, W] validity; rgbs: optional [Nf, H, W, 3] colours carried
    to the returned clouds; downsample_num > 0: a random subset (without
    replacement) of the masked points, the same for pred and gt.  Returns
    the floats of ``PCD_METRIC_KEYS``, ``alignment`` (the monitoring
    values) and ``pred_pcd`` / ``gt_pcd`` (points, colours) numpy pairs."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_exact_f32()
    to_dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    mask_np = np.asarray(masks) > 0
    pred_aligned, gt_out, monitoring = scale_shift_align(
        to_dev(predicted_pcd), to_dev(ground_truth_pcd), torch.as_tensor(mask_np, device=dev))

    # host-side masked gather and downsample (data-dependent size)
    pred_np = pred_aligned.cpu().numpy()[mask_np]
    gt_np = gt_out.cpu().numpy()[mask_np]
    colors_np = np.asarray(rgbs)[mask_np] if rgbs is not None else np.zeros_like(pred_np)
    if downsample_num > 0 and pred_np.shape[0] > downsample_num:
        sel = np.random.default_rng(seed).choice(pred_np.shape[0], downsample_num, replace=False)
        pred_np, gt_np, colors_np = pred_np[sel], gt_np[sel], colors_np[sel]

    if pred_np.shape[0] == 0:
        zeros = {k: 0.0 for k in PCD_METRIC_KEYS}
        zeros.update({"pred_pcd": (pred_np, colors_np), "gt_pcd": (gt_np, colors_np)})
        return zeros

    result = {"pred_pcd": (pred_np.copy(), colors_np.copy()),
              "gt_pcd": (gt_np.copy(), colors_np.copy())}
    gt_t = to_dev(gt_np)
    _, pred_icp = icp_point_to_point(to_dev(pred_np), gt_t, threshold=threshold,
                                     max_iterations=icp_iterations)
    stats = accuracy_completion(pred_icp, gt_t, estimate_normals(pred_icp),
                                estimate_normals(gt_t))
    result.update({k: float(v) for k, v in stats.items()})
    result["alignment"] = {k: float(v) for k, v in monitoring.items()}
    return result
