"""Secondary metrics, port of ``unigeo_tpu/metrics/extras.py``.

  * ``depth_evaluation_in_global_coord``: radial distances scored in the
    world frame;
  * ``completion_ratio``: the share of GT points within a distance of the
    reconstruction;
  * ``voxel_iou``: occupancy IoU on a voxel grid (numpy);
  * ``align_pcd``: the standalone ICP helper;
  * ``plot_trajectory``: a top-down trajectory plot (matplotlib is imported
    inside it only);
  * the evo results-file scraping and directory averaging.

Tensor work runs where the inputs lie (a numpy array on the CPU).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from unigeo_tpu_torch.metrics.alignment import lstsq_scale_shift
from unigeo_tpu_torch.metrics.depth import depth_evaluation
from unigeo_tpu_torch.metrics.pointcloud import icp_point_to_point
from unigeo_tpu_torch.ops.backproject import backproject_to_cv_position
from unigeo_tpu_torch.ops.knn import nearest_neighbor


def depth_evaluation_in_global_coord(predicted_depth, ground_truth_depth, ground_truth_radius,
                                     cam2world, intrinsics, max_depth: float = 80.0,
                                     custom_mask=None):
    """lstsq-align pred depth to gt over the validity mask, backproject with
    K, move to the world with c2w, take the radial norm, and score it with a
    second lstsq against the GT radius (zeroed outside the depth validity
    mask, as the reference masks).  Returns (metrics, aligned radii)."""
    pred = torch.as_tensor(predicted_depth).float()
    dev = pred.device
    gt = torch.as_tensor(ground_truth_depth).float().to(dev)
    radius_gt = torch.as_tensor(ground_truth_radius).float().to(dev)
    c2w = torch.as_tensor(cam2world).float().to(dev)
    K = torch.as_tensor(intrinsics).float().to(dev)

    mask = (gt > 0) & (gt < max_depth)
    s, t = lstsq_scale_shift(pred, gt, mask)
    cam_pts = backproject_to_cv_position(s * pred + t, K)  # [Nf,H,W,3]
    world_pts = (torch.einsum("nij,nhwj->nhwi", c2w[:, :3, :3], cam_pts)
                 + c2w[:, None, None, :3, 3])
    results, _, aligned, _ = depth_evaluation(
        torch.linalg.norm(world_pts, dim=-1), torch.where(mask, radius_gt, 0.0),
        max_depth=None, custom_mask=custom_mask, alignment="lstsq")
    return results, aligned.cpu().numpy()


def completion_ratio(gt_points, rec_points, dist_th: float = 0.05) -> float:
    """Share of GT points whose nearest reconstructed point is closer than
    ``dist_th``."""
    gt = torch.as_tensor(gt_points).float()
    dist, _ = nearest_neighbor(gt, torch.as_tensor(rec_points).float().to(gt.device))
    return float((dist < dist_th).float().mean())


def voxel_iou(pred_points, gt_points, voxel_size: float = 0.1) -> float:
    """Occupancy IoU between the voxelizations of two clouds."""
    def voxels(pts):
        idx = np.floor(np.asarray(pts) / voxel_size).astype(np.int64)
        return set(map(tuple, idx))

    vp = voxels(pred_points)
    vg = voxels(gt_points)
    if not vp and not vg:
        return 1.0
    return len(vp & vg) / max(len(vp | vg), 1)


def align_pcd(source_points, target_points, threshold: float = 0.1):
    """Standalone point-to-point ICP: (T [4,4], transformed source) in numpy."""
    src = torch.as_tensor(source_points).float()
    T, moved = icp_point_to_point(src, torch.as_tensor(target_points).float().to(src.device),
                                  threshold=threshold)
    return T.cpu().numpy(), moved.cpu().numpy()


def plot_trajectory(pred_poses, gt_poses=None, title: str = "", filename: Optional[str] = None):
    """Top-down (x, z) trajectory plot; saved to ``filename`` if given."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    pred = np.asarray(pred_poses)
    ax.plot(pred[:, 0, 3], pred[:, 2, 3], "b-", label="estimate")
    if gt_poses is not None:
        gt = np.asarray(gt_poses)
        ax.plot(gt[:, 0, 3], gt[:, 2, 3], "k--", label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(title)
    ax.legend()
    ax.set_aspect("equal")
    if filename:
        fig.savefig(filename, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return filename
    return fig


# ---------------------------------------------------------------------------
# evo results-txt scraping and directory averaging
# ---------------------------------------------------------------------------

def extract_metrics(file_path: str):
    """(ATE, RPE trans, RPE rot) rmse values scraped from an evo-style
    results txt; a missing metric is 0.0."""
    import re

    with open(file_path, "r") as f:
        content = f.read()

    def rmse_after(header: str) -> float:
        m = re.search(re.escape(header) + r".*?rmse\s+([0-9.]+)", content, re.DOTALL)
        return float(m.group(1)) if m else 0.0

    return (
        rmse_after("APE w.r.t. translation part (m)"),
        rmse_after("RPE w.r.t. translation part (m)"),
        rmse_after("RPE w.r.t. rotation angle in degrees (deg)"),
    )


def process_directory(directory: str):
    """(seq_name, ate, rpe_trans, rpe_rot) of every *_metric.txt under
    ``directory``."""
    import os

    results = []
    for root, _, files in os.walk(directory):
        for name in sorted(files):
            if name.endswith("_metric.txt"):
                # strip the full eval suffix when present, else the short one
                if name.endswith("_eval_metric.txt"):
                    seq = name[: -len("_eval_metric.txt")]
                else:
                    seq = name[: -len("_metric.txt")]
                results.append((seq,) + extract_metrics(os.path.join(root, name)))
    return results


def calculate_trajectory_averages(results):
    """Mean ATE / RPE trans / RPE rot over scraped results (zeros if none)."""
    if not results:
        return 0.0, 0.0, 0.0
    n = len(results)
    return (
        sum(r[1] for r in results) / n,
        sum(r[2] for r in results) / n,
        sum(r[3] for r in results) / n,
    )
