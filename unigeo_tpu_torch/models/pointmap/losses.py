"""Training objectives of the pointmap family, port of
``unigeo_tpu/models/pointmap/losses.py``.

DUSt3R / Spann3R-lineage confidence-weighted 3D regression: both clouds are
scaled by their mean distance to the origin over valid pixels, the
per-pixel Euclidean error is weighted by the predicted confidence, and a
-alpha log(conf) term keeps the confidences honest.  The masked means are
the metrics' (summed in f64, returned in the input's dtype).
"""

from __future__ import annotations

import torch

from unigeo_tpu_torch.metrics._masked import masked_mean
from unigeo_tpu_torch.models.posecodec import camera_to_pose_encoding


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
    """``masked_mean``; with a process ``group`` over the whole batch that
    the group's ranks hold between them: the f64 sums all-reduced
    (differentiably, ``comm.AllReduceSum``) before the division."""
    if group is None:
        return masked_mean(x, mask)
    from unigeo_tpu_torch.parallel.comm import AllReduceSum

    m = mask.to(x.dtype)
    num = AllReduceSum.apply((x * m).sum(dtype=torch.float64), group)
    den = AllReduceSum.apply(m.sum(dtype=torch.float64), group)
    return (num / den.clamp_min(1.0)).to(x.dtype)


def normalize_by_avg_dis(pts: torch.Tensor, valid: torch.Tensor, eps: float = 1e-8,
                         group=None):
    """(pts / factor, factor): the mean distance to the origin over valid
    pixels (of the whole batch over ``group``'s ranks, when given).  pts
    [..., H, W, 3], valid [..., H, W]."""
    factor = _masked_mean(torch.linalg.vector_norm(pts, dim=-1), valid.to(pts.dtype), group)
    return pts / factor.clamp_min(eps), factor


def pointmap_regression_loss(pred_pts, gt_pts, valid, pred_conf=None, alpha: float = 0.2,
                             normalize: bool = True, group=None):
    """Confidence-weighted regression loss (a scalar).  pred_pts / gt_pts
    [..., H, W, 3], valid [..., H, W], pred_conf [..., H, W] (>= 1 by the
    heads' construction) or None for the unweighted mean error.  ``group``:
    the batch's clips split over its ranks (dp); the normalisation and the
    mean are then the whole batch's, on every rank."""
    v = valid.float()
    if normalize:
        pred_pts, _ = normalize_by_avg_dis(pred_pts, v, group=group)
        gt_pts, _ = normalize_by_avg_dis(gt_pts, v, group=group)
    err = torch.linalg.vector_norm(pred_pts - gt_pts, dim=-1)
    if pred_conf is None:
        return _masked_mean(err, v, group)
    conf = pred_conf.clamp_min(1.0 + 1e-6)
    return _masked_mean(conf * err - alpha * torch.log(conf), v, group)


def pose_loss(pred_enc, gt_c2w, trans_weight: float = 1.0, rot_weight: float = 1.0):
    """L1 on the 7-DoF pose encoding against the ground truth's, the
    quaternions sign-aligned first (a double cover)."""
    gt_enc = camera_to_pose_encoding(gt_c2w)
    sign = torch.sign((pred_enc[..., 3:] * gt_enc[..., 3:]).sum(-1, keepdim=True))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    t_l1 = (pred_enc[..., :3] - gt_enc[..., :3]).abs().mean()
    q_l1 = (pred_enc[..., 3:] - sign * gt_enc[..., 3:]).abs().mean()
    return trans_weight * t_l1 + rot_weight * q_l1
