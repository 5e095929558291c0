"""Depth-map evaluation (port of ``unigeo_tpu/metrics/depth.py`` for the
``lstsq`` and ``metric`` alignments).

Validity = 0 < gt < max_depth; alignment uses the validity mask, the
metrics use validity AND the custom mask; pred is clamped to >= 1e-5 before
Log RMSE and the delta thresholds; an all-invalid clip scores zeros.
"""

from __future__ import annotations

from typing import Optional

import torch

from unigeo_tpu_torch.metrics._masked import masked_mean
from unigeo_tpu_torch.metrics.alignment import lstsq_scale_shift

DEPTH_METRIC_KEYS = (
    "Abs Rel",
    "Sq Rel",
    "RMSE",
    "Log RMSE",
    "delta < 1.",
    "delta < 1.25",
    "delta < 1.25^2",
    "delta < 1.25^3",
    "valid_pixels",
)


def depth_evaluation(predicted_depth, ground_truth_depth,
                     max_depth: Optional[float] = 80.0, custom_mask=None,
                     alignment: str = "lstsq"):
    """-> (metrics dict of Python floats, aligned prediction)."""
    pred = torch.as_tensor(predicted_depth).float()
    gt = torch.as_tensor(ground_truth_depth).float().to(pred.device)
    mask = (gt > 0) & (gt < max_depth) if max_depth is not None else gt > 0
    if alignment == "lstsq":
        s, t = lstsq_scale_shift(pred, gt, mask)
    elif alignment == "metric":
        s, t = torch.tensor(1.0), torch.tensor(0.0)
    else:
        raise ValueError(f"alignment {alignment!r} is not ported yet")
    p_aligned = s * pred + t

    metric_mask = mask
    if custom_mask is not None:
        metric_mask = mask & (torch.as_tensor(custom_mask).to(pred.device) > 0)
    mm = metric_mask.float()
    n_valid = mm.sum()
    diff = p_aligned - gt
    safe_gt = torch.where(metric_mask, gt, torch.ones_like(gt))
    abs_rel = masked_mean(diff.abs() / safe_gt, mm)
    sq_rel = masked_mean(diff * diff / safe_gt, mm)
    rmse = masked_mean(diff * diff, mm).sqrt()
    p_log = p_aligned.clamp_min(1e-5)
    log_diff = torch.log(p_log) - torch.log(safe_gt)
    log_rmse = masked_mean(log_diff * log_diff, mm).sqrt()
    safe_p = torch.where(metric_mask, p_log, torch.ones_like(p_log))
    max_ratio = torch.maximum(safe_p / safe_gt, safe_gt / safe_p)
    has = float(n_valid > 0)
    vals = [abs_rel, sq_rel, rmse, log_rmse] + [
        masked_mean((max_ratio < th).float(), mm) for th in (1.0, 1.25, 1.25**2, 1.25**3)
    ]
    out = {k: float(v) * has for k, v in zip(DEPTH_METRIC_KEYS, vals)}
    out["valid_pixels"] = int(n_valid)
    return out, p_aligned
