"""Depth-map evaluation, port of ``unigeo_tpu/metrics/depth.py``.

Validity = 0 < gt < max_depth; alignment (every mode of
``metrics/alignment.py``) uses the validity mask, the metrics use validity
AND the custom mask; with ``disp_input`` the alignment runs against 1/gt and
the aligned prediction is inverted back to depth; pred is clamped to >= 1e-5
before Log RMSE and the delta thresholds; an all-invalid clip scores zeros.
"""

from __future__ import annotations

from typing import Optional

import torch

from unigeo_tpu_torch.metrics import alignment as align
from unigeo_tpu_torch.metrics._masked import masked_mean, masked_median

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
ALIGNMENT_MODES = ("metric", "lstsq", "lad", "lad2", "scale", "median")


def safe_gt_full(gt: torch.Tensor) -> torch.Tensor:
    return torch.where(gt == 0, torch.ones_like(gt), gt)


def _align(mode: str, p, g, mask, lr: float, max_iters: int):
    """(s, t) of the alignment ``mode`` over the validity mask."""
    one, zero = torch.ones((), device=p.device), torch.zeros((), device=p.device)
    if mode == "metric":
        return one, zero
    if mode == "lstsq":
        return align.lstsq_scale_shift(p, g, mask)
    if mode == "lad":
        return align.lad_scale_shift(p, g, mask)
    if mode == "lad2":
        s0 = masked_median(g, mask) / masked_median(p, mask).clamp_min(1e-12)
        return align.adam_l1_scale_shift(p, g, mask, s0, lr=lr, max_iters=max_iters)
    if mode == "scale":
        return align.weiszfeld_scale(p, g, mask).clamp_min(1e-3), zero
    if mode == "median":
        return align.median_scale(p, g, mask), zero
    raise ValueError(f"unknown alignment mode {mode!r}")


def depth_evaluation(
    predicted_depth,
    ground_truth_depth,
    max_depth: Optional[float] = 80.0,
    custom_mask=None,
    alignment: str = "lstsq",
    disp_input: bool = False,
    pre_clip_min: Optional[float] = None,
    pre_clip_max: Optional[float] = None,
    post_clip_min: Optional[float] = None,
    post_clip_max: Optional[float] = None,
    lr: float = 1e-4,
    max_iters: int = 1000,
):
    """Evaluate a depth prediction ([H, W] or [Nf, H, W]) against GT.

    Returns (metrics dict of Python floats, error-parity map, aligned
    prediction, masked gt), the JAX package's tuple."""
    pred = torch.as_tensor(predicted_depth).float()
    gt = torch.as_tensor(ground_truth_depth).float().to(pred.device)
    mask = (gt > 0) & (gt < max_depth) if max_depth is not None else gt > 0

    p = pred
    if pre_clip_min is not None:
        p = p.clamp_min(pre_clip_min)
    if pre_clip_max is not None:
        p = p.clamp_max(pre_clip_max)
    g = 1.0 / (gt + 1e-8) if disp_input else gt

    s, t = _align(alignment, p, g, mask, lr, max_iters)
    p_aligned = s * p + t
    if disp_input:
        p_aligned = 1.0 / p_aligned.clamp_min(1e-8)
    if post_clip_min is not None:
        p_aligned = p_aligned.clamp_min(post_clip_min)
    if post_clip_max is not None:
        p_aligned = p_aligned.clamp_max(post_clip_max)

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

    # error-parity map over the validity mask
    zero = torch.zeros_like(gt)
    parity = torch.where(mask, (p_aligned - gt).abs() / safe_gt_full(gt), zero)
    return out, parity, p_aligned, torch.where(mask, gt, zero)
