"""Surface-normal evaluation (port of ``unigeo_tpu/metrics/normal.py``):
angular error in degrees, masked mean / lower-middle median / RMSE and the
percentage of pixels under each threshold."""

from __future__ import annotations

import math

import torch

from unigeo_tpu_torch.metrics._masked import masked_mean, masked_median

NORMAL_METRIC_KEYS = (
    "normal mean",
    "normal median",
    "normal rmse",
    "angle < 5",
    "angle < 7.5",
    "angle < 11.25",
    "angle < 22.5",
    "angle < 30",
)


def normal_evaluation(predicted_normal, ground_truth_normal, custom_mask=None):
    """[Nf,H,W,3] channels-last normals -> dict of Python floats."""
    pred = torch.as_tensor(predicted_normal).float()
    gt = torch.as_tensor(ground_truth_normal).float().to(pred.device)
    if custom_mask is None:
        mask = torch.ones(pred.shape[:-1], dtype=torch.bool, device=pred.device)
    else:
        mask = torch.as_tensor(custom_mask).to(pred.device) > 0
    cos = (pred * gt).sum(-1) / (
        torch.linalg.norm(pred, dim=-1) * torch.linalg.norm(gt, dim=-1) + 1e-6
    )
    err = torch.arccos(cos.clamp(-1.0, 1.0)) * (180.0 / math.pi)
    m = mask.float()
    out = {
        "normal mean": masked_mean(err, m),
        "normal median": masked_median(err, mask),
        "normal rmse": masked_mean(err * err, m).sqrt(),
    }
    for th, key in zip((5.0, 7.5, 11.25, 22.5, 30.0), NORMAL_METRIC_KEYS[3:]):
        out[key] = 100.0 * masked_mean((err < th).float(), m)
    return {k: float(v) for k, v in out.items()}
