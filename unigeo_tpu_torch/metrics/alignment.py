"""Scale-and-shift least squares (port of
``unigeo_tpu/metrics/alignment.py::lstsq_scale_shift``; the other alignment
modes are not ported yet)."""

from __future__ import annotations

import torch

from unigeo_tpu_torch.metrics._masked import masked_mean


def lstsq_scale_shift(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor):
    """(s, t) minimising sum over the mask of (s*pred + t - gt)^2, by the
    mean-centred normal equations (stable in f32)."""
    m = mask.float()
    p, g = pred.float(), gt.float()
    mean_p = masked_mean(p, m)
    mean_g = masked_mean(g, m)
    pc = (p - mean_p) * m
    gc = (g - mean_g) * m
    s = (pc * gc).sum() / (pc * pc).sum().clamp_min(1e-12)
    return s, mean_g - s * mean_p
