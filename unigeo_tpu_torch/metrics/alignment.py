"""Depth alignment solvers, port of ``unigeo_tpu/metrics/alignment.py``.

Every mode of the reference's depth evaluation, on full tensors with a
validity mask, in f32:

  * lstsq  - scale and shift by least squares (mean-centred closed form);
  * median - scale = median(gt) / median(pred) (torch median semantics);
  * scale  - scale only, 10 Weiszfeld IRLS iterations;
  * lad    - L1 scale and shift by 50 IRLS iterations;
  * lad2   - Adam on the L1 objective (torch defaults), all ``max_iters``.

The loops run a fixed number of iterations, as the JAX package's fori_loops
do, so both packages take the same steps.
"""

from __future__ import annotations

import torch

from unigeo_tpu_torch.metrics._masked import masked_mean, masked_median


def _f32(pred, gt, mask):
    return pred.float(), gt.float(), mask.float()


def lstsq_scale_shift(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor):
    """(s, t) minimising sum over the mask of (s*pred + t - gt)^2, by the
    mean-centred normal equations (stable in f32)."""
    p, g, m = _f32(pred, gt, mask)
    mean_p = masked_mean(p, m)
    mean_g = masked_mean(g, m)
    pc = (p - mean_p) * m
    gc = (g - mean_g) * m
    s = (pc * gc).sum() / (pc * pc).sum().clamp_min(1e-12)
    return s, mean_g - s * mean_p


def median_scale(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """median(gt) / median(pred) over valid pixels; 1 where the prediction's
    median is about 0 (a finite bad score instead of a huge scale)."""
    med_gt = masked_median(gt, mask)
    med_pred = masked_median(pred, mask)
    if med_pred.abs() <= 1e-8:
        return torch.ones((), device=pred.device)
    return med_gt / med_pred


def weiszfeld_scale(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                    iters: int = 10) -> torch.Tensor:
    """Scale only, by IRLS with weights 1/(|s*pred - gt| + 1e-8), from
    s = mean(gt) / mean(pred)."""
    p, g, m = _f32(pred, gt, mask)
    s = masked_mean(g, m) / masked_mean(p, m).clamp_min(1e-12)
    for _ in range(iters):
        w = m / ((s * p - g).abs() + 1e-8)
        s = (w * p * g).sum() / (w * p * p).sum().clamp_min(1e-12)
    return s


def lad_scale_shift(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                    iters: int = 50):
    """L1 scale and shift by IRLS (the weighted least-squares step in closed
    form), from s = median(gt) / median(pred), t = 0."""
    p, g, m = _f32(pred, gt, mask)
    s = masked_median(g, m) / masked_median(p, m).clamp_min(1e-12)
    t = torch.zeros((), device=p.device)
    for _ in range(iters):
        w = m / ((s * p + t - g).abs() + 1e-8)
        sw = w.sum().clamp_min(1e-12)
        mean_p = (w * p).sum() / sw
        mean_g = (w * g).sum() / sw
        pc, gc = p - mean_p, g - mean_g
        s = (w * pc * gc).sum() / (w * pc * pc).sum().clamp_min(1e-12)
        t = mean_g - s * mean_p
    return s, t


def adam_l1_scale_shift(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                        s_init, t_init=0.0, lr: float = 1e-4, max_iters: int = 1000):
    """Adam (betas 0.9 / 0.999, eps 1e-8, bias-corrected) on
    sum |s*pred + t - gt| over the mask, for all ``max_iters`` steps."""
    p, g, m = _f32(pred, gt, mask)
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=p.device)
    s, t = f32(s_init), f32(t_init)
    ms, vs, mt, vt = (f32(0.0) for _ in range(4))
    b1, b2, eps = 0.9, 0.999, 1e-8
    for i in range(max_iters):
        sign = torch.sign(s * p + t - g) * m
        gs, gt_ = (sign * p).sum(), sign.sum()
        ms = b1 * ms + (1 - b1) * gs
        mt = b1 * mt + (1 - b1) * gt_
        vs = b2 * vs + (1 - b2) * gs * gs
        vt = b2 * vt + (1 - b2) * gt_ * gt_
        step = f32(i + 1.0)
        c1, c2 = 1 - torch.pow(f32(b1), step), 1 - torch.pow(f32(b2), step)
        s = s - lr * (ms / c1) / (torch.sqrt(vs / c2) + eps)
        t = t - lr * (mt / c1) / (torch.sqrt(vt / c2) + eps)
    return s, t
