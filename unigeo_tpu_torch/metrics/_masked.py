"""Masked reductions on full tensors (port of ``unigeo_tpu/metrics/_masked.py``).

The mask is carried as weights over the whole array, as in the JAX package.
Means are summed in f64: one f32 sum over a clip's ~5e6 pixels (the JAX
package's) drifts in its fourth digit when the terms are of one size.
Median semantics: torch's lower-middle element for even counts, the one the
reference uses for depth and normals (numpy's mean of the middle two comes
with the point-cloud metrics).
"""

from __future__ import annotations

import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x where mask is true, 0 if none is; summed in f64 (so the
    result does not depend on the tensor's layout, the thread count or the
    device) and returned in x's dtype."""
    m = mask.to(x.dtype)
    num = (x * m).sum(dtype=torch.float64)
    return (num / m.sum(dtype=torch.float64).clamp_min(1.0)).to(x.dtype)


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Lower-middle element over valid entries (torch.median), in f32; 0 if
    none is valid."""
    vals = x.reshape(-1)[mask.reshape(-1).bool()].float()
    if vals.numel() == 0:
        return x.new_zeros((), dtype=torch.float32)
    return vals.median()
