"""Masked reductions on full tensors (port of ``unigeo_tpu/metrics/_masked.py``).

The mask is carried as weights over the whole array, as in the JAX package.
Means are summed in f64: one f32 sum over a clip's ~5e6 pixels (the JAX
package's) drifts in its fourth digit when the terms are of one size.
Median semantics: ``"torch"``, the lower-middle element for even counts
(torch.median, what the reference uses for depth, normals and the point-cloud
alignment), or ``"numpy"``, the mean of the middle two (np.median, the
reference's nearest-neighbour distance medians).
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


def masked_median(x: torch.Tensor, mask: torch.Tensor, semantics: str = "torch") -> torch.Tensor:
    """Median over valid entries in f32, 0 if none is valid: the lower-middle
    element for ``semantics="torch"``, the mean of the middle two for an even
    count with ``semantics="numpy"``."""
    if semantics not in ("torch", "numpy"):
        raise ValueError(f"bad median semantics: {semantics}")
    vals = x.reshape(-1)[mask.reshape(-1).bool()].float()
    n = vals.numel()
    if n == 0:
        return x.new_zeros((), dtype=torch.float32)
    if semantics == "torch" or n % 2:
        return vals.median()
    s = vals.sort().values
    return 0.5 * (s[n // 2 - 1] + s[n // 2])
