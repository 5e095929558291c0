"""Masked reductions on full tensors (port of ``unigeo_tpu/metrics/_masked.py``).

The mask is carried as weights over the whole array, as in the JAX package.
Median semantics: torch's lower-middle element for even counts.
"""

from __future__ import annotations

import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp_min(1.0)


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Lower-middle element over valid entries (torch.median); 0 if none."""
    vals = x.reshape(-1)[mask.reshape(-1).bool()]
    if vals.numel() == 0:
        return x.new_zeros(())
    return vals.float().median()
