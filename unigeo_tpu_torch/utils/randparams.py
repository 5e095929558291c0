"""Random weights for benches and tools, port of
``unigeo_tpu/utils/randparams.py``.

``random_state_dict_like`` fills a module's state dict with N(0, scale^2)
values from one flat draw of an explicit ``torch.Generator`` on the
module's device, sliced into the tensors in state-dict order (one RNG launch,
not one per tensor), in ``dtype`` (bf16 by default: half the memory, and the
production inference dtype).  The JAX package draws from its own PRNG, so the
two packages' values differ; the shapes, the order and the scale are the
same.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn


def random_state_dict_like(module: nn.Module, seed: int = 0, scale: float = 0.02,
                           dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """{key: random tensor} for every floating-point tensor of ``module``'s
    state dict (other tensors, integer buffers, kept as they are), on the
    module's device."""
    sd = module.state_dict()
    floats = [k for k, v in sd.items() if v.is_floating_point()]
    device = next(iter(sd.values())).device if sd else torch.device("cpu")
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(sd[k].numel() for k in floats)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype) * scale
    out, offset = dict(sd), 0
    for k in floats:
        n = sd[k].numel()
        out[k] = flat[offset:offset + n].view(sd[k].shape)
        offset += n
    return out
