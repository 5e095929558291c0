"""Random weights for benches and tools, port of
``unigeo_tpu/utils/randparams.py``.

``random_state_dict_like`` fills a module's state dict with N(0, scale^2)
values from one flat draw of an explicit ``torch.Generator`` on the
module's device, sliced into the tensors in state-dict order (one RNG launch,
not one per tensor), in ``dtype`` (bf16 by default: half the memory, and the
production inference dtype).  ``random_pipeline_params`` does so for the
three modules of a ``DepthCrafterPipeline`` (built on the meta device and
given storage on its device by its constructor), so a full-size pipeline's
random bf16 weights are drawn on the card with no float32 copy anywhere
(a full-size float32 init is 6 GB).  The JAX package draws from its own
PRNG, so the two packages' values differ; the shapes, the order and the
scale are the same.
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


def random_pipeline_params(pipe, seed: int = 0, scale: float = 0.02,
                           dtype: torch.dtype = torch.bfloat16) -> Dict[str, Dict[str, torch.Tensor]]:
    """Fill ``pipe``'s modules with random weights drawn on its device and
    return them, keyed as the pipeline's checkpoint ("unet", "vae",
    "clip"): ``random_state_dict_like`` per module, one seed each
    from ``seed``; the modules' float tensors then hold them in the modules'
    dtype.  The JAX package's version takes the clip shape for its
    ``eval_shape``; the port's modules know their shapes without one."""
    from unigeo_tpu_torch.models.depthcrafter.pipeline import CHECKPOINT_KEYS

    params = {}
    with torch.no_grad():
        for i, (name, module) in enumerate(zip(CHECKPOINT_KEYS, pipe.modules())):
            params[name] = random_state_dict_like(module, seed=seed + i, scale=scale, dtype=dtype)
            module.load_state_dict(params[name])
    return params
