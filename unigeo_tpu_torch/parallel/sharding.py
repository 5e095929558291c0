"""Tensor-parallel partitioning rules, port of ``unigeo_tpu/parallel/sharding.py``.

Megatron-style, over the port's diffusers / transformers module names:

  * to_q / to_k / to_v (q_proj / k_proj / v_proj), GEGLU and MLP
    in-projections (ff.net.0, fc1)                 -> shard OUTPUT features
  * to_out (out_proj), MLP out-projections (ff.net.2, fc2)
                                                   -> shard INPUT features
  * resblock conv1 (+ time_emb_proj)               -> shard OUTPUT channels
  * resblock conv2                                 -> shard INPUT channels
  * conv_shortcut, downsample / upsample convs     -> shard OUTPUT channels
  * two-layer timestep MLPs (linear_1 / linear_2)  -> column / row pair
  * norms, embeddings, biases, proj_in / proj_out  -> replicated

A rule matches the weight of an ``nn.Linear`` or ``nn.Conv*`` by the
segments of its module path (``downsample`` / ``upsample`` as substrings of
the path), never by the leaf name ``weight`` alone: ``nn.Embedding`` (CLIP's
position table) and every norm stay replicated, as the JAX package's
``kernel``-only rule keeps them.

Layouts differ: flax stores dense kernels [in, out] and convs [kh, kw, in,
out]; PyTorch stores [out, in] and [out, in, kh, kw].  So column-parallel
shards PyTorch dim 0 and row-parallel dim 1.  A dim that does not divide
the tp size replicates (never an uneven layout).

A spec here is the dim a weight is split on over tp, or None (replicated).
``shard_params`` returns each rank's tp shard; nothing executes tp in the
port yet (the trainer's slice, ROADMAP queue 1 item 11).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn

# matched against path SEGMENTS (one name each, or consecutive names)
_COL_PARALLEL = (
    "to_q", "to_k", "to_v", "q_proj", "k_proj", "v_proj", "fc1", "net.0",
    "conv1", "time_emb_proj",
    "conv_shortcut", "linear_1",
)
_ROW_PARALLEL = (
    "to_out", "out_proj", "fc2", "net.2",
    "conv2", "linear_2",
)
# matched as substrings of the joined path (indexed module names)
_COL_PARALLEL_SUBSTR = ("downsample", "upsample")
_SHARDABLE = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)


def _has_segment(segments, tag: str) -> bool:
    parts = tag.split(".")
    n = len(parts)
    return any(segments[i:i + n] == parts for i in range(len(segments) - n + 1))


def param_spec(key: str, shape: Tuple[int, ...], tp_size: int = 2,
               module: Optional[nn.Module] = None) -> Optional[int]:
    """The dim the parameter ``key`` (a state-dict key) of ``shape`` is split
    on over tp, or None.  ``module``: the module that owns it (when given,
    only an ``nn.Linear`` / ``nn.Conv*`` weight is sharded)."""
    segments = key.split(".")
    if segments[-1] != "weight" or len(shape) < 2:
        return None
    if module is not None and not isinstance(module, _SHARDABLE):
        return None
    path = segments[:-1]
    joined = ".".join(path)
    col = any(_has_segment(path, t) for t in _COL_PARALLEL) or any(
        t in joined for t in _COL_PARALLEL_SUBSTR)
    row = any(_has_segment(path, t) for t in _ROW_PARALLEL)
    if col:
        return 0 if shape[0] % tp_size == 0 else None
    if row:
        return 1 if shape[1] % tp_size == 0 else None
    return None


def param_specs(module: nn.Module, tp_size: int = 2) -> Dict[str, Optional[int]]:
    """Every parameter of ``module`` -> its spec (``param_spec``)."""
    owners = dict(module.named_modules())
    specs = {}
    for key, p in module.named_parameters():
        owner = owners[key.rsplit(".", 1)[0]] if "." in key else module
        specs[key] = param_spec(key, tuple(p.shape), tp_size, owner)
    return specs


def sharded_bytes_fraction(module: nn.Module, tp_size: int = 2) -> Tuple[int, int]:
    """(sharded bytes, total bytes) of ``module``'s parameters under the
    rules at ``tp_size`` (meta-device modules count too)."""
    sharded = total = 0
    specs = param_specs(module, tp_size)
    for key, p in module.named_parameters():
        nbytes = p.numel() * p.element_size()
        total += nbytes
        if specs[key] is not None:
            sharded += nbytes
    return sharded, total


def shard_params(module: nn.Module, mesh, tp_axis: str = "tp") -> Mapping[str, torch.Tensor]:
    """This rank's tp shard of ``module``'s parameters: each sharded weight's
    ``tp_rank``-th equal block along its spec's dim, the rest whole."""
    from unigeo_tpu_torch.parallel.mesh import axis_size

    tp = axis_size(mesh, tp_axis)
    index = mesh[tp_axis].get_local_rank() if tp > 1 else 0
    specs = param_specs(module, tp)
    return {key: p if specs[key] is None or tp == 1 else p.chunk(tp, dim=specs[key])[index]
            for key, p in module.named_parameters()}
