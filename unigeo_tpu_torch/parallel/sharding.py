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
``shard_params`` returns each rank's tp shard; ``parallelize`` puts the
shards in the module and makes it execute tp (``models/layers.py``'s
``TensorParallel`` forward, inside ``tensor_parallel(group)``);
``gather_params`` gives back the whole state dict in the one-device layout.

GEGLU's projection (``ff.net.0.proj``, [2 I, dim]) holds the value rows
first and the gate rows second, and the layer splits its output in two
(``chunk(2, -1)``).  Its equal blocks along dim 0 would give rank 0 value
rows only; rank i holds value block i followed by gate block i instead
(its bias likewise), so the local ``chunk(2)`` pairs each value with its
gate.  The JAX package never sees this: XLA keeps the ``chunk`` global.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Set, Tuple

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


def _geglu_projections(module: nn.Module) -> Set[str]:
    """The module paths of ``module``'s GEGLU projections."""
    from unigeo_tpu_torch.models.layers import GEGLU

    return {f"{name}.proj" if name else "proj" for name, m in module.named_modules()
            if isinstance(m, GEGLU)}


def _block(p: torch.Tensor, dim: int, tp: int, index: int, geglu: bool) -> torch.Tensor:
    """Block ``index`` of ``tp`` of p along ``dim``; GEGLU's projection (and
    its bias): value block ``index`` followed by gate block ``index``."""
    if not geglu:
        return p.chunk(tp, dim=dim)[index]
    value, gate = p.chunk(2, dim=0)
    if value.shape[0] % tp:
        raise ValueError(f"GEGLU's projection {tuple(p.shape)}: its {value.shape[0]} value "
                         f"rows do not split over {tp} ranks")
    return torch.cat([value.chunk(tp, dim=0)[index], gate.chunk(tp, dim=0)[index]])


def _tp_place(mesh, tp_axis: str):
    from unigeo_tpu_torch.parallel.mesh import axis_size

    tp = axis_size(mesh, tp_axis)
    return tp, (mesh[tp_axis].get_local_rank() if tp > 1 else 0)


def shard_params(module: nn.Module, mesh, tp_axis: str = "tp") -> Mapping[str, torch.Tensor]:
    """This rank's tp shard of ``module``'s parameters: each sharded weight's
    ``tp_rank``-th equal block along its spec's dim (GEGLU's projection
    interleaved, see the module doc), the rest whole."""
    tp, index = _tp_place(mesh, tp_axis)
    specs = param_specs(module, tp)
    geglu = _geglu_projections(module)
    return {key: p if specs[key] is None or tp == 1
            else _block(p, specs[key], tp, index, key.rsplit(".", 1)[0] in geglu)
            for key, p in module.named_parameters()}


def parallelize(module: nn.Module, mesh, tp_axis: str = "tp") -> nn.Module:
    """Place ``module`` on ``mesh``'s tp dim, in place: every weight whose
    spec is not None becomes this rank's shard (a column-parallel layer's
    bias too), and its layer gets a ``TPSpec`` (the dim, the tp group, this
    rank's place) and the ``TensorParallel`` forward.  Returns ``module``;
    tp = 1 leaves it as it is.  The layers then run tp inside
    ``layers.tensor_parallel(mesh.get_group(tp_axis))``."""
    from unigeo_tpu_torch.models.layers import TPSpec, tensor_parallel_class

    tp, index = _tp_place(mesh, tp_axis)
    if tp == 1:
        return module
    if any(getattr(m, "tp_spec", None) is not None for m in module.modules()):
        raise ValueError(f"{type(module).__name__} is placed on tp already: parallelize it once")
    group = mesh.get_group(tp_axis)
    owners = dict(module.named_modules())
    geglu = _geglu_projections(module)
    for key, dim in param_specs(module, tp).items():
        if dim is None:
            continue
        path = key.rsplit(".", 1)[0]
        owner = owners[path]
        spec = TPSpec(dim, group, tp, index, geglu=path in geglu)
        leaves = ["weight"] + (["bias"] if dim == 0 and owner.bias is not None else [])
        for leaf in leaves:
            p = getattr(owner, leaf)
            block = _block(p.detach(), dim if leaf == "weight" else 0, tp, index, spec.geglu)
            setattr(owner, leaf, nn.Parameter(block.contiguous().clone(),
                                              requires_grad=p.requires_grad))
        owner.tp_spec = spec
        owner.__class__ = tensor_parallel_class(type(owner))
    return module


def gather_params(module: nn.Module,
                  values: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """The whole state dict of a module placed by ``parallelize``, in the
    one-device layout (GEGLU's projection un-interleaved), on every rank of
    the tp group: each shard gathered over its layer's group, the rest as
    it is (a module never placed: its state dict).

    values: {state-dict key: this rank's tensor of that key's local shape}
    to gather instead of the module's own (the gradients, say); only those
    keys come back."""
    from unigeo_tpu_torch.parallel.comm import all_gather

    owners = dict(module.named_modules())
    local = module.state_dict() if values is None else values
    out = {}
    for key, t in local.items():
        path, leaf = key.rsplit(".", 1) if "." in key else ("", key)
        spec = getattr(owners.get(path), "tp_spec", None)
        if spec is None or not (leaf == "weight" or (leaf == "bias" and spec.dim == 0)):
            out[key] = t
            continue
        dim = spec.dim if leaf == "weight" else 0
        whole = all_gather(t.detach().contiguous(), spec.group, dim)
        if spec.geglu:  # [v0 g0 v1 g1 ...] -> [v0 v1 ... g0 g1 ...]
            pairs = [b.chunk(2, dim=0) for b in whole.chunk(spec.size, dim=0)]
            whole = torch.cat([v for v, _ in pairs] + [g for _, g in pairs])
        out[key] = whole
    return out
