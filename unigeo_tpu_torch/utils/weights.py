"""Weight bridge: the JAX package's flax parameter trees -> the port's state dicts.

The port's modules keep the upstream key names (diffusers for the UNet and
the VAE, transformers for CLIP).  This module is the inverse of
``unigeo_tpu/utils/convert_svd.py::convert_svd_checkpoint``, with its own copy
of that module's naming rules: for each key of a port state dict it finds the
flax leaf, undoes the layout change (dense kernels [in, out] -> [out, in],
conv kernels HWIO -> OIHW, temporal conv kernels (k,1,1,in,out) ->
(out,in,k,1,1)) and, for CLIP, picks layer i out of the scan-stacked leading
axis.  It is strict: a port key with no flax leaf, a flax leaf no port key
uses, or a shape that differs raises.

The input is a nested dict of numpy (or array-like) leaves, as
``DepthCrafterPipeline.init_params`` of the JAX package makes it.

The pointmap networks (``pointmap_state_dict``) keep the JAX package's own
module names, so their rule is structural: ``blocks.layers.N.`` picks layer
N of the scan-stacked ``blocks/layers/block`` leaves, Dust3R's
``decoder.layers.N.block1.`` (``block2.``) layer N of
``decoder/layers/block1`` (the Spann3R memory step's and the Cut3R
recurrent step's leaves are broadcast over the frames, not stacked; the
learned tables keep their flax names), ``to_out.0`` is
flax's ``to_out``, and each leaf's layout follows its torch module: Linear
[in, out] -> [out, in], Conv2d HWIO -> OIHW, and ConvTranspose2d HWIO ->
[in, out, kh, kw] spatially flipped (flax's transposed conv correlates the
dilated input with the kernel as stored, torch's with it flipped).

Aether (``aether_state_dicts``) goes through the same rules, with three
of its own: the DiT's ``stack.blocks.N.`` picks layer N of the scan-stacked
``stack/blocks/block`` leaves, GroupNorm leaves sit under flax's
``GroupNorm_0`` level, and Conv3d kernels [kt, kh, kw, in, out] become
[out, in, kt, kh, kw].
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

# --- naming rules (a copy of convert_svd.py's tables) -----------------------

_UNET_RULES = [
    (r"^down_blocks\.(\d+)\.resnets\.(\d+)\.", r"down_\1_res_\2."),
    (r"^down_blocks\.(\d+)\.attentions\.(\d+)\.", r"down_\1_attn_\2."),
    (r"^down_blocks\.(\d+)\.downsamplers\.0\.", r"down_\1_downsample."),
    (r"^mid_block\.resnets\.(\d+)\.", r"mid_res_\1."),
    (r"^mid_block\.attentions\.0\.", "mid_attn."),
    (r"^up_blocks\.(\d+)\.resnets\.(\d+)\.", r"up_\1_res_\2."),
    (r"^up_blocks\.(\d+)\.attentions\.(\d+)\.", r"up_\1_attn_\2."),
    (r"^up_blocks\.(\d+)\.upsamplers\.0\.", r"up_\1_upsample."),
]

_COMMON_RULES = [
    (r"\.transformer_blocks\.0\.", ".transformer_blocks_0."),
    (r"\.temporal_transformer_blocks\.0\.", ".temporal_transformer_blocks_0."),
    (r"(^|\.)to_out\.0\.", r"\1to_out."),
    (r"\.ff\.net\.0\.proj\.", ".ff.net_0.proj."),
    (r"\.ff\.net\.2\.", ".ff.net_2."),
    (r"\.ff_in\.net\.0\.proj\.", ".ff_in.net_0.proj."),
    (r"\.ff_in\.net\.2\.", ".ff_in.net_2."),
]

_VAE_RULES = [
    (r"^encoder\.down_blocks\.(\d+)\.resnets\.(\d+)\.", r"encoder.down_\1_res_\2."),
    (r"^encoder\.down_blocks\.(\d+)\.downsamplers\.0\.conv\.",
     r"encoder.down_\1_downsample.Conv_0."),
    (r"^encoder\.mid_block\.resnets\.(\d+)\.", r"encoder.mid_res_\1."),
    (r"^encoder\.mid_block\.attentions\.0\.", "encoder.mid_attn."),
    (r"^decoder\.mid_block\.resnets\.(\d+)\.", r"decoder.mid_res_\1."),
    (r"^decoder\.mid_block\.attentions\.0\.", "decoder.mid_attn."),
    (r"(mid_attn)\.(to_q|to_k|to_v|to_out)\.", r"\1.attn.\2."),
    (r"^decoder\.up_blocks\.(\d+)\.resnets\.(\d+)\.", r"decoder.up_\1_res_\2."),
    (r"^decoder\.up_blocks\.(\d+)\.upsamplers\.0\.conv\.",
     r"decoder.up_\1_upsample.Conv_0."),
]

_CLIP_RULES = [
    (r"^vision_model\.embeddings\.patch_embedding\.", "vision_model.patch_embed.proj."),
    (r"^vision_model\.embeddings\.class_embedding$", "vision_model.class_embedding"),
    (r"^vision_model\.embeddings\.position_embedding\.weight$", "vision_model.pos_embed"),
    (r"^vision_model\.pre_layrnorm\.", "vision_model.pre_norm."),
    (r"^vision_model\.post_layernorm\.", "vision_model.post_norm."),
    (r"\.self_attn\.q_proj\.", ".attn.to_q."),
    (r"\.self_attn\.k_proj\.", ".attn.to_k."),
    (r"\.self_attn\.v_proj\.", ".attn.to_v."),
    (r"\.self_attn\.out_proj\.", ".attn.to_out."),
    (r"\.layer_norm1\.", ".norm1."),
    (r"\.layer_norm2\.", ".norm2."),
]

# the flax Conv2d / TemporalConv wrappers add a "Conv_0" level, the GroupNorm
# wrapper a "GroupNorm_0" level
_CONV_SITES = [
    (
        r"(^|\.)((?:conv1|conv2|conv_shortcut|conv_in|conv_out|conv|quant_conv|"
        r"time_conv_out))\.(weight|bias)$",
        r"\1\2.Conv_0.\3",
    ),
]

_GROUPNORM_SITES = [
    (r"((?:spatial|temporal)_res_block)\.(norm[12])\.", r"\1.\2.GroupNorm_0."),
    (r"((?:_attn_\d+|mid_attn))\.norm\.", r"\1.norm.GroupNorm_0."),
    (r"conv_norm_out\.", "conv_norm_out.GroupNorm_0."),
    (r"((?:encoder|decoder)\.(?:down|up|mid)_[^.]+)\.(norm[12])\.", r"\1.\2.GroupNorm_0."),
    (r"\.group_norm\.", ".group_norm.GroupNorm_0."),
]

_CLIP_LAYER = re.compile(r"^vision_model\.encoder\.layers\.(\d+)\.(.*)$")
_CLIP_STACK_ROOT = ("vision_model", "blocks", "layers", "block")


def _apply(name: str, rules) -> str:
    for pattern, repl in rules:
        name = re.sub(pattern, repl, name)
    return name


def _flax_leaf(name: str) -> Tuple[str, ...]:
    parts = name.split(".")
    leaf = parts[-1]
    parent = parts[-2].lower() if len(parts) > 1 else ""
    if leaf == "weight":
        leaf = "scale" if "norm" in parent else "kernel"
    return tuple(parts[:-1] + [leaf])


def unet_flax_path(key: str) -> Tuple[str, ...]:
    name = _apply(_apply(key, _UNET_RULES), _COMMON_RULES)
    return _flax_leaf(_apply(_apply(name, _GROUPNORM_SITES), _CONV_SITES))


def vae_flax_path(key: str) -> Tuple[str, ...]:
    name = _apply(_apply(key, _VAE_RULES), _COMMON_RULES)
    return _flax_leaf(_apply(_apply(name, _GROUPNORM_SITES), _CONV_SITES))


def clip_flax_path(key: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """(flax path, layer index or None for an unstacked leaf)."""
    m = _CLIP_LAYER.match(key)
    if m:
        sub = _flax_leaf(_apply(f"layers.{m.group(2)}", _CLIP_RULES))[1:]
        return _CLIP_STACK_ROOT + sub, int(m.group(1))
    return _flax_leaf(_apply(key, _CLIP_RULES)), None


# --- layout -----------------------------------------------------------------

def to_torch_layout(key: str, arr: np.ndarray) -> np.ndarray:
    """Inverse of ``unigeo_tpu/utils/checkpoint.py::convert_tensor``."""
    if key.endswith("position_embedding.weight") or not key.endswith(".weight"):
        return arr
    if arr.ndim == 5:  # (k,1,1,in,out) -> (out,in,k,1,1)
        return np.transpose(arr, (4, 3, 0, 1, 2))
    if arr.ndim == 4:  # HWIO -> OIHW
        return np.transpose(arr, (3, 2, 0, 1))
    if arr.ndim == 2:  # [in, out] -> [out, in]
        return arr.T
    return arr


def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def state_dict_from_flax(flax_params: Mapping[str, Any], module: nn.Module,
                         path_fn, layout_fn=to_torch_layout) -> Dict[str, torch.Tensor]:
    """One component's flax tree -> a state dict with ``module``'s keys.

    ``path_fn``: ``unet_flax_path``, ``vae_flax_path``, or one that returns
    (flax path, layer index or None) as ``clip_flax_path`` does;
    ``layout_fn(key, arr)`` turns a leaf into the torch layout.
    Raises on a missing leaf, a left-over leaf or a shape mismatch."""
    flat = _flatten(flax_params)
    used: Dict[Tuple[str, ...], set] = {}
    out: Dict[str, torch.Tensor] = {}
    for key, ref in module.state_dict().items():
        found = path_fn(key)
        path, idx = found if isinstance(found[0], tuple) else (found, None)
        if path not in flat:
            raise KeyError(f"{key}: no flax leaf {'/'.join(path)}")
        arr = np.asarray(flat[path])
        if idx is not None:
            if idx >= arr.shape[0]:
                raise KeyError(f"{key}: no layer {idx} in flax {'/'.join(path)} {arr.shape}")
            arr = arr[idx]
        arr = layout_fn(key, arr)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: flax {arr.shape} vs port {tuple(ref.shape)}")
        used.setdefault(path, set()).add(idx)
        out[key] = torch.from_numpy(np.array(arr, copy=True))
    left = [p for p in flat if p not in used]
    for path, idxs in used.items():
        if None not in idxs and len(idxs) != np.shape(flat[path])[0]:
            left.append(path)
    if left:
        raise KeyError(f"flax leaves left over: {['/'.join(p) for p in left[:8]]}")
    return out


def pipeline_state_dicts(params: Mapping[str, Any], pipeline):
    """{"unet", "vae", "clip"} flax trees -> (unet_sd, vae_sd, clip_sd) for
    a port ``DepthCrafterPipeline``."""
    return (
        state_dict_from_flax(params["unet"], pipeline.unet, unet_flax_path),
        state_dict_from_flax(params["vae"], pipeline.vae, vae_flax_path),
        state_dict_from_flax(params["clip"], pipeline.clip, clip_flax_path),
    )


# --- the pointmap networks -----------------------------------------------------

_STACKED_LAYER = re.compile(r"^(.*\.)?blocks\.layers\.(\d+)\.(.*)$")
# Dust3R's entangled decoder: both streams' blocks stacked over depth
_ENTANGLED_LAYER = re.compile(r"^(.*\.)?decoder\.layers\.(\d+)\.(block[12]\..*)$")
# Aether's DiT: its scan's leaves under stack/blocks/block, stacked over depth
_DIT_LAYER = re.compile(r"^(.*\.)?stack\.blocks\.(\d+)\.(.*)$")


def pointmap_flax_path(key: str, module_types: Mapping[str, type]):
    """(flax path, layer index or None) of a pointmap network's or Aether's
    key; ``module_types`` maps each key to its torch module's type."""
    name = re.sub(r"(^|\.)to_out\.0\.", r"\1to_out.", key)
    idx = None
    m = _STACKED_LAYER.match(name)
    e = _ENTANGLED_LAYER.match(name)
    d = _DIT_LAYER.match(name)
    if m:
        name = f"{m.group(1) or ''}blocks.layers.block.{m.group(3)}"
        idx = int(m.group(2))
    elif e:
        name = f"{e.group(1) or ''}decoder.layers.{e.group(3)}"
        idx = int(e.group(2))
    elif d:
        name = f"{d.group(1) or ''}stack.blocks.block.{d.group(3)}"
        idx = int(d.group(2))
    parts = name.split(".")
    kind = module_types[key]
    if issubclass(kind, nn.GroupNorm):  # flax's GroupNorm inside the wrapper
        parts[-1:] = ["GroupNorm_0", "scale" if parts[-1] == "weight" else "bias"]
    elif parts[-1] == "weight":
        parts[-1] = "scale" if kind is nn.LayerNorm else "kernel"
    return tuple(parts), idx


def pointmap_layout(key: str, arr: np.ndarray, module_types: Mapping[str, type]) -> np.ndarray:
    if not key.endswith(".weight"):
        return arr
    kind = module_types[key]
    if kind is nn.Linear:
        return arr.T
    if kind is nn.Conv2d:
        return np.transpose(arr, (3, 2, 0, 1))
    if kind is nn.ConvTranspose2d:
        return np.transpose(arr, (2, 3, 0, 1))[:, :, ::-1, ::-1]
    if kind is nn.Conv3d:
        return np.transpose(arr, (4, 3, 0, 1, 2))
    return arr


def pointmap_state_dict(flax_params: Mapping[str, Any], network: nn.Module):
    """A JAX pointmap network's params (``network.init``'s tree, with or
    without its "params" level) -> a strict state dict for the port's
    network of the same configuration (``Spann3RNetwork``, ``Dust3RNetwork``,
    ``Cut3RNetwork``, ``VDANetwork``)."""
    if set(flax_params) == {"params"}:
        flax_params = flax_params["params"]
    module_types = {}
    for name, mod in network.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            module_types[f"{name}.{pname}" if name else pname] = type(mod)
    return state_dict_from_flax(
        flax_params, network,
        lambda key: pointmap_flax_path(key, module_types),
        lambda key, arr: pointmap_layout(key, arr, module_types))


# --- Aether ---------------------------------------------------------------------


def aether_state_dicts(vae_params: Optional[Mapping[str, Any]],
                       dit_params: Optional[Mapping[str, Any]], model) -> Dict[str, torch.Tensor]:
    """The JAX Aether's VAE and DiT params (``init``'s trees, with or without
    their "params" level) -> one strict state dict for ``model``: the port's
    ``AetherNetwork`` (or an adapter holding one as ``network``), or with
    ``dit_params`` None a ``CausalVAE3D``, or with ``vae_params`` None an
    ``AetherDiT``."""
    strip = lambda p: p["params"] if p is not None and set(p) == {"params"} else p
    vae_params, dit_params = strip(vae_params), strip(dit_params)
    if vae_params is None:
        tree = dict(dit_params)
    else:
        tree = dict(vae_params)
        if dit_params is not None:
            tree["dit"] = dit_params
    return pointmap_state_dict(tree, getattr(model, "network", model))
