"""VideoDepthAnything / DepthAnything checkpoints -> the port's
``VDANetwork`` state dict, the counterpart of
``unigeo_tpu/utils/convert_vda.py``.

A DINOv2 ViT backbone (prefix ``pretrained.``) and a DPT head with temporal
motion modules (prefix ``head.``; plain DepthAnything uses ``depth_head.``
and has no motion modules).  Both sides are torch, so tensors keep their
layouts; the names change, the fused ``attn.qkv`` splits in three, and:

  pretrained.cls_token [1, 1, C]      -> cls_token [C]
  pretrained.pos_embed [1, 1+N, C]    -> pos_embed [1+N, C]
  pretrained.patch_embed.proj.*       -> patch_embed.proj.*
  pretrained.norm.*                   -> hook_norm.*
  pretrained.blocks.{i}.*             -> blocks.layers.{i}.*
  head.motion_modules.{h}.*           -> temporal_{h}.*
  head.projects.{k}.*                 -> head.act_postprocess_{k}_proj.*
  head.resize_layers.{0,1,3}.*        -> head.act_postprocess_{k}_resample.*
  head.scratch.layer{k}_rn.*          -> head.layer{k}_rn.*
  head.scratch.refinenet{k}.*         -> head.refinenet{k}.*
  head.scratch.output_conv1.*         -> head.head_0.*
  head.scratch.output_conv2.{0,2}.*   -> head.head_2.* / head.head_4.*

DINOv2's LayerScale gammas (``ls1.gamma``, ``ls2.gamma``) are folded into
the branch's output projection, exactly: gamma * (h W^T + b) = h (gamma W)^T
+ gamma * b, so ``attn.to_out.0`` and ``mlp.fc2`` take weight * gamma[:, None]
and bias * gamma (the port's ViT block has no LayerScale).

Skipped, and reported: ``mask_token``, ``register_tokens`` and the DPT
head's ``refinenet4.resConfUnit1`` (dead in the torch forward: the deepest
fusion block has no skip input).  A block key no rule maps, and any key
outside the two prefixes, is refused, named.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import torch

from unigeo_tpu_torch.utils.convert_dust3r import DEAD_DPT_UNIT

BACKBONE_SKIPPED = ("mask_token", "register_tokens")
HEAD_RULES = [
    (r"^projects\.(\d)\.", r"act_postprocess_\1_proj."),
    (r"^resize_layers\.([013])\.", r"act_postprocess_\1_resample."),
    (r"^scratch\.layer(\d)_rn\.", r"layer\1_rn."),
    (r"^scratch\.refinenet(\d)\.", r"refinenet\1."),
    (r"^scratch\.output_conv1\.", "head_0."),
    (r"^scratch\.output_conv2\.0\.", "head_2."),
    (r"^scratch\.output_conv2\.2\.", "head_4."),
]
_BLOCK_NAMES = {"attn.proj": "attn.to_out.0", "norm1": "norm1", "norm2": "norm2",
                "mlp.fc1": "mlp.fc1", "mlp.fc2": "mlp.fc2"}
_GAMMA = {"attn.proj": "ls1.gamma", "mlp.fc2": "ls2.gamma"}


def vit_block_entries(sub: Mapping[str, torch.Tensor]
                      ) -> Tuple[List[Tuple[str, torch.Tensor]], List[str]]:
    """One timm / DINOv2 block's {key inside the block: tensor} -> ([(the
    port's key inside the block, tensor)], the keys no rule maps): qkv
    split, LayerScale folded."""
    out, unknown = [], []
    for name, t in sub.items():
        if name in ("ls1.gamma", "ls2.gamma"):
            continue
        stem, _, leaf = name.rpartition(".")
        if leaf not in ("weight", "bias"):
            unknown.append(name)
        elif stem == "attn.qkv":
            out += [(f"attn.to_{n}.{leaf}", x.clone()) for n, x in zip("qkv", t.chunk(3, 0))]
        elif stem in _BLOCK_NAMES:
            gamma = sub.get(_GAMMA.get(stem, ""))
            if gamma is not None:
                t = t * (gamma[:, None] if leaf == "weight" else gamma)
            out.append((f"{_BLOCK_NAMES[stem]}.{leaf}", t))
        else:
            unknown.append(name)
    return out, unknown


def _rename_head(name: str) -> str:
    for pattern, repl in HEAD_RULES:
        name = re.sub(pattern, repl, name)
    return name


def convert_vda_checkpoint(
        state_dict: Mapping[str, torch.Tensor], backbone_prefix: str = "pretrained.",
        head_prefix: str = "head.") -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A VideoDepthAnything state dict -> (the port's ``VDANetwork`` state
    dict, the source keys skipped).  For plain DepthAnything pass
    ``head_prefix="depth_head."``.  Raises ``KeyError`` naming every key no
    rule maps."""
    out: Dict[str, torch.Tensor] = {}
    skipped, unknown = [], []
    # the port's block root -> (the source's block prefix, {key in the block: tensor})
    layers: Dict[str, Tuple[str, Dict[str, torch.Tensor]]] = {}
    blk = re.compile(r"^blocks\.(\d+)\.(.*)$")
    mm = re.compile(r"^motion_modules\.(\d+)\.(.*)$")
    for name, t in state_dict.items():
        if name.startswith(backbone_prefix):
            sub = name[len(backbone_prefix):]
            m = blk.match(sub)
            if sub == "cls_token":
                out["cls_token"] = t.reshape(-1)
            elif sub == "pos_embed":
                out["pos_embed"] = t.reshape(t.shape[-2], t.shape[-1])
            elif sub.startswith("patch_embed.proj."):
                out[sub] = t
            elif sub.startswith("norm."):
                out["hook_norm." + sub[len("norm."):]] = t
            elif m:
                layers.setdefault(f"blocks.layers.{m.group(1)}",
                                  (name[:-len(m.group(2))], {}))[1][m.group(2)] = t
            elif sub.startswith(BACKBONE_SKIPPED):
                skipped.append(name)
            else:
                unknown.append(name)
        elif name.startswith(head_prefix):
            sub = name[len(head_prefix):]
            m = mm.match(sub)
            if m:
                layers.setdefault(f"temporal_{m.group(1)}",
                                  (name[:-len(m.group(2))], {}))[1][m.group(2)] = t
            elif DEAD_DPT_UNIT in sub:
                skipped.append(name)
            else:
                out[f"head.{_rename_head(sub)}"] = t
        else:
            unknown.append(name)
    for root, (source, sub) in layers.items():
        entries, left = vit_block_entries(sub)
        out.update((f"{root}.{k}", v) for k, v in entries)
        unknown += [source + k for k in left]
    if unknown:
        raise KeyError(f"{len(unknown)} unrecognized VideoDepthAnything keys: {unknown[:10]}")
    return out, skipped
