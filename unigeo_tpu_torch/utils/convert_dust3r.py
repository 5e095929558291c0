"""DUSt3R checkpoints -> the port's ``Dust3RNetwork`` state dict, the
counterpart of ``unigeo_tpu/utils/convert_dust3r.py``.

The port's pointmap modules keep the JAX package's module names, and both
sides are torch, so every tensor keeps its layout (Linear [out, in], Conv2d
[out, in, kh, kw], and ConvTranspose2d [in, out, kh, kw] with no flip: the
flip the JAX package applies is flax's, which the port's weight bridge
undoes).  What changes is the names, and the fused ``attn.qkv`` projection
splits into ``to_q`` / ``to_k`` / ``to_v``:

  patch_embed.proj.*            -> encoder.patch_embed.proj.*
  enc_norm.*                    -> encoder.norm.*
  enc_blocks.{i}.*              -> encoder.blocks.layers.{i}.*
  decoder_embed.*               -> decoder.decoder_embed.*
  dec_blocks.{i}.*              -> decoder.layers.{i}.block1.*
  dec_blocks2.{i}.*             -> decoder.layers.{i}.block2.*
  dec_norm.*                    -> decoder.norm1.* and decoder.norm2.*
                                   (torch shares one final norm)
  downstream_head{n}.dpt.*      -> head{n}.dpt.* (the DPT rules below)

Inside a block (CroCo naming): ``attn.proj`` -> ``attn.to_out.0``,
``cross_attn.projq/projk/projv/proj`` -> ``cross_attn.to_q/to_k/to_v/to_out.0``,
and the decoder's norms norm1 (self-attention), norm2 (cross-attention:
``norm_cross``), norm3 (the MLP: ``norm2``) and norm_y (the memory:
``norm_context``).

Skipped, and reported: ``mask_token``, ``prediction_head``, the position
tables the port computes, and ``refinenet4.resConfUnit1`` of each DPT head
(the deepest fusion block never receives a skip input, so those weights are
dead in the torch forward too).  Any other key is refused, named.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import torch

# keys with no counterpart in the port's network
SKIP_PREFIXES = ("mask_token", "prediction_head", "enc_pos_embed", "dec_pos_embed")

# torch Sequential slots of the DPT head -> the port's named modules
DPT_RULES = [
    (r"(^|\.)act_postprocess\.0\.0\.", r"\1act_postprocess_0_proj."),
    (r"(^|\.)act_postprocess\.0\.1\.", r"\1act_postprocess_0_resample."),
    (r"(^|\.)act_postprocess\.1\.0\.", r"\1act_postprocess_1_proj."),
    (r"(^|\.)act_postprocess\.1\.1\.", r"\1act_postprocess_1_resample."),
    (r"(^|\.)act_postprocess\.2\.0\.", r"\1act_postprocess_2_proj."),
    (r"(^|\.)act_postprocess\.3\.0\.", r"\1act_postprocess_3_proj."),
    (r"(^|\.)act_postprocess\.3\.1\.", r"\1act_postprocess_3_resample."),
    (r"(^|\.)scratch\.layer(\d)_rn\.", r"\1layer\2_rn."),
    (r"(^|\.)scratch\.refinenet(\d)\.", r"\1refinenet\2."),
    (r"(^|\.)head\.0\.", r"\1head_0."),
    (r"(^|\.)head\.2\.", r"\1head_2."),
    (r"(^|\.)head\.4\.", r"\1head_4."),
]
DEAD_DPT_UNIT = "refinenet4.resConfUnit1."

_TOP = {
    "patch_embed.proj": ["encoder.patch_embed.proj"],
    "enc_norm": ["encoder.norm"],
    "decoder_embed": ["decoder.decoder_embed"],
    "dec_norm": ["decoder.norm1", "decoder.norm2"],
}
_BLOCK = re.compile(r"^(enc_blocks|dec_blocks|dec_blocks2)\.(\d+)\.(.*)$")
_HEAD = re.compile(r"^downstream_head(\d+)\.(?:dpt\.)?(.*)$")
_DEC_NORMS = {"norm1": "norm1", "norm2": "norm_cross", "norm3": "norm2",
              "norm_y": "norm_context"}
_PROJ = {"attn.proj": "attn.to_out.0", "cross_attn.projq": "cross_attn.to_q",
         "cross_attn.projk": "cross_attn.to_k", "cross_attn.projv": "cross_attn.to_v",
         "cross_attn.proj": "cross_attn.to_out.0", "mlp.fc1": "mlp.fc1", "mlp.fc2": "mlp.fc2"}


def rename_dpt_key(name: str) -> str:
    for pattern, repl in DPT_RULES:
        name = re.sub(pattern, repl, name)
    return name


def block_entries(sub: str, tensor: torch.Tensor, dec: bool) -> List[Tuple[str, torch.Tensor]]:
    """One key inside a CroCo block -> [(the port's key inside the block,
    tensor)]; the fused qkv splits in three.  Raises on a key no rule maps."""
    stem, leaf = sub.rsplit(".", 1)
    if stem == "attn.qkv":
        return [(f"attn.to_{n}.{leaf}", t.clone()) for n, t in zip("qkv", tensor.chunk(3, 0))]
    norms = _DEC_NORMS if dec else {"norm1": "norm1", "norm2": "norm2"}
    if stem in norms:
        return [(f"{norms[stem]}.{leaf}", tensor)]
    if stem in _PROJ:
        return [(f"{_PROJ[stem]}.{leaf}", tensor)]
    raise KeyError(f"unrecognized block key: {sub}")


def convert_dust3r_checkpoint(
        state_dict: Mapping[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A DUSt3R (two-view, DPT heads) state dict -> (the port's
    ``Dust3RNetwork`` state dict, the source keys skipped).  Raises
    ``KeyError`` naming every source key no rule maps."""
    out: Dict[str, torch.Tensor] = {}
    skipped, unknown = [], []
    for name, tensor in state_dict.items():
        if name.startswith(SKIP_PREFIXES):
            skipped.append(name)
            continue
        stem, _, leaf = name.rpartition(".")
        if stem in _TOP:
            for port in _TOP[stem]:
                out[f"{port}.{leaf}"] = tensor
            continue
        m = _BLOCK.match(name)
        if m:
            which, idx, sub = m.groups()
            root = {"enc_blocks": f"encoder.blocks.layers.{idx}",
                    "dec_blocks": f"decoder.layers.{idx}.block1",
                    "dec_blocks2": f"decoder.layers.{idx}.block2"}[which]
            try:
                entries = block_entries(sub, tensor, dec=which != "enc_blocks")
            except KeyError:
                unknown.append(name)
                continue
            for key, t in entries:
                out[f"{root}.{key}"] = t
            continue
        m = _HEAD.match(name)
        if m:
            if DEAD_DPT_UNIT in m.group(2):
                skipped.append(name)
                continue
            out[f"head{m.group(1)}.dpt.{rename_dpt_key(m.group(2))}"] = tensor
            continue
        unknown.append(name)
    if unknown:
        raise KeyError(f"{len(unknown)} unrecognized DUSt3R keys: {unknown[:10]}")
    return out, skipped
