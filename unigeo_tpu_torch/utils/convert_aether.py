"""CogVideoX-lineage checkpoints (the public Aether release: a
``CogVideoXTransformer3DModel`` DiT and an ``AutoencoderKLCogVideoX``) ->
the port's Aether checkpoint {"vae", "dit"}, the counterpart of
``unigeo_tpu/utils/convert_aether.py``.

Both sides are torch: Conv2d / Conv3d / Linear tensors keep their layouts,
and the names change.

  DiT  patch_embed.proj               -> patchify
       time_embedding.linear_{1,2}    -> t_embed{1,2}
       transformer_blocks.{i}.attn1.to_{q,k,v}, .to_out.0
                                      -> stack.blocks.{i}.attn.to_{q,k,v}, .to_out.0
       transformer_blocks.{i}.ff.net.0.proj, .ff.net.2
                                      -> stack.blocks.{i}.mlp.fc1, .fc2
       transformer_blocks.{i}.norm1.linear ++ .norm2.linear
                                      -> stack.blocks.{i}.adaLN_modulation: the
           first 3 C rows of each (the hidden stream's shift, scale, gate;
           CogVideoX's LayerNormZero emits 6 C, the text stream's 3 C that
           Aether drops), C read off attn1.to_q
       norm_out.linear                -> final_modulation
       proj_out                       -> final_proj
  VAE  encoder.conv_in.conv           -> encoder.stem.conv
       encoder.down_blocks.{i}.resnets.0 -> encoder.enc_res{i}
       encoder.down_blocks.{i}.downsamplers.0.conv[.conv]
                                      -> encoder.enc_down{i}.conv
       {encoder,decoder}.mid_block.resnets.0 -> encoder.enc_mid / decoder.dec_mid
       encoder.norm_out / conv_out.conv -> encoder.enc_norm / enc_out.conv
       decoder.conv_in.conv           -> decoder.dec_in.conv
       decoder.up_blocks.{k}.resnets.0, .upsamplers.0.conv[.conv]
                                      -> decoder.dec_res{S-1-k}, .dec_up{S-1-k}.conv
           (torch's up blocks run deepest first; the port names a stage by
           its encoder index)
       decoder.norm_out / conv_out.conv -> decoder.dec_norm / dec_out.conv
       a resnet's conv_shortcut (1 x 1 x 1 Conv3d [out, in, 1, 1, 1])
                                      -> its skip (Linear [out, in])

Keys of the lineage with no counterpart here (the text stream's q / k
norms, the LayerNormZero norms, resnets past the first of a stage, quant
convs, spatial norms) are skipped and reported, as the JAX converter skips
them; a key outside the two models' roots is refused, named.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple

import torch

DIT_ROOTS = ("patch_embed.", "time_embedding.", "transformer_blocks.", "norm_final.",
             "norm_out.", "proj_out.", "ofs_embedding.")
VAE_ROOTS = ("encoder.", "decoder.", "quant_conv.", "post_quant_conv.")

_DIT_TOP = {"patch_embed.proj": "patchify", "time_embedding.linear_1": "t_embed1",
            "time_embedding.linear_2": "t_embed2", "norm_out.linear": "final_modulation",
            "proj_out": "final_proj"}
_DIT_BLOCK = {"attn1.to_q": "attn.to_q", "attn1.to_k": "attn.to_k", "attn1.to_v": "attn.to_v",
              "attn1.to_out.0": "attn.to_out.0", "ff.net.0.proj": "mlp.fc1",
              "ff.net.2": "mlp.fc2"}


def _refuse(unknown: List[str], what: str) -> None:
    if unknown:
        raise KeyError(f"{len(unknown)} keys outside the {what}'s roots: {unknown[:10]}")


def convert_cogvideox_transformer(
        state_dict: Mapping[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """The DiT's state dict -> (the port's ``AetherDiT`` state dict, the
    source keys skipped)."""
    out: Dict[str, torch.Tensor] = {}
    skipped, unknown = [], []
    adaln: Dict[Tuple[str, str, str], torch.Tensor] = {}
    blk = re.compile(r"^transformer_blocks\.(\d+)\.(.*)\.(weight|bias)$")
    for name, t in state_dict.items():
        if not name.startswith(DIT_ROOTS):
            unknown.append(name)
            continue
        stem, _, leaf = name.rpartition(".")
        m = blk.match(name)
        if stem in _DIT_TOP:
            out[f"{_DIT_TOP[stem]}.{leaf}"] = t
        elif m and m.group(2) in _DIT_BLOCK:
            out[f"stack.blocks.{m.group(1)}.{_DIT_BLOCK[m.group(2)]}.{leaf}"] = t
        elif m and m.group(2) in ("norm1.linear", "norm2.linear"):
            adaln[(m.group(1), m.group(2), leaf)] = t
        else:
            skipped.append(name)
    _refuse(unknown, "DiT")
    width = next((t.shape[1] for n, t in state_dict.items()
                  if re.match(r"^transformer_blocks\.\d+\.attn1\.to_q\.weight$", n)), None)
    for (i, norm, leaf), t in adaln.items():
        other = adaln.get((i, "norm2.linear", leaf))
        if norm == "norm1.linear" and other is not None and width is not None:
            out[f"stack.blocks.{i}.adaLN_modulation.{leaf}"] = torch.cat(
                [t[:3 * width], other[:3 * width]], dim=0)
    return out, skipped


_RES = {"norm1": "norm1", "norm2": "norm2", "conv1.conv": "conv1.conv",
        "conv2.conv": "conv2.conv", "conv_shortcut.conv": "skip", "conv_shortcut": "skip"}


def _res_entry(sub: str, t: torch.Tensor) -> Optional[Tuple[str, torch.Tensor]]:
    """A key inside a CogVideoX resnet -> (the port's key inside the block,
    tensor), or None where the port has no counterpart."""
    stem, _, leaf = sub.rpartition(".")
    if stem not in _RES or leaf not in ("weight", "bias"):
        return None
    if _RES[stem] == "skip" and leaf == "weight":
        t = t.reshape(t.shape[0], t.shape[1])  # Conv3d 1x1x1 -> Linear
    return f"{_RES[stem]}.{leaf}", t


def convert_cogvideox_vae(state_dict: Mapping[str, torch.Tensor],
                          num_stages: Optional[int] = None
                          ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """The 3D VAE's state dict -> (the port's ``CausalVAE3D`` state dict, the
    source keys skipped).  ``num_stages`` (default: one more than the largest
    stage index seen) fixes the decoder's reversed stage order."""
    if num_stages is None:
        idxs = [int(m.group(2)) for m in
                (re.match(r"^(encoder\.down|decoder\.up)_blocks\.(\d+)\.", n)
                 for n in state_dict) if m]
        num_stages = max(idxs) + 1 if idxs else 0
    top = {"encoder.conv_in.conv": "encoder.stem.conv",
           "encoder.conv_out.conv": "encoder.enc_out.conv",
           "decoder.conv_in.conv": "decoder.dec_in.conv",
           "decoder.conv_out.conv": "decoder.dec_out.conv",
           "encoder.norm_out": "encoder.enc_norm", "decoder.norm_out": "decoder.dec_norm"}
    mid = re.compile(r"^(encoder|decoder)\.mid_block\.resnets\.0\.(.*)$")
    down = re.compile(r"^encoder\.down_blocks\.(\d+)\.(.*)$")
    up = re.compile(r"^decoder\.up_blocks\.(\d+)\.(.*)$")
    sampler = re.compile(r"^(?:down|up)samplers\.0\.conv(?:\.conv)?\.(weight|bias)$")
    out: Dict[str, torch.Tensor] = {}
    skipped, unknown = [], []
    for name, t in state_dict.items():
        if not name.startswith(VAE_ROOTS):
            unknown.append(name)
            continue
        stem, _, leaf = name.rpartition(".")
        key = None
        if stem in top and leaf in ("weight", "bias"):
            key = f"{top[stem]}.{leaf}"
        elif m := mid.match(name):
            block = "encoder.enc_mid" if m.group(1) == "encoder" else "decoder.dec_mid"
            entry = _res_entry(m.group(2), t)
            if entry:
                key, t = f"{block}.{entry[0]}", entry[1]
        elif (m := down.match(name)) or (m := up.match(name)):
            side = "encoder" if name.startswith("encoder") else "decoder"
            i = int(m.group(1)) if side == "encoder" else num_stages - 1 - int(m.group(1))
            res, samp = ("enc_res", "enc_down") if side == "encoder" else ("dec_res", "dec_up")
            sub = m.group(2)
            s = sampler.match(sub)
            if s:
                key = f"{side}.{samp}{i}.conv.{s.group(1)}"
            elif sub.startswith("resnets.0."):
                entry = _res_entry(sub[len("resnets.0."):], t)
                if entry:
                    key, t = f"{side}.{res}{i}.{entry[0]}", entry[1]
        if key is None:
            skipped.append(name)
        else:
            out[key] = t
    _refuse(unknown, "VAE")
    return out, skipped


def convert_aether_checkpoint(transformer_sd: Optional[Mapping[str, torch.Tensor]] = None,
                              vae_sd: Optional[Mapping[str, torch.Tensor]] = None):
    """Either or both state dicts -> ({"dit": ..., "vae": ...} with the
    components given, the source keys skipped)."""
    params, skipped = {}, []
    if transformer_sd:
        params["dit"], s = convert_cogvideox_transformer(transformer_sd)
        skipped += s
    if vae_sd:
        params["vae"], s = convert_cogvideox_vae(vae_sd)
        skipped += s
    return params, skipped
