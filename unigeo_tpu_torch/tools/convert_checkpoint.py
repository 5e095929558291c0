"""Upstream checkpoints -> the port's checkpoint layouts.

    python -m unigeo_tpu_torch.tools.convert_checkpoint \
        --unet FILE|DIR --vae FILE|DIR --clip FILE|DIR --out FILE \
        [--network-config JSON] [--allow-partial]
    python -m unigeo_tpu_torch.tools.convert_checkpoint --family dust3r \
        --ckpt FILE --out FILE [--network-config JSON]
    python -m unigeo_tpu_torch.tools.convert_checkpoint --family vda \
        --ckpt FILE --out FILE [--network-config JSON] [--head-prefix depth_head.]
    python -m unigeo_tpu_torch.tools.convert_checkpoint --family aether \
        --transformer FILE|DIR --vae FILE|DIR --out FILE [--network-config JSON]

Counterpart of ``tools/convert_checkpoint.py``'s four families.  Inputs are
``.safetensors``, or ``.pt`` / ``.pth`` / ``.bin`` read with
``weights_only=True``; a directory merges every shard in it; state dicts
nested under ``model`` / ``state_dict`` and ``module.`` prefixes are
unwrapped.  Each family's result is checked key by key and shape by shape
against the port's modules, built on the meta device at the widths of
``--network-config``; the check is two-sided (no module key without a
tensor, no tensor without a module key) and refuses a partial conversion,
naming the keys.  With ``--allow-partial`` it reports one instead, as the
JAX tool does: the module keys without a tensor (or with one of another
shape) are written as ZEROS and the unconsumed tensors dropped, so the
file is for inspection or re-grafting by hand, not for loading as it is.

* ``svd`` (the default): a diffusers ``UNetSpatioTemporalConditionModel``,
  ``AutoencoderKLTemporalDecoder`` and transformers
  ``CLIPVisionModelWithProjection`` -> the {"unet", "vae", "clip"}
  checkpoint that ``DepthCrafter(checkpoint_path=...)`` and the other
  SVD-family adapters load.  The port keeps the upstream key names, so
  nothing is renamed or transposed; ``position_ids`` buffers that older
  transformers versions saved are dropped and reported.  ``--network-config``:
  ``unet_config`` / ``vae_config`` / ``clip_config``, SVD-XT's where absent.
* ``dust3r``: a two-view DUSt3R with DPT heads -> the ``Dust3RNetwork``
  state dict ``Dust3R(checkpoint_path=...)`` loads
  (``utils/convert_dust3r.py``); ``--network-config`` the network's keywords
  over DUSt3R_ViTLarge_BaseDecoder_512_dpt's.
* ``vda``: VideoDepthAnything (or DepthAnything with ``--head-prefix
  depth_head.``) -> the ``VDANetwork`` state dict
  ``VideoDepthAnything(checkpoint_path=...)`` loads (``utils/convert_vda.py``);
  ``--network-config`` the network's keywords.
* ``aether``: the CogVideoX-lineage DiT and 3D VAE -> the {"vae", "dit"}
  checkpoint ``Aether(checkpoint_path=...)`` loads
  (``utils/convert_aether.py``); ``--network-config``: ``vae_config`` /
  ``network_config``.  Both components are needed.

The keys a family's rules skip (no counterpart in the port) are printed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Mapping, Optional

import torch

COMPONENTS = ("unet", "vae", "clip")
# saved by older transformers versions, a buffer the port computes
SKIPPED_SUFFIXES = ("position_ids",)


def _load_one(path: str) -> Dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        obj = load_file(path, device="cpu")
    else:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A file, or a directory's shards merged, with ``module.`` stripped."""
    if os.path.isdir(path):
        shards = [n for n in sorted(os.listdir(path))
                  if n.endswith((".safetensors", ".bin", ".pth", ".pt"))]
        if not shards:
            raise FileNotFoundError(f"no checkpoint shards in {path}")
        sd = {}
        for n in shards:
            sd.update(_load_one(os.path.join(path, n)))
    else:
        sd = _load_one(path)
    return {k.removeprefix("module."): v for k, v in sd.items()}


def port_modules(network_config: Optional[Mapping] = None):
    """The port's UNet, VAE and CLIP on the meta device (no memory) at the
    config's widths, in COMPONENTS order."""
    from unigeo_tpu_torch.models.depthcrafter.unet import UNetSpatioTemporal
    from unigeo_tpu_torch.models.depthcrafter.vae import AutoencoderKLTemporal
    from unigeo_tpu_torch.models.vit import ClipImageEmbedder

    cfg = dict(network_config or {})
    with torch.device("meta"):
        return (UNetSpatioTemporal(**(cfg.get("unet_config") or {})),
                AutoencoderKLTemporal(**(cfg.get("vae_config") or {})),
                ClipImageEmbedder(**(cfg.get("clip_config") or {})))


def check_component(name: str, module: torch.nn.Module,
                    state_dict: Mapping[str, torch.Tensor],
                    allow_partial: bool = False) -> Dict[str, torch.Tensor]:
    """``state_dict`` less the skipped buffers, once every key and shape
    matches ``module``'s; raises naming what differs.  With
    ``allow_partial`` it reports what differs on stderr instead and returns
    the matched tensors, ZEROS for the module keys without a tensor of
    their shape, and no unconsumed tensor."""
    skipped = sorted(k for k in state_dict if k.endswith(SKIPPED_SUFFIXES))
    sd = {k: v for k, v in state_dict.items() if k not in skipped}
    own_sd = module.state_dict()
    own = {k: tuple(v.shape) for k, v in own_sd.items()}
    missing = sorted(set(own) - set(sd))
    orphans = sorted(set(sd) - set(own))
    shapes = sorted(k for k in set(own) & set(sd) if tuple(sd[k].shape) != own[k])
    print(f"{name}: {len(own) - len(missing)} of {len(own)} module keys matched, "
          f"{len(orphans)} unconsumed tensors, {len(shapes)} of another shape"
          + (f", skipped {skipped}" if skipped else ""), flush=True)
    if not (missing or orphans or shapes):
        return sd
    report = (f"missing {missing[:10]}, unconsumed {orphans[:10]}, "
              f"shapes {[(k, tuple(sd[k].shape), own[k]) for k in shapes[:10]]}")
    if not allow_partial:
        raise SystemExit(f"{name}: conversion incomplete: {report} (pass --allow-partial "
                         "to write it anyway)")
    print(f"{name}: partial conversion: {report}", file=sys.stderr)
    print(f"WARNING: --allow-partial writes {len(missing) + len(shapes)} unmatched module "
          f"keys of {name} as ZEROS (not random init) and drops {len(orphans)} unconsumed "
          "tensors: the file is for inspection or manual re-grafting, loading it as it "
          "is gives degenerate outputs", file=sys.stderr, flush=True)
    out = {k: sd[k] for k in own if k in sd and k not in shapes}
    out.update({k: torch.zeros(own[k], dtype=own_sd[k].dtype) for k in [*missing, *shapes]})
    return out


def convert_svd(unet_sd, vae_sd, clip_sd, network_config: Optional[Mapping] = None,
                allow_partial: bool = False):
    """The three upstream state dicts -> the port's checkpoint, checked."""
    return {name: check_component(name, module, sd, allow_partial) for name, module, sd in
            zip(COMPONENTS, port_modules(network_config), (unet_sd, vae_sd, clip_sd))}


# the released DUSt3R_ViTLarge_BaseDecoder_512_dpt architecture
DUST3R_512_DPT_CONFIG = dict(enc_width=1024, enc_depth=24, enc_heads=16, dec_width=768,
                             dec_depth=12, dec_heads=12, patch_size=16, head_type="dpt",
                             pos_embed="RoPE100", qkv_bias=True, norm_context=True)


def _report_skipped(skipped) -> None:
    if skipped:
        print(f"skipped {len(skipped)} source keys with no counterpart: {skipped[:10]}",
              flush=True)


def _converted(convert, *args, **kwargs):
    """``convert``'s (params, skipped), its refusal of unknown keys as a
    SystemExit naming them."""
    try:
        params, skipped = convert(*args, **kwargs)
    except KeyError as exc:
        raise SystemExit(f"conversion refused: {exc.args[0]}") from None
    _report_skipped(skipped)
    return params


def convert_dust3r(state_dict, network_config: Optional[Mapping] = None,
                   allow_partial: bool = False):
    """A DUSt3R state dict -> the ``Dust3RNetwork`` state dict, checked."""
    from unigeo_tpu_torch.models.pointmap.dust3r import Dust3RNetwork
    from unigeo_tpu_torch.utils.convert_dust3r import convert_dust3r_checkpoint

    with torch.device("meta"):
        net = Dust3RNetwork(**{**DUST3R_512_DPT_CONFIG, **(network_config or {})})
    return check_component("dust3r", net, _converted(convert_dust3r_checkpoint, state_dict),
                           allow_partial)


def convert_vda(state_dict, network_config: Optional[Mapping] = None,
                head_prefix: str = "head.", allow_partial: bool = False):
    """A VideoDepthAnything state dict -> the ``VDANetwork`` state dict, checked."""
    from unigeo_tpu_torch.models.vda import VDANetwork
    from unigeo_tpu_torch.utils.convert_vda import convert_vda_checkpoint

    with torch.device("meta"):
        net = VDANetwork(**(network_config or {}))
    return check_component("vda", net, _converted(convert_vda_checkpoint, state_dict,
                                                  head_prefix=head_prefix), allow_partial)


def convert_aether(transformer_sd, vae_sd, network_config: Optional[Mapping] = None,
                   allow_partial: bool = False):
    """The DiT's and the VAE's state dicts -> the {"vae", "dit"} checkpoint,
    each component checked."""
    from unigeo_tpu_torch.models.aether import AetherNetwork, CausalVAE3D
    from unigeo_tpu_torch.utils.convert_aether import convert_aether_checkpoint

    cfg = dict(network_config or {})
    with torch.device("meta"):
        vae = CausalVAE3D(**(cfg.get("vae_config") or {}))
        dit = AetherNetwork(vae_config=cfg.get("vae_config"),
                            network_config=cfg.get("network_config")).dit
    params = _converted(convert_aether_checkpoint, transformer_sd, vae_sd)
    return {"vae": check_component("vae", vae, params["vae"], allow_partial),
            "dit": check_component("dit", dit, params["dit"], allow_partial)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--family", choices=("svd", "dust3r", "vda", "aether"), default="svd")
    for name in COMPONENTS:
        parser.add_argument(f"--{name}", help=f"svd: the {name}'s state dict"
                            + (" (aether: the 3D VAE's)" if name == "vae" else ""))
    parser.add_argument("--ckpt", help="dust3r / vda: the checkpoint")
    parser.add_argument("--transformer", help="aether: the DiT's state dict")
    parser.add_argument("--head-prefix", default="head.",
                        help="vda: 'depth_head.' for plain DepthAnything")
    parser.add_argument("--out", required=True, help="the checkpoint file to write")
    parser.add_argument("--network-config", default=None,
                        help="JSON: the family's configs (see above)")
    parser.add_argument("--allow-partial", action="store_true",
                        help="report a partial conversion and write it (unmatched "
                             "module keys as zeros) instead of refusing it")
    args = parser.parse_args(argv)
    needs = {"svd": COMPONENTS, "dust3r": ("ckpt",), "vda": ("ckpt",),
             "aether": ("transformer", "vae")}[args.family]
    absent = [f"--{n}" for n in needs if not getattr(args, n)]
    if absent:
        parser.error(f"{args.family} needs {' '.join(absent)}")

    from unigeo_tpu_torch.utils.checkpoint import save_params

    cfg = json.loads(args.network_config) if args.network_config else None
    sds = [load_state_dict(getattr(args, n)) for n in needs]
    partial = args.allow_partial
    if args.family == "svd":
        params = convert_svd(*sds, cfg, allow_partial=partial)
    elif args.family == "dust3r":
        params = convert_dust3r(*sds, cfg, allow_partial=partial)
    elif args.family == "vda":
        params = convert_vda(*sds, cfg, head_prefix=args.head_prefix, allow_partial=partial)
    else:
        params = convert_aether(*sds, cfg, allow_partial=partial)
    save_params(params, args.out)
    tensors = [v for v in params.values()] if args.family in ("dust3r", "vda") else [
        v for sd in params.values() for v in sd.values()]
    n = sum(v.numel() for v in tensors)
    print(f"wrote {args.out}: {n / 1e9:.3f} B parameters", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
