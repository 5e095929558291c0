"""Upstream SVD checkpoints -> the port's checkpoint layout.

    python -m unigeo_tpu_torch.tools.convert_checkpoint \
        --unet FILE|DIR --vae FILE|DIR --clip FILE|DIR --out FILE \
        [--network-config JSON]

Counterpart of ``tools/convert_checkpoint.py``'s ``svd`` family: reads a
diffusers-layout ``UNetSpatioTemporalConditionModel`` and
``AutoencoderKLTemporalDecoder`` state dict and a transformers
``CLIPVisionModelWithProjection`` one (``.safetensors``, or ``.pt`` /
``.pth`` / ``.bin`` read with ``weights_only=True``; a directory merges
every shard in it; state dicts nested under ``model`` / ``state_dict`` and
``module.`` prefixes are unwrapped), checks every key name and shape
against the port's modules, built on the meta device at the widths of
``--network-config`` (a JSON object with ``unet_config`` / ``vae_config`` /
``clip_config``, the default SVD-XT ones where absent), and writes the
{"unet", "vae", "clip"} checkpoint that ``DepthCrafter(checkpoint_path=...)``
and the other SVD-family adapters load.  The port keeps the upstream key
names, so nothing is renamed or transposed; the check is two-sided (no
module key without a tensor, no tensor without a module key) and refuses a
partial conversion, naming the keys.  ``position_ids`` buffers that older
transformers versions saved are dropped and reported.
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
                    state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``state_dict`` less the skipped buffers, once every key and shape
    matches ``module``'s; raises naming what differs."""
    skipped = sorted(k for k in state_dict if k.endswith(SKIPPED_SUFFIXES))
    sd = {k: v for k, v in state_dict.items() if k not in skipped}
    own = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    missing = sorted(set(own) - set(sd))
    orphans = sorted(set(sd) - set(own))
    shapes = sorted(k for k in set(own) & set(sd) if tuple(sd[k].shape) != own[k])
    print(f"{name}: {len(own) - len(missing)} of {len(own)} module keys matched, "
          f"{len(orphans)} unconsumed tensors, {len(shapes)} of another shape"
          + (f", skipped {skipped}" if skipped else ""), flush=True)
    if missing or orphans or shapes:
        raise SystemExit(
            f"{name}: conversion incomplete: missing {missing[:10]}, unconsumed "
            f"{orphans[:10]}, shapes {[(k, tuple(sd[k].shape), own[k]) for k in shapes[:10]]}")
    return sd


def convert_svd(unet_sd, vae_sd, clip_sd, network_config: Optional[Mapping] = None):
    """The three upstream state dicts -> the port's checkpoint, checked."""
    return {name: check_component(name, module, sd) for name, module, sd in
            zip(COMPONENTS, port_modules(network_config), (unet_sd, vae_sd, clip_sd))}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for name in COMPONENTS:
        parser.add_argument(f"--{name}", required=True, help=f"the {name}'s state dict")
    parser.add_argument("--out", required=True, help="the checkpoint file to write")
    parser.add_argument("--network-config", default=None,
                        help="JSON with unet_config / vae_config / clip_config")
    args = parser.parse_args(argv)

    from unigeo_tpu_torch.utils.checkpoint import save_params

    cfg = json.loads(args.network_config) if args.network_config else None
    params = convert_svd(*(load_state_dict(getattr(args, n)) for n in COMPONENTS), cfg)
    save_params(params, args.out)
    n = sum(v.numel() for sd in params.values() for v in sd.values())
    print(f"wrote {args.out}: {n / 1e9:.3f} B parameters", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
