"""Time three ways of computing the Aether decoder's upsampling convolution
side by side: conv3x3x3(nearest_up2_spatial(x)) with the causal temporal pad
(kt - 1 copies of frame 0), on [T, C, H, W] in f32 with TF32 off.

  plain       the causal pad, ``F.interpolate`` (nearest x2), ``F.conv3d``
              on the upsampled input: 9 products a tap per output pixel.
  transposed  one ``F.conv_transpose3d`` at spatial stride 2 on the input
              as it is, its 4x4 kernel the 3x3 taps summed over each 2x2
              window and flipped (the JAX package's lhs-dilated form): 4
              products per output pixel, on cuDNN's dgrad engine.
  subpixel    one ``F.conv3d`` on the input as it is, its kernel 2x2 over
              4 x C_out channels (one 2x2 kernel per output phase, the
              3x3 taps summed per phase), then the phases interleaved into
              the 2x output: 4 products per output pixel, on the forward
              engines.  This is the port's decoder
              (``models/aether.py::upsample2x_conv3d``).

The three are equal in exact arithmetic.  At the decoder's shapes of
``configs/aether_scannetpp.yaml`` (a 16-frame clip at 384 x 512: 4 latent
frames of 48 x 64, base width 64, mults (1, 2, 4), temporal down (F, T, T))
each runs once to be held against ``plain`` (max abs error over the
reference's largest magnitude), then is timed two ways: CUDA events around
``--iters`` back-to-back calls (``ms``) and its kernels' device time from
torch.profiler (``device_ms``), with the products it performs and the rate
they give.  It prints one JSON object with the card's name and power limit:

    python -m unigeo_tpu_torch.tools.upsample_variants [--iters 5]

``--device cpu --small`` runs the check alone at a small shape on the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

KT = 3


def causal_pad(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([x[:1].expand(n, *x.shape[1:]), x]) if n else x


def plain(x, w, b):
    x = F.interpolate(causal_pad(x, KT - 1), scale_factor=2, mode="nearest")
    return F.conv3d(x.transpose(0, 1)[None], w, b, padding=(0, 1, 1))[0].transpose(0, 1)


def transposed(x, w, b):
    kp = w.new_zeros(*w.shape[:3], 4, 4)
    for u in range(2):
        for v in range(2):
            kp[..., u:u + 3, v:v + 3] += w
    wt = kp.flip(-3, -2, -1).transpose(0, 1)
    y = F.conv_transpose3d(causal_pad(x, KT - 1).transpose(0, 1)[None], wt, b,
                           stride=(1, 2, 2), padding=(KT - 1, 1, 1))
    return y[0].transpose(0, 1)


def subpixel(x, w, b):
    from unigeo_tpu_torch.models.aether import upsample2x_conv3d

    return upsample2x_conv3d(causal_pad(x, KT - 1).transpose(0, 1)[None], w, b)


VARIANTS = {"plain": plain, "transposed": transposed, "subpixel": subpixel}


def decoder_shapes(frames: int = 16, h: int = 384, w: int = 512, base: int = 64,
                   mults=(1, 2, 4), temporal_down=(False, True, True),
                   ct: int = 4) -> List[Tuple[str, int, int, int, int, int]]:
    """(name, T, C_in, C_out, h, w) of each upsampling conv's input."""
    cs = 2 ** len(mults)
    t, hh, ww = -(-frames // ct), h // cs, w // cs
    c = base * mults[-1]
    shapes = []
    for i in reversed(range(len(mults))):
        if temporal_down[i]:
            t *= 2
        shapes.append((f"dec_up{i}", t, c, base * mults[i], hh, ww))
        c, hh, ww = base * mults[i], 2 * hh, 2 * ww
    return shapes


def products(name: str, t: int, cin: int, cout: int, h: int, w: int) -> float:
    """Multiply-adds x 2 each variant performs."""
    taps = 9 if name == "plain" else 4
    return 2.0 * t * 4 * h * w * cout * cin * KT * taps


def main(argv: Optional[List[str]] = None) -> Dict:
    from unigeo_tpu_torch.device import set_exact_f32

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="one small shape, the check only")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("upsample_variants needs an NVIDIA GPU unless --device cpu")
    set_exact_f32()
    shapes = [("small", 4, 6, 5, 7, 9)] if args.small else decoder_shapes()
    result: Dict = {"shapes": {}}
    if dev.type == "cuda":
        result["device"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, t, cin, cout, h, w in shapes:
        x = torch.randn((t, cin, h, w), generator=gen, device=dev)
        wt = torch.randn((cout, cin, KT, 3, 3), generator=gen, device=dev) * (cin * 27) ** -0.5
        bias = torch.randn((cout,), generator=gen, device=dev)
        with torch.no_grad():
            ref = plain(x, wt, bias)
            row = {"t": t, "cin": cin, "cout": cout, "h": h, "w": w}
            for var, fn in VARIANTS.items():
                out = fn(x, wt, bias)
                entry = {"rel_dev": ((out - ref).abs().max() / ref.abs().max()).item()}
                del out
                if dev.type == "cuda" and not args.small:
                    from unigeo_tpu_torch.tools.forward_variants import (
                        events_ms, profile_device_ms)

                    call = lambda: fn(x, wt, bias)
                    entry["ms"] = events_ms(call, args.iters)
                    entry["device_ms"] = profile_device_ms(call, args.iters)
                    entry["tflop"] = products(var, t, cin, cout, h, w) / 1e12
                    entry["tflop_per_s"] = entry["tflop"] / entry["device_ms"] * 1e3
                    torch.cuda.empty_cache()
                row[var] = entry
        result["shapes"][name] = row
        del x, ref
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
