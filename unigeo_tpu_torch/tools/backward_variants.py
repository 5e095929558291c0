"""Time variants of the f32 flash backward pair at d = 64 side by side.

Each variant is the kernel sources with textual edits (``VARIANTS``: name ->
[(file, anchor, replacement)]), built by ``forward_variants.build_variants``
into a temporary directory, all builds in parallel; ``built`` is the
sources as they are, ``earlier_d64`` the earlier CUDA-core body
(``bwd_{dq,dkv}_f32_kernel<16>``) at d = 64, the others the register-tiled
bodies' plan choices: block rows (8 warps, 128 rows a block), ring depth,
the loops' unrolling, and the cluster split (off; doubled until the items fill both block slots
of every SM; or the split with the fewest rounds of tiles at every shape).  Each library's dq and dk/dv kernels run at the f32
training paths' shapes ``SHAPES`` (chip_smoke.py's F32_BWD_SHAPES) in f32,
TF32 off, from the plain forward's out and lse, held elementwise against
the plain version under ``grad_error_limits``, and timed two ways: CUDA
events around ``ITERS`` back-to-back calls (``ms``) and the kernel's own
device time from torch.profiler (``device_ms``), with the kernel's name
and SDPA's f32 backward beside them:

    python -m unigeo_tpu_torch.tools.backward_variants [--variants a,b,...]

It prints one JSON object: per variant and shape the dq and dk/dv kernels'
``ms``, ``device_ms`` and ``kernel``, the pair's sums, ``max_err_over_limit``
over dq, dk and dv; per shape SDPA's ``library_ms``; and the card's name.
It needs the card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import re
import tempfile
from typing import List, Optional

import numpy as np
import torch

_SRC = "flash_attention_bwd.cu"
_SHAPE = "constexpr int kBwdWarps = 4, kBwdStages = 2;"
_UNROLL = "constexpr int kBwdUnrollD = 8, kBwdUnrollK = 16;"
_SPLIT = "  while (split < 8 && items * split < sms && 2 * split <= n_tiles) split *= 2;"
VARIANTS = {
    "built": [],
    # the earlier CUDA-core body (bwd_{dq,dkv}_f32_kernel<16>) at d = 64
    "earlier_d64": [(_SRC, "    if (a.D == kBwdD) return launch_f32_d64(a, dkv);",
                     "    if (false) return launch_f32_d64(a, dkv);")],
    # block rows (eight warps, one block an SM) and ring depth (one block an SM)
    "warps8": [(_SRC, _SHAPE, "constexpr int kBwdWarps = 8, kBwdStages = 2;")],
    "stages3": [(_SRC, _SHAPE, "constexpr int kBwdWarps = 4, kBwdStages = 3;")],
    # the cluster split: never, or until the items fill both block slots of an SM
    "nosplit": [(_SRC, _SPLIT, "")],
    "split_slots": [(_SRC, _SPLIT,
                     _SPLIT.replace("items * split < sms", "items * split < 2 * sms"))],
    # the products' loops unrolled by half or whole, the updates' by half or
    # whole
    "unroll_d4": [(_SRC, _UNROLL, "constexpr int kBwdUnrollD = 4, kBwdUnrollK = 16;")],
    "unroll_d16": [(_SRC, _UNROLL, "constexpr int kBwdUnrollD = 16, kBwdUnrollK = 16;")],
    "unroll_k8": [(_SRC, _UNROLL, "constexpr int kBwdUnrollD = 8, kBwdUnrollK = 8;")],
    "unroll_k64": [(_SRC, _UNROLL, "constexpr int kBwdUnrollD = 8, kBwdUnrollK = 64;")],
    # the split with the fewest rounds of tiles over both block slots of
    # every SM, at every shape (Aether's 576 blocks fill 2.18 rounds)
    "split_waves": [(_SRC, _SPLIT,
                     "  for (int s = 1, best = -1; s <= 8 && s <= n_tiles; s *= 2) {\n"
                     "    const int64_t cost = (items * s + 2 * sms - 1) / (2 * sms) *\n"
                     "                         ((n_tiles + s - 1) / s);\n"
                     "    if (best < 0 || cost < best) best = (int)cost, split = s;\n"
                     "  }")],
}
# (name, B, Sq, Sk, H): the f32 training paths at 384 x 512 (chip_smoke.py's
# F32_BWD_SHAPES): Aether's DiT, Spann3R's encoder, Dust3R's encoder and
# decoder over its 16-frame training clip, VideoDepthAnything's encoder,
# the decoders' single frame, Cut3R's frame-to-state cross-attention
SHAPES = [("aether_dit", 1, 3072, 3072, 12), ("spann3r_encoder", 20, 768, 768, 12),
          ("dust3r_encoder", 16, 768, 768, 16), ("dust3r_decoder", 15, 768, 768, 12),
          ("vda_encoder", 25, 972, 972, 16), ("pointmap_decoder", 1, 768, 768, 8),
          ("cut3r_state_cross", 1, 768, 64, 8)]
D = 64
ITERS = 10


def _profiled(fn, part: str):
    """(name, mean device ms per launch) of the one kernel whose name holds
    ``part`` that ITERS calls of ``fn`` launched."""
    from unigeo_tpu_torch.tools.forward_variants import _profiled_kernels

    found = [e for e in _profiled_kernels(fn, ITERS) if part in e.key]
    if len(found) != 1:
        raise RuntimeError(f"{ITERS} calls launched {[(e.key, e.count) for e in found]}")
    return found[0].key, found[0].self_device_time_total / 1e3 / found[0].count


def main(argv: Optional[List[str]] = None) -> dict:
    import torch.nn.functional as F

    from unigeo_tpu_torch.device import set_exact_f32
    from unigeo_tpu_torch.ops import attention
    from unigeo_tpu_torch.ops.attention import (
        _delta,
        attention_bwd_reference,
        attention_fwd_lse_reference,
        grad_error_limits,
    )
    from unigeo_tpu_torch.tools.forward_variants import build_variants, events_ms, profile_device_ms

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=None, help="comma-separated names from VARIANTS")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("backward_variants needs an NVIDIA GPU")
    names = args.variants.split(",") if args.variants else list(VARIANTS)
    set_exact_f32()
    dev = torch.device("cuda:0")
    result = {"device": torch.cuda.get_device_name(0), "dtype": "float32", "variants": {},
              "library_ms": {}}
    with tempfile.TemporaryDirectory() as root:
        libs = build_variants(names, root, VARIANTS)
        for name, b, sq, sk, h in SHAPES:
            rng = np.random.default_rng(sq + sk + b)
            mk = lambda s: torch.from_numpy(
                rng.standard_normal((b, s, h * D), dtype=np.float32)).to(dev)
            q, k, v, dout = mk(sq), mk(sk), mk(sk), mk(sq)
            out, lse = attention_fwd_lse_reference(q, k, v, h)
            delta = _delta(out, dout, h)
            refs = attention_bwd_reference(q, k, v, out, lse, dout, h)
            limits = grad_error_limits(q, k, v, out, lse, dout, h, refs)
            split = lambda x, s: x.view(b, s, h, D).transpose(1, 2)
            qs, ks, vs = (split(x, s).detach().requires_grad_()
                          for x, s in ((q, sq), (k, sk), (v, sk)))
            sdpa_out = F.scaled_dot_product_attention(qs, ks, vs)
            sdpa_bwd = lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), split(dout, sq),
                                                   retain_graph=True)
            result["library_ms"][name] = dict(ms=events_ms(sdpa_bwd, ITERS),
                                              device_ms=profile_device_ms(sdpa_bwd, ITERS))
            del sdpa_out, qs, ks, vs
            for var in names:
                lib = libs[var]
                dq_fn = lambda: attention._launch_bwd_dq(lib, q, k, v, dout, lse, delta, h,
                                                         D**-0.5)
                dkv_fn = lambda: attention._launch_bwd_dkv(lib, q, k, v, dout, lse, delta, h,
                                                           D**-0.5)
                grads = (dq_fn(), *dkv_fn())
                torch.cuda.synchronize()
                ratio = max(((g - r).abs() / lim).max().item()
                            for g, r, lim in zip(grads, refs, limits))
                del grads
                row = {"max_err_over_limit": ratio}
                for part, fn in (("dq", dq_fn), ("dkv", dkv_fn)):
                    kernel, device_ms = _profiled(fn, f"bwd_{part}")
                    row[part] = dict(ms=events_ms(fn, ITERS), device_ms=device_ms,
                                     kernel=re.search(r"bwd_\w+<[^>]*>", kernel).group(0))
                row["pair_ms"] = row["dq"]["ms"] + row["dkv"]["ms"]
                row["pair_device_ms"] = row["dq"]["device_ms"] + row["dkv"]["device_ms"]
                result["variants"].setdefault(var, {})[name] = row
            del q, k, v, dout, out, lse, delta, refs, limits
            torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
