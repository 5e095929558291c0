"""Time variants of the bf16 flash forward's wgmma bodies side by side.

Each variant is the kernel sources with textual edits (``VARIANTS``: name ->
[(file, anchor, replacement)]), built by ``_build.compile_library`` into a
temporary directory, all builds in parallel; ``built`` is the sources as
they are.  Each library's packed forward runs at the forward's attention
shapes at batch 25 (the frames of a clip): the UNet's three stages (d = 64),
the VAE mid block (d = 512) and CLIP (d = 80), held against the plain
version on frames 0, 1 and 24 under ``bf16_error_limit``, and timed two
ways: CUDA events around ``ITERS`` back-to-back calls (``ms``, what a caller
waits, host cost included) and the kernel's own device time from
torch.profiler (``device_ms``).  The variants are the design choices of the
64-row body (d = 16, 64 and 80); the d = 512 body runs as built:

    python -m unigeo_tpu_torch.tools.forward_variants [--variants a,b,...]

With ``--f32`` the variants are ``F32_VARIANTS``: those of the f32 body at
d = 64 (block rows, ring depth, unrolls; and the earlier CUDA-core body at
d = 64) and of the f32 body at d = 512 (key tile, the key split of the
items left over, unrolls; and the earlier CUDA-core body at d = 512), at
the pointmap
path's shapes and the DepthCrafter trainer's VAE mid attention
(``F32_SHAPES``) in f32 (TF32 off), each held against the plain version
within F32_OUT_TOL = 1e-5 on the batch entries 0, 1 and the last, with the
kernel's name and SDPA's f32 time beside them (a variant of one width
builds the other's body as it is):

    python -m unigeo_tpu_torch.tools.forward_variants --f32 [--variants a,b,...]

It prints one JSON object: per variant and shape ``ms``, ``device_ms``,
``max_err_over_limit`` (in f32 the max abs error over 1e-5) and, in f32,
``kernel``; and the card's name.  It needs the card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

_SRC = "flash_attention_packed.cu"
VARIANTS = {
    "built": [],
    # the consumers issue their products whenever they are ready
    "no_pingpong": [(_SRC, "constexpr bool kWgPingpong = true;",
                     "constexpr bool kWgPingpong = false;")],
    # ring depth
    "stages2": [(_SRC, "static constexpr int kStages = 4;", "static constexpr int kStages = 2;")],
    "stages5": [(_SRC, "static constexpr int kStages = 4;", "static constexpr int kStages = 5;")],
    # two consumers (128 queries a block, 240 registers each), at every
    # width or at d = 80 alone
    "consumers2": [(_SRC, "static constexpr int kConsumers = 3;",
                    "static constexpr int kConsumers = 2;")],
    "clip_consumers2": [(_SRC, "static constexpr int kConsumers = 3;",
                         "static constexpr int kConsumers = D == 80 ? 2 : 3;")],
    # the key tile: 64 keys (S = q k^T as m64n64 products) at every width,
    # or 128 at d = 80 too
    "block_k64": [(_SRC, "static constexpr int kBlockK = D == 80 ? 64 : 128;",
                   "static constexpr int kBlockK = 64;")],
    "clip_block_k128": [(_SRC, "static constexpr int kBlockK = D == 80 ? 64 : 128;",
                         "static constexpr int kBlockK = 128;")],
}
_REG = "constexpr int kRegWarps = 4, kRegStages = 2;"
F32_VARIANTS = {
    "built": [],
    # the earlier CUDA-core body (flash_*_kernel<64, 64, 16>) at d = 64
    "earlier_d64": [(_SRC, "  if (D == kRegD)\n    return launch_f32_d64(",
                     "  if (false)\n    return launch_f32_d64(")],
    # block rows (eight warps: one block an SM) and ring depth
    "warps8": [(_SRC, _REG, "constexpr int kRegWarps = 8, kRegStages = 2;")],
    "stages3": [(_SRC, _REG, "constexpr int kRegWarps = 4, kRegStages = 3;")],
    # the products' loops unrolled whole, or by half as much
    "full_unroll": [(_SRC, "constexpr int kRegUnrollD = 4, kRegUnrollK = 16;",
                     "constexpr int kRegUnrollD = 16, kRegUnrollK = 64;")],
    "half_unroll": [(_SRC, "constexpr int kRegUnrollD = 4, kRegUnrollK = 16;",
                     "constexpr int kRegUnrollD = 2, kRegUnrollK = 8;")],
    # d = 512: the earlier CUDA-core body (flash_*_kernel<16, 32, 32>)
    "earlier_d512": [(_SRC, "  if (D == kW512D)\n    return launch_f32_d512(",
                      "  if (false)\n    return launch_f32_d512(")],
    # key tiles of 8 (S: 4 rows x 4 keys a lane, 8 FMAs a load; 4 owners)
    "w512_bk8": [(_SRC, "constexpr int kW512BK = 16;     // keys of a tile",
                  "constexpr int kW512BK = 8;     // keys of a tile")],
    # the items left over after the whole rounds run one block an item, as
    # the others (no key split over clusters)
    "w512_no_split": [(_SRC, "if (rest * kSplit <= sms && kSplit <= n_tiles) return",
                       "if (false) return")],
    # S's loop over 16 steps of 4 d unrolled by 4 or by 2 (whole as built)
    "w512_unroll4": [(_SRC, "constexpr int kW512UnrollD = 16;", "constexpr int kW512UnrollD = 4;")],
    "w512_unroll2": [(_SRC, "constexpr int kW512UnrollD = 16;", "constexpr int kW512UnrollD = 2;")],
}
# (name, B, S, H, D): Spann3R's encoder over UniGeoCam's 25 frames and over
# its own 20, its decoder per frame (768 tokens of 384 x 512); the
# DepthCrafter trainer's f32 target encode, its VAE mid block's one head
# over 25 frames' 48 x 64 latents
F32_SHAPES = [("pointmap_encoder", 25, 768, 12, 64), ("spann3r_encoder", 20, 768, 12, 64),
              ("pointmap_decoder", 1, 768, 8, 64), ("depthcrafter_vae_mid", 25, 3072, 1, 512)]
# calls a timing at d = 512 (the earlier body takes about 0.12 s a call)
F32_WIDE_ITERS = 5
F32_OUT_TOL = 1e-5
SHAPES = [("unet_stage0", 3072, 5, 64), ("unet_stage1", 768, 10, 64),
          ("unet_stage2", 192, 20, 64), ("vae_mid", 3072, 1, 512), ("clip_vit_h", 257, 16, 80)]
BATCH = 25
FRAMES = (0, 1, 24)
ITERS = 20


def build_variants(names: List[str], root: str, variants: Optional[dict] = None) -> dict:
    """name -> the loaded library of that variant of ``variants`` (this
    tool's ``VARIANTS`` by default), built under ``root``."""
    from unigeo_tpu_torch import _build

    variants = VARIANTS if variants is None else variants
    jobs = {}
    for name in names:
        work = os.path.join(root, name)
        shutil.copytree(_build.CSRC_DIR, work)
        for fname, anchor, repl in variants[name]:
            path = os.path.join(work, fname)
            with open(path) as f:
                text = f.read()
            if text.count(anchor) != 1:
                raise RuntimeError(f"{name}: anchor not found once in {fname}: {anchor!r}")
            with open(path, "w") as f:
                f.write(text.replace(anchor, repl))
        cu = sorted(os.path.join(work, f) for f in os.listdir(work) if f.endswith(".cu"))
        jobs[name] = (cu, os.path.join(work, "lib.so"))
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda j: _build.compile_library(*j), jobs.values()))
    return {name: _build.open_library(out) for name, (_, out) in jobs.items()}


def events_ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


PROFILE_ATTEMPTS = 3


def _profiled_kernels(fn, iters: int):
    """``iters`` calls of ``fn`` under torch.profiler: the key averages of
    the device kernels they launched.  The profiler at times records no
    kernel of a window at all; such a window is run again, up to
    PROFILE_ATTEMPTS times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.count > 0]
        if found:
            return found
    raise RuntimeError(f"torch.profiler recorded no kernel of {iters} calls "
                       f"in {PROFILE_ATTEMPTS} windows")


def profile_device_ms(fn, iters: int) -> float:
    """``iters`` calls of ``fn`` under torch.profiler: the device time of
    the kernels they launched, in ms per call (for a library call, whose
    kernels have names of their own): each kernel's mean per recorded
    launch, times its launches per call."""
    return sum(e.self_device_time_total / e.count * max(1, round(e.count / iters))
               for e in _profiled_kernels(fn, iters)) / 1e3


def profile_flash(fn, iters: int):
    """``iters`` calls of ``fn`` under torch.profiler: (the name of the flash
    kernel they launched, its mean device ms per launch the profiler
    recorded; it may miss one of a run of long launches).  A call of the f32
    body at d = 512 may be two launches of it (the whole rounds of items,
    then the items left over, split over clusters or not): then the names
    joined by " + " and the sum of their means, each times its launches a
    call."""
    found = [e for e in _profiled_kernels(fn, iters) if "flash_" in e.key]
    if len(found) != 1 and not (len(found) == 2 and all("f32w512" in e.key for e in found)):
        raise RuntimeError(f"{iters} calls launched the flash kernels "
                           f"{[(e.key, e.count) for e in found]}")
    found.sort(key=lambda e: e.key)
    return (" + ".join(e.key for e in found),
            sum(e.self_device_time_total / 1e3 / e.count * max(1, round(e.count / iters))
                for e in found))


def main(argv: Optional[List[str]] = None) -> dict:
    from unigeo_tpu_torch.ops import attention
    from unigeo_tpu_torch.ops.attention import attention_packed_reference, bf16_error_limit

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=None,
                    help="comma-separated names from VARIANTS (F32_VARIANTS with --f32)")
    ap.add_argument("--f32", action="store_true", help="the f32 bodies at d = 64 and 512")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("forward_variants needs an NVIDIA GPU")
    if args.f32:
        return main_f32(args.variants.split(",") if args.variants else list(F32_VARIANTS))
    names = args.variants.split(",") if args.variants else list(VARIANTS)
    dev = torch.device("cuda:0")
    result = {"device": torch.cuda.get_device_name(0), "batch": BATCH, "variants": {}}
    with tempfile.TemporaryDirectory() as root:
        libs = build_variants(names, root)
        for name, s, h, d in SHAPES:
            rng = np.random.default_rng(s)
            q, k, v = (torch.from_numpy(rng.standard_normal((BATCH, s, h * d), dtype=np.float32))
                       .to(dev, torch.bfloat16) for _ in range(3))
            idx = list(FRAMES)
            ref = attention_packed_reference(q[idx], k[idx], v[idx], h)
            limit = bf16_error_limit(q[idx], k[idx], v[idx], h, ref)
            for var in names:
                fn = lambda: attention._launch(libs[var], q, k, v, h, d**-0.5)
                out = fn()
                torch.cuda.synchronize()
                ratio = ((out[idx].float() - ref.float()).abs() / limit).max().item()
                result["variants"].setdefault(var, {})[name] = dict(
                    ms=events_ms(fn, ITERS), device_ms=profile_flash(fn, ITERS)[1],
                    max_err_over_limit=ratio)
            del q, k, v, ref, limit
            torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return result


def main_f32(names: List[str]) -> dict:
    """The f32 body's variants at F32_SHAPES (see the module's note)."""
    import torch.nn.functional as F

    from unigeo_tpu_torch.device import set_exact_f32
    from unigeo_tpu_torch.ops import attention
    from unigeo_tpu_torch.ops.attention import attention_packed_reference

    set_exact_f32()
    dev = torch.device("cuda:0")
    result = {"device": torch.cuda.get_device_name(0), "dtype": "float32", "variants": {},
              "library_ms": {}}
    with tempfile.TemporaryDirectory() as root:
        libs = build_variants(names, root, F32_VARIANTS)
        for name, b, s, h, d in F32_SHAPES:
            iters = ITERS if d == 64 else F32_WIDE_ITERS
            rng = np.random.default_rng(s + b)
            q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h * d), dtype=np.float32))
                       .to(dev) for _ in range(3))
            idx = sorted({0, min(1, b - 1), b - 1})
            ref = attention_packed_reference(q[idx], k[idx], v[idx], h)
            split = lambda x: x.view(b, s, h, d).transpose(1, 2)
            sdpa = lambda: F.scaled_dot_product_attention(split(q), split(k), split(v))
            result["library_ms"][name] = dict(ms=events_ms(sdpa, iters),
                                              device_ms=profile_device_ms(sdpa, iters))
            for var in names:
                fn = lambda: attention._launch(libs[var], q, k, v, h, d**-0.5)
                out = fn()
                torch.cuda.synchronize()
                err = (out[idx] - ref).abs().max().item()
                kernel, device_ms = profile_flash(fn, iters)
                result["variants"].setdefault(var, {})[name] = dict(
                    ms=events_ms(fn, iters), device_ms=device_ms,
                    max_err_over_limit=err / F32_OUT_TOL, kernel=kernel)
            del q, k, v, ref
            torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
