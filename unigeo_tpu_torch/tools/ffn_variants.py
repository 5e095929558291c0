"""Time variants of the GEGLU feed-forward's and the LayerNorm -> dense's
wgmma bodies side by side.

Each variant is the kernel sources with textual edits (``VARIANTS``: name ->
[(file, anchor, replacement)]), built into a temporary directory, all builds
in parallel; ``built`` is the sources as they are.  Each library runs the
fused GEGLU feed-forward at the UNet's four feed-forward shapes and the
LayerNorm -> dense at its three temporal-attention shapes (M = 25 frames x
tokens at 384 x 512), held against the plain versions under
``geglu_error_limit`` / ``ln_dense_error_limit``, and timed three ways:
CUDA events around ``ITERS`` back-to-back calls (``ms``), the launch's
device time from torch.profiler (``device_ms``, the split-sum pass included
where the plan splits the hidden tiles), and the host's time to issue one
call (``host_ms``: the host clock around ``ITERS`` calls, without waiting
for the card, which is still busy with them); each with the plan it took:

    python -m unigeo_tpu_torch.tools.ffn_variants [--variants a,b,...] [--kernels geglu,ln]

It prints one JSON object: per variant, kernel and shape ``ms``,
``device_ms``, ``host_ms``, ``max_err_over_limit`` and ``plan``; and the
card's name.  It
needs the card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

from unigeo_tpu_torch.tools.forward_variants import build_variants, events_ms, profile_device_ms

_G = "geglu_ffn.cu"
VARIANTS = {
    "built": [],
    # the GEGLU feed-forward fused at every shape, or as two passes at every
    # shape (built: fused at C_out = 320, two passes at 640 and 1280)
    "geglu_fused": [(_G, "  p->two_pass = (m.groups > 1 || m.cw > 160) && Hd % kUpTile<kUp> == 0;",
                     "  p->two_pass = 0;")],
    "geglu_two_pass": [(_G, "  p->two_pass = (m.groups > 1 || m.cw > 160) && Hd % kUpTile<kUp> == 0;",
                        "  p->two_pass = Hd % kUpTile<kUp> == 0;")],
    # one block a cluster: every GEGLU block loads whole weight tiles from L2
    "geglu_no_cluster": [(_G, "constexpr int kCluster = 2;", "constexpr int kCluster = 1;")],
    # a timing proxy, not a kernel: the fused body with one column group at
    # every shape, so at C_out = 1280 it computes the up-projection once
    # and only the first 640 output columns (the rest of the output is not
    # written: its error is no result).  It times the fused body at 1x of
    # the up-projection's work, a design that shares h between the two
    # column groups (through DSMEM) without the exchange's cost
    "geglu_fused_one_group": [
        (_G, "  p->two_pass = (m.groups > 1 || m.cw > 160) && Hd % kUpTile<kUp> == 0;",
         "  p->two_pass = 0;\n  m.groups = 1;")],
}
GEGLU_SHAPES = [("unet_stage0", 76800, 320), ("unet_stage1", 19200, 640),
                ("unet_stage2", 4800, 1280), ("unet_mid", 1200, 1280)]
LN_SHAPES = [("unet_stage0", 76800, 320, 960), ("unet_stage1", 19200, 640, 1920),
             ("unet_stage2", 4800, 1280, 3840)]
ITERS = 20


def _bf16(rng, shape, std, mean=0.0, device="cuda"):
    return torch.from_numpy((rng.standard_normal(shape) * std + mean).astype(np.float32)).to(
        device, torch.bfloat16)


def host_ms(fn, iters: int) -> float:
    """The host's time to issue one call of ``fn``, in ms: the host clock
    around ``iters`` calls after the card has caught up, not waiting for it
    (``iters`` is far below what fills the launch queue)."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed * 1e3 / iters


def geglu_inputs(m, c, dev, seed=0):
    """x [M, C] ~ N(0, 1), nn.Linear-layout weights at lecun-normal scales,
    hidden 4C, C_out = C, small biases; bf16."""
    rng = np.random.default_rng(seed)
    h = 4 * c
    return (_bf16(rng, (m, c), 1.0, device=dev), _bf16(rng, (2 * h, c), c**-0.5, device=dev),
            _bf16(rng, (2 * h,), 0.05, device=dev), _bf16(rng, (c, h), h**-0.5, device=dev))


def ln_inputs(m, c, n, dev, seed=0):
    """x [M, C] with row means of 0.5, gamma ~ 1 + 0.2 N, beta ~ 0.3 N, W [N, C]
    ~ N(0, 1/C), bias ~ 0.1 N; bf16."""
    rng = np.random.default_rng(seed)
    return (_bf16(rng, (m, c), 1.0, 0.5, dev), _bf16(rng, (c,), 0.2, 1.0, dev),
            _bf16(rng, (c,), 0.3, device=dev), _bf16(rng, (n, c), c**-0.5, device=dev),
            _bf16(rng, (n,), 0.1, device=dev))


def main(argv: Optional[List[str]] = None) -> dict:
    from unigeo_tpu_torch.device import set_exact_f32
    from unigeo_tpu_torch.ops import geglu, ln_qkv

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names from VARIANTS")
    ap.add_argument("--kernels", default="geglu,ln", help="geglu, ln or both")
    args = ap.parse_args(argv)
    names, kernels = args.variants.split(","), args.kernels.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("ffn_variants needs an NVIDIA GPU")
    set_exact_f32()  # the f32 plain versions in full f32
    dev = torch.device("cuda:0")
    result = {"device": torch.cuda.get_device_name(0), "variants": {n: {} for n in names}}

    def run(kernel, shape, fn, check, plan):
        for var in names:
            out = fn(var)
            torch.cuda.synchronize()
            result["variants"][var].setdefault(kernel, {})[shape] = dict(
                ms=events_ms(lambda: fn(var), ITERS),
                device_ms=profile_device_ms(lambda: fn(var), ITERS),
                host_ms=host_ms(lambda: fn(var), ITERS),
                max_err_over_limit=check(out), plan=plan(var))

    with tempfile.TemporaryDirectory() as root:
        libs = build_variants(names, root, VARIANTS)
        if "geglu" in kernels:
            for name, m, c in GEGLU_SHAPES:
                x, w1, b1, w2 = geglu_inputs(m, c, dev, seed=m + c)
                out = torch.empty((m, c), dtype=torch.bfloat16, device=dev)
                ref = geglu.geglu_ffn_plain(x, w1, b1, w2)
                limit = geglu.geglu_error_limit(x, w1, b1, w2, ref)
                run("geglu", name, lambda v: geglu._launch(libs[v], x, w1, b1, w2, out),
                    lambda o: ((o.float() - ref.float()).abs() / limit).max().item(),
                    lambda v: geglu.kernel_plan(libs[v], m, c, 4 * c, c))
                del x, w1, b1, w2, out, ref, limit
                torch.cuda.empty_cache()
        if "ln" in kernels:
            for name, m, c, n in LN_SHAPES:
                args_ = ln_inputs(m, c, n, dev, seed=m + c)
                out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
                ref = ln_qkv.ln_dense_plain(*args_)
                limit = ln_qkv.ln_dense_error_limit(*args_, ref)
                run("ln_dense", name, lambda v: ln_qkv._launch(libs[v], *args_, out, 1e-5),
                    lambda o: ((o.float() - ref.float()).abs() / limit).max().item(),
                    lambda v: ln_qkv.kernel_plan(libs[v], *args_[:4]))
                del args_, out, ref, limit
                torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
