"""Time the fused LayerNorm -> dense kernel against the unfused layers.

Port of ``tools/ablate_ln_qkv.py``, at the UNet's temporal-attention shapes
(per level at 25 x 384 x 512: x [25 tokens, C] with the q/k/v output
[., 3C]) and the same inputs: gamma = 1, beta = 0, W ~ N(0, 1/C), b = 0.
Each step of the timed chain is the layer then a projection back down with
W^T / sqrt(3C), so the carry keeps [M, C]:

    fused:    ln_dense(x)                             -> @ W_down
    unfused:  F.linear(F.layer_norm(x), W, b)         -> @ W_down

    python -m unigeo_tpu_torch.tools.ablate_ln_qkv [--small] [--device cpu]

On the card (the default) each chain is timed with CUDA events over
``LENGTH`` steps after ``WARMUP`` steps; per shape the kernel is launched
``launches_per_shape()`` times.  It prints one JSON object: per shape
``unfused_ms`` and ``fused_ms`` (per chain step), ``speedup``,
``max_abs_dev`` (kernel vs ``ln_dense_reference``), ``max_err_over_limit``
(kernel vs ``ln_dense_plain`` under ``ln_dense_error_limit``) and the
kernel's ``bound_ms`` on an H100; ``device``.  With ``--device cpu`` it runs
only the plain version and the reference, launches no kernel and times
nothing (the times are null).  ``--small``: one shape, (1024, 256).
"""

from __future__ import annotations

import argparse
import json
import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from unigeo_tpu_torch.device import resolve_device, set_exact_f32
from unigeo_tpu_torch.ops.ln_qkv import (
    ln_dense,
    ln_dense_error_limit,
    ln_dense_plain,
    ln_dense_reference,
)

# (M, C) per UNet level at 25x384x512: tokens = T * (H/8 / 2^l) * (W/8 / 2^l)
SHAPES = [
    (25 * 48 * 64, 320),
    (25 * 24 * 32, 640),
    (25 * 12 * 16, 1280),
]
SMALL_SHAPES = [(1024, 256)]
WARMUP = 2   # chain steps before the timed chain
LENGTH = 16  # timed chain steps (the JAX tool's scan length)
EPS = 1e-5
H100_BF16_FLOPS = 989e12  # tensor cores, dense
H100_F32_FLOPS = 67e12  # CUDA cores (the f32 kernel uses no tensor core)
H100_BYTES_PER_S = 3.35e12


def launches_per_shape() -> int:
    """Kernel launches per shape on the card: the warm-up and the timed
    fused chains, and the check."""
    return WARMUP + LENGTH + 1


def bound(m: int, c: int, n: int, dtype=torch.bfloat16):
    """(least ms on an H100, bound_by) of one call: 2 M C N operations at
    the dtype's peak (bf16 tensor cores, f32 CUDA cores), against x, W, out
    and gamma, beta, b moved once."""
    es, peak = (2, H100_BF16_FLOPS) if dtype == torch.bfloat16 else (4, H100_F32_FLOPS)
    t_ops = 2.0 * m * c * n / peak
    t_bytes = es * (m * c + n * c + m * n + 2 * c + n) / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def make_inputs(m: int, c: int, device):
    """bf16 x, gamma, beta, weight [3C, C], bias, and the down-projection
    [3C, C], from seed 0."""
    gen = torch.Generator(device=device).manual_seed(0)
    n = 3 * c
    x = torch.randn((m, c), generator=gen, device=device).to(torch.bfloat16)
    weight = (torch.randn((n, c), generator=gen, device=device) / math.sqrt(c)).to(torch.bfloat16)
    gamma = torch.ones((c,), device=device, dtype=torch.bfloat16)
    beta = torch.zeros((c,), device=device, dtype=torch.bfloat16)
    bias = torch.zeros((n,), device=device, dtype=torch.bfloat16)
    w_down = weight / math.sqrt(3.0 * c)
    return x, gamma, beta, weight, bias, w_down


def _unfused(x, gamma, beta, weight, bias):
    return F.linear(F.layer_norm(x, (x.shape[1],), gamma, beta, EPS), weight, bias)


def _chain_ms(layer, x, params, w_down) -> float:
    """ms per step of the chain x <- layer(x, *params) @ w_down, by CUDA
    events over LENGTH steps after WARMUP steps."""
    y = x
    for _ in range(WARMUP):
        y = layer(y, *params) @ w_down
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    y = x
    start.record()
    for _ in range(LENGTH):
        y = layer(y, *params) @ w_down
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / LENGTH


def measure(m: int, c: int, device) -> dict:
    x, gamma, beta, weight, bias, w_down = make_inputs(m, c, device)
    params = (gamma, beta, weight, bias)
    on_card = device.type == "cuda"
    unfused_ms = _chain_ms(_unfused, x, params, w_down) if on_card else None
    fused_ms = _chain_ms(ln_dense, x, params, w_down) if on_card else None
    out = ln_dense(x, *params, eps=EPS)
    plain = ln_dense_plain(x, *params, eps=EPS)
    limit = ln_dense_error_limit(x, *params, plain, eps=EPS)
    ref = ln_dense_reference(x, *params, eps=EPS)
    bms, by = bound(m, c, 3 * c)
    return {
        "M": m, "C": c, "N": 3 * c,
        "unfused_ms": unfused_ms,
        "fused_ms": fused_ms,
        "speedup": unfused_ms / fused_ms if on_card else None,
        "max_abs_dev": (out.float() - ref.float()).abs().max().item(),
        "max_err_over_limit": ((out.float() - plain.float()).abs() / limit).max().item(),
        "bound_ms": bms,
        "bound_by": by,
    }


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--small", action="store_true", help="one shape, (1024, 256)")
    parser.add_argument("--device", default="cuda", help="cuda (the kernel) or cpu (plain)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        set_exact_f32()  # the f32 plain version and limit in full f32
    results = {
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "shapes": [measure(m, c, device) for m, c in (SMALL_SHAPES if args.small else SHAPES)],
    }
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
