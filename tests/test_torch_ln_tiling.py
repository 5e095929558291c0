"""The fused LayerNorm -> dense's bf16 wgmma body (csrc/ln_dense.cu), its
tiling and arithmetic emulated in torch on the CPU, against the port's
plain version and the JAX package's Pallas kernel in interpret mode.

The emulation follows the kernel's schedule.  Rows in items of 64 (a
cluster's two blocks take two consecutive row blocks; rows past M are the
TMA's zeros and are dropped); per item the row statistics in f32 (the mean,
then the mean of the centred squares over the true C) and y = bf16((x -
mean) rsqrt(var + eps) gamma + beta) once, zeros past C and for rows past
M; the N tiles of 320 columns split over items into contiguous ranges, each
item normalizing its rows again (the same values); per tile consumer c adds
y W[c 160 .. c 160 + 160)^T over chunks of 32 columns of C in f32, then the
f32 bias, rounded once to bf16; columns past N are dropped.

Inputs are bf16, made with numpy from a seed (rows with a mean of 0.5,
gamma ~ 1 + 0.2 N, beta ~ 0.3 N, W ~ N(0, 1/C), b ~ 0.1 N).  Tolerance:
``ln_dense_error_limit`` (1.0625 (2^-7 |ref| + 2 C 2^-24 T + dY |W|^T)) of
the plain version and of the interpret-mode Pallas kernel: all compute y and
the product in f32 with the same two roundings, in other orders.  The twin
of the planted fault ``ln_other_rows_stats`` of tests/test_torch_cuda.py,
each row normalized with the statistics of another row of its block, fails
the limit by at least 3x.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unigeo_tpu.ops.ln_qkv import ln_dense_tpu
from unigeo_tpu_torch.ops.ln_qkv import ln_dense_error_limit, ln_dense_plain

ROWS, CLUSTER, N_TILE, HALF, K_CHUNK = 64, 2, 320, 160, 32
EPS = 1e-5

# (M, C, N, N splits): ragged M, C not a multiple of 64 (16-byte rows), a
# ragged last N tile (N = 129, 400), N split over items and not
CASES = [(100, 200, 400, 1), (100, 200, 400, 2), (37, 72, 129, 1), (300, 128, 960, 3),
         (130, 96, 640, 2)]


def _stats(rows):
    mean = rows.mean(dim=1, keepdim=True)
    return mean, torch.rsqrt(((rows - mean) ** 2).mean(dim=1, keepdim=True) + EPS)


def emulate_ln_dense(x, gamma, beta, w, bias, nsplit, fault=None):
    """out [M, N] bf16 by the kernel's schedule; all inputs bf16.  ``fault``:
    None or "other_rows_stats": row r of a block normalized with the
    statistics of row r ^ 8, as the kernel's warp w, which normalizes rows
    w, w + 8, ... in place in that order, would take them: from x where row
    r ^ 8 comes later, from its y where it came before."""
    m, c = x.shape
    n = w.shape[0]
    rows = -(-m // (CLUSTER * ROWS)) * CLUSTER * ROWS
    xf = torch.cat([x.float(), torch.zeros(rows - m, c)])
    norm = lambda r, st: ((r - st[0]) * st[1] * gamma.float() + beta.float()).to(
        torch.bfloat16).float()
    if fault == "other_rows_stats":
        first = (torch.arange(rows) // 8) % 2 == 0  # normalized before its partner
        partner = torch.arange(rows) ^ 8
        y = torch.empty_like(xf)
        y[first] = norm(xf[first], _stats(xf[partner[first]]))
        y[~first] = norm(xf[~first], _stats(y[partner[~first]]))
    else:
        y = norm(xf, _stats(xf))
    y[m:] = 0.0
    n_tiles = -(-n // N_TILE)
    wf = torch.cat([w.float(), torch.zeros(n_tiles * N_TILE - n, c)])
    out = torch.empty(rows, n_tiles * N_TILE)
    for sp in range(nsplit):
        for t in range(sp * n_tiles // nsplit, (sp + 1) * n_tiles // nsplit):
            for cons in range(2):
                cols = slice(t * N_TILE + cons * HALF, t * N_TILE + cons * HALF + HALF)
                acc = torch.zeros(rows, HALF)
                for k0 in range(0, c, K_CHUNK):
                    acc += y[:, k0:k0 + K_CHUNK] @ wf[cols, k0:k0 + K_CHUNK].T
                out[:, cols] = acc
    out = out[:m, :n] + bias.float()
    return out.to(torch.bfloat16)


def _inputs(m, c, n, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda shape, std, mean=0.0: torch.from_numpy(
        (rng.standard_normal(shape) * std + mean).astype(np.float32)).to(torch.bfloat16)
    return (mk((m, c), 1.0, 0.5), mk((c,), 0.2, 1.0), mk((c,), 0.3), mk((n, c), c**-0.5),
            mk((n,), 0.1))


def _ratio(out, ref, args):
    limit = ln_dense_error_limit(*args, ref)
    return ((out.float() - ref.float()).abs() / limit).max().item()


@pytest.mark.parametrize("m,c,n,nsplit", CASES)
def test_emulation_matches_plain(m, c, n, nsplit):
    args = _inputs(m, c, n, seed=m + c)
    out = emulate_ln_dense(*args, nsplit)
    assert out.shape == (m, n) and out.dtype == torch.bfloat16
    assert _ratio(out, ln_dense_plain(*args), args) <= 1.0


@pytest.mark.parametrize("m,c,n,nsplit", [CASES[0], CASES[2], CASES[3]])
def test_emulation_matches_pallas_interpret(m, c, n, nsplit):
    x, g, b, w, bias = args = _inputs(m, c, n, seed=m + c)
    jx = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    # the JAX package's Dense kernel is [C, N]
    ref = ln_dense_tpu(jx(x), jx(g), jx(b), jx(w.T), jx(bias), interpret=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    assert _ratio(emulate_ln_dense(*args, nsplit), ref, args) <= 1.0


@pytest.mark.parametrize("m,c,n,nsplit", [CASES[0], CASES[3], CASES[4]])
def test_emulated_other_rows_stats_fails_the_limit(m, c, n, nsplit):
    args = _inputs(m, c, n, seed=m + c)
    ref = ln_dense_plain(*args)
    assert _ratio(emulate_ln_dense(*args, nsplit), ref, args) <= 1.0
    assert _ratio(emulate_ln_dense(*args, nsplit, fault="other_rows_stats"), ref, args) >= 3.0
