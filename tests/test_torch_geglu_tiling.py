"""The fused GEGLU feed-forward's wgmma body (csrc/geglu_ffn.cu), its tiling
and arithmetic emulated in torch on the CPU, against the port's plain
version and the JAX package's Pallas kernel in interpret mode.

The emulation follows the kernel's schedule.  Rows in items of 64 (a
cluster's two blocks take two consecutive row blocks; rows past M are
zeros, as the TMA loads them, and are dropped); output columns in groups of
2 CW, consumer c of a group owning columns [c CW, c CW + CW); the hidden
tiles of 64 split over items into contiguous ranges.  Per hidden tile j,
consumer c computes the value and gate of hidden columns j 64 + 32c +
[0, 32) in f32 (f32 biases), writes h = bf16(v gelu_tanh(g)) into its half
of the tile's h buffer (two buffers, taken in turn), and both consumers
add h W2^T of the whole tile to their f32 accumulators.  A split's f32
accumulator is its partial output; the partials are summed in split order
and rounded once to bf16.  Where the kernel's plan takes two passes (the
up-projection writing h to device memory, then the down-projection
reading it back, its up-projection in tiles of 128 with 64 columns a
consumer), each h element and every sum are the same: the emulation stands
for both.

Inputs are bf16, made with numpy from a seed.  Tolerance: the emulation
within ``geglu_error_limit`` (1.0625 (2^-7 |ref| + (2^-7 + 2 H 2^-24) T +
F_up), T = |h| |w2|^T) of the plain version and of the interpret-mode Pallas
kernel: all compute the same function in f32 with h and the output rounded
to bf16 once, differing in the order of the f32 sums (the split sum's
order included).  The twins of the planted faults of
tests/test_torch_cuda.py fail the limit by at least 3x: a consumer's half
of h never written (``geglu_half_h_unwritten``: the half keeps what the
buffer held), the down-projection reading the h buffer of the tile before
(``geglu_stale_h_tile``: the other buffer), and the split sum dropping its last split
(``geglu_drop_split``).

The two-pass plan's row guards are emulated on their own: the up pass
stores h into a scratch of whole items filled with NaN and the down pass
its output into such a buffer, each only for rows < M.  Rows past M must
stay NaN; the twins of ``geglu_h_rows_past_m`` (the up pass stores every
row of its items) and of ``geglu_no_ragged_mask`` (the down pass does)
write them, which the card tests count as failing the limit outright.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unigeo_tpu.ops.geglu import geglu_ffn_tpu
from unigeo_tpu_torch.ops.geglu import geglu_error_limit, geglu_ffn_plain, gelu_tanh

ROWS, HIDDEN_TILE, CLUSTER, H_BUFFERS = 64, 64, 2, 2
UP_TILE = 128  # the up pass's hidden tile: 64 columns a consumer

# (M, C, hidden multiple, columns a consumer, hidden splits): ragged M, one
# and several column groups (C_out = 64 as 4 groups of 16 at CW = 8), one
# split and several, a split count that does not divide the hidden tiles
CASES = [(100, 64, 4, 32, 1), (100, 64, 4, 32, 4), (130, 128, 4, 64, 3), (37, 64, 2, 8, 2),
         (200, 128, 4, 32, 3), (65, 192, 4, 32, 6)]


def emulate_geglu(x, w1, b1, w2, cw, splits, fault=None):
    """out [M, C_out] bf16 by the kernel's schedule; bf16 x [M, C], w1 [2H, C],
    b1 [2H], w2 [C_out, H].  ``fault``: None, "half_h_unwritten",
    "stale_h_tile" or "drop_split"."""
    m, c = x.shape
    hidden, c_out = w1.shape[0] // 2, w2.shape[0]
    rows = -(-m // (CLUSTER * ROWS)) * CLUSTER * ROWS
    xf = torch.cat([x.float(), x.new_zeros(rows - m, c).float()])
    w1f, b1f, w2f = w1.float(), b1.float(), w2.float()
    n_tiles = hidden // HIDDEN_TILE
    out = torch.empty(rows, c_out)
    for n0 in range(0, c_out, 2 * cw):  # column groups
        partials = []
        for sp in range(splits):
            acc = torch.zeros(rows, 2 * cw)
            # the h buffers (each block's rows): a half never written keeps zeros
            buffers = [torch.zeros(rows, HIDDEN_TILE) for _ in range(H_BUFFERS)]
            tiles = range(sp * n_tiles // splits, (sp + 1) * n_tiles // splits)
            for i, j in enumerate(tiles):
                h = buffers[i % H_BUFFERS]
                for cons in range(2):
                    if fault == "half_h_unwritten" and cons == 1:
                        continue
                    cols = slice(j * HIDDEN_TILE + 32 * cons, j * HIDDEN_TILE + 32 * cons + 32)
                    gate_cols = slice(hidden + cols.start, hidden + cols.stop)
                    v = xf @ w1f[cols].T + b1f[cols]
                    g = xf @ w1f[gate_cols].T + b1f[gate_cols]
                    h[:, 32 * cons:32 * cons + 32] = (v * gelu_tanh(g)).to(torch.bfloat16).float()
                read = buffers[(i - 1) % H_BUFFERS] if fault == "stale_h_tile" else h
                w2_tile = w2f[n0:n0 + 2 * cw, j * HIDDEN_TILE:(j + 1) * HIDDEN_TILE]
                acc += read @ w2_tile.T
            partials.append(acc)
        if fault == "drop_split" and splits > 1:
            partials = partials[:-1]
        total = partials[0]
        for p in partials[1:]:
            total = total + p
        out[:, n0:n0 + 2 * cw] = total
    return out[:m].to(torch.bfloat16)


def _inputs(m, c, mult, seed=0):
    """bf16 x [M, C] ~ N(0, 1) and nn.Linear-layout weights at lecun-normal
    scales, small random biases (tests/test_torch_cuda.py's inputs)."""
    rng = np.random.default_rng(seed)
    mk = lambda shape, std: torch.from_numpy(
        (rng.standard_normal(shape) * std).astype(np.float32)).to(torch.bfloat16)
    hidden = c * mult
    return (mk((m, c), 1.0), mk((2 * hidden, c), c**-0.5), mk((2 * hidden,), 0.05),
            mk((c, hidden), hidden**-0.5))


def _ratio(out, ref, args):
    limit = geglu_error_limit(*args, ref)
    return ((out.float() - ref.float()).abs() / limit).max().item()


@pytest.mark.parametrize("m,c,mult,cw,splits", CASES)
def test_emulation_matches_plain(m, c, mult, cw, splits):
    args = _inputs(m, c, mult, seed=m + c)
    out = emulate_geglu(*args, cw, splits)
    assert out.shape == (m, c) and out.dtype == torch.bfloat16
    assert _ratio(out, geglu_ffn_plain(*args), args) <= 1.0


@pytest.mark.parametrize("m,c,mult,cw,splits", [CASES[1], CASES[2], CASES[3]])
def test_emulation_matches_pallas_interpret(m, c, mult, cw, splits):
    x, w1, b1, w2 = args = _inputs(m, c, mult, seed=m + c)
    jx = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    # the JAX package's layout: w1 [C, 2H], w2 [H, C_out]
    ref = geglu_ffn_tpu(jx(x), jx(w1.T), jx(b1), jx(w2.T), block_m=64, interpret=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    assert _ratio(emulate_geglu(*args, cw, splits), ref, args) <= 1.0


@pytest.mark.parametrize("fault,case", [
    ("half_h_unwritten", CASES[0]), ("half_h_unwritten", CASES[4]),
    ("stale_h_tile", CASES[1]), ("stale_h_tile", CASES[2]),
    ("drop_split", CASES[1]), ("drop_split", CASES[5]),
])
def test_emulated_faults_fail_the_limit(fault, case):
    m, c, mult, cw, splits = case
    args = _inputs(m, c, mult, seed=m + c)
    ref = geglu_ffn_plain(*args)
    assert _ratio(emulate_geglu(*args, cw, splits), ref, args) <= 1.0
    assert _ratio(emulate_geglu(*args, cw, splits, fault=fault), ref, args) >= 3.0


def emulate_two_pass(x, w1, b1, w2, fault=None):
    """The two-pass plan: (the h scratch, the output buffer), both [rows of
    whole items, ...] filled with NaN and written for rows < M; x's rows
    past M are zeros, as the TMA loads them.  ``fault``: None,
    "h_rows_past_m" (the up pass stores every row) or "no_ragged_mask" (the
    down pass does)."""
    m, c = x.shape
    hidden, c_out = w1.shape[0] // 2, w2.shape[0]
    rows = -(-m // (CLUSTER * ROWS)) * CLUSTER * ROWS
    xf = torch.cat([x.float(), x.new_zeros(rows - m, c).float()])
    w1f, b1f = w1.float(), b1.float()
    scratch = torch.full((rows, hidden), float("nan"), dtype=torch.bfloat16)
    stored = rows if fault == "h_rows_past_m" else m
    for j in range(hidden // UP_TILE):
        for cons in range(2):
            cols = slice(j * UP_TILE + 64 * cons, j * UP_TILE + 64 * cons + 64)
            gate_cols = slice(hidden + cols.start, hidden + cols.stop)
            v = xf @ w1f[cols].T + b1f[cols]
            g = xf @ w1f[gate_cols].T + b1f[gate_cols]
            scratch[:stored, cols] = (v * gelu_tanh(g)).to(torch.bfloat16)[:stored]
    # the down pass reads h by the TMA: rows past M load as zeros
    h = torch.cat([scratch[:m].float(), torch.zeros(rows - m, hidden)])
    out = torch.full((rows, c_out), float("nan"), dtype=torch.bfloat16)
    stored = rows if fault == "no_ragged_mask" else m
    out[:stored] = (h @ w2.float().T).to(torch.bfloat16)[:stored]
    return scratch, out


def _two_pass_ratio(x, w1, b1, w2, fault=None):
    """max err/limit of the emulated two-pass output, inf where a row past M
    of the h scratch or of the output was written."""
    m = x.shape[0]
    scratch, out = emulate_two_pass(x, w1, b1, w2, fault)
    if not (torch.isnan(scratch[m:].float()).all() and torch.isnan(out[m:].float()).all()):
        return float("inf")
    return _ratio(out[:m], geglu_ffn_plain(x, w1, b1, w2), (x, w1, b1, w2))


@pytest.mark.parametrize("m,c,mult", [(100, 64, 4), (37, 64, 2), (200, 128, 4)])
def test_emulated_two_pass_matches_plain(m, c, mult):
    assert _two_pass_ratio(*_inputs(m, c, mult, seed=m + c)) <= 1.0


@pytest.mark.parametrize("fault", ["h_rows_past_m", "no_ragged_mask"])
def test_emulated_two_pass_row_faults_fail(fault):
    args = _inputs(100, 64, 4, seed=164)
    assert _two_pass_ratio(*args) <= 1.0
    assert _two_pass_ratio(*args, fault=fault) >= 3.0
