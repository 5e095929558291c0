"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  They import
no JAX, so they run on a machine that has only PyTorch:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances, forward (the packed kernel and the lse kernel's output): f32
inputs (the CUDA-core path), f32 arithmetic in both versions, only the order
of the sums differs: 1e-5 absolute on outputs of order 1.  bf16 inputs (the
tensor-core path): the elementwise limit of ``bf16_error_limit``,
1.0625 * (2^-7 |ref| + 2^-8 P|V|), from the two roundings in which the
versions differ (P to bf16 before P.V, the output to bf16), each at most
bf16's unit roundoff 2^-8; at least 3.3e-3 for these N(0,1) inputs (P|V| is
about 0.8).  The logsumexp: 1e-4 absolute in both dtypes (f32 in both
versions from the same inputs, sums in another order and exp2/log2 for
exp/log, each under 1e-6 relative on values of order 10).

Backward (dq, dk, dv): the elementwise limits of ``grad_error_limits``; in
bf16 1.0625 * (2^-7 |ref| + 2^-8 T + F), T being P^T|dO| for dv, |dS||k| for
dq and |dS|^T|q| for dk, from the three roundings in which the versions
differ (P before dv, dS before dq and dk, each gradient once); in f32
1.0625 * (2 max(Sq, Sk) 2^-24 T + F), the first-order bound of the last
product's sums taken in another order.  F carries the f32 error of S and dP
(D 2^-24 of their magnitude sums) through P and dS; it holds the S_k = 1
cases, where dP - delta cancels and dS is zero in exact arithmetic.

The bf16 forward has two Hopper bodies (TMA, wgmma), chosen by head width
in one switch: 64-row consumers that each own whole rows at d in {16, 64,
80}, and at d = 512 two consumers that split a row's 512 output columns and
trade their partial scores through shared memory.  Every other bf16 width up
to 512, and rows not aligned to 16 bytes, run the CUDA-core body read into
f32 (the backward's likewise up to 128), held to
``bf16_cuda_core_error_limit`` (and ``grad_error_limits(cuda_core=True)``):
1.0625 (2^-7 |ref| + 2 E), the output's one rounding and twice each
version's f32 error E (the sums' order; P is not rounded).  A launch a body
refuses raises; no other body is tried.  Each writes every output element
once, so two launches give the same bits.

The head-split forward (``flash_attention`` on [B, S, H, D]) is the packed
kernel's body under another name: its output is bitwise equal to the packed
kernel's on the same bytes, and held against the plain version under the
same limits.

The fused GEGLU feed-forward (bf16 only): the elementwise limit of
``geglu_error_limit``, 1.0625 (2^-7 |ref| + (2^-7 + 2 H 2^-24) T + F_up),
T = |h| |w2|^T, from the bf16 roundings of h and of the output, which f32
sums taken in another order can move by one unit each (see there; the
hidden splits' partials summed in a fixed order are such an order).  The
kernel runs fused or as two passes (h through a bf16 scratch) by its plan;
both round h and the output once, and two launches give the same bits.
Rows past M of the output and of the h scratch, written into buffers of
whole items (``geglu.BLOCK_M``) filled with NaN, must stay NaN.

The fused LayerNorm -> dense (bf16 and f32): the elementwise limit of
``ln_dense_error_limit``, 1.0625 (2 u_out |ref| + 2 C 2^-24 T + dY |W|^T),
T = |y| |W|^T + |b|: the output's rounding (u_out = 2^-8 in bf16, 2^-24 in
f32), the product's f32 sums in another order, and y's rounding flips, only
where the two f32 values of y can straddle a boundary (see there).  Rows
past M, written into a zeroed buffer of whole items (each kernel's
``BLOCK_M``), must stay 0.  bf16 takes the wgmma body for 16-byte rows and
the mma.sync body otherwise, by shape and alignment.

The planted-fault tests show that the limits fail a kernel that drops one
key tile or the ragged-edge mask (forward, each of its two bf16 bodies; the
CUDA-core body's bf16 instantiation dropping a key tile fails by 10x),
reads P v's B operand without wgmma's transpose bit, or writes lse without
its log l term or into another consumer's rows (the lse held to LSE_TOL),
skips the fifth 16-column k-step of S (d = 80), or, at d = 512, adds a
consumer's own partial scores twice or stores each consumer's output half
at the other's columns (forward; and in f32 at d = 512 drops the eighth
key tile, the ragged mask or the alpha rescale, sums one warp's partial
scores twice in place of another's, or merges one block's partial twice
where the keys split over a cluster), skips one query tile of dk/dv,
drops the ragged last key tile of dq or reads dv's B operand without
wgmma's transpose bit (backward; and in f32 at d = 64 drops dq's eighth key
tile, loses dk/dv's ragged query tile, takes delta as 0 in either kernel or
adds one block's partial twice in a cluster's merge), zeroes one hidden tile's h, swaps value
and gate, drops the ragged-row guard of the output (fused and two-pass) or
of the h scratch (rows past M must stay unwritten: their limit is 0),
leaves a consumer's half of h unwritten, reads the h buffer of the tile
before, or drops a hidden split from the sum in the GEGLU kernel, or skips the last K chunk, drops beta, leaves the last N
tile at N = 960 unwritten, writes rows past M or normalizes rows with
another row's statistics in the LayerNorm -> dense kernel (each by at
least 3x; a faulty output that is not finite fails outright).

The point-cloud metrics on the card against the port's CPU run of the same
clip (a synthetic 8 x 96 x 128 clip, its world points scaled, rotated,
shifted and noised as the prediction): the distance statistics v within
1e-5 max|q| + 2 E / v, E = 16 u max|q|^2, and the normal consistencies
within 1e-4, the bounds of tests/test_torch_pointcloud.py for the JAX
package against the port (f32 sums in other orders, cuSOLVER's SVD and
eigh for LAPACK's).  The camera metrics run in numpy f64 on the host
wherever the model ran (chip_smoke.py's metrics phase holds the card run's
CSV against the CPU run's).
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from unigeo_tpu_torch import _build
from unigeo_tpu_torch.device import set_exact_f32
from unigeo_tpu_torch.ops import attention, geglu
from unigeo_tpu_torch.ops.attention import (
    FlashAttentionPacked,
    _delta,
    attention_bwd_reference,
    attention_fwd_lse_reference,
    attention_packed_reference,
    bf16_error_limit,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_fwd_lse,
    flash_attention_packed,
    grad_error_limits,
)
from unigeo_tpu_torch.ops.geglu import geglu_error_limit, geglu_ffn, geglu_ffn_plain
from unigeo_tpu_torch.ops import ln_qkv
from unigeo_tpu_torch.ops.ln_qkv import ln_dense, ln_dense_error_limit, ln_dense_plain

pytestmark = pytest.mark.cuda

LSE_TOL = 1e-4  # the logsumexp, both dtypes (see above)
F32_OUT_TOL = 1e-5  # the f32 forward's output (see above)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    set_exact_f32()
    return torch.device("cuda")


def _qkv(b, sq, sk, h, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda s: torch.from_numpy(
        rng.standard_normal((b, s, h * d)).astype(np.float32)
    ).to(device=device, dtype=dtype)
    return mk(sq), mk(sk), mk(sk)


def _err_over_limit(out, q, k, v, h):
    """max over elements of |out - plain| / bf16 limit (fails above 1)."""
    ref = attention_packed_reference(q, k, v, h)
    limit = bf16_error_limit(q, k, v, h, ref)
    return ((out.float() - ref.float()).abs() / limit).max().item()


@pytest.mark.parametrize(
    "b,sq,sk,h,d",
    [
        (2, 70, 100, 3, 8),
        (2, 70, 100, 3, 10),
        (2, 130, 130, 2, 64),
        (2, 257, 257, 4, 80),
        (1, 200, 150, 1, 32),
        (1, 96, 77, 1, 512),
        # d = 512, the wide register-tiled body at the VAE mid block's 3072
        # tokens (48 items of 64 rows a batch entry, 192 key tiles)
        (2, 3072, 3072, 1, 512),
        # d = 64, the register-tiled body: ragged Sq and Sk (one partial key
        # tile; 257: the last tile holds one key; Sq below a block), the
        # pointmap shapes at small batch (the encoder unsplit, 12 heads) and
        # the decoder's single batch (its keys split over 4 blocks)
        (2, 70, 100, 3, 64),
        (1, 257, 257, 2, 64),
        (2, 130, 61, 2, 64),
        (1, 5, 300, 4, 64),
        (2, 768, 768, 12, 64),
        (1, 768, 768, 8, 64),
    ],
)
def test_kernel_matches_plain_f32(cuda, b, sq, sk, h, d):
    q, k, v = _qkv(b, sq, sk, h, d, torch.float32, cuda)
    before = flash_attention_packed.launches
    out = flash_attention_packed(q, k, v, h)
    torch.cuda.synchronize()
    assert flash_attention_packed.launches == before + 1
    ref = attention_packed_reference(q, k, v, h)
    err = (out - ref).abs().max().item()
    assert err < 1e-5, err


@pytest.mark.parametrize(
    "b,sq,sk,h,d",
    [
        (2, 70, 100, 3, 16),
        (1, 200, 150, 1, 16),
        (1, 200, 150, 1, 64),
        (2, 130, 61, 2, 64),
        (2, 257, 257, 4, 80),
        (1, 96, 77, 1, 512),
    ],
)
def test_kernel_matches_plain_bf16(cuda, b, sq, sk, h, d):
    q, k, v = _qkv(b, sq, sk, h, d, torch.bfloat16, cuda, seed=3)
    out = flash_attention_packed(q, k, v, h)
    torch.cuda.synchronize()
    ratio = _err_over_limit(out, q, k, v, h)
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize(
    "b,s,h,d",
    [(2, 3072, 5, 64), (2, 768, 10, 64), (2, 192, 20, 64), (2, 257, 16, 80),
     (1, 3072, 1, 512)],
)
def test_kernel_matches_plain_bf16_main_path_shapes(cuda, b, s, h, d):
    q, k, v = _qkv(b, s, s, h, d, torch.bfloat16, cuda)
    out = flash_attention_packed(q, k, v, h)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ratio = _err_over_limit(out, q, k, v, h)
    assert ratio <= 1.0, ratio


# textual faults planted in a copy of a kernel source: (file, anchor, replacement)
PLANTED_FAULTS = {
    # the forward, both wgmma bodies (the softmax step they share): the
    # eighth key tile's scores become -inf, so it adds to neither O nor l;
    # the ring still hands the tile over
    "drop_key_tile": (
        "flash_attention_packed.cu",
        "  return ragged && it == last ? softmax_tile<true, BK>",
        "  if (it == 7) for (float& x : s) x = -INFINITY;\n"
        "  return ragged && it == last ? softmax_tile<true, BK>",
    ),
    # forward, both wgmma bodies: the last tile's select goes, so the TMA's
    # zero key rows past Sk score 0 instead of -inf
    "no_ragged_mask": (
        "flash_attention_packed.cu",
        "      if (kMask) s[4 * j + e] = 8 * j + (e & 1) < lim ? s[4 * j + e] : -INFINITY;\n",
        "",
    ),
    # forward, wgmma body: P v reads v, its B operand, without wgmma's
    # transpose bit (as K-major, though the TMA lays it out MN-major)
    "wgmma_pv_no_transpose": (
        "flash_attention_packed.cu",
        "sm90::wgmma_rs<D, 1>(o, pa[i], Tile::mnmajor(vs, i, box), 1);",
        "sm90::wgmma_rs<D, 0>(o, pa[i], Tile::mnmajor(vs, i, box), 1);",
    ),
    # forward with lse, wgmma body: lse written without its log l term
    "lse_no_log_l": (
        "flash_attention_packed.cu",
        "(m[i] + log2f(l[i])) * kLn2;",
        "m[i] * kLn2;",
    ),
    # forward with lse, wgmma body: each consumer writes its lse into
    # another consumer's rows (row ^ 64; within the lse at Sq = 3072)
    "lse_wrong_consumer": (
        "flash_attention_packed.cu",
        "lse[lse_bh + row] =",
        "lse[lse_bh + (row ^ kWgRows)] =",
    ),
    # forward, wgmma body at D = 80 (five 16-column boxes a row): S = q k^T
    # skips its fifth k-step, the columns [64, 80) of the d-sum
    "skip_fifth_k_step": (
        "flash_attention_packed.cu",
        "    const int x = i / (W / 16), kk = i % (W / 16);  // box, k-step within it\n",
        "    if (i == 4) continue;\n"
        "    const int x = i / (W / 16), kk = i % (W / 16);  // box, k-step within it\n",
    ),
    # forward, D = 512 body: the trade reads the consumer's own partial
    # scores back, so S = S_c + S_c
    "trade_reads_own_partial": (
        "flash_attention_packed.cu",
        "    const float4 y = sm.x[par][c ^ 1][f][t];",
        "    const float4 y = sm.x[par][c][f][t];",
    ),
    # forward, D = 512 body: each consumer stores its output half at the
    # other's column offset
    "store_other_half": (
        "flash_attention_packed.cu",
        "(int64_t)h * kW5D + kW5Half * c,",
        "(int64_t)h * kW5D + kW5Half * (c ^ 1),",
    ),
    # forward, f32 body at d = 64: the eighth key tile's scores become
    # -inf, so it adds to neither O nor l; the ring still hands it over
    "f32reg_drop_key_tile": (
        "flash_attention_packed.cu",
        "    // the online softmax in log2 units; keys past Sk (the ragged last\n",
        "    if (t0 + it == 7)\n"
        "      for (auto& row : s)\n"
        "        for (float& x : row) x = -INFINITY;\n"
        "    // the online softmax in log2 units; keys past Sk (the ragged last\n",
    ),
    # forward, f32 body: the last tile's select goes, so the copies' zero
    # key rows past Sk score 0 instead of -inf
    "f32reg_no_ragged_mask": (
        "flash_attention_packed.cu",
        "s[i][j] = cl + 8 * j < lim ? s[i][j] : -INFINITY;",
        "s[i][j] = lim > 0 ? s[i][j] : -INFINITY;",
    ),
    # forward, f32 body: O is not rescaled by alpha when the running max
    # rises (l still is)
    "f32reg_no_rescale": (
        "flash_attention_packed.cu",
        "for (int c = 0; c < 8; ++c) acc[i][c] *= alpha[i];",
        "for (int c = 0; c < 8; ++c) acc[i][c] *= 1.f;",
    ),
    # forward, f32 body split over a cluster: the merge takes block 0's
    # partial O in place of block 1's (its m and l stay block 1's)
    "f32reg_merge_twice": (
        "flash_attention_packed.cu",
        "sm90::ld_cluster_f32x4(part + r * kRegD + x, sp);",
        "sm90::ld_cluster_f32x4(part + r * kRegD + x, sp == 1 ? 0 : sp);",
    ),
    # forward, f32 body at d = 512: the eighth key tile's scores become -inf
    # in its owners' softmax, so it adds to neither O nor l (the copies still
    # hand it over)
    "w512_drop_key_tile": (
        "flash_attention_packed.cu",
        "      float sc[4] = {x.x, x.y, x.z, x.w};\n",
        "      float sc[4] = {x.x, x.y, x.z, x.w};\n"
        "      if (t == 7) for (float& y : sc) y = -INFINITY;\n",
    ),
    # forward, f32 body at d = 512: the last tile's select goes, so the
    # copies' zero key rows past Sk score 0 instead of -inf
    "w512_no_ragged_mask": (
        "flash_attention_packed.cu",
        "sc[j] = ok + LK * j < lim ? sc[j] : -INFINITY;",
        "sc[j] = lim > 0 ? sc[j] : -INFINITY;",
    ),
    # forward, f32 body at d = 512: O is not rescaled by alpha when the
    # running max rises (l still is)
    "w512_no_rescale": (
        "flash_attention_packed.cu",
        "for (int c = 0; c < 16; ++c) acc[i][c] *= al[i];",
        "for (int c = 0; c < 16; ++c) acc[i][c] *= 1.f;",
    ),
    # forward, f32 body at d = 512: the owners' sum of the 8 partial scores
    # reads warp 0's partial twice, in place of warp 1's
    "w512_trade_reads_one_twice": (
        "flash_attention_packed.cu",
        "(src + w * Shape::kPartFloats);",
        "(src + (w == 1 ? 0 : w) * Shape::kPartFloats);",
    ),
    # forward, f32 body at d = 512, its keys split over a cluster: the merge
    # takes block 0's partial O in place of block 1's (its m and l stay
    # block 1's)
    "w512_merge_twice": (
        "flash_attention_packed.cu",
        "const float4 a = sm90::ld_cluster_f32x4(qs + r * kW512Pitch + 4 * x, sp);",
        "const float4 a = sm90::ld_cluster_f32x4(qs + r * kW512Pitch + 4 * x, sp == 1 ? 0 : sp);",
    ),
    # forward, the CUDA-core body instantiated for bf16: the eighth key
    # tile's scores become -inf, so it adds to neither O nor l (the f32
    # instantiation keeps every tile)
    "bf16_cuda_core_drop_key_tile": (
        "flash_attention_packed.cu",
        "    tmax = group_max<TPR>(tmax);\n",
        "    if (sizeof(T) == 2 && k0 == 7 * BK)\n"
        "      for (int j = 0; j < KPT; ++j) sc[j] = -INFINITY;\n"
        "    tmax = group_max<TPR>(tmax);\n",
    ),
    # backward: the tensor-core dk/dv kernel skips its eighth query tile
    # (the ring still hands the tile over, but it adds nothing to dk, dv)
    "skip_query_tile": (
        "flash_attention_bwd.cu",
        "st[4 * j + e] = 8 * j + (e & 1) < lim ? p : 0.f;",
        "st[4 * j + e] = 8 * j + (e & 1) < lim && it != 7 ? p : 0.f;",
    ),
    # backward: the tensor-core dq kernel loses its ragged key edge: its loop
    # stops at the last whole key tile, so the keys of the partial tile never
    # reach dq (dropping the key mask alone is no fault now: the TMA's zero
    # key rows add dS * 0 to dq)
    "dq_no_ragged_mask": (
        "flash_attention_bwd.cu",
        "const int n_tiles = (Sk + kTile - 1) / kTile;",
        "const int n_tiles = Sk / kTile;",
    ),
    # backward: the dk/dv kernel reads dO, dv's B operand, without wgmma's
    # transpose bit (as K-major, though the TMA lays it out MN-major)
    "dv_no_transpose": (
        "flash_attention_bwd.cu",
        "sm90::wgmma_rs<D, 1>(acc_v, pa[i], Tile::mnmajor(dos, i), 1);",
        "sm90::wgmma_rs<D, 0>(acc_v, pa[i], Tile::mnmajor(dos, i), 1);",
    ),
    # f32 backward at d = 64 (the register-tiled pair): the dq kernel's
    # eighth key tile gets P = 0, so it adds nothing to dq (the ring still
    # hands the tile over)
    "f32_bwd_dq_drop_key_tile": (
        "flash_attention_bwd.cu",
        "const float p = exp2_approx(fmaf(s[i][j], scale_log2, -lse2[i]));",
        "const float p = t0 + it == 7 ? 0.f : exp2_approx(fmaf(s[i][j], scale_log2, -lse2[i]));",
    ),
    # f32 backward: the dk/dv kernel loses its ragged query edge: its loop
    # stops at the last whole query tile, so the queries of the partial tile
    # never reach dk and dv (dropping the query mask alone is no fault: the
    # copies' zero query rows add P^T 0 to dv and dS^T = 0 to dk)
    "f32_bwd_dkv_no_ragged_mask": (
        "flash_attention_bwd.cu",
        "const int n_all = (Sq + kBwdBK - 1) / kBwdBK;",
        "const int n_all = Sq / kBwdBK;",
    ),
    # f32 backward: delta = rowsum(dO * O) taken as 0 by the dq kernel, and
    # by the dk/dv kernel
    "f32_bwd_dq_delta_zero": (
        "flash_attention_bwd.cu",
        "dlt[i] = ok ? delta_bh[row] * scale : 0.f;",
        "dlt[i] = 0.f;",
    ),
    "f32_bwd_dkv_delta_zero": (
        "flash_attention_bwd.cu",
        "dl[j] = ok ? delta_bh[qi] * scale : 0.f;",
        "dl[j] = 0.f;",
    ),
    # f32 backward split over a cluster (both kernels): the merge adds block
    # 0's partial in place of block 1's
    "f32_bwd_merge_twice": (
        "flash_attention_bwd.cu",
        "const float4 a = sm90::ld_cluster_f32x4(part + r * kBwdD + x, sp);",
        "const float4 a = sm90::ld_cluster_f32x4(part + r * kBwdD + x, sp == 1 ? 0 : sp);",
    ),
    # GEGLU: the third hidden tile's h is zero, so it adds nothing to the
    # down-projection (the ring still hands the tile over)
    "geglu_skip_hidden_tile": (
        "geglu_ffn.cu",
        "const float v0 = upa[4 * jj + 2 * i] + bv0, v1 = upa[4 * jj + 2 * i + 1] + bv1;",
        "const float v0 = j == 2 ? 0.f : upa[4 * jj + 2 * i] + bv0,\n"
        "                      v1 = j == 2 ? 0.f : upa[4 * jj + 2 * i + 1] + bv1;",
    ),
    # GEGLU: g * gelu(v) instead of v * gelu(g)
    "geglu_swap_value_gate": (
        "geglu_ffn.cu",
        "pack_bf16x2(v0 * gelu_tanh(q0), v1 * gelu_tanh(q1))",
        "pack_bf16x2(q0 * gelu_tanh(v0), q1 * gelu_tanh(v1))",
    ),
    # GEGLU: rows past M are stored too, by the fused pass (their outputs
    # come from the biases) or the down pass (zeros: h past M loads as
    # zeros); held at shapes whose plan takes one hidden split, since the
    # splits' partials end at row M
    "geglu_no_ragged_mask": (
        "geglu_ffn.cu",
        "      if (row >= M) continue;\n",
        "",
    ),
    # GEGLU: the up-projection pass stores h rows past M too, past the end
    # of the h scratch
    "geglu_h_rows_past_m": (
        "geglu_ffn.cu",
        "} else if (item.m0 + row < M) {",
        "} else {",
    ),
    # GEGLU: consumer 1 never writes its half of h, which keeps whatever the
    # buffer held
    "geglu_half_h_unwritten": (
        "geglu_ffn.cu",
        "*reinterpret_cast<uint32_t*>(hs + row * 128 + ((2 * col) ^ ((row & 7) << 4))) = hv;",
        "if (c == 0) *reinterpret_cast<uint32_t*>(hs + row * 128 + ((2 * col) ^ ((row & 7) << 4))) = hv;",
    ),
    # GEGLU: a tile's down-projection reads the other h buffer, where both
    # consumers' halves of the tile before it lie
    "geglu_stale_h_tile": (
        "geglu_ffn.cu",
        "const __nv_bfloat16* hts = h_tile(MODE == kFused ? ht % kHTiles : hr.slot);",
        "const __nv_bfloat16* hts = h_tile(MODE == kFused ? (ht + 1) % kHTiles : hr.slot);",
    ),
    # GEGLU: the split sum drops the last hidden split
    "geglu_drop_split": (
        "geglu_ffn.cu",
        "for (int sp = 1; sp < splits; ++sp) {",
        "for (int sp = 1; sp < splits - 1; ++sp) {",
    ),
    # LayerNorm -> dense (bf16 wgmma body): the last 32-column chunk of C
    # never reaches the product (the ring still hands it over)
    "ln_skip_last_k_tile": (
        "ln_dense.cu",
        "        for (int i = 0; i < kWgKC / 16; ++i)\n",
        "        for (int i = 0; i < kWgKC / 16 && kc < n_kc - 1; ++i)\n",
    ),
    # LayerNorm -> dense (bf16 wgmma body): beta is not added
    "ln_skip_beta": (
        "ln_dense.cu",
        "y[j] = (v[j] - st.x) * st.y * gv[j] + bv[j];",
        "y[j] = (v[j] - st.x) * st.y * gv[j];",
    ),
    # LayerNorm -> dense (bf16 wgmma body): the N tiles stop at the last
    # whole one below N, so N = 960 leaves its last tile of 320 unwritten
    "ln_last_n_tile_unwritten": (
        "ln_dense.cu",
        "const int n_tiles = (N + kWgBN - 1) / kWgBN, n_kc",
        "const int n_tiles = (N - 1) / kWgBN, n_kc",
    ),
    # LayerNorm -> dense (bf16 wgmma body): rows past M are stored too
    "ln_rows_past_m": (
        "ln_dense.cu",
        "          if (row >= M) continue;  // rows past M are not stored\n",
        "",
    ),
    # LayerNorm -> dense (bf16 wgmma body): each row is normalized with the
    # statistics of the row 8 away in its block of 64, which the same warp
    # normalizes just before or after it
    "ln_other_rows_stats": (
        "ln_dense.cu",
        "const float2 st = row_stats(r);",
        "const float2 st = row_stats(r ^ 8);",
    ),
}


@pytest.fixture(scope="module")
def faulty_libraries(tmp_path_factory):
    """One library per planted fault, built from a copy of every kernel
    source with one of them mutated, in a temporary directory; the builds
    go in parallel, as many at once as the host has cores (each runs one
    nvcc per source at once: every build at once left each nvcc so small a
    share of the cores that the slowest passed its time limit)."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    root = tmp_path_factory.mktemp("planted")
    jobs = {}
    for name, (fname, anchor, faulty) in PLANTED_FAULTS.items():
        src = os.path.join(_build.CSRC_DIR, fname)
        with open(src) as f:
            text = f.read()
        assert text.count(anchor) == 1, f"{name}: anchor not found once in {src}"
        work = root / name
        shutil.copytree(_build.CSRC_DIR, work)
        (work / fname).write_text(text.replace(anchor, faulty))
        cu = sorted(str(p) for p in work.glob("*.cu"))
        jobs[name] = (cu, str(work / "libfaulty.so"))
    with ThreadPoolExecutor(min(len(jobs), os.cpu_count() or 1)) as pool:
        list(pool.map(lambda j: _build.compile_library(*j), jobs.values()))
    return {name: _build.open_library(out) for name, (_, out) in jobs.items()}


@pytest.mark.parametrize(
    "fault,b,s,h,d",
    [
        # the forward at the UNet's stage 0, the VAE's and CLIP's head
        # widths 512 and 80, and ragged shapes (S = 257: the last key tile
        # holds one key and 127, 63 or 31 zero rows at d 64, 80 and 512)
        ("drop_key_tile", 2, 3072, 5, 64),
        ("drop_key_tile", 1, 3072, 1, 512),
        ("drop_key_tile", 2, 1024, 16, 80),
        ("no_ragged_mask", 2, 257, 4, 64),
        ("no_ragged_mask", 2, 257, 16, 80),
        ("no_ragged_mask", 2, 257, 1, 512),
        ("skip_fifth_k_step", 2, 257, 16, 80),
        ("trade_reads_own_partial", 1, 3072, 1, 512),
        ("store_other_half", 1, 3072, 1, 512),
        ("wgmma_pv_no_transpose", 2, 3072, 5, 64),
        ("lse_no_log_l", 2, 3072, 5, 64),
        ("lse_wrong_consumer", 2, 3072, 5, 64),
        ("skip_query_tile", 2, 3072, 5, 64),
        ("dq_no_ragged_mask", 2, 257, 4, 64),
        ("dv_no_transpose", 2, 3072, 5, 64),
        # the f32 body at d = 64 (held to F32_OUT_TOL): Spann3R's encoder
        # at batch 2 (unsplit, 12 key tiles), its decoder (keys split over 4
        # blocks), and S = 257 (the last key tile holds one key and 63 zero
        # rows; split over 4 blocks)
        ("f32reg_drop_key_tile", 2, 768, 12, 64),
        ("f32reg_drop_key_tile", 1, 768, 8, 64),
        # Aether's DiT: one sequence of 3072 tokens (48 key tiles, unsplit)
        ("f32reg_drop_key_tile", 1, 3072, 12, 64),
        ("f32reg_no_ragged_mask", 2, 257, 4, 64),
        ("f32reg_no_rescale", 2, 768, 12, 64),
        ("f32reg_merge_twice", 1, 768, 8, 64),
        # the f32 body at d = 512 (held to F32_OUT_TOL): the VAE mid block's
        # 3072 tokens (192 key tiles of 16), and S = 257 (the last key tile
        # holds one key and 15 zero rows)
        ("w512_drop_key_tile", 1, 3072, 1, 512),
        ("w512_no_ragged_mask", 2, 257, 1, 512),
        ("w512_no_rescale", 1, 3072, 1, 512),
        ("w512_no_rescale", 2, 257, 1, 512),
        ("w512_trade_reads_one_twice", 1, 3072, 1, 512),
        # one sequence of 1024 tokens: 16 items, their keys split over
        # clusters of 8 blocks
        ("w512_merge_twice", 1, 1024, 1, 512),
        # GEGLU at (M, C) = (b * s, h * d): the UNet's stage 0 (the fused
        # pass, where h lives in shared memory), stage 2 and its ragged mid
        # block (two passes; M = 1200, 18.75 row blocks, three hidden splits
        # by the kernel's plan), and ragged shapes whose plan takes one
        # hidden split: M = 76784 at C = 320 (the fused pass; 600 pairs of
        # row blocks, 16 rows past M) and M = 19184 at C = 640 (two passes)
        ("geglu_skip_hidden_tile", 25, 3072, 5, 64),
        ("geglu_swap_value_gate", 25, 192, 20, 64),
        ("geglu_no_ragged_mask", 1, 76784, 5, 64),
        ("geglu_no_ragged_mask", 1, 19184, 10, 64),
        ("geglu_h_rows_past_m", 1, 19184, 10, 64),
        ("geglu_half_h_unwritten", 25, 3072, 5, 64),
        ("geglu_stale_h_tile", 25, 3072, 5, 64),
        ("geglu_drop_split", 25, 48, 20, 64),
    ],
)
def test_limit_fails_planted_faults(cuda, faulty_libraries, fault, b, s, h, d):
    """At the main-path (or ragged) shapes, the kernel passes its bf16 limit
    and a copy of it with a planted fault fails it by at least 3x."""
    lib = faulty_libraries[fault]
    if PLANTED_FAULTS[fault][0] == "geglu_ffn.cu":
        return _geglu_planted(cuda, lib, fault, m=b * s, c=h * d)
    if fault.startswith(("f32reg_", "w512_")):
        return _f32_planted(cuda, lib, fault, b, s, h, d)
    q, k, v = _qkv(b, s, s, h, d, torch.bfloat16, cuda, seed=5)
    if fault.startswith("lse_"):
        # the lse entry point: max of the output's err/limit and the lse's
        # error over LSE_TOL
        good = _fwd_lse_ratio(*flash_attention_fwd_lse(q, k, v, h), q, k, v, h)
        lse = torch.empty((b, h, s), dtype=torch.float32, device=cuda)
        bad_out = attention._launch(lib, q, k, v, h, d**-0.5, lse=lse)
        bad = _fwd_lse_ratio(bad_out, lse, q, k, v, h)
    elif PLANTED_FAULTS[fault][0] == "flash_attention_packed.cu":
        good = _err_over_limit(flash_attention_packed(q, k, v, h), q, k, v, h)
        bad_out = attention._launch(lib, q, k, v, h, d**-0.5)
        bad = _err_over_limit(bad_out, q, k, v, h)
    else:
        out, lse, dout = _fwd_and_dout(q, k, v, h, seed=6)
        delta = _delta(out, dout, h)
        good = max(_grad_ratios(flash_attention_bwd(q, k, v, out, lse, dout, h),
                                q, k, v, out, lse, dout, h))
        bad_dq = attention._launch_bwd_dq(lib, q, k, v, dout, lse, delta, h, d**-0.5)
        bad_dk, bad_dv = attention._launch_bwd_dkv(lib, q, k, v, dout, lse, delta, h, d**-0.5)
        bad = max(_grad_ratios((bad_dq, bad_dk, bad_dv), q, k, v, out, lse, dout, h))
    print(f"planted {fault} [B={b},S={s},H={h},D={d}]: max err/limit "
          f"kernel {good:.3f}, faulty copy {bad:.3f}", flush=True)
    assert good <= 1.0 and bad >= 3.0, (good, bad)


@pytest.mark.parametrize(
    "fault,b,sq,sk,h,d",
    [
        # the f32 training paths: Spann3R's encoder at batch 2 and Aether's
        # DiT (12 and 48 key tiles, unsplit); VideoDepthAnything's 972 tokens
        # (15 query tiles and 12 rows: a ragged query edge); Cut3R's frame-
        # to-state cross-attention (768 queries, 64 keys: dk/dv's query
        # tiles split over 8 blocks); the decoders' [1, 768, 8, 64] (both
        # kernels split over 2 blocks)
        ("f32_bwd_dq_drop_key_tile", 2, 768, 768, 12, 64),
        ("f32_bwd_dq_drop_key_tile", 1, 3072, 3072, 12, 64),
        ("f32_bwd_dkv_no_ragged_mask", 2, 972, 972, 16, 64),
        ("f32_bwd_dq_delta_zero", 1, 768, 64, 8, 64),
        ("f32_bwd_dq_delta_zero", 2, 768, 768, 12, 64),
        ("f32_bwd_dkv_delta_zero", 1, 768, 64, 8, 64),
        ("f32_bwd_dkv_delta_zero", 2, 972, 972, 16, 64),
        ("f32_bwd_merge_twice", 1, 768, 768, 8, 64),
        ("f32_bwd_merge_twice", 1, 768, 64, 8, 64),
    ],
)
def test_f32_bwd_limit_fails_planted_faults(cuda, faulty_libraries, fault, b, sq, sk, h, d):
    """The f32 backward pair passes its limits (grad_error_limits in f32)
    at the training shapes, and a copy with a planted fault fails them by at
    least 3x.  Cut3R's [1, 768 -> 64, 8, 64] has no ragged edge for the
    64-row tiles (12 query tiles, one key tile), so the dk/dv kernel's query
    edge is held at VideoDepthAnything's 972 tokens."""
    lib = faulty_libraries[fault]
    q, k, v = _qkv(b, sq, sk, h, d, torch.float32, cuda, seed=5)
    out, lse, dout = _fwd_and_dout(q, k, v, h, seed=6)
    delta = _delta(out, dout, h)
    good = max(_grad_ratios(flash_attention_bwd(q, k, v, out, lse, dout, h),
                            q, k, v, out, lse, dout, h))
    bad_dq = attention._launch_bwd_dq(lib, q, k, v, dout, lse, delta, h, d**-0.5)
    bad_dk, bad_dv = attention._launch_bwd_dkv(lib, q, k, v, dout, lse, delta, h, d**-0.5)
    ratios = _grad_ratios((bad_dq, bad_dk, bad_dv), q, k, v, out, lse, dout, h)
    bad = max(r if np.isfinite(r) else float("inf") for r in ratios)
    print(f"planted {fault} [B={b},Sq={sq},Sk={sk},H={h},D={d}]: max err/limit "
          f"kernel {good:.3f}, faulty copy {bad:.3f} (dq, dk, dv {ratios})", flush=True)
    assert good <= 1.0 and bad >= 3.0, (good, ratios)


@pytest.mark.parametrize("b,s,h,d", [(2, 768, 2, 32), (1, 1024, 2, 24), (1, 600, 1, 128)])
def test_bf16_cuda_core_limit_fails_planted_fault(cuda, faulty_libraries, b, s, h, d):
    """The bf16 CUDA-core body passes bf16_cuda_core_error_limit and a copy
    that drops its eighth key tile fails it by at least 10x; the same copy's
    f32 instantiation, untouched, still passes F32_OUT_TOL."""
    lib = faulty_libraries["bf16_cuda_core_drop_key_tile"]
    q, k, v = _qkv(b, s, s, h, d, torch.bfloat16, cuda, seed=5)
    good = _cuda_core_ratio(flash_attention_packed(q, k, v, h), q, k, v, h)
    bad = _cuda_core_ratio(attention._launch(lib, q, k, v, h, d**-0.5), q, k, v, h)
    qf, kf, vf = q.float(), k.float(), v.float()
    f32 = _f32_ratio(attention._launch(lib, qf, kf, vf, h, d**-0.5), qf, kf, vf, h)
    print(f"planted bf16_cuda_core_drop_key_tile [B={b},S={s},H={h},D={d}]: max err/limit "
          f"kernel {good:.3f}, faulty copy {bad:.3f} (its f32 instantiation {f32:.3f})",
          flush=True)
    assert good <= 1.0 and bad >= 10.0 and f32 <= 1.0, (good, bad, f32)


def _f32_ratio(out, q, k, v, h):
    """max |out - plain| / F32_OUT_TOL (inf where out is not finite)."""
    torch.cuda.synchronize()
    err = (out - attention_packed_reference(q, k, v, h)).abs().max().item()
    return err / F32_OUT_TOL if np.isfinite(err) else float("inf")


def _f32_planted(cuda, lib, fault, b, s, h, d):
    """The f32 body passes F32_OUT_TOL and its faulty copy misses it by 3x,
    through the packed and the lse entry points."""
    q, k, v = _qkv(b, s, s, h, d, torch.float32, cuda, seed=5)
    good = _f32_ratio(flash_attention_packed(q, k, v, h), q, k, v, h)
    bad = _f32_ratio(attention._launch(lib, q, k, v, h, d**-0.5), q, k, v, h)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=cuda)
    bad_lse = _f32_ratio(attention._launch(lib, q, k, v, h, d**-0.5, lse=lse), q, k, v, h)
    print(f"planted {fault} [B={b},S={s},H={h},D={d}]: max err/1e-5 "
          f"kernel {good:.3f}, faulty copy {bad:.3f} (lse entry {bad_lse:.3f})", flush=True)
    assert good <= 1.0 and bad >= 3.0 and bad_lse >= 3.0, (good, bad, bad_lse)


def _fwd_lse_ratio(out, lse, q, k, v, h):
    """max of the output's err/limit and the lse's max abs error / LSE_TOL."""
    torch.cuda.synchronize()
    _, ref_lse = attention_fwd_lse_reference(q, k, v, h)
    return max(_err_over_limit(out, q, k, v, h),
               (lse - ref_lse).abs().max().item() / LSE_TOL)


def _misaligned(x):
    """x's values in a contiguous tensor whose base is 2 bytes past a 16-byte
    boundary (the TMA cannot take it)."""
    y = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape)
    assert y.is_contiguous() and y.data_ptr() % 16 != 0
    return y


def _cuda_core_ratio(out, q, k, v, h):
    """max over elements of |out - plain| / the CUDA-core body's bf16 limit."""
    torch.cuda.synchronize()
    ref = attention_packed_reference(q, k, v, h)
    limit = attention.bf16_cuda_core_error_limit(q, k, v, h, ref)
    return ((out.float() - ref.float()).abs() / limit).max().item()


def test_kernel_rejects_what_it_does_not_take(cuda):
    """f16, d > 512 and strided rows are refused.  bf16 at d = 8 (no wgmma
    body) and bf16 rows not aligned to 16 bytes (the TMA cannot take them),
    refused until the CUDA-core body took bf16, now run on it within its
    limit."""
    q, k, v = _qkv(1, 128, 128, 2, 64, torch.float16, cuda)
    with pytest.raises(ValueError):
        flash_attention_packed(q, k, v, 2)
    q, k, v = _qkv(1, 128, 128, 1, 640, torch.float32, cuda)
    with pytest.raises(ValueError):
        flash_attention_packed(q, k, v, 1)
    q, k, v = _qkv(1, 128, 128, 2, 64, torch.float32, cuda)
    with pytest.raises(ValueError):
        flash_attention_packed(q[:, ::2], k[:, ::2], v[:, ::2], 2)
    q, k, v = _qkv(1, 128, 128, 3, 8, torch.bfloat16, cuda)
    assert attention.bf16_fwd_on_cuda_core(q, k, v, 8)
    assert _cuda_core_ratio(flash_attention_packed(q, k, v, 3), q, k, v, 3) <= 1.0
    b, s, h, d = 1, 150, 2, 64
    q, k, v = (_misaligned(x) for x in _qkv(b, s, s, h, d, torch.bfloat16, cuda))
    assert attention.bf16_fwd_on_cuda_core(q, k, v, d)
    assert _cuda_core_ratio(flash_attention_packed(q, k, v, h), q, k, v, h) <= 1.0


# bf16 on the CUDA-core body: the tiny pointmap configs' 24 and 32 (a
# [2, 768, 2, 32] attention), 128, ragged shapes, the checks' 8, and the
# wgmma widths with rows not aligned to 16 bytes
BF16_CUDA_CORE_CASES = [
    (2, 768, 768, 2, 24, False),
    (2, 768, 768, 2, 32, False),
    (2, 130, 61, 3, 32, False),
    (1, 257, 257, 4, 128, False),
    (2, 70, 100, 3, 8, False),
    (1, 96, 77, 1, 200, False),
    (1, 150, 150, 2, 64, True),
    (2, 257, 100, 4, 16, True),
    (1, 257, 257, 4, 80, True),
    (1, 130, 96, 1, 512, True),
]


@pytest.mark.parametrize("b,sq,sk,h,d,shifted", BF16_CUDA_CORE_CASES)
def test_bf16_cuda_core_forward_matches_plain_bitwise(cuda, b, sq, sk, h, d, shifted):
    """bf16 the wgmma bodies do not take runs the CUDA-core body
    (flash_{packed,headsplit,fwd_lse}_kernel<__nv_bfloat16, ...>, by the
    profiler's kernel names) within bf16_cuda_core_error_limit, its lse
    within LSE_TOL; two launches give the same bits, and the head-split
    entry the packed entry's bits."""
    q, k, v = _qkv(b, sq, sk, h, d, torch.bfloat16, cuda, seed=31)
    if shifted:
        q, k, v = (_misaligned(x) for x in (q, k, v))
    assert attention.bf16_fwd_on_cuda_core(q, k, v, d)
    heads = lambda x: x.view(b, x.shape[1], h, d)
    run = lambda: (flash_attention_packed(q, k, v, h), *flash_attention_fwd_lse(q, k, v, h),
                   flash_attention(heads(q), heads(k), heads(v)).reshape(q.shape))
    launched = _f32reg_launches(run, iters=2)
    for name in ("flash_packed_kernel<__nv_bfloat16", "flash_fwd_lse_kernel<__nv_bfloat16",
                 "flash_headsplit_kernel<__nv_bfloat16"):
        assert any(name in key for key, _ in launched), launched
    first, second = run(), run()
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)
    out, out_lse, lse, out_hs = first
    assert torch.equal(out, out_lse) and torch.equal(out, out_hs)
    assert _cuda_core_ratio(out, q, k, v, h) <= 1.0
    _, ref_lse = attention_fwd_lse_reference(q, k, v, h)
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL


@pytest.mark.parametrize("b,sq,sk,h,d,shifted", [
    (2, 768, 768, 2, 32, False),
    (2, 257, 257, 16, 80, False),
    (2, 130, 61, 3, 24, False),
    (1, 200, 150, 2, 128, False),
    (2, 130, 61, 2, 64, True),
    (1, 100, 70, 3, 16, True),
])
def test_bf16_cuda_core_backward_matches_plain_bitwise(cuda, b, sq, sk, h, d, shifted):
    """The bf16 backward pair outside the wgmma widths (CLIP's 80 when a
    trainer unfreezes it, the tiny pointmap widths, 128) and with rows not
    aligned to 16 bytes runs bwd_{dq,dkv}_f32_kernel<__nv_bfloat16, ...>
    (by kernel name) within grad_error_limits(cuda_core=True); two launches
    give the same bits."""
    q, k, v = _qkv(b, sq, sk, h, d, torch.bfloat16, cuda, seed=32)
    out, lse, dout = _fwd_and_dout(q, k, v, h, seed=33)
    if shifted:
        q, k, v, dout = (_misaligned(x) for x in (q, k, v, dout))
    assert attention.bf16_bwd_on_cuda_core(q, k, v, dout, d)
    run = lambda: flash_attention_bwd(q, k, v, out, lse, dout, h)
    launched = _f32reg_launches(run, part="bwd_", iters=2)
    for name in ("bwd_dq_f32_kernel<__nv_bfloat16", "bwd_dkv_f32_kernel<__nv_bfloat16"):
        assert any(name in key for key, _ in launched), launched
    first, second = run(), run()
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)
    refs = attention_bwd_reference(q, k, v, out, lse, dout, h)
    limits = grad_error_limits(q, k, v, out, lse, dout, h, refs, cuda_core=True)
    for g, r, lim in zip(first, refs, limits):
        assert ((g.float() - r.float()).abs() / lim).max().item() <= 1.0


def test_wider_heads_still_raise(cuda):
    """What no body takes: the forward past d = 512 and the backward past
    d = 128, in both dtypes."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(1, 128, 128, 1, 520, dtype, cuda)
        with pytest.raises(ValueError):
            flash_attention_packed(q, k, v, 1)
        q, k, v = _qkv(1, 128, 128, 1, 136, dtype, cuda)
        out, lse, dout = _fwd_and_dout(q, k, v, 1, seed=34)
        with pytest.raises(ValueError):
            flash_attention_bwd(q, k, v, out, lse, dout, 1)


@pytest.mark.parametrize("b,sq,sk,h,d", [(2, 3072, 3072, 5, 64), (2, 257, 100, 4, 16),
                                         (2, 257, 257, 16, 80), (2, 257, 257, 1, 512),
                                         (2, 130, 61, 16, 80)])
def test_fwd_kernels_are_bitwise_reproducible(cuda, b, sq, sk, h, d):
    """Each output element (and each lse) is written by one block, once:
    two launches of the packed and of the lse forward give the same bits."""
    q, k, v = _qkv(b, sq, sk, h, d, torch.bfloat16, cuda, seed=19)
    first = (flash_attention_packed(q, k, v, h), *flash_attention_fwd_lse(q, k, v, h))
    second = (flash_attention_packed(q, k, v, h), *flash_attention_fwd_lse(q, k, v, h))
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def _f32reg_launches(fn, part="flash_", iters=5):
    """The kernels whose names hold ``part`` (the f32 forward's by default,
    ``bwd_`` the backward's) that ``iters`` calls of ``fn()`` launched, by
    torch.profiler: [(name, template arguments of an f32reg body or None)].
    A trace can lose the first records of its window (a one-call window
    came back empty or without its second kernel on the card): over
    several calls every kernel a call launches is still seen."""
    import re

    from unigeo_tpu_torch.tools.forward_variants import _profiled_kernels

    found = []
    for e in _profiled_kernels(fn, iters):
        if part in e.key:
            m = re.search(r"f32reg_kernel<(\d+), (\d+), (\d+)>", e.key)
            found.append((e.key, tuple(int(x) for x in m.groups()) if m else None))
    return found


@pytest.mark.parametrize("b,sq,sk,h", [(2, 768, 768, 12), (1, 768, 768, 8), (2, 130, 61, 2)])
def test_f32_d64_runs_the_register_tiled_body_bitwise(cuda, b, sq, sk, h):
    """f32 at d = 64: the packed, head-split and lse entries run
    flash_{packed,headsplit,fwd_lse}_f32reg_kernel<kWarps, kStages, kSplit>
    (by the profiler's kernel names), whose grid gives every SM a block
    where the items allow (the decoder's 96 items of 64 rows do not: its
    keys split over a cluster); two launches give the same bits."""
    q, k, v = _qkv(b, sq, sk, h, 64, torch.float32, cuda, seed=23)
    heads = lambda x: x.view(b, x.shape[1], h, 64)
    run = lambda: (flash_attention_packed(q, k, v, h), *flash_attention_fwd_lse(q, k, v, h),
                   flash_attention(heads(q), heads(k), heads(v)).reshape(q.shape))
    launched = _f32reg_launches(run)
    names = " ".join(name for name, _ in launched)
    for entry in ("flash_packed_f32reg_kernel", "flash_fwd_lse_f32reg_kernel",
                  "flash_headsplit_f32reg_kernel"):
        assert entry in names, launched
    assert all(args is not None for _, args in launched), launched
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    warps, _, split = launched[0][1]
    items = -(-sq // (16 * warps)) * h * b
    if sk > 64:  # more than one key tile: the plan can fill the card
        assert items * split >= min(sms, 4 * items), (launched, sms)
    first, second = run(), run()
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_f32_other_widths_keep_the_earlier_body(cuda):
    """f32 at d = 32 and 80 runs flash_packed_kernel<BQ, BK, NCOL> as before;
    f32 at d = 64 with rows not aligned to 16 bytes is refused (the wrapper
    raises, and the library refuses the launch: no other body is tried)."""
    for d in (32, 80):
        q, k, v = _qkv(1, 200, 150, 2, d, torch.float32, cuda, seed=24)
        launched = _f32reg_launches(lambda: flash_attention_packed(q, k, v, 2))
        assert [args for _, args in launched] == [None], launched
        assert "flash_packed_kernel<" in launched[0][0], launched
    b, s, h, d = 1, 150, 2, 64
    q, k, v = _qkv(b, s, s, h, d, torch.float32, cuda, seed=25)
    shift = lambda x: torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(b, s, h * d)
    qs, ks, vs = shift(q), shift(k), shift(v)
    assert qs.is_contiguous() and qs.data_ptr() % 16 != 0
    with pytest.raises(ValueError):
        flash_attention_packed(qs, ks, vs, h)
    with pytest.raises(RuntimeError):
        attention._launch(_build.load_library(), qs, ks, vs, h, d**-0.5)


@pytest.mark.parametrize("b,sq,sk,h", [(1, 96, 77, 1), (2, 3072, 3072, 1), (1, 130, 61, 2),
                                       (2, 257, 257, 1)])
def test_f32_d512_runs_the_wide_body_bitwise(cuda, b, sq, sk, h):
    """f32 at d = 512: the packed, head-split and lse entries run
    flash_{packed,headsplit,fwd_lse}_f32w512_kernel (by the profiler's
    kernel names), each within F32_OUT_TOL of the plain version (the lse
    within LSE_TOL), and two launches give the same bits; one block an item,
    or (257 tokens: 10 items) the keys split over 8-block clusters."""
    d = 512
    q, k, v = _qkv(b, sq, sk, h, d, torch.float32, cuda, seed=26)
    heads = lambda x: x.view(b, x.shape[1], h, d)
    run = lambda: (flash_attention_packed(q, k, v, h), *flash_attention_fwd_lse(q, k, v, h),
                   flash_attention(heads(q), heads(k), heads(v)).reshape(q.shape))
    launched = [name for name, _ in _f32reg_launches(run)]
    for entry in ("flash_packed_f32w512_kernel", "flash_fwd_lse_f32w512_kernel",
                  "flash_headsplit_f32w512_kernel"):
        assert any(entry in name for name in launched), launched
    assert all("f32w512_kernel" in name for name in launched), launched
    first, second = run(), run()
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)
    ref, ref_lse = attention_fwd_lse_reference(q, k, v, h)
    for out in (first[0], first[1], first[3]):
        err = (out - ref).abs().max().item()
        assert err < F32_OUT_TOL, err
    assert (first[2] - ref_lse).abs().max().item() < LSE_TOL


@pytest.mark.parametrize("b,s", [(25, 3072), (1, 1024)])
def test_f32_d512_splits_the_items_left_over(cuda, b, s):
    """The host plan runs the whole rounds of items one block an item and
    splits the keys of the items left over across a cluster
    (attention.f32_d512_plan): at the VAE mid block's [25, 3072, 1, 512]
    1188 items, then 12 over 8-block clusters; at [1, 1024, 1, 512] 16 items
    over 8-block clusters; by the profiler's kernel names (template
    arguments <16, split>); the output and the lse within their limits, two
    launches bitwise equal."""
    import re

    h, d = 1, 512
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    whole, rest, split = attention.f32_d512_plan(b, s, s, h, sms)
    q, k, v = _qkv(b, s, s, h, d, torch.float32, cuda, seed=28)
    launched = [name for name, _ in _f32reg_launches(lambda: flash_attention_fwd_lse(q, k, v, h))]
    splits = sorted({int(re.search(r"f32w512_kernel<16, (\d+)>", n).group(1)) for n in launched})
    expected = ({1} if whole else set()) | ({split} if rest else set())
    assert splits == sorted(expected), (launched, whole, rest)
    first, second = flash_attention_fwd_lse(q, k, v, h), flash_attention_fwd_lse(q, k, v, h)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    idx = sorted({0, b - 1})  # the first and the last batch entry (the split items)
    ref, ref_lse = attention_fwd_lse_reference(q[idx], k[idx], v[idx], h)
    assert (first[0][idx] - ref).abs().max().item() < F32_OUT_TOL
    assert (first[1][idx] - ref_lse).abs().max().item() < LSE_TOL


def test_f32_d512_refuses_rows_not_aligned_to_16_bytes(cuda):
    """f32 at d = 512 with rows not aligned to 16 bytes is refused: the
    wrapper raises, and the library refuses the launch (no other body is
    tried)."""
    b, s, h, d = 1, 150, 1, 512
    q, k, v = _qkv(b, s, s, h, d, torch.float32, cuda, seed=27)
    shift = lambda x: torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(b, s, h * d)
    qs, ks, vs = shift(q), shift(k), shift(v)
    assert qs.is_contiguous() and qs.data_ptr() % 16 != 0
    with pytest.raises(ValueError):
        flash_attention_packed(qs, ks, vs, h)
    with pytest.raises(ValueError):
        flash_attention_fwd_lse(qs, ks, vs, h)
    lib = _build.load_library()
    with pytest.raises(RuntimeError):
        attention._launch(lib, qs, ks, vs, h, d**-0.5)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=cuda)
    with pytest.raises(RuntimeError):
        attention._launch(lib, qs, ks, vs, h, d**-0.5, lse=lse)


def test_f32_d512_body_compiles_to_fma_and_16_byte_loads(cuda):
    """What ptxas and cuobjdump show of the three f32w512 kernels
    (tools/kernel_report.py): no spill (0 bytes, no local loads or stores),
    no tensor-core instruction (so no TF32 product), f32 FMAs, 16-byte
    shared loads (LDS.128) and the TMA's bulk copies (UBLKCP); it prints
    each kernel's registers and FFMA share."""
    from unigeo_tpu_torch.tools import kernel_report

    kernels = kernel_report.main(["--match", "f32w512"])["kernels"]
    assert len(kernels) >= 3, kernels
    for name, rep in kernels.items():
        sass = rep["sass"]
        print(f"{name}: {rep.get('registers')} registers, FFMA share {rep['ffma_share']:.3f}",
              flush=True)
        assert rep["spill_stores"] == rep["spill_loads"] == 0, (name, rep)
        assert sass.get("LDL", 0) == sass.get("STL", 0) == 0, (name, rep)
        assert sass.get("tensor_core", 0) == 0, (name, rep)
        assert sass.get("FFMA", 0) > 0 and sass.get("LDS.128", 0) > 0, (name, rep)
        assert sass.get("UBLKCP", 0) > 0, (name, rep)


@pytest.mark.parametrize("source,count", [("flash_attention_packed.cu", 3),
                                          ("flash_attention_bwd.cu", 2)])
def test_f32_d64_body_compiles_to_fma_and_16_byte_loads(cuda, source, count):
    """What ptxas and cuobjdump show of every f32reg kernel of the forward
    and of the backward pair (tools/kernel_report.py): no spill (0 bytes, no
    local loads or stores), no tensor-core instruction (so no TF32 product),
    f32 FMAs, 16-byte shared loads (LDS.128) and cp.async copies (LDGSTS)."""
    from unigeo_tpu_torch.tools import kernel_report

    kernels = kernel_report.main(["--source", source, "--match", "f32reg"])["kernels"]
    assert len(kernels) >= count, kernels
    for name, rep in kernels.items():
        sass = rep["sass"]
        assert rep["spill_stores"] == rep["spill_loads"] == 0, (name, rep)
        assert sass.get("LDL", 0) == sass.get("STL", 0) == 0, (name, rep)
        assert sass.get("tensor_core", 0) == 0, (name, rep)
        assert sass.get("FFMA", 0) > 0 and sass.get("LDS.128", 0) > 0, (name, rep)
        assert sass.get("LDGSTS", 0) > 0, (name, rep)


def test_bf16_forward_switch_refuses_without_fallback(cuda):
    """The bf16 forward's switch by head width: at d = 64, 80 and 512 the
    wgmma bodies refuse rows that are not contiguous [B, S, H*D] (their
    tensor maps assume them) and the launch raises; no other body is tried.
    A bf16 width outside the switch, refused until the CUDA-core body took
    bf16, runs on it within its limit."""
    lib = _build.load_library()
    for d in (64, 80, 512):
        b, s, h = 2, 200, 2
        wide = _qkv(b, s, s, 2 * h, d, torch.bfloat16, cuda, seed=20)
        q, k, v = (x[:, :, : h * d] for x in wide)  # row stride 2 H D, 16-byte aligned
        assert not q.is_contiguous() and q.data_ptr() % 16 == 0
        with pytest.raises(ValueError):  # the wrapper takes contiguous rows only
            flash_attention_packed(q, k, v, h)
        with pytest.raises(RuntimeError):
            attention._launch(lib, q, k, v, h, d**-0.5)
    q, k, v = _qkv(1, 128, 128, 2, 32, torch.bfloat16, cuda, seed=21)
    out = attention._launch(lib, q, k, v, 2, 32**-0.5)  # d = 32: the CUDA-core body
    assert _cuda_core_ratio(out, q, k, v, 2) <= 1.0


# --- forward with logsumexp, and the backward ---------------------------------


def _fwd_and_dout(q, k, v, h, seed):
    """The plain forward's (out, lse) and a N(0,1) dO: the backward's inputs,
    the same for kernel and plain version."""
    out, lse = attention_fwd_lse_reference(q, k, v, h)
    rng = np.random.default_rng(seed)
    dout = torch.from_numpy(rng.standard_normal(tuple(q.shape)).astype(np.float32))
    return out, lse, dout.to(device=q.device, dtype=q.dtype)


def _grad_ratios(grads, q, k, v, out, lse, dout, h):
    """max over elements of |kernel - plain| / limit, for dq, dk, dv."""
    refs = attention_bwd_reference(q, k, v, out, lse, dout, h)
    limits = grad_error_limits(q, k, v, out, lse, dout, h, refs)
    return [((g.float() - r.float()).abs() / lim).max().item()
            for g, r, lim in zip(grads, refs, limits)]


FWD_LSE_CASES = [
    (torch.float32, 2, 70, 100, 3, 8),
    (torch.float32, 2, 257, 100, 4, 64),
    (torch.float32, 1, 96, 77, 1, 512),
    # the f32 body at d = 64: unsplit, split over 2 and over 4 blocks
    (torch.float32, 2, 768, 768, 12, 64),
    (torch.float32, 2, 130, 61, 2, 64),
    (torch.float32, 1, 257, 257, 2, 64),
    (torch.float32, 1, 768, 768, 8, 64),
    (torch.bfloat16, 2, 70, 100, 3, 16),
    (torch.bfloat16, 2, 130, 61, 2, 64),
    (torch.bfloat16, 2, 257, 257, 4, 80),
    (torch.bfloat16, 1, 96, 77, 1, 512),
]


@pytest.mark.parametrize("dtype,b,sq,sk,h,d", FWD_LSE_CASES)
def test_fwd_lse_kernel_matches_plain(cuda, dtype, b, sq, sk, h, d):
    q, k, v = _qkv(b, sq, sk, h, d, dtype, cuda, seed=7)
    before = flash_attention_fwd_lse.launches
    out, lse = flash_attention_fwd_lse(q, k, v, h)
    torch.cuda.synchronize()
    assert flash_attention_fwd_lse.launches == before + 1
    ref, ref_lse = attention_fwd_lse_reference(q, k, v, h)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    assert (lse - ref_lse).abs().max().item() < 1e-4
    if dtype == torch.float32:
        assert (out - ref).abs().max().item() < 1e-5
    else:
        assert _err_over_limit(out, q, k, v, h) <= 1.0
    # the packed forward is the same function
    torch.testing.assert_close(flash_attention_packed(q, k, v, h), out, atol=0, rtol=0)


BWD_CASES = [
    (torch.float32, 2, 64, 64, 2, 8),
    (torch.float32, 2, 70, 100, 3, 16),
    (torch.float32, 2, 257, 100, 4, 64),
    (torch.float32, 1, 100, 1, 2, 64),
    # f32 at d = 64 (the register-tiled pair): both sides ragged, a single
    # query block with three of its four warps past Sq, and Cut3R's 64 state
    # keys (dk/dv's query tiles split over 8 blocks)
    (torch.float32, 2, 130, 61, 2, 64),
    (torch.float32, 1, 5, 300, 4, 64),
    (torch.float32, 1, 768, 64, 8, 64),
    (torch.float32, 1, 200, 150, 1, 128),
    (torch.bfloat16, 2, 70, 100, 3, 16),
    (torch.bfloat16, 1, 200, 150, 1, 64),
    (torch.bfloat16, 2, 130, 61, 2, 64),
    (torch.bfloat16, 1, 100, 1, 2, 64),
    # ragged edges inside a 64-row tile and a 128- or 192-row block, where
    # the TMA returns zero rows past Sq or Sk
    (torch.bfloat16, 2, 150, 150, 3, 64),
    (torch.bfloat16, 2, 257, 100, 4, 64),
    (torch.bfloat16, 2, 150, 150, 3, 16),
    (torch.bfloat16, 2, 257, 100, 4, 16),
]


@pytest.mark.parametrize("dtype,b,sq,sk,h,d", BWD_CASES)
def test_bwd_kernels_match_plain(cuda, dtype, b, sq, sk, h, d):
    q, k, v = _qkv(b, sq, sk, h, d, dtype, cuda, seed=8)
    out, lse, dout = _fwd_and_dout(q, k, v, h, seed=9)
    n_dq, n_dkv = flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches
    grads = flash_attention_bwd(q, k, v, out, lse, dout, h)
    torch.cuda.synchronize()
    assert flash_attention_bwd_dq.launches == n_dq + 1
    assert flash_attention_bwd_dkv.launches == n_dkv + 1
    for g, x in zip(grads, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
    ratios = _grad_ratios(grads, q, k, v, out, lse, dout, h)
    assert max(ratios) <= 1.0, ratios


@pytest.mark.parametrize("b,s,h,d", [(2, 3072, 5, 64), (2, 768, 10, 64), (2, 192, 20, 64)])
def test_bwd_kernels_match_plain_bf16_main_path_shapes(cuda, b, s, h, d):
    q, k, v = _qkv(b, s, s, h, d, torch.bfloat16, cuda, seed=10)
    out, lse = flash_attention_fwd_lse(q, k, v, h)
    rng = np.random.default_rng(11)
    dout = torch.from_numpy(rng.standard_normal(tuple(q.shape)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    grads = flash_attention_bwd(q, k, v, out, lse, dout, h)
    torch.cuda.synchronize()
    ratios = _grad_ratios(grads, q, k, v, out, lse, dout, h)
    assert max(ratios) <= 1.0, ratios


@pytest.mark.parametrize(
    "dtype,b,sq,sk,h,d",
    [(torch.bfloat16, 2, 3072, 3072, 5, 64), (torch.bfloat16, 2, 257, 100, 4, 16),
     # f32 at d = 64: both kernels split over a cluster (the decoders'
     # shape), dk/dv split over 8 blocks (Cut3R's 64 state keys), and
     # VideoDepthAnything's ragged 972 tokens unsplit
     (torch.float32, 1, 768, 768, 8, 64), (torch.float32, 1, 768, 64, 8, 64),
     (torch.float32, 2, 972, 972, 16, 64)],
)
def test_bwd_kernels_are_bitwise_reproducible(cuda, dtype, b, sq, sk, h, d):
    """Every output element is written by one block, once (a split's
    partials added in rank order): two launches on the same inputs give the
    same bits."""
    q, k, v = _qkv(b, sq, sk, h, d, dtype, cuda, seed=17)
    out, lse, dout = _fwd_and_dout(q, k, v, h, seed=18)
    delta = _delta(out, dout, h)
    first = (flash_attention_bwd_dq(q, k, v, dout, lse, delta, h),
             *flash_attention_bwd_dkv(q, k, v, dout, lse, delta, h))
    second = (flash_attention_bwd_dq(q, k, v, dout, lse, delta, h),
              *flash_attention_bwd_dkv(q, k, v, dout, lse, delta, h))
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_autograd_function_matches_autograd_through_plain(cuda):
    """FlashAttentionPacked's gradients (f32 kernels) against autograd
    through the plain forward, under the f32 limits."""
    b, sq, sk, h, d = 2, 150, 130, 2, 32
    q, k, v = (x.requires_grad_() for x in _qkv(b, sq, sk, h, d, torch.float32, cuda, seed=12))
    rng = np.random.default_rng(13)
    g = torch.from_numpy(rng.standard_normal((b, sq, h * d)).astype(np.float32)).to(cuda)
    out = FlashAttentionPacked.apply(q, k, v, h, d**-0.5)
    grads = torch.autograd.grad(out, (q, k, v), g)
    refs = torch.autograd.grad(attention_packed_reference(q, k, v, h), (q, k, v), g)
    with torch.no_grad():
        o, lse = attention_fwd_lse_reference(q, k, v, h)
        limits = grad_error_limits(q, k, v, o, lse, g, h, refs)
    for x, r, lim in zip(grads, refs, limits):
        assert ((x - r).abs() / lim).max().item() <= 1.0


def test_bwd_kernels_reject_what_they_do_not_take(cuda):
    def args(b, s, h, d, dtype):
        q, k, v = _qkv(b, s, s, h, d, dtype, cuda)
        out, lse, dout = _fwd_and_dout(q, k, v, h, seed=1)
        return q, k, v, out, lse, dout

    # bf16 at d = 80 (no wgmma body), refused until the CUDA-core body took
    # bf16, now runs on it within its limit
    a80 = args(1, 128, 2, 80, torch.bfloat16)
    q, k, v, out, lse, dout = a80
    assert attention.bf16_bwd_on_cuda_core(q, k, v, dout, 80)
    refs = attention_bwd_reference(*a80[:3], out, lse, dout, 2)
    for g, r, lim in zip(flash_attention_bwd(*a80, 2), refs,
                         grad_error_limits(*a80[:3], out, lse, dout, 2, refs, cuda_core=True)):
        assert ((g.float() - r.float()).abs() / lim).max().item() <= 1.0
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError):  # up to d = 128
            flash_attention_bwd(*args(1, 128, 1, 256, dtype), 1)
    with pytest.raises(ValueError):  # float16
        flash_attention_bwd(*args(1, 128, 2, 64, torch.float16), 2)
    q, k, v, out, lse, dout = args(1, 128, 2, 64, torch.float32)
    with pytest.raises(ValueError):  # lse in the wrong dtype
        flash_attention_bwd(q, k, v, out, lse.double(), dout, 2)
    wide = torch.cat([dout, dout], dim=2)
    with pytest.raises(ValueError):  # non-contiguous dO
        flash_attention_bwd(q, k, v, out, lse, wide[:, :, : dout.shape[2]], 2)
    b, s, h, d = 1, 150, 2, 64
    shift = lambda x: torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(b, s, h * d)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, out, lse, dout = args(b, s, h, d, dtype)
        qs, ks, vs, dos = shift(q), shift(k), shift(v), shift(dout)
        assert qs.is_contiguous() and qs.data_ptr() % 16 != 0
        if dtype == torch.bfloat16:
            # rows not aligned to 16 bytes: refused until the CUDA-core body
            # took bf16, now run on it within its limit
            refs = attention_bwd_reference(qs, ks, vs, out, lse, dos, h)
            limits = grad_error_limits(qs, ks, vs, out, lse, dos, h, refs, cuda_core=True)
            for g, r, lim in zip(flash_attention_bwd(qs, ks, vs, shift(out), lse, dos, h),
                                 refs, limits):
                assert ((g.float() - r.float()).abs() / lim).max().item() <= 1.0
            continue
        with pytest.raises(ValueError):  # rows not aligned to 16 bytes
            flash_attention_bwd(qs, ks, vs, shift(out), lse, dos, h)
        if dtype == torch.float32:
            # the f32 d = 64 bodies refuse the launch too: no other body is tried
            delta = _delta(out, dout, h)
            lib = _build.load_library()
            with pytest.raises(RuntimeError):
                attention._launch_bwd_dq(lib, qs, ks, vs, dos, lse, delta, h, d**-0.5)
            with pytest.raises(RuntimeError):
                attention._launch_bwd_dkv(lib, qs, ks, vs, dos, lse, delta, h, d**-0.5)


@pytest.mark.parametrize("b,sq,sk,h", [(2, 768, 768, 12), (1, 768, 768, 8), (1, 768, 64, 8),
                                       (2, 130, 61, 2)])
def test_f32_bwd_d64_runs_the_register_tiled_bodies(cuda, b, sq, sk, h):
    """f32 at d = 64: the pair runs bwd_dq_f32reg_kernel and
    bwd_dkv_f32reg_kernel (by the profiler's kernel names), split over a
    cluster where the items leave SMs without a block (the plan,
    ``attention.f32_bwd_split`` at this card's SMs); at d = 32 the earlier
    bwd_{dq,dkv}_f32_kernel<NCOL> run as before."""
    q, k, v = _qkv(b, sq, sk, h, 64, torch.float32, cuda, seed=26)
    out, lse, dout = _fwd_and_dout(q, k, v, h, seed=27)
    launched = _f32reg_launches(lambda: flash_attention_bwd(q, k, v, out, lse, dout, h), "bwd_")
    names = {("dkv" if "bwd_dkv" in name else "dq"): (name, args) for name, args in launched}
    assert len(launched) == 2 and set(names) == {"dq", "dkv"}, launched
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for part in ("dq", "dkv"):
        name, args = names[part]
        assert f"bwd_{part}_f32reg_kernel" in name, launched
        assert args[0] * 16 == attention.BWD_F32_BLOCK_ROWS, launched
        assert args[2] == attention.f32_bwd_split(b, sq, sk, h, part == "dkv", sms), (
            part, launched, sms)
    q, k, v = _qkv(1, 200, 150, 2, 32, torch.float32, cuda, seed=28)
    out, lse, dout = _fwd_and_dout(q, k, v, 2, seed=29)
    launched = _f32reg_launches(lambda: flash_attention_bwd(q, k, v, out, lse, dout, 2), "bwd_")
    assert [args for _, args in launched] == [None, None], launched
    assert all("f32_kernel<" in name for name, _ in launched), launched


# --- the head-split forward ---------------------------------------------------


@pytest.mark.parametrize(
    "dtype,b,sq,sk,h,d",
    [(torch.bfloat16, 2, 3072, 3072, 5, 64), (torch.bfloat16, 2, 768, 768, 10, 64),
     (torch.bfloat16, 2, 192, 192, 20, 64), (torch.bfloat16, 1, 3072, 3072, 1, 512),
     (torch.bfloat16, 2, 257, 257, 16, 80), (torch.bfloat16, 2, 130, 61, 2, 64),
     (torch.float32, 2, 70, 100, 3, 16)],
)
def test_headsplit_kernel_matches_plain_and_packed(cuda, dtype, b, sq, sk, h, d):
    q, k, v = _qkv(b, sq, sk, h, d, dtype, cuda, seed=14)
    split = lambda x: x.view(x.shape[0], x.shape[1], h, d)
    before = flash_attention.launches, flash_attention_packed.launches
    out = flash_attention(split(q), split(k), split(v))
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_packed.launches) == (before[0] + 1,
                                                                           before[1])
    assert out.shape == (b, sq, h, d) and out.dtype == dtype
    packed = out.view(b, sq, h * d)
    if dtype == torch.float32:
        assert (packed - attention_packed_reference(q, k, v, h)).abs().max().item() < 1e-5
    else:
        assert _err_over_limit(packed, q, k, v, h) <= 1.0
    # the same kernel body on the same bytes
    assert torch.equal(packed, flash_attention_packed(q, k, v, h))


# --- the fused GEGLU feed-forward ---------------------------------------------------


def _geglu_inputs(m, c, mult, device, seed=0):
    """bf16 x [M, C] ~ N(0, 1) and nn.Linear-layout weights at the
    JAX package's init scales (lecun normal), small random biases."""
    rng = np.random.default_rng(seed)
    mk = lambda shape, std: torch.from_numpy(
        (rng.standard_normal(shape) * std).astype(np.float32)).to(device, torch.bfloat16)
    hidden = c * mult
    return (mk((m, c), 1.0), mk((2 * hidden, c), c**-0.5), mk((2 * hidden,), 0.05),
            mk((c, hidden), hidden**-0.5))


def _geglu_ratio(out, x, w1, b1, w2):
    ref = geglu_ffn_plain(x, w1, b1, w2)
    limit = geglu_error_limit(x, w1, b1, w2, ref)
    return ((out.float() - ref.float()).abs() / limit).max().item()


# the UNet's (M, C) at 25 x 384 x 512: stages 0-2 and the mid block, and
# ragged or small shapes (C_out column blocks of 320, 128, 64 and 16)
GEGLU_CASES = [(76800, 320, 4), (19200, 640, 4), (4800, 1280, 4), (1200, 1280, 4),
               (100, 64, 4), (37, 64, 2), (256, 128, 4), (65, 192, 4), (130, 320, 4)]


def _geglu_into_tiles(lib, x, w1, b1, w2):
    """The kernel in ``lib`` into buffers of whole items of ``geglu.BLOCK_M``
    rows filled with NaN: the output and, where the plan takes two passes,
    the h scratch.  Returns (the output's rows < M, the number of rows past
    M written in either)."""
    m, c, hidden, c_out = x.shape[0], x.shape[1], w1.shape[0] // 2, w2.shape[0]
    plan = geglu.kernel_plan(lib, m, c, hidden, c_out)
    rows = -(-m // geglu.BLOCK_M) * geglu.BLOCK_M
    nan = lambda width: torch.full((rows, width), float("nan"), dtype=torch.bfloat16,
                                   device=x.device)
    out, hbuf = nan(c_out), nan(hidden) if plan["two_pass"] else None
    splits = plan["hidden_splits"]
    partial = (torch.empty((splits, m, c_out), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    geglu._run(lib, x, w1, b1, w2, out[:m], partial, None if hbuf is None else hbuf[:m])
    torch.cuda.synchronize()
    written = lambda buf: int((~torch.isnan(buf[m:].float())).any(dim=1).sum().item())
    return out[:m], written(out) + (0 if hbuf is None else written(hbuf))


@pytest.mark.parametrize("m,c,mult", GEGLU_CASES)
def test_geglu_kernel_matches_plain(cuda, m, c, mult):
    x, w1, b1, w2 = _geglu_inputs(m, c, mult, cuda, seed=m + c)
    before = geglu_ffn.launches
    out = geglu_ffn(x, w1, b1, w2)
    torch.cuda.synchronize()
    assert geglu_ffn.launches == before + 1
    assert out.shape == (m, c) and out.dtype == torch.bfloat16
    ratio = _geglu_ratio(out, x, w1, b1, w2)
    tiled, past = _geglu_into_tiles(_build.load_library(), x, w1, b1, w2)
    print(f"geglu [M={m},C={c},H={c * mult}]: max err/limit {ratio:.3f}, rows written past M "
          f"{past}", flush=True)
    assert ratio <= 1.0 and past == 0 and torch.equal(tiled, out), ratio


def _geglu_planted(cuda, lib, fault, m, c):
    x, w1, b1, w2 = _geglu_inputs(m, c, 4, cuda, seed=7)
    good = _geglu_ratio(geglu_ffn(x, w1, b1, w2), x, w1, b1, w2)
    if fault == "geglu_no_ragged_mask":
        # without the row mask, split partials' rows past M would lie outside
        # their scratch: the shapes are ones whose plan takes one split
        assert geglu.kernel_plan(lib, m, c, 4 * c, c)["hidden_splits"] == 1
    out, past = _geglu_into_tiles(lib, x, w1, b1, w2)
    bad = _geglu_ratio(out, x, w1, b1, w2)
    # rows past M must stay as they were (their limit is 0), and a value
    # that is not finite fails any limit
    if past or not np.isfinite(bad):
        bad = float("inf")
    print(f"planted {fault} [M={m},C={c}]: max err/limit kernel {good:.3f}, faulty copy "
          f"{bad:.3f} ({past} rows written past M)", flush=True)
    assert good <= 1.0 and bad >= 3.0, (good, bad)


@pytest.mark.parametrize("m,c", [(76800, 320), (1200, 1280), (100, 64)])
def test_geglu_kernel_is_bitwise_reproducible(cuda, m, c):
    """Every output element is written once, and the hidden splits' partials
    are summed in a fixed order: two launches give the same bits."""
    x, w1, b1, w2 = _geglu_inputs(m, c, 4, cuda, seed=23)
    first, second = geglu_ffn(x, w1, b1, w2), geglu_ffn(x, w1, b1, w2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_geglu_kernel_plans_at_the_main_path_shapes(cuda):
    """The wgmma body's plan at the UNet's four feed-forward shapes: fused
    at C_out = 320 (x resident), two passes (up-projection, then
    down-projection) at 640 and 1280 (two column groups), hidden splits for
    the mid block's 19 row blocks, at most one block per SM."""
    lib = _build.load_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {c: geglu.kernel_plan(lib, m, c, 4 * c, c)
             for m, c in ((76800, 320), (19200, 640), (4800, 1280))}
    assert [plans[c]["column_groups"] for c in (320, 640, 1280)] == [1, 1, 2]
    assert [plans[c]["two_pass"] for c in (320, 640, 1280)] == [0, 1, 1]
    assert plans[320]["consumer_columns"] == 160 and plans[640]["consumer_columns"] == 320
    assert plans[320]["x_resident"] == 1
    mid = geglu.kernel_plan(lib, 1200, 1280, 5120, 1280)
    assert mid["two_pass"] == 1 and mid["hidden_splits"] > 1
    assert all(p["blocks"] <= sms and p["up_pass_blocks"] <= sms for p in (*plans.values(), mid))


def test_geglu_kernel_rejects_what_it_does_not_take(cuda):
    x, w1, b1, w2 = _geglu_inputs(64, 64, 4, cuda)
    with pytest.raises(ValueError):  # f32
        geglu_ffn(x.float(), w1.float(), b1.float(), w2.float())
    with pytest.raises(ValueError):  # C not a multiple of 64
        x2, w12, b12, w22 = _geglu_inputs(64, 48, 4, cuda)
        geglu_ffn(x2, w12, b12, w22)
    with pytest.raises(ValueError):  # x not aligned to 16 bytes
        shifted = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(64, 64)
        geglu_ffn(shifted, w1, b1, w2)


# --- the fused LayerNorm -> dense ----------------------------------------------------


def _ln_inputs(m, c, n, dtype, device, seed=0):
    """x [M, C] with row means of 0.5, gamma ~ 1 + 0.2 N, beta ~ 0.3 N, the
    nn.Linear weight [N, C] ~ N(0, 1/C) and bias ~ 0.1 N, in ``dtype``."""
    rng = np.random.default_rng(seed)
    mk = lambda shape, std, mean=0.0: torch.from_numpy(
        (rng.standard_normal(shape) * std + mean).astype(np.float32)).to(device, dtype)
    return (mk((m, c), 1.0, 0.5), mk((c,), 0.2, 1.0), mk((c,), 0.3), mk((n, c), c**-0.5),
            mk((n,), 0.1))


def _ln_ratio(out, args):
    ref = ln_dense_plain(*args)
    return ((out.float() - ref.float()).abs() / ln_dense_error_limit(*args, ref)).max().item()


def _ln_into_tiles(lib, args):
    """The kernel in ``lib`` into a zeroed buffer of whole items of
    ``ln_qkv.BLOCK_M`` rows: (the rows < M, the number of rows past M it
    wrote)."""
    x, weight = args[0], args[3]
    m = x.shape[0]
    buf = torch.zeros((-(-m // ln_qkv.BLOCK_M) * ln_qkv.BLOCK_M, weight.shape[0]),
                      dtype=x.dtype, device=x.device)
    ln_qkv._launch(lib, *args, buf[:m], 1e-5)
    torch.cuda.synchronize()
    return buf[:m], int(buf[m:].abs().amax(dim=1).gt(0).sum().item())


# the UNet's temporal-attention shapes (M, C, N = 3C) at 25 x 384 x 512, and
# ragged ones: M = 100, N = 2C, C not a multiple of the K tile (64 in bf16,
# 32 in f32), with and without 16-byte rows (C % 8), an odd N
LN_CASES = [(76800, 320, 960, "bf16"), (19200, 640, 1920, "bf16"), (4800, 1280, 3840, "bf16"),
            (100, 200, 400, "bf16"), (100, 100, 200, "bf16"), (37, 72, 129, "bf16"),
            (100, 200, 400, "f32"), (100, 100, 200, "f32"), (37, 72, 129, "f32")]
LN_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.mark.parametrize("m,c,n,dtype", LN_CASES)
def test_ln_dense_kernel_matches_plain(cuda, m, c, n, dtype):
    args = _ln_inputs(m, c, n, LN_DTYPES[dtype], cuda, seed=m + c)
    before = ln_dense.launches
    out = ln_dense(*args)
    torch.cuda.synchronize()
    assert ln_dense.launches == before + 1
    assert out.shape == (m, n) and out.dtype == LN_DTYPES[dtype]
    ratio = _ln_ratio(out, args)
    tiled, past = _ln_into_tiles(_build.load_library(), args)
    print(f"ln_dense [M={m},C={c},N={n},{dtype}]: max err/limit {ratio:.3f}, rows written "
          f"past M {past}", flush=True)
    assert ratio <= 1.0 and past == 0 and torch.equal(tiled, out)


@pytest.mark.parametrize(
    "fault,m,c,n",
    [
        ("ln_skip_last_k_tile", 76800, 320, 960),
        ("ln_skip_beta", 19200, 640, 1920),
        ("ln_last_n_tile_unwritten", 1200, 320, 960),
        ("ln_rows_past_m", 100, 200, 400),
        ("ln_other_rows_stats", 19200, 640, 1920),
    ],
)
def test_ln_dense_limit_fails_planted_faults(cuda, faulty_libraries, fault, m, c, n):
    """The kernel passes its limit and a copy with a planted fault fails it
    by at least 3x (rows written past M: inf)."""
    args = _ln_inputs(m, c, n, torch.bfloat16, cuda, seed=11)
    good = _ln_ratio(ln_dense(*args), args)
    out, past = _ln_into_tiles(faulty_libraries[fault], args)
    bad = _ln_ratio(out, args)
    if past or not np.isfinite(bad):  # as in _geglu_planted
        bad = float("inf")
    print(f"planted {fault} [M={m},C={c},N={n}]: max err/limit kernel {good:.3f}, faulty copy "
          f"{bad:.3f} ({past} rows written past M)", flush=True)
    assert good <= 1.0 and bad >= 3.0, (good, bad)


@pytest.mark.parametrize("m,c,n", [(4800, 1280, 3840), (76800, 320, 960), (100, 100, 200)])
def test_ln_dense_kernel_is_bitwise_reproducible(cuda, m, c, n):
    """Every output element is written once: two launches give the same bits
    (the wgmma body with and without N splits, and the mma.sync body)."""
    args = _ln_inputs(m, c, n, torch.bfloat16, cuda, seed=29)
    first, second = ln_dense(*args), ln_dense(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_ln_dense_body_by_shape(cuda):
    """bf16 takes the wgmma body at the UNet's three shapes and at 16-byte
    rows (C % 8 == 0), the mma.sync body where rows are not 16-byte
    aligned (C = 100) or x is not; f32 launches its own kernel."""
    lib = _build.load_library()
    body = lambda args: ln_qkv.kernel_plan(lib, *args[:4])["wgmma"]
    for m, c, n in ((76800, 320, 960), (19200, 640, 1920), (4800, 1280, 3840), (37, 72, 129)):
        assert body(_ln_inputs(m, c, n, torch.bfloat16, cuda)) == 1
    assert body(_ln_inputs(100, 100, 200, torch.bfloat16, cuda)) == 0
    x, g, b, w, bias = _ln_inputs(64, 96, 192, torch.bfloat16, cuda)
    shifted = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(64, 96)
    assert body((shifted, g, b, w)) == 0
    args = (shifted, g, b, w, bias)
    ratio = _ln_ratio(ln_dense(*args), args)
    assert ratio <= 1.0, ratio


def test_ln_dense_kernel_rejects_what_it_does_not_take(cuda):
    x, g, b, w, bias = _ln_inputs(64, 96, 192, torch.bfloat16, cuda)
    with pytest.raises(ValueError):  # x not contiguous
        ln_dense(x.t().contiguous().t(), g, b, w, bias)
    with pytest.raises(ValueError):  # mixed dtypes
        ln_dense(x, g, b, w.float(), bias)
    with pytest.raises(ValueError):  # a dtype the kernel does not take
        ln_dense(*(t.half() for t in (x, g, b, w, bias)))
    with pytest.raises(ValueError):  # a weight on another device
        ln_dense(x, g, b, w.cpu(), bias)


# --- the point-cloud and camera metrics ----------------------------------------------


def test_pcd_metrics_on_the_card_match_the_cpu(cuda):
    from unigeo_tpu_torch.data.sample import prepare_gt_label
    from unigeo_tpu_torch.data.synthetic import SyntheticBoxDataset
    from unigeo_tpu_torch.metrics.pointcloud import PCD_METRIC_KEYS, pcd_evaluation

    gt = prepare_gt_label(SyntheticBoxDataset(clip_length=8, num_scenes=1, frames_per_scene=8)[0])
    rng = np.random.default_rng(12)
    a = np.radians(3.0)
    rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    pts = gt["gt_world_pts"]
    pred = (1.1 * pts @ rot.T + np.array([0.02, -0.01, 0.03])
            + rng.normal(0, 0.005, pts.shape)).astype(np.float32)
    args = (pred, pts, gt["gt_masks"])
    kw = dict(rgbs=gt["gt_rgbs"], downsample_num=4000)
    on_card = pcd_evaluation(*args, device="cuda", **kw)
    on_cpu = pcd_evaluation(*args, device="cpu", **kw)
    q_max = float(np.linalg.norm(pts[gt["gt_masks"]], axis=-1).max())
    e = 16 * 2.0**-24 * q_max**2
    for key in PCD_METRIC_KEYS:
        tol = 1e-4 if key.startswith("nc") else 1e-5 * q_max + 2 * e / on_cpu[key]
        print(f"pcd {key}: card {on_card[key]:.6g} cpu {on_cpu[key]:.6g} tol {tol:.3g}",
              flush=True)
        assert abs(on_card[key] - on_cpu[key]) <= tol, key
    np.testing.assert_array_equal(on_card["gt_pcd"][0], on_cpu["gt_pcd"][0])
    assert torch.backends.cuda.matmul.allow_tf32 is False


# --- the windowed crossfade, the batched denoise and the clip reader -----------------

PIPELINE_TOL_REL = 1e-3  # the tiny f32 pipeline, card against CPU (chip_smoke.py)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms inside the block: by
    default its heuristics pick, for some of the f32 UNet's convolutions, an
    algorithm whose sums land in another order from run to run (the same
    window twice differs by ~5e-6 in its latents), so "the same kernels on
    the same inputs" holds only under this setting."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


@pytest.fixture()
def tiny_card_pipeline(cuda):
    """The tiny f32 pipeline on the card at 128 x 128 (256 latent tokens: the
    UNet's spatial attentions take the kernel), random weights from a seed."""
    from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline

    pipe = tiny_pipeline(device=cuda, dtype=torch.float32)
    return pipe.init_random(torch.Generator(device=cuda).manual_seed(3))


def test_windowed_call_on_the_card_is_two_windows_crossfaded(tiny_card_pipeline):
    """t = 6, window 4, overlap 2: windows at 0 and 2, each drawn from its
    own generator; frames 0-1 are window 0's, 4-5 window 1's 2-3, and 2-3
    the f64 blend (1 - r) old + r new, r = 0, 0.5, rounded to f32; exact
    (with cuDNN's deterministic algorithms)."""
    pipe = tiny_card_pipeline
    h = w = 128
    frames = torch.from_numpy(np.random.default_rng(6).random((6, h, w, 3)).astype(np.float32))
    before = flash_attention_packed.launches
    with deterministic_cudnn():
        out = pipe(frames, num_inference_steps=5, window_size=4, overlap=2, seed=7)
        wins = []
        for wi, start in enumerate((0, 2)):
            noise, aug = pipe.draw_clip_noise(pipe.window_generator(7, wi), 4, h, w)
            wins.append(pipe.run_window_staged(frames[start:start + 4], noise, 5,
                                               aug_noise=aug).cpu().numpy())
    assert flash_attention_packed.launches > before and out.device.type == "cuda"
    r = np.array([0.0, 0.5]).reshape(-1, 1, 1, 1)
    blend = ((1.0 - r) * wins[0][2:] + r * wins[1][:2]).astype(np.float32)
    want = (np.concatenate([wins[0][:2], blend, wins[1][2:]]) + 1.0) / 2.0
    got = out.cpu().numpy()
    print("max |out - want| per frame", np.abs(got - want).reshape(6, -1).max(1).tolist())
    assert np.array_equal(got, want)


def test_window_on_the_card_is_deterministic(tiny_card_pipeline):
    """Under cuDNN's deterministic algorithms the same window twice gives
    the same bits at every stage (encode, denoise, decode): the crossfade's
    exactness against its windows rests on it.  With the default algorithms
    the deviation is printed, not held."""
    pipe = tiny_card_pipeline
    rng = np.random.default_rng(8)
    frames = torch.from_numpy(rng.random((4, 128, 128, 3)).astype(np.float32)).to(pipe.device)
    noise, aug = pipe.draw_clip_noise(torch.Generator(device=pipe.device).manual_seed(1),
                                      4, 128, 128)
    nchw = lambda a: a.permute(0, 3, 1, 2)

    def stage_diffs():
        runs = []
        for _ in range(2):
            cond, ctx = pipe._encode_stage(nchw(frames).contiguous(), nchw(aug))
            x = pipe._denoise_loop(cond[None], ctx[None], nchw(noise)[None], 5)[0]
            runs.append({"cond": cond, "context": ctx, "latents": x,
                         "decoded": pipe._decode_stage(x)})
        return {k: (runs[0][k].float() - runs[1][k].float()).abs().max().item() for k in runs[0]}

    print("default algorithms: stage max |run 1 - run 2|", stage_diffs())
    with deterministic_cudnn():
        diffs = stage_diffs()
    print("deterministic cuDNN: stage max |run 1 - run 2|", diffs)
    assert all(v == 0.0 for v in diffs.values()), diffs


def test_forward_batch_on_the_card_matches_serial(tiny_card_pipeline):
    """B = 2 through one batched denoise against each clip alone, f32 with
    TF32 off: decoded frames within the pipeline bound, depths within the
    adapter's 1e-2 (tests/test_torch_windows.py)."""
    from unigeo_tpu_torch.models.depthcrafter.model import DepthCrafter

    pipe = tiny_card_pipeline
    rng = np.random.default_rng(9)
    k = np.array([[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]], np.float32)
    datas = [{"images": rng.integers(0, 256, (2, 3, 128, 128)).astype(np.uint8),
              "intrinsics": np.stack([k] * 2)} for _ in range(2)]
    model = DepthCrafter(pipeline=pipe, clips_per_step=2, seed=5)
    batched = model.forward_batch(datas)
    for data, got in zip(datas, batched):
        want = model.forward(data)
        rel = np.abs(got["pred_depths"] - want["pred_depths"]).max() / np.abs(
            want["pred_depths"]).max()
        assert rel < 1e-2, rel
    noise, aug = pipe.draw_clip_noise(torch.Generator(device=pipe.device).manual_seed(5),
                                      2, 128, 128)
    frames = torch.stack([pipe.prepare_clip(d["images"]) for d in datas])
    dec = pipe.run_clips_staged(frames, noise.expand(2, *noise.shape), 5,
                                aug_noise=aug.expand(2, *aug.shape))
    for i in range(2):
        one = pipe.run_window_staged(frames[i], noise, 5, aug_noise=aug)
        assert ((dec[i] - one).abs().max() / one.abs().max()).item() < PIPELINE_TOL_REL


def test_native_reader_on_the_card_machine(cuda, tmp_path):
    """The clip reader builds with the machine's g++ and codec libraries (or
    the test says why not) and decodes the standard library's PNGs."""
    from unigeo_tpu_torch import native
    from unigeo_tpu_torch.tools.disk_fixture import write_png

    if not native.available():
        pytest.skip(f"the native reader does not build here: {native.build_error}")
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (5, 6, 3), np.uint8)
    grey = rng.integers(0, 65536, (5, 6), np.uint16)
    write_png(str(tmp_path / "c.png"), rgb)
    write_png(str(tmp_path / "d.png"), grey)
    np.testing.assert_array_equal(native.decode_clip_rgb([str(tmp_path / "c.png")])[0],
                                  rgb.transpose(2, 0, 1).astype(np.float32))
    np.testing.assert_array_equal(native.decode_clip_depth([str(tmp_path / "d.png")], 1000.0)[0],
                                  grey.astype(np.float32) / np.float32(1000.0))


# --- the SVD-family and Spann3R slice ------------------------------------------


@pytest.mark.parametrize("b,s,h,d", [(25, 768, 12, 64), (1, 768, 8, 64)])
def test_f32_kernel_at_the_pointmap_shapes(cuda, b, s, h, d):
    """The f32 (CUDA-core) body at Spann3R's encoder (25 frames, 12 heads)
    and decoder (one frame, 8 heads) self-attention shapes at 384 x 512
    (768 tokens): within 1e-5 of the plain version (f32 in both)."""
    q, k, v = _qkv(b, s, s, h, d, torch.float32, cuda, seed=11)
    before = flash_attention_packed.launches
    out = flash_attention_packed(q, k, v, h)
    assert flash_attention_packed.launches == before + 1
    err = (out - attention_packed_reference(q, k, v, h)).abs().max().item()
    print(f"[{b},{s},{h},{d}] f32 max abs err {err:.3e}")
    assert err < 1e-5


def test_known_frame_clamp_is_exact_on_the_card(tiny_card_pipeline):
    """Frames with mask 1 come out of ``_denoise_stage_known`` equal to the
    known latents bit for bit on the card, and the others do not."""
    pipe = tiny_card_pipeline
    rng = np.random.default_rng(9)
    frames = torch.from_numpy(rng.random((4, 3, 128, 128)).astype(np.float32)).to(pipe.device)
    gen = torch.Generator(device=pipe.device).manual_seed(2)
    noise = torch.randn((4, 4, 16, 16), generator=gen, device=pipe.device)
    known = torch.randn((4, 4, 16, 16), generator=gen, device=pipe.device)
    cond, ctx = pipe._encode_stage(frames, None)
    before = flash_attention_packed.launches
    x = pipe._denoise_stage_known(cond, ctx, noise, known, torch.tensor([1.0, 1.0, 0.0, 0.0]), 3)
    assert flash_attention_packed.launches > before
    assert torch.equal(x[:2], known[:2]) and not torch.allclose(x[2:], known[2:], atol=1e-3)


def _rotation(rotvec):
    """Rodrigues: a rotation matrix from an axis-angle vector (f64)."""
    theta = np.linalg.norm(rotvec)
    kx, ky, kz = rotvec / theta
    kmat = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]])
    return np.eye(3) + np.sin(theta) * kmat + (1 - np.cos(theta)) * kmat @ kmat


def test_spann3r_on_the_card_matches_the_cpu(cuda):
    """Spann3R in f32 (TF32 off): the card's network (the f32 flash kernel on
    its 192-token self-attentions) against the same weights on the CPU,
    points and confidence within 1e-4 relative (the network's f32 sums in
    other orders, as the CPU parity with JAX); then the camera recovery on a
    scene whose cameras are known, card against CPU: rotations within 1e-3
    degree and translations within 1e-3 of their norm (cuSOLVER's eigh and
    SVD for LAPACK's; tests/test_torch_pointmap.py holds the CPU against JAX
    to the same), depths within 1e-3 relative."""
    from unigeo_tpu_torch.models.camera_solver import solve_depth_and_camera_from_pointmaps
    from unigeo_tpu_torch.models.pointmap.spann3r import Spann3R, tiny_spann3r_config

    cfg = dict(tiny_spann3r_config(), pos_embed="RoPE100", qkv_bias=True, norm_context=True,
               head_type="dpt")
    card = Spann3R(network_config=cfg, device=cuda, seed=3)
    cpu = Spann3R(network_config=cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.network.state_dict().items()})
    frames = torch.from_numpy(np.random.default_rng(12).random((3, 192, 256, 3)).astype(np.float32))
    before = flash_attention_packed.launches
    with torch.no_grad():
        pts, conf = card.network(frames.to(cuda))
    assert flash_attention_packed.launches - before == 2 + 2 * 3  # encoder, decoder per frame
    with torch.no_grad():
        ref_pts, ref_conf = cpu.network(frames)
    rel = lambda a, b: ((a.cpu() - b).abs().max() / b.abs().max()).item()
    print("points rel dev", rel(pts, ref_pts), "conf rel dev", rel(conf, ref_conf))
    assert rel(pts, ref_pts) < 1e-4 and rel(conf, ref_conf) < 1e-4

    rng = np.random.default_rng(13)
    h, w, f = 48, 64, 3
    uu, vv = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    world = []
    for i in range(f):
        depth = 2.0 + rng.uniform(0, 0.5, (h, w))
        cam = np.stack([(uu - w / 2) * depth / 50.0, (vv - h / 2) * depth / 50.0, depth], -1)
        r = np.eye(3) if i == 0 else _rotation(rng.normal(0, 0.05, 3))
        t = np.zeros(3) if i == 0 else rng.normal(0, 0.2, 3)
        world.append(((cam.reshape(-1, 3) - t) @ r).reshape(h, w, 3))
    world = torch.from_numpy(np.stack(world).astype(np.float32))
    cam_c, ext_c, _ = solve_depth_and_camera_from_pointmaps(world.to(cuda))
    cam_h, ext_h, _ = solve_depth_and_camera_from_pointmaps(world)
    d = ext_c[:, :3, :3].cpu().double() @ ext_h[:, :3, :3].double().transpose(1, 2)
    angle = np.degrees(2 * np.arcsin(np.clip(
        (d - torch.eye(3, dtype=torch.float64)).norm(dim=(1, 2)).numpy() / (2 * np.sqrt(2)), 0, 1)))
    t_dev = (ext_c[:, :3, 3].cpu() - ext_h[:, :3, 3]).norm(dim=-1)
    print("rotation deg", angle.tolist(), "translation dev", t_dev.tolist())
    assert (angle < 1e-3).all()
    assert (t_dev[1:] < 1e-3 * ext_h[1:, :3, 3].norm(dim=-1)).all()
    assert rel(cam_c[..., 2], cam_h[..., 2]) < 1e-3


# --- the Dust3R, Cut3R and VideoDepthAnything slice --------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sq,sk", [(768, 64), (64, 768)])
def test_forward_with_fewer_or_more_keys_than_queries(cuda, dtype, sq, sk):
    """Cut3R's frame tokens reading its 64 state tokens (768 queries, one key
    tile: no key split) and the converse (64 queries, 768 keys), at 8 heads
    of 64: f32 on the register-tiled body within 1e-5 of the plain version,
    bf16 (``compute_dtype: bfloat16``) on the wgmma body within the bf16
    limit."""
    torch_dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    q, k, v = _qkv(1, sq, sk, 8, 64, torch_dtype, cuda, seed=31)
    out = flash_attention_packed(q, k, v, 8)
    if dtype == "f32":
        launched = _f32reg_launches(lambda: flash_attention_packed(q, k, v, 8))
        assert launched and all(a is not None for _, a in launched), launched
        err = (out - attention_packed_reference(q, k, v, 8)).abs().max().item()
        print(f"[1,{sq}->{sk},8,64] f32 max abs err {err:.3e} body {launched[0][0][:60]}")
        assert err < 1e-5
    else:
        ratio = _err_over_limit(out, q, k, v, 8)
        print(f"[1,{sq}->{sk},8,64] bf16 err/limit {ratio:.3f}")
        assert ratio <= 1.0


@pytest.mark.parametrize("b,sq,sk,h", [(20, 768, 768, 16), (19, 768, 768, 12),
                                       (25, 972, 972, 16), (1, 3072, 3072, 12)])
def test_f32_kernel_at_the_new_pointmap_shapes(cuda, b, sq, sk, h):
    """Dust3R's encoder over 20 frames and its decoder over 19 pairs,
    VideoDepthAnything's encoder over 25 frames at patch 14 (972 = 15 x 64
    + 12 tokens: ragged rows and keys), and Aether's DiT over a 16-frame
    clip (one sequence of 3072 tokens), on the register-tiled body within
    1e-5 of the plain version."""
    q, k, v = _qkv(b, sq, sk, h, 64, torch.float32, cuda, seed=32)
    out = flash_attention_packed(q, k, v, h)
    err = (out - attention_packed_reference(q, k, v, h)).abs().max().item()
    print(f"[{b},{sq},{h},64] f32 max abs err {err:.3e}")
    assert err < 1e-5


def _tiny_pointmap_networks():
    from unigeo_tpu_torch.models.pointmap.cut3r import Cut3RNetwork, tiny_cut3r_config
    from unigeo_tpu_torch.models.pointmap.dust3r import Dust3RNetwork, tiny_dust3r_config
    from unigeo_tpu_torch.models.vda import VDANetwork, tiny_vda_config

    rope = dict(pos_embed="RoPE100", qkv_bias=True, norm_context=True, head_type="dpt")
    # (network, its call on frames, launches: the encoder's layers, then as
    # chip_smoke.pointmap_launches counts them over three frames)
    return {"dust3r": (Dust3RNetwork(**tiny_dust3r_config(), **rope),
                       lambda net, f: net(f[:1], f[1:]), 2 + 2 * 4),
            "cut3r": (Cut3RNetwork(**tiny_cut3r_config(), **rope), lambda net, f: net(f),
                      2 + 3 * 2 * 2),
            "vda": (VDANetwork(**tiny_vda_config()), lambda net, f: net(f), 4)}


@pytest.mark.parametrize("name", ["dust3r", "cut3r", "vda"])
def test_pointmap_slice_networks_on_the_card_match_the_cpu(cuda, name):
    """The tiny networks in f32 (TF32 off) at 192 x 256 (192 tokens: the f32
    kernel): the card against the same weights on the CPU, every output
    within 1e-4 of the reference's largest magnitude (the networks' f32 sums
    in other orders, as the CPU parity with JAX)."""
    import copy

    from unigeo_tpu_torch.device import set_exact_f32
    from unigeo_tpu_torch.models.pointmap.adapter import init_network_

    set_exact_f32()
    cpu_net, run, want = _tiny_pointmap_networks()[name]
    init_network_(cpu_net.eval().requires_grad_(False), torch.Generator().manual_seed(4))
    card = copy.deepcopy(cpu_net).to(cuda)
    frames = torch.from_numpy(np.random.default_rng(14).random((3, 192, 256, 3))
                              .astype(np.float32))
    flat = lambda out: (list(out.values()) if isinstance(out, dict)
                        else list(out) if isinstance(out, tuple) else [out])
    before = flash_attention_packed.launches
    with torch.no_grad():
        outs = flat(run(card, frames.to(cuda)))
        assert flash_attention_packed.launches - before == want
        refs = flat(run(cpu_net, frames))
    rels = [((o.cpu() - r).abs().max() / r.abs().max()).item() for o, r in zip(outs, refs)]
    print(name, "rel dev", rels)
    assert max(rels) < 1e-4


def test_aether_on_the_card_matches_the_cpu(cuda):
    """The small Aether of chip_smoke.py's aether phase
    (tools/aether_check.py: 8 frames at 128 x 128, 256 DiT tokens at
    d = 64, 2 steps) in f32 with TF32 off, its constant leaves perturbed,
    one noise draw given to both: the card's depths, raymaps, world points
    and poses within 1e-4 of the CPU's largest magnitude, its normals by
    angle (median within 0.05 degree, mean within twice the CPU's round-off
    floor: aether_check.within_limits says why), the DiT's 2 x 2
    attentions on the f32 kernel."""
    from unigeo_tpu_torch.tools import aether_check

    set_exact_f32()
    devs, launched = aether_check.run_on_both(cuda, 6, 20, 21,
                                              count=lambda: flash_attention_packed.launches)
    print("aether deviations", devs)
    assert launched == aether_check.LAUNCHES == 4
    assert aether_check.within_limits(devs), devs
