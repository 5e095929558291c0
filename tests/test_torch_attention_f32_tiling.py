"""The f32 forward's register-tiled body at d = 64
(csrc/flash_attention_packed.cu, ``flash_*_f32reg_kernel``), its schedule
emulated in torch on the CPU, against the JAX package's Pallas kernels in
interpret mode.

The emulation follows the body's schedule: query blocks of 64 rows (four
warps of 16), rows past Sq computed on zeros and dropped; keys in tiles of
64, the tiles past Sk filled with zero rows as the copies zero-fill them;
per tile the f32 scores S = q k^T, the running max m in log2 units
(max(m, rowmax(S) * scale * log2 e)), alpha = 2^(m_old - m_new),
p = 2^(fma(S, scale * log2 e, -m)) summed in f32 into l, O = alpha O + P v
with P in f32; on the last tile only, when Sk is ragged, the keys past Sk
score -inf.  Where the query blocks do not give every SM one (``plan``, the
host's choice at 132 SMs), the key tiles split over a cluster of 2 or 4
blocks, block r taking tiles [r n / split, (r + 1) n / split), and the
partials (m, l, acc) merge in rank order: M = max m_r, w_r = 2^(m_r - M),
out = sum w_r acc_r / sum w_r l_r, lse = (M + log2 L) ln 2.

Inputs are f32, made with numpy from a seed, at d = 64 with ragged Sq and
Sk and a 768-token case at small batch (the pointmap path's sequence,
split over 4 blocks).  Tolerances, as on the card: the output within 1e-5
absolute (f32 in both, sums in another order, exp2 for exp), the lse within
1e-4.  The planted faults of tests/test_torch_cuda.py have twins here that
miss the output limit by 3x or more: a dropped key tile, no ragged mask, no
alpha rescale, and a merge that takes one block's partial twice.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unigeo_tpu.ops.attention import flash_attention_tpu_fwd_lse, flash_attention_tpu_packed

F32_OUT_TOL, LSE_TOL = 1e-5, 1e-4
BLOCK_Q, KEY_TILE, D = 64, 64, 64
SMS = 132  # the H100's SMs, for the host's plan


def plan(b, sq, sk, h, sms=SMS):
    """The key split the host picks for [b, sq, h, 64] against sk keys: 1
    where the 64-row items give every SM one, else 2, or 4 where two splits
    would still not (and there are 4 key tiles or more)."""
    items = -(-sq // BLOCK_Q) * h * b
    n_tiles = -(-sk // KEY_TILE)
    if items >= sms or n_tiles < 2:
        return 1
    return 2 if 2 * items >= sms or n_tiles < 4 else 4


# (b, Sq, Sk, H): ragged in Sk (100, 61: one partial tile; 257: the last tile
# holds one key) and in Sq; 768 tokens (Spann3R at 384 x 512) at small batch
CASES = [(1, 70, 100, 2), (1, 257, 257, 2), (2, 130, 61, 1), (1, 768, 768, 2)]


def _heads(x, h):
    b, s, hd = x.shape
    return x.reshape(b, s, h, hd // h).transpose(1, 2)  # [B, H, S, D]


def _fma(a, b, c):
    """fmaf(a, b, c) per element: the f64 product of two f32 is exact."""
    return (a.double() * b + c.double()).float()


def emulate_f32reg_forward(q, k, v, h, scale, split=1, mask_last_tile=True, drop_tile=None,
                           rescale=True, merge_twice=False):
    """(out f32 [B, Sq, H*D], lse f32 [B, H, Sq]) by the body's schedule; f32
    q, k, v [B, S, H*D].  The keyword arguments after ``split`` plant the
    card's faults: ``drop_tile`` scores that tile's keys -inf,
    ``rescale=False`` skips O's alpha, ``merge_twice`` merges partial 0 in
    place of partial 1."""
    b, sq, hd = q.shape
    sk, d = k.shape[1], hd // h
    n_tiles = -(-sk // KEY_TILE)
    pad_q, pad_k = -(-sq // BLOCK_Q) * BLOCK_Q - sq, n_tiles * KEY_TILE - sk
    zeros = lambda x, n: torch.cat([x, x.new_zeros(b, n, hd)], dim=1)
    qh, kh, vh = _heads(zeros(q, pad_q), h), _heads(zeros(k, pad_k), h), _heads(zeros(v, pad_k), h)
    scale_log2 = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    rows = qh.shape[2]
    parts = []
    for r in range(split):
        m = torch.full((b, h, rows), -math.inf)
        l = torch.zeros(b, h, rows)
        acc = torch.zeros(b, h, rows, d)
        for t in range(r * n_tiles // split, (r + 1) * n_tiles // split):
            keys = slice(t * KEY_TILE, (t + 1) * KEY_TILE)
            s = qh @ kh[:, :, keys].transpose(-1, -2)
            if mask_last_tile and t == n_tiles - 1 and sk % KEY_TILE:
                s[..., sk - t * KEY_TILE:] = -math.inf
            if t == drop_tile:
                s[:] = -math.inf
            m_new = torch.maximum(m, s.amax(-1) * scale_log2)
            # a dropped first tile leaves m at -inf: keep its alpha 0
            alpha = torch.exp2(m - m_new).nan_to_num(0.0)
            p = torch.exp2(_fma(s, scale_log2.double(), -m_new[..., None])).nan_to_num(0.0)
            l = l * alpha + p.sum(-1)
            acc = (acc * alpha[..., None] if rescale else acc) + p @ vh[:, :, keys]
            m = m_new
        parts.append((m, l, acc))
    if merge_twice:
        parts[1] = parts[0]
    mx = functools.reduce(torch.maximum, [p[0] for p in parts])
    lsum = torch.zeros_like(mx)
    out = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:  # rank order
        w = torch.exp2(m - mx)
        lsum = lsum + w * l
        out = out + w[..., None] * acc
    out = (out / lsum[..., None])[:, :, :sq].transpose(1, 2).reshape(b, sq, hd)
    lse = ((mx + torch.log2(lsum)) * math.log(2.0))[:, :, :sq]
    return out, lse


def _qkv(b, sq, sk, h, seed=0):
    rng = np.random.default_rng(seed + 7 * sq + sk + h)
    mk = lambda s: torch.from_numpy(rng.standard_normal((b, s, h * D)).astype(np.float32))
    return mk(sq), mk(sk), mk(sk)


@functools.lru_cache(maxsize=None)
def _pallas_packed(b, sq, sk, h):
    """The Pallas packed kernel's f32 output on ``_qkv(b, sq, sk, h)``."""
    q, k, v = _qkv(b, sq, sk, h)
    out = flash_attention_tpu_packed(*(jnp.asarray(x.numpy()) for x in (q, k, v)), num_heads=h,
                                     scale=D**-0.5, interpret=True)
    return torch.from_numpy(np.array(out))


def _err(case, **kw):
    """max |emulation - Pallas packed| on ``case`` under the host's split."""
    b, sq, sk, h = case
    q, k, v = _qkv(b, sq, sk, h)
    out, _ = emulate_f32reg_forward(q, k, v, h, D**-0.5, **{"split": plan(*case), **kw})
    assert out.dtype == torch.float32 and out.shape == q.shape
    return (out - _pallas_packed(*case)).abs().max().item()


def test_plan_splits_the_decoder_and_not_the_encoder():
    """Spann3R's decoder [1, 768, 8, 64] (96 items of 64 rows) splits its
    keys over 2 blocks; the encoder at 20 and 25 frames does not split."""
    assert plan(1, 768, 768, 8) == 2
    assert plan(20, 768, 768, 12) == plan(25, 768, 768, 12) == 1
    assert [plan(*c) for c in CASES] == [2, 4, 1, 4]


@pytest.mark.parametrize("case", CASES)
def test_emulation_matches_pallas_packed_interpret(case):
    err = _err(case)
    assert err <= F32_OUT_TOL, err


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("planned", [False, True])
def test_emulation_lse_matches_pallas_fwd_lse_interpret(case, planned):
    """The lse entry without a split (one block per item) and under the
    host's split."""
    b, sq, sk, h = case
    q, k, v = _qkv(b, sq, sk, h, seed=1)
    split = plan(*case) if planned else 1
    out, lse = emulate_f32reg_forward(q, k, v, h, D**-0.5, split=split)
    split_heads = lambda x: jnp.asarray(x.numpy()).reshape(b, x.shape[1], h, D)
    o_jax, lse_jax = flash_attention_tpu_fwd_lse(split_heads(q), split_heads(k), split_heads(v),
                                                 scale=D**-0.5, interpret=True)
    lse_jax = torch.from_numpy(np.array(lse_jax))[:, :sq].reshape(b, h, sq)
    assert lse.shape == (b, h, sq)
    assert (lse - lse_jax).abs().max().item() <= LSE_TOL
    o_jax = torch.from_numpy(np.array(o_jax)).reshape(b, sq, h * D)
    assert (out - o_jax).abs().max().item() <= F32_OUT_TOL


@pytest.mark.parametrize(
    "case,fault",
    [((1, 768, 768, 2), {"drop_tile": 7}),
     ((1, 70, 100, 2), {"mask_last_tile": False}),
     ((2, 130, 61, 1), {"mask_last_tile": False}),
     ((1, 768, 768, 2), {"rescale": False}),
     ((1, 257, 257, 2), {"rescale": False}),
     ((1, 768, 768, 2), {"merge_twice": True}),
     ((1, 257, 257, 2), {"merge_twice": True})],
)
def test_emulated_planted_faults_fail_the_limit(case, fault):
    """The twins of the card's planted faults miss 1e-5 by 3x or more."""
    err = _err(case, **fault)
    assert err >= 3 * F32_OUT_TOL, (fault, err)


def test_planted_fault_anchors_are_unique():
    """Each planted fault of tests/test_torch_cuda.py (built on the card)
    finds its anchor once in its source, and its replacement changes it."""
    import importlib.util
    import os

    from unigeo_tpu_torch import _build

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location("card_tests",
                                                  os.path.join(here, "test_torch_cuda.py"))
    card = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(card)
    for name, (fname, anchor, faulty) in card.PLANTED_FAULTS.items():
        with open(os.path.join(_build.CSRC_DIR, fname)) as f:
            assert f.read().count(anchor) == 1, name
        assert faulty != anchor, name


F32_VARIANT_NAMES = ["built", "earlier_d64", "warps8", "stages3", "full_unroll", "half_unroll",
                     "earlier_d512", "w512_bk8", "w512_no_split", "w512_unroll4",
                     "w512_unroll2"]


@pytest.mark.parametrize("name", F32_VARIANT_NAMES)
def test_f32_variant_anchors_are_unique(name):
    """Each f32 variant of tools/forward_variants.py (built on the card: the
    d = 64 body's and, since the d = 512 body was redesigned, that one's)
    finds each anchor once in its source, and its replacement changes it."""
    import os

    from unigeo_tpu_torch import _build
    from unigeo_tpu_torch.tools.forward_variants import F32_VARIANTS

    assert sorted(F32_VARIANTS) == sorted(F32_VARIANT_NAMES)
    for fname, anchor, repl in F32_VARIANTS[name]:
        with open(os.path.join(_build.CSRC_DIR, fname)) as f:
            assert f.read().count(anchor) == 1, (name, anchor)
        assert repl != anchor, name
