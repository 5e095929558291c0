"""The bf16 forward's wgmma bodies at the wide head widths
(csrc/flash_attention_packed.cu: CLIP's D = 80 and the VAE's D = 512), their
tiling and arithmetic emulated in torch on the CPU, against the JAX
package's Pallas kernels in interpret mode.

The emulation follows the kernels step by step.  D = 80: blocks of 192
queries (three consumers of 64 rows), key tiles of 64.  D = 512: blocks of
64 queries whose two consumers each own 256 output columns, key tiles of
32; per tile each consumer computes its partial S_c over its 256 columns of
the d-sum, and both form S = S_0 + S_1 in that order.  Both: query rows past
Sq computed on zeros and dropped; the tiles past Sk filled with zero rows as
the TMA fills them; per tile the f32 scores, the running max m in log2 units
(max(m, rowmax(S) * scale * log2 e)), alpha = 2^(m_old - m_new),
p = 2^(S * scale * log2 e - m) summed in f32 into l, P rounded to bf16
before P v; on the last tile only, when Sk is ragged, the keys past Sk
score -inf.  out = acc / l in bf16, lse = (m + log2 l) ln 2 (consumer 0's).

Inputs are bf16, made with numpy from a seed.  Tolerances: the output
within ``bf16_error_limit`` (1.0625 (2^-7 |ref| + 2^-8 P|V|), ref the plain
f32 version: the emulation and the Pallas kernel each round P to bf16, at
their own running max, and the output once); the lse within LSE_TOL = 1e-4
(f32 in both, sums in another order and exp2/log2 for exp/log).  Two faults
fail the limit: without the last tile's mask the TMA's zero key rows score
0 instead of -inf and take weight 2^-m each (the CPU twin of the planted
fault ``no_ragged_mask`` in tests/test_torch_cuda.py; by at least 3x where
the last tile holds 8 or more zero rows, and only asserted to fail it where
it holds fewer), and at D = 512 a trade that reads
a consumer's own partial back (S = S_c + S_c, the twin of
``trade_reads_own_partial``; by at least 3x).
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unigeo_tpu.ops.attention import flash_attention_tpu_fwd_lse, flash_attention_tpu_packed
from unigeo_tpu_torch.ops.attention import attention_packed_reference, bf16_error_limit

LSE_TOL = 1e-4
# per head width: queries of a block, keys of a tile, consumers that split
# the output columns (and trade partial scores)
BLOCK_Q = {80: 192, 512: 64}
KEY_TILE = {80: 64, 512: 32}
COLUMN_SPLIT = {80: 1, 512: 2}
HEADS = {80: 2, 512: 1}  # CLIP's heads are 80 wide, the VAE's one head 512
B = 1

# (Sq, Sk) ragged in Sk (every key tile count here ends in a partial tile)
# and in Sq, at the two head widths
CASES = [(sq, sk, d) for sq, sk in ((70, 100), (257, 257), (130, 61)) for d in (80, 512)]


def _heads(x, h):
    b, s, hd = x.shape
    return x.float().reshape(b, s, h, hd // h).transpose(1, 2)  # [B, H, S, D]


def emulate_wide_forward(q, k, v, h, scale, mask_last_tile=True, own_partial_twice=False):
    """(out bf16 [B, Sq, H*D], lse f32 [B, H, Sq]) by the wide bodies' tiling
    and arithmetic; bf16 q, k, v [B, S, H*D].  ``own_partial_twice``: each
    consumer's S is its own partial added twice."""
    b, sq, hd = q.shape
    sk, d = k.shape[1], hd // h
    block_q, key_tile, split = BLOCK_Q[d], KEY_TILE[d], COLUMN_SPLIT[d]
    n_tiles = -(-sk // key_tile)
    pad_q, pad_k = -(-sq // block_q) * block_q - sq, n_tiles * key_tile - sk
    zeros = lambda x, n: torch.cat([x, x.new_zeros(b, n, hd)], dim=1)
    qh, kh, vh = _heads(zeros(q, pad_q), h), _heads(zeros(k, pad_k), h), _heads(zeros(v, pad_k), h)
    scale_log2 = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    rows, dc = qh.shape[2], d // split
    cols = [slice(c * dc, (c + 1) * dc) for c in range(split)]
    outs, lses = [], []
    for c in range(split):  # consumer c: output columns cols[c]
        m = torch.full((b, h, rows), -math.inf)
        l = torch.zeros(b, h, rows)
        acc = torch.zeros(b, h, rows, dc)
        for t in range(n_tiles):
            keys = slice(t * key_tile, (t + 1) * key_tile)
            partial = [qh[..., j] @ kh[:, :, keys, j].transpose(-1, -2) for j in cols]
            if own_partial_twice:
                s = partial[c] + partial[c]
            else:
                s = partial[0]
                for p_j in partial[1:]:
                    s = s + p_j
            if mask_last_tile and t == n_tiles - 1 and sk % key_tile:
                s[..., sk - t * key_tile:] = -math.inf
            m_new = torch.maximum(m, s.amax(-1) * scale_log2)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s * scale_log2 - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p.bfloat16().float() @ vh[:, :, keys, cols[c]]
            m = m_new
        outs.append(acc / l[..., None])
        lses.append((m + torch.log2(l)) * math.log(2.0))
    out = torch.cat(outs, -1)[:, :, :sq].transpose(1, 2).reshape(b, sq, hd).bfloat16()
    return out, lses[0][:, :, :sq]


def _qkv(sq, sk, d, seed=0):
    rng = np.random.default_rng(seed + sq + sk + d)
    mk = lambda s: torch.from_numpy(rng.standard_normal((B, s, HEADS[d] * d)).astype(np.float32))
    return tuple(x.bfloat16() for x in (mk(sq), mk(sk), mk(sk)))


def _jax(x):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


def _ratio(out, q, k, v, h):
    """max over elements of |out - other| / bf16 limit, for a given other."""
    ref = attention_packed_reference(q, k, v, h)
    limit = bf16_error_limit(q, k, v, h, ref)
    return lambda other: ((out.float() - other.float()).abs() / limit).max().item()


@functools.lru_cache(maxsize=None)
def _pallas_packed(sq, sk, d):
    """The Pallas packed kernel's output on ``_qkv(sq, sk, d)``, in f32."""
    q, k, v = _qkv(sq, sk, d)
    out = flash_attention_tpu_packed(_jax(q), _jax(k), _jax(v), num_heads=HEADS[d],
                                     scale=d**-0.5, interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


@pytest.mark.parametrize("sq,sk,d", CASES)
def test_emulation_matches_pallas_packed_interpret(sq, sk, d):
    q, k, v = _qkv(sq, sk, d)
    h = HEADS[d]
    out, _ = emulate_wide_forward(q, k, v, h, d**-0.5)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ratio = _ratio(out, q, k, v, h)(_pallas_packed(sq, sk, d))
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("sq,sk,d", CASES)
def test_emulation_lse_matches_pallas_fwd_lse_interpret(sq, sk, d):
    q, k, v = _qkv(sq, sk, d, seed=1)
    h = HEADS[d]
    out, lse = emulate_wide_forward(q, k, v, h, d**-0.5)
    split = lambda x: _jax(x).reshape(B, x.shape[1], h, d)
    o_jax, lse_jax = flash_attention_tpu_fwd_lse(split(q), split(k), split(v), scale=d**-0.5,
                                                 interpret=True)
    lse_jax = torch.from_numpy(np.array(lse_jax))[:, :sq].reshape(B, h, sq)
    assert lse.shape == (B, h, sq)
    assert (lse - lse_jax).abs().max().item() <= LSE_TOL
    o_jax = torch.from_numpy(np.array(o_jax.astype(jnp.float32))).reshape(B, sq, h * d)
    assert _ratio(out, q, k, v, h)(o_jax) <= 1.0


@pytest.mark.parametrize("sq,sk,d", [c for c in CASES if c[1] % KEY_TILE[c[2]]])
def test_emulation_without_last_tile_mask_fails_the_limit(sq, sk, d):
    """The zero key rows past Sk, unmasked, take weight 2^-m each: the
    output misses the limit, by at least 3x where the last tile holds 8 or
    more of them.  With fewer the miss is smaller, and the test asserts only
    that the limit is missed (ratio > 1).  That is both Sk = 61 cases: three
    zero rows in a 64-key tile (D = 80, the output misses the limit by 2.87x)
    and in a 32-key tile (D = 512, by 3.02x)."""
    q, k, v = _qkv(sq, sk, d)
    h = HEADS[d]
    out, _ = emulate_wide_forward(q, k, v, h, d**-0.5, mask_last_tile=False)
    ratio = _ratio(out, q, k, v, h)(_pallas_packed(sq, sk, d))
    zero_rows = -sk % KEY_TILE[d]
    assert ratio > 1.0, (ratio, zero_rows)
    if zero_rows >= 8:
        assert ratio >= 3.0, (ratio, zero_rows)


@pytest.mark.parametrize("sq,sk,d", [c for c in CASES if COLUMN_SPLIT[c[2]] > 1])
def test_emulation_with_own_partial_twice_fails_the_limit(sq, sk, d):
    """S = S_c + S_c (a trade that reads the consumer's own partial back)
    doubles half of the d-sum and drops the other: the output misses the
    limit by far."""
    q, k, v = _qkv(sq, sk, d)
    h = HEADS[d]
    out, _ = emulate_wide_forward(q, k, v, h, d**-0.5, own_partial_twice=True)
    ratio = _ratio(out, q, k, v, h)(_pallas_packed(sq, sk, d))
    assert ratio >= 3.0, ratio
