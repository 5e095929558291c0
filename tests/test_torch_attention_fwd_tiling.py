"""The bf16 forward's wgmma body (csrc/flash_attention_packed.cu, D in {16,
64}), its tiling and arithmetic emulated in torch on the CPU, against the
JAX package's Pallas kernels in interpret mode.

The emulation follows the kernel step by step: blocks of 192 queries (three
consumers of 64 rows), query rows past Sq computed on zeros and dropped;
keys in tiles of 128, the tiles past Sk filled with zero rows as the TMA
fills them; per tile the f32 scores S = q k^T, the running max m in log2
units (max(m, rowmax(S) * scale * log2 e)), alpha = 2^(m_old - m_new),
p = 2^(S * scale * log2 e - m) summed in f32 into l, P rounded to bf16
before P v; on the last tile only, when Sk is ragged, the keys past Sk
score -inf.  out = acc / l in bf16, lse = (m + log2 l) ln 2.

Inputs are bf16, made with numpy from a seed.  Tolerances: the output
within ``bf16_error_limit`` (1.0625 (2^-7 |ref| + 2^-8 P|V|), ref the plain
f32 version: the emulation and the Pallas kernel each round P to bf16, at
their own running max, and the output once); the lse within LSE_TOL = 1e-4
(f32 in both, sums in another order and exp2/log2 for exp/log).  Without
the last tile's mask the TMA's zero key rows score 0 instead of -inf, take
weight 2^-m each, and the output fails the limit: the CPU twin of the
planted fault ``wgmma_no_ragged_mask`` in tests/test_torch_cuda.py.
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
BLOCK_Q, KEY_TILE = 192, 128  # three consumers of 64 rows; a ring slot's keys

# (Sq, Sk) ragged in Sk (100, 61: one partial tile; 257: the last tile holds
# one key) and in Sq, at the two head widths of the body
CASES = [(sq, sk, d) for sq, sk in ((70, 100), (257, 257), (130, 61)) for d in (16, 64)]
B, H = 1, 2


def _heads(x, h):
    b, s, hd = x.shape
    return x.float().reshape(b, s, h, hd // h).transpose(1, 2)  # [B, H, S, D]


def emulate_wgmma_forward(q, k, v, h, scale, mask_last_tile=True):
    """(out bf16 [B, Sq, H*D], lse f32 [B, H, Sq]) by the wgmma body's
    tiling and arithmetic; bf16 q, k, v [B, S, H*D]."""
    b, sq, hd = q.shape
    sk, d = k.shape[1], hd // h
    n_tiles = -(-sk // KEY_TILE)
    pad_q, pad_k = -(-sq // BLOCK_Q) * BLOCK_Q - sq, n_tiles * KEY_TILE - sk
    zeros = lambda x, n: torch.cat([x, x.new_zeros(b, n, hd)], dim=1)
    qh, kh, vh = _heads(zeros(q, pad_q), h), _heads(zeros(k, pad_k), h), _heads(zeros(v, pad_k), h)
    scale_log2 = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    rows = qh.shape[2]
    m = torch.full((b, h, rows), -math.inf)
    l = torch.zeros(b, h, rows)
    acc = torch.zeros(b, h, rows, d)
    for t in range(n_tiles):
        keys = slice(t * KEY_TILE, (t + 1) * KEY_TILE)
        s = qh @ kh[:, :, keys].transpose(-1, -2)
        if mask_last_tile and t == n_tiles - 1 and sk % KEY_TILE:
            s[..., sk - t * KEY_TILE:] = -math.inf
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.bfloat16().float() @ vh[:, :, keys]
        m = m_new
    out = (acc / l[..., None])[:, :, :sq].transpose(1, 2).reshape(b, sq, hd).bfloat16()
    lse = ((m + torch.log2(l)) * math.log(2.0))[:, :, :sq]
    return out, lse


def _qkv(sq, sk, d, seed=0):
    rng = np.random.default_rng(seed + sq + sk + d)
    mk = lambda s: torch.from_numpy(rng.standard_normal((B, s, H * d)).astype(np.float32))
    return tuple(x.bfloat16() for x in (mk(sq), mk(sk), mk(sk)))


def _jax(x):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


def _ratio(out, q, k, v):
    """max over elements of |out - Pallas| / bf16 limit."""
    ref = attention_packed_reference(q, k, v, H)
    return lambda other: ((out.float() - other.float()).abs()
                          / bf16_error_limit(q, k, v, H, ref)).max().item()


@functools.lru_cache(maxsize=None)
def _pallas_packed(sq, sk, d):
    """The Pallas packed kernel's output on ``_qkv(sq, sk, d)``, in f32."""
    q, k, v = _qkv(sq, sk, d)
    out = flash_attention_tpu_packed(_jax(q), _jax(k), _jax(v), num_heads=H, scale=d**-0.5,
                                     interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


@pytest.mark.parametrize("sq,sk,d", CASES)
def test_emulation_matches_pallas_packed_interpret(sq, sk, d):
    q, k, v = _qkv(sq, sk, d)
    out, _ = emulate_wgmma_forward(q, k, v, H, d**-0.5)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ratio = _ratio(out, q, k, v)(_pallas_packed(sq, sk, d))
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize("sq,sk,d", CASES)
def test_emulation_lse_matches_pallas_fwd_lse_interpret(sq, sk, d):
    q, k, v = _qkv(sq, sk, d, seed=1)
    out, lse = emulate_wgmma_forward(q, k, v, H, d**-0.5)
    split = lambda x: _jax(x).reshape(B, x.shape[1], H, d)
    o_jax, lse_jax = flash_attention_tpu_fwd_lse(split(q), split(k), split(v), scale=d**-0.5,
                                                 interpret=True)
    lse_jax = torch.from_numpy(np.array(lse_jax))[:, :sq].reshape(B, H, sq)
    assert lse.shape == (B, H, sq)
    assert (lse - lse_jax).abs().max().item() <= LSE_TOL
    o_jax = torch.from_numpy(np.array(o_jax.astype(jnp.float32))).reshape(B, sq, H * d)
    assert _ratio(out, q, k, v)(o_jax) <= 1.0


@pytest.mark.parametrize("sq,sk,d", [c for c in CASES if c[1] % KEY_TILE])
def test_emulation_without_last_tile_mask_fails_the_limit(sq, sk, d):
    """The zero key rows past Sk, unmasked, take weight 2^-m each: the
    output misses the limit by far."""
    q, k, v = _qkv(sq, sk, d)
    ratio = _ratio(emulate_wgmma_forward(q, k, v, H, d**-0.5, mask_last_tile=False)[0], q, k, v)
    pallas = _pallas_packed(sq, sk, d)
    assert ratio(pallas) >= 3.0, ratio(pallas)
