"""The column-chunked CUDA-core bodies (every head width past the forward's
512 and the backward's 128: ``csrc/flash_attention_packed.cu::
flash_wide_block<T>``, ``csrc/flash_attention_bwd.cu::bwd_{dq,dkv}_wide_kernel
<T>``), their arithmetic emulated in torch on the CPU, against the plain
versions under the limits derived for the CUDA-core bodies, and the plain
versions against the JAX package's Pallas kernels in interpret mode at
these widths (the JAX kernels take any width).

The forward's emulation: query blocks of 16 rows, key tiles of 32; each
tile's scores the sum over the head's column chunks (``wide_chunk``: ceil(d
/ 512) chunks as equal as can be) of the chunk's q . k in f32, times scale,
the keys past Sk at -inf; the online softmax in f32 (P not rounded); each
output chunk's accumulator rescaled and summed over the tiles; the output
rounded to its dtype once, lse = m + log l.  The backward's: S and dP of a
32-row tile summed over the chunks, P = exp(S scale - lse), dS = P (dP -
delta) scale in f32, dq = dS k, dk = dS^T q, dv = P^T dO, each gradient
rounded once.

Tolerances: the forward within ``bf16_cuda_core_error_limit`` (in f32 its
2 E alone), the lse within LSE_TOL = 1e-4; the backward within
``grad_error_limits(cuda_core=True)``.  The Pallas kernels round P (and dS)
to bf16 on bf16 inputs, so in bf16 they are held to ``bf16_error_limit``
and the backward's bf16 limits; in f32 to the f32 limits.  An emulation
whose scores skip the head's first column chunk misses the limit by 10x or
more: the CPU twin of the planted faults ``wide_drop_column_chunk`` and
``wide_dq_drop_column_chunk`` of tests/test_torch_cuda.py.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unigeo_tpu.ops.attention import (
    flash_attention_tpu_bwd,
    flash_attention_tpu_fwd_lse,
    flash_attention_tpu_packed,
)
from unigeo_tpu_torch.ops import attention as att

LSE_TOL = 1e-4
B = 1


def _qkv(sq, sk, h, d, dtype, seed=0):
    rng = np.random.default_rng(seed + 7 * sq + sk + d)
    mk = lambda s: torch.from_numpy(rng.standard_normal((B, s, h * d)).astype(np.float32))
    return tuple(x.to(dtype) for x in (mk(sq), mk(sk), mk(sk)))


def _heads(x, h):
    b, s, hd = x.shape
    return x.float().reshape(b, s, h, hd // h).transpose(1, 2)  # [B, H, S, D]


def _chunks(d):
    dc = att.wide_chunk(d)
    return [(c0, min(dc, d - c0)) for c0 in range(0, d, dc)]


def emulate_forward(q, k, v, h, drop_first_chunk=False):
    """(out in q's dtype, lse) by the column-chunked body's tiles."""
    b, sq, hd = q.shape
    sk, d = k.shape[1], hd // h
    scale = d**-0.5
    qh, kh, vh = _heads(q, h), _heads(k, h), _heads(v, h)
    chunks = _chunks(d)[1:] if drop_first_chunk else _chunks(d)
    m = torch.full((b, h, sq), -math.inf)
    l = torch.zeros(b, h, sq)
    acc = torch.zeros(b, h, sq, d)
    for k0 in range(0, sk, 32):
        s = sum(qh[..., c0:c0 + cw] @ kh[:, :, k0:k0 + 32, c0:c0 + cw].transpose(-1, -2)
                for c0, cw in chunks) * scale
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p @ vh[:, :, k0:k0 + 32]
        m = m_new
    out = (acc / l[..., None]).transpose(1, 2).reshape(b, sq, hd).to(q.dtype)
    return out, m + torch.log(l)


def emulate_dq(q, k, v, out, lse, dout, h, drop_first_chunk=False):
    """dq in q's dtype by the column-chunked dq body's tiles."""
    d = q.shape[2] // h
    scale = d**-0.5
    qh, kh, vh, doh = (_heads(x, h) for x in (q, k, v, dout))
    delta = att._delta(out, dout, h)
    chunks = _chunks(d)[1:] if drop_first_chunk else _chunks(d)
    dq = torch.zeros_like(qh)
    for k0 in range(0, k.shape[1], 32):
        kt, vt = kh[:, :, k0:k0 + 32], vh[:, :, k0:k0 + 32]
        s = sum(qh[..., c0:c0 + cw] @ kt[..., c0:c0 + cw].transpose(-1, -2) for c0, cw in chunks)
        dp = sum(doh[..., c0:c0 + cw] @ vt[..., c0:c0 + cw].transpose(-1, -2)
                 for c0, cw in chunks)
        p = torch.exp(s * scale - lse[..., None])
        dq = dq + (p * (dp - delta[..., None]) * scale) @ kt
    return dq.transpose(1, 2).reshape(q.shape).to(q.dtype)


def _fwd_ratio(out, q, k, v, h, limit_fn=att.bf16_cuda_core_error_limit):
    ref = att.attention_packed_reference(q, k, v, h)
    return ((out.float() - ref.float()).abs() / limit_fn(q, k, v, h, ref)).max().item()


def _bwd_inputs(sq, sk, h, d, dtype, seed):
    q, k, v = _qkv(sq, sk, h, d, dtype, seed=seed)
    out, lse = att.attention_fwd_lse_reference(q, k, v, h)
    dout = _qkv(sq, sq, h, d, dtype, seed=seed + 1)[0]
    return q, k, v, out, lse, dout


def test_wide_chunk_mirrors_the_kernels():
    assert [att.wide_chunk(d) for d in (136, 256, 512, 520, 768, 1024, 1030)] == \
        [136, 256, 512, 260, 384, 512, 344]
    for d in (136, 520, 768, 1030, 2048):
        chunks = _chunks(d)
        assert sum(cw for _, cw in chunks) == d and max(cw for _, cw in chunks) <= 512


def test_wide_widths_take_the_cuda_core_bodies():
    for d in (520, 768, 1024):
        q, k, v = _qkv(40, 40, 1, d, torch.bfloat16)
        assert att.bf16_fwd_on_cuda_core(q, k, v, d)
    for d in (136, 256, 512, 520):
        q, k, v = _qkv(40, 40, 1, d, torch.bfloat16)
        assert att.bf16_bwd_on_cuda_core(q, k, v, q, d)
    assert not hasattr(att, "FWD_MAX_HEAD_WIDTH") and not hasattr(att, "BWD_MAX_HEAD_WIDTH")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,h,d", [(70, 100, 2, 520), (40, 77, 1, 768), (33, 64, 1, 1024)])
def test_emulated_wide_forward_within_the_cuda_core_limit(dtype, sq, sk, h, d):
    q, k, v = _qkv(sq, sk, h, d, dtype)
    out, lse = emulate_forward(q, k, v, h)
    assert _fwd_ratio(out, q, k, v, h) <= 1.0
    _, ref_lse = att.attention_fwd_lse_reference(q, k, v, h)
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL


@pytest.mark.parametrize("dtype,d", [(torch.float32, 768), (torch.bfloat16, 1024),
                                     (torch.bfloat16, 520)])
def test_dropped_column_chunk_fails_the_limit_by_10x(dtype, d):
    q, k, v = _qkv(64, 200, 1, d, dtype, seed=5)
    assert _fwd_ratio(emulate_forward(q, k, v, 1)[0], q, k, v, 1) <= 1.0
    assert _fwd_ratio(emulate_forward(q, k, v, 1, drop_first_chunk=True)[0], q, k, v, 1) >= 10.0
    q, k, v, out, lse, dout = _bwd_inputs(64, 100, 1, d, dtype, seed=6)
    refs = att.attention_bwd_reference(q, k, v, out, lse, dout, 1)
    limit = att.grad_error_limits(q, k, v, out, lse, dout, 1, refs, cuda_core=True)[0]
    ratio = lambda dq: ((dq.float() - refs[0].float()).abs() / limit).max().item()
    assert ratio(emulate_dq(q, k, v, out, lse, dout, 1)) <= 1.0
    assert ratio(emulate_dq(q, k, v, out, lse, dout, 1, drop_first_chunk=True)) >= 10.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,h,d", [(50, 70, 2, 136), (40, 33, 1, 512), (30, 45, 1, 520)])
def test_emulated_wide_dq_within_the_cuda_core_limit(dtype, sq, sk, h, d):
    q, k, v, out, lse, dout = _bwd_inputs(sq, sk, h, d, dtype, seed=2)
    refs = att.attention_bwd_reference(q, k, v, out, lse, dout, h)
    limit = att.grad_error_limits(q, k, v, out, lse, dout, h, refs, cuda_core=True)[0]
    dq = emulate_dq(q, k, v, out, lse, dout, h)
    assert ((dq.float() - refs[0].float()).abs() / limit).max().item() <= 1.0


def _jax(x, dtype):
    return jnp.asarray(x.float().numpy()).astype(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_forward_at_d520_matches_the_pallas_kernels(dtype):
    """The plain forward (the wide bodies' reference) against the JAX
    packed kernel and its lse kernel in interpret mode at d = 520."""
    sq, h, d = 40, 1, 520
    q, k, v = _qkv(sq, sq, h, d, dtype, seed=8)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    got = flash_attention_tpu_packed(_jax(q, jdt), _jax(k, jdt), _jax(v, jdt), num_heads=h,
                                     scale=d**-0.5, interpret=True)
    got = torch.from_numpy(np.array(got.astype(jnp.float32))).reshape(q.shape)
    limit_fn = att.bf16_error_limit if dtype == torch.bfloat16 else att.bf16_cuda_core_error_limit
    assert _fwd_ratio(got, q, k, v, h, limit_fn) <= 1.0
    split = lambda x: _jax(x, jdt).reshape(B, sq, h, d)
    _, lse = flash_attention_tpu_fwd_lse(split(q), split(k), split(v), scale=d**-0.5,
                                         interpret=True)
    _, ref_lse = att.attention_fwd_lse_reference(q, k, v, h)
    lse = torch.from_numpy(np.array(lse))[:, :sq].reshape(B, h, sq)
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_at_d512_matches_the_pallas_kernel(dtype):
    """The plain backward (the wide bodies' reference) against the JAX
    backward in interpret mode at the VAE mid block's d = 512, small S."""
    sq, h, d = 24, 1, 512
    q, k, v, out, lse, dout = _bwd_inputs(sq, sq, h, d, dtype, seed=9)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    split = lambda x: _jax(x, jdt).reshape(B, sq, h, d)
    lse_j = jnp.asarray(lse.reshape(B * h, sq).numpy())
    grads = flash_attention_tpu_bwd(split(q), split(k), split(v), split(out), lse_j,
                                    split(dout), scale=d**-0.5, interpret=True)
    grads = [torch.from_numpy(np.array(g.astype(jnp.float32))).reshape(B, sq, h * d)
             for g in grads]
    refs = att.attention_bwd_reference(q, k, v, out, lse, dout, h)
    limits = att.grad_error_limits(q, k, v, out, lse, dout, h, refs)
    for g, r, lim in zip(grads, refs, limits):
        assert ((g - r.float()).abs() / lim).max().item() <= 1.0
