"""The bf16 CUDA-core bodies (``csrc/flash_attention_packed.cu::flash_f32_block
<__nv_bfloat16>``, ``csrc/flash_attention_bwd.cu::bwd_{dq,dkv}_f32_kernel
<__nv_bfloat16>``), their arithmetic emulated in torch on the CPU, against
the plain versions under the limits derived for them, and the JAX package's
Pallas kernels in interpret mode at the same head widths (which take any d).

The forward's emulation: bf16 q, k, v read into f32, query blocks of BQ rows
(64 at d <= 128, 16 above), key tiles of BK (64, or 32 above d = 128); per
tile the f32 scores times scale, the keys past Sk at -inf, the running max,
alpha = exp(m_old - m_new), p = exp(s - m_new) in f32 (not rounded), l and
acc rescaled by alpha, out = acc / l rounded to bf16 once, lse = m + log l.
The backward's: P = exp(S scale - lse), dS = P (dP - delta) scale in f32, dq
= dS k, dk = dS^T q, dv = P^T dO over 64-row tiles, each gradient rounded
to bf16 once.

Tolerances: the forward within ``bf16_cuda_core_error_limit``, 1.0625 (2^-7
|ref| + 2 E), E each version's f32 error (see there); the backward within
``grad_error_limits(cuda_core=True)``; the lse within LSE_TOL = 1e-4.  The
Pallas kernels round P to bf16 as the wgmma bodies do, so they are held to
``bf16_error_limit`` and the backward's bf16 limits.  An emulation that drops
its eighth key tile misses the CUDA-core limit by 10x or more: the CPU twin
of the planted fault ``bf16_cuda_core_drop_key_tile`` of
tests/test_torch_cuda.py.  The body is chosen by shape and alignment alone
(``bf16_fwd_on_cuda_core``, ``bf16_bwd_on_cuda_core``).
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unigeo_tpu.ops.attention import flash_attention_tpu_bwd, flash_attention_tpu_packed
from unigeo_tpu_torch.ops import attention as att

LSE_TOL = 1e-4
B = 1


def _qkv(sq, sk, h, d, seed=0):
    rng = np.random.default_rng(seed + 7 * sq + sk + d)
    mk = lambda s: torch.from_numpy(rng.standard_normal((B, s, h * d)).astype(np.float32))
    return tuple(x.bfloat16() for x in (mk(sq), mk(sk), mk(sk)))


def _heads(x, h):
    b, s, hd = x.shape
    return x.float().reshape(b, s, h, hd // h).transpose(1, 2)  # [B, H, S, D]


def emulate_forward(q, k, v, h, drop_tile=None):
    """(out bf16, lse f32 [B, H, Sq]) by the CUDA-core body's tiles and f32
    arithmetic; ``drop_tile``: that key tile's scores at -inf."""
    b, sq, hd = q.shape
    sk, d = k.shape[1], hd // h
    bk = 64 if d <= 128 else 32
    scale = d**-0.5
    qh, kh, vh = _heads(q, h), _heads(k, h), _heads(v, h)
    m = torch.full((b, h, sq), -math.inf)
    l = torch.zeros(b, h, sq)
    acc = torch.zeros(b, h, sq, d)
    for t, k0 in enumerate(range(0, sk, bk)):
        s = (qh @ kh[:, :, k0:k0 + bk].transpose(-1, -2)) * scale
        if t == drop_tile:
            s = torch.full_like(s, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p @ vh[:, :, k0:k0 + bk]
        m = m_new
    out = (acc / l[..., None]).transpose(1, 2).reshape(b, sq, hd).bfloat16()
    return out, m + torch.log(l)


def emulate_backward(q, k, v, out, lse, dout, h):
    """(dq, dk, dv) bf16 by the CUDA-core backward's f32 arithmetic."""
    d = q.shape[2] // h
    scale = d**-0.5
    qh, kh, vh, doh = (_heads(x, h) for x in (q, k, v, dout))
    delta = att._delta(out, dout, h)
    p = torch.exp((qh @ kh.transpose(-1, -2)) * scale - lse[..., None])
    ds = p * ((doh @ vh.transpose(-1, -2)) - delta[..., None]) * scale
    back = lambda x, like: x.transpose(1, 2).reshape(like.shape).bfloat16()
    return back(ds @ kh, q), back(ds.transpose(-1, -2) @ qh, k), \
        back(p.transpose(-1, -2) @ doh, v)


def _ratio(out, q, k, v, h, limit_fn=att.bf16_cuda_core_error_limit):
    ref = att.attention_packed_reference(q, k, v, h)
    return ((out.float() - ref.float()).abs() / limit_fn(q, k, v, h, ref)).max().item()


def _jax(x):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


# (Sq, Sk, H, D): the tiny pointmap configs' 24 and 32 (a [., 768, 2, 32]
# attention and ragged ones), 80, 128, and 200 (16-row blocks, 32-key tiles)
FWD_CASES = [(768, 768, 2, 32), (130, 61, 2, 24), (257, 257, 2, 24), (200, 150, 2, 80),
             (130, 200, 1, 128), (96, 77, 1, 200)]


@pytest.mark.parametrize("sq,sk,h,d", FWD_CASES)
def test_emulated_forward_within_the_cuda_core_limit(sq, sk, h, d):
    q, k, v = _qkv(sq, sk, h, d)
    out, lse = emulate_forward(q, k, v, h)
    assert _ratio(out, q, k, v, h) <= 1.0
    _, ref_lse = att.attention_fwd_lse_reference(q, k, v, h)
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL


@pytest.mark.parametrize("sq,sk,h,d", FWD_CASES[:4])
def test_pallas_kernel_at_the_same_widths(sq, sk, h, d):
    """The JAX package's packed kernel (interpret mode) takes these widths:
    within the limit of a body that rounds P (bf16_error_limit)."""
    q, k, v = _qkv(sq, sk, h, d)
    out = flash_attention_tpu_packed(_jax(q), _jax(k), _jax(v), num_heads=h, scale=d**-0.5,
                                     interpret=True)
    out = torch.from_numpy(np.array(out.astype(jnp.float32)))
    assert _ratio(out, q, k, v, h, att.bf16_error_limit) <= 1.0


@pytest.mark.parametrize("sq,sk,h,d", [(768, 768, 2, 32), (1024, 1024, 2, 24), (600, 600, 1, 128)])
def test_dropped_key_tile_fails_the_limit_by_10x(sq, sk, h, d):
    q, k, v = _qkv(sq, sk, h, d, seed=5)
    assert _ratio(emulate_forward(q, k, v, h)[0], q, k, v, h) <= 1.0
    assert _ratio(emulate_forward(q, k, v, h, drop_tile=7)[0], q, k, v, h) >= 10.0


def test_cuda_core_limit_is_within_the_wgmma_limit():
    """Not rounding P takes its 2^-8 P|V| term away: the CUDA-core limit is
    below the wgmma bodies' everywhere (no limit was widened)."""
    q, k, v = _qkv(257, 257, 2, 32)
    ref = att.attention_packed_reference(q, k, v, 2)
    assert (att.bf16_cuda_core_error_limit(q, k, v, 2, ref)
            < att.bf16_error_limit(q, k, v, 2, ref)).all()


@pytest.mark.parametrize("sq,sk,h,d", [(768, 768, 2, 32), (257, 257, 4, 80), (130, 61, 3, 24),
                                       (200, 150, 2, 128)])
def test_emulated_backward_within_the_cuda_core_limit(sq, sk, h, d):
    q, k, v = _qkv(sq, sk, h, d, seed=2)
    out, lse = att.attention_fwd_lse_reference(q, k, v, h)
    dout = _qkv(sq, sq, h, d, seed=3)[0]
    grads = emulate_backward(q, k, v, out, lse, dout, h)
    refs = att.attention_bwd_reference(q, k, v, out, lse, dout, h)
    limits = att.grad_error_limits(q, k, v, out, lse, dout, h, refs, cuda_core=True)
    wgmma = att.grad_error_limits(q, k, v, out, lse, dout, h, refs)
    for g, r, lim, wide in zip(grads, refs, limits, wgmma):
        assert ((g.float() - r.float()).abs() / lim).max().item() <= 1.0
        assert (lim <= wide).all()


def test_pallas_backward_at_clip_width():
    """The JAX package's backward (interpret mode) takes CLIP's 80: within
    the bf16 limits of a body that rounds P and dS."""
    sq, h, d = 257, 2, 80
    q, k, v = _qkv(sq, sq, h, d, seed=4)
    out, lse = att.attention_fwd_lse_reference(q, k, v, h)
    dout = _qkv(sq, sq, h, d, seed=6)[0]
    split = lambda x: _jax(x).reshape(B, sq, h, d)
    lse_j = jnp.asarray(lse.reshape(B * h, sq).numpy())  # the kernel pads it
    dq, dk, dv = flash_attention_tpu_bwd(split(q), split(k), split(v), split(out), lse_j,
                                         split(dout), scale=d**-0.5, interpret=True)
    grads = [torch.from_numpy(np.array(g.astype(jnp.float32))).reshape(B, sq, h * d)
             for g in (dq, dk, dv)]
    refs = att.attention_bwd_reference(q, k, v, out, lse, dout, h)
    limits = att.grad_error_limits(q, k, v, out, lse, dout, h, refs)
    for g, r, lim in zip(grads, refs, limits):
        assert ((g - r.float()).abs() / lim).max().item() <= 1.0


def test_body_choice_by_shape_and_alignment():
    q, k, v = _qkv(130, 130, 2, 64)
    assert not att.bf16_fwd_on_cuda_core(q, k, v, 64)
    shifted = [torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape) for x in (q, k, v)]
    assert shifted[0].data_ptr() % 16
    assert att.bf16_fwd_on_cuda_core(*shifted, 64)
    assert att.bf16_bwd_on_cuda_core(*shifted, q, 64)
    for d, fwd, bwd in ((16, False, False), (80, False, True), (512, False, True),
                        (24, True, True), (32, True, True), (128, True, True)):
        q, k, v = _qkv(130, 130, 1, d)
        assert att.bf16_fwd_on_cuda_core(q, k, v, d) == fwd, d
        assert att.bf16_bwd_on_cuda_core(q, k, v, q, d) == bwd, d
