"""The port's forward-with-logsumexp and backward (plain versions, CPU)
against the JAX package's Pallas kernels in interpret mode.

Inputs are made with numpy from a seed and handed to both packages, in f32
and the packed layout.  The JAX side runs ``flash_attention_tpu_fwd_lse``
and ``flash_attention_tpu_bwd`` with ``interpret=True`` and small tiles, as
tests/test_ops_attention.py runs them; the backward gets the same (out, lse)
on both sides, the JAX one with its padded lse rows.

Tolerances, absolute, f32 on both sides, only the order of the sums differs
(the JAX kernels are tiled online softmaxes, the port's plain versions dense
einsums): outputs and gradients of order 1, 1e-5; the logsumexp (values of
order 5), 2e-5.  ``FlashAttentionPacked`` on the CPU against
``torch.autograd.grad`` through ``attention_packed_reference``: 1e-5.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unigeo_tpu.ops.attention import flash_attention_tpu_bwd, flash_attention_tpu_fwd_lse
from unigeo_tpu_torch.models.layers import attend
from unigeo_tpu_torch.ops.attention import (
    FlashAttentionPacked,
    _delta,
    attention_bwd_reference,
    attention_fwd_lse_reference,
    attention_packed_reference,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_fwd_lse,
)

TOL = 1e-5
LSE_TOL = 2e-5
B, H, D = 1, 2, 32


def _inputs(sq, sk, seed):
    rng = np.random.default_rng(seed)
    mk = lambda s: rng.standard_normal((B, s, H * D)).astype(np.float32)
    return mk(sq), mk(sk), mk(sk), mk(sq)  # q, k, v, dO


def _split(x):
    return jnp.asarray(x.reshape(x.shape[0], x.shape[1], H, D))


def _jax_fwd_lse(q, k, v):
    out, lse = flash_attention_tpu_fwd_lse(
        _split(q), _split(k), _split(v), scale=D**-0.5, block_q=32, block_k=64,
        interpret=True,
    )
    return out, lse


@pytest.mark.parametrize("sq,sk", [(64, 64), (70, 100), (100, 1)])
def test_fwd_lse_plain_matches_pallas_interpret(sq, sk):
    q, k, v, _ = _inputs(sq, sk, seed=sq + sk)
    out_j, lse_j = _jax_fwd_lse(q, k, v)
    out, lse = attention_fwd_lse_reference(*(torch.from_numpy(x) for x in (q, k, v)), H)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j).reshape(B, sq, H * D),
                               atol=TOL, rtol=0)
    # the JAX lse is [B*H, Sq_pad]; its unpadded rows are the port's [B, H, Sq]
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, :sq].reshape(B, H, sq),
                               atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("sq,sk", [(64, 64), (70, 100), (100, 1)])
def test_bwd_plain_matches_pallas_interpret(sq, sk):
    q, k, v, g = _inputs(sq, sk, seed=10 + sq + sk)
    out_j, lse_j = _jax_fwd_lse(q, k, v)
    grads_j = flash_attention_tpu_bwd(
        _split(q), _split(k), _split(v), out_j, lse_j, _split(g), scale=D**-0.5,
        block_q=32, block_k=64, interpret=True,
    )
    out = torch.from_numpy(np.array(out_j).reshape(B, sq, H * D))
    lse = torch.from_numpy(np.ascontiguousarray(np.array(lse_j)[:, :sq]).reshape(B, H, sq))
    qt, kt, vt, gt = (torch.from_numpy(x) for x in (q, k, v, g))
    grads = attention_bwd_reference(qt, kt, vt, out, lse, gt, H)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref).reshape(got.shape),
                                   atol=TOL, rtol=0, err_msg=name)
    # the wrappers' CPU path is the plain version, and counts no launch
    counts = (flash_attention_fwd_lse.launches, flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    for got, ref in zip(flash_attention_bwd(qt, kt, vt, out, lse, gt, H), grads):
        torch.testing.assert_close(got, ref, atol=0, rtol=0)
    delta = _delta(out, gt, H)
    torch.testing.assert_close(flash_attention_bwd_dq(qt, kt, vt, gt, lse, delta, H), grads[0],
                               atol=0, rtol=0)
    for got, ref in zip(flash_attention_bwd_dkv(qt, kt, vt, gt, lse, delta, H), grads[1:]):
        torch.testing.assert_close(got, ref, atol=0, rtol=0)
    assert counts == (flash_attention_fwd_lse.launches, flash_attention_bwd_dq.launches,
                      flash_attention_bwd_dkv.launches)


@pytest.mark.parametrize("sq,sk", [(128, 128), (130, 70), (140, 1)])
def test_autograd_function_matches_autograd_through_plain(sq, sk):
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(sq, sk, seed=20 + sq + sk))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = FlashAttentionPacked.apply(*leaves, H, D**-0.5)
    grads = torch.autograd.grad(out, leaves, g)
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref_out = attention_packed_reference(*ref_leaves, H)
    refs = torch.autograd.grad(ref_out, ref_leaves, g)
    torch.testing.assert_close(out, ref_out, atol=TOL, rtol=0)
    for got, ref in zip(grads, refs):
        torch.testing.assert_close(got, ref, atol=TOL, rtol=0)
    # the layers' dispatch takes the differentiable kernel path under
    # autograd from 128 query tokens on, and gives the same gradients
    att = attend(*leaves, H, D)
    assert att.grad_fn is not None
    if sq >= 128:
        assert type(att.grad_fn).__name__.startswith("FlashAttentionPacked")
    for got, ref in zip(torch.autograd.grad(att, leaves, g), refs):
        torch.testing.assert_close(got, ref, atol=TOL, rtol=0)


def test_attend_without_grad_stays_on_the_forward_kernel():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(128, 128, seed=3))
    with torch.no_grad():
        out = attend(q.requires_grad_(), k, v, H, D)
    assert out.grad_fn is None
    torch.testing.assert_close(out, attention_packed_reference(q, k, v, H), atol=0, rtol=0)


def test_bwd_wrappers_reject_bad_inputs():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(70, 100, seed=4))
    out, lse = attention_fwd_lse_reference(q, k, v, H)
    with pytest.raises(ValueError):  # lse in the JAX package's padded [B*H, Sq_pad]
        flash_attention_bwd(q, k, v, out, lse.reshape(B * H, 70), g, H)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, out, lse, g[:, :50], H)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, out[:, :50], lse, g, H)
    with pytest.raises(ValueError):
        flash_attention_bwd_dq(q, k, v, g, lse, lse.double(), H)
