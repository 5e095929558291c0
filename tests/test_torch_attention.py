"""The port's packed attention (plain version, CPU) against the JAX package.

Inputs are made with numpy from a seed and handed to both packages, in f32.
The JAX side is ``attention_reference`` and the Pallas kernel
``flash_attention_tpu_packed`` in interpret mode, run as
tests/test_ops_attention.py runs it.  d = 10 stands in for CLIP's 80 (not a
power of two) and the single-head d = 32 for the VAE's 512.

Tolerance 1e-5 absolute: f32 on both sides, outputs of order 1; only the
order of the sums differs (the JAX reference and kernel are chunked online
softmaxes, the port's plain version is one dense softmax).
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unigeo_tpu.ops.attention import attention_reference, flash_attention_tpu_packed
from unigeo_tpu_torch.models.layers import attend
from unigeo_tpu_torch.ops.attention import (
    attention_packed_reference,
    flash_attention_packed,
)

TOL = 1e-5

# (b, sq, sk, heads, d): ragged S_k in every case that has sq != sk or sk
# not a multiple of the interpret-mode key block (64)
CASES = [
    (2, 70, 100, 3, 8),
    (2, 70, 100, 3, 10),
    (2, 40, 77, 2, 64),
    (1, 96, 130, 1, 32),
]


def _qkv(b, sq, sk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, sq, h * d)).astype(np.float32),
        rng.standard_normal((b, sk, h * d)).astype(np.float32),
        rng.standard_normal((b, sk, h * d)).astype(np.float32),
    )


@pytest.mark.parametrize("b,sq,sk,h,d", CASES)
def test_plain_matches_jax_attention_reference(b, sq, sk, h, d):
    q, k, v = _qkv(b, sq, sk, h, d)
    ref = attention_reference(
        jnp.asarray(q.reshape(b, sq, h, d)), jnp.asarray(k.reshape(b, sk, h, d)),
        jnp.asarray(v.reshape(b, sk, h, d)), d**-0.5,
    )
    out = attention_packed_reference(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), h)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref).reshape(b, sq, h * d),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("b,sq,sk,h,d", CASES)
def test_plain_matches_pallas_packed_interpret(b, sq, sk, h, d):
    q, k, v = _qkv(b, sq, sk, h, d, seed=1)
    ref = flash_attention_tpu_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=h, scale=d**-0.5,
        block_q=32, block_k=64, interpret=True,
    )
    out = attention_packed_reference(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), h)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("b,sq,sk,h,d", CASES)
def test_wrapper_on_cpu_runs_plain_version_without_counting(b, sq, sk, h, d):
    q, k, v = (torch.from_numpy(a) for a in _qkv(b, sq, sk, h, d, seed=2))
    before = flash_attention_packed.launches
    out = flash_attention_packed(q, k, v, h)
    assert flash_attention_packed.launches == before
    torch.testing.assert_close(out, attention_packed_reference(q, k, v, h), atol=0, rtol=0)
    # the plain version in the input dtype (the layers' short-sequence
    # path), and the layers' dispatch on either side of 128 tokens, compute
    # the same function
    torch.testing.assert_close(attention_packed_reference(q, k, v, h, upcast=False), out,
                               atol=TOL, rtol=0)
    torch.testing.assert_close(attend(q, k, v, h, d), out, atol=TOL, rtol=0)


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(2, 10, 12)
    with pytest.raises(ValueError):
        flash_attention_packed(q, torch.zeros(2, 10, 8), torch.zeros(2, 10, 8), 3)
    with pytest.raises(ValueError):
        flash_attention_packed(q, q, q, 5)
    with pytest.raises(ValueError):
        flash_attention_packed(q[0], q[0], q[0], 3)
    with pytest.raises(ValueError):
        flash_attention_packed(q, q.double(), q, 3)
