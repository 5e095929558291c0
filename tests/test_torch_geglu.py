"""The port's fused GEGLU feed-forward (plain version, CPU) against the JAX package.

Inputs are made with numpy from a seed and handed to both packages in bf16.
The JAX side is the Pallas kernel ``geglu_ffn_tpu`` in interpret mode, as
tests/test_geglu_fused.py runs it, and its ``geglu_ffn_reference``.

Tolerances:
  * plain version and fused ``FeedForward`` against the interpret-mode
    kernel: ``geglu_error_limit``, 1.0625 (2^-7 |ref| + (2^-7 + 2 H 2^-24) T
    + F_up), T = |h| |w2|^T.  Both compute the same function (f32 products,
    h rounded to bf16 once, the output once) and differ only in the order of
    the f32 sums, which can move h and the output by one bf16 unit each
    (see the function's docstring).  The ``FeedForward`` adds b2 in bf16 on
    both sides: one more rounding of each side's sum, 2^-7 of its magnitude.
  * ``GegluFFN``'s gradients against ``jax.vjp(geglu_ffn_reference)`` in
    bf16: 3e-2 of the largest magnitude of each gradient.  Both sides
    differentiate the same bf16 graph (a bf16 matmul, the tanh gelu, the
    product, a bf16 matmul) but round at other places: XLA rounds every
    elementwise step of the gelu and its derivative to bf16, PyTorch's
    fused gelu rounds once, so each of the backward's ~5 bf16 steps may
    differ by a unit (2^-8 relative), and the matmuls sum up to 4C = 512
    terms of such differences.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from unigeo_tpu.ops.geglu import geglu_ffn_reference as j_reference
from unigeo_tpu.ops.geglu import geglu_ffn_tpu
from unigeo_tpu_torch.models.layers import FeedForward
from unigeo_tpu_torch.ops.geglu import (
    GegluFFN,
    geglu_error_limit,
    geglu_ffn,
    geglu_ffn_plain,
    geglu_ffn_reference,
)
from unigeo_tpu_torch.utils.weights import state_dict_from_flax, unet_flax_path

# (M, C, mult): tests/test_geglu_fused.py's shapes (ragged M, one and several
# hidden tiles, mult 2)
SHAPES = [(100, 64, 4), (256, 128, 4), (37, 64, 2)]
GRAD_TOL = 3e-2


def _inputs(m, c, mult, seed=0):
    """x [M, C], JAX-layout w1 [C, 2H], b1 [2H], w2 [H, C], b2 [C], bf16-exact
    f32 numpy arrays (the scales of tests/test_geglu_fused.py)."""
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return (bf(rng.normal(size=(m, c)) * 0.5), bf(rng.normal(size=(c, 2 * c * mult)) * 0.05),
            bf(rng.normal(size=(2 * c * mult,)) * 0.05), bf(rng.normal(size=(c * mult, c)) * 0.05),
            bf(rng.normal(size=(c,)) * 0.05))


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _jax_fused(x, w1, b1, w2):
    return geglu_ffn_tpu(*(jnp.asarray(a, jnp.bfloat16) for a in (x, w1, b1, w2)),
                         block_m=64, interpret=True)


def _ratio(ours, ref, limit):
    return ((ours.float() - ref.float()).abs() / limit).max().item()


@pytest.mark.parametrize("m,c,mult", SHAPES)
def test_plain_matches_pallas_interpret(m, c, mult):
    x, w1, b1, w2, _ = _inputs(m, c, mult)
    ref = torch.from_numpy(np.asarray(_jax_fused(x, w1, b1, w2).astype(jnp.float32)))
    px, pw1, pb1, pw2 = _bf16(x), _bf16(w1.T), _bf16(b1), _bf16(w2.T)
    before = geglu_ffn.launches
    ours = geglu_ffn(px, pw1, pb1, pw2)
    assert geglu_ffn.launches == before  # the CPU runs the plain version
    torch.testing.assert_close(ours, geglu_ffn_plain(px, pw1, pb1, pw2), atol=0, rtol=0)
    assert ours.dtype == torch.bfloat16 and ours.shape == (m, c)
    limit = geglu_error_limit(px, pw1, pb1, pw2, ours)
    assert _ratio(ours, ref, limit) <= 1.0


def _port_feed_forward(w1, b1, w2, b2, c, mult):
    """A port FeedForward given the JAX layout's weights through the weight
    bridge (``net.0.proj`` and ``net.2`` map with the UNet's existing rules)."""
    holder = nn.Module()
    holder.blk = nn.Module()
    holder.blk.ff = FeedForward(c, mult)
    flax = {"blk": {"ff": {"net_0": {"proj": {"kernel": w1, "bias": b1}},
                           "net_2": {"kernel": w2, "bias": b2}}}}
    holder.load_state_dict(state_dict_from_flax(flax, holder, unet_flax_path))
    return holder.blk.ff.to(torch.bfloat16)


@pytest.mark.parametrize("m,c,mult", SHAPES)
def test_fused_feed_forward_matches_pallas_interpret(m, c, mult, monkeypatch):
    x, w1, b1, w2, b2 = _inputs(m, c, mult, seed=1)
    ref = _jax_fused(x, w1, b1, w2) + jnp.asarray(b2, jnp.bfloat16)
    ref = torch.from_numpy(np.asarray(ref.astype(jnp.float32)))
    ff = _port_feed_forward(w1, b1, w2, b2, c, mult)
    monkeypatch.setenv("UNIGEO_FUSED_GEGLU", "1")
    with torch.no_grad():
        ours = ff(_bf16(x)[None])[0]
    w1p, b1p, w2p = ff.net[0].proj.weight, ff.net[0].proj.bias, ff.net[2].weight
    no_b2 = geglu_ffn_plain(_bf16(x), w1p, b1p, w2p)
    limit = geglu_error_limit(_bf16(x), w1p, b1p, w2p, no_b2) + 1.0625 * 2.0**-7 * ref.abs()
    assert _ratio(ours, ref, limit) <= 1.0


def test_feed_forward_without_the_switch_is_unfused(monkeypatch):
    """Switch off: the unfused layers.  Switch on with f32: the unfused
    layers too (the JAX package's dispatch rule), bit for bit."""
    x, w1, b1, w2, b2 = _inputs(37, 64, 2, seed=2)
    ff = _port_feed_forward(w1, b1, w2, b2, 64, 2)
    xb = _bf16(x)
    monkeypatch.delenv("UNIGEO_FUSED_GEGLU", raising=False)
    with torch.no_grad():
        off = ff(xb)
        unfused = ff.net[2](ff.net[0](xb))
        torch.testing.assert_close(off, unfused, atol=0, rtol=0)
        ff32 = ff.float()
        off32 = ff32(torch.from_numpy(x))
        monkeypatch.setenv("UNIGEO_FUSED_GEGLU", "1")
        torch.testing.assert_close(ff32(torch.from_numpy(x)), off32, atol=0, rtol=0)


@pytest.mark.parametrize("m,c,mult", [(37, 64, 2), (64, 128, 4)])
def test_gradients_match_jax_vjp(m, c, mult):
    x, w1, b1, w2, _ = _inputs(m, c, mult, seed=3)
    g = np.random.default_rng(4).normal(size=(m, c)).astype(np.float32)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (x, w1, b1, w2)]
    _, vjp = jax.vjp(j_reference, *jargs)
    refs = [np.asarray(r.astype(jnp.float32)) for r in vjp(jnp.asarray(g, jnp.bfloat16))]
    refs[1], refs[3] = refs[1].T, refs[3].T  # to the port's [out, in] layout
    inputs = [_bf16(a).requires_grad_() for a in (x, w1.T, b1, w2.T)]
    out = GegluFFN.apply(*inputs)
    torch.testing.assert_close(out.detach(), geglu_ffn_plain(*inputs).detach(), atol=0, rtol=0)
    grads = torch.autograd.grad(out, inputs, _bf16(g))
    for name, ours, ref in zip(("x", "w1", "b1", "w2"), grads, refs):
        assert ours.shape == ref.shape and ours.dtype == torch.bfloat16, name
        dev = np.abs(ours.float().numpy() - ref).max() / np.abs(ref).max()
        assert dev <= GRAD_TOL, (name, dev)
    # the backward is autograd through the port's reference, recomputed
    direct = torch.autograd.grad(geglu_ffn_reference(*inputs), inputs, _bf16(g))
    for ours, ref in zip(grads, direct):
        torch.testing.assert_close(ours, ref, atol=0, rtol=0)


def test_wrapper_rejects_bad_shapes():
    x = torch.zeros(10, 64, dtype=torch.bfloat16)
    w1 = torch.zeros(512, 64, dtype=torch.bfloat16)
    b1 = torch.zeros(512, dtype=torch.bfloat16)
    w2 = torch.zeros(64, 256, dtype=torch.bfloat16)
    geglu_ffn(x, w1, b1, w2)
    with pytest.raises(ValueError):
        geglu_ffn(x, w1[:, :32], b1, w2)
    with pytest.raises(ValueError):
        geglu_ffn(x, w1, b1[:10], w2)
    with pytest.raises(ValueError):
        geglu_ffn(x, w1, b1, w2[:, :100])
