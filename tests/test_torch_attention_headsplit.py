"""The port's head-split attention path (``UNIGEO_PACKED_ATTN=0``) against the
JAX package, on the CPU in f32.

Under the switch ``layers.attend`` sends a query sequence of at least 128
tokens to ``flash_attention`` on the [B, S, H, D] view (the head-split
kernel on the card, its plain version here) and, under autograd, to
``FlashAttentionPacked`` on the same view.  The JAX side is
``layers.Attention`` with the same variables and the switch set the same
way; on the CPU it runs ``attention_reference``, as its own tests run it.

Tolerances (relative to the largest magnitude of the reference; for the
parameter gradients, of the layer's largest gradient): 1e-5, f32 on both
sides with only the order of the sums differing (the JAX reference is a
chunked online softmax, the port's plain version one dense softmax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigeo_tpu.models import layers as jl
from unigeo_tpu.ops.attention import attention_reference
from unigeo_tpu_torch.models import layers as tl
from unigeo_tpu_torch.ops.attention import (
    attention_packed_reference,
    flash_attention,
    flash_attention_packed,
)
from unigeo_tpu_torch.utils.weights import state_dict_from_flax, unet_flax_path

TOL = 1e-5


def rel_dev(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-12)


@pytest.fixture()
def headsplit(monkeypatch):
    monkeypatch.setenv("UNIGEO_PACKED_ATTN", "0")


@pytest.mark.parametrize("b,sq,sk,h,d", [(2, 130, 130, 2, 8), (1, 140, 70, 3, 10),
                                         (2, 128, 600, 1, 16)])
def test_wrapper_matches_jax_attention_reference(b, sq, sk, h, d):
    rng = np.random.default_rng(sq + sk)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for s in (sq, sk, sk))
    ref = attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d**-0.5)
    before = flash_attention.launches, flash_attention_packed.launches
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert (flash_attention.launches, flash_attention_packed.launches) == before
    assert out.shape == (b, sq, h, d)
    assert rel_dev(out.numpy(), ref) < TOL
    packed = lambda a: torch.from_numpy(a.reshape(a.shape[0], a.shape[1], h * d))
    torch.testing.assert_close(out.reshape(b, sq, h * d),
                               attention_packed_reference(packed(q), packed(k), packed(v), h),
                               atol=0, rtol=0)


def _attention_pair(seq, ctx_len, seed):
    """(JAX Attention, its variables, the port's Attention with the same
    weights through the weight bridge, x, context)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, seq, 16)).astype(np.float32)
    ctx = None if ctx_len is None else rng.standard_normal((2, ctx_len, 12)).astype(np.float32)
    cdim = None if ctx is None else 12
    mod = jl.Attention(num_heads=2, head_dim=8, context_dim=cdim, qkv_bias=True)
    params = mod.init(jax.random.PRNGKey(seed), x, ctx)["params"]
    params = jax.tree.map(lambda a: a + 0.05, params)  # non-zero biases
    holder = torch.nn.Module()
    holder.blk = torch.nn.Module()
    holder.blk.attn1 = tl.Attention(16, 2, 8, context_dim=cdim, qkv_bias=True)
    holder.load_state_dict(state_dict_from_flax({"blk": {"attn1": params}}, holder,
                                                unet_flax_path))
    return mod, params, holder.blk.attn1, x, ctx


@pytest.mark.parametrize("seq,ctx_len", [(130, None), (20, None), (140, 7)],
                         ids=["kernel_path", "dense_path", "cross"])
def test_attention_matches_jax_under_the_switch(headsplit, seq, ctx_len):
    jmod, params, port, x, ctx = _attention_pair(seq, ctx_len, seed=1)
    ref = jmod.apply({"params": params}, x, ctx)
    with torch.no_grad():
        ours = port(torch.from_numpy(x), None if ctx is None else torch.from_numpy(ctx))
    assert rel_dev(ours.numpy(), ref) < TOL


def test_attend_under_the_switch_takes_the_headsplit_wrapper(headsplit, monkeypatch):
    """The dispatch, seen through the wrappers: with the switch, attend calls
    flash_attention (never the packed wrapper) from 128 query tokens on."""
    calls = []
    monkeypatch.setattr(tl, "flash_attention",
                        lambda *a: calls.append("headsplit") or flash_attention(*a))
    monkeypatch.setattr(tl, "flash_attention_packed",
                        lambda *a: calls.append("packed") or flash_attention_packed(*a))
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 130, 3 * 16)).astype(np.float32))
               for _ in range(3))
    out = tl.attend(q, k, v, 3, 16)
    assert calls == ["headsplit"]
    torch.testing.assert_close(out, attention_packed_reference(q, k, v, 3), atol=0, rtol=0)
    monkeypatch.setenv("UNIGEO_PACKED_ATTN", "1")
    tl.attend(q, k, v, 3, 16)
    assert calls == ["headsplit", "packed"]


@pytest.mark.parametrize("seq", [130, 20])
def test_gradients_match_jax_autodiff_under_the_switch(headsplit, seq, monkeypatch):
    """Under autograd the switch's path is FlashAttentionPacked on the same
    view (from 128 query tokens on), as the JAX package's custom_vjp."""
    jmod, params, port, x, _ = _attention_pair(seq, None, seed=3)
    g = np.random.default_rng(4).standard_normal((2, seq, 16)).astype(np.float32)
    applied, real = [], tl.FlashAttentionPacked

    class Spy:
        @staticmethod
        def apply(*args):
            applied.append(args[3])
            return real.apply(*args)

    monkeypatch.setattr(tl, "FlashAttentionPacked", Spy)

    def loss(p, xx):
        return jnp.sum(jmod.apply({"params": p}, xx) * g)

    jg_params, jg_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = port(xt)
    assert applied == ([2] if seq >= 128 else [])
    (out * torch.from_numpy(g)).sum().backward()
    assert rel_dev(xt.grad.numpy(), jg_x) < TOL
    ref_sd = state_dict_from_flax({"blk": {"attn1": jg_params}}, _holder(port), unet_flax_path)
    # against the layer's largest gradient: to_k.bias's is zero in exact
    # arithmetic (one constant added to a row's scores leaves its softmax
    # as it was), so both sides return round-off there
    scale = max(np.abs(r.numpy()).max() for r in ref_sd.values())
    for name, p in port.named_parameters():
        dev = np.abs(p.grad.numpy() - ref_sd["blk.attn1." + name].numpy()).max() / scale
        assert dev < TOL, (name, dev)


def _holder(attn):
    holder = torch.nn.Module()
    holder.blk = torch.nn.Module()
    holder.blk.attn1 = attn
    return holder
