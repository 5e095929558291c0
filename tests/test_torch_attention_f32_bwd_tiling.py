"""The f32 backward pair's register-tiled bodies at d = 64
(csrc/flash_attention_bwd.cu, ``bwd_{dq,dkv}_f32reg_kernel``), their
schedule emulated in torch on the CPU, against the JAX package's
``flash_attention_tpu_bwd`` (both Pallas kernels) in interpret mode.

The emulation follows the bodies' schedule.  Blocks of 64 resident rows
(four warps of 16): query rows with dO for dq, key rows with v for dk/dv,
rows past Sq or Sk zero-filled as the copies fill them, and never stored.
The other side streams in tiles of 64 rows, zero-filled past the edge;
lse log2 e and delta scale are 0 for rows past Sq (never read).  Per tile:
S = q k^T (dq) or S^T = k q^T (dk/dv) and dP or dP^T in f32;
P = 2^(fma(S, scale log2 e, -lse log2 e)), selected to 0 for keys past Sk
(dq) or queries past Sq (dk/dv); dS = P fma(dP, scale, -delta scale); then
dq += dS k, or dv += P^T dO and dk += dS^T q, tile by tile in order.  Where
the items do not give every SM a block (``attention.f32_bwd_split``, the
host's plan, at the H100's 132 SMs), the looped tiles split over a cluster
of 2, 4 or 8 blocks, block r taking tiles [r n / split, (r + 1) n / split),
and the partial sums are added in rank order.

Inputs are f32, made with numpy from a seed, at d = 64 with ragged Sq and
Sk, Cut3R's 768 queries over 64 keys (dk/dv split over 8 blocks) and
splits over 2, 4 and 8 blocks; both sides get the JAX forward's out and
lse.  Tolerance: the f32 ``grad_error_limits`` of
unigeo_tpu_torch/ops/attention.py, elementwise, 1.0625 (2 max(Sq, Sk) 2^-24
T + F): each version sums the last product in its own order (T its
magnitude sums), and F carries the f32 error of S and dP through P and dS.
The planted faults of tests/test_torch_cuda.py have twins here that miss
that limit by 3x or more: a dropped key tile (dq), the ragged query tile
lost (dk/dv), delta as 0 (either kernel), and a merge that adds one
block's partial twice.  The query select alone is no fault (the zero query
rows add P^T 0 to dv and dS^T = 0 to dk): the emulation without it stays
within the limit.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unigeo_tpu.ops.attention import flash_attention_tpu_bwd, flash_attention_tpu_fwd_lse
from unigeo_tpu_torch.ops.attention import (
    BWD_F32_BLOCK_ROWS,
    BWD_F32_TILE,
    _delta,
    f32_bwd_split,
    grad_error_limits,
)

D = 64
SMS = 132  # the H100's SMs, for the host's plan

# (b, Sq, Sk, H): ragged in both; Sq = 130 (two whole query tiles and 2
# rows), 61 keys; Cut3R's 768 queries over 64 keys; S = 257 (the last tile
# holds one row); 768 tokens at small batch (12 key tiles)
CASES = [(1, 70, 100, 2), (2, 130, 61, 1), (1, 768, 64, 2), (1, 257, 257, 2),
         (1, 768, 768, 2)]


def _fma(a, b, c):
    """fmaf(a, b, c) per element: the f64 product of two f32 is exact."""
    return (a.double() * b + c.double()).float()


def _pad(x, rows):
    """[B, H, S, D] with zero rows up to ``rows``."""
    return torch.cat([x, x.new_zeros(*x.shape[:2], rows - x.shape[2], x.shape[3])], dim=2)


def _ranges(n, split):
    return [range(r * n // split, (r + 1) * n // split) for r in range(split)]


def _merge(parts, merge_twice):
    """The partials added in rank order (``merge_twice``: rank 0's in place
    of rank 1's; one block merges nothing)."""
    if merge_twice and len(parts) > 1:
        parts = [parts[0], parts[0], *parts[2:]]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def emulate_f32reg_bwd(q, k, v, dout, lse, delta, h, scale, split_dq=1, split_dkv=1,
                       drop_key_tile=None, query_edge=True, query_mask=True, dq_delta=True,
                       dkv_delta=True, merge_twice=False):
    """(dq, dk, dv) f32 [B, S, H*D] by the bodies' schedule; f32 q, k, v, dO
    [B, S, H*D], lse and delta [B, H, Sq].  The keyword arguments after
    ``split_dkv`` plant the card's faults: ``drop_key_tile`` gives that key
    tile P = 0 in dq, ``query_edge=False`` stops dk/dv's loop at the last
    whole query tile, ``query_mask=False`` drops dk/dv's query select,
    ``dq_delta`` / ``dkv_delta=False`` take delta as 0, ``merge_twice`` adds
    rank 0's partial in place of rank 1's (both kernels)."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    heads = lambda x: x.reshape(b, x.shape[1], h, D).transpose(1, 2)  # [B, H, S, D]
    # a block's rows and a streamed tile are both 64 rows: every side pads
    # to whole tiles
    assert BWD_F32_BLOCK_ROWS == BWD_F32_TILE
    nq, nk = -(-sq // BWD_F32_TILE), -(-sk // BWD_F32_TILE)
    qp, dop = (_pad(heads(x), nq * BWD_F32_TILE) for x in (q, dout))
    kp, vp = (_pad(heads(x), nk * BWD_F32_TILE) for x in (k, v))
    zeros = lambda x: torch.cat([x, x.new_zeros(b, h, nq * BWD_F32_TILE - sq)], dim=2)
    lse2 = zeros(lse * torch.tensor(math.log2(math.e)))
    dlt = zeros(delta * torch.tensor(scale))
    scale_log2 = torch.tensor(scale * math.log2(math.e), dtype=torch.float32).double()
    scale_t = torch.tensor(scale, dtype=torch.float32).double()
    tile = lambda x, t: x[:, :, t * BWD_F32_TILE:(t + 1) * BWD_F32_TILE]

    parts = []  # dq: the key tiles split over split_dq ranks
    for tiles in _ranges(nk, split_dq):
        acc = torch.zeros_like(qp)
        for t in tiles:
            kt, vt = tile(kp, t), tile(vp, t)
            s = qp @ kt.transpose(-1, -2)
            dp = dop @ vt.transpose(-1, -2)
            p = torch.exp2(_fma(s, scale_log2, -lse2[..., None]))
            keys = torch.arange(t * BWD_F32_TILE, (t + 1) * BWD_F32_TILE)
            p = torch.where((keys < sk) & (t != drop_key_tile), p, torch.zeros(()))
            ds = p * _fma(dp, scale_t, -(dlt if dq_delta else torch.zeros_like(dlt))[..., None])
            acc = acc + ds @ kt
        parts.append(acc)
    dq = _merge(parts, merge_twice)

    n_loop = nq if query_edge else sq // BWD_F32_TILE
    parts = []  # dk, dv: the query tiles split over split_dkv ranks
    for tiles in _ranges(n_loop, split_dkv):
        acck, accv = torch.zeros_like(kp), torch.zeros_like(kp)
        for t in tiles:
            qt, dot = tile(qp, t), tile(dop, t)
            l2, dl = tile(lse2, t), tile(dlt, t)
            if not dkv_delta:
                dl = torch.zeros_like(dl)
            st = kp @ qt.transpose(-1, -2)
            pt = torch.exp2(_fma(st, scale_log2, -l2[:, :, None, :]))
            queries = torch.arange(t * BWD_F32_TILE, (t + 1) * BWD_F32_TILE)
            if query_mask:
                pt = torch.where(queries < sq, pt, torch.zeros(()))
            accv = accv + pt @ dot
            dpt = vp @ dot.transpose(-1, -2)
            dst = pt * _fma(dpt, scale_t, -dl[:, :, None, :])
            acck = acck + dst @ qt
        parts.append((acck, accv))
    dk = _merge([p[0] for p in parts], merge_twice)
    dv = _merge([p[1] for p in parts], merge_twice)

    back = lambda x, s: x[:, :, :s].transpose(1, 2).reshape(b, s, hd)
    return back(dq, sq), back(dk, sk), back(dv, sk)


def _inputs(b, sq, sk, h, seed=0):
    rng = np.random.default_rng(seed + 11 * sq + sk + h)
    mk = lambda s: rng.standard_normal((b, s, h * D)).astype(np.float32)
    return mk(sq), mk(sk), mk(sk), mk(sq)  # q, k, v, dO


@functools.lru_cache(maxsize=None)
def _jax_case(b, sq, sk, h):
    """(q, k, v, dO, out, lse [B, H, Sq], the JAX gradients), all torch f32
    [B, S, H*D]: the Pallas forward's out and lse, then its backward, in
    interpret mode."""
    q, k, v, g = _inputs(b, sq, sk, h)
    split = lambda x: jnp.asarray(x.reshape(b, x.shape[1], h, D))
    out, lse = flash_attention_tpu_fwd_lse(split(q), split(k), split(v), scale=D**-0.5,
                                           interpret=True)
    grads = flash_attention_tpu_bwd(split(q), split(k), split(v), out, lse, split(g),
                                    scale=D**-0.5, interpret=True)
    packed = lambda x: torch.from_numpy(np.array(x)).reshape(b, -1, h * D)
    lse_t = torch.from_numpy(np.ascontiguousarray(np.array(lse)[:, :sq])).reshape(b, h, sq)
    return (*(torch.from_numpy(x) for x in (q, k, v, g)), packed(out), lse_t,
            tuple(packed(x) for x in grads))


def _ratios(case, **kw):
    """max |emulation - Pallas| / limit for dq, dk, dv on ``case`` under the
    host's split."""
    b, sq, sk, h = case
    q, k, v, g, out, lse, grads = _jax_case(*case)
    delta = _delta(out, g, h)
    splits = dict(split_dq=f32_bwd_split(b, sq, sk, h, False, SMS),
                  split_dkv=f32_bwd_split(b, sq, sk, h, True, SMS))
    emu = emulate_f32reg_bwd(q, k, v, g, lse, delta, h, D**-0.5, **{**splits, **kw})
    limits = grad_error_limits(q, k, v, out, lse, g, h, grads)
    ratios = []
    for got, ref, lim in zip(emu, grads, limits):
        assert got.dtype == torch.float32 and got.shape == ref.shape
        ratios.append(((got - ref).abs() / lim).max().item())
    return ratios


def test_plan_splits_the_small_shapes_and_not_the_large():
    """Cut3R's [1, 768 -> 64, 8, 64] splits dk/dv's 12 query tiles over 8
    blocks (its 8 items of 64 key rows) and leaves dq (one key tile)
    whole; the decoders' [1, 768, 8, 64] (96 items a kernel) split over 2;
    the training paths' large shapes do not split."""
    assert f32_bwd_split(1, 768, 64, 8, True, SMS) == 8
    assert f32_bwd_split(1, 768, 64, 8, False, SMS) == 1
    assert f32_bwd_split(1, 768, 768, 8, False, SMS) == 2
    assert f32_bwd_split(1, 768, 768, 8, True, SMS) == 2
    for b, s, h in [(1, 3072, 12), (20, 768, 12), (16, 768, 16), (15, 768, 12), (25, 972, 16)]:
        assert f32_bwd_split(b, s, s, h, False, SMS) == f32_bwd_split(b, s, s, h, True, SMS) == 1
    # the cases here: splits of 1, 2, 4 and 8 blocks
    assert [(f32_bwd_split(*c, False, SMS), f32_bwd_split(*c, True, SMS)) for c in CASES] == [
        (2, 2), (1, 2), (1, 8), (4, 4), (8, 8)]


@pytest.mark.parametrize("case", CASES)
def test_emulation_matches_pallas_bwd_interpret(case):
    ratios = _ratios(case)
    assert max(ratios) <= 1.0, ratios


@pytest.mark.parametrize("case", [(1, 70, 100, 2), (1, 768, 64, 2)])
def test_emulation_unsplit_matches_pallas_bwd_interpret(case):
    """One block an item, as at the large shapes."""
    ratios = _ratios(case, split_dq=1, split_dkv=1)
    assert max(ratios) <= 1.0, ratios


def test_query_select_alone_is_no_fault():
    """Without dk/dv's query select, the zero query rows past Sq add P^T 0
    to dv and dS^T = 0 to dk: the emulation stays within the limit."""
    ratios = _ratios((2, 130, 61, 1), query_mask=False)
    assert max(ratios) <= 1.0, ratios


@pytest.mark.parametrize(
    "case,fault,which",
    [((1, 768, 768, 2), {"drop_key_tile": 7}, 0),
     ((2, 130, 61, 1), {"query_edge": False}, 1),
     ((1, 70, 100, 2), {"query_edge": False}, 1),
     ((1, 768, 64, 2), {"dq_delta": False}, 0),
     ((1, 768, 64, 2), {"dkv_delta": False}, 1),
     ((1, 257, 257, 2), {"dkv_delta": False}, 1),
     ((1, 768, 768, 2), {"merge_twice": True}, 0),
     ((1, 768, 64, 2), {"merge_twice": True}, 1)],
)
def test_emulated_planted_faults_fail_the_limit(case, fault, which):
    """The twins of the card's planted faults miss the limit of the
    gradient they touch (0 dq, 1 dk) by 3x or more."""
    ratios = _ratios(case, **fault)
    assert ratios[which] >= 3.0, (fault, ratios)


def test_planted_fault_anchors_are_unique():
    """Each planted fault of the f32 backward in tests/test_torch_cuda.py
    (built on the card) finds its anchor once in the source, and its
    replacement changes it."""
    import importlib.util
    import os

    from unigeo_tpu_torch import _build

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location("card_tests",
                                                  os.path.join(here, "test_torch_cuda.py"))
    card = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(card)
    names = [n for n in card.PLANTED_FAULTS if n.startswith("f32_bwd_")]
    assert sorted(names) == sorted(["f32_bwd_dq_drop_key_tile", "f32_bwd_dkv_no_ragged_mask",
                                    "f32_bwd_dq_delta_zero", "f32_bwd_dkv_delta_zero",
                                    "f32_bwd_merge_twice"])
    with open(os.path.join(_build.CSRC_DIR, "flash_attention_bwd.cu")) as f:
        text = f.read()
    for name in names:
        fname, anchor, faulty = card.PLANTED_FAULTS[name]
        assert fname == "flash_attention_bwd.cu" and text.count(anchor) == 1, name
        assert faulty != anchor, name


@pytest.mark.parametrize("name", ["built", "earlier_d64", "warps8", "stages3", "unroll_d4",
                                  "unroll_d16", "unroll_k8", "unroll_k64", "nosplit",
                                  "split_slots", "split_waves"])
def test_bwd_variant_anchors_are_unique(name):
    """Each variant of tools/backward_variants.py (built on the card) finds
    each anchor once in its source, and its replacement changes it."""
    import os

    from unigeo_tpu_torch import _build
    from unigeo_tpu_torch.tools.backward_variants import VARIANTS

    assert sorted(VARIANTS) == sorted(["built", "earlier_d64", "warps8", "stages3", "unroll_d4",
                                       "unroll_d16", "unroll_k8", "unroll_k64", "nosplit",
                                       "split_slots", "split_waves"])
    for fname, anchor, repl in VARIANTS[name]:
        with open(os.path.join(_build.CSRC_DIR, fname)) as f:
            assert f.read().count(anchor) == 1, (name, anchor)
        assert repl != anchor, name
