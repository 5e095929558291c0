"""The f32 forward's register-tiled body at d = 512
(csrc/flash_attention_packed.cu, ``flash_*_f32w512_kernel``), its schedule
emulated in torch on the CPU, against the JAX package's Pallas kernels in
interpret mode.

The emulation follows the body's schedule: query items of 64 rows, rows
past Sq computed on zeros and dropped; keys in tiles of 16, the tiles past
Sk filled with zero rows as the copies zero-fill them.  Per tile each of the
8 warps computes its partial scores S_w over its 64-wide slice of d,
columns [64w, 64w + 64), and the owners of the rows add them up in warp
order, S = ((S_0 + S_1) + S_2) + ... in f32; on the last tile only, when Sk
is ragged, the keys past Sk score -inf; then the online softmax in log2
units: the running max m = max(m, rowmax(S) * scale * log2 e), alpha =
2^(m_old - m_new), p = 2^(fma(S, scale * log2 e, -m)) summed in f32 into
l, O = alpha O + P v with P in f32.  out = O / l, lse = (m + log2 l) ln 2.
Which warp owns a row's softmax changes no number, so the emulation runs
every row's at once.  The host's plan (``plan``, mirrored from
``unigeo_tpu_torch.ops.attention.f32_d512_plan``) runs the whole rounds of
items over the SMs one block an item, and splits the keys of the items left
over across a cluster of 8 where the SMs hold them all and each keeps a key
tile: block r takes tiles [r n / 8, (r + 1) n / 8), and the partials (m, l,
O) merge in rank order: M = max m_r, w_r = 2^(m_r - M), out = sum w_r O_r
/ sum w_r l_r, lse = (M + log2 L) ln 2.  The cases run under three plans:
at 132 SMs every item of the 9- and 17-tile cases is split, at 9 SMs the
17-tile case runs one round whole and its last item split, at 1 SM nothing
is split.

Inputs are f32, made with numpy from a seed, at d = 512 with ragged Sq and
Sk.  Tolerances, as on the card: the output within 1e-5 absolute (f32 in
both, sums in another order, exp2 for exp), the lse within 1e-4.  The
planted faults of tests/test_torch_cuda.py at d = 512 have twins here that
miss the output limit by 3x or more: a dropped key tile, no ragged mask, no
alpha rescale, a trade that reads one warp's partial twice (warp 0's in
place of warp 1's), and a merge that takes block 0's partial O in place of
block 1's.  The file also checks that those faults' anchors lie
once in the source, and the body's shared memory by the source's constants.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import functools
import math
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unigeo_tpu.ops.attention import flash_attention_tpu_fwd_lse, flash_attention_tpu_packed

F32_OUT_TOL, LSE_TOL = 1e-5, 1e-4
BLOCK_Q, KEY_TILE, D, WARPS = 64, 16, 512, 8
SLICE = D // WARPS
SMS = 132  # the H100's SMs, for the host's plan


def plan(b, sq, sk, h, sms=SMS):
    """(whole, rest, split): the items (64 query rows of one batch entry and
    head) that run one block an item in whole rounds of ``sms``, those left
    over, and the clusters their keys split over (8 where the SMs hold them
    all and each keeps a key tile, else 1)."""
    items = -(-sq // BLOCK_Q) * h * b
    whole = items // sms * sms
    rest = items - whole
    n_tiles = -(-sk // KEY_TILE)
    return whole, rest, 8 if rest and rest * 8 <= sms and n_tiles >= 8 else 1

# (b, Sq, Sk, H): ragged in Sk (130, 61: one partial tile; 257: the last
# tile holds one key) and in Sq (70, 130, 257 rows: a partial item), two
# heads in the last (the head's column offset)
CASES = [(1, 70, 130, 1), (2, 130, 61, 1), (1, 257, 257, 2)]


def _heads(x, h):
    b, s, hd = x.shape
    return x.reshape(b, s, h, hd // h).transpose(1, 2)  # [B, H, S, D]


def _fma(a, b, c):
    """fmaf(a, b, c) per element: the f64 product of two f32 is exact."""
    return (a.double() * b + c.double()).float()


def _partial(qh, kh, vh, sk, scale_log2, tiles, mask_last_tile, drop_tile, rescale,
             trade_reads_one_twice):
    """(m, l, O) of every row over the key tiles ``tiles`` by the body's
    schedule (see the module's note)."""
    b, h, rows, _ = qh.shape
    n_tiles = kh.shape[2] // KEY_TILE
    m = torch.full((b, h, rows), -math.inf)
    l = torch.zeros(b, h, rows)
    acc = torch.zeros(b, h, rows, D)
    cols = [slice(w * SLICE, (w + 1) * SLICE) for w in range(WARPS)]
    for t in tiles:
        keys = slice(t * KEY_TILE, (t + 1) * KEY_TILE)
        partial = [qh[..., c] @ kh[:, :, keys, c].transpose(-1, -2) for c in cols]
        if trade_reads_one_twice:
            partial[1] = partial[0]
        s = partial[0]
        for p_w in partial[1:]:  # warp order
            s = s + p_w
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
    return m, l, acc


def emulate_f32w512_forward(q, k, v, h, scale, sms=SMS, mask_last_tile=True, drop_tile=None,
                            rescale=True, trade_reads_one_twice=False, merge_twice=False):
    """(out f32 [B, Sq, H*D], lse f32 [B, H, Sq]) by the body's schedule and
    the host's plan at ``sms`` SMs; f32 q, k, v [B, S, H*D].  The keyword
    arguments after ``sms`` plant the card's faults: ``drop_tile`` scores
    that tile's keys -inf, ``rescale=False`` skips O's alpha,
    ``trade_reads_one_twice`` sums warp 0's partial in place of warp 1's,
    ``merge_twice`` merges block 0's partial O in place of block 1's."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    n_tiles = -(-sk // KEY_TILE)
    pad_q, pad_k = -(-sq // BLOCK_Q) * BLOCK_Q - sq, n_tiles * KEY_TILE - sk
    zeros = lambda x, n: torch.cat([x, x.new_zeros(b, n, hd)], dim=1)
    qh, kh, vh = _heads(zeros(q, pad_q), h), _heads(zeros(k, pad_k), h), _heads(zeros(v, pad_k), h)
    scale_log2 = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    faults = dict(mask_last_tile=mask_last_tile, drop_tile=drop_tile, rescale=rescale,
                  trade_reads_one_twice=trade_reads_one_twice)
    whole, rest, split = plan(b, sq, sk, h, sms)
    m, l, acc = _partial(qh, kh, vh, sk, scale_log2, range(n_tiles), **faults)
    out, lse = acc / l[..., None], m + torch.log2(l)
    if rest:
        parts = [_partial(qh, kh, vh, sk, scale_log2,
                          range(r * n_tiles // split, (r + 1) * n_tiles // split), **faults)
                 for r in range(split)]
        if merge_twice:
            parts[1] = (parts[1][0], parts[1][1], parts[0][2])
        mx = functools.reduce(torch.maximum, [p_r[0] for p_r in parts])
        lsum, o_split = torch.zeros_like(mx), torch.zeros_like(acc)
        for m_r, l_r, acc_r in parts:  # rank order
            w = torch.exp2(m_r - mx)
            lsum = lsum + w * l_r
            o_split = o_split + w[..., None] * acc_r
        # the items left over: item = query block + n_qb (head + H batch)
        n_qb = qh.shape[2] // BLOCK_Q
        item = (torch.arange(n_qb)[None, None, :] + n_qb * (
            torch.arange(h)[None, :, None] + h * torch.arange(b)[:, None, None]))
        left = (item >= whole).repeat_interleave(BLOCK_Q, dim=2)
        out = torch.where(left[..., None], o_split / lsum[..., None], out)
        lse = torch.where(left, mx + torch.log2(lsum), lse)
    out = out[:, :, :sq].transpose(1, 2).reshape(b, sq, hd)
    return out, (lse * math.log(2.0))[:, :, :sq]


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
    """max |emulation - Pallas packed| on ``case``."""
    b, sq, sk, h = case
    q, k, v = _qkv(b, sq, sk, h)
    out, _ = emulate_f32w512_forward(q, k, v, h, D**-0.5, **kw)
    assert out.dtype == torch.float32 and out.shape == q.shape
    return (out - _pallas_packed(*case)).abs().max().item()


def test_plan_splits_the_items_left_over():
    """The VAE mid block's [25, 3072, 1, 512]: 9 rounds of 132 items, the 12
    left over split 8 ways; the card tests' [1, 1024, 1, 512] (16 items)
    split, [1, 3072, 1, 512] and [2, 3072, 1, 512] (48 and 96 items: 8
    blocks each would not fit) not; the python mirror of the plan agrees."""
    from unigeo_tpu_torch.ops.attention import f32_d512_plan

    shapes = [(25, 3072, 3072, 1), (1, 1024, 1024, 1), (1, 3072, 3072, 1),
              (2, 3072, 3072, 1), *CASES]
    plans = [plan(*c) for c in shapes]
    assert plans[:4] == [(1188, 12, 8), (0, 16, 8), (0, 48, 1), (0, 96, 1)]
    assert plans[4:] == [(0, 2, 8), (0, 6, 1), (0, 10, 8)]  # 61 keys: 4 tiles, fewer than 8
    assert all(f32_d512_plan(*c, SMS) == p for c, p in zip(shapes, plans))
    assert plan(*CASES[2], sms=9) == (9, 1, 8)
    assert [plan(*c, sms=1) for c in CASES] == [(2, 0, 1), (6, 0, 1), (10, 0, 1)]


@pytest.mark.parametrize("sms", [SMS, 9, 1])
@pytest.mark.parametrize("case", CASES)
def test_emulation_matches_pallas_packed_interpret(case, sms):
    """Under the three plans of the module's note."""
    err = _err(case, sms=sms)
    assert err <= F32_OUT_TOL, err


@pytest.mark.parametrize("case", CASES)
def test_emulation_lse_matches_pallas_fwd_lse_interpret(case):
    b, sq, sk, h = case
    q, k, v = _qkv(b, sq, sk, h, seed=1)
    out, lse = emulate_f32w512_forward(q, k, v, h, D**-0.5)
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
    [((1, 257, 257, 2), {"drop_tile": 7}),
     ((1, 70, 130, 1), {"mask_last_tile": False}),
     ((2, 130, 61, 1), {"mask_last_tile": False}),
     ((1, 257, 257, 2), {"mask_last_tile": False}),
     ((1, 257, 257, 2), {"rescale": False}),
     ((2, 130, 61, 1), {"rescale": False}),
     ((1, 70, 130, 1), {"trade_reads_one_twice": True}),
     ((1, 257, 257, 2), {"trade_reads_one_twice": True}),
     ((1, 70, 130, 1), {"merge_twice": True}),
     ((1, 257, 257, 2), {"merge_twice": True})],
)
def test_emulated_planted_faults_fail_the_limit(case, fault):
    """The twins of the card's planted faults miss 1e-5 by 3x or more
    (under the plan at 132 SMs)."""
    err = _err(case, **fault)
    assert err >= 3 * F32_OUT_TOL, (fault, err)


def _card_faults():
    """tests/test_torch_cuda.py's PLANTED_FAULTS (the module imports no JAX)."""
    import importlib.util

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location("card_tests",
                                                  os.path.join(here, "test_torch_cuda.py"))
    card = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(card)
    return card.PLANTED_FAULTS


@pytest.mark.parametrize("name", ["w512_drop_key_tile", "w512_no_ragged_mask", "w512_no_rescale",
                                  "w512_trade_reads_one_twice", "w512_merge_twice"])
def test_f32_d512_fault_anchors_are_unique(name):
    """Each planted fault of the d = 512 body (built on the card) finds its
    anchor once in the source, and its replacement changes it."""
    from unigeo_tpu_torch import _build

    fname, anchor, faulty = _card_faults()[name]
    with open(os.path.join(_build.CSRC_DIR, fname)) as f:
        assert f.read().count(anchor) == 1, name
    assert faulty != anchor, name


def test_f32_d512_shared_memory_by_the_source_constants():
    """The body's shared memory from the constants of the source: q (64
    rows) and a k tile (16 keys) at the padded pitch, a v tile unpadded, 8
    warps' partials of 8 owner regions and two mbarriers; one block an SM
    fits the 227 KB a block may take, and the 12.7 MB an item reads from L2 at Sk = 3072 make
    about 15.3 GB at [25, 3072, 1, 512]."""
    from unigeo_tpu_torch import _build

    with open(os.path.join(_build.CSRC_DIR, "flash_attention_packed.cu")) as f:
        text = f.read()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
    rows, warps, bk, region = (const("kW512Rows"), const("kW512Warps"), const("kW512BK"),
                               const("kW512Region"))
    assert (rows, warps, bk) == (BLOCK_Q, WARPS, KEY_TILE)
    assert re.search(r"constexpr int kW512Pitch = kW512D \+ 4;", text)
    pitch = D + 4
    owners = rows // (32 // (bk // 4))
    floats = rows * pitch + bk * pitch + bk * D + warps * owners * region + 4
    assert 4 * floats == 231_696 <= 232_448
    items = 25 * -(-3072 // rows)
    per_item = 4 * (rows * D + 2 * 3072 * D)
    assert abs(items * per_item / 1e9 - 15.26) < 0.01
