"""Packed multi-head attention: the hand-written CUDA kernels and their plain versions.

q, k and v stay in the ``[B, S, H*D]`` layout that the projections emit; head
h is the column slice ``[h*D, (h+1)*D)``.  Three kernels, each behind a
wrapper that launches it on a CUDA tensor (built on first use, see
``_build.py``) or raises, runs its plain version on a CPU tensor, and adds
one to its ``launches`` count per launch:

* ``flash_attention_packed``: the forward (port of
  ``unigeo_tpu/ops/attention.py::flash_attention_tpu_packed``), kernel
  ``csrc/flash_attention_packed.cu``; plain version
  ``attention_packed_reference``.
* ``flash_attention``: the same forward in the head-split layout
  ``[B, S, H, D]`` (port of ``flash_attention_tpu``).  A contiguous
  ``[B, S, H, D]`` tensor has the bytes of ``[B, S, H*D]``, and the packed
  kernel takes batch and sequence strides, so this is the packed kernel's
  body instantiated once more under its own name (``flash_headsplit_*``)
  with its own entry point and ``launches`` count; the JAX package needs a
  second Pallas kernel only because Mosaic's tiles want ``[B*H, S, D]``.
  Plain version ``attention_packed_reference`` on the packed view.
* ``flash_attention_fwd_lse``: the same forward that also returns the row
  logsumexp ``lse [B, H, Sq]`` f32 (port of ``flash_attention_tpu_fwd_lse``),
  the lse kernels of the same source (one kernel body, instantiated
  with and without the lse write); plain version
  ``attention_fwd_lse_reference``.
* ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv``: the backward
  (port of ``flash_attention_tpu_bwd``), kernels
  ``csrc/flash_attention_bwd.cu``; ``flash_attention_bwd`` computes
  delta = rowsum(dO * O) in plain torch and launches both.  Plain version
  ``attention_bwd_reference``.

``FlashAttentionPacked`` is the differentiable attention (the JAX package's
``attention_packed`` custom_vjp): its forward is ``flash_attention_fwd_lse``,
its backward ``flash_attention_bwd``.  It serves both layouts under autograd,
as the JAX package's ``_attention_tpu`` custom_vjp does for the head-split
one.  ``use_packed_attention`` reads the A/B switch ``UNIGEO_PACKED_ATTN``.

``attention_packed_reference`` also serves, with ``upcast=False``, as the
layers' path below the kernels' 128-token threshold (the 25-token temporal
attention, as the JAX package keeps those on its jnp
``attention_reference``).  ``bf16_error_limit`` and ``grad_error_limits``
are the elementwise limits on kernel vs plain version.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

_DTYPE_TAGS = {torch.float32: 0, torch.bfloat16: 1}
MIN_KERNEL_SEQ = 128  # same threshold as unigeo_tpu's use_packed_attention
# the forward takes any head width in both dtypes.  bf16: the tensor-core
# bodies (TMA + wgmma: 64-row consumers at 16, 64 and 80, a column-split
# pair of consumers at 512) for rows aligned to 16 bytes at the UNet's 64,
# CLIP's 80, the VAE's 512 and 16 for small checks; every other width, and
# rows the TMA cannot take, on the CUDA-core body read into f32.  f32 (CUDA
# cores): the register-tiled bodies at the pointmap path's 64 and the VAE
# mid block's 512, which take rows aligned to 16 bytes, the earlier body at
# every other width.  Past FWD_WIDE_ABOVE both dtypes run the CUDA-core
# body with the head width streamed in column chunks (``wide_chunk``).  The
# choice is by shape and alignment alone.
FWD_WIDE_ABOVE = 512
BF16_WGMMA_HEAD_WIDTHS = (16, 64, 80, 512)
F32_TILED_HEAD_WIDTHS = (64, 512)
F32_TILED_HEAD_WIDTH = 64  # the f32 backward's register-tiled bodies
# the backward kernels take any head width in both dtypes: bf16 on the
# tensor-core bodies at the UNet's 64 (and 16 for small checks) for rows
# aligned to 16 bytes, else on the CUDA-core body read into f32; f32 on the
# CUDA cores (the register-tiled bodies at the f32 training paths' 64, which
# take rows aligned to 16 bytes, the earlier body at every other width up to
# BWD_WIDE_ABOVE); past it both dtypes run the column-chunked CUDA-core body
BWD_BF16_WGMMA_HEAD_WIDTHS = (16, 64)
BWD_WIDE_ABOVE = 128
# the column-chunked bodies' widest chunk (16 lanes a row, 32 columns each)
WIDE_MAX_CHUNK = 512


def wide_chunk(d: int) -> int:
    """The column chunk of the column-chunked bodies at head width ``d``
    (``csrc/flash_attention_packed.cu::wide_chunk`` and its twin in
    ``flash_attention_bwd.cu``): ceil(d / 512) chunks as equal as can be."""
    n = -(-d // WIDE_MAX_CHUNK)
    return -(-d // n)


def _aligned16(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def bf16_fwd_on_cuda_core(q, k, v, d: int) -> bool:
    """Whether bf16 q, k, v (contiguous, on the card) run the forward's
    CUDA-core body rather than a wgmma body: a head width outside
    ``BF16_WGMMA_HEAD_WIDTHS``, or a base not aligned to 16 bytes
    (``csrc/flash_attention_packed.cu::dispatch_bf16``)."""
    return d not in BF16_WGMMA_HEAD_WIDTHS or not _aligned16(q, k, v)


def bf16_bwd_on_cuda_core(q, k, v, dout, d: int) -> bool:
    """The same for the backward pair (``csrc/flash_attention_bwd.cu::dispatch``)."""
    return d not in BWD_BF16_WGMMA_HEAD_WIDTHS or not _aligned16(q, k, v, dout)
# rows a block of the f32 backward's bodies at d = 64 owns (4 warps of 16)
# and rows of the tiles it streams
BWD_F32_BLOCK_ROWS, BWD_F32_TILE = 64, 64


def f32_bwd_split(b: int, sq: int, sk: int, h: int, dkv: bool, sms: int) -> int:
    """The cluster split the library's host plan picks for the f32 backward
    at d = 64 (``csrc/flash_attention_bwd.cu::f32reg_split``; written here
    for the tests and the reports): the items are blocks of
    ``BWD_F32_BLOCK_ROWS`` query rows (dq) or key rows (dk/dv) of one batch
    and head; the looped tiles (key tiles for dq, query tiles for dk/dv)
    split over 1, 2, 4 or 8 blocks, doubled while the items times the split
    leave SMs without a block and every block keeps a tile."""
    rows, looped = (sk, sq) if dkv else (sq, sk)
    items = -(-rows // BWD_F32_BLOCK_ROWS) * h * b
    n_tiles = -(-looped // BWD_F32_TILE)
    split = 1
    while split < 8 and items * split < sms and 2 * split <= n_tiles:
        split *= 2
    return split


# rows of an item of the f32 forward's body at d = 512, keys of its tiles
F32_D512_ITEM_ROWS, F32_D512_KEY_TILE = 64, 16


def f32_d512_plan(b: int, sq: int, sk: int, h: int, sms: int):
    """The launches the library's host plan makes for the f32 forward at
    d = 512 (``csrc/flash_attention_packed.cu::launch_f32_d512``; written here
    for the tests and the reports): (whole, rest, split).  The items are
    blocks of ``F32_D512_ITEM_ROWS`` query rows of one batch entry and head;
    the first launch runs the ``whole`` rounds of ``sms`` items, one block
    an item, the second the ``rest`` left over with their keys split over
    clusters of ``split`` = 8 blocks where the SMs hold them all and each
    keeps a key tile, else 1."""
    items = -(-sq // F32_D512_ITEM_ROWS) * h * b
    whole = items // sms * sms
    rest = items - whole
    n_tiles = -(-sk // F32_D512_KEY_TILE)
    return whole, rest, 8 if rest and rest * 8 <= sms and n_tiles >= 8 else 1


def _heads(x, num_heads: int, upcast: bool = True):
    """[B, S, H*D] -> [B, S, H, D], in f32 unless ``upcast`` is false."""
    b, s, hd = x.shape
    return (x.float() if upcast else x).reshape(b, s, num_heads, hd // num_heads)


def attention_packed_reference(
    q, k, v, num_heads: int, scale: Optional[float] = None, upcast: bool = True
):
    """softmax(q_h k_h^T * scale) v_h per head, in f32 (the output of
    ``attention_fwd_lse_reference``) or, with ``upcast=False``, in the input
    dtype; returns q's dtype."""
    if upcast:
        return attention_fwd_lse_reference(q, k, v, num_heads, scale)[0]
    b, sq, hd = q.shape
    if scale is None:
        scale = (hd // num_heads) ** -0.5
    qh, kh, vh = (_heads(x, num_heads, upcast=False) for x in (q, k, v))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vh).reshape(b, sq, hd)


def bf16_error_limit(q, k, v, num_heads: int, ref, scale: Optional[float] = None):
    """Elementwise limit on |kernel - plain version| for bf16 q, k, v.

    Both versions read the same bf16 values and keep scores, the running max
    and the sums in f32.  Two roundings differ between them, each at most
    bf16's unit roundoff 2^-8 (8 significant bits) of what it rounds:

    * the kernel rounds P to bf16 before P.V: at most 2^-8 (P|V|) on an
      output, P|V| being the plain attention of |v| (the row's softmax mean
      of |v|);
    * each version rounds its f32 output to bf16 once, so the two differ by
      at most 2^-8 (|x_kernel| + |x_plain|), about 2^-7 |ref|.

    The limit is the sum of the two, widened by 1/16 for the second-order
    terms, the f32 sums taken in another order and the kernel's exp2 (all
    under 1e-4 relative).  ``ref`` is the plain version's output.  This is
    the wgmma bodies' limit; the CUDA-core body, which does not round P,
    has ``bf16_cuda_core_error_limit``.
    """
    pv = attention_packed_reference(q.float(), k.float(), v.float().abs(), num_heads, scale)
    return 1.0625 * (2.0**-7 * ref.float().abs() + 2.0**-8 * pv)


def bf16_cuda_core_error_limit(q, k, v, num_heads: int, ref, scale: Optional[float] = None):
    """Elementwise limit on |kernel - plain version| for bf16 q, k, v on the
    forward's CUDA-core body (``bf16_fwd_on_cuda_core``).

    Both versions read the same bf16 values into f32 exactly and keep every
    score, max, exponential and sum in f32; the body does not round P.  They
    differ in two ways only:

    * the order of the f32 sums.  With u = 2^-24, n = Sk, s the scaled
      scores, p = softmax(s) and lse the row logsumexp, each version's f32
      output is within E = sum_j p_j |v_j| r_j of the exact one, where r_j
      bounds the relative error of its p_j: the score is a D-term dot
      product and a scaling, off by at most e_j = (D + 1) u scale
      sum_d |q_d||k_jd| (the row's max of it, e, enters again through the
      normaliser); the subtraction of the row's max or lse, the exponential
      (expf, 2 ulp) and the normaliser's n-term sum with one rescale a key
      tile add u (|s_j| + 2 |lse| + 3 n + 8), and the n-term sum of
      p_j v_j its own n u, inside the 3 n: r_j = 2 e + u (|s_j| + 2 |lse|
      + 3 n + 8).  The two versions differ by at most 2 E.
    * each rounds its f32 output to bf16 once: at most 2^-8 (|x_kernel| +
      |x_plain|), about 2^-7 |ref|.

    The limit is 2^-7 |ref| + 2 E, widened by 1/16 for the second-order
    terms (2^-8 of 2 E, the plain version's values standing for the exact
    ones).  ``ref`` is the plain version's output.  For f32 q, k, v (the
    same bodies instantiated for float, e.g. the column-chunked one past
    d = 512) neither version rounds its output, so the limit is 1.0625 * 2 E.
    """
    u = 2.0**-24
    b, sq, hd = q.shape
    d, sk = hd // num_heads, k.shape[1]
    if scale is None:
        scale = d**-0.5
    qh, kh, vh = (_heads(x, num_heads) for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse)
    e = ((d + 1) * u * scale
         * torch.einsum("bqhd,bkhd->bhqk", qh.abs(), kh.abs())).amax(-1, keepdim=True)
    r = 2.0 * e + u * (s.abs() + 2.0 * lse.abs() + 3 * sk + 8)
    err = torch.einsum("bhqk,bkhd->bqhd", p * r, vh.abs()).reshape(b, sq, hd)
    rounding = 2.0**-7 if q.dtype == torch.bfloat16 else 0.0
    return 1.0625 * (rounding * ref.float().abs() + 2.0 * err)


def _check(q, k, v, num_heads: int):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be [B, S, H*D]")
    b, sq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != hd:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if num_heads <= 0 or hd % num_heads:
        raise ValueError(f"width {hd} does not split into {num_heads} heads")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share a dtype")


def _check_kernel_input(q, k, v, d: int):
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.dtype not in _DTYPE_TAGS:
        raise ValueError(f"kernel takes float32 or bfloat16, not {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("kernel takes contiguous q, k, v")
    # 16-byte tile loads (rows and head offsets are then multiples of 16
    # bytes) in the f32 bodies at d = 64 and 512; bf16 rows that the TMA
    # cannot take run on the CUDA-core body
    if q.dtype == torch.float32 and d in F32_TILED_HEAD_WIDTHS and not _aligned16(q, k, v):
        raise ValueError(f"{q.dtype} kernel at d = {d} takes rows aligned to 16 bytes")


def use_packed_attention() -> bool:
    """The packed layout unless ``UNIGEO_PACKED_ATTN=0`` (read at call time,
    as the JAX package's ``use_packed_attention`` reads it)."""
    return os.environ.get("UNIGEO_PACKED_ATTN", "1") != "0"


def _launch(lib, q, k, v, num_heads: int, scale: float, lse=None, headsplit: bool = False):
    """One launch of the forward kernel in ``lib`` (a library from
    ``_build``); with ``lse`` (f32 [B, H, Sq]) through the lse entry point,
    with ``headsplit`` through the head-split one."""
    from unigeo_tpu_torch import _build

    b, sq, hd = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            b, sq, k.shape[1], num_heads, hd // num_heads, float(scale),
            _DTYPE_TAGS[q.dtype], stream,
        )
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        if headsplit:
            err = lib.unigeo_flash_attention_headsplit(*ptrs, *args)
        elif lse is None:
            err = lib.unigeo_flash_attention_packed(*ptrs, *args)
        else:
            err = lib.unigeo_flash_attention_fwd_lse(*ptrs, lse.data_ptr(), *args)
    _build.check(lib, err, "flash attention forward launch")
    return out


def flash_attention_packed(q, k, v, num_heads: int, scale: Optional[float] = None):
    """Packed flash-attention forward: q [B,Sq,H*D], k/v [B,Sk,H*D] -> [B,Sq,H*D]."""
    _check(q, k, v, num_heads)
    d = q.shape[2] // num_heads
    if scale is None:
        scale = d**-0.5
    if q.device.type == "cpu":
        return attention_packed_reference(q, k, v, num_heads, scale)
    _check_kernel_input(q, k, v, d)

    from unigeo_tpu_torch import _build

    out = _launch(_build.load_library(), q, k, v, num_heads, scale)
    flash_attention_packed.launches += 1
    return out


flash_attention_packed.launches = 0


def flash_attention(q, k, v, scale: Optional[float] = None):
    """Head-split flash-attention forward: q [B,Sq,H,D], k/v [B,Sk,H,D] ->
    [B,Sq,H,D], through the packed view of the same bytes."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, H, D]")
    b, sq, h, d = q.shape
    if k.shape[2:] != (h, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)}")
    qp, kp, vp = (t.reshape(t.shape[0], t.shape[1], h * d) for t in (q, k, v))
    _check(qp, kp, vp, h)
    if scale is None:
        scale = d**-0.5
    if q.device.type == "cpu":
        return attention_packed_reference(qp, kp, vp, h, scale).view(b, sq, h, d)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("kernel takes contiguous q, k, v")
    _check_kernel_input(qp, kp, vp, d)

    from unigeo_tpu_torch import _build

    out = _launch(_build.load_library(), qp, kp, vp, h, scale, headsplit=True)
    flash_attention.launches += 1
    return out.view(b, sq, h, d)


flash_attention.launches = 0


# --- forward with logsumexp, and the backward ---------------------------------


def attention_fwd_lse_reference(q, k, v, num_heads: int, scale: Optional[float] = None):
    """(out, lse): softmax(q_h k_h^T * scale) v_h per head in f32, returned in
    q's dtype, and the logsumexp of each row of scaled scores, f32 [B, H, Sq]."""
    b, sq, hd = q.shape
    if scale is None:
        scale = (hd // num_heads) ** -0.5
    qh, kh, vh = (_heads(x, num_heads) for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, vh)
    return out.reshape(b, sq, hd).to(q.dtype), lse


def _delta(out, dout, num_heads: int):
    """delta = rowsum(dO * O) per head, f32 [B, H, Sq] (computed outside the
    backward kernels, as attention.py:615 of the JAX package does)."""
    return (_heads(dout, num_heads) * _heads(out, num_heads)).sum(-1).transpose(1, 2).contiguous()


def _bwd_dense(q, k, v, dout, lse, delta, num_heads: int, scale: float):
    """The backward's dense f32 intermediates: heads of q, k, dO, and P, dS
    [B, H, Sq, Sk] with P = exp(S - lse), dS = P * (dO v^T - delta) * scale."""
    qh, kh, vh, doh = (_heads(x, num_heads) for x in (q, k, v, dout))
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", doh, vh)
    ds = p * (dp - delta.float()[..., None]) * scale
    return qh, kh, doh, p, ds


def _bwd_plain(q, k, v, dout, lse, delta, num_heads: int, scale: float,
               parts=("dq", "dk", "dv")):
    """The plain backward's gradients named in ``parts``, each in its input's
    dtype: the dq kernel's plain version is ``parts=("dq",)``, the dk/dv
    kernel's ``("dk", "dv")``."""
    qh, kh, doh, p, ds = _bwd_dense(q, k, v, dout, lse, delta, num_heads, scale)
    make = {
        "dq": lambda: torch.einsum("bhqk,bkhd->bqhd", ds, kh).reshape(q.shape).to(q.dtype),
        "dk": lambda: torch.einsum("bhqk,bqhd->bkhd", ds, qh).reshape(k.shape).to(k.dtype),
        "dv": lambda: torch.einsum("bhqk,bqhd->bkhd", p, doh).reshape(v.shape).to(v.dtype),
    }
    return tuple(make[name]() for name in parts)


def attention_bwd_reference(q, k, v, out, lse, dout, num_heads: int,
                            scale: Optional[float] = None):
    """(dq, dk, dv) of packed attention from the forward's out and lse, in f32
    without autograd: P = exp(S - lse), dP = dO v^T, delta = rowsum(dO * O),
    dS = P * (dP - delta) * scale; dq = dS k, dk = dS^T q, dv = P^T dO.  Each
    gradient is returned in its input's dtype."""
    if scale is None:
        scale = (q.shape[2] // num_heads) ** -0.5
    return _bwd_plain(q, k, v, dout, lse, _delta(out, dout, num_heads), num_heads, scale)


def grad_error_limits(q, k, v, out, lse, dout, num_heads: int, grads,
                      scale: Optional[float] = None, cuda_core: bool = False):
    """Elementwise limits on |kernel - plain version| for ``grads`` = the plain
    version's (dq, dk, dv), both versions given the same q, k, v, out, lse
    and dO (delta = rowsum(dO * O) is the same torch code in both).

    With T the magnitude sums of each gradient's last product, T_dq =
    |dS||k|, T_dk = |dS|^T|q|, T_dv = P^T|dO|:

    * bf16 inputs: three roundings differ between the versions, each at most
      bf16's unit roundoff 2^-8 of what it rounds: the kernel rounds P to
      bf16 before dv = P^T dO (2^-8 T_dv), and dS before dq = dS k and
      dk = dS^T q (2^-8 T_dq, 2^-8 T_dk); each version rounds its f32
      gradient to bf16 once (together 2^-8 (|x_kernel| + |x_plain|), about
      2^-7 |ref|).
    * f32 inputs: no rounding differs, but each version sums the last
      product in its own order: at most n 2^-24 T each, n = max(Sq, Sk).
    * bf16 inputs on the CUDA-core body (``cuda_core``,
      ``bf16_bwd_on_cuda_core``): it rounds neither P nor dS, so only each
      gradient's one rounding (2^-7 |ref|) and the sums' order (2 n 2^-24 T,
      as in f32) differ.

    Both dtypes add F, the f32 error of S and dP (sums of D products, at
    most D 2^-24 of the sums of their magnitudes in each version) carried
    through P = exp(S - lse) and dS = P (dP - delta) scale into the
    gradients.  F matters where dP - delta cancels (S_k = 1 makes dS zero in
    exact arithmetic), elsewhere it is far below the other terms.  The limit
    is the sum, widened by 1/16 for the second-order terms and the kernel's
    exp2 (under 1e-4 relative).
    """
    if scale is None:
        scale = (q.shape[2] // num_heads) ** -0.5
    d = q.shape[2] // num_heads
    delta = _delta(out, dout, num_heads)
    qh, kh, doh, p, ds = _bwd_dense(q, k, v, dout, lse, delta, num_heads, scale)
    qa, ka, doa = qh.abs(), kh.abs(), doh.abs()
    va = _heads(v, num_heads).abs()
    ads = ds.abs()
    # T: magnitude sums of the last products
    t_dq = torch.einsum("bhqk,bkhd->bqhd", ads, ka)
    t_dk = torch.einsum("bhqk,bqhd->bkhd", ads, qa)
    t_dv = torch.einsum("bhqk,bqhd->bkhd", p, doa)
    # F: errors of the scaled S and of dP in each of the two versions
    gamma_d = d * 2.0**-24
    s_err = scale * gamma_d * torch.einsum("bqhd,bkhd->bhqk", qa, ka)
    dp_err = gamma_d * torch.einsum("bqhd,bkhd->bhqk", doa, va)
    e_p = 2.0 * p * s_err
    e_ds = 2.0 * (p * dp_err * scale + ads * s_err)
    f_dq = torch.einsum("bhqk,bkhd->bqhd", e_ds, ka)
    f_dk = torch.einsum("bhqk,bqhd->bkhd", e_ds, qa)
    f_dv = torch.einsum("bhqk,bqhd->bkhd", e_p, doa)
    limits = []
    for g, t, f in zip(grads, (t_dq, t_dk, t_dv), (f_dq, f_dk, f_dv)):
        t, f = t.reshape(g.shape), f.reshape(g.shape)
        if q.dtype == torch.bfloat16 and cuda_core:
            lim = (2.0**-7 * g.float().abs()
                   + 2.0 * max(q.shape[1], k.shape[1]) * 2.0**-24 * t + f)
        elif q.dtype == torch.bfloat16:
            lim = 2.0**-7 * g.float().abs() + 2.0**-8 * t + f
        else:
            lim = 2.0 * max(q.shape[1], k.shape[1]) * 2.0**-24 * t + f
        limits.append(1.0625 * lim)
    return tuple(limits)


def _check_lse(lse, q, num_heads: int, name: str = "lse"):
    b, sq, _ = q.shape
    if tuple(lse.shape) != (b, num_heads, sq) or lse.dtype != torch.float32:
        raise ValueError(f"{name} must be f32 [B, H, Sq] = {(b, num_heads, sq)}, "
                         f"not {lse.dtype} {tuple(lse.shape)}")
    if lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"{name} must be contiguous, on q's device")


def _check_bwd_kernel_input(q, k, v, dout, d: int):
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if q.dtype not in _DTYPE_TAGS:
        raise ValueError(f"kernel takes float32 or bfloat16, not {q.dtype}")
    tensors = (q, k, v, dout)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("backward kernel takes contiguous q, k, v, dO")
    # 16-byte tile loads in the f32 bodies at d = 64; bf16 rows that the TMA
    # cannot take run on the CUDA-core body
    if q.dtype == torch.float32 and d == F32_TILED_HEAD_WIDTH and not _aligned16(*tensors):
        raise ValueError(f"{q.dtype} backward kernel at d = {d} takes rows aligned to 16 bytes")


def _bwd_args(q, k, num_heads: int, scale: float):
    b, sq, hd = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return (b, sq, k.shape[1], num_heads, hd // num_heads, float(scale),
            _DTYPE_TAGS[q.dtype], stream)


def _launch_bwd_dq(lib, q, k, v, dout, lse, delta, num_heads: int, scale: float):
    """One launch of the dq kernel in ``lib``."""
    from unigeo_tpu_torch import _build

    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.unigeo_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), *_bwd_args(q, k, num_heads, scale),
        )
    _build.check(lib, err, "flash attention backward dq launch")
    return dq


def _launch_bwd_dkv(lib, q, k, v, dout, lse, delta, num_heads: int, scale: float):
    """One launch of the dk/dv kernel in ``lib``."""
    from unigeo_tpu_torch import _build

    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = lib.unigeo_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_bwd_args(q, k, num_heads, scale),
        )
    _build.check(lib, err, "flash attention backward dk/dv launch")
    return dk, dv


def flash_attention_fwd_lse(q, k, v, num_heads: int, scale: Optional[float] = None):
    """Forward with logsumexp: -> (out [B,Sq,H*D], lse [B,H,Sq] f32)."""
    _check(q, k, v, num_heads)
    d = q.shape[2] // num_heads
    if scale is None:
        scale = d**-0.5
    if q.device.type == "cpu":
        return attention_fwd_lse_reference(q, k, v, num_heads, scale)
    _check_kernel_input(q, k, v, d)

    from unigeo_tpu_torch import _build

    lse = torch.empty((q.shape[0], num_heads, q.shape[1]), dtype=torch.float32,
                      device=q.device)
    out = _launch(_build.load_library(), q, k, v, num_heads, scale, lse=lse)
    flash_attention_fwd_lse.launches += 1
    return out, lse


flash_attention_fwd_lse.launches = 0


def _check_bwd(q, k, v, dout, lse, delta, num_heads: int):
    """Shapes, dtypes and devices of a backward's inputs (``delta`` may be
    None); returns (default scale, head width)."""
    _check(q, k, v, num_heads)
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"dO must match q: {dout.dtype} {tuple(dout.shape)}")
    _check_lse(lse, q, num_heads)
    if delta is not None:
        _check_lse(delta, q, num_heads, "delta")
    d = q.shape[2] // num_heads
    return d**-0.5, d


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, num_heads: int,
                           scale: Optional[float] = None):
    """dq from q, k, v, dO, the forward's lse and delta (both f32 [B,H,Sq])."""
    default_scale, d = _check_bwd(q, k, v, dout, lse, delta, num_heads)
    scale = default_scale if scale is None else scale
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, dout, lse, delta, num_heads, scale, ("dq",))[0]
    _check_bwd_kernel_input(q, k, v, dout, d)

    from unigeo_tpu_torch import _build

    dq = _launch_bwd_dq(_build.load_library(), q, k, v, dout, lse, delta, num_heads, scale)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, num_heads: int,
                            scale: Optional[float] = None):
    """(dk, dv) from q, k, v, dO, the forward's lse and delta."""
    default_scale, d = _check_bwd(q, k, v, dout, lse, delta, num_heads)
    scale = default_scale if scale is None else scale
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, dout, lse, delta, num_heads, scale, ("dk", "dv"))
    _check_bwd_kernel_input(q, k, v, dout, d)

    from unigeo_tpu_torch import _build

    dk, dv = _launch_bwd_dkv(_build.load_library(), q, k, v, dout, lse, delta,
                             num_heads, scale)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, num_heads: int,
                        scale: Optional[float] = None):
    """Packed flash backward: (dq, dk, dv) in the packed layout.  delta =
    rowsum(dO * O) is plain torch in f32; then the dq and the dk/dv kernels."""
    if out.shape != q.shape or out.dtype != q.dtype or out.device != q.device:
        raise ValueError(f"out must match q: {out.dtype} {tuple(out.shape)}")
    _check_bwd(q, k, v, dout, lse, None, num_heads)
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, out, lse, dout, num_heads, scale)
    delta = _delta(out, dout, num_heads)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, num_heads, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, num_heads, scale)
    return dq, dk, dv


class FlashAttentionPacked(torch.autograd.Function):
    """Differentiable packed attention, the port of the JAX package's
    ``attention_packed`` custom_vjp: the forward is ``flash_attention_fwd_lse``
    (q, k, v, out and lse saved), the backward ``flash_attention_bwd``.

    ``FlashAttentionPacked.apply(q, k, v, num_heads, scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, scale: float):
        out, lse = flash_attention_fwd_lse(q, k, v, num_heads, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         ctx.num_heads, ctx.scale)
        return dq, dk, dv, None, None
