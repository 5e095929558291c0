"""Packed multi-head attention: the hand-written CUDA kernel and its plain version.

Port of ``unigeo_tpu/ops/attention.py::flash_attention_tpu_packed``.  q, k and
v stay in the ``[B, S, H*D]`` layout that the projections emit; head h is the
column slice ``[h*D, (h+1)*D)``.

* ``flash_attention_packed`` is the wrapper.  On a CUDA tensor it launches
  ``csrc/flash_attention_packed.cu`` (built on first use, see ``_build.py``)
  or raises; on a CPU tensor it runs ``attention_packed_reference``.  Each
  launch adds one to ``flash_attention_packed.launches``.
* ``attention_packed_reference`` is the plain version: per-head softmax
  attention, in f32 by default (the numerics the kernel is held to; the
  wrapper's CPU path and the checks), or in the input dtype with
  ``upcast=False`` (the layers' path below the kernel's 128-token threshold,
  the 25-token temporal attention, as the JAX package keeps those on its jnp
  ``attention_reference``).
* ``bf16_error_limit`` is the elementwise limit on kernel vs plain version
  for bf16 inputs.
"""

from __future__ import annotations

from typing import Optional

import torch

_DTYPE_TAGS = {torch.float32: 0, torch.bfloat16: 1}
MIN_KERNEL_SEQ = 128  # same threshold as unigeo_tpu's use_packed_attention
# head widths of the bf16 tensor-core kernel: UNet 64, CLIP 80, VAE 512, and
# 16 for small checks; f32 takes any width up to 512 (CUDA cores)
BF16_HEAD_WIDTHS = (16, 64, 80, 512)


def attention_packed_reference(
    q, k, v, num_heads: int, scale: Optional[float] = None, upcast: bool = True
):
    """softmax(q_h k_h^T * scale) v_h per head, in f32 (or, with
    ``upcast=False``, in the input dtype); returns q's dtype."""
    b, sq, hd = q.shape
    sk = k.shape[1]
    d = hd // num_heads
    if scale is None:
        scale = d**-0.5
    cast = (lambda x: x.float()) if upcast else (lambda x: x)
    qh = cast(q).reshape(b, sq, num_heads, d)
    kh = cast(k).reshape(b, sk, num_heads, d)
    vh = cast(v).reshape(b, sk, num_heads, d)
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vh)
    return out.reshape(b, sq, hd).to(q.dtype)


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
    under 1e-4 relative).  ``ref`` is the plain version's output.
    """
    pv = attention_packed_reference(q.float(), k.float(), v.float().abs(), num_heads, scale)
    return 1.0625 * (2.0**-7 * ref.float().abs() + 2.0**-8 * pv)


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
    if d > 512:
        raise ValueError(f"kernel takes head widths up to 512, not {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("kernel takes contiguous q, k, v")
    if q.dtype == torch.bfloat16:
        if d not in BF16_HEAD_WIDTHS:
            raise ValueError(f"bf16 kernel takes head widths {BF16_HEAD_WIDTHS}, not {d}")
        # 16-byte tile loads (rows and head offsets are then multiples of 8)
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("bf16 kernel takes rows aligned to 16 bytes")


def _launch(lib, q, k, v, num_heads: int, scale: float):
    """One launch of the kernel in ``lib`` (a library from ``_build``)."""
    b, sq, hd = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.unigeo_flash_attention_packed(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            b, sq, k.shape[1], num_heads, hd // num_heads, float(scale),
            _DTYPE_TAGS[q.dtype], stream,
        )
    from unigeo_tpu_torch import _build

    _build.check(lib, err, "flash_attention_packed launch")
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
