"""Fused LayerNorm -> dense: the hand-written CUDA kernel and its plain version.

Port of ``unigeo_tpu/ops/ln_qkv.py``.  For x [M, C], gamma, beta [C], the
``nn.Linear`` weight [N, C] (the JAX package's [C, N] Dense kernel through
``utils/weights.py::to_torch_layout``) and its bias [N]:

    y = round_x((x - mean) rsqrt(var + eps) gamma + beta)   f32 row statistics
    out = round_x(y W^T + b)                                 f32 accumulate and bias

with var the mean of the centred squares, and round_x a rounding to x's
dtype (none for f32), the rounding points of the JAX kernel's body.

* ``ln_dense``: the wrapper.  On a CUDA tensor it launches the kernel of
  ``csrc/ln_dense.cu`` (bf16 or f32, all inputs of one dtype and contiguous;
  anything else raises) and adds one to ``ln_dense.launches``; on a CPU
  tensor it runs ``ln_dense_plain``.
* ``kernel_plan``: the bf16 body a launch takes (the wgmma body for 16-byte
  rows, else the mma.sync body) and the wgmma body's plan.
* ``ln_dense_plain``: the same function step by step with ``torch.matmul``.
* ``ln_dense_reference``: the unfused layers, ``F.layer_norm`` then
  ``F.linear`` in f32 with the same two roundings (the JAX package's
  ``ln_dense_reference``, the flax ``LayerNorm -> Dense`` composition).
* ``ln_dense_error_limit``: the elementwise limit on kernel vs plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK_M = 64  # rows of a kernel item: a buffer of whole items holds every row it may touch
PLAN_KEYS = ("wgmma", "y_buffers", "w_ring", "n_splits", "items", "blocks")
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_U = 2.0**-24  # f32 unit roundoff


def _check(x, gamma, beta, weight, bias):
    if x.dim() != 2:
        raise ValueError(f"x must be [M, C], not {tuple(x.shape)}")
    c = x.shape[1]
    if weight.dim() != 2 or weight.shape[1] != c:
        raise ValueError(f"weight must be [N, C={c}], not {tuple(weight.shape)}")
    if tuple(gamma.shape) != (c,) or tuple(beta.shape) != (c,):
        raise ValueError(f"gamma and beta must be [{c}], not {tuple(gamma.shape)} / "
                         f"{tuple(beta.shape)}")
    if tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"bias must be [{weight.shape[0]}], not {tuple(bias.shape)}")
    if not (x.device == gamma.device == beta.device == weight.device == bias.device):
        raise ValueError("x and the parameters must be on one device")


def _stats(x, eps):
    """(f32 x, x - mean, rsqrt(var + eps)) with var the mean of the centred
    squares, as the JAX body computes it."""
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    return xf, xc, torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)


def ln_dense_plain(x, gamma, beta, weight, bias, eps: float = 1e-5):
    """The kernel's function step by step: f32 statistics, y rounded to x's
    dtype, f32 product and bias, rounded to x's dtype.  x [M, C] -> [M, N]."""
    _check(x, gamma, beta, weight, bias)
    _, xc, rstd = _stats(x, eps)
    y = (xc * rstd * gamma.float() + beta.float()).to(x.dtype)
    return (y.float() @ weight.float().T + bias.float()).to(x.dtype)


def ln_dense_reference(x, gamma, beta, weight, bias, eps: float = 1e-5):
    """The unfused layers the kernel fuses: ``F.layer_norm`` and ``F.linear``
    in f32, the normalized rows and the output rounded to x's dtype."""
    _check(x, gamma, beta, weight, bias)
    y = F.layer_norm(x.float(), (x.shape[1],), gamma.float(), beta.float(), eps).to(x.dtype)
    return F.linear(y.float(), weight.float(), bias.float()).to(x.dtype)


def ln_dense_error_limit(x, gamma, beta, weight, bias, ref, eps: float = 1e-5):
    """Elementwise limit on |kernel - plain version|; ``ref`` is the plain
    version's output.

    Both versions read the same values and compute in f32; they differ in
    the order of their f32 sums, the rsqrt (the card's rsqrtf, within 2
    ulps), and so in what each rounds:

    * the mean: each f32 sum of C terms is within (C - 1) u sum|x| of the
      exact one (u = 2^-24), so the two means are within
      dmu = 2 C u mean|x| of each other;
    * the variance, a sum of C positive terms: within 2 (C + 3) u of each
      other relatively, and a mean off by dmu adds dmu^2 to it; so the two
      rsqrt are within drs = (C + 3) u + dmu^2 / (2 (var + eps)) + 8 u
      relatively;
    * y: dy = |gamma| rs (dmu + |x - mean| (drs + 4 u)) + 3 u (|x - mean| rs
      |gamma| + |beta|), the product and FMA roundings included.  Each
      version rounds its f32 y to x's dtype; where [y - dy, y + dy] holds a
      rounding boundary the rounded values may differ by one unit, so y may
      move by at most dY = max|round(y +- dy) - round(y)| (dy itself in
      f32).  Carried through |W| that is dY |W|^T;
    * the product's f32 sums over C terms, in other orders (on the tensor
      cores with truncating adds): at most 2 C u T, T = |y| |W|^T + |b|;
    * each version rounds its f32 output once: together 2 u_out (|out_kernel|
      + |out_plain|) / 2, about 2 u_out |ref| (u_out = 2^-8 for bf16, u for f32).

    The limit is the sum, widened by 1/16 for the second-order terms.  A
    rounding flip of y is allowed only where the f32 values can straddle a
    boundary, not at every element: a kernel that drops a slice of C, beta
    or a tile of columns fails it by far.
    """
    c = x.shape[1]
    xf, xc, rstd = _stats(x, eps)
    g, b = gamma.float(), beta.float()
    dmu = 2.0 * c * _U * xf.abs().mean(dim=-1, keepdim=True)
    var_eps = rstd.pow(-2)
    drs = (c + 3) * _U + dmu * dmu / (2.0 * var_eps) + 8 * _U
    xn = xc.abs() * rstd
    dy = g.abs() * (rstd * dmu + xn * (drs + 4 * _U)) + 3 * _U * (xn * g.abs() + b.abs())
    y32 = xc * rstd * g + b
    y = y32.to(x.dtype).float()
    d_round = torch.maximum((y32 + dy).to(x.dtype).float() - y,
                            y - (y32 - dy).to(x.dtype).float())
    wa = weight.float().abs().T
    t = y.abs() @ wa + bias.float().abs()
    u_out = 2.0**-8 if x.dtype == torch.bfloat16 else _U
    lim = 2.0 * u_out * ref.float().abs() + 2.0 * c * _U * t + torch.maximum(d_round, dy) @ wa
    return 1.0625 * lim


def _check_kernel_input(x, gamma, beta, weight, bias):
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    dtypes = {t.dtype for t in (x, gamma, beta, weight, bias)}
    if len(dtypes) != 1 or x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"kernel takes one dtype of {KERNEL_DTYPES} for every input, not "
                         f"{sorted(str(d) for d in dtypes)}")
    if not all(t.is_contiguous() for t in (x, gamma, beta, weight, bias)):
        raise ValueError("kernel takes contiguous x and parameters")
    if max(x.shape[0], x.shape[1], weight.shape[0]) >= 2**31:
        raise ValueError(f"kernel takes M, C, N below 2^31, not {tuple(x.shape)} / "
                         f"{weight.shape[0]}")


def kernel_plan(lib, x, gamma, beta, weight):
    """The bf16 body the kernel in ``lib`` takes for these tensors on the
    current device and its plan: a dict of ``PLAN_KEYS``, ``wgmma`` 1 for
    the TMA + wgmma body, 0 for the mma.sync body (the rest 0 then)."""
    import ctypes

    from unigeo_tpu_torch import _build

    plan = (ctypes.c_int * len(PLAN_KEYS))()
    with torch.cuda.device(x.device):
        err = lib.unigeo_ln_dense_plan(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                                       weight.data_ptr(), x.shape[0], x.shape[1],
                                       weight.shape[0], plan)
    _build.check(lib, err, "LayerNorm -> dense plan")
    return dict(zip(PLAN_KEYS, plan))


def _launch(lib, x, gamma, beta, weight, bias, out, eps):
    """One launch of the kernel in ``lib`` (a library from ``_build``) into
    ``out`` [M, N] (contiguous, x's dtype)."""
    from unigeo_tpu_torch import _build

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.unigeo_ln_dense(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            out.data_ptr(), x.shape[0], x.shape[1], weight.shape[0], eps,
            int(x.dtype == torch.bfloat16), stream,
        )
    _build.check(lib, err, "LayerNorm -> dense launch")
    return out


def ln_dense(x, gamma, beta, weight, bias, eps: float = 1e-5):
    """LayerNorm -> dense, x [M, C] -> [M, N]."""
    _check(x, gamma, beta, weight, bias)
    if x.device.type == "cpu":
        return ln_dense_plain(x, gamma, beta, weight, bias, eps)
    _check_kernel_input(x, gamma, beta, weight, bias)

    from unigeo_tpu_torch import _build

    out = torch.empty((x.shape[0], weight.shape[0]), dtype=x.dtype, device=x.device)
    _launch(_build.load_library(), x, gamma, beta, weight, bias, out, eps)
    ln_dense.launches += 1
    return out


ln_dense.launches = 0
