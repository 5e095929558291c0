"""Fused GEGLU feed-forward: the hand-written CUDA kernel and its plain version.

Port of ``unigeo_tpu/ops/geglu.py``.  For x [..., C] and the port's own
weight layout (``nn.Linear`` weights, [out, in]):

    w1 = net.0.proj.weight [2H, C]  rows [0, H) value, [H, 2H) gate
    b1 = net.0.proj.bias   [2H]
    w2 = net.2.weight      [C_out, H]

it computes v = x w1v^T + b1v and g = x w1g^T + b1g in f32, h = bf16(v *
gelu_tanh(g)), and out = bf16(h w2^T) accumulated in f32 over every hidden
tile, without b2: the caller adds b2 in bf16, as ``models/layers.py`` does
in both packages.

* ``geglu_ffn``: the wrapper.  On a CUDA tensor it launches the kernel of
  ``csrc/geglu_ffn.cu`` (bf16 only; anything else raises) and adds one to
  ``geglu_ffn.launches``; on a CPU tensor it runs ``geglu_ffn_plain``.
  Where the kernel's plan splits the hidden tiles over items (too few row
  blocks to fill the card), the wrapper allocates the f32 scratch of the
  splits' partial outputs, which a last kernel sums in a fixed order; where
  it takes two passes (the up-projection, then the down-projection: at
  C_out 640 and 1280), the bf16 scratch of h [M, H] between them.
* ``kernel_plan``: the plan the kernel takes at a shape (``PLAN_KEYS``:
  columns a consumer, column groups, hidden splits, x resident or
  streamed, ring depths, items, blocks of the fused or down-projection
  pass; two passes or not; the up-projection pass's splits, x, ring, items
  and blocks).
* ``geglu_ffn_plain``: the same function step by step in f32 with
  ``torch.matmul``, h and the output rounded to bf16 as in the kernel.
* ``geglu_ffn_reference``: the unfused layers' arithmetic in the input
  dtype (the JAX package's ``geglu_ffn_reference``), through which
  ``GegluFFN``'s backward differentiates by recomputation, as the JAX
  package's ``geglu_ffn`` custom_vjp does: there is no backward kernel.
* ``use_fused_geglu``: the dispatch rule of ``models/layers.py::FeedForward``,
  read at call time: ``UNIGEO_FUSED_GEGLU=1`` and bf16 inputs and weights.
* ``geglu_error_limit``: the elementwise limit on kernel vs plain version.
"""

from __future__ import annotations

import functools
import os

import torch
import torch.nn.functional as F

GELU_TANH_C = 0.7978845608028654  # sqrt(2 / pi)
# rows of a cluster's item (two blocks of 64): a buffer of whole items holds
# every row the kernel may touch (out, and h in the two-pass plan)
BLOCK_M = 128
PLAN_KEYS = ("consumer_columns", "column_groups", "hidden_splits", "x_resident", "up_ring",
             "w2_ring", "items", "blocks", "two_pass", "up_pass_hidden_splits",
             "up_pass_x_resident", "up_pass_up_ring", "up_pass_items", "up_pass_blocks")
# the largest |gelu_tanh'|, over all of R (at x of about 1.5)
GELU_TANH_MAX_SLOPE = 1.13


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate gelu, the formula of the JAX kernel's ``_gelu_tanh``."""
    return 0.5 * x * (1.0 + torch.tanh(GELU_TANH_C * (x + 0.044715 * x * x * x)))


def use_fused_geglu(x_dtype, w_dtype) -> bool:
    """Opt-in, as in the JAX package: ``UNIGEO_FUSED_GEGLU=1``, and bf16 end to
    end (mixed or f32 dtypes keep the unfused path and its numerics)."""
    if os.environ.get("UNIGEO_FUSED_GEGLU", "0") != "1":
        return False
    return x_dtype == torch.bfloat16 and w_dtype == torch.bfloat16


def _check(x, w1, b1, w2):
    c = x.shape[-1]
    two_h = w1.shape[0]
    if w1.dim() != 2 or w1.shape[1] != c or two_h % 2:
        raise ValueError(f"w1 must be [2H, C={c}], not {tuple(w1.shape)}")
    if tuple(b1.shape) != (two_h,):
        raise ValueError(f"b1 must be [{two_h}], not {tuple(b1.shape)}")
    if w2.dim() != 2 or w2.shape[1] != two_h // 2:
        raise ValueError(f"w2 must be [C_out, H={two_h // 2}], not {tuple(w2.shape)}")
    if not (x.device == w1.device == b1.device == w2.device):
        raise ValueError("x and the weights must be on one device")


def _up(x2, w1, b1):
    """(v, g) of the up-projection in f32, x2 [M, C]."""
    hidden = w1.shape[0] // 2
    xf = x2.float()
    v = xf @ w1[:hidden].float().T + b1[:hidden].float()
    g = xf @ w1[hidden:].float().T + b1[hidden:].float()
    return v, g


def geglu_ffn_plain(x, w1, b1, w2):
    """The kernel's function step by step: f32 up-projection with f32 bias,
    gelu_tanh in f32, h rounded to x's dtype, f32 down-projection rounded to
    x's dtype.  x [..., C] -> [..., C_out]."""
    _check(x, w1, b1, w2)
    x2 = x.reshape(-1, x.shape[-1])
    v, g = _up(x2, w1, b1)
    h = (v * gelu_tanh(g)).to(x.dtype)
    out = (h.float() @ w2.float().T).to(x.dtype)
    return out.reshape(*x.shape[:-1], w2.shape[0])


def geglu_error_limit(x, w1, b1, w2, ref):
    """Elementwise limit on |kernel - plain version| for bf16 inputs; ``ref``
    is the plain version's output.

    Both versions read the same bf16 values and accumulate both products in
    f32; they differ only in the order of the f32 sums, and so in what each
    rounds to bf16:

    * h: the f32 values of v and g differ by at most 2 C 2^-24 of the
      magnitude sums |x||w1|^T + |b1| (both orders' errors), which moves h
      by at most |gelu(g)| dv + 1.13 |v| dg (1.13 bounds gelu_tanh's slope);
      each version then rounds h to bf16, a relative error of at most 2^-8,
      so where the two f32 values straddle a rounding boundary the bf16 h
      differ by one unit, at most 2^-7 |h|.  Carried through |w2| that is
      2^-7 T + F_up, with T = |h| |w2|^T;
    * the down-projection's f32 sums over H terms: at most 2 H 2^-24 T;
    * each version rounds its f32 output to bf16 once: together
      2^-8 (|out_kernel| + |out_plain|), about 2^-7 |ref|.

    The limit is the sum, widened by 1/16 for the second-order terms and the
    kernel's tanhf (under 1e-6 relative).
    """
    x2 = x.reshape(-1, x.shape[-1])
    hidden = w1.shape[0] // 2
    v, g = _up(x2, w1, b1)
    h = (v * gelu_tanh(g)).to(x.dtype).float()
    xa, w1a, b1a = x2.float().abs(), w1.float().abs(), b1.float().abs()
    w2a = w2.float().abs().T
    gamma_c = 2.0 * x2.shape[-1] * 2.0**-24
    dv = gamma_c * (xa @ w1a[:hidden].T + b1a[:hidden])
    dg = gamma_c * (xa @ w1a[hidden:].T + b1a[hidden:])
    f_up = (gelu_tanh(g).abs() * dv + GELU_TANH_MAX_SLOPE * v.abs() * dg) @ w2a
    t = h.abs() @ w2a
    lim = 2.0**-7 * ref.reshape(t.shape).float().abs() + (2.0**-7 + 2.0 * hidden * 2.0**-24) * t
    return (1.0625 * (lim + f_up)).reshape(ref.shape)


def _check_kernel_input(x2, w1, b1, w2):
    if x2.device.type != "cuda":
        raise ValueError(f"no kernel for device {x2.device}")
    if not all(t.dtype == torch.bfloat16 for t in (x2, w1, b1, w2)):
        raise ValueError(f"kernel takes bfloat16 only, not {x2.dtype} / {w1.dtype}")
    c, hidden, c_out = x2.shape[1], w1.shape[0] // 2, w2.shape[0]
    if c % 64 or hidden % 64 or c_out % 16:
        raise ValueError(f"kernel takes C and H multiples of 64 and C_out of 16, "
                         f"not C={c} H={hidden} C_out={c_out}")
    if not all(t.is_contiguous() for t in (x2, w1, b1, w2)):
        raise ValueError("kernel takes contiguous x and weights")
    if any(t.data_ptr() % 16 for t in (x2, w1, w2)):
        raise ValueError("kernel takes x, w1, w2 aligned to 16 bytes")


@functools.lru_cache(maxsize=None)
def _plan(lib, device, m, c, hidden, c_out):
    import ctypes

    from unigeo_tpu_torch import _build

    plan = (ctypes.c_int * len(PLAN_KEYS))()
    with torch.cuda.device(device):
        err = lib.unigeo_geglu_ffn_plan(m, c, hidden, c_out, plan)
    _build.check(lib, err, "geglu feed-forward plan")
    return tuple(plan)


def kernel_plan(lib, m, c, hidden, c_out, device=None):
    """The plan of the kernel in ``lib`` at x [m, c], hidden ``hidden`` and
    ``c_out`` output columns on ``device`` (the current one by default): a
    dict of ``PLAN_KEYS``.  Worked out once per library, device and sizes,
    here and in the library."""
    device = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if device.index is None else device.index
    return dict(zip(PLAN_KEYS, _plan(lib, index, m, c, hidden, c_out)))


def _run(lib, x2, w1, b1, w2, out, partial, hbuf):
    """The kernel in ``lib`` into ``out`` with the scratch buffers its plan
    needs: ``partial`` f32 [hidden splits, M, C_out] where the plan splits
    the hidden tiles, ``hbuf`` bf16 [M, H] where it takes two passes (else
    None)."""
    from unigeo_tpu_torch import _build

    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = lib.unigeo_geglu_ffn(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), out.data_ptr(),
            ptr(partial), ptr(hbuf), x2.shape[0], x2.shape[1], w1.shape[0] // 2, w2.shape[0],
            stream,
        )
    _build.check(lib, err, "geglu feed-forward launch")
    return out


def _launch(lib, x2, w1, b1, w2, out):
    """One launch of the kernel in ``lib`` (a library from ``_build``) into
    ``out`` [M, C_out] (contiguous bf16), with the scratch its plan needs."""
    m, c, hidden, c_out = x2.shape[0], x2.shape[1], w1.shape[0] // 2, w2.shape[0]
    plan = kernel_plan(lib, m, c, hidden, c_out, x2.device)
    splits = plan["hidden_splits"]
    partial = hbuf = None
    if splits > 1:  # the splits' f32 partial outputs, summed by the kernel's last pass
        partial = torch.empty((splits, m, c_out), dtype=torch.float32, device=x2.device)
    if plan["two_pass"]:  # h, written by the up-projection pass, read by the down pass
        hbuf = torch.empty((m, hidden), dtype=torch.bfloat16, device=x2.device)
    return _run(lib, x2, w1, b1, w2, out, partial, hbuf)


def geglu_ffn(x, w1, b1, w2):
    """Fused GEGLU feed-forward without b2: x [..., C] -> [..., C_out]."""
    _check(x, w1, b1, w2)
    if x.device.type == "cpu":
        return geglu_ffn_plain(x, w1, b1, w2)
    x2 = x.reshape(-1, x.shape[-1])
    _check_kernel_input(x2, w1, b1, w2)

    from unigeo_tpu_torch import _build

    out = torch.empty((x2.shape[0], w2.shape[0]), dtype=x.dtype, device=x.device)
    _launch(_build.load_library(), x2, w1, b1, w2, out)
    geglu_ffn.launches += 1
    return out.reshape(*x.shape[:-1], w2.shape[0])


geglu_ffn.launches = 0


def geglu_ffn_reference(x, w1, b1, w2):
    """The unfused feed-forward without b2, in x's dtype: x w1^T + b1, split,
    v * gelu(g) (tanh form in bf16, erf in f32, as ``layers.GEGLU``), then
    the down-projection."""
    hidden = w1.shape[0] // 2
    h = F.linear(x, w1.to(x.dtype), b1.to(x.dtype))
    v, g = h[..., :hidden], h[..., hidden:]
    act = v * F.gelu(g, approximate="tanh" if x.dtype == torch.bfloat16 else "none")
    return act @ w2.to(x.dtype).T


class GegluFFN(torch.autograd.Function):
    """Differentiable fused feed-forward, the port of the JAX package's
    ``geglu_ffn`` custom_vjp: the forward is ``geglu_ffn`` (the kernel on the
    card), the backward autograd through ``geglu_ffn_reference`` recomputed
    from the saved inputs.

    ``GegluFFN.apply(x, w1, b1, w2)``."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2):
        ctx.save_for_backward(x, w1, b1, w2)
        return geglu_ffn(x, w1, b1, w2)

    @staticmethod
    def backward(ctx, dout):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = geglu_ffn_reference(*inputs)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, dout))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)
