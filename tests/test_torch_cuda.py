"""The port's CUDA kernel against its plain version, on the card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  They import
no JAX, so they run on a machine that has only PyTorch:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: f32 inputs (the CUDA-core path), f32 arithmetic in both
versions, only the order of the sums differs: 1e-5 absolute on outputs of
order 1.  bf16 inputs (the tensor-core path): the elementwise limit of
``bf16_error_limit``, 1.0625 * (2^-7 |ref| + 2^-8 P|V|), from the two
roundings in which the versions differ (P to bf16 before P.V, the output to
bf16), each at most bf16's unit roundoff 2^-8; at least 3.3e-3 for these
N(0,1) inputs (P|V| is about 0.8).  The planted-fault test shows
that the limit fails a kernel that drops one key tile or the ragged-edge
mask at the main-path shapes.
"""

import os

import numpy as np
import pytest
import torch

from unigeo_tpu_torch import _build
from unigeo_tpu_torch.device import set_exact_f32
from unigeo_tpu_torch.ops import attention
from unigeo_tpu_torch.ops.attention import (
    attention_packed_reference,
    bf16_error_limit,
    flash_attention_packed,
)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    set_exact_f32()
    return torch.device("cuda")


def _qkv(b, sq, sk, h, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda s: torch.from_numpy(
        rng.standard_normal((b, s, h * d)).astype(np.float32)
    ).to(device=device, dtype=dtype)
    return mk(sq), mk(sk), mk(sk)


def _err_over_limit(out, q, k, v, h):
    """max over elements of |out - plain| / bf16 limit (fails above 1)."""
    ref = attention_packed_reference(q, k, v, h)
    limit = bf16_error_limit(q, k, v, h, ref)
    return ((out.float() - ref.float()).abs() / limit).max().item()


@pytest.mark.parametrize(
    "b,sq,sk,h,d",
    [
        (2, 70, 100, 3, 8),
        (2, 70, 100, 3, 10),
        (2, 130, 130, 2, 64),
        (2, 257, 257, 4, 80),
        (1, 200, 150, 1, 32),
        (1, 96, 77, 1, 512),
    ],
)
def test_kernel_matches_plain_f32(cuda, b, sq, sk, h, d):
    q, k, v = _qkv(b, sq, sk, h, d, torch.float32, cuda)
    before = flash_attention_packed.launches
    out = flash_attention_packed(q, k, v, h)
    torch.cuda.synchronize()
    assert flash_attention_packed.launches == before + 1
    ref = attention_packed_reference(q, k, v, h)
    err = (out - ref).abs().max().item()
    assert err < 1e-5, err


@pytest.mark.parametrize(
    "b,sq,sk,h,d",
    [
        (2, 70, 100, 3, 16),
        (1, 200, 150, 1, 16),
        (1, 200, 150, 1, 64),
        (2, 130, 61, 2, 64),
        (2, 257, 257, 4, 80),
        (1, 96, 77, 1, 512),
    ],
)
def test_kernel_matches_plain_bf16(cuda, b, sq, sk, h, d):
    q, k, v = _qkv(b, sq, sk, h, d, torch.bfloat16, cuda, seed=3)
    out = flash_attention_packed(q, k, v, h)
    torch.cuda.synchronize()
    ratio = _err_over_limit(out, q, k, v, h)
    assert ratio <= 1.0, ratio


@pytest.mark.parametrize(
    "b,s,h,d",
    [(2, 3072, 5, 64), (2, 768, 10, 64), (2, 192, 20, 64), (2, 257, 16, 80),
     (1, 3072, 1, 512)],
)
def test_kernel_matches_plain_bf16_main_path_shapes(cuda, b, s, h, d):
    q, k, v = _qkv(b, s, s, h, d, torch.bfloat16, cuda)
    out = flash_attention_packed(q, k, v, h)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ratio = _err_over_limit(out, q, k, v, h)
    assert ratio <= 1.0, ratio


# textual faults planted in a copy of the kernel source: (anchor, replacement)
PLANTED_FAULTS = {
    # the tensor-core loop skips its eighth key tile
    "drop_key_tile": (
        "  for (int k0 = 0; k0 < Sk; k0 += BK) {\n    __syncthreads();\n    load_tile<",
        "  for (int k0 = 0; k0 < Sk; k0 += BK) {\n    if (k0 == 7 * BK) continue;\n"
        "    __syncthreads();\n    load_tile<",
    ),
    # keys past Sk (zero-filled) keep their score instead of -inf
    "no_ragged_mask": (
        "s[j][e] = key < Sk ? s[j][e] * scale_log2 : -INFINITY;",
        "s[j][e] = s[j][e] * scale_log2;",
    ),
}


@pytest.fixture(scope="module")
def faulty_libraries(tmp_path_factory):
    """One library per planted fault, built from a mutated copy of the
    source in a temporary directory; the nvcc runs go in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    src = os.path.join(_build.CSRC_DIR, "flash_attention_packed.cu")
    with open(src) as f:
        text = f.read()
    root = tmp_path_factory.mktemp("planted")
    jobs = {}
    for name, (anchor, faulty) in PLANTED_FAULTS.items():
        assert text.count(anchor) == 1, f"{name}: anchor not found once in {src}"
        path = root / name / "flash_attention_packed.cu"
        path.parent.mkdir()
        path.write_text(text.replace(anchor, faulty))
        jobs[name] = (str(path), str(root / name / "libfaulty.so"))
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda j: _build.compile_library([j[0]], j[1]), jobs.values()))
    return {name: _build.open_library(out) for name, (_, out) in jobs.items()}


@pytest.mark.parametrize(
    "fault,b,s,h,d",
    [
        ("drop_key_tile", 2, 3072, 5, 64),
        ("drop_key_tile", 1, 3072, 1, 512),
        ("no_ragged_mask", 2, 257, 16, 80),
    ],
)
def test_limit_fails_planted_faults(cuda, faulty_libraries, fault, b, s, h, d):
    """At the main-path shapes, the kernel passes the bf16 limit and a copy
    of it with a planted fault fails it."""
    q, k, v = _qkv(b, s, s, h, d, torch.bfloat16, cuda, seed=5)
    good = _err_over_limit(flash_attention_packed(q, k, v, h), q, k, v, h)
    bad_out = attention._launch(faulty_libraries[fault], q, k, v, h, d**-0.5)
    bad = _err_over_limit(bad_out, q, k, v, h)
    print(f"planted {fault} [B={b},S={s},H={h},D={d}]: max err/limit "
          f"kernel {good:.3f}, faulty copy {bad:.3f}", flush=True)
    assert good <= 1.0 < bad, (good, bad)


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv(1, 128, 128, 2, 64, torch.float16, cuda)
    with pytest.raises(ValueError):
        flash_attention_packed(q, k, v, 2)
    q, k, v = _qkv(1, 128, 128, 1, 640, torch.float32, cuda)
    with pytest.raises(ValueError):
        flash_attention_packed(q, k, v, 1)
    q, k, v = _qkv(1, 128, 128, 2, 64, torch.float32, cuda)
    with pytest.raises(ValueError):
        flash_attention_packed(q[:, ::2], k[:, ::2], v[:, ::2], 2)
    # bf16: only the tensor-core head widths, and rows aligned to 16 bytes
    q, k, v = _qkv(1, 128, 128, 3, 8, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        flash_attention_packed(q, k, v, 3)
    b, s, h, d = 1, 150, 2, 64
    q, k, v = _qkv(b, s, s, h, d, torch.bfloat16, cuda)
    shift = lambda x: torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(b, s, h * d)
    qs, ks, vs = shift(q), shift(k), shift(v)
    assert qs.is_contiguous() and qs.data_ptr() % 16 != 0
    with pytest.raises(ValueError):
        flash_attention_packed(qs, ks, vs, h)
