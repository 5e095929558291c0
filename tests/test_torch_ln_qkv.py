"""The port's fused LayerNorm -> dense (plain version, CPU) against the JAX package.

Inputs are made with numpy from a seed (rows with a mean of 1 and a spread
of 2, gamma ~ 1 + 0.2 N, beta ~ 0.3 N, W ~ N(0, 1/C), b ~ 0.1 N) and handed
to both packages in the dtype of the case.  The JAX side is the Pallas
kernel ``ln_dense_tpu`` in interpret mode, as tests/test_ln_qkv.py runs it,
and its ``ln_dense_reference`` (the jnp composition); the port's weight is
the JAX kernel transposed ([N, C], ``nn.Linear``'s layout).

Tolerances:
* f32: 1e-5 absolute on outputs of order 1 (the same f32 arithmetic, sums
  in other orders: seen 1.7e-6).
* bf16: the elementwise limit ``ln_dense_error_limit``, 1.0625 (2^-7 |ref|
  + 2 C 2^-24 T + dY |W|^T), T = |y| |W|^T + |b|: one bf16 unit of the
  output (each side rounds its f32 sum once), the f32 product's sums in
  another order, and the flip allowance dY of y's bf16 rounding, non-zero
  only where the two f32 values of y can straddle a rounding boundary (see
  the function's docstring).  The port's unfused reference (``F.layer_norm``
  then ``F.linear`` in f32) is held to the same limit.
* The flax ``LayerNorm -> Dense`` module, its parameters carried across by
  ``utils/weights.py::to_torch_layout``, against the port's plain version
  and reference in f32: 1e-5 absolute (tests/test_ln_qkv.py's bound for
  the JAX reference).
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigeo_tpu.ops.ln_qkv import ln_dense_reference as j_reference
from unigeo_tpu.ops.ln_qkv import ln_dense_tpu
from unigeo_tpu_torch.ops.ln_qkv import (
    ln_dense,
    ln_dense_error_limit,
    ln_dense_plain,
    ln_dense_reference,
)
from unigeo_tpu_torch.tools import ablate_ln_qkv
from unigeo_tpu_torch.utils.weights import to_torch_layout

# (M, C, mult): tests/test_ln_qkv.py's cases (a non-tile M, N = 3C and 2C)
# and C = 96
CASES = [(512, 256, 3), (100, 128, 2), (64, 96, 3)]
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
F32_TOL = 1e-5


def _inputs(m, c, mult, jdtype, seed=0):
    """x, gamma, beta, JAX-layout w [C, N], bias as f32 numpy arrays exact in
    ``jdtype``."""
    rng = np.random.default_rng(seed)
    n = mult * c
    arrays = (rng.normal(size=(m, c)) * 2.0 + 1.0, 1.0 + 0.2 * rng.normal(size=c),
              0.3 * rng.normal(size=c), rng.normal(size=(c, n)) / np.sqrt(c),
              0.1 * rng.normal(size=n))
    return [np.asarray(jnp.asarray(a, jdtype).astype(jnp.float32)) for a in arrays]


def _port(arrays, dtype):
    x, g, b, w, bias = (torch.from_numpy(np.array(a)).to(dtype) for a in arrays)
    return x, g, b, w.T.contiguous(), bias


@pytest.fixture(scope="module")
def jax_outputs():
    """(case, dtype) -> (interpret-mode kernel, jnp reference) outputs in f32."""
    out = {}
    for m, c, mult in CASES:
        for name, (_, jdtype) in DTYPES.items():
            args = [jnp.asarray(a, jdtype) for a in _inputs(m, c, mult, jdtype)]
            out[(m, c, mult, name)] = (
                np.asarray(ln_dense_tpu(*args, interpret=True).astype(jnp.float32)),
                np.asarray(j_reference(*args).astype(jnp.float32)))
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,c,mult", CASES)
def test_plain_matches_pallas_interpret_and_references(jax_outputs, m, c, mult, dtype):
    tdtype, jdtype = DTYPES[dtype]
    args = _port(_inputs(m, c, mult, jdtype), tdtype)
    before = ln_dense.launches
    ours = ln_dense(*args)
    assert ln_dense.launches == before  # the CPU runs the plain version
    torch.testing.assert_close(ours, ln_dense_plain(*args), atol=0, rtol=0)
    assert ours.dtype == tdtype and ours.shape == (m, mult * c)
    kernel, reference = (torch.from_numpy(np.array(a)) for a in jax_outputs[(m, c, mult, dtype)])
    port_reference = ln_dense_reference(*args)
    if dtype == "f32":
        for other in (kernel, reference, port_reference):
            assert (ours - other.float()).abs().max().item() <= F32_TOL
    else:
        limit = ln_dense_error_limit(*args, ours)
        for other in (kernel, reference, port_reference):
            assert ((ours.float() - other.float()).abs() / limit).max().item() <= 1.0


def test_flax_layernorm_dense_carried_across():
    """flax LayerNorm -> Dense, its parameters through the port's Dense rule
    (a 2-D ``.weight`` is transposed to [out, in]; scale and biases as they
    are), against the plain version and the reference."""
    import flax.linen as nn

    class LnDense(nn.Module):
        n: int

        @nn.compact
        def __call__(self, x):
            return nn.Dense(self.n)(nn.LayerNorm(epsilon=1e-5)(x))

    m, c, n = 64, 96, 192
    x = jax.random.normal(jax.random.PRNGKey(0), (m, c), jnp.float32) * 3.0 + 2.0
    params = LnDense(n).init(jax.random.PRNGKey(1), x)["params"]
    ref = np.asarray(LnDense(n).apply({"params": params}, x))
    leaves = {"norm.weight": params["LayerNorm_0"]["scale"],
              "norm.bias": params["LayerNorm_0"]["bias"],
              "proj.weight": params["Dense_0"]["kernel"], "proj.bias": params["Dense_0"]["bias"]}
    sd = {k: torch.from_numpy(np.array(to_torch_layout(k, np.asarray(v))))
          for k, v in leaves.items()}
    assert tuple(sd["proj.weight"].shape) == (n, c)
    args = (torch.from_numpy(np.asarray(x)), sd["norm.weight"], sd["norm.bias"],
            sd["proj.weight"], sd["proj.bias"])
    for fn in (ln_dense_plain, ln_dense_reference):
        assert np.abs(fn(*args).numpy() - ref).max() <= F32_TOL


def test_wrapper_rejects_bad_shapes():
    x = torch.zeros(10, 32)
    g, b = torch.ones(32), torch.zeros(32)
    w, bias = torch.zeros(96, 32), torch.zeros(96)
    assert ln_dense(x, g, b, w, bias).shape == (10, 96)
    for bad in ((x[None], g, b, w, bias), (x, g[:16], b, w, bias), (x, g, b, w[:, :16], bias),
                (x, g, b, w, bias[:10])):
        with pytest.raises(ValueError):
            ln_dense(*bad)


def test_ablation_tool_on_the_cpu_prints_its_keys():
    before = ln_dense.launches
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = ablate_ln_qkv.main(["--small", "--device", "cpu"])
    assert json.loads(buf.getvalue()) == json.loads(json.dumps(results))
    assert ln_dense.launches == before
    assert results["device"] == "cpu"
    (row,) = results["shapes"]
    assert set(row) == {"M", "C", "N", "unfused_ms", "fused_ms", "speedup", "max_abs_dev",
                        "max_err_over_limit", "bound_ms", "bound_by"}
    assert (row["M"], row["C"], row["N"]) == (1024, 256, 768)
    assert row["unfused_ms"] is row["fused_ms"] is row["speedup"] is None  # nothing timed
    assert row["max_err_over_limit"] == 0.0 and row["max_abs_dev"] <= 2.0**-7 * 8
    # the bound: 2 M C N operations vs the bytes of x, W, out (and the vectors)
    ms, by = ablate_ln_qkv.bound(76800, 320, 960)
    assert by == "bytes" and abs(ms - 0.0589) < 5e-4
    assert ablate_ln_qkv.bound(19200, 640, 1920)[1] == "operations"
    assert ablate_ln_qkv.launches_per_shape() == ablate_ln_qkv.WARMUP + ablate_ln_qkv.LENGTH + 1
