"""The port's bf16-vs-f32 numerics tool (``unigeo_tpu_torch/tools/
measure_bf16_drift.py``) against the JAX tool and the JAX package, on the
CPU at tiny sizes.

* the tool end to end on the tiny DepthCrafter (4 x 64 x 64, 2 steps) and
  the tiny Aether (8 x 128 x 128, 2 steps): every key, a nonzero finite
  drift (zero would mean both legs ran the same program), the file equal
  to the printed line, no ``BF16_DRIFT.json`` written at the root;
* ``reference_postproc`` against the JAX tool's, rtol 1e-6;
* the tool's figures of one seeded pair of depth clips against the same
  figures from the JAX package's ``depth_evaluation``,
  ``backproject_to_cv_position`` and ``surface_normals_from_points``: the
  depth metrics' shifts within 1e-5 relative, the normals by mean angle
  under 0.05 degree (the bound of tests/test_torch_vda.py; the plane fits
  are dominated by rounding, ROADMAP queue 3 item 5);
* the f32 leg against the JAX pipeline on the same weights, frames and
  noise, within test_torch_depthcrafter.py::test_run_window_staged's 1e-3;
* ROADMAP queue 3 item 2 at tiny size: the JAX package's bf16 leg (its
  pipeline at dtype bf16, as the JAX tool runs it) and the port's bf16 leg,
  each scored against the one shared f32 leg, both within 0.5% on Abs Rel,
  delta < 1.25 and normal mean.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import copy
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unigeo_tpu_torch.tools import measure_bf16_drift as drift

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("metric", "absrel", "absrel_aligned_lstsq", "rel_p99", "rel_max", "delta_1p25",
        "metric_shift_vs_fixed_gt", "normal_mean_angle_shift_deg", "north_star_tolerance",
        "within_tolerance", "device", "held", "held_within_tolerance", "jax_gate",
        "yardstick", "seconds", "launches", "constant_prediction_floor")
SHIFT_KEYS = ("Abs Rel", "Sq Rel", "RMSE", "delta < 1.25", "normal mean", "normal median")
T, H, W, STEPS = 2, 64, 64, 2


def run_tool(argv, tmp_path, capsys):
    out = tmp_path / "drift.json"
    result = drift.main([*argv, "--device", "cpu", "--out", str(out)])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(out.read_text()) == json.loads(printed) == json.loads(json.dumps(result))
    assert not os.path.exists(os.path.join(REPO, "BF16_DRIFT.json"))
    for key in KEYS:
        assert key in result, key
    assert set(result["metric_shift_vs_fixed_gt"]) == set(SHIFT_KEYS)
    assert all(np.isfinite(v) for v in result["metric_shift_vs_fixed_gt"].values())
    assert all(np.isfinite(v) for v in result["yardstick"]["metric_shift_vs_fixed_gt"].values())
    assert set(result["held"]) == {"Abs Rel", "delta < 1.25", "normal mean"}
    assert np.isfinite(result["rel_max"]) and np.isfinite(result["normal_mean_angle_shift_deg"])
    return result


def test_tool_tiny_depthcrafter(tmp_path, capsys):
    result = run_tool(["--tiny"], tmp_path, capsys)
    assert result["shape"] == [4, 64, 64] and result["steps"] == 2
    assert 0.0 < result["absrel"] < 0.5
    # rounding the inputs moves the network less than running it in bf16
    assert 0.0 < result["yardstick"]["absrel"] < result["absrel"]
    assert 0.5 <= result["delta_1p25"] <= 1.0
    assert result["launches"] == {"f32": 0, "yardstick": 0, "bf16": 0}  # plain versions here


def test_tool_tiny_aether(tmp_path, capsys):
    result = run_tool(["--model", "aether", "--tiny"], tmp_path, capsys)
    assert result["shape"] == [8, 128, 128] and result["steps"] == 2
    # a random adaLN-zero DiT outputs 0 unless its constant leaves are redrawn:
    # then both legs would agree trivially
    assert 0.0 < result["absrel"] < 0.5
    cam = result["camera_max_rel_dev"]
    assert all(np.isfinite(v) and v > 0 for v in (cam["raymaps"]["bf16"], cam["poses"]["bf16"]))


def test_reference_postproc_matches_jax_tool():
    from tools.measure_bf16_drift import reference_postproc

    decoded = np.random.default_rng(0).uniform(-1, 1, size=(3, 16, 16, 3)).astype(np.float32)
    ours = drift.reference_postproc(torch.from_numpy(decoded)).numpy()
    np.testing.assert_allclose(ours, reference_postproc(decoded), rtol=1e-6)


def mean_angle_deg(a, b):
    cos = np.clip((np.asarray(a, np.float64) * np.asarray(b, np.float64)).sum(-1), -1, 1)
    return float(np.degrees(np.arccos(cos)).mean())


def jax_figures(d_test, d_ref, gt, k):
    """The JAX tool's metric shifts and normals, from the JAX package."""
    from unigeo_tpu.metrics.depth import depth_evaluation
    from unigeo_tpu.metrics.normal import normal_evaluation
    from unigeo_tpu.ops.backproject import backproject_to_cv_position
    from unigeo_tpu.ops.normals import surface_normals_from_points

    def normals(d):
        pts = jax.vmap(lambda dd: backproject_to_cv_position(dd, k))(jnp.asarray(d))
        return np.asarray(surface_normals_from_points(pts))

    n_gt = normals(gt)
    legs = {}
    for tag, d in (("test", d_test), ("ref", d_ref)):
        m = depth_evaluation(d, gt, alignment="lstsq")[0]
        n = normal_evaluation(normals(d), n_gt)
        legs[tag] = {key: float((m if key in m else n)[key]) for key in SHIFT_KEYS}
    shift = {key: abs(legs["test"][key] - legs["ref"][key]) for key in SHIFT_KEYS}
    return shift, normals(d_test), normals(d_ref)


def test_figures_match_jax_package():
    rng = np.random.default_rng(3)
    t, h, w = 2, 48, 64
    gt = drift.synthetic_gt(t, h, w)
    # a reference clip that follows the GT with noise, and a test clip 20% off
    # it: every metric shifts by 1e4 times its f32 round-off or more
    d_ref = (gt * (1.0 + 0.1 * rng.standard_normal(gt.shape)) + 0.2).astype(np.float32)
    d_test = (np.abs(d_ref * (1.0 + 0.2 * rng.standard_normal(gt.shape))) + 0.05).astype(np.float32)
    k = drift.intrinsics(h, w)
    gt_t = torch.from_numpy(gt)
    legs = {tag: {"depth": torch.from_numpy(d), "normals": drift.depth_normals(torch.from_numpy(d), k)}
            for tag, d in (("test", d_test), ("ref", d_ref))}
    ours = drift.drift(legs["test"], legs["ref"], gt_t, drift.depth_normals(gt_t, k))
    shift, n_test, n_ref = jax_figures(d_test, d_ref, gt, k)
    for key in ("Abs Rel", "Sq Rel", "RMSE", "delta < 1.25"):
        assert shift[key] > 1e-2, (key, shift)
        assert abs(ours["metric_shift_vs_fixed_gt"][key] - shift[key]) <= 1e-5 * shift[key], key
    assert mean_angle_deg(legs["test"]["normals"].numpy(), n_test) < 0.05
    assert mean_angle_deg(legs["ref"]["normals"].numpy(), n_ref) < 0.05
    for key in ("normal mean", "normal median"):
        assert abs(ours["metric_shift_vs_fixed_gt"][key] - shift[key]) < 0.05, key
    assert abs(ours["normal_mean_angle_shift_deg"] - mean_angle_deg(n_test, n_ref)) < 0.05
    # the pixel figures are the JAX tool's formulas on the same arrays
    rel = np.abs(d_test - d_ref) / d_ref
    assert ours["absrel"] == pytest.approx(float(rel.mean()), rel=1e-6)
    assert ours["rel_max"] == pytest.approx(float(rel.max()), rel=1e-6)


@pytest.fixture(scope="module")
def tiny_legs(shared_tiny_pipeline):
    """The same frames, noise and aug noise through the JAX tiny pipeline in
    f32 and in bf16 (as the JAX tool runs them) and through the port's three
    legs on the same weights: the decoded clips."""
    from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline
    from unigeo_tpu_torch.utils.weights import pipeline_state_dicts

    jp = shared_tiny_pipeline
    rng = np.random.default_rng(11)
    frames = rng.random((T, H, W, 3)).astype(np.float32)
    noise = rng.standard_normal((T, H // 8, W // 8, 4)).astype(np.float32)
    aug = rng.standard_normal((T, H, W, 3)).astype(np.float32)
    f32 = np.array(jp.run_window_staged(jp.params, jnp.asarray(frames), jnp.asarray(noise),
                                          STEPS, aug_noise=jnp.asarray(aug)), np.float32)
    jb = copy.copy(jp)  # a pipeline object of its own: the jitted stages key on it
    jb.dtype = jnp.bfloat16
    params16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp.params)
    bf16 = np.array(jb.run_window_staged(params16, jnp.asarray(frames), jnp.asarray(noise),
                                           STEPS, aug_noise=jnp.asarray(aug)), np.float32)
    pp = tiny_pipeline(device="cpu", dtype=torch.float32)
    pp.load_state_dicts(*pipeline_state_dicts(jp.params, pp))
    decoded = {}
    with torch.no_grad():
        drift.depthcrafter_legs(pp, *(torch.from_numpy(a) for a in (frames, noise, aug)),
                                STEPS, drift.intrinsics(H, W), decoded=decoded)
    return {"jax_f32": f32, "jax_bf16": bf16, **{f"port_{k}": v.numpy() for k, v in decoded.items()}}


def test_f32_leg_matches_jax_pipeline(tiny_legs):
    ours, ref = tiny_legs["port_f32"], tiny_legs["jax_f32"]
    assert np.abs(ours - ref).max() / np.abs(ref).max() < 1e-3


@pytest.mark.parametrize("package", ["jax", "port"])
def test_bf16_leg_within_half_percent(tiny_legs, package):
    """Each package's bf16 leg scored against the shared f32 leg (the JAX
    package's) on the fixed GT: the held shifts within 0.5%."""
    k = drift.intrinsics(H, W)
    gt = torch.from_numpy(drift.synthetic_gt(T, H, W))

    def leg(decoded):
        depth = drift.reference_postproc(torch.from_numpy(decoded))
        return {"depth": depth, "normals": drift.depth_normals(depth, k)}

    summary = drift.drift(leg(tiny_legs[f"{package}_bf16"]), leg(tiny_legs["jax_f32"]), gt,
                          drift.depth_normals(gt, k))
    checks = drift.held(summary)
    print(package, json.dumps({key: c["rel_shift"] for key, c in checks.items()}),
          "absrel", summary["absrel"])
    assert summary["absrel"] > 0.0  # the bf16 leg is another program
    assert all(c["within"] for c in checks.values()), checks


def test_held_fails_a_shift_past_half_percent():
    summary = {"metric_shift_vs_fixed_gt": {"Abs Rel": 0.002, "delta < 1.25": 0.001,
                                            "normal mean": 0.5},
               "metrics_vs_fixed_gt": {"reference": {"Abs Rel": 0.3, "delta < 1.25": 0.5,
                                                     "normal mean": 80.0},
                                       "test": {"Abs Rel": 0.302, "delta < 1.25": 0.499,
                                                "normal mean": 80.5}}}
    checks = drift.held(summary)
    assert [checks[k]["within"] for k in drift.HELD_KEYS] == [False, True, False]
    assert checks["normal mean"]["limit"] == pytest.approx(0.4)
