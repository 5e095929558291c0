"""UniGeoCam with its geometry branch (the paper's model, all four metric
families) and the port's eval CLI on the synthetic configs, against the JAX
package on the CPU in f32.

* ``UniGeoCam.forward`` with the geometry branch (the tiny pipeline, the
  JAX weights carried over, the JAX draws passed in), the branch's outputs
  taken from the clip's GT in both packages, as the JAX package's fusion
  test does: a random network's pointmaps fit no camera, so their DLT is
  degenerate (the network and the camera recovery are held alone in
  ``tests/test_torch_pointmap.py``).  The aligned depths and world points
  within 1e-2 relative (the clip min-max and 1 / (x + 0.1) of the depth
  branch, the bound of ``tests/test_torch_depthcrafter.py``, carried
  through the least-squares alignment); the poses pass through unchanged.
* The degenerate-fit guard, both packages' ``_geometry_branch`` on the same
  depths and pointmap outputs: a fit kept (1e-5: f32 sums in another
  order), and each way the fit is refused (no valid pixel, a non-finite
  fit, s about 0) giving s, t = 1, 0 (so the clamped raw depth) in both.
* ``python -m unigeo_tpu_torch.eval`` on ``configs/unigeo_synthetic.yaml``
  and ``configs/chronodepth_synthetic.yaml``: the config as it is on the CPU
  (bf16, random weights of the port's own, the real Spann3R branch) writes
  every column finite; then the CLI again with its model built from the
  config's ``model_params`` but given the JAX weights at f32, the JAX
  draws and the GT branch above, against the JAX package's
  ``run_evaluation`` with the same f32 model.  Every CSV column of every
  row: the error metrics (Abs Rel, normal mean / median, acc, comp) within
  2e-2 relative and the threshold shares within 3 pixels' share, the bounds
  of ``tests/test_torch_eval.py``'s DepthCrafter rows; ATE and RPE trans
  and RPE rot within 2e-2 relative plus 1e-4 (the same GT poses in both,
  so what differs is the metric code's round-off).
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import copy
import os

import numpy as np
import pytest
import torch
import yaml

import jax

from unigeo_tpu.config import EvalConfig as JaxEvalConfig
from unigeo_tpu.evaluator import run_evaluation as jax_run_evaluation
from unigeo_tpu_torch import eval as eval_cli
from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline
from unigeo_tpu_torch.utils.weights import pipeline_state_dicts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNIGEO_YAML = os.path.join(ROOT, "configs", "unigeo_synthetic.yaml")
CHRONO_YAML = os.path.join(ROOT, "configs", "chronodepth_synthetic.yaml")
H = W = 64
SEED = 42
MAX_CLIPS = 3


def rel_dev(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-12)


def rotation_deg(r1, r2):
    d = np.asarray(r1, np.float64) @ np.asarray(r2, np.float64).swapaxes(-1, -2)
    dist = np.linalg.norm(d - np.eye(3), axis=(-2, -1))
    return np.degrees(2.0 * np.arcsin(np.clip(dist / (2.0 * np.sqrt(2.0)), 0.0, 1.0)))


def t_(a):
    return torch.from_numpy(np.array(a))


def _load(path):
    with open(path) as f:
        return yaml.safe_load(f)


@pytest.fixture(scope="module")
def models(shared_tiny_pipeline):
    """The tiny f32 JAX pipeline (the configs' widths, its weights as they
    are now) and the port's twin with those weights."""
    jp = copy.copy(shared_tiny_pipeline)
    pp = tiny_pipeline(device="cpu", dtype=torch.float32)
    pp.load_state_dicts(*pipeline_state_dicts(jp.params, pp))
    return jp, pp


def _clip(t, seed):
    rng = np.random.default_rng(seed)
    k = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]], np.float32)
    return {"images": rng.integers(0, 256, (t, 3, H, W)).astype(np.uint8),
            "intrinsics": np.stack([k] * t)}


def _gt_branch(data):
    """The pointmap branch's outputs taken from the clip's GT (world points,
    depths, c2w poses), as the JAX package's fusion test does it."""
    from unigeo_tpu_torch.data.sample import prepare_gt_label

    gt = prepare_gt_label(data)
    return {"pred_world_pts": np.asarray(gt["gt_world_pts"], np.float32),
            "pred_depths": np.asarray(gt["gt_depths"], np.float32),
            "pred_poses": np.asarray(gt["gt_poses"], np.float32)}


class _JaxOracle:
    def forward(self, data):
        return _gt_branch(data)


class _PortOracle:
    def forward_tensors(self, data):
        return {k: torch.from_numpy(v) for k, v in _gt_branch(data).items()}


def _box_clip(t=3):
    from unigeo_tpu_torch.data.synthetic import SyntheticBoxDataset

    ds = SyntheticBoxDataset(clip_length=t, clip_overlap=0, num_scenes=1, frames_per_scene=t,
                             render_size=(H, W))
    return ds[0]


def test_unigeo_cam_with_branch_matches_jax(models):
    """The whole model with the branch, its pointmap network's outputs taken
    from the GT: a random network's pointmaps fit no camera, and their DLT
    is degenerate (176 degrees apart between the packages on world points
    equal to 8e-7).  The network and the camera recovery are held in
    ``tests/test_torch_pointmap.py``."""
    from unigeo_tpu.models.unigeo_cam import UniGeoCam as JUG
    from unigeo_tpu_torch.models.unigeo_cam import UniGeoCam

    jp, pp = models
    data = _box_clip()
    ref = JUG(num_inference_steps=2, pipeline=jp, seed=SEED, geometry_branch=True,
              pointmap_model=_JaxOracle()).forward(data)
    noise, aug = (t_(a) for a in jp.clip_noise(SEED, 3, H, W))
    ours = UniGeoCam(num_inference_steps=2, pipeline=pp, seed=SEED, geometry_branch=True,
                     pointmap_model=_PortOracle()).forward(data, noise=noise, aug_noise=aug)
    assert sorted(ours) == sorted(ref) == ["pred_depths", "pred_normals", "pred_poses",
                                           "pred_world_pts"]
    assert all(v.dtype == np.float32 and np.isfinite(v).all() for v in ours.values())
    assert rel_dev(ours["pred_depths"], ref["pred_depths"]) < 1e-2
    assert rel_dev(ours["pred_world_pts"], ref["pred_world_pts"]) < 1e-2
    assert np.array_equal(ours["pred_poses"], ref["pred_poses"])


class _JaxPointmap:
    def __init__(self, out):
        self.out = out

    def forward(self, data):
        return self.out


class _PortPointmap:
    def __init__(self, out):
        self.out = {k: torch.from_numpy(v) for k, v in out.items()}

    def forward_tensors(self, data):
        return self.out


@pytest.mark.parametrize("case", ["fit", "no_valid_pixel", "non_finite", "zero_scale"])
def test_geometry_branch_degenerate_fit_guard_matches_jax(case):
    from unigeo_tpu.models.unigeo_cam import UniGeoCam as JUG
    from unigeo_tpu_torch.models.unigeo_cam import UniGeoCam

    rng = np.random.default_rng(2)
    data = _clip(2, 3)
    depths = (1.0 / (rng.random((2, H, W)) + 0.1)).astype(np.float32)
    pm_depth = {
        "fit": 2.0 * depths + 0.5 + 0.01 * rng.standard_normal((2, H, W)),
        "no_valid_pixel": np.zeros((2, H, W)),
        "non_finite": np.where(rng.random((2, H, W)) < 0.5, np.inf, 1.0),
        "zero_scale": np.full((2, H, W), 3.0),  # constant: covariance 0, s = 0
    }[case].astype(np.float32)
    poses = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
    poses[1, :3, 3] = [0.1, -0.2, 0.3]
    out = {"pred_depths": pm_depth, "pred_poses": poses}
    jmodel, pmodel = JUG.__new__(JUG), UniGeoCam.__new__(UniGeoCam)
    jmodel.pointmap, pmodel.pointmap = _JaxPointmap(out), _PortPointmap(out)
    ref = jmodel._geometry_branch(data, depths)
    ours = {k: v.numpy() for k, v in pmodel._geometry_branch(data, t_(depths)).items()}
    for key in ("pred_depths", "pred_world_pts", "pred_poses"):
        assert rel_dev(ours[key], ref[key]) < 1e-5, key
    if case != "fit":  # s, t = 1, 0: the raw depth, clamped
        assert np.array_equal(ours["pred_depths"], np.maximum(depths, 1e-3))


# --- the CLI ---------------------------------------------------------------------


class _WithJaxDraws:
    """A port model given each clip's JAX draws (a torch generator cannot
    reproduce ``jax.random``)."""

    def __init__(self, model, draws):
        self.model, self.draws = model, draws

    def forward(self, data):
        t = len(data["images"])
        return self.model.forward(data, **self.draws(t))


def _unigeo_draws(jp, seed):
    def draws(t):
        noise, aug = jp.clip_noise(seed, t, H, W)
        return {"noise": t_(noise), "aug_noise": t_(aug)}
    return draws


def _chrono_draws(params):
    def draws(t):
        win = min(params["window_size"], t)
        ov = min(params["overlap"], win - 1) if win < t else 0
        n = len(range(0, max(t - ov, 1), win - ov))
        rng = jax.random.PRNGKey(params.get("seed", SEED))
        return {"window_noise": [
            t_(jax.random.normal(jax.random.fold_in(rng, wi), (win, H // 8, W // 8, 4)))
            for wi in range(n)]}
    return draws


def _cli(config, out, capsys):
    manager = eval_cli.main(["--config", config, "--output", str(out), "--device", "cpu",
                             "--max-clips", str(MAX_CLIPS)])
    assert "Averages:" in capsys.readouterr().out
    return manager.rows()


def _check_rows(rows, ref_rows, families):
    assert [r["seq_name"] for r in rows] == [r["seq_name"] for r in ref_rows]
    assert len(rows) == MAX_CLIPS
    pixels = 3.0 / (2 * H * W)
    for row, ref in zip(rows, ref_rows):
        assert row.keys() == ref.keys() and families <= set(row), (row.keys(), families)
        for key, val in ref.items():
            if key == "seq_name":
                continue
            if key.startswith("delta"):
                tol = pixels
            elif key in ("ATE", "RPE trans", "RPE rot"):
                tol = 2e-2 * abs(val) + 1e-4
            else:
                tol = 2e-2 * abs(val)
            assert abs(row[key] - val) <= tol, (row["seq_name"], key, row[key], val)


@pytest.mark.parametrize("config", [UNIGEO_YAML, CHRONO_YAML], ids=["unigeo", "chronodepth"])
def test_cli_runs_the_config_as_it_is(config, tmp_path, capsys, monkeypatch):
    built = []
    get = eval_cli.get_model_cls
    monkeypatch.setattr(eval_cli, "get_model_cls",
                        lambda name: lambda **kw: built.append(get(name)(**kw)) or built[-1])
    rows = _cli(config, tmp_path / "port", capsys)
    model = built[0]
    pipe = getattr(model, "pipeline", None) or model.pipe
    assert pipe.dtype == torch.bfloat16 and pipe.device.type == "cpu"
    if config == UNIGEO_YAML:  # the branch's Spann3R at the config's widths, in f32
        net = model.pointmap.network
        assert len(net.encoder.blocks.layers) == 2 and net.memory_step.decoder.proj_in.out_features == 48
        assert next(net.parameters()).dtype == torch.float32
    cfg = _load(config)
    names = [n for sec in ("eval_depth", "eval_normal", "eval_pcd", "eval_camera")
             for n in cfg.get(sec, {}).get("metric_names", [])]
    for row in rows:
        for name in names:
            assert np.isfinite(row[name]), (row["seq_name"], name, row[name])


def test_cli_unigeo_rows_match_jax(models, tmp_path, capsys, monkeypatch):
    from unigeo_tpu.models.unigeo_cam import UniGeoCam as JUG
    from unigeo_tpu_torch.models.unigeo_cam import UniGeoCam

    jp, pp = models
    cfg = _load(UNIGEO_YAML)
    params = cfg["model_params"]
    jmodel = JUG(**params, pipeline=jp, pointmap_model=_JaxOracle())
    ref = jax_run_evaluation(JaxEvalConfig.from_dict(cfg), save_dir=str(tmp_path / "jax"),
                             model=jmodel, max_clips=MAX_CLIPS, data_parallel=False,
                             verbose=False)

    def factory(**kw):
        assert kw["device"] == "cpu" and kw["geometry_branch"] is True
        model = UniGeoCam(**kw, pipeline=pp, pointmap_model=_PortOracle())
        return _WithJaxDraws(model, _unigeo_draws(jp, model.seed))

    monkeypatch.setattr(eval_cli, "get_model_cls", lambda name: factory)
    rows = _cli(UNIGEO_YAML, tmp_path / "port", capsys)
    _check_rows(rows, ref.rows(), {"Abs Rel", "normal mean", "acc", "ATE"})


def test_cli_chronodepth_rows_match_jax(models, tmp_path, capsys, monkeypatch):
    from unigeo_tpu.models.chronodepth import ChronoDepth as JCD
    from unigeo_tpu_torch.models.chronodepth import ChronoDepth

    jp, pp = models
    cfg = _load(CHRONO_YAML)
    params = cfg["model_params"]
    ref = jax_run_evaluation(JaxEvalConfig.from_dict(cfg), save_dir=str(tmp_path / "jax"),
                             model=JCD(**params, _pipeline=jp), max_clips=MAX_CLIPS,
                             data_parallel=False, verbose=False)

    def factory(**kw):
        return _WithJaxDraws(ChronoDepth(**kw, _pipeline=pp), _chrono_draws(params))

    monkeypatch.setattr(eval_cli, "get_model_cls", lambda name: factory)
    rows = _cli(CHRONO_YAML, tmp_path / "port", capsys)
    _check_rows(rows, ref.rows(), {"Abs Rel", "normal mean"})
