"""The port's evaluator against the JAX package's, on the CPU.

* ``MetricsManager``: the same rows (NaN cells, an all-NaN column, a name
  that needs quoting) give a CSV byte-identical to the one pandas writes
  for the JAX package, before and after a resume reload.
* Every ``depth_alignment`` mode against JAX ``depth_evaluation`` on the
  same arrays (f32 on both sides).  Tolerances on the error metrics and the
  aligned depth: the closed forms (metric, lstsq, median) 1e-4 relative, the
  first-order bound n 2^-24 of f32 sums over the case's n ~ 2000 valid
  pixels; the iterative solvers (lad, lad2, scale) 1e-2 relative: their
  IRLS weights 1/(|r| + 1e-8) let a few near-zero residuals dominate the
  sums, so each package lands up to ~5e-3 away from the same solver run in
  f64 on this case (scale: 1.3983 and 1.3980 against 1.3911), and the two
  up to twice that apart.  The parity map |p - gt| / gt to the same
  relative tolerance of max(|p| / gt).  The threshold
  shares: within 3 pixels' share, 3 / valid pixels (a pixel within
  round-off of a threshold may land on either side).
* ``validate_sample`` accepts and rejects the same samples.
* ``IdentityModel`` on ``configs/identity_synthetic.yaml`` as it is (all
  four families; 96x128, clips of 8, 4000 points): the JAX package's
  ``run_evaluation`` against the port's CLI (``python -m
  unigeo_tpu_torch.eval --device cpu``).  The CSVs are byte-identical but
  for the columns that carry f32 round-off of a perfect prediction, and a
  resumed run skips every clip.
  - "normal mean": the normal error of a perfect prediction is cos = 1 -
    1e-6 to a few ulps, ~0.079 degree.  The two packages round the 3-term
    dot product and norms in different orders, so a pixel's cos may differ
    by up to ~4 ulps (4 * 2^-24), which arccos turns into 4 * 2^-24 /
    sin(theta) radians, ~0.01 degree at theta = 0.079 degree.  Held to this
    bound plus one unit of the printed fifth decimal (seen: 8.3e-4 degree at
    most on a clip).
  - "acc", "comp": a point's distance to itself is the f32 round-off of the
    expansion ||q||^2 + ||r||^2 - 2 q.r, at most 16 u (||q||^2 + ||r||^2)
    = 32 u ||q||^2 in either package (u = 2^-24), clamped at 0, through the
    square root: each package's value lies in [0, sqrt(32 u) max ||q||]
    (max over the run's valid world points), so they are held to that plus
    one printed unit (seen: 1e-5, one unit).
  The normal median and shares, nc1 and nc2 (1.00000), ATE and RPE (the
  same numpy f64 code) land on the same printed values.
* A tiny DepthCrafter (the ``tiny_*_config()`` sizes, f32, the JAX weights
  carried over, the JAX noise draws passed in) through both
  ``run_evaluation``s: the error metrics of every row within 2e-2 relative,
  the threshold shares within 3 pixels' share.  The depths differ by up to
  1e-2 relative (tests/test_torch_depthcrafter.py: the clip's min-max and
  1/(x + 0.1) amplify the pipeline's f32 differences); the lstsq-aligned
  errors and plane-fit angles move by about as much.
* With ``vis_pcd`` the evaluator writes each clip's downsampled clouds as
  PLY files, which the JAX package's reader reads; for the identity model
  pred equals gt within 1e-5 of its
  largest coordinate (the alignment's f32 rescale by gt_scale / pred_scale,
  a few ulps).
* What is not ported raises, naming its ROADMAP item; the CLI runs a YAML
  config on the CPU.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import json
import math
import os

import numpy as np
import pytest
import torch
import yaml

from unigeo_tpu.config import EvalConfig as JaxEvalConfig
from unigeo_tpu.evaluator import run_evaluation as jax_run_evaluation
from unigeo_tpu.metrics.depth import depth_evaluation as jax_depth_evaluation
from unigeo_tpu.metrics.manager import MetricsManager as JaxManager
from unigeo_tpu_torch.config import EvalConfig
from unigeo_tpu_torch.evaluator import run_evaluation
from unigeo_tpu_torch.metrics.depth import ALIGNMENT_MODES, depth_evaluation
from unigeo_tpu_torch.metrics.manager import MetricsManager
from unigeo_tpu_torch.utils.profiling import ClipTimer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# the CSV
# ---------------------------------------------------------------------------

NAMES = ["Abs Rel", "delta < 1.25", "normal mean", "never, set"]
ROWS = [
    {"seq_name": "000_scene00", "Abs Rel": 0.123456789, "delta < 1.25": 1.0,
     "normal mean": 12.5, "ignored": 3.0},
    {"seq_name": "001_scene00", "Abs Rel": -1e-7, "normal mean": 1234567.891},
    {"seq_name": "002_a,b", "Abs Rel": float("nan"), "delta < 1.25": 0.333333333,
     "normal mean": 2.0 / 3.0},
    {"seq_name": "000_scene00", "delta < 1.25": 0.5},  # an update of a row
]


def test_manager_csv_is_byte_identical_to_pandas(tmp_path):
    ours, ref = MetricsManager(NAMES), JaxManager(NAMES)
    for row in ROWS:
        ours.update_metrics(dict(row))
        ref.update_metrics(dict(row))
    ours.export_to_csv(str(tmp_path / "port" / "metrics.csv"))
    ref.export_to_csv(str(tmp_path / "jax" / "metrics.csv"))
    data = _read(tmp_path / "port" / "metrics.csv")
    assert data == _read(tmp_path / "jax" / "metrics.csv")
    assert b'"002_a,b",,0.33333' in data and b"-0.00000,," in data
    avg_ours, avg_ref = ours.calculate_averages(), ref.calculate_averages()
    assert math.isnan(avg_ours["never, set"]) and math.isnan(avg_ref["never, set"])
    assert {k: v for k, v in avg_ours.items() if k != "never, set"} == \
        {k: float(v) for k, v in avg_ref.items() if k != "never, set"}
    assert ours.rows() == ref.rows()

    # resume: each package reloads its own CSV; exported again, still equal
    back = MetricsManager.from_csv(str(tmp_path / "port" / "metrics.csv"), NAMES)
    back_ref = JaxManager.from_csv(str(tmp_path / "jax" / "metrics.csv"), NAMES)
    assert back.sequence_names == [r["seq_name"] for r in ROWS[:3]]
    assert all(back.has_sequence(s) for s in back.sequence_names)
    assert not back.has_sequence("Average")
    back.update_metrics({"seq_name": "003_new", "Abs Rel": 0.25})
    back_ref.update_metrics({"seq_name": "003_new", "Abs Rel": 0.25})
    back.export_to_csv(str(tmp_path / "port2.csv"))
    back_ref.export_to_csv(str(tmp_path / "jax2.csv"))
    assert _read(tmp_path / "port2.csv") == _read(tmp_path / "jax2.csv")
    # an empty manager writes nothing
    MetricsManager(NAMES).export_to_csv(str(tmp_path / "empty.csv"))
    assert not os.path.exists(tmp_path / "empty.csv")


# ---------------------------------------------------------------------------
# depth alignment modes
# ---------------------------------------------------------------------------


def _depth_case(seed):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.5, 6.0, (3, 24, 32)).astype(np.float32)
    gt[:, :2] = 0.0  # invalid rows
    gt[0, 5, :4] = 90.0  # beyond max_depth
    pred = (0.6 * gt + 0.4 + rng.normal(0, 0.15, gt.shape)).astype(np.float32)
    pred[1, 10:12] += 3.0  # outliers for the robust modes
    mask = rng.random(gt.shape) > 0.1
    return pred, gt, mask


@pytest.mark.parametrize("mode", ALIGNMENT_MODES)
@pytest.mark.parametrize("disp", [False, True], ids=["depth", "disparity"])
def test_depth_alignment_modes_match_jax(mode, disp):
    pred, gt, mask = _depth_case(7)
    kwargs = dict(custom_mask=mask, alignment=mode, max_depth=80.0)
    if disp:
        # disparity input, with the pre and post clips the reference offers
        pred = (1.0 / np.maximum(pred, 0.1)).astype(np.float32)
        kwargs.update(disp_input=True, pre_clip_min=1e-3, post_clip_min=0.1, post_clip_max=50.0)
    ref, ref_parity, ref_aligned, ref_gt = jax_depth_evaluation(pred, gt, **kwargs)
    ours, parity, aligned, gt_masked = depth_evaluation(pred, gt, **kwargs)
    assert ours.keys() == ref.keys()
    assert ours["valid_pixels"] == ref["valid_pixels"]
    rel = 1e-2 if mode in ("lad", "lad2", "scale") else 1e-4
    pixels = 3.0 / ref["valid_pixels"]
    for key, val in ref.items():
        tol = pixels if key.startswith("delta") else rel * abs(val) + 1e-6
        assert abs(ours[key] - val) <= tol, (mode, key, ours[key], val)
    np.testing.assert_array_equal(gt_masked.numpy(), np.asarray(ref_gt))
    ref_aligned = np.asarray(ref_aligned)
    assert np.abs(aligned.numpy() - ref_aligned).max() <= rel * np.abs(ref_aligned).max()
    parity_scale = (np.abs(ref_aligned) / np.where(gt == 0, 1.0, gt)).max()
    assert np.abs(parity.numpy() - np.asarray(ref_parity)).max() <= rel * parity_scale


# ---------------------------------------------------------------------------
# the sample contract
# ---------------------------------------------------------------------------


def test_validate_sample_accepts_and_rejects_as_jax(tmp_path):
    from unigeo_tpu.data.sample import validate_sample as jax_validate
    from unigeo_tpu_torch.data.sample import validate_sample
    from unigeo_tpu_torch.data.synthetic import SyntheticBoxDataset

    good = SyntheticBoxDataset(cache_dir=str(tmp_path), clip_length=3, num_scenes=1,
                               frames_per_scene=3, render_size=(24, 32))[0]
    validate_sample(good)
    jax_validate(good)
    missing = {k: v for k, v in good.items() if k != "world_normal"}
    bad_mask = dict(good, mask=good["mask"][:, :-1])
    bad_k = dict(good, intrinsics=good["intrinsics"][:, :2])
    for bad, err in ((missing, KeyError), (bad_mask, ValueError), (bad_k, ValueError)):
        with pytest.raises(err):
            validate_sample(bad)
        with pytest.raises(err):
            jax_validate(bad)


# ---------------------------------------------------------------------------
# the evaluator
# ---------------------------------------------------------------------------


IDENTITY_YAML = os.path.join(ROOT, "configs", "identity_synthetic.yaml")
# the identity CSV's columns that carry f32 round-off (module docstring)
ROUND_OFF_COLUMNS = ("normal mean", "acc", "comp")


def _identity_config():
    with open(IDENTITY_YAML) as f:
        return yaml.safe_load(f)


def _max_world_norm(cfg):
    """The largest norm of a valid GT world point over the config's clips."""
    from unigeo_tpu_torch.data.sample import prepare_gt_label
    from unigeo_tpu_torch.registry import get_dataset_cls

    ecfg = EvalConfig.from_dict(cfg)
    dataset = get_dataset_cls(ecfg.dataset)(**ecfg.dataset_kwargs)
    norms = []
    for i in range(len(dataset)):
        gt = prepare_gt_label(dataset[i])
        norms.append(np.linalg.norm(gt["gt_world_pts"][gt["gt_masks"]], axis=-1).max())
    return float(max(norms))


def test_identity_eval_csv_matches_jax_and_resumes(tmp_path, capsys):
    from unigeo_tpu_torch import eval as eval_cli

    cfg = _identity_config()
    assert all(k in cfg for k in ("eval_depth", "eval_normal", "eval_pcd", "eval_camera"))
    jax_run_evaluation(JaxEvalConfig.from_dict(cfg), save_dir=str(tmp_path / "jax"))
    cli = ["--config", IDENTITY_YAML, "--output", str(tmp_path / "port"), "--device", "cpu"]
    manager = eval_cli.main(cli)
    csv_bytes = _read(tmp_path / "port" / "metrics.csv")
    ours, ref = (_split_columns(_read(tmp_path / d / "metrics.csv"), ROUND_OFF_COLUMNS)
                 for d in ("port", "jax"))
    assert ours[0] == ref[0]  # every byte of the other columns
    dist_tol = math.sqrt(32 * 2.0**-24) * _max_world_norm(cfg) + 1e-5
    for name in ROUND_OFF_COLUMNS:
        for cell, ref_cell in zip(ours[1][name], ref[1][name]):
            if name == "normal mean":
                # 4 ulps of cos near 1 through arccos, plus one printed unit
                theta = math.radians(float(ref_cell))
                tol = math.degrees(4 * 2.0**-24 / math.sin(theta)) + 1e-5
            else:
                tol = dist_tol
            assert abs(float(cell) - float(ref_cell)) <= tol, (name, cell, ref_cell, tol)
    n = len(manager.sequence_names)
    assert n >= 2
    averages = manager.calculate_averages()
    assert averages["Abs Rel"] < 1e-5 and averages["delta < 1.25"] == 1.0
    assert averages["normal mean"] < 0.1
    assert averages["acc"] < dist_tol and averages["comp"] < dist_tol
    assert averages["nc1"] > 1 - 1e-5 and averages["nc2"] > 1 - 1e-5
    assert averages["ATE"] < 1e-6 and averages["RPE trans"] < 1e-6

    # resumed through the CLI and through run_evaluation: every clip
    # skipped, nothing run, the CSV as it was
    capsys.readouterr()
    eval_cli.main(cli)
    assert "processing seq" not in capsys.readouterr().out
    again = ClipTimer()
    run_evaluation(EvalConfig.from_dict(cfg), save_dir=str(tmp_path / "port"), timer=again,
                   device="cpu")
    assert again.count == 0 and "processing seq" not in capsys.readouterr().out
    assert _read(tmp_path / "port" / "metrics.csv") == csv_bytes
    # max_clips, strict and the synchronous path give the same first rows;
    # the timer journals each forward
    timer = ClipTimer(jsonl_path=str(tmp_path / "clips.jsonl"))
    sync = run_evaluation(EvalConfig.from_dict(cfg), save_dir=str(tmp_path / "sync"),
                          max_clips=2, strict=True, async_metrics=False, verbose=False,
                          timer=timer, device="cpu")
    assert sync.rows() == manager.rows()[:2]
    assert timer.count == 2
    with open(tmp_path / "clips.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [r["clip"] for r in lines] == [1, 2]
    assert all(r["frames"] == 8 and r["fps"] > 0 for r in lines)


def test_point_clouds_are_written_under_vis_pcd(tmp_path):
    from unigeo_tpu.utils.vis import load_point_cloud  # the JAX package's reader

    cfg = dict(_identity_config(), vis_pcd=True, clip_overlap=0,
               dataset_params={"num_scenes": 1, "frames_per_scene": 8})
    cfg["eval_pcd"] = dict(cfg["eval_pcd"], pcd_downsample_num=500)
    run_evaluation(EvalConfig.from_dict(cfg), save_dir=str(tmp_path), verbose=False,
                   device="cpu")
    (seq_dir,) = [d for d in os.listdir(tmp_path) if d.startswith("pcd_")]
    pred, pred_rgb = load_point_cloud(str(tmp_path / seq_dir / "pred.ply"))
    gt, gt_rgb = load_point_cloud(str(tmp_path / seq_dir / "gt.ply"))
    assert pred.shape == gt.shape == (500, 3) and pred_rgb.dtype == np.uint8
    np.testing.assert_array_equal(pred_rgb, gt_rgb)
    assert np.abs(pred - gt).max() <= 1e-5 * np.abs(gt).max()


def _split_columns(csv_bytes, names):
    """(the CSV without the columns ``names``, {name: that column's cells})."""
    import csv
    import io

    rows = list(csv.reader(io.StringIO(csv_bytes.decode())))
    idx = [rows[0].index(name) for name in names]
    out = io.StringIO()
    csv.writer(out, lineterminator="\n").writerows(
        [[c for j, c in enumerate(r) if j not in idx] for r in rows])
    return out.getvalue(), {name: [r[i] for r in rows[1:]] for name, i in zip(names, idx)}


class _WithJaxDraws:
    """The port's DepthCrafter given the JAX adapter's own noise draws for
    each clip (a torch generator cannot reproduce ``jax.random``)."""

    def __init__(self, model, jax_pipeline):
        self.model, self.jax_pipeline = model, jax_pipeline

    def forward(self, data):
        t, _, h, w = np.asarray(data["images"]).shape
        noise, aug = self.jax_pipeline.clip_noise(self.model.seed, t, h, w)
        return self.model.forward(data, noise=torch.from_numpy(np.array(noise)),
                                  aug_noise=torch.from_numpy(np.array(aug)))


def _tiny_depthcrafter_config():
    return {
        "dataset": "SyntheticBoxDataset", "root": None, "h": 64, "w": 64,
        "clip_length": 2, "clip_overlap": 0, "split": "test",
        "dataset_params": {"render_size": [64, 64], "num_scenes": 1, "frames_per_scene": 4},
        "model_name": "DepthCrafter",
        "model_params": {"checkpoint_path": None, "num_inference_steps": 5, "overlap": 25},
        "eval_depth": {"metric_names": ["Abs Rel", "delta < 1.25", "delta < 1.25^2",
                                        "delta < 1.25^3"], "depth_alignment": "lstsq"},
        "eval_normal": {"metric_names": ["normal mean", "normal median", "angle < 7.5",
                                         "angle < 11.25"]},
    }


def test_tiny_depthcrafter_eval_rows_match_jax(shared_tiny_pipeline, tmp_path):
    from unigeo_tpu.models.depthcrafter.model import DepthCrafter as JaxDepthCrafter
    from unigeo_tpu_torch.models.depthcrafter.model import DepthCrafter
    from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline
    from unigeo_tpu_torch.utils.weights import pipeline_state_dicts

    jp = shared_tiny_pipeline
    pp = tiny_pipeline(device="cpu", dtype=torch.float32)
    pp.load_state_dicts(*pipeline_state_dicts(jp.params, pp))
    cfg = _tiny_depthcrafter_config()
    ref = jax_run_evaluation(JaxEvalConfig.from_dict(cfg), save_dir=str(tmp_path / "jax"),
                             model=JaxDepthCrafter(pipeline=jp, **cfg["model_params"]),
                             data_parallel=False, verbose=False)
    model = DepthCrafter(pipeline=pp, **cfg["model_params"])
    ours = run_evaluation(EvalConfig.from_dict(cfg), save_dir=str(tmp_path / "port"),
                          model=_WithJaxDraws(model, jp), verbose=False)
    ref_rows, rows = ref.rows(), ours.rows()
    assert [r["seq_name"] for r in rows] == [r["seq_name"] for r in ref_rows]
    assert len(rows) == 2
    pixels = 3.0 / (2 * 64 * 64)  # the clip's pixels, all valid
    for row, ref_row in zip(rows, ref_rows):
        assert row.keys() == ref_row.keys()
        for key, val in ref_row.items():
            if key == "seq_name":
                continue
            if key.startswith("delta"):
                tol = pixels
            elif key.startswith("angle"):
                tol = 100.0 * pixels
            else:
                tol = 2e-2 * abs(val)
            assert abs(row[key] - val) <= tol, (key, row[key], val)


# ---------------------------------------------------------------------------
# what raises
# ---------------------------------------------------------------------------


def test_unported_sections_and_options_raise(tmp_path):
    cfg = EvalConfig.from_dict(_identity_config())
    # prefetch runs: two clips decoded on two threads, scored in order
    manager = run_evaluation(cfg, save_dir=str(tmp_path / "prefetch"), num_workers=2,
                             max_clips=2, verbose=False, device="cpu")
    assert manager.sequence_names == ["000_scene00", "001_scene00"]
    with pytest.raises(NotImplementedError, match="item 12"):
        run_evaluation(cfg, save_dir=str(tmp_path), debug_nans=True)

    class NoBatch:
        def forward(self, data):
            raise AssertionError("not reached")

    with pytest.raises(ValueError, match="no forward_batch"):
        run_evaluation(cfg, save_dir=str(tmp_path), model=NoBatch(), data_parallel=True)


def test_depthcrafter_constructor_takes_the_config_keys_and_raises_on_unported():
    from unigeo_tpu_torch.models.depthcrafter.model import DepthCrafter
    from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline
    from unigeo_tpu_torch.models.depthcrafter.unet import tiny_unet_config
    from unigeo_tpu_torch.models.depthcrafter.vae import tiny_vae_config
    from unigeo_tpu_torch.models.vit import tiny_clip_config
    from unigeo_tpu_torch.registry import get_model_cls

    assert get_model_cls("DepthCrafter") is DepthCrafter
    with pytest.raises(NotImplementedError, match="item 9"):
        DepthCrafter(checkpoint_path="weights.npz")
    # without a pipeline: built at the given configs, random weights from
    # the seed (the same seed, the same weights); reference keys ignored
    unet = tiny_unet_config()
    kwargs = dict(unet_config=unet, vae_config=tiny_vae_config(),
                  clip_config=dict(tiny_clip_config(), projection_dim=unet["cross_attention_dim"]),
                  device="cpu", seed=3, checkpoint_path=None, overlap=25,
                  model_dir="/nowhere", unet_path="/nowhere", pre_train_path="/nowhere",
                  scheduler_config={"sigma_max": 700.0, "unknown": 1}, init_height=64)
    # Heun builds its pipeline with that solver; an unknown solver raises
    assert DepthCrafter(solver="heun", **kwargs).pipeline.solver == "heun"
    with pytest.raises(ValueError, match="unknown solver 'rk4'"):
        DepthCrafter(solver="rk4", **kwargs)
    a, b = DepthCrafter(**kwargs), DepthCrafter(**kwargs)
    assert a.pipeline.dtype == torch.bfloat16 and a.pipeline.device.type == "cpu"
    for pa, pb in zip(a.pipeline.unet.parameters(), b.pipeline.unet.parameters()):
        assert torch.equal(pa, pb)
    assert any(p.abs().max() > 0 for p in a.pipeline.unet.parameters())
    # clips_per_step is the evaluator's batch
    assert DepthCrafter(clips_per_step=2, **kwargs).eval_batch_size == 2
    assert a.eval_batch_size == 1
    # a window shorter than the clip runs the crossfaded windows
    pipe = tiny_pipeline(device="cpu").init_random(torch.Generator().manual_seed(0))
    model = DepthCrafter(pipeline=pipe, window_size=2, overlap=1, num_inference_steps=1)
    k = np.array([[50.0, 0, 32], [0, 50.0, 32], [0, 0, 1]], np.float32)
    out = model.forward({"images": np.zeros((4, 3, 64, 64), np.uint8),
                         "intrinsics": np.stack([k] * 4)})
    assert out["pred_depths"].shape == (4, 64, 64) and np.isfinite(out["pred_depths"]).all()


def test_cli_runs_a_yaml_config_on_the_cpu(tmp_path, capsys):
    from unigeo_tpu_torch import eval as eval_cli

    cfg = _identity_config()
    cfg.update(clip_overlap=0, dataset_params={"num_scenes": 1, "frames_per_scene": 8})
    path = tmp_path / "identity.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = tmp_path / "out"
    manager = eval_cli.main(["--config", str(path), "--output", str(out), "--device", "cpu",
                             "--strict"])
    assert len(manager.sequence_names) == 1 and (out / "metrics.csv").exists()
    assert "Averages:" in capsys.readouterr().out
    # the preflight of the config's dataset: its report, exit code 0
    with pytest.raises(SystemExit) as done:
        eval_cli.main(["--config", str(path), "--validate-root"])
    assert done.value.code == 0
    assert "preflight: synthetic_box.test — OK" in capsys.readouterr().out
