"""``debug_nans`` in the port's evaluator and eval CLI, the counterpart of the
JAX package's ``jax_debug_nans`` (which this file leaves untouched: the JAX
flag, once set, stays on in the process).

* A tiny f32 DepthCrafter with one NaN planted in a weight raises
  ``FloatingPointError`` naming the module class whose output first held a
  NaN, through ``run_evaluation`` and through the CLI's ``--debug-nans``.
* A model whose ``pred_*`` output holds a NaN raises, naming the model and
  the key.
* A clean run writes the same CSV with and without the flag.
* The forward hook is gone after every run, one that raised included.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import os

import numpy as np
import pytest
import torch

from unigeo_tpu_torch.config import EvalConfig
from unigeo_tpu_torch.evaluator import nan_hooks, run_evaluation
from unigeo_tpu_torch.models.identity import IdentityModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(**extra):
    return {
        "dataset": "SyntheticBoxDataset", "root": None, "h": 64, "w": 64,
        "clip_length": 2, "clip_overlap": 0, "split": "test",
        "dataset_params": {"render_size": [64, 64], "num_scenes": 1, "frames_per_scene": 4},
        "model_name": "IdentityModel", "model_params": {},
        "eval_depth": {"metric_names": ["Abs Rel", "delta < 1.25"],
                       "depth_alignment": "lstsq"},
        "eval_normal": {"metric_names": ["normal mean"]},
        "eval_camera": {"metric_names": ["ATE"]}, **extra,
    }


def _global_hooks():
    return dict(torch.nn.modules.module._global_forward_hooks)


@pytest.fixture(scope="module")
def nan_depthcrafter():
    """A tiny f32 DepthCrafter whose VAE encoder's first convolution holds
    one NaN weight."""
    from unigeo_tpu_torch.models.depthcrafter.model import DepthCrafter
    from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline

    pipe = tiny_pipeline(device="cpu").init_random(torch.Generator().manual_seed(5))
    model = DepthCrafter(pipeline=pipe, num_inference_steps=2)
    conv = pipe.vae.encoder.conv_in
    with torch.no_grad():
        conv.weight[0, 0, 0, 0] = float("nan")
    return model, type(conv).__name__


def test_planted_nan_weight_raises_naming_the_module(nan_depthcrafter, tmp_path):
    model, cls = nan_depthcrafter
    before = _global_hooks()
    cfg = EvalConfig.from_dict(_config(model_name="DepthCrafter"))
    with pytest.raises(FloatingPointError, match=f"NaN in the output of {cls}$"):
        run_evaluation(cfg, save_dir=str(tmp_path), model=model, verbose=False,
                       debug_nans=True, device="cpu")
    assert _global_hooks() == before
    # without the flag the NaN runs on to the predictions
    out = model.forward(run_dataset(cfg)[0])
    assert np.isnan(out["pred_depths"]).any()


def run_dataset(cfg):
    from unigeo_tpu_torch.registry import get_dataset_cls

    return get_dataset_cls(cfg.dataset)(**cfg.dataset_kwargs)


def test_nan_in_a_prediction_raises_naming_the_key(tmp_path):
    class NanDepths(IdentityModel):
        def forward(self, data):
            out = super().forward(data)
            out["pred_depths"][0, 0, 0] = np.nan
            return out

    cfg = EvalConfig.from_dict(_config())
    with pytest.raises(FloatingPointError, match="NanDepths's pred_depths"):
        run_evaluation(cfg, save_dir=str(tmp_path), model=NanDepths(), verbose=False,
                       debug_nans=True, device="cpu")
    # batched clips are checked too
    with pytest.raises(FloatingPointError, match="pred_depths"):
        run_evaluation(cfg, save_dir=str(tmp_path / "b"), model=NanDepths(), verbose=False,
                       debug_nans=True, data_parallel=True, device="cpu")


@pytest.mark.parametrize("value,raises", [(float("nan"), True), (float("inf"), False),
                                          (1.0, False)])
def test_hook_checks_nan_only(value, raises):
    """NaN raises, Inf does not (as jax_debug_nans); the hook goes at the
    block's end."""
    before = _global_hooks()
    lin = torch.nn.Linear(2, 2)
    x = torch.tensor([[value, 0.0]])
    with nan_hooks():
        assert len(_global_hooks()) == len(before) + 1
        if raises:
            with pytest.raises(FloatingPointError, match="Linear"):
                lin(x)
        else:
            lin(x)
    assert _global_hooks() == before


def test_clean_run_writes_the_same_csv_with_and_without_the_flag(tmp_path):
    cfg = EvalConfig.from_dict(_config())
    before = _global_hooks()
    for name, flag in (("plain", False), ("nans", True)):
        run_evaluation(cfg, save_dir=str(tmp_path / name), verbose=False, debug_nans=flag,
                       device="cpu")
    assert _global_hooks() == before
    with open(tmp_path / "plain" / "metrics.csv") as a, open(tmp_path / "nans" / "metrics.csv") as b:
        assert a.read() == b.read()


def test_cli_debug_nans_flag(nan_depthcrafter, tmp_path, monkeypatch):
    """``--debug-nans`` reaches the evaluator: the planted weight raises."""
    import json

    from unigeo_tpu_torch import eval as eval_cli

    model, cls = nan_depthcrafter
    cfg = _config(model_name="DepthCrafter")
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    monkeypatch.setattr(eval_cli, "get_model_cls", lambda name: lambda **kw: model)
    with pytest.raises(FloatingPointError, match=cls):
        eval_cli.main(["--config", str(path), "--output", str(tmp_path / "out"),
                       "--device", "cpu", "--debug-nans"])
