"""The port's data side against the JAX package: the synthetic box dataset
(clip slicing, backprojection, keyview rebase, masks, resizes), the clip
slicer, the experiment config and the dataset registry.  All numpy on both
sides, so equality is exact (``np.array_equal``)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from unigeo_tpu.config import EvalConfig as JaxEvalConfig
from unigeo_tpu.data.base import slice_clips as jax_slice_clips
from unigeo_tpu.data.synthetic import SyntheticBoxDataset as JaxSynthetic
from unigeo_tpu_torch.config import EvalConfig
from unigeo_tpu_torch.data.base import slice_clips
from unigeo_tpu_torch.data.synthetic import SyntheticBoxDataset
from unigeo_tpu_torch.registry import get_dataset_cls

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARRAYS = ("images", "intrinsics", "extrinsics", "cam_coord", "cam_normal", "world_coord",
          "world_normal", "mask")


@pytest.mark.parametrize(
    "kwargs",
    [
        # no resize (render size = target size), as the training smoke runs it
        dict(clip_length=4, clip_overlap=1, num_scenes=2, frames_per_scene=6,
             render_size=(48, 64), input_size=(48, 64), target_size=(48, 64)),
        # bilinear image and nearest target resizes, intrinsics rescaled
        dict(clip_length=3, num_scenes=1, frames_per_scene=5, render_size=(96, 128),
             input_size=(40, 56), target_size=(40, 56)),
    ],
)
def test_synthetic_samples_equal_jax(kwargs, tmp_path):
    ours = SyntheticBoxDataset(cache_dir=str(tmp_path / "port"), **kwargs)
    ref = JaxSynthetic(cache_dir=str(tmp_path / "jax"), **kwargs)
    assert len(ours) == len(ref) and ours.samples == ref.samples
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert a["scene_name"] == b["scene_name"] and a["image_names"] == b["image_names"]
        for key in ARRAYS:
            assert a[key].dtype == b[key].dtype, key
            assert np.array_equal(a[key], b[key]), (i, key)


@pytest.mark.parametrize("n,length,overlap", [(10, 4, 0), (10, 4, 2), (25, 25, 0), (3, 8, 5)])
def test_slice_clips_equal_jax(n, length, overlap):
    assert slice_clips(n, length, overlap) == jax_slice_clips(n, length, overlap)


@pytest.mark.parametrize("name", ["unigeo_synthetic.yaml", "identity_synthetic.yaml"])
def test_eval_config_from_yaml_equals_jax(name):
    path = os.path.join(ROOT, "configs", name)
    ours, ref = EvalConfig.from_yaml(path), JaxEvalConfig.from_yaml(path)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    # and from the dict, as the training smoke builds it
    assert EvalConfig.from_dict(ref.raw) == ours


def test_registry_resolves_the_port_datasets():
    assert get_dataset_cls("SyntheticBoxDataset") is SyntheticBoxDataset
    with pytest.raises(KeyError, match="SyntheticBoxDataset"):
        get_dataset_cls("ScannetPPDataset")


@pytest.mark.parametrize("compute", [True, False])
def test_normals_of_a_dataset_without_normal_maps_equal_jax(compute, tmp_path):
    """No normal maps: both packages plane-fit the camera points (5x5, f32),
    or both write zeros when ``compute_normals_if_missing`` is off.

    The f32 fit subtracts moments of order |p|^2 to get a centred scatter
    about 1e-3 of them, so the two packages' box sums, taken in another
    order, move the normals by up to ~5e-4 in the interior (each package is
    within 5e-4 of the same fit in f64 there): 1e-3 absolute.  In the
    2-pixel border the window reaches the zero padding (points at the
    origin) and the fit is ill-conditioned (each package within 0.14 of the
    f64 fit): held by the mean angle over every pixel, under 0.1 degree."""
    from unigeo_tpu_torch.ops.normals import surface_normals_from_points

    kwargs = dict(clip_length=3, num_scenes=1, frames_per_scene=3, render_size=(48, 64),
                  input_size=(48, 64), target_size=(48, 64),
                  compute_normals_if_missing=compute)
    ours = SyntheticBoxDataset(cache_dir=str(tmp_path / "port"), **kwargs)
    ref = JaxSynthetic(cache_dir=str(tmp_path / "jax"), **kwargs)
    ours.native_normals = ref.native_normals = False
    a, b = ours[0], ref[0]
    for key in ARRAYS:
        if key not in ("cam_normal", "world_normal"):
            assert np.array_equal(a[key], b[key]), key
    if not compute:
        assert not a["cam_normal"].any() and not b["cam_normal"].any()
        return
    pts = torch.from_numpy(np.ascontiguousarray(np.moveaxis(a["cam_coord"], 1, -1)))
    fit = np.moveaxis(surface_normals_from_points(pts).numpy(), -1, 1)
    valid = a["mask"][:, None] > 0
    assert np.array_equal(a["cam_normal"], np.where(valid, fit, 0.0).astype(np.float32))
    for key in ("cam_normal", "world_normal"):
        assert a[key].dtype == b[key].dtype == np.float32
        diff = np.abs(a[key] - b[key])
        assert diff[..., 2:-2, 2:-2].max() < 1e-3, (key, diff[..., 2:-2, 2:-2].max())
        cos = np.clip((a[key] * b[key]).sum(1), -1.0, 1.0)
        assert np.degrees(np.arccos(cos))[valid[:, 0]].mean() < 0.1, key
