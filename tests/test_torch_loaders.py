"""The port's disk loaders against the JAX package's, on the CPU.

Each of the eleven disk datasets and Hypersim is built on the fixture of
``tests/fixtures_loaders.py`` (files in the dataset's own layout, written
once), then read by the JAX loader and by the port's loader of the same
name on the same root.  Every key of every sample must be equal exactly
(``np.array_equal``, as ``tests/test_torch_data.py`` holds the synthetic
dataset): the port runs the same numpy code, the same decoders (each
package's build of the same C++ reader, or PIL) and, for Hypersim's normal
orientation, a sign flip decided by the same threshold.  The port's samples
also match the committed golden fingerprints as the JAX loaders' do
(``tests/test_loader_goldens.py``).

One exception, measured: a dataset without normal maps gets normals from
the f32 5x5 plane fit of its camera points (``compute_normals_if_missing``),
and on depth quantised to 1 mm that fit is dominated by rounding in both
packages (on the 7-Scenes fixture each is about 12 degrees off an f64 fit on
average, and the two differ by more than 10 degrees at 14% of the pixels,
with a median difference of 0.3 degree).  XLA and torch round its sums in
different orders, so ``cam_normal`` and ``world_normal`` of those datasets
cannot be equal bit for bit.  For them the test holds the loader's wiring
exactly instead (the port's normals are the port's plane fit of the JAX
sample's camera points, rotated by the JAX sample's poses) and the two fits
to a median angle under 1 degree; every other key stays exact.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import json

import numpy as np
import pytest
import torch

import fixtures_loaders as fx
import test_loader_goldens as goldens

from unigeo_tpu.data.hypersim import HyperSimDataset as JaxHyperSim
from unigeo_tpu_torch.data import hypersim as port_hypersim
from unigeo_tpu_torch.data import loaders as port_loaders


def _port_twin(jds, cache_dir):
    """The port's dataset of the same class on the same root and settings."""
    name = type(jds).__name__
    if isinstance(jds, JaxHyperSim):
        scenes = sorted({s["scene"] for s in jds.samples})
        return port_hypersim.HyperSimDataset(root=jds.root, scene_list=scenes)
    kwargs = dict(root=jds.root, scene_list=jds._scene_list, split=jds.split,
                  clip_length=jds.clip_length, clip_overlap=jds.clip_overlap,
                  cache_dir=cache_dir)
    kwargs.update(jds.config_extras())
    return getattr(port_loaders, name)(**kwargs)


PLANE_FIT_KEYS = ("cam_normal", "world_normal")


def _plane_fit(ds) -> bool:
    """True for a dataset whose normals come from the plane fit of its points."""
    return not getattr(ds, "native_normals", True) and ds.compute_normals_if_missing


def _assert_plane_fit_normals(ours, ref):
    """The port's normals are its plane fit of the (equal) camera points,
    masked and rotated into the keyview as the base class does; the JAX
    fit agrees to a median angle under 1 degree on valid pixels."""
    from unigeo_tpu_torch import coords
    from unigeo_tpu_torch.ops.normals import surface_normals_from_points

    pts = np.ascontiguousarray(np.moveaxis(ref["cam_coord"], 1, -1))
    nrm = np.moveaxis(surface_normals_from_points(torch.from_numpy(pts)).numpy(), -1, 1)
    valid = ref["mask"][:, None] > 0
    want = np.where(valid, nrm, 0.0).astype(np.float32)
    assert np.array_equal(ours["cam_normal"], want)
    # world_normal: each frame's normals by its rotation into the keyview
    # (the poses are equal, so the rebase is the JAX sample's)
    extr = ref["extrinsics"]
    nf = len(extr)
    rot = np.stack([coords.relative_transform(extr[0], extr[i])[:3, :3] for i in range(nf)])
    world = (rot @ ours["cam_normal"].reshape(nf, 3, -1)).reshape(ours["cam_normal"].shape)
    np.testing.assert_allclose(ours["world_normal"], np.where(valid, world, 0.0), atol=1e-5)
    cos = (ours["cam_normal"] * ref["cam_normal"]).sum(1)[ref["mask"] > 0]
    assert np.median(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))) < 1.0


def _assert_samples_equal(ours, ref, plane_fit=False):
    assert sorted(ours) == sorted(ref)
    if plane_fit:
        _assert_plane_fit_normals(ours, ref)
    for key, val in ref.items():
        if plane_fit and key in PLANE_FIT_KEYS:
            continue
        if isinstance(val, np.ndarray):
            got = ours[key]
            assert isinstance(got, np.ndarray) and got.dtype == val.dtype, key
            assert np.array_equal(got, val, equal_nan=True), key
        else:
            assert ours[key] == val, key


def _build(name, tmp_path, **kwargs):
    jds = fx.BUILDERS[name](str(tmp_path / "root"), str(tmp_path / "cache_jax"), **kwargs)
    return jds, _port_twin(jds, str(tmp_path / "cache_port"))


@pytest.mark.parametrize("name", sorted(fx.BUILDERS))
def test_loader_matches_jax(name, tmp_path):
    jds, pds = _build(name, tmp_path)
    assert len(pds) == len(jds) > 0
    assert pds.samples == jds.samples
    for i in range(len(jds)):
        _assert_samples_equal(pds[i], jds[i], _plane_fit(pds))


@pytest.mark.parametrize("name", sorted(fx.BUILDERS))
def test_loader_matches_goldens(name, tmp_path):
    _, pds = _build(name, tmp_path)
    with open(goldens.GOLDENS_PATH) as f:
        want = json.load(f)[name]
    if _plane_fit(pds):  # rounding-dominated in both packages (see above)
        want = {k: v for k, v in want.items() if k not in PLANE_FIT_KEYS}
    goldens._assert_matches(goldens._fingerprint(pds[0]), want, name)


def test_neuralrgbd_nan_pose_filter(tmp_path):
    """A pose of 'nan's drops its frame in both packages: frame 3 poisoned
    leaves frame 0 of the gap-3 subsample, padded."""
    jds, pds = _build("NeuralRGBDDataset", tmp_path, nan_frame=3)
    ours = pds[0]
    _assert_samples_equal(ours, jds[0], plane_fit=True)
    assert len(pds._scene("kitchen").rgb_paths) == 1
    assert np.array_equal(ours["extrinsics"][1], ours["extrinsics"][0])


def test_scannetv2_resizes_rgb_to_depth_resolution(tmp_path):
    """RGB stored at 96 x 128 beside 480 x 640 depth: the port resizes it
    with PIL's bicubic to the depth maps' size, as the JAX loader does."""
    jds, pds = _build("ScannetV2Dataset", tmp_path, sensor_res=True)
    assert pds.rgb_match_depth_resolution
    ours = pds[0]
    assert ours["images"].shape[-2:] == (480, 640)
    _assert_samples_equal(ours, jds[0], plane_fit=True)


def test_registry_names_equal_the_jax_packages():
    """The port registers every dataset under the JAX package's name."""
    from unigeo_tpu.registry import DATASETS as JAX_DATASETS
    from unigeo_tpu_torch.registry import DATASETS, get_dataset_cls

    get_dataset_cls("SyntheticBoxDataset")
    assert set(DATASETS._entries) == set(JAX_DATASETS._entries)
    for name, cls in DATASETS._entries.items():
        assert cls.__name__ == JAX_DATASETS._entries[name].__name__, name


def test_root_from_paths_toml(tmp_path, monkeypatch):
    """root=None resolves through paths.toml, keyed by the dataset's name."""
    jds, _ = _build("SevenScenesDataset", tmp_path)
    toml = tmp_path / "paths.toml"
    toml.write_text(f'[7scenes]\nroot = "{jds.root}"\n')
    monkeypatch.setenv("UNIGEO_PATHS", str(toml))
    pds = port_loaders.SevenScenesDataset(root=None, scene_list=jds._scene_list,
                                          clip_length=jds.clip_length,
                                          cache_dir=str(tmp_path / "c3"))
    assert pds.root == jds.root
    _assert_samples_equal(pds[0], jds[0], plane_fit=True)
