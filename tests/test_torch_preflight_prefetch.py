"""The port's dataset preflight, ``paths.toml`` lookup, EXR codec and clip
prefetch against the JAX package's, on the CPU.

* ``format_report(validate_root(ds))`` is the JAX package's text, character
  for character, for every disk loader on its fixture
  (``tests/fixtures_loaders.py``), and on a 7-Scenes fixture with a depth
  file deleted; the eval CLI's ``--validate-root`` prints it and exits 0 or 1.
* ``resolve_root`` gives the JAX package's answer for every form of entry.
* The EXR codec round-trips every pixel type and compression, and each
  package reads the other's files equal.
* ``PrefetchLoader`` yields the serial order and content, copies to a
  device when asked, and raises a worker's exception in the caller.
* An identity eval with ``num_workers=2`` writes the CSV that
  ``num_workers=0`` writes, byte for byte.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import os

import numpy as np
import pytest

import fixtures_loaders as fx
from test_torch_loaders import _port_twin

from unigeo_tpu.data import exr as jax_exr
from unigeo_tpu.data import paths as jax_paths
from unigeo_tpu.data import preflight as jax_preflight
from unigeo_tpu_torch.data import exr, paths, preflight

DISK_LOADERS = sorted(n for n in fx.BUILDERS if n != "HyperSimDataset")


def _reports(jds, pds):
    ours = preflight.format_report(preflight.validate_root(pds))
    ref = jax_preflight.format_report(jax_preflight.validate_root(jds))
    return ours, ref


@pytest.mark.parametrize("name", DISK_LOADERS)
def test_report_equals_jax(name, tmp_path):
    jds = fx.BUILDERS[name](str(tmp_path / "root"), str(tmp_path / "cache_jax"))
    ours, ref = _reports(jds, _port_twin(jds, str(tmp_path / "cache_port")))
    assert ours == ref
    assert ours.startswith(f"preflight: {jds.name} — ")


def test_report_on_a_missing_depth_file_equals_jax(tmp_path):
    jds = fx.build_seven_scenes(str(tmp_path / "root"), str(tmp_path / "cache_jax"))
    pds = _port_twin(jds, str(tmp_path / "cache_port"))
    os.remove(os.path.join(jds.root, "chess", "seq-01", "frame-000003.depth.proj.png"))
    ours, ref = _reports(jds, pds)
    assert ours == ref
    assert "FAILED" in ours and "✗ scene_index [chess/seq-01]: load_scene_index raised" in ours


def test_cli_validate_root(tmp_path, capsys):
    import yaml

    from unigeo_tpu_torch import eval as eval_cli

    root = str(tmp_path / "root")
    fx.build_seven_scenes(root, str(tmp_path / "cache_jax"))
    cfg = {"dataset": "sevenScenesDataset", "root": root, "h": 48, "w": 64, "clip_length": 4,
           "split": "test", "dataset_params": {"scene_list": ["chess/seq-01"],
                                               "cache_dir": str(tmp_path / "c")},
           "model_name": "IdentityModel",
           "eval_depth": {"metric_names": ["Abs Rel"]}}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(SystemExit) as done:
        eval_cli.main(["--config", str(path), "--validate-root"])
    out = capsys.readouterr().out
    assert done.value.code == 0, out
    assert out.splitlines()[0] in ("clip reader: native", "clip reader: pil")
    assert "preflight: 7scenes.test — OK" in out and "✓ sample_contract" in out
    os.remove(os.path.join(root, "chess", "seq-01", "frame-000000.color.png"))
    with pytest.raises(SystemExit) as done:
        eval_cli.main(["--config", str(path), "--validate-root"])
    assert done.value.code == 1 and "FAILED" in capsys.readouterr().out


@pytest.mark.parametrize("text", [
    '[7scenes]\nroot = "/data/7s"\n',
    '7scenes = "/data/seven"\n',
    '[bonn]\nroot = "/data/bonn"\n',
])
def test_resolve_root_equals_jax(text, tmp_path, monkeypatch):
    toml = tmp_path / "paths.toml"
    toml.write_text(text)
    monkeypatch.setenv("UNIGEO_PATHS", str(toml))
    for name in ("7scenes", "bonn", "replica"):
        assert paths.resolve_root(name) == jax_paths.resolve_root(name)
    monkeypatch.delenv("UNIGEO_PATHS")
    monkeypatch.chdir(tmp_path)  # ./paths.toml
    assert paths.resolve_root("7scenes") == jax_paths.resolve_root("7scenes")


@pytest.mark.parametrize("compression", ["NONE", "ZIPS", "ZIP"])
@pytest.mark.parametrize("pixel_type", ["HALF", "FLOAT", "UINT"])
def test_exr_round_trip_and_cross_read(compression, pixel_type, tmp_path):
    rng = np.random.default_rng(5)
    if pixel_type == "UINT":
        chans = {"Z": rng.integers(0, 2**31, (37, 23)).astype(np.uint32)}
    else:
        chans = {"R": rng.random((37, 23), np.float32) * 50, "Z": rng.random((37, 23), np.float32)}
        if pixel_type == "HALF":
            chans = {k: v.astype(np.float16).astype(np.float32) for k, v in chans.items()}
    ours, ref = str(tmp_path / "ours.exr"), str(tmp_path / "ref.exr")
    exr.write_exr(ours, chans, pixel_type=pixel_type, compression=compression)
    jax_exr.write_exr(ref, chans, pixel_type=pixel_type, compression=compression)
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    for path in (ours, ref):
        for reader in (exr.read_exr, jax_exr.read_exr):
            got = reader(path)
            got = got if isinstance(got, dict) else {"Z": got}
            assert sorted(got) == sorted(chans)
            for k, v in chans.items():
                assert got[k].dtype == v.dtype and np.array_equal(got[k], v), (path, k)


class _Clips:
    """A dataset of numbered dicts; index ``bad`` raises."""

    def __init__(self, n, bad=None):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            raise ValueError(f"clip {i} is broken")
        return {"images": np.full((2, 3, 4, 4), i, np.float32), "intrinsics": np.eye(3) * i,
                "scene_name": f"s{i}"}


@pytest.mark.parametrize("workers,prefetch", [(1, 1), (2, 4), (4, 2)])
def test_prefetch_yields_the_serial_order(workers, prefetch):
    from unigeo_tpu_torch.data.prefetch import PrefetchLoader

    ds = _Clips(9)
    loader = PrefetchLoader(ds, num_workers=workers, prefetch=prefetch, indices=[4, 0, 8, 3])
    assert len(loader) == 4
    got = list(loader)
    assert [d["scene_name"] for d in got] == ["s4", "s0", "s8", "s3"]
    for d, i in zip(got, [4, 0, 8, 3]):
        assert np.array_equal(d["images"], ds[i]["images"])


def test_prefetch_device_put_and_worker_error():
    import torch

    from unigeo_tpu_torch.data.prefetch import PrefetchLoader

    got = list(PrefetchLoader(_Clips(3), num_workers=2, device_put=True, device="cpu"))
    assert all(isinstance(d["images"], torch.Tensor) and isinstance(d["intrinsics"], torch.Tensor)
               for d in got)
    assert isinstance(got[0]["scene_name"], str)
    seen = []
    with pytest.raises(ValueError, match="clip 2 is broken"):
        for d in PrefetchLoader(_Clips(5, bad=2), num_workers=2):
            seen.append(d["scene_name"])
    assert seen == ["s0", "s1"]


def test_eval_with_prefetch_writes_the_serial_csv(tmp_path):
    from unigeo_tpu_torch.config import EvalConfig
    from unigeo_tpu_torch.evaluator import run_evaluation

    cfg = {"dataset": "SyntheticBoxDataset", "root": None, "h": 48, "w": 64, "clip_length": 4,
           "clip_overlap": 1, "split": "test",
           "dataset_params": {"num_scenes": 2, "frames_per_scene": 7, "render_size": [48, 64]},
           "model_name": "IdentityModel", "model_params": {},
           "eval_depth": {"metric_names": ["Abs Rel", "delta < 1.25"]},
           "eval_normal": {"metric_names": ["normal mean", "angle < 11.25"]},
           "eval_camera": {"metric_names": ["ATE", "RPE trans", "RPE rot"]}}
    csvs = []
    for workers in (0, 2):
        out = tmp_path / f"w{workers}"
        manager = run_evaluation(EvalConfig.from_dict(cfg), save_dir=str(out),
                                 num_workers=workers, verbose=False, device="cpu")
        assert len(manager.sequence_names) == 6
        csvs.append((out / "metrics.csv").read_bytes())
    assert csvs[0] == csvs[1]


def test_chip_smoke_disk_config_is_the_7scenes_yaml():
    """chip_smoke.py's disk-eval phase runs configs/depthcrafter_7scenes.yaml
    as a dict (the card machine may lack PyYAML): the same keys and values
    but for the root, the sample-list cache, the SVD-XT widths written out
    and vis_depth (off: its strips need matplotlib)."""
    import yaml

    import chip_smoke

    with open(os.path.join(os.path.dirname(fx.__file__), "..", "configs",
                           "depthcrafter_7scenes.yaml")) as f:
        want = yaml.safe_load(f)
    got = chip_smoke.disk_eval_config("/fixture", "/lists")
    assert got.pop("root") == "/fixture" and want.pop("root")
    assert got.pop("dataset_params") == {"cache_dir": "/lists"}
    assert got.pop("vis_depth") is False and want.pop("vis_depth") is True
    params = got.pop("model_params")
    assert params.pop("unet_config") == chip_smoke.SVD_XT_UNET
    assert params.pop("clip_config") == chip_smoke.SVD_XT_CLIP
    assert params == want.pop("model_params")
    assert got == want


def test_prefetch_threads_share_the_synthetic_frame_cache():
    """Sixteen prefetch threads with a 1 us switch interval, five passes over
    a dataset whose frame cache (64 frames) is trimmed all the time: every
    clip arrives, equal to the serial one.  (Without the cache's lock, 4 of
    5 runs of three such passes raised KeyError.)"""
    import sys

    from unigeo_tpu_torch.data.prefetch import PrefetchLoader
    from unigeo_tpu_torch.data.synthetic import SyntheticBoxDataset

    kw = dict(clip_length=4, num_scenes=2, frames_per_scene=200, render_size=(8, 8),
              compute_normals_if_missing=False)
    ds, ref = SyntheticBoxDataset(**kw), SyntheticBoxDataset(**kw)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        passes = [list(PrefetchLoader(ds, num_workers=16, prefetch=32)) for _ in range(5)]
    finally:
        sys.setswitchinterval(old)
    for got in passes:
        assert len(got) == len(ref) == 100
        for i in (0, 49, 99):
            assert np.array_equal(got[i]["images"], ref[i]["images"])
