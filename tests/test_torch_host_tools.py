"""The port's host tools against the JAX package's, on tiny fixtures, on the
CPU: ``python -m unigeo_tpu_torch.tools.preprocess_7scenes``,
``preprocess_scannetpp`` (the iPhone and the DSLR path) and ``vis_dataset``
(each run with ``--device cpu``) against ``tools/preprocess_7scenes.py``,
``tools/preprocess_scannetpp.py`` and ``tools/vis_dataset.py`` on the same
fixture written into ``tmp_path``; and ``TimeWriter.eta_seconds``,
``random_pipeline_params`` and the converter's ``--allow-partial``.

Tolerances: the registered 7-Scenes depth PNGs bitwise
(tests/test_torch_preprocess.py holds ``register_depth_to_rgb`` bitwise);
the ScanNet++ depth PNGs within 1 mm where both hit and their hit masks
equal, the normal maps within 1 of 255 (uint8 of normals within 1e-5),
the RGB outputs bitwise on the iPhone path (the same PIL resize of the
same file) and within 1 of 255 on the DSLR path (undistortion maps within
1e-4 px), the metadata within 1e-6; the QA strips' RGB and stored-normal panels
bitwise, their refit-normal panel within 1 of 255 (the plane fit's uint8
quantization) except in the frame's 2-pixel border band, where the
zero-padded patches make the fit degenerate in both packages, and their CSV
rows equal.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import json
import os
import runpy
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_jax_tool(name, argv, monkeypatch):
    """tools/<name>.py's main with ``argv``, in this process."""
    monkeypatch.setattr(sys, "argv", [name] + argv)
    runpy.run_path(os.path.join(ROOT, "tools", f"{name}.py"), run_name="__main__")


def _png(path):
    return np.asarray(Image.open(path))


# ---------------------------------------------------------------------------
# preprocess_7scenes
# ---------------------------------------------------------------------------

def _seven_scenes_fixture(root, rng):
    for seq in ("seq-01", "seq-02"):
        d = root / "chess" / seq
        d.mkdir(parents=True)
        for i in range(2):
            vv, uu = np.mgrid[0:480, 0:640]
            depth = 1200 + 2.0 * uu + 1.0 * vv + rng.normal(scale=25, size=uu.shape)
            depth = np.clip(depth, 1, 65534).astype(np.uint16)
            depth[rng.random(depth.shape) < 0.05] = 0
            depth[rng.random(depth.shape) < 0.01] = 65535
            Image.fromarray(depth).save(d / f"frame-{i:06d}.depth.png")


def test_preprocess_7scenes_cli_matches_jax(tmp_path, monkeypatch, capsys):
    from unigeo_tpu_torch.tools import preprocess_7scenes

    _seven_scenes_fixture(tmp_path / "jax", np.random.default_rng(0))
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    _run_jax_tool("preprocess_7scenes", ["--root", str(tmp_path / "jax")], monkeypatch)
    assert preprocess_7scenes.main(["--root", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert "done: 4 frames registered" in capsys.readouterr().out
    outs = sorted((tmp_path / "port").rglob("*.depth.proj.png"))
    assert len(outs) == 4
    for p in outs:
        theirs = tmp_path / "jax" / p.relative_to(tmp_path / "port")
        ours = _png(p)
        assert ours.dtype == np.uint16 and np.array_equal(ours, _png(theirs))
    # a second run keeps what is there
    assert preprocess_7scenes.main(["--root", str(tmp_path / "port"), "--scenes", "chess",
                                    "--device", "cpu"]) == 0
    assert "done: 0 frames registered" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# preprocess_scannetpp
# ---------------------------------------------------------------------------

def _room_mesh(rng):
    """A back wall of a 20 x 15 noisy grid at z ~ 3 and a box in front."""
    xs, ys = np.meshgrid(np.linspace(-3, 3, 20), np.linspace(-2, 2, 15))
    zs = 3.0 + 0.05 * rng.normal(size=xs.shape)
    verts = np.stack([xs, ys, zs], -1).reshape(-1, 3)
    idx = np.arange(verts.shape[0]).reshape(15, 20)
    a, b, c, d = idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1], idx[1:, 1:]
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([b, d, c], -1).reshape(-1, 3)])
    box = np.array([[x, y, z] for z in (1.5, 2.0) for y in (-0.4, 0.4) for x in (-0.5, 0.5)])
    bf = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                   [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
    verts = np.concatenate([verts, box]).astype(np.float32)
    return verts, np.concatenate([faces, bf + len(idx.reshape(-1))]).astype(np.int64)


def _scannetpp_fixture(root, rng):
    from unigeo_tpu.preprocess.rasterizer import write_ply_mesh

    scene = root / "scene0"
    for sub in ("scans", "iphone/rgb", "dslr/colmap", "dslr/images"):
        (scene / sub).mkdir(parents=True)
    write_ply_mesh(str(scene / "scans" / "mesh_aligned_0.05.ply"), *_room_mesh(rng))
    meta = {}
    for i in range(3):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.1 * i, -0.05 * i, 0.0]
        meta[f"frame_{i:06d}"] = {"aligned_pose": c2w.tolist(),
                                  "intrinsic": [[90.0, 0, 63.5], [0, 90.0, 47.5], [0, 0, 1]]}
        if i < 2:  # the third frame has no image: skipped
            Image.fromarray(rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)).save(
                scene / "iphone" / "rgb" / f"frame_{i:06d}.jpg")
    (scene / "iphone" / "pose_intrinsic_imu.json").write_text(json.dumps(meta))
    w, h = 64, 48
    (scene / "dslr" / "colmap" / "cameras.txt").write_text(
        f"1 OPENCV_FISHEYE {w} {h} 40.0 40.0 {w / 2 + 0.5} {h / 2 + 0.5} 0.03 -0.005 0.0 0.0\n")
    (scene / "dslr" / "colmap" / "images.txt").write_text(
        "1 1 0 0 0 0 0 0 1 DSC00001.JPG\n\n2 0.999 0 0.0447 0 0.1 0 0 1 DSC00002.JPG\n\n")
    (scene / "dslr" / "colmap" / "points3D.txt").write_text("# none\n")
    for name in ("DSC00001.JPG", "DSC00002.JPG"):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            scene / "dslr" / "images" / name)


@pytest.mark.parametrize("camera", ["iphone", "dslr"])
def test_preprocess_scannetpp_cli_matches_jax(tmp_path, monkeypatch, camera):
    from unigeo_tpu_torch.tools import preprocess_scannetpp

    _scannetpp_fixture(tmp_path / "raw", np.random.default_rng(1))
    args = ["--data-root", str(tmp_path / "raw"), "--height", "48", "--width", "64",
            "--camera", camera]
    _run_jax_tool("preprocess_scannetpp", args + ["--out-root", str(tmp_path / "jax")],
                  monkeypatch)
    assert preprocess_scannetpp.main(args + ["--out-root", str(tmp_path / "port"),
                                             "--device", "cpu"]) == 0
    ours, theirs = tmp_path / "port" / "scene0", tmp_path / "jax" / "scene0"
    meta, jmeta = np.load(ours / "scene_metadata.npz"), np.load(theirs / "scene_metadata.npz")
    assert list(meta["images"]) == list(jmeta["images"]) and len(meta["images"]) == 2
    for key in ("trajectories", "intrinsics"):
        assert meta[key].dtype == jmeta[key].dtype
        assert np.abs(meta[key] - jmeta[key]).max() <= 1e-6
    for name in meta["images"]:
        d, jd = _png(ours / "depth" / f"{name}.png"), _png(theirs / "depth" / f"{name}.png")
        assert d.dtype == np.uint16 and np.array_equal(d > 0, jd > 0)
        assert (d > 0).mean() > 0.9
        assert np.abs(d.astype(np.int64) - jd).max() <= 1
        n, jn = _png(ours / "normal" / f"{name}.webp"), _png(theirs / "normal" / f"{name}.webp")
        assert np.abs(n.astype(np.int64) - jn).max() <= 1
        rgb, jrgb = _png(ours / "images" / f"{name}.webp"), _png(theirs / "images" / f"{name}.webp")
        assert np.abs(rgb.astype(np.int64) - jrgb).max() <= (0 if camera == "iphone" else 1)


# ---------------------------------------------------------------------------
# vis_dataset
# ---------------------------------------------------------------------------

def test_vis_dataset_cli_matches_jax(tmp_path, monkeypatch):
    from unigeo_tpu_torch.tools import vis_dataset

    cfg = os.path.join(ROOT, "configs", "identity_synthetic.yaml")
    args = ["--config", cfg, "--every", "3", "--max-samples", "2"]
    _run_jax_tool("vis_dataset", args + ["--out", str(tmp_path / "jax")], monkeypatch)
    assert vis_dataset.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    rows = (tmp_path / "port" / "data.csv").read_text().splitlines()
    assert rows == (tmp_path / "jax" / "data.csv").read_text().splitlines() and len(rows) == 3
    strips = sorted(p.name for p in (tmp_path / "port").glob("*.png"))
    assert strips == sorted(p.name for p in (tmp_path / "jax").glob("*.png")) and len(strips) == 2
    for name in strips:
        ours, theirs = _png(tmp_path / "port" / name), _png(tmp_path / "jax" / name)
        assert ours.shape == theirs.shape == (96, 3 * 128, 3)
        # RGB and the stored normals: the same loaders' bits
        assert np.array_equal(ours[:, :256], theirs[:, :256])
        # the refit normals away from the frame's 2-pixel border band, where
        # the zero-padded 5 x 5 patch holds padding zeros as points (at the
        # world origin) and the fit is degenerate in both packages
        diff = np.abs(ours[2:-2, 256 + 2:-2].astype(np.int64) - theirs[2:-2, 256 + 2:-2])
        assert diff.max() <= 1


# ---------------------------------------------------------------------------
# the timer's ETA, random pipeline weights, partial conversions
# ---------------------------------------------------------------------------

def test_time_writer_eta_matches_jax():
    from unigeo_tpu.utils.writers import TimeWriter as JaxTimeWriter
    from unigeo_tpu_torch.utils.writers import TimeWriter

    for total in (None, 10):
        ours, theirs = TimeWriter(total_steps=total), JaxTimeWriter(total_steps=total)
        assert ours.eta_seconds is None and theirs.eta_seconds is None
        for w in (ours, theirs):
            w.times.extend([0.5, 1.5, 1.0])
            w.step = 3
        assert ours.eta_seconds == theirs.eta_seconds
        assert ours.eta_seconds == (None if total is None else 7.0)
    with TimeWriter(total_steps=2, window=1) as t:
        pass
    assert t.step == 1 and t.eta_seconds == pytest.approx(t.last)


def test_random_pipeline_params_shapes_and_dtypes():
    from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline
    from unigeo_tpu_torch.utils.randparams import random_pipeline_params

    pipe = tiny_pipeline(device="cpu")
    params = random_pipeline_params(pipe, seed=3)
    assert set(params) == {"unet", "vae", "clip"}
    for module, sd in zip(pipe.modules(), params.values()):
        own = module.state_dict()
        assert list(sd) == list(own)
        for k, v in sd.items():
            assert v.shape == own[k].shape and v.device.type == "cpu"
            if own[k].is_floating_point():
                assert v.dtype == torch.bfloat16 and torch.isfinite(v.float()).all()
    flat = torch.cat([v.float().reshape(-1) for v in params["unet"].values()])
    assert abs(flat.std().item() - 0.02) < 0.002
    again = random_pipeline_params(pipe, seed=3)
    assert all(torch.equal(again["vae"][k], params["vae"][k]) for k in params["vae"])
    for module, sd in zip(pipe.modules(), params.values()):  # the modules hold them
        for k, v in module.state_dict().items():
            if v.is_floating_point():
                assert torch.equal(v, sd[k].to(v.dtype))


def test_convert_checkpoint_allow_partial(tmp_path, capsys):
    from test_torch_checkpoint import tiny_upstream
    from unigeo_tpu_torch.tools import convert_checkpoint
    from unigeo_tpu_torch.utils.checkpoint import load_params

    sds, cfg = tiny_upstream()
    vae = {k: v.contiguous() for k, v in sds["vae"].items()}
    missing = sorted(vae)[3]
    vae.pop(missing)
    vae["encoder.renamed.weight"] = torch.ones(3)
    args = []
    for name, sd in (("unet", sds["unet"]), ("vae", vae), ("clip", sds["clip"])):
        path = str(tmp_path / f"{name}.pt")
        torch.save({k: v.contiguous() for k, v in sd.items()}, path)
        args += [f"--{name}", path]
    out = str(tmp_path / "svd.ckpt")
    args += ["--out", out, "--network-config", json.dumps(cfg)]
    with pytest.raises(SystemExit, match="allow-partial"):
        convert_checkpoint.main(args)
    assert not os.path.exists(out)
    assert convert_checkpoint.main(args + ["--allow-partial"]) == 0
    err = capsys.readouterr().err
    assert "partial conversion" in err and missing in err and "encoder.renamed.weight" in err
    params = load_params(out)
    assert "encoder.renamed.weight" not in params["vae"]
    assert params["vae"][missing].abs().sum() == 0  # written as zeros
    assert torch.equal(params["unet"][sorted(sds["unet"])[0]],
                       sds["unet"][sorted(sds["unet"])[0]])
