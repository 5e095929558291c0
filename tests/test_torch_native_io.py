"""The port's native clip reader (``unigeo_tpu_torch/native``) on the CPU.

Its decodes equal PIL's on the same files (8- and 16-bit PNG, JPEG, WebP,
RGB-coded normals), its error codes equal the JAX package's reader's, its
library is built from the port's own ``io.cc`` into ``unigeo_tpu_torch/_build``
and a dataset's samples are the same through it and through PIL.  The PNGs
that ``tools/disk_fixture.py`` encodes with the standard library read back
equal in PIL, and the port's 7-Scenes loader over them equals the JAX one.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from unigeo_tpu import native as jax_native
from unigeo_tpu_torch import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def media(tmp_path):
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, (40, 56, 3), np.uint8)
    depth = rng.integers(0, 60000, (40, 56), np.uint16)
    normal = rng.integers(0, 256, (40, 56, 3), np.uint8)
    normal[:6, :9] = 0  # invalid pixels (all-zero codes)
    paths = {}
    for ext in ("png", "jpg", "webp"):
        paths[ext] = str(tmp_path / f"rgb.{ext}")
        Image.fromarray(rgb).save(paths[ext])
    paths["depth"] = str(tmp_path / "depth.png")
    Image.fromarray(depth).save(paths["depth"])
    paths["depth8"] = str(tmp_path / "depth8.png")
    Image.fromarray((depth // 256).astype(np.uint8)).save(paths["depth8"])
    paths["normal"] = str(tmp_path / "normal.png")
    Image.fromarray(normal).save(paths["normal"])
    return paths


def test_reader_is_built_and_named():
    assert native.available(), native.build_error
    assert native.reader_name() == "native"
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "unigeo_tpu_torch", "_build")
    assert os.path.exists(path)
    assert native.SOURCE == os.path.join(ROOT, "unigeo_tpu_torch", "native", "io.cc")


@pytest.mark.parametrize("ext", ["png", "jpg", "webp"])
def test_rgb_equals_pil(media, ext):
    out = native.decode_clip_rgb([media[ext]] * 3)
    ref = np.asarray(Image.open(media[ext]).convert("RGB"), np.float32).transpose(2, 0, 1)
    assert out.shape == (3, 3, 40, 56) and out.dtype == np.float32
    for f in range(3):
        np.testing.assert_array_equal(out[f], ref)


@pytest.mark.parametrize("key,scale", [("depth", 5000.0), ("depth8", 1000.0)])
def test_depth_equals_pil(media, key, scale):
    out = native.decode_clip_depth([media[key]] * 2, scale)
    ref = np.asarray(Image.open(media[key]), np.float32) / scale
    assert out.shape == (2, 40, 56)
    np.testing.assert_array_equal(out[0], ref)
    np.testing.assert_array_equal(out[1], ref)


def test_normal_equals_pil(media):
    out = native.decode_clip_normal([media["normal"]])
    raw = np.asarray(Image.open(media["normal"]), np.float32)
    ref = raw / 255.0 * 2.0 - 1.0
    ref[np.all(raw < 1e-3, axis=2)] = 0
    np.testing.assert_array_equal(out[0], ref.transpose(2, 0, 1))
    assert native.image_info(media["normal"]) == jax_native.image_info(media["normal"])


def _code(fn, *args):
    with pytest.raises(RuntimeError) as info:
        fn(*args)
    return info.value.code, str(info.value)


def test_error_codes_equal_the_jax_readers(media, tmp_path):
    assert jax_native.available()
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(b"not an image at all")
    small = str(tmp_path / "small.png")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(small)
    cases = [
        ("decode_clip_rgb", ([str(tmp_path / "missing.png")],)),
        ("decode_clip_rgb", ([bad],)),
        ("decode_clip_depth", ([media["png"]], 1000.0)),
        ("decode_clip_rgb", ([media["png"], small],)),
    ]
    codes = []
    for name, args in cases:
        ours = _code(getattr(native, name), *args)
        ref = _code(getattr(jax_native, name), *args)
        assert ours == ref, name
        codes.append(ours[0])
    assert codes == [-1, -2, -5, -4]
    assert isinstance(native.NativeIOError(-1), RuntimeError)


def test_build_writes_only_the_ports_build_dir(tmp_path):
    """A fresh build (in a process that imports only the port) writes its
    library into the build directory it is given and nowhere else; the port
    names no file of the JAX package's reader."""
    code = (
        "import os, sys\n"
        "from unigeo_tpu_torch import native\n"
        f"native.BUILD_DIR = {str(tmp_path / 'b')!r}\n"
        f"native.library_path = lambda: os.path.join(native.BUILD_DIR, 'lib.so')\n"
        "assert native.available(), native.build_error\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('unigeo_tpu', 'jax', 'PIL')]\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert os.listdir(tmp_path / "b") == ["lib.so"]
    with open(native.__file__) as f:
        src = f.read()
    assert "_libunigeo_io.so" not in src


def test_native_and_pil_routes_give_equal_samples(tmp_path, monkeypatch):
    """ScanNet++ (WebP RGB and normals, PNG depth): one sample through the
    native reader, then through PIL."""
    from fixtures_loaders import build_scannetpp
    from test_torch_loaders import _port_twin

    pds = _port_twin(build_scannetpp(str(tmp_path / "root"), str(tmp_path / "c1")),
                     str(tmp_path / "c2"))
    scene = pds._scene("02455b3d20")
    assert pds._native_clip("rgb", [pds._abs(scene.rgb_paths[0])]) is not None
    through_native = pds[0]
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("UNIGEO_NATIVE_IO", "0")
    assert native.reader_name() == "pil"
    assert pds._native_clip("rgb", [pds._abs(scene.rgb_paths[0])]) is None
    through_pil = pds[0]
    for key in ("images", "cam_coord", "cam_normal", "world_coord", "world_normal", "mask"):
        np.testing.assert_array_equal(through_native[key], through_pil[key], err_msg=key)


def test_own_readers_bypass_the_native_reader(tmp_path):
    """Sintel's .dpt depth and InteriorNet's ray-length depth keep their own
    per-frame readers."""
    from fixtures_loaders import build_interiornet, build_sintel
    from test_torch_loaders import _port_twin

    ds = _port_twin(build_sintel(str(tmp_path / "s"), str(tmp_path / "c1")), str(tmp_path / "c2"))
    assert ds._native_clip("depth", [ds._abs(ds._scene("alley_1").depth_paths[0])]) is None
    ds = _port_twin(build_interiornet(str(tmp_path / "i"), str(tmp_path / "c3")),
                    str(tmp_path / "c4"))
    scene = ds._scene("3FO4IDEI1LAV_Dining_room")
    assert ds._native_clip("depth", [ds._abs(scene.depth_paths[0])]) is None


def test_disk_fixture_pngs_read_back_and_load_as_in_jax(tmp_path):
    from unigeo_tpu.data.loaders import SevenScenesDataset as JaxSevenScenes
    from test_torch_loaders import _assert_samples_equal
    from unigeo_tpu_torch.data.loaders import SevenScenesDataset
    from unigeo_tpu_torch.tools import disk_fixture

    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (7, 9, 3), np.uint8)
    grey = rng.integers(0, 65536, (7, 9), np.uint16)
    disk_fixture.write_png(str(tmp_path / "rgb.png"), rgb)
    disk_fixture.write_png(str(tmp_path / "grey.png"), grey)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "rgb.png")), rgb)
    back = np.asarray(Image.open(tmp_path / "grey.png"))
    np.testing.assert_array_equal(back.astype(np.uint16), grey)

    root = str(tmp_path / "7s")
    disk_fixture.write_seven_scenes(root, num_frames=6, height=48, width=64)
    kw = dict(clip_length=4, clip_overlap=1)
    jds = JaxSevenScenes(root=root, cache_dir=str(tmp_path / "cj"), **kw)
    pds = SevenScenesDataset(root=root, cache_dir=str(tmp_path / "cp"), **kw)
    assert pds.list_scenes("test") == ["chess/seq-01"] and len(pds) == len(jds) == 2
    for i in range(len(pds)):
        _assert_samples_equal(pds[i], jds[i], plane_fit=True)
