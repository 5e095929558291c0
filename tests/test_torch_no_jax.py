"""The port stands alone: importing every module of unigeo_tpu_torch loads no
JAX and nothing of the JAX package, and neither the package nor
chip_smoke.py names them in an import.  Nor does an import load ``yaml`` or
``PIL``, which the card machine does not have: the training path imports
them only where a YAML file is read or an image file decoded or resized."""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "unigeo_tpu_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_importing_every_module_loads_no_jax():
    mods = []
    for path in _port_files():
        rel = os.path.relpath(path, ROOT)[:-3]
        if rel == "chip_smoke":
            mods.append("chip_smoke")
        else:
            mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'flax', 'unigeo_tpu', 'yaml', 'PIL'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_source_names_no_jax(path):
    with open(path) as f:
        src = f.read()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax)\b", src, re.M), path
    assert not re.search(r"unigeo_tpu\.(?!_torch)", src.replace("unigeo_tpu_torch", "")), path
    assert not re.search(r"(import|from)\s+unigeo_tpu\b(?!_torch)", src), path


# the modules of the training slice, which the walk above must find
TRAINING_MODULES = [
    "unigeo_tpu_torch/train.py",
    "unigeo_tpu_torch/config.py",
    "unigeo_tpu_torch/registry.py",
    "unigeo_tpu_torch/parallel/trainer.py",
    "unigeo_tpu_torch/data/base.py",
    "unigeo_tpu_torch/data/transforms.py",
    "unigeo_tpu_torch/data/synthetic.py",
    "unigeo_tpu_torch/utils/writers.py",
    # checkpoint IO and the other trainer families
    "unigeo_tpu_torch/utils/checkpoint.py",
    "unigeo_tpu_torch/data/collate.py",
    "unigeo_tpu_torch/data/augmentations.py",
    "unigeo_tpu_torch/models/pointmap/losses.py",
    "unigeo_tpu_torch/tools/convert_checkpoint.py",
]


@pytest.mark.parametrize("rel", TRAINING_MODULES)
def test_training_modules_are_checked(rel):
    assert os.path.join(ROOT, rel) in _port_files()


# the modules of the eval slice, which the walk above must find
EVAL_MODULES = [
    "unigeo_tpu_torch/eval.py",
    "unigeo_tpu_torch/evaluator.py",
    "unigeo_tpu_torch/metrics/manager.py",
    "unigeo_tpu_torch/metrics/alignment.py",
    "unigeo_tpu_torch/metrics/depth.py",
    "unigeo_tpu_torch/models/base.py",
    "unigeo_tpu_torch/models/identity.py",
    "unigeo_tpu_torch/ops/geglu.py",
    "unigeo_tpu_torch/utils/profiling.py",
    "unigeo_tpu_torch/utils/vis.py",
]


@pytest.mark.parametrize("rel", EVAL_MODULES)
def test_eval_modules_are_checked(rel):
    assert os.path.join(ROOT, rel) in _port_files()


# the modules of the LayerNorm -> dense and metrics slice, which the walk
# above must find
METRICS_SLICE_MODULES = [
    "unigeo_tpu_torch/ops/ln_qkv.py",
    "unigeo_tpu_torch/tools/ablate_ln_qkv.py",
    "unigeo_tpu_torch/ops/knn.py",
    "unigeo_tpu_torch/ops/geometry.py",
    "unigeo_tpu_torch/metrics/pointcloud.py",
    "unigeo_tpu_torch/metrics/camera.py",
    "unigeo_tpu_torch/metrics/extras.py",
    "unigeo_tpu_torch/data/trajectories.py",
]


@pytest.mark.parametrize("rel", METRICS_SLICE_MODULES)
def test_metrics_slice_modules_are_checked(rel):
    assert os.path.join(ROOT, rel) in _port_files()


def test_evaluator_imports_no_pandas_yaml_pil_or_matplotlib():
    """The card machine has none of them: the CLI, the evaluator, the CSV
    manager, the metrics (extras imports matplotlib only to plot a
    trajectory), the trajectory readers and the LayerNorm -> dense tool
    import without them (vis imports matplotlib and PIL only when a strip is
    saved, the config yaml only when a YAML file is read)."""
    code = (
        "import sys\n"
        "import unigeo_tpu_torch.eval, unigeo_tpu_torch.evaluator\n"
        "import unigeo_tpu_torch.metrics.manager, unigeo_tpu_torch.utils.vis\n"
        "import unigeo_tpu_torch.metrics.extras, unigeo_tpu_torch.data.trajectories\n"
        "import unigeo_tpu_torch.tools.ablate_ln_qkv\n"
        "from unigeo_tpu_torch.registry import get_model_cls\n"
        "get_model_cls('DepthCrafter'); get_model_cls('IdentityModel')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('pandas', 'yaml', 'PIL', 'matplotlib', 'jax', 'unigeo_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


# the modules of the loader, prefetch and batched-denoise slice, which the
# walk above must find
LOADER_SLICE_MODULES = [
    "unigeo_tpu_torch/data/paths.py",
    "unigeo_tpu_torch/data/exr.py",
    "unigeo_tpu_torch/data/loaders.py",
    "unigeo_tpu_torch/data/hypersim.py",
    "unigeo_tpu_torch/data/preflight.py",
    "unigeo_tpu_torch/data/prefetch.py",
    "unigeo_tpu_torch/native/__init__.py",
    "unigeo_tpu_torch/tools/disk_fixture.py",
    "unigeo_tpu_torch/models/depthcrafter/pipeline.py",
    "unigeo_tpu_torch/models/depthcrafter/model.py",
]


@pytest.mark.parametrize("rel", LOADER_SLICE_MODULES)
def test_loader_slice_modules_are_checked(rel):
    assert os.path.join(ROOT, rel) in _port_files()


# the modules of the SVD-family and Spann3R slice, which the walk above must find
SIBLING_SLICE_MODULES = [
    "unigeo_tpu_torch/models/stablenormal.py",
    "unigeo_tpu_torch/models/chronodepth.py",
    "unigeo_tpu_torch/models/depthanyvideo.py",
    "unigeo_tpu_torch/models/unigeo_cam.py",
    "unigeo_tpu_torch/models/camera_solver.py",
    "unigeo_tpu_torch/models/pointmap/__init__.py",
    "unigeo_tpu_torch/models/pointmap/network.py",
    "unigeo_tpu_torch/models/pointmap/dpt.py",
    "unigeo_tpu_torch/models/pointmap/adapter.py",
    "unigeo_tpu_torch/models/pointmap/spann3r.py",
    "unigeo_tpu_torch/ops/rope.py",
]


@pytest.mark.parametrize("rel", SIBLING_SLICE_MODULES)
def test_sibling_slice_modules_are_checked(rel):
    assert os.path.join(ROOT, rel) in _port_files()


# the modules of the Dust3R, Cut3R and VideoDepthAnything slice, which the
# walk above must find
POINTMAP_SLICE_MODULES = [
    "unigeo_tpu_torch/models/posecodec.py",
    "unigeo_tpu_torch/models/pointmap/dust3r.py",
    "unigeo_tpu_torch/models/pointmap/cut3r.py",
    "unigeo_tpu_torch/models/vda.py",
]


@pytest.mark.parametrize("rel", POINTMAP_SLICE_MODULES)
def test_pointmap_slice_modules_are_checked(rel):
    assert os.path.join(ROOT, rel) in _port_files()


def test_pointmap_slice_names_resolve_without_jax_yaml_or_pil():
    """Dust3R, Cut3R and VideoDepthAnything resolve through the port's
    registry to the port's classes, importing neither JAX nor the JAX
    package, PyYAML or PIL."""
    code = (
        "import sys\n"
        "from unigeo_tpu_torch.registry import get_model_cls\n"
        "for n in ('Dust3R', 'Cut3R', 'VideoDepthAnything'):\n"
        "    assert get_model_cls(n).__module__.startswith('unigeo_tpu_torch.'), n\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'flax', 'unigeo_tpu', 'yaml', 'PIL'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_every_new_model_name_resolves_without_jax_yaml_or_pil():
    """The six names of the SVD-family and Spann3R slice resolve through the
    port's registry, importing neither JAX nor the JAX package, PyYAML or PIL."""
    code = (
        "import sys\n"
        "from unigeo_tpu_torch.registry import get_model_cls\n"
        "for n in ('UniGeoCam', 'UniGeo', 'StableNormal', 'ChronoDepth', 'DepthAnyVideo',\n"
        "          'Spann3R'):\n"
        "    get_model_cls(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'flax', 'unigeo_tpu', 'yaml', 'PIL'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_loader_slice_imports_no_pil_pandas_h5py_or_yaml():
    """The card machine may lack all four: the loaders import PIL only to
    decode or resize, Hypersim pandas and h5py only to read its files, and
    the registry's disk datasets register without any of them."""
    mods = [rel[:-3].replace("/", ".").removesuffix(".__init__") for rel in LOADER_SLICE_MODULES]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from unigeo_tpu_torch.registry import get_dataset_cls\n"
        "get_dataset_cls('sevenScenesDataset'); get_dataset_cls('HyperSimDataset')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'unigeo_tpu', 'PIL', 'pandas', 'h5py', 'yaml'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


# the modules of the serving slice, which the walk above must find
SERVING_SLICE_MODULES = [
    "unigeo_tpu_torch/serving.py",
    "unigeo_tpu_torch/serve.py",
    "unigeo_tpu_torch/utils/convert_dust3r.py",
    "unigeo_tpu_torch/utils/convert_vda.py",
    "unigeo_tpu_torch/utils/convert_aether.py",
    "unigeo_tpu_torch/utils/randparams.py",
]


@pytest.mark.parametrize("rel", SERVING_SLICE_MODULES)
def test_serving_slice_modules_are_checked(rel):
    assert os.path.join(ROOT, rel) in _port_files()


def test_serving_and_converters_import_no_jax_yaml_or_pil():
    """The server, its CLI and the converters import neither JAX nor the JAX
    package, PyYAML or PIL."""
    code = (
        "import sys\n"
        "import unigeo_tpu_torch.serve, unigeo_tpu_torch.serving\n"
        "import unigeo_tpu_torch.tools.convert_checkpoint\n"
        "import unigeo_tpu_torch.utils.convert_dust3r, unigeo_tpu_torch.utils.convert_vda\n"
        "import unigeo_tpu_torch.utils.convert_aether, unigeo_tpu_torch.utils.randparams\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'flax', 'unigeo_tpu', 'yaml', 'PIL'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
