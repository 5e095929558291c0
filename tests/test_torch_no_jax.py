"""The port stands alone: importing every module of unigeo_tpu_torch loads no
JAX and nothing of the JAX package, and neither the package nor
chip_smoke.py names them in an import."""

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
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'flax' or m.startswith('flax.')\n"
        "             or m == 'unigeo_tpu' or m.startswith('unigeo_tpu.'))\n"
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
