"""Build the port's CUDA kernels into one shared library and load it.

On first use every ``csrc/*.cu`` is compiled by its own ``nvcc``, all of
them started together, and one more ``nvcc`` links the objects into
``_build/libunigeo_kernels_<hash>.so``; the hash covers the
sources (headers included) and the flags, so an edited source builds anew
and an unchanged one loads the library already there.  The
library has a plain C interface and is loaded with ``ctypes`` (no PyTorch
headers are compiled, so a build takes seconds).  The compile runs under a
time limit and writes to a temporary name that is renamed into place, so a
build that is cut leaves nothing a later call could mistake for a library.

Nothing here runs at import: ``load_library()`` is called by the wrappers the
first time they launch a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_TIMEOUT_S = 300
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build, if any


def _sources():
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if not path:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return path


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libunigeo_kernels_{_digest(_sources())}.so")


def _run_all(cmds, deadline: float) -> None:
    """Run the commands at once; raise on the first that fails or outlives
    ``deadline`` (a ``time.monotonic`` value), after stopping the others."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    try:
        for cmd, proc in zip(cmds, procs):
            try:
                _, err = proc.communicate(timeout=max(deadline - time.monotonic(), 1e-3))
            except subprocess.TimeoutExpired as e:
                raise RuntimeError(f"nvcc did not finish in {NVCC_TIMEOUT_S} s: {cmd}") from e
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed with exit code {proc.returncode}: "
                                   f"{' '.join(cmd)}\n{err}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def compile_library(sources, out: str) -> float:
    """nvcc ``sources`` into the shared library ``out``, one compile per
    ``.cu`` in parallel and then the link, all under the time limit; returns
    the seconds it took.  Objects go to a temporary directory beside ``out``
    and the library to a temporary name renamed into place."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cu = [s for s in sources if s.endswith(".cu")]
    include = [f"-I{d}" for d in sorted({os.path.dirname(s) for s in cu})]
    t0 = time.perf_counter()
    deadline = time.monotonic() + NVCC_TIMEOUT_S
    with tempfile.TemporaryDirectory(dir=os.path.dirname(out)) as work:
        objs = [os.path.join(work, os.path.basename(s)[:-3] + ".o") for s in cu]
        _run_all([[_nvcc(), *NVCC_FLAGS, *include, "-c", "-o", o, s]
                  for s, o in zip(cu, objs)], deadline)
        tmp = os.path.join(work, "lib.so")
        _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs]], deadline)
        os.replace(tmp, out)
    return time.perf_counter() - t0


def build() -> str:
    """Compile the sources if the library for their hash is missing."""
    global build_seconds
    out = library_path()
    if not os.path.exists(out):
        build_seconds = compile_library(_sources(), out)
    return out


def open_library(path: str) -> ctypes.CDLL:
    """Load a kernel library and set every argtype."""
    lib = ctypes.CDLL(path)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    f32 = ctypes.c_float
    signatures = {
        "unigeo_flash_attention_packed": [p] * 4 + [i64] * 8 + [i32] * 5 + [f32, i32, p],
        "unigeo_flash_attention_headsplit": [p] * 4 + [i64] * 8 + [i32] * 5 + [f32, i32, p],
        "unigeo_flash_attention_fwd_lse": [p] * 5 + [i64] * 8 + [i32] * 5 + [f32, i32, p],
        "unigeo_flash_attention_bwd_dq": [p] * 7 + [i32] * 5 + [f32, i32, p],
        "unigeo_flash_attention_bwd_dkv": [p] * 8 + [i32] * 5 + [f32, i32, p],
        "unigeo_geglu_ffn": [p] * 7 + [i32] * 4 + [p],
        "unigeo_geglu_ffn_plan": [i32] * 4 + [p],
        "unigeo_ln_dense": [p] * 6 + [i32] * 3 + [f32, i32, p],
        "unigeo_ln_dense_plan": [p] * 4 + [i32] * 3 + [p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i32
    lib.unigeo_cuda_error_string.argtypes = [i32]
    lib.unigeo_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = open_library(build())
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.unigeo_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
