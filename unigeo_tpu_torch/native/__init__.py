"""The native (C++) clip reader, port of ``unigeo_tpu/native/__init__.py``.

``io.cc`` (this package's own copy) decodes every frame of a clip in one C
call on a thread pool (libpng / libjpeg / libwebp), straight into a numpy
buffer in the layout the clip datasets use: [N,3,H,W] f32 0..255 RGB,
[N,H,W] f32 depth (codes / scale), [N,3,H,W] f32 normals in [-1, 1].

The library is built with g++ on first use into
``unigeo_tpu_torch/_build/libunigeo_io_<hash>.so``, the hash over the source
and the flags, under a time limit, written to a temporary name and renamed
into place, so a cut build leaves nothing a later call could load.  When
g++ or a codec's headers are missing (or ``UNIGEO_NATIVE_IO=0``),
``available()`` is False and the datasets decode frame by frame with PIL,
bit for bit the same; ``reader_name()`` says which reader decodes
("native" or "pil") and ``build_error`` why the build failed, if it did.
Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import subprocess
import tempfile
import threading
from typing import Optional, Sequence

import numpy as np

_DIR = osp.dirname(osp.abspath(__file__))
SOURCE = osp.join(_DIR, "io.cc")
BUILD_DIR = osp.join(osp.dirname(_DIR), "_build")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lpng", "-ljpeg", "-lwebp", "-lpthread")
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False
build_error: Optional[str] = None  # why the library is not available, if it is not

_ERRORS = {
    -1: "cannot open file",
    -2: "unknown or unsupported image format",
    -3: "codec decode failure",
    -4: "decoded dims differ from expected dims",
    -5: "depth file is not 8/16-bit grayscale PNG",
}


class NativeIOError(RuntimeError):
    def __init__(self, code: int, context: str = ""):
        self.code = code
        msg = _ERRORS.get(code, f"native io error {code}")
        super().__init__(f"{msg}{': ' + context if context else ''}")


def library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS + LIBS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return osp.join(BUILD_DIR, f"libunigeo_io_{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    """g++ io.cc into ``out``: a temporary name beside it, renamed into place."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, SOURCE, *LIBS, "-o", tmp], check=True,
                       capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        os.replace(tmp, out)
    finally:
        if osp.exists(tmp):
            os.unlink(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_char_pp = ctypes.POINTER(ctypes.c_char_p)
    i32 = ctypes.c_int32
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.ug_image_info.argtypes = [ctypes.c_char_p] + [ctypes.POINTER(i32)] * 3
    lib.ug_decode_clip_rgb_f32.argtypes = [c_char_pp, i32, i32, i32, f32p, i32]
    lib.ug_decode_clip_depth_f32.argtypes = [c_char_pp, i32, i32, i32, ctypes.c_float, f32p, i32]
    lib.ug_decode_clip_normal_f32.argtypes = [c_char_pp, i32, i32, i32, f32p, i32]
    for fn in (lib.ug_image_info, lib.ug_decode_clip_rgb_f32, lib.ug_decode_clip_depth_f32,
               lib.ug_decode_clip_normal_f32):
        fn.restype = ctypes.c_int
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed, build_error
    if _lib is not None:
        return _lib
    if os.environ.get("UNIGEO_NATIVE_IO") == "0":
        return None
    with _lock:
        if _lib is None and not _load_failed:
            out = library_path()
            try:
                if not osp.exists(out):
                    _build(out)
                _lib = _bind(ctypes.CDLL(out))
            except subprocess.CalledProcessError as e:
                # one line: the compiler's first error (a missing codec header)
                errors = [ln for ln in e.stderr.splitlines() if "error" in ln] or [""]
                _load_failed, build_error = True, f"g++ failed: {errors[0].strip()}"
            except (subprocess.SubprocessError, OSError) as e:
                _load_failed, build_error = True, f"{type(e).__name__}: {e}"
    return _lib


def available() -> bool:
    """True when the library is built or buildable and not disabled
    (``UNIGEO_NATIVE_IO=0`` forces the PIL reader)."""
    return _load() is not None


def reader_name() -> str:
    """The reader the stock per-frame formats are decoded with: "native" or "pil"."""
    return "native" if available() else "pil"


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise NativeIOError(-3, "native io unavailable")
    return lib


def image_info(path: str):
    """(h, w, kind) without decoding pixels; kind 0=png8 1=jpeg 2=webp 3=png16."""
    lib = _lib_or_raise()
    h, w, kind = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib.ug_image_info(path.encode(), h, w, kind)
    if rc != 0:
        raise NativeIOError(rc, path)
    return h.value, w.value, kind.value


def _paths_array(paths: Sequence[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_clip_rgb(paths: Sequence[str], nthreads: int = 0) -> np.ndarray:
    """Clip of RGB frames -> [N,3,H,W] float32 0..255 (dims from frame 0)."""
    lib = _lib_or_raise()
    h, w, _ = image_info(paths[0])
    out = np.empty((len(paths), 3, h, w), np.float32)
    rc = lib.ug_decode_clip_rgb_f32(_paths_array(paths), len(paths), h, w, _f32p(out), nthreads)
    if rc != 0:
        raise NativeIOError(rc, paths[0])
    return out


def decode_clip_depth(paths: Sequence[str], scale: float, nthreads: int = 0) -> np.ndarray:
    """Clip of grayscale-PNG depth frames -> [N,H,W] float32 (codes / scale)."""
    lib = _lib_or_raise()
    h, w, _ = image_info(paths[0])
    out = np.empty((len(paths), h, w), np.float32)
    rc = lib.ug_decode_clip_depth_f32(_paths_array(paths), len(paths), h, w, float(scale),
                                      _f32p(out), nthreads)
    if rc != 0:
        raise NativeIOError(rc, paths[0])
    return out


def decode_clip_normal(paths: Sequence[str], nthreads: int = 0) -> np.ndarray:
    """Clip of RGB-coded normal maps -> [N,3,H,W] float32 in [-1, 1], pixels
    whose three codes are all 0 set to 0."""
    lib = _lib_or_raise()
    h, w, _ = image_info(paths[0])
    out = np.empty((len(paths), 3, h, w), np.float32)
    rc = lib.ug_decode_clip_normal_f32(_paths_array(paths), len(paths), h, w, _f32p(out),
                                       nthreads)
    if rc != 0:
        raise NativeIOError(rc, paths[0])
    return out
