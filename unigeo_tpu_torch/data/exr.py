"""Minimal native OpenEXR scanline codec (reader + writer).

MatrixCity ships its ground-truth depth as single-channel ``.exr`` files;
the reference framework has no matrixcity loader (the row is unchecked in
dataset/Readme.md:4) and this environment has no OpenEXR/imageio binding,
so the subset of the format those files actually use is implemented here
natively:

  * single-part scanline images (version field 2, no tiles/deep/multipart),
  * NONE / ZIPS / ZIP compression (zlib deflate over OpenEXR's
    byte-reorder + delta predictor, ImfZip.cpp semantics, including the
    store-raw fallback when deflate does not shrink a chunk),
  * HALF / FLOAT / UINT channels, any channel count, alphabetical chlist
    order, increasing-Y line order, xSampling == ySampling == 1.

The writer exists for test fixtures and the preprocessing tools; it always
emits exactly the subset above.

Format layout per the OpenEXR file-format notes: magic ``20000630`` int32,
version int32, attribute list (``name\\0 type\\0 int32-size payload``)
terminated by an empty name, a uint64 chunk-offset table, then per chunk
``int32 y, int32 size, data`` where the uncompressed payload is scanline-
major and channel-major-within-scanline in chlist order.

A copy of ``unigeo_tpu/data/exr.py`` (numpy and zlib only).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

_MAGIC = 20000630
# compression enum (ImfCompression.h): lines-per-chunk for the supported set
_LINES_PER_CHUNK = {0: 1, 2: 1, 3: 16}  # NONE, ZIPS, ZIP
_COMPRESSION_NAMES = {"NONE": 0, "ZIPS": 2, "ZIP": 3}
# pixel type enum (ImfPixelType.h)
_PIXEL_DTYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
_PIXEL_CODES = {"UINT": 0, "HALF": 1, "FLOAT": 2}


def _predictor_decode(buf: bytes) -> np.ndarray:
    """Invert OpenEXR's ZIP predictor: delta-decode, then re-interleave the
    two half-buffers (ImfZip.cpp uncompress)."""
    d = np.frombuffer(buf, np.uint8).astype(np.int64)
    # t[0] = d[0]; t[i] = t[i-1] + d[i] - 128  (mod 256) — a prefix sum
    t = np.empty(len(d), np.uint8)
    if len(d):
        t[:] = (d[0] + np.concatenate(([0], np.cumsum(d[1:] - 128)))) & 0xFF
    out = np.empty(len(t), np.uint8)
    half = (len(t) + 1) // 2
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out


def _predictor_encode(raw: np.ndarray) -> bytes:
    """OpenEXR ZIP predictor: split even/odd bytes, then delta-encode
    (ImfZip.cpp compress)."""
    raw = np.ascontiguousarray(raw, np.uint8)
    half = (len(raw) + 1) // 2
    t = np.empty(len(raw), np.uint8)
    t[:half] = raw[0::2]
    t[half:] = raw[1::2]
    d = t.astype(np.int64)
    enc = np.empty(len(t), np.uint8)
    if len(t):
        enc[0] = t[0]
        enc[1:] = (d[1:] - d[:-1] + 384) & 0xFF
    return enc.tobytes()


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        if len(out) != n:
            raise ValueError("truncated EXR file")
        self.pos += n
        return out

    def cstring(self, max_len: int = 256) -> str:
        end = self.data.index(b"\x00", self.pos)
        if end - self.pos > max_len:
            raise ValueError("EXR name too long")
        s = self.data[self.pos : end].decode("latin-1")
        self.pos = end + 1
        return s

    def i32(self) -> int:
        return struct.unpack("<i", self.read(4))[0]


def _parse_channels(payload: bytes):
    r = _Reader(payload)
    channels = []
    while True:
        if payload[r.pos : r.pos + 1] == b"\x00":
            break
        name = r.cstring()
        ptype = r.i32()
        r.read(4)  # pLinear + 3 reserved
        xs, ys = r.i32(), r.i32()
        if (xs, ys) != (1, 1):
            raise ValueError("EXR subsampled channels not supported")
        if ptype not in _PIXEL_DTYPES:
            raise ValueError(f"EXR pixel type {ptype} not supported")
        channels.append((name, ptype))
    return channels


def read_exr(
    path: str, channel: Optional[str] = None
) -> "np.ndarray | Dict[str, np.ndarray]":
    """Read a scanline EXR.

    With ``channel`` given (or a single-channel file), returns that channel
    as a float32 ``[H, W]`` array (UINT channels stay uint32).  Otherwise
    returns ``{name: [H, W]}`` for every channel.
    """
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    if r.i32() != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    version = r.i32()
    if version & 0x200 or version & 0x800 or version & 0x1000:
        raise ValueError(f"{path}: tiled/deep/multipart EXR not supported")

    channels, compression, dw = None, None, None
    while True:
        if data[r.pos : r.pos + 1] == b"\x00":
            r.pos += 1
            break
        name = r.cstring()
        r.cstring()  # attribute type (validated implicitly by use)
        size = r.i32()
        payload = r.read(size)
        if name == "channels":
            channels = _parse_channels(payload)
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            dw = struct.unpack("<4i", payload)
        elif name == "lineOrder" and payload[0] != 0:
            raise ValueError("EXR decreasing/random line order not supported")
    if channels is None or compression is None or dw is None:
        raise ValueError(f"{path}: missing required EXR header attributes")
    if compression not in _LINES_PER_CHUNK:
        raise ValueError(
            f"{path}: EXR compression {compression} not supported "
            "(NONE/ZIPS/ZIP only)"
        )

    x_min, y_min, x_max, y_max = dw
    width, height = x_max - x_min + 1, y_max - y_min + 1
    lpc = _LINES_PER_CHUNK[compression]
    n_chunks = -(-height // lpc)
    r.read(8 * n_chunks)  # offset table (chunks follow in order anyway)

    # bytes per scanline = sum over channels (chlist order within scanline)
    ch_dtypes = [( _PIXEL_DTYPES[pt], name) for name, pt in channels]
    line_bytes = sum(dt.itemsize for dt, _ in ch_dtypes) * width
    out = {name: np.empty((height, width), dt) for dt, name in ch_dtypes}

    for ci in range(n_chunks):
        y = r.i32() - y_min
        size = r.i32()
        payload = r.read(size)
        rows = min(lpc, height - y)
        raw_size = rows * line_bytes
        if compression == 0 or size >= raw_size:
            raw = np.frombuffer(payload, np.uint8)[:raw_size]
        else:
            raw = _predictor_decode(zlib.decompress(payload))
            if len(raw) != raw_size:
                raise ValueError(f"{path}: chunk {ci} decompressed size mismatch")
        off = 0
        for row in range(rows):
            for dt, name in ch_dtypes:
                nbytes = width * dt.itemsize
                out[name][y + row] = np.frombuffer(
                    raw[off : off + nbytes].tobytes(), dt
                )
                off += nbytes

    def _as_float(a):
        return a if a.dtype == np.uint32 else a.astype(np.float32)

    if channel is not None:
        if channel not in out:
            raise KeyError(f"{path}: channel {channel!r} not in {sorted(out)}")
        return _as_float(out[channel])
    if len(out) == 1:
        return _as_float(next(iter(out.values())))
    return {k: _as_float(v) for k, v in out.items()}


def _attr(name: str, type_: str, payload: bytes) -> bytes:
    return (
        name.encode() + b"\x00" + type_.encode() + b"\x00"
        + struct.pack("<i", len(payload)) + payload
    )


def write_exr(
    path: str,
    channels: "np.ndarray | Dict[str, np.ndarray]",
    pixel_type: str = "FLOAT",
    compression: str = "ZIP",
) -> None:
    """Write a scanline EXR (the supported subset; see module docstring).

    ``channels`` is ``{name: [H, W]}`` or a bare ``[H, W]`` array (stored as
    channel ``"Z"``, the conventional depth channel name).
    """
    if not isinstance(channels, dict):
        channels = {"Z": np.asarray(channels)}
    names = sorted(channels)  # chlist must be alphabetical
    ptype = _PIXEL_CODES[pixel_type]
    dt = _PIXEL_DTYPES[ptype]
    arrs = [np.ascontiguousarray(channels[n], dt) for n in names]
    h, w = arrs[0].shape
    for a in arrs:
        if a.shape != (h, w):
            raise ValueError("all EXR channels must share one shape")
    comp = _COMPRESSION_NAMES[compression]
    lpc = _LINES_PER_CHUNK[comp]

    chlist = b""
    for n in names:
        chlist += (
            n.encode() + b"\x00" + struct.pack("<i", ptype)
            + b"\x00\x00\x00\x00" + struct.pack("<ii", 1, 1)
        )
    chlist += b"\x00"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (
        struct.pack("<ii", _MAGIC, 2)
        + _attr("channels", "chlist", chlist)
        + _attr("compression", "compression", bytes([comp]))
        + _attr("dataWindow", "box2i", box)
        + _attr("displayWindow", "box2i", box)
        + _attr("lineOrder", "lineOrder", b"\x00")
        + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
        + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\x00"
    )

    n_chunks = -(-h // lpc)
    chunks = []
    for ci in range(n_chunks):
        y0, rows = ci * lpc, min(lpc, h - ci * lpc)
        raw = b"".join(
            a[y0 + row].tobytes() for row in range(rows) for a in arrs
        )
        if comp == 0:
            payload = raw
        else:
            packed = zlib.compress(_predictor_encode(np.frombuffer(raw, np.uint8)))
            # OpenEXR stores the chunk raw when deflate does not shrink it
            payload = packed if len(packed) < len(raw) else raw
        chunks.append(struct.pack("<ii", y0, len(payload)) + payload)

    table_pos = len(header)
    offset = table_pos + 8 * n_chunks
    table = b""
    for c in chunks:
        table += struct.pack("<Q", offset)
        offset += len(c)
    with open(path, "wb") as f:
        f.write(header + table + b"".join(chunks))
