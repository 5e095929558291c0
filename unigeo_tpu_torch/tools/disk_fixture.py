"""Write a 7-Scenes-layout scene from the synthetic box renderer.

    python -m unigeo_tpu_torch.tools.disk_fixture ROOT [--frames 45]
        [--height 480 --width 640] [--scene chess/seq-01]

writes ``ROOT/<scene>/frame-%06d.{color.png,depth.proj.png,pose.txt}`` as
``SevenScenesDataset`` reads them, and ``ROOT/splits/test.txt`` naming the
scene (the loader's split file): 8-bit RGB, 16-bit grey depth in
millimetres, and the camera-to-world pose in the OpenCV convention, one
4x4 text matrix a frame.  The frames are rendered with 7-Scenes' own
intrinsics (fx = fy = 525, principal point (320, 240)) scaled to the
requested size, so at 480 x 640 the loader's fixed K describes them
exactly.  The PNGs are encoded with the standard library (``zlib`` and
``struct``, filter 0 on every row), so the tool needs neither PIL nor a
codec library.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import struct
import zlib

import numpy as np

from unigeo_tpu_torch import coords
from unigeo_tpu_torch.data.synthetic import _orbit_pose_gl_w2c, render_box_frame

SEVEN_SCENES_K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]], np.float32)
SEVEN_SCENES_HW = (480, 640)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(pixels: np.ndarray) -> bytes:
    """PNG bytes of [H, W, 3] uint8 (RGB) or [H, W] uint16 (grey) pixels,
    unfiltered rows, one IDAT."""
    if pixels.dtype == np.uint8 and pixels.ndim == 3 and pixels.shape[2] == 3:
        depth, colour = 8, 2
        rows = pixels
    elif pixels.dtype == np.uint16 and pixels.ndim == 2:
        depth, colour = 16, 0
        rows = pixels.astype(">u2")
    else:
        raise ValueError(f"unsupported pixels {pixels.dtype} {pixels.shape}")
    h, w = pixels.shape[:2]
    raw = b"".join(b"\x00" + rows[y].tobytes() for y in range(h))
    header = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def write_png(path: str, pixels: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(pixels))


def frame_intrinsics(h: int, w: int) -> np.ndarray:
    """7-Scenes' K scaled from 480 x 640 to (h, w)."""
    return SEVEN_SCENES_K * coords.intrinsics_resize_scale(SEVEN_SCENES_HW, (h, w))


def write_seven_scenes(root: str, num_frames: int = 45, height: int = 480, width: int = 640,
                       scene: str = "chess/seq-01") -> str:
    """Write one scene of ``num_frames`` rendered frames; returns its directory.
    Depth is stored as round(metres * 1000) in uint16."""
    scene_dir = osp.join(root, scene)
    os.makedirs(scene_dir, exist_ok=True)
    K = frame_intrinsics(height, width)
    for i in range(num_frames):
        w2c_gl = _orbit_pose_gl_w2c(i, num_frames)
        rgb, depth, _ = render_box_frame(w2c_gl, K, height, width)
        stem = osp.join(scene_dir, f"frame-{i:06d}")
        write_png(stem + ".color.png",
                  np.ascontiguousarray(np.moveaxis(np.clip(rgb, 0, 255), 0, -1).astype(np.uint8)))
        write_png(stem + ".depth.proj.png", np.round(depth * 1000.0).astype(np.uint16))
        c2w_cv = coords.convert_pose_gl_cv(coords.se3_inverse(w2c_gl))
        np.savetxt(stem + ".pose.txt", c2w_cv)
    os.makedirs(osp.join(root, "splits"), exist_ok=True)
    with open(osp.join(root, "splits", "test.txt"), "w") as f:
        f.write(scene + "\n")
    return scene_dir


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("root")
    parser.add_argument("--frames", type=int, default=45)
    parser.add_argument("--height", type=int, default=SEVEN_SCENES_HW[0])
    parser.add_argument("--width", type=int, default=SEVEN_SCENES_HW[1])
    parser.add_argument("--scene", default="chess/seq-01")
    args = parser.parse_args(argv)
    print(write_seven_scenes(args.root, args.frames, args.height, args.width, args.scene))


if __name__ == "__main__":
    main()
