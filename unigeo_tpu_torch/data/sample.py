"""The clip-sample contract and GT-label preparation, port of
``unigeo_tpu/data/sample.py`` (``validate_sample``, ``prepare_gt_label``).

The clip sample is a dict of dense [Nf, ...] arrays in OpenGL convention
(images 0..255, intrinsics, extrinsics world-to-camera rebased to frame 0,
cam/world coords and normals channels-first, mask); the labels are
channels-last OpenCV arrays, except normals, which stay OpenGL.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from unigeo_tpu_torch import coords

SAMPLE_KEYS = (
    "scene_name",
    "images",
    "intrinsics",
    "extrinsics",
    "cam_coord",
    "cam_normal",
    "world_coord",
    "world_normal",
    "mask",
    "keyview_idx",
)


def validate_sample(data: Dict[str, Any]) -> None:
    """Raise ``KeyError`` for a missing key and ``ValueError`` for an array
    whose shape breaks the contract (the evaluator's ``strict`` check)."""
    missing = [k for k in SAMPLE_KEYS if k not in data]
    if missing:
        raise KeyError(f"clip sample missing keys: {missing}")
    nf = data["images"].shape[0]
    h, w = data["images"].shape[-2:]
    expect = {
        "images": (nf, 3, h, w),
        "intrinsics": (nf, 3, 3),
        "extrinsics": (nf, 4, 4),
        "cam_coord": (nf, 3, h, w),
        "cam_normal": (nf, 3, h, w),
        "world_coord": (nf, 3, h, w),
        "world_normal": (nf, 3, h, w),
        "mask": (nf, h, w),
    }
    for key, shape in expect.items():
        got = tuple(data[key].shape)
        if got != shape:
            raise ValueError(f"{key}: expected shape {shape}, got {got}")


def prepare_gt_label(data: Dict[str, Any]) -> Dict[str, np.ndarray]:
    extr = np.asarray(data["extrinsics"], np.float32)  # [Nf,4,4] w2c GL
    c2w_cv = coords.convert_pose_gl_cv(coords.se3_inverse(extr))
    world_pts = coords.flip_yz_channels_first(np.asarray(data["world_coord"], np.float32))
    cam_pts = coords.flip_yz_channels_first(np.asarray(data["cam_coord"], np.float32))
    return {
        "gt_world_pts": np.moveaxis(world_pts, 1, -1),
        "gt_masks": np.asarray(data["mask"]) > 0,
        "gt_poses": c2w_cv,
        "gt_depths": np.moveaxis(cam_pts, 1, -1)[..., 2],  # camera z in CV
        "gt_rgbs": np.moveaxis(np.asarray(data["images"], np.float32), 1, -1) / 255.0,
        "gt_normals": np.moveaxis(np.asarray(data["cam_normal"], np.float32), 1, -1),
    }
