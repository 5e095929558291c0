"""GT-label preparation, port of ``unigeo_tpu/data/sample.py::prepare_gt_label``.

The clip sample is a dict of dense [Nf, ...] arrays in OpenGL convention
(images 0..255, intrinsics, extrinsics world-to-camera rebased to frame 0,
cam/world coords and normals channels-first, mask); the labels are
channels-last OpenCV arrays, except normals, which stay OpenGL.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from unigeo_tpu_torch import coords


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
