"""Coordinate conventions: the part of ``unigeo_tpu/coords.py`` that the
depth and normal path uses (numpy).

OpenCV camera frame: +x right, +y down, +z forward; OpenGL: +y up, -z
forward.  Clip samples store geometry in OpenGL; predictions and GT labels
for the metrics are OpenCV, except normals, which stay OpenGL on both sides.
"""

from __future__ import annotations

import numpy as np

OPENGL_TO_OPENCV = np.array(
    [[1.0, 0.0, 0.0, 0.0],
     [0.0, -1.0, 0.0, 0.0],
     [0.0, 0.0, -1.0, 0.0],
     [0.0, 0.0, 0.0, 1.0]],
    dtype=np.float32,
)

GL_CV_DIAG3 = np.array([1.0, -1.0, -1.0], dtype=np.float32)


def flip_yz_channels_first(pts: np.ndarray) -> np.ndarray:
    """Flip y, z of points stored channels-first [..., 3, H, W]."""
    shape = [1] * pts.ndim
    shape[-3] = 3
    return pts * GL_CV_DIAG3.reshape(shape)


def convert_pose_gl_cv(pose: np.ndarray) -> np.ndarray:
    """F @ P @ F with the GL<->CV flip (its own inverse)."""
    f = OPENGL_TO_OPENCV.astype(pose.dtype)
    return f @ pose @ f


def se3_inverse(pose: np.ndarray) -> np.ndarray:
    """[R t; 0 1]^-1 = [R^T -R^T t; 0 1] for [..., 4, 4]."""
    r = pose[..., :3, :3]
    t = pose[..., :3, 3:]
    rt = np.swapaxes(r, -1, -2)
    top = np.concatenate([rt, -rt @ t], axis=-1)
    bottom = np.broadcast_to(
        np.asarray([0.0, 0.0, 0.0, 1.0], dtype=top.dtype), pose.shape[:-2] + (1, 4)
    )
    return np.concatenate([top, bottom], axis=-2)
