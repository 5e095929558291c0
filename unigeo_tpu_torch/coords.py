"""Coordinate conventions: the part of ``unigeo_tpu/coords.py`` that the
depth and normal path and the clip datasets use (numpy).

OpenCV camera frame: +x right, +y down, +z forward; OpenGL: +y up, -z
forward.  Clip samples store geometry in OpenGL; predictions and GT labels
for the metrics are OpenCV, except normals, which stay OpenGL on both sides.
"""

from __future__ import annotations

import numpy as np
import torch

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


def flip_yz_channels_last(pts: np.ndarray) -> np.ndarray:
    """Flip y, z of points stored channels-last [..., 3]."""
    return pts * GL_CV_DIAG3


def convert_pose_gl_cv(pose: np.ndarray) -> np.ndarray:
    """F @ P @ F with the GL<->CV flip (its own inverse)."""
    f = OPENGL_TO_OPENCV.astype(pose.dtype)
    return f @ pose @ f


def se3_inverse(pose):
    """[R t; 0 1]^-1 = [R^T -R^T t; 0 1] for [..., 4, 4], numpy or torch
    (on the tensor's device, the product elementwise, so in f32 whatever
    the TF32 flags)."""
    if isinstance(pose, torch.Tensor):
        rt = pose[..., :3, :3].transpose(-1, -2)
        top = torch.cat([rt, -(rt * pose[..., None, :3, 3]).sum(-1, keepdim=True)], dim=-1)
        bottom = torch.zeros_like(pose[..., :1, :])
        bottom[..., 0, 3] = 1.0
        return torch.cat([top, bottom], dim=-2)
    r = pose[..., :3, :3]
    t = pose[..., :3, 3:]
    rt = np.swapaxes(r, -1, -2)
    top = np.concatenate([rt, -rt @ t], axis=-1)
    bottom = np.broadcast_to(
        np.asarray([0.0, 0.0, 0.0, 1.0], dtype=top.dtype), pose.shape[:-2] + (1, 4)
    )
    return np.concatenate([top, bottom], axis=-2)


def rebase_to_keyview(extrinsics: np.ndarray, keyview_idx: int = 0) -> np.ndarray:
    """World-to-camera [N, 4, 4] re-expressed so that the keyview is the world."""
    return extrinsics @ se3_inverse(extrinsics[keyview_idx])


def relative_transform(ref_w2c: np.ndarray, src_w2c: np.ndarray) -> np.ndarray:
    """The transform taking src-camera coordinates to ref-camera coordinates."""
    return ref_w2c @ se3_inverse(src_w2c)


def intrinsics_resize_scale(orig_hw, new_hw, dtype=np.float32) -> np.ndarray:
    """Elementwise scale of K when an image is resized from orig_hw to new_hw."""
    oh, ow = orig_hw
    nh, nw = new_hw
    return np.array([[nw / ow] * 3, [nh / oh] * 3, [1.0] * 3], dtype=dtype)
