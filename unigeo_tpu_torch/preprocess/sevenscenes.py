"""7-Scenes preprocessing: register Kinect depth onto the RGB sensor.

Port of ``unigeo_tpu/preprocess/sevenscenes.py`` (the reference's
dataset/sevenScenes/preprocess.py): back-project with the depth camera's
intrinsics (f = 585), move by the fixed depth -> RGB rig transform, and
z-buffer the points into the RGB frame, on one device.

It follows numpy's arithmetic step by step, so the result is the JAX
package's to the bit on either device: z in float32 (the depth in mm over
1000, a true division also on the card), x and y in
float64 (the int pixel grid minus a float32 principal point promotes),
the rig transform written out elementwise in float64, the pixel indices
rounded half to even (``np.round`` and ``torch.round`` both), and the
z-buffer an ``amin`` scatter of the float32 depths (``np.minimum.at`` on
the float32 buffer stores the float32 minimum), which is exact in any
order.
"""

from __future__ import annotations

import os.path as osp
from glob import glob

import numpy as np
import torch

from unigeo_tpu_torch.device import resolve_device

# Kinect depth intrinsics and the fixed depth -> RGB rig transform of the
# standard 7-Scenes calibration
DEPTH_K = np.array([[585.0, 0, 320.0], [0, 585.0, 240.0], [0, 0, 1]], np.float32)
RGB_K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]], np.float32)
DEPTH_TO_RGB = np.array(
    [
        [1.0, 0.0, 0.0, 0.0240],
        [0.0, 1.0, 0.0, -0.0006],
        [0.0, 0.0, 1.0, -0.0010],
        [0.0, 0.0, 0.0, 1.0],
    ],
    np.float32,
)

INVALID_DEPTH = 65535


def _f64(x, dev) -> torch.Tensor:
    """A float32 (or float64) calibration array's values as float64 on dev."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return x.to(device=dev, dtype=torch.float64)


def register_depth_to_rgb(depth_mm, depth_K=DEPTH_K, rgb_K=RGB_K,
                          depth_to_rgb=DEPTH_TO_RGB, device="cuda") -> torch.Tensor:
    """[H, W] uint16 depth (mm, 65535 = invalid) -> registered [H, W] depth
    in mm (uint16 values, as int32: torch's uint16 takes few operations) on
    ``device``."""
    dev = resolve_device(device)
    if not isinstance(depth_mm, torch.Tensor):
        depth_mm = torch.from_numpy(np.asarray(depth_mm).astype(np.int32))
    depth_mm = depth_mm.to(device=dev, dtype=torch.int32)
    h, w = depth_mm.shape
    dk, rk, rig = _f64(depth_K, dev), _f64(rgb_K, dev), _f64(depth_to_rgb, dev)
    # divided by a tensor on the device: PyTorch's CUDA division by a host
    # scalar multiplies by its reciprocal, which can round z one ulp away
    # from numpy's quotient (and move a rounded pixel index)
    z = depth_mm.to(torch.float32) / torch.tensor(1000.0, device=dev)
    valid = (depth_mm > 0) & (depth_mm != INVALID_DEPTH)

    v, u = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float64),
                          torch.arange(w, device=dev, dtype=torch.float64), indexing="ij")
    zd = z.to(torch.float64)
    x = (u - dk[0, 2]) * zd / dk[0, 0]
    y = (v - dk[1, 2]) * zd / dk[1, 1]
    pts = torch.stack([x, y, zd], dim=-1).reshape(-1, 3)[valid.reshape(-1)]

    r, t = rig[:3, :3], rig[:3, 3]
    pts_rgb = (pts[:, None, 0] * r[:, 0] + pts[:, None, 1] * r[:, 1]
               + pts[:, None, 2] * r[:, 2]) + t
    z_rgb = pts_rgb[:, 2]
    front = z_rgb > 1e-6
    pts_rgb, z_rgb = pts_rgb[front], z_rgb[front]
    u_rgb = torch.round(pts_rgb[:, 0] / z_rgb * rk[0, 0] + rk[0, 2]).to(torch.int64)
    v_rgb = torch.round(pts_rgb[:, 1] / z_rgb * rk[1, 1] + rk[1, 2]).to(torch.int64)
    inside = (u_rgb >= 0) & (u_rgb < w) & (v_rgb >= 0) & (v_rgb < h)

    zbuf = torch.full((h * w,), torch.inf, dtype=torch.float32, device=dev)
    flat = v_rgb[inside] * w + u_rgb[inside]
    zbuf.scatter_reduce_(0, flat, z_rgb[inside].to(torch.float32), reduce="amin")

    out = torch.where(torch.isfinite(zbuf), torch.round(zbuf * 1000.0), 0.0)
    return out.reshape(h, w).to(torch.int32)


def process_scene(scene_dir: str, verbose: bool = True, device="cuda") -> int:
    """Register every ``*.depth.png`` in a sequence directory, writing
    ``*.depth.proj.png`` beside it (existing outputs are kept)."""
    from PIL import Image

    dev = resolve_device(device)
    count = 0
    for depth_path in sorted(glob(osp.join(scene_dir, "*.depth.png"))):
        out_path = depth_path.replace(".depth.png", ".depth.proj.png")
        if osp.exists(out_path):
            continue
        depth = np.asarray(Image.open(depth_path), np.uint16)
        registered = register_depth_to_rgb(depth, device=dev)
        Image.fromarray(registered.cpu().numpy().astype(np.uint16)).save(out_path)
        count += 1
        if verbose and count % 100 == 0:
            print(f"  {count} frames registered")
    return count
