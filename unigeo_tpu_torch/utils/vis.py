"""Visualization, port of the part of ``unigeo_tpu/utils/vis.py`` the
evaluator calls: the binary PLY point clouds of ``vis_pcd``
(``save_point_cloud``) and the depth and normal strips of ``vis_depth`` (``colorize``, ``normal_to_rgb``,
``save_depth_normal_maps``).  matplotlib and PIL are imported inside the
functions that need them, so the module imports without them.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def save_point_cloud(points: np.ndarray, colors: Optional[np.ndarray], path: str):
    """Write a binary little-endian PLY, y and z flipped (as the reference
    exports, so viewers see the cloud upright); colours in [0, 1] are
    scaled to uint8."""
    pts = np.asarray(points, np.float32).reshape(-1, 3).copy()
    pts[:, 1:] *= -1
    n = pts.shape[0]
    has_color = colors is not None
    if has_color:
        cols = np.asarray(colors).reshape(-1, 3)
        if cols.dtype != np.uint8:
            cols = np.clip(cols * 255.0 if cols.max() <= 1.0 + 1e-6 else cols, 0, 255).astype(
                np.uint8)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {ax}" for ax in "xyz"]
    if has_color:
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
    header += ["end_header"]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if has_color:
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec["xyz"] = pts
            rec["rgb"] = cols
            f.write(rec.tobytes())
        else:
            f.write(pts.astype("<f4").tobytes())


def colorize(value: np.ndarray, vmin: Optional[float] = None, vmax: Optional[float] = None,
             cmap: str = "Spectral_r") -> np.ndarray:
    """[H,W] scalar map -> [H,W,3] uint8 through a matplotlib colormap."""
    import matplotlib

    value = np.asarray(value, np.float32)
    vmin = float(np.nanmin(value)) if vmin is None else vmin
    vmax = float(np.nanmax(value)) if vmax is None else vmax
    norm = (value - vmin) / max(vmax - vmin, 1e-8)
    rgba = matplotlib.colormaps[cmap](np.clip(norm, 0, 1))
    return (rgba[..., :3] * 255).astype(np.uint8)


def normal_to_rgb(normal: np.ndarray) -> np.ndarray:
    """[H,W,3] unit normals in [-1,1] -> uint8 visualization."""
    return ((np.clip(normal, -1, 1) + 1.0) * 0.5 * 255).astype(np.uint8)


def save_depth_normal_maps(depths, normals, save_dir: str, rgbs=None):
    """Per-frame RGB | depth | normal strips, one ``<frame>.webp`` each."""
    from PIL import Image

    os.makedirs(save_dir, exist_ok=True)
    depths = None if depths is None else np.asarray(depths)
    normals = None if normals is None else np.asarray(normals)
    rgbs = None if rgbs is None else np.asarray(rgbs)
    nf = len(depths) if depths is not None else len(normals)
    vmin = float(np.nanmin(depths)) if depths is not None else 0.0
    vmax = float(np.nanmax(depths)) if depths is not None else 1.0
    for i in range(nf):
        panels = []
        if rgbs is not None:
            panels.append((np.clip(rgbs[i], 0, 1) * 255).astype(np.uint8))
        if depths is not None:
            panels.append(colorize(depths[i], vmin, vmax))
        if normals is not None:
            panels.append(normal_to_rgb(normals[i]))
        strip = np.concatenate(panels, axis=1)
        Image.fromarray(strip).save(os.path.join(save_dir, f"{i:04d}.webp"))
