"""Visualization, port of ``unigeo_tpu/utils/vis.py``: the binary PLY point
clouds of ``vis_pcd`` (``save_point_cloud``, ``load_point_cloud``), the
depth and normal strips of ``vis_depth`` (``colorize``, ``normal_to_rgb``,
``save_depth_normal_maps``) and the generic image helpers (``vis_2d_array``,
``vis_image``, ``overlay_text``, ``tile_images``), which take numpy arrays
or tensors on any device.  matplotlib and PIL are imported inside the
functions that need them, so the module imports without them.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from unigeo_tpu_torch.device import to_host


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


def load_point_cloud(path: str):
    """(points [N, 3] f32, colours [N, 3] uint8 or None) of a binary
    little-endian PLY as ``save_point_cloud`` writes it (y and z as
    stored)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode().strip()
            header.append(line)
            if line == "end_header":
                break
        n = int(next(h for h in header if h.startswith("element vertex")).split()[-1])
        if any("uchar" in h for h in header):
            rec = np.frombuffer(f.read(n * 15), dtype=[("xyz", np.float32, 3),
                                                        ("rgb", np.uint8, 3)])
            return rec["xyz"].copy(), rec["rgb"].copy()
        return np.frombuffer(f.read(n * 12), dtype="<f4").reshape(n, 3).copy(), None


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


# --- generic tensor -> image helpers --------------------------------------------


def vis_2d_array(arr, cmap: str = "Spectral_r", vmin: Optional[float] = None,
                 vmax: Optional[float] = None, mask=None) -> np.ndarray:
    """[H, W] scalars -> [H, W, 3] uint8 through a matplotlib colormap; the
    range defaults to the finite (and masked-in) values' extent, and NaN,
    inf and masked-out pixels are black."""
    a = to_host(arr).astype(np.float64)
    valid = np.isfinite(a)
    if mask is not None:
        valid &= to_host(mask) > 0
    if vmin is None:
        vmin = float(a[valid].min()) if valid.any() else 0.0
    if vmax is None:
        vmax = float(a[valid].max()) if valid.any() else 1.0
    rgb = colorize(np.where(valid, a, vmin), vmin=vmin, vmax=vmax, cmap=cmap)
    return np.where(valid[..., None], rgb, 0).astype(np.uint8)


def vis_image(img) -> np.ndarray:
    """[3, H, W], [H, W, 3] or [H, W], float in 0..1 or 0..255 or uint8 ->
    [H, W, 3] uint8."""
    a = to_host(img)
    if a.ndim == 3 and a.shape[0] in (1, 3) and a.shape[-1] not in (1, 3):
        a = np.moveaxis(a, 0, -1)
    if a.ndim == 2:
        a = np.repeat(a[..., None], 3, axis=-1)
    if a.shape[-1] == 1:
        a = np.repeat(a, 3, axis=-1)
    if a.dtype != np.uint8:
        amax = np.nanmax(a) if a.size else 1.0
        scale = 255.0 if amax <= 1.0 + 1e-6 else 1.0
        a = np.clip(np.nan_to_num(a) * scale, 0, 255).astype(np.uint8)
    return a


def overlay_text(img, text: str, color=(255, 255, 255)) -> np.ndarray:
    """``vis_image(img)`` with a small label at the top left (PIL's default
    font)."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(vis_image(img))
    ImageDraw.Draw(im).text((2, 2), text, fill=tuple(color))
    return np.asarray(im)


def tile_images(images, cols: Optional[int] = None, labels=None, pad: int = 2,
                pad_value: int = 0) -> np.ndarray:
    """A list or batch of images -> one [H', W', 3] uint8 mosaic, each cell
    padded to the largest image (about square unless ``cols`` is given)."""
    imgs = [vis_image(im) for im in images]
    if labels is not None:
        imgs = [overlay_text(im, str(lb)) for im, lb in zip(imgs, labels)]
    n = len(imgs)
    if n == 0:
        return np.zeros((1, 1, 3), np.uint8)
    cols = cols or int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    th = max(im.shape[0] for im in imgs) + pad
    tw = max(im.shape[1] for im in imgs) + pad
    out = np.full((rows * th + pad, cols * tw + pad, 3), pad_value, np.uint8)
    for i, im in enumerate(imgs):
        r, c = divmod(i, cols)
        y, x = r * th + pad, c * tw + pad
        out[y:y + im.shape[0], x:x + im.shape[1]] = im
    return out
