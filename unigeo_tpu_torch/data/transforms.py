"""Host-side clip transforms, port of ``unigeo_tpu/data/transforms.py``.

Images get a bilinear resize (PIL, imported only when a resize runs) with
the intrinsics rescaled elementwise; geometric targets (cam/world coord and
normal, mask) get a nearest-neighbour resize, so values are never
interpolated across depth edges.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from unigeo_tpu_torch import coords


def _nearest_indices(new_len: int, orig_len: int) -> np.ndarray:
    src = (np.arange(new_len) + 0.5) * (orig_len / new_len) - 0.5
    return np.clip(np.round(src).astype(np.int64), 0, orig_len - 1)


def resize_nearest(arr: np.ndarray, size) -> np.ndarray:
    """Nearest-neighbour resize of the trailing two axes."""
    ht, wd = size
    oh, ow = arr.shape[-2:]
    if (oh, ow) == (ht, wd):
        return arr
    yi = _nearest_indices(ht, oh)
    xi = _nearest_indices(wd, ow)
    return arr[..., yi[:, None], xi[None, :]]


def resize_bilinear_chw(img: np.ndarray, size) -> np.ndarray:
    """Bilinear resize of a [C, H, W] float image through PIL."""
    ht, wd = size
    c, oh, ow = img.shape
    if (oh, ow) == (ht, wd):
        return img
    from PIL import Image

    out = np.empty((c, ht, wd), dtype=np.float32)
    for i in range(c):
        ch = Image.fromarray(np.ascontiguousarray(img[i], dtype=np.float32), mode="F")
        out[i] = np.asarray(ch.resize((wd, ht), Image.BILINEAR), dtype=np.float32)
    return out


class ResizeInputs:
    """Resize stacked images [Nf,3,H,W] and rescale the intrinsics."""

    def __init__(self, size):
        self.size = tuple(size)

    def __call__(self, sample: Dict) -> Dict:
        images = sample["images"]
        oh, ow = images.shape[-2:]
        if (oh, ow) != self.size:
            sample["images"] = np.stack([resize_bilinear_chw(im, self.size) for im in images])
            scale = coords.intrinsics_resize_scale((oh, ow), self.size)
            sample["intrinsics"] = sample["intrinsics"] * scale
        return sample


class ResizeTargets:
    """Nearest resize of the geometric targets."""

    ATTRS = ("cam_normal", "world_normal", "cam_coord", "world_coord", "mask")

    def __init__(self, size):
        self.size = tuple(size)

    def __call__(self, sample: Dict) -> Dict:
        for attr in self.ATTRS:
            if attr in sample:
                sample[attr] = np.ascontiguousarray(resize_nearest(sample[attr], self.size))
        return sample
