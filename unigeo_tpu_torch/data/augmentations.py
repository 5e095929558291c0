"""Train-time augmentations on the stacked clip sample, a copy of
``unigeo_tpu/data/augmentations.py`` on numpy (the same outputs for the same
``np.random.Generator`` seed).

Rebuilds the reference's augmentation set (dataset_core/transforms.py:
113-352 — unused by the eval path but part of the dataset core) on stacked
[Nf, ...] arrays with an explicit np.random.Generator (no hidden global
RNG), and without the cv2/torchvision dependencies:

  SpatialAugmentation  random scale(+stretch) then random crop, intrinsics
                       rescaled/shifted accordingly (:113-224)
  ColorJitter          brightness/contrast/saturation/hue on 0..255 images
                       (:227-242, torchvision semantics)
  NormalizeImagesToMinMax  images → [min, max] range (:245-256)
  Eraser               random rectangles replaced by the image mean
                       (:259-292)
  Scale3DFixed         scale all metric quantities by a constant (:295-320)
  MaskDepth            zero depth/coords outside a validity range (:323-340)
  NormalizeIntrinsics  K → resolution-independent form (:343-352)
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from unigeo_tpu_torch import coords
from unigeo_tpu_torch.data.transforms import resize_bilinear_chw, resize_nearest

_GEOM_KEYS = ("cam_coord", "world_coord", "cam_normal", "world_normal")


class SpatialAugmentation:
    """Random scale (optionally anisotropic) + random crop to a fixed size."""

    def __init__(self, size, p=0.5, stretch_p=0.0, max_stretch=0.2,
                 max_scale=1.6, rng: Optional[np.random.Generator] = None):
        self.size = tuple(size)
        self.p = p
        self.stretch_p = stretch_p
        self.max_stretch = max_stretch
        self.max_scale = max_scale
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample: Dict) -> Dict:
        cht, cwd = self.size
        images = sample["images"]
        ht, wd = images.shape[-2:]
        if self.rng.random() >= self.p:
            # still guarantee the output size via center crop/resize
            return _center_crop_to(sample, self.size)

        min_scale = max((cht + 8) / ht, (cwd + 8) / wd)
        scale = float(np.exp(self.rng.uniform(0.0, 0.5)))
        scale_x = scale_y = min(max(scale, min_scale), self.max_scale)
        if self.rng.random() < self.stretch_p:
            scale_x *= 2 ** self.rng.uniform(-self.max_stretch, self.max_stretch)
            scale_y *= 2 ** self.rng.uniform(-self.max_stretch, self.max_stretch)
            scale_x = max(scale_x, min_scale)
            scale_y = max(scale_y, min_scale)

        sht, swd = int(round(ht * scale_y)), int(round(wd * scale_x))
        sample["images"] = np.stack(
            [resize_bilinear_chw(im, (sht, swd)) for im in images]
        )
        sample["intrinsics"] = sample["intrinsics"] * coords.intrinsics_resize_scale(
            (ht, wd), (sht, swd)
        )
        for key in _GEOM_KEYS + ("mask",):
            if key in sample:
                sample[key] = resize_nearest(sample[key], (sht, swd))

        # +1: integers() is exclusive-high — include the bottom/right-most
        # crop position
        y0 = int(self.rng.integers(0, max(sht - cht, 0) + 1))
        x0 = int(self.rng.integers(0, max(swd - cwd, 0) + 1))
        return _crop(sample, y0, x0, cht, cwd)


def _crop(sample: Dict, y0: int, x0: int, cht: int, cwd: int) -> Dict:
    sample["images"] = np.ascontiguousarray(
        sample["images"][..., y0 : y0 + cht, x0 : x0 + cwd]
    )
    shift = np.array([[0, 0, -x0], [0, 0, -y0], [0, 0, 0]], np.float32)
    sample["intrinsics"] = sample["intrinsics"] + shift
    for key in _GEOM_KEYS + ("mask",):
        if key in sample:
            sample[key] = np.ascontiguousarray(
                sample[key][..., y0 : y0 + cht, x0 : x0 + cwd]
            )
    return sample


def _center_crop_to(sample: Dict, size: Tuple[int, int]) -> Dict:
    cht, cwd = size
    ht, wd = sample["images"].shape[-2:]
    if (ht, wd) == (cht, cwd):
        return sample
    if ht < cht or wd < cwd:
        # input smaller than target: upscale first so the crop below really
        # yields the promised output size
        scale = max(cht / ht, cwd / wd)
        sht, swd = int(np.ceil(ht * scale)), int(np.ceil(wd * scale))
        sample["images"] = np.stack(
            [resize_bilinear_chw(im, (sht, swd)) for im in sample["images"]]
        )
        sample["intrinsics"] = sample["intrinsics"] * coords.intrinsics_resize_scale(
            (ht, wd), (sht, swd)
        )
        for key in _GEOM_KEYS + ("mask",):
            if key in sample:
                sample[key] = resize_nearest(sample[key], (sht, swd))
        ht, wd = sht, swd
    y0 = (ht - cht) // 2
    x0 = (wd - cwd) // 2
    return _crop(sample, y0, x0, cht, cwd)


class ColorJitter:
    """brightness/contrast/saturation/hue jitter on [Nf,3,H,W] 0..255."""

    def __init__(self, brightness=0.2, contrast=0.2, saturation=0.2, hue=0.05,
                 rng: Optional[np.random.Generator] = None):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample: Dict) -> Dict:
        img = sample["images"].astype(np.float32)
        if self.brightness:
            img = img * (1.0 + self.rng.uniform(-self.brightness, self.brightness))
        if self.contrast:
            mean = img.mean(axis=(-2, -1), keepdims=True)
            img = mean + (img - mean) * (
                1.0 + self.rng.uniform(-self.contrast, self.contrast)
            )
        if self.saturation:
            gray = img.mean(axis=-3, keepdims=True)
            img = gray + (img - gray) * (
                1.0 + self.rng.uniform(-self.saturation, self.saturation)
            )
        if self.hue:
            # cheap hue shift: rotate channels toward their mean
            shift = self.rng.uniform(-self.hue, self.hue)
            img = img + shift * (np.roll(img, 1, axis=-3) - img)
        sample["images"] = np.clip(img, 0.0, 255.0)
        return sample


class NormalizeImagesToMinMax:
    def __init__(self, min_val: float = -1.0, max_val: float = 1.0):
        self.min_val = min_val
        self.max_val = max_val

    def __call__(self, sample: Dict) -> Dict:
        img = sample["images"].astype(np.float32) / 255.0
        sample["images"] = img * (self.max_val - self.min_val) + self.min_val
        return sample


class Eraser:
    """Random rectangles replaced by the per-frame channel mean."""

    def __init__(self, p=0.5, max_boxes=2, box_size=(30, 100),
                 rng: Optional[np.random.Generator] = None):
        self.p = p
        self.max_boxes = max_boxes
        self.box_size = box_size
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample: Dict) -> Dict:
        if self.rng.random() >= self.p:
            return sample
        images = sample["images"]
        nf, _, h, w = images.shape
        for i in range(nf):
            mean = images[i].mean(axis=(-2, -1), keepdims=True)
            for _ in range(int(self.rng.integers(1, self.max_boxes + 1))):
                bw = int(self.rng.integers(self.box_size[0], self.box_size[1] + 1))
                bh = int(self.rng.integers(self.box_size[0], self.box_size[1] + 1))
                x0 = int(self.rng.integers(0, max(w - bw, 1)))
                y0 = int(self.rng.integers(0, max(h - bh, 1)))
                images[i][:, y0 : y0 + bh, x0 : x0 + bw] = mean
        sample["images"] = images
        return sample


class Scale3DFixed:
    """Scale every metric quantity by a constant factor."""

    def __init__(self, scale: float):
        self.scale = scale

    def __call__(self, sample: Dict) -> Dict:
        for key in ("cam_coord", "world_coord"):
            if key in sample:
                sample[key] = sample[key] * self.scale
        extr = sample.get("extrinsics")
        if extr is not None:
            extr = extr.copy()
            extr[..., :3, 3] *= self.scale
            sample["extrinsics"] = extr
        return sample


class MaskDepth:
    """Zero geometry outside a depth range (OpenGL: depth = -z)."""

    def __init__(self, min_depth: float, max_depth: float):
        self.min_depth = min_depth
        self.max_depth = max_depth

    def __call__(self, sample: Dict) -> Dict:
        depth = -sample["cam_coord"][:, 2]
        bad = (depth < self.min_depth) | (depth > self.max_depth)
        for key in _GEOM_KEYS:
            if key in sample:
                sample[key] = np.where(bad[:, None], 0.0, sample[key])
        if "mask" in sample:
            sample["mask"] = np.where(bad, 0.0, sample["mask"])
        return sample


class NormalizeIntrinsics:
    """K → resolution-independent (divide by image size)."""

    def __call__(self, sample: Dict) -> Dict:
        h, w = sample["images"].shape[-2:]
        scale = np.array([[1.0 / w] * 3, [1.0 / h] * 3, [1.0] * 3], np.float32)
        sample["intrinsics"] = sample["intrinsics"] * scale
        return sample
