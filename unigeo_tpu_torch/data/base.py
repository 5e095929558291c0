"""Dataset core: clip slicing, postprocessing, sample-list caching.

Port of ``unigeo_tpu/data/base.py`` (numpy).  A concrete dataset provides
``list_scenes``, ``load_scene_index`` and the per-frame readers; this base
slices each scene into clips (sliding windows, the last one padded by
repeating its final frame), backprojects depth into OpenGL camera points,
rebases geometry to the keyview and builds the validity mask.

Files are decoded frame by frame in Python (``PIL`` is imported only where a
file is decoded); ``_native_clip`` returns None until the C++ clip reader is
ported with the eval driver.  A ``root`` of None is kept as given: the
``paths.toml`` root lookup belongs to the disk loaders, not ported yet.
"""

from __future__ import annotations

import hashlib
import json
import os
import os.path as osp
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from unigeo_tpu_torch import coords
from unigeo_tpu_torch.data.transforms import ResizeInputs, ResizeTargets
from unigeo_tpu_torch.ops.backproject import backproject_to_cv_position
from unigeo_tpu_torch.ops.normals import surface_normals_from_points


class SceneIndex:
    """Per-scene frame index: paths and cameras, before clip slicing."""

    def __init__(
        self,
        scene_name: str,
        rgb_paths: Sequence[str],
        depth_paths: Sequence[str],
        extrinsics: np.ndarray,  # [N,4,4] world-to-camera, OpenGL convention
        intrinsics: np.ndarray,  # [N,3,3]
        normal_paths: Optional[Sequence[str]] = None,
    ):
        n = len(rgb_paths)
        if len(depth_paths) != n or len(extrinsics) != n or len(intrinsics) != n:
            raise ValueError("depth paths and cameras must align with the rgb paths")
        if normal_paths is not None and len(normal_paths) != n:
            raise ValueError("normal paths must align with the rgb paths")
        self.scene_name = scene_name
        self.rgb_paths = list(rgb_paths)
        self.depth_paths = list(depth_paths)
        self.normal_paths = list(normal_paths) if normal_paths is not None else None
        self.extrinsics = np.asarray(extrinsics, np.float32)
        self.intrinsics = np.asarray(intrinsics, np.float32)

    def subsample(self, gap: int) -> "SceneIndex":
        """Every gap-th frame."""
        if gap <= 1:
            return self
        return SceneIndex(
            self.scene_name,
            self.rgb_paths[::gap],
            self.depth_paths[::gap],
            self.extrinsics[::gap],
            self.intrinsics[::gap],
            self.normal_paths[::gap] if self.normal_paths is not None else None,
        )


def slice_clips(num_frames: int, clip_length: int, clip_overlap: int) -> List[List[int]]:
    """Sliding windows with stride (length - overlap); the last clip pads by
    repeating its final frame.  With overlap > 0 a final window whose fresh
    frames were already covered is still emitted, as the reference does."""
    stride = clip_length - clip_overlap
    if stride <= 0:
        raise ValueError("clip_overlap must be smaller than clip_length")
    clips = []
    for start in range(0, num_frames, stride):
        group = list(range(start, min(start + clip_length, num_frames)))
        if len(group) < clip_length:
            group += [group[-1]] * (clip_length - len(group))
        clips.append(group)
    return clips


class ClipDataset:
    """Base class of the clip datasets.

    Subclasses set ``base_dataset`` (cache key name), ``frame_gap``,
    ``depth_scale`` (divisor), ``depth_clamp`` (min, max meters) and
    ``native_normals``, and implement ``list_scenes``, ``load_scene_index``
    and, for other files than the stock ones, the per-frame readers.  A
    dataset without normal maps gets plane-fit normals of its camera points
    (``compute_normals_if_missing``, default on, as in the JAX package), or
    zeros when that is off.  The RGB-to-depth-resolution resize comes with
    the disk loaders that need it.
    """

    base_dataset = "base"
    frame_gap = 1
    depth_scale = 1000.0
    depth_clamp = (1e-3, 20.0)
    native_normals = False

    def __init__(
        self,
        root: Optional[str],
        split: str = "test",
        clip_length: int = 30,
        clip_overlap: int = 0,
        input_size=None,
        target_size=None,
        cache_dir: Optional[str] = None,
        compute_normals_if_missing: bool = True,
        **_: Dict,
    ):
        self.root = root
        self.compute_normals_if_missing = compute_normals_if_missing
        self.split = split
        self.clip_length = clip_length
        self.clip_overlap = clip_overlap
        self.input_resize = ResizeInputs(input_size) if input_size else None
        self.target_resize = ResizeTargets(target_size) if target_size else None
        self.cache_dir = cache_dir or osp.join(osp.dirname(osp.abspath(__file__)), "sample_lists")
        self.samples: List[Dict] = []  # each: {scene, frame_ids}
        self._scenes: Dict[str, SceneIndex] = {}
        self._init_samples()

    # --- indexing ---------------------------------------------------------

    @property
    def name(self) -> str:
        return f"{self.base_dataset}.{self.split}"

    def _cache_path(self, scenes: Sequence[str]) -> str:
        # keyed on the root and the scene list, so a cache of another data
        # setup is never reused
        tag = hashlib.sha1(json.dumps([self.root, list(scenes)]).encode()).hexdigest()[:10]
        return osp.join(
            self.cache_dir,
            f"{self.name}_clip{self.clip_length}_overlap{self.clip_overlap}_{tag}.json",
        )

    def _init_samples(self) -> None:
        scenes = self.list_scenes(self.split)
        path = self._cache_path(scenes)
        if osp.isfile(path):
            with open(path) as f:
                self.samples = json.load(f)
            return
        for scene_name in scenes:
            index = self._scene(scene_name)
            for clip in slice_clips(len(index.rgb_paths), self.clip_length, self.clip_overlap):
                self.samples.append({"scene": scene_name, "frame_ids": clip})
        try:
            os.makedirs(self.cache_dir, exist_ok=True)
            with open(path, "w") as f:
                json.dump(self.samples, f)
        except OSError:
            pass

    def _scene(self, scene_name: str) -> SceneIndex:
        if scene_name not in self._scenes:
            self._scenes[scene_name] = self.load_scene_index(scene_name).subsample(self.frame_gap)
        return self._scenes[scene_name]

    def __len__(self) -> int:
        return len(self.samples)

    # --- subclass hooks ---------------------------------------------------

    def list_scenes(self, split: str) -> List[str]:
        raise NotImplementedError

    def load_scene_index(self, scene_name: str) -> SceneIndex:
        raise NotImplementedError

    def load_image(self, path: str) -> np.ndarray:
        """RGB file -> [3, H, W] float32 0..255."""
        from PIL import Image

        img = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32)
        return img.transpose(2, 0, 1)

    def load_depth(self, path: str) -> np.ndarray:
        """Depth file -> [H, W] float32 meters."""
        from PIL import Image

        return np.asarray(Image.open(path), dtype=np.float32) / self.depth_scale

    def load_normal(self, path: str) -> np.ndarray:
        """Normal map file -> [3, H, W] float32 in [-1, 1], OpenGL camera frame;
        zero-vector pixels (all channels < 1e-3) become 0."""
        from PIL import Image

        raw = np.asarray(Image.open(path), dtype=np.float32)
        invalid = np.all(raw < 1e-3, axis=2)
        normal = raw / 255.0 * 2.0 - 1.0
        normal[invalid] = 0
        return normal.astype(np.float32).transpose(2, 0, 1)

    # --- clip assembly ----------------------------------------------------

    def _native_clip(self, kind: str, paths: List[str]):
        """A whole clip from the native reader, or None for the per-frame
        Python readers.  The native reader is not ported yet: always None."""
        return None

    def __getitem__(self, index: int) -> Dict:
        rec = self.samples[index]
        scene = self._scene(rec["scene"])
        ids = rec["frame_ids"]

        rgb_paths = [self._abs(scene.rgb_paths[i]) for i in ids]
        images = self._native_clip("rgb", rgb_paths)
        if images is None:
            images = np.stack([self.load_image(p) for p in rgb_paths])
        intrinsics = scene.intrinsics[ids].copy()
        extrinsics = scene.extrinsics[ids].copy()

        depth_paths = [self._abs(scene.depth_paths[i]) for i in ids]
        depths = self._native_clip("depth", depth_paths)
        if depths is None:
            depths = [self.load_depth(p) for p in depth_paths]
        cam_coord = np.stack(
            [self._depth_to_gl_points(d, intrinsics[k]) for k, d in enumerate(depths)]
        )  # [Nf,3,H,W] OpenGL camera points

        if self.native_normals and scene.normal_paths is not None:
            normal_paths = [self._abs(scene.normal_paths[i]) for i in ids]
            cam_normal = self._native_clip("normal", normal_paths)
            if cam_normal is None:
                cam_normal = np.stack([self.load_normal(p) for p in normal_paths])
        elif self.compute_normals_if_missing:
            # 5x5 plane fit of the OpenGL camera points, as the JAX package
            pts_last = torch.from_numpy(np.ascontiguousarray(np.moveaxis(cam_coord, 1, -1)))
            nrm = surface_normals_from_points(pts_last).numpy()
            cam_normal = np.moveaxis(nrm, -1, 1).astype(np.float32)
        else:
            cam_normal = np.zeros_like(cam_coord)

        sample = {
            "scene_name": rec["scene"].replace("/", "_"),
            "images": images,
            "image_names": [osp.basename(scene.rgb_paths[i]) for i in ids],
            "intrinsics": intrinsics,
            "extrinsics": extrinsics,
            "cam_coord": cam_coord,
            "cam_normal": cam_normal,
            "keyview_idx": 0,
            "_index": index,
            "_dataset": self.name,
        }
        sample = self.postprocess(sample)
        if self.input_resize is not None:
            sample = self.input_resize(sample)
        if self.target_resize is not None:
            sample = self.target_resize(sample)
        return sample

    def _abs(self, path: str) -> str:
        return path if osp.isabs(path) or self.root is None else osp.join(self.root, path)

    def _depth_to_gl_points(self, depth: np.ndarray, K: np.ndarray) -> np.ndarray:
        """[H,W] depth -> [3,H,W] OpenGL camera points."""
        pos = backproject_to_cv_position(torch.from_numpy(depth), torch.from_numpy(K)).numpy()
        return np.moveaxis(coords.flip_yz_channels_last(pos), -1, 0).astype(np.float32)

    def postprocess(self, sample: Dict) -> Dict:
        """Rebase geometry to the keyview and build the validity mask."""
        key = sample["keyview_idx"]
        extr = sample["extrinsics"]  # [Nf,4,4] w2c GL
        ref_pose = extr[key]
        trans = np.stack(
            [coords.relative_transform(ref_pose, extr[i]) for i in range(len(extr))]
        )  # [Nf,4,4] src-cam -> keyview

        cam_coord = sample["cam_coord"]  # [Nf,3,H,W]
        cam_normal = sample["cam_normal"]
        nf, _, h, w = cam_coord.shape

        R = trans[:, :3, :3]
        t = trans[:, :3, 3]
        cc = cam_coord.reshape(nf, 3, -1)
        cn = cam_normal.reshape(nf, 3, -1)
        world_coord = (R @ cc + t[..., None]).reshape(nf, 3, h, w)
        world_normal = (R @ cn).reshape(nf, 3, h, w)

        invalid = np.isnan(cam_normal).any(axis=1) | np.isnan(cam_coord).any(axis=1)
        depth = np.nan_to_num(-cam_coord[:, 2])  # OpenGL: depth = -z
        dmin, dmax = self.depth_clamp
        invalid |= (depth < dmin) | (depth > dmax)

        inv4 = invalid[:, None]
        sample.update(
            cam_coord=np.where(inv4, 0.0, np.nan_to_num(cam_coord)).astype(np.float32),
            cam_normal=np.where(inv4, 0.0, np.nan_to_num(cam_normal)).astype(np.float32),
            world_coord=np.where(inv4, 0.0, np.nan_to_num(world_coord)).astype(np.float32),
            world_normal=np.where(inv4, 0.0, np.nan_to_num(world_normal)).astype(np.float32),
            mask=(~invalid).astype(np.float32),
            extrinsics=coords.rebase_to_keyview(extr, key).astype(np.float32),
        )
        return sample
