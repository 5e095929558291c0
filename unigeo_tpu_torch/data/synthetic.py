"""Synthetic box-scene dataset, port of ``unigeo_tpu/data/synthetic.py``.

A procedural indoor scene with analytically exact depth, normals and poses:
the camera moves on a smooth orbit inside an axis-aligned box room, and
every pixel ray is intersected with the box faces in closed form.  The same
numpy code as the JAX package's, so both give the same samples bit for bit.
It plugs into the port's ``ClipDataset``; the frames are rendered on demand,
so it needs no files (and no PIL, when ``render_size`` equals the config's
``h``, ``w`` and no resize runs).
"""

from __future__ import annotations

import threading
from typing import Dict, List

import numpy as np

from unigeo_tpu_torch import coords
from unigeo_tpu_torch.data.base import ClipDataset, SceneIndex
from unigeo_tpu_torch.registry import DATASETS

# box interior bounds (world, OpenGL convention: y up): x, y, z
_BOX_MIN = np.array([-2.0, -1.5, -2.0])
_BOX_MAX = np.array([2.0, 1.5, 2.0])
_FACE_COLORS = np.array(
    [
        [200, 80, 80],   # +x wall
        [80, 200, 80],   # -x wall
        [80, 80, 200],   # +y ceiling
        [200, 200, 80],  # -y floor
        [200, 80, 200],  # +z wall
        [80, 200, 200],  # -z wall
    ],
    dtype=np.float32,
)


def _look_at_c2w_cv(eye, target, up=(0.0, 1.0, 0.0)):
    """OpenCV camera-to-world: +z forward toward target, +y down."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    up = np.asarray(up, np.float64)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)  # +y down for OpenCV
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = down
    c2w[:3, 2] = fwd
    c2w[:3, 3] = eye
    return c2w.astype(np.float32)


def _orbit_pose_gl_w2c(frame: int, num_frames: int, radius: float = 0.7):
    """World-to-camera extrinsic in OpenGL convention for an interior orbit."""
    phase = 2.0 * np.pi * frame / max(num_frames, 1)
    eye = np.array([radius * np.cos(phase), 0.2 * np.sin(2 * phase), radius * np.sin(phase)])
    target = np.array(
        [1.8 * np.cos(phase + 0.9), 0.3 * np.sin(phase), 1.8 * np.sin(phase + 0.9)]
    )
    c2w_cv = _look_at_c2w_cv(eye, target)
    c2w_gl = coords.convert_pose_gl_cv(c2w_cv)
    return coords.se3_inverse(c2w_gl)


def render_box_frame(w2c_gl: np.ndarray, K: np.ndarray, h: int, w: int):
    """Analytic render of the box interior.

    Returns:
        rgb [3,H,W] float32 0..255, depth [H,W] meters (OpenCV +z),
        normal_cam_gl [3,H,W] unit normals in the OpenGL camera frame.
    """
    c2w_gl = coords.se3_inverse(w2c_gl)
    c2w_cv = coords.convert_pose_gl_cv(c2w_gl)
    R = c2w_cv[:3, :3].astype(np.float64)
    o = c2w_cv[:3, 3].astype(np.float64)

    u, v = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    dirs_cam = np.stack(
        [(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones_like(u, np.float64)],
        axis=-1,
    )  # z-normalized: ray param t IS the OpenCV depth
    # world is OpenGL; convert ray to world-GL: first to world-CV then flip
    dirs_world_cv = dirs_cam @ R.T
    dirs_world = dirs_world_cv * np.array([1.0, -1.0, -1.0])
    o_world = o * np.array([1.0, -1.0, -1.0])

    t_best = np.full((h, w), np.inf)
    face_best = np.zeros((h, w), np.int32)
    for axis in range(3):
        for sign, bound, face in (
            (1, _BOX_MAX[axis], 2 * axis),
            (-1, _BOX_MIN[axis], 2 * axis + 1),
        ):
            d = dirs_world[..., axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (bound - o_world[axis]) / d
            t = np.where(np.abs(d) < 1e-12, np.inf, t)
            t = np.where(t > 1e-6, t, np.inf)
            with np.errstate(invalid="ignore"):
                hit = o_world[None, None] + np.where(np.isfinite(t), t, 0.0)[..., None] * dirs_world
            inside = np.ones((h, w), bool)
            for other in range(3):
                if other == axis:
                    continue
                inside &= (hit[..., other] >= _BOX_MIN[other] - 1e-9) & (
                    hit[..., other] <= _BOX_MAX[other] + 1e-9
                )
            better = inside & (t < t_best)
            t_best = np.where(better, t, t_best)
            face_best = np.where(better, face, face_best)

    depth = np.where(np.isfinite(t_best), t_best, 0.0).astype(np.float32)

    # face normals point into the room (world GL), exact per pixel
    face_normals = np.zeros((6, 3))
    for axis in range(3):
        face_normals[2 * axis, axis] = -1.0  # +bound face points inward
        face_normals[2 * axis + 1, axis] = 1.0
    n_world = face_normals[face_best]  # [H,W,3] world GL
    # world GL → camera GL: rotate by w2c rotation
    n_cam = n_world @ w2c_gl[:3, :3].T
    normal_cam_gl = np.moveaxis(n_cam, -1, 0).astype(np.float32)

    # rgb: face color modulated by a world-space checkerboard
    hit_pt = o_world[None, None] + t_best[..., None] * dirs_world
    checker = (
        np.floor(hit_pt[..., 0] * 2) + np.floor(hit_pt[..., 1] * 2) + np.floor(hit_pt[..., 2] * 2)
    ) % 2
    base = _FACE_COLORS[face_best]
    rgb = base * (0.6 + 0.4 * checker[..., None])
    rgb = np.moveaxis(rgb, -1, 0).astype(np.float32)
    return rgb, depth, normal_cam_gl


@DATASETS.register("SyntheticBoxDataset")
class SyntheticBoxDataset(ClipDataset):
    """Procedural box-room clips with exact GT."""

    base_dataset = "synthetic_box"
    frame_gap = 1
    depth_scale = 1.0
    depth_clamp = (1e-3, 20.0)
    native_normals = True

    def __init__(
        self,
        root=None,
        split: str = "test",
        clip_length: int = 8,
        clip_overlap: int = 0,
        num_scenes: int = 2,
        frames_per_scene: int = 16,
        render_size=(96, 128),
        **kwargs,
    ):
        self.num_scenes = num_scenes
        self.frames_per_scene = frames_per_scene
        self._frame_cache: Dict[str, tuple] = {}
        self._cache_lock = threading.Lock()
        self.render_h, self.render_w = render_size
        fx = 0.9 * self.render_w
        self._K = np.array(
            [
                [fx, 0, self.render_w / 2.0],
                [0, fx, self.render_h / 2.0],
                [0, 0, 1.0],
            ],
            dtype=np.float32,
        )
        kwargs.setdefault("cache_dir", None)
        # never cache synthetic sample lists to the shared dir
        import tempfile

        kwargs["cache_dir"] = kwargs["cache_dir"] or tempfile.mkdtemp(
            prefix="unigeo_synth_"
        )
        super().__init__(
            root=None,
            split=split,
            clip_length=clip_length,
            clip_overlap=clip_overlap,
            **kwargs,
        )

    # ------------------------------------------------------------------

    def list_scenes(self, split: str) -> List[str]:
        return [f"scene{idx:02d}" for idx in range(self.num_scenes)]

    def load_scene_index(self, scene_name: str) -> SceneIndex:
        scene_id = int(scene_name.replace("scene", ""))
        n = self.frames_per_scene
        extr = np.stack(
            [
                _orbit_pose_gl_w2c(f + scene_id * 3, n, radius=0.6 + 0.1 * scene_id)
                for f in range(n)
            ]
        )
        intr = np.repeat(self._K[None], n, axis=0)
        frame_tokens = [f"{scene_name}:{f}" for f in range(n)]
        return SceneIndex(scene_name, frame_tokens, frame_tokens, extr, intr, frame_tokens)

    # per-frame "files" are rendered on demand and memoized; prefetch threads
    # share the cache, so it is read and trimmed under a lock (a render runs
    # outside it, and two threads may render one frame twice)
    def _render(self, token: str):
        with self._cache_lock:
            frame = self._frame_cache.get(token)
        if frame is None:
            scene_name, index = token.split(":")
            w2c = self._scene(scene_name).extrinsics[int(index)]
            frame = render_box_frame(w2c, self._K, self.render_h, self.render_w)
            with self._cache_lock:
                self._frame_cache[token] = frame
                while len(self._frame_cache) > 64:
                    self._frame_cache.pop(next(iter(self._frame_cache)))
        return frame

    def load_image(self, token: str) -> np.ndarray:
        return self._render(token)[0]

    def load_depth(self, token: str) -> np.ndarray:
        return self._render(token)[1]

    def load_normal(self, token: str) -> np.ndarray:
        return self._render(token)[2]

    def _abs(self, path: str) -> str:
        return path  # tokens, not files
