"""On-disk dataset loaders, port of ``unigeo_tpu/data/loaders.py`` (numpy):
the eleven disk datasets under the JAX package's registry names.

One file for all loaders because, as the survey shows (SURVEY.md §2.3), they
differ only in metadata reading + a handful of constants; the clip logic
lives once in ClipDataset.  Behavior references (file:line into the
reference repo) are given per class.

Split lists: the reference bundles split .txt files inside each dataset
package.  Here splits resolve in order: (1) an explicit ``scene_list``
constructor arg; (2) ``<root>/splits/<split>.txt``; (3) every directory
under root (sorted) as a fallback — so the loaders run against any standard
dataset layout without repo-bundled metadata.
"""

from __future__ import annotations

import os
import os.path as osp
import re
from glob import glob
from typing import List, Optional

import numpy as np

from unigeo_tpu_torch import coords
from unigeo_tpu_torch.data.base import ClipDataset, SceneIndex
from unigeo_tpu_torch.data.trajectories import (
    associate_timestamps,
    read_dpt,
    read_matrix_trajectory,
    read_sintel_cam,
    read_tum_trajectory,
)
from unigeo_tpu_torch.registry import DATASETS


class _DiskClipDataset(ClipDataset):
    """Shared split-resolution logic."""

    def __init__(self, root, scene_list: Optional[List[str]] = None, **kwargs):
        self._scene_list = scene_list
        super().__init__(root=root, **kwargs)

    def list_scenes(self, split: str) -> List[str]:
        if self._scene_list is not None:
            return list(self._scene_list)
        split_file = osp.join(self.root, "splits", f"{split}.txt")
        if osp.isfile(split_file):
            with open(split_file) as f:
                return [ln.strip() for ln in f if ln.strip()]
        # fallback: all scene directories under the dataset's scan dir
        scan = self._scene_scan_dir()
        return sorted(
            d for d in os.listdir(scan)
            if osp.isdir(osp.join(scan, d)) and d != "splits"
        )

    def _scene_scan_dir(self) -> str:
        """Directory whose subdirectories are scene names (hook for layouts
        where scenes do not live directly under root, e.g. Sintel)."""
        return self.root

    @staticmethod
    def _filter_valid_poses(poses, *lists):
        """Drop frames whose pose contains NaN/Inf
        (reference: sevenScenes.py:65-68, scannetv2.py:65-68)."""
        ok = ~np.array([not np.isfinite(p).all() for p in poses])
        poses = np.asarray(poses)[ok]
        outs = [[x for x, keep in zip(lst, ok) if keep] for lst in lists]
        return (poses, *outs)


def _numeric_sort(files, pattern):
    def key(f):
        m = re.search(pattern, osp.basename(f))
        return int(m.group(1)) if m else 0

    return sorted(files, key=key)


@DATASETS.register("ScannetPPDataset")
class ScannetPPDataset(_DiskClipDataset):
    """ScanNet++ (processed iPhone+IMU dumps).

    (reference: dataset/scannetpp/scannetpp.py — scene_metadata.npz with
    OpenCV c2w trajectories converted to OpenGL and inverted :51-70, webp
    rgb + webp GT normals + mm png depth, frame gap 3 :25-30, depth clamp
    80 m :163; split names 'train'/'nvs_sem_val' :212)
    """

    base_dataset = "scannetpp"
    frame_gap = 3
    depth_scale = 1000.0
    depth_clamp = (1e-3, 80.0)
    native_normals = True

    def list_scenes(self, split: str) -> List[str]:
        # reference maps test → nvs_sem_val split file name
        if self._scene_list is None:
            name = "train" if split == "train" else "nvs_sem_val"
            split_file = osp.join(self.root, "splits", f"{name}.txt")
            if osp.isfile(split_file):
                with open(split_file) as f:
                    return [ln.strip() for ln in f if ln.strip()]
        return super().list_scenes(split)

    def load_scene_index(self, scene_name: str) -> SceneIndex:
        meta = np.load(osp.join(self.root, scene_name, "scene_metadata.npz"))
        c2w_cv = meta["trajectories"].astype(np.float32)  # [N,4,4] OpenCV c2w
        c2w_gl = coords.convert_pose_gl_cv(c2w_cv)
        w2c_gl = coords.se3_inverse(c2w_gl)
        intr = meta["intrinsics"].astype(np.float32)
        names = [str(n) for n in meta["images"].tolist()]
        return SceneIndex(
            scene_name,
            [osp.join(scene_name, "images", f"{n}.webp") for n in names],
            [osp.join(scene_name, "depth", f"{n}.png") for n in names],
            w2c_gl,
            intr,
            [osp.join(scene_name, "normal", f"{n}.webp") for n in names],
        )


@DATASETS.register("sevenScenesDataset")
class SevenScenesDataset(_DiskClipDataset):
    """7-Scenes with Kinect depth registered onto RGB.

    (reference: dataset/sevenScenes/sevenScenes.py — per-frame *.pose.txt
    c2w conjugated to OpenGL and inverted :53-62, fixed K [525,0,320;0,525,
    240] :53, NaN-pose filtering :65-68, registered depth *.depth.proj.png
    /1000 :124, clamp 20 m :151, gap 1 :24)
    """

    base_dataset = "7scenes"
    frame_gap = 1
    depth_scale = 1000.0
    depth_clamp = (1e-3, 20.0)
    K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]], np.float32)

    def load_scene_index(self, scene_name: str) -> SceneIndex:
        scene_dir = osp.join(self.root, scene_name)
        rgb = sorted(glob(osp.join(scene_dir, "*.color.png")))
        depth = sorted(glob(osp.join(scene_dir, "*.depth.proj.png")))
        pose_files = sorted(glob(osp.join(scene_dir, "*.pose.txt")))
        c2w_cv = np.stack([np.genfromtxt(p) for p in pose_files]).astype(np.float32)
        c2w_cv, rgb, depth = self._filter_valid_poses(c2w_cv, rgb, depth)
        w2c_gl = coords.se3_inverse(coords.convert_pose_gl_cv(c2w_cv))
        rel = [osp.relpath(p, self.root) for p in rgb]
        reld = [osp.relpath(p, self.root) for p in depth]
        K = np.repeat(self.K[None], len(rel), axis=0)
        return SceneIndex(scene_name, rel, reld, w2c_gl, K)


@DATASETS.register("bonnDataset")
class BonnDataset(_DiskClipDataset):
    """Bonn RGB-D Dynamic.

    (reference: dataset/bonn/bonn.py — TUM groundtruth_110.txt trajectory
    :64-66 conjugated+inverted, fixed K from the dataset page :54-61,
    rgb_110/ + depth_110/ file lists, depth /5000 :128, clamp 20 m :162)
    """

    base_dataset = "bonn"
    frame_gap = 1
    depth_scale = 5000.0
    depth_clamp = (1e-3, 20.0)
    K = np.array(
        [[542.822841, 0, 315.593520], [0, 542.576870, 237.756098], [0, 0, 1]],
        np.float32,
    )

    def load_scene_index(self, scene_name: str) -> SceneIndex:
        scene_dir = osp.join(self.root, scene_name)
        rgb = sorted(glob(osp.join(scene_dir, "rgb_110", "*.png")))
        depth = sorted(glob(osp.join(scene_dir, "depth_110", "*.png")))
        poses_c2w, _ = read_tum_trajectory(osp.join(scene_dir, "groundtruth_110.txt"))
        w2c_gl = coords.se3_inverse(coords.convert_pose_gl_cv(poses_c2w))
        n = min(len(rgb), len(depth), len(w2c_gl))
        rel = [osp.relpath(p, self.root) for p in rgb[:n]]
        reld = [osp.relpath(p, self.root) for p in depth[:n]]
        K = np.repeat(self.K[None], n, axis=0)
        return SceneIndex(scene_name, rel, reld, w2c_gl[:n], K)


@DATASETS.register("replicaDataset")
class ReplicaDataset(_DiskClipDataset):
    """Replica (iMAP/vMAP renders).

    (reference: dataset/replica/replica.py — imap/00/rgb + depth numerically
    sorted :50-62, traj_w_cgl.txt 16-value rows already OpenGL c2w, inverted
    without conjugation :66-81, fixed K fx=fy=600 cx=599.5 cy=339.5 :64-71,
    depth /1000 :130, clamp 20 m :174, gap 3 :24)
    """

    base_dataset = "replica"
    frame_gap = 3
    depth_scale = 1000.0
    depth_clamp = (1e-3, 20.0)
    K = np.array([[600.0, 0, 599.5], [0, 600.0, 339.5], [0, 0, 1]], np.float32)

    def load_scene_index(self, scene_name: str) -> SceneIndex:
        base = osp.join(self.root, scene_name, "imap", "00")
        rgb = _numeric_sort(glob(osp.join(base, "rgb", "*.png")), r"rgb_(\d+)\.png")
        depth = _numeric_sort(
            glob(osp.join(base, "depth", "*.png")), r"depth_(\d+)\.png"
        )
        c2w_gl = read_matrix_trajectory(osp.join(base, "traj_w_cgl.txt"))
        w2c_gl = coords.se3_inverse(c2w_gl)  # already OpenGL: no conjugation
        n = min(len(rgb), len(depth), len(w2c_gl))
        rel = [osp.relpath(p, self.root) for p in rgb[:n]]
        reld = [osp.relpath(p, self.root) for p in depth[:n]]
        K = np.repeat(self.K[None], n, axis=0)
        return SceneIndex(scene_name, rel, reld, w2c_gl[:n], K)


@DATASETS.register("neuralRGBDDataset")
class NeuralRGBDDataset(_DiskClipDataset):
    """NeuralRGBD synthetic scenes.

    (reference: dataset/neuralRGBD/neuralRGBD.py — poses.txt as 4-line
    matrices with 'nan' validity rows :83-103, poses already OpenGL c2w
    inverted to w2c :81, fixed K fx=fy=554.256 :68, images/ + depth/
    numerically sorted, nan_to_num depth /1000 :149, clamp 20 m :182,
    gap 3 :24)
    """

    base_dataset = "neuralrgbd"
    frame_gap = 3
    depth_scale = 1000.0
    depth_clamp = (1e-3, 20.0)
    K = np.array(
        [[554.2562584220408, 0, 320.0], [0, 554.2562584220408, 240.0], [0, 0, 1]],
        np.float32,
    )

    def load_scene_index(self, scene_name: str) -> SceneIndex:
        scene_dir = osp.join(self.root, scene_name)
        rgb = _numeric_sort(glob(osp.join(scene_dir, "images", "*.png")), r"img(\d+)\.png")
        depth = _numeric_sort(glob(osp.join(scene_dir, "depth", "*.png")), r"depth(\d+)\.png")
        with open(osp.join(scene_dir, "poses.txt")) as f:
            lines = f.readlines()
        poses, valid = [], []
        for i in range(0, len(lines), 4):
            if "nan" in lines[i]:
                valid.append(False)
                poses.append(np.eye(4, dtype=np.float32))
            else:
                valid.append(True)
                poses.append(
                    np.asarray(
                        [[float(x) for x in ln.split()] for ln in lines[i : i + 4]],
                        np.float32,
                    )
                )
        poses = np.stack(poses)
        keep = np.asarray(valid)
        n = min(len(rgb), len(depth), len(poses))
        poses, rgb, depth, keep = poses[:n], rgb[:n], depth[:n], keep[:n]
        poses = poses[keep]
        rgb = [p for p, k in zip(rgb, keep) if k]
        depth = [p for p, k in zip(depth, keep) if k]
        w2c_gl = coords.se3_inverse(poses)  # poses already OpenGL c2w
        rel = [osp.relpath(p, self.root) for p in rgb]
        reld = [osp.relpath(p, self.root) for p in depth]
        K = np.repeat(self.K[None], len(rel), axis=0)
        return SceneIndex(scene_name, rel, reld, w2c_gl, K)

    def load_depth(self, path: str) -> np.ndarray:
        from PIL import Image

        depth = np.asarray(Image.open(path), dtype=np.float32)
        return np.nan_to_num(depth) / self.depth_scale  # (reference :149)


@DATASETS.register("ScannetV2Dataset")
class ScannetV2Dataset(_DiskClipDataset):
    """ScanNetV2 (downscaled 270-line dumps).

    (reference: dataset/scannetv2/scannetv2.py — color_270/*.jpg +
    depth_270/*.png, pose_270.txt stacked c2w matrices conjugated+inverted
    :49-75, NaN filtering :65-68, intrinsic/intrinsic_depth.txt 4x4 → 3x3
    :71-74, depth /1000 :119, clamp 20 m :150, gap 2 :23)
    """

    base_dataset = "scannetv2"
    frame_gap = 2
    depth_scale = 1000.0
    depth_clamp = (1e-3, 20.0)
    # reference resizes color_270 jpgs (968x1296) to the depth resolution
    # 480x640 at load (scannetv2.py:108-114)
    rgb_match_depth_resolution = True

    def load_scene_index(self, scene_name: str) -> SceneIndex:
        scene_dir = osp.join(self.root, scene_name)
        rgb = sorted(glob(osp.join(scene_dir, "color_270", "*.jpg")))
        depth = sorted(glob(osp.join(scene_dir, "depth_270", "*.png")))
        c2w_cv = np.genfromtxt(osp.join(scene_dir, "pose_270.txt")).reshape(-1, 4, 4)
        n = min(len(rgb), len(depth), len(c2w_cv))
        c2w_cv, rgb, depth = self._filter_valid_poses(
            c2w_cv[:n].astype(np.float32), rgb[:n], depth[:n]
        )
        w2c_gl = coords.se3_inverse(coords.convert_pose_gl_cv(c2w_cv))
        intr = (
            np.genfromtxt(osp.join(scene_dir, "intrinsic", "intrinsic_depth.txt"))
            .reshape(4, 4)[:3, :3]
            .astype(np.float32)
        )
        rel = [osp.relpath(p, self.root) for p in rgb]
        reld = [osp.relpath(p, self.root) for p in depth]
        K = np.repeat(intr[None], len(rel), axis=0)
        return SceneIndex(scene_name, rel, reld, w2c_gl, K)


@DATASETS.register("tumRGBDDataset")
class TumRGBDDataset(_DiskClipDataset):
    """TUM RGB-D (freiburg1/2/3 sequences, raw download layout).

    The reference declares tumRGBD support (dataset/Readme.md:12) but ships
    no loader; this implements the dataset's published layout: per-scene
    ``rgb.txt`` / ``depth.txt`` / ``groundtruth.txt`` timestamp lists with
    nearest-timestamp association (TUM associate.py semantics, max 0.02 s),
    per-freiburg fixed intrinsics from the dataset page, depth /5000 like
    Bonn (dataset/bonn/bonn.py:128 — Bonn uses the TUM container).  Poses
    are OpenCV c2w TUM rows → conjugated to OpenGL and inverted, exactly the
    Bonn convention (dataset/bonn/bonn.py:64-66).  Frame gap 3 downsamples
    the 30 Hz stream to ~10 Hz, the gap-3 convention of the other dense
    video sets (scannetpp.py:25, replica.py:24, neuralRGBD.py:24).
    """

    base_dataset = "tumrgbd"
    frame_gap = 3
    depth_scale = 5000.0
    depth_clamp = (1e-3, 20.0)
    # fx, fy, cx, cy per camera (TUM RGB-D dataset intrinsics page)
    _K_BY_CAM = {
        "freiburg1": (517.3, 516.5, 318.6, 255.3),
        "freiburg2": (520.9, 521.0, 325.1, 249.7),
        "freiburg3": (535.4, 539.2, 320.1, 247.6),
    }
    _K_DEFAULT = (525.0, 525.0, 319.5, 239.5)  # ROS default K

    @classmethod
    def _intrinsics_for(cls, scene_name: str) -> np.ndarray:
        fx, fy, cx, cy = cls._K_DEFAULT
        for cam, k in cls._K_BY_CAM.items():
            if cam in scene_name:
                fx, fy, cx, cy = k
                break
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)

    @staticmethod
    def _read_file_list(path):
        """``timestamp filename`` rows, '#' comments."""
        stamps, files = [], []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, rel = line.split()[:2]
                stamps.append(float(ts))
                files.append(rel)
        return np.asarray(stamps), files

    def load_scene_index(self, scene_name: str) -> SceneIndex:
        scene_dir = osp.join(self.root, scene_name)
        rgb_ts, rgb_files = self._read_file_list(osp.join(scene_dir, "rgb.txt"))
        dep_ts, dep_files = self._read_file_list(osp.join(scene_dir, "depth.txt"))
        poses_c2w, pose_ts = read_tum_trajectory(
            osp.join(scene_dir, "groundtruth.txt")
        )
        # rgb → depth association, then rgb → pose (associate.py defaults)
        ri, di = associate_timestamps(rgb_ts, dep_ts, max_diff=0.02)
        ri2, pi = associate_timestamps(rgb_ts[ri], pose_ts, max_diff=0.02)
        ri = ri[ri2]
        di = di[ri2]
        rel = [osp.join(scene_name, rgb_files[i]) for i in ri]
        reld = [osp.join(scene_name, dep_files[i]) for i in di]
        w2c_gl = coords.se3_inverse(coords.convert_pose_gl_cv(poses_c2w[pi]))
        K = np.repeat(self._intrinsics_for(scene_name)[None], len(rel), axis=0)
        return SceneIndex(scene_name, rel, reld, w2c_gl, K)


@DATASETS.register("sintelDataset")
class SintelDataset(_DiskClipDataset):
    """MPI-Sintel depth-training split (clean/final pass).

    The reference declares sintel support (dataset/Readme.md:10) and parses
    Sintel .cam trajectories in its evo wrappers (metrics/evo_utils.py:
    18-148) but ships no loader.  Published layout: ``training/<pass>/
    <scene>/frame_%04d.png`` RGB, ``training/depth/<scene>/frame_%04d.dpt``
    float32 z-depth in meters, ``training/camdata_left/<scene>/
    frame_%04d.cam`` with per-frame K [3,3] + OpenCV w2c extrinsic [3,4].
    Depth clamp 80 m (outdoor far-field, same bound as the reference's
    depth-metric gt mask, eval_depth.py:8); the sky's sentinel depths
    (~1e8) fall out via the clamp mask.
    """

    base_dataset = "sintel"
    frame_gap = 1
    depth_scale = 1.0
    depth_clamp = (1e-3, 80.0)

    def __init__(self, root, pass_name: str = "final", **kwargs):
        self.pass_name = pass_name
        super().__init__(root=root, **kwargs)

    def _scene_scan_dir(self) -> str:
        return osp.join(self.root, "training", self.pass_name)

    def load_scene_index(self, scene_name: str) -> SceneIndex:
        img_dir = osp.join(self.root, "training", self.pass_name, scene_name)
        cam_dir = osp.join(self.root, "training", "camdata_left", scene_name)
        dep_dir = osp.join(self.root, "training", "depth", scene_name)
        rgb = _numeric_sort(glob(osp.join(img_dir, "frame_*.png")), r"frame_(\d+)")
        poses, intrinsics = [], []
        for p in rgb:
            stem = osp.splitext(osp.basename(p))[0]
            Kf, E = read_sintel_cam(osp.join(cam_dir, f"{stem}.cam"))
            w2c_cv = np.eye(4, dtype=np.float32)
            w2c_cv[:3] = E
            c2w_cv = coords.se3_inverse(w2c_cv)
            poses.append(coords.se3_inverse(coords.convert_pose_gl_cv(c2w_cv)))
            intrinsics.append(Kf)
        depth = [
            osp.join(dep_dir, osp.splitext(osp.basename(p))[0] + ".dpt")
            for p in rgb
        ]
        rel = [osp.relpath(p, self.root) for p in rgb]
        reld = [osp.relpath(p, self.root) for p in depth]
        return SceneIndex(
            scene_name, rel, reld, np.stack(poses), np.stack(intrinsics)
        )

    def load_depth(self, path: str) -> np.ndarray:
        return read_dpt(path)


@DATASETS.register("interiorNetDataset")
class InteriorNetDataset(_DiskClipDataset):
    """InteriorNet (HD RGB-D sequences).

    The reference declares interiornet support (dataset/Readme.md:3) but
    ships no loader.  Published layout per scene: ``cam0/data/<t>.png``
    640×480 RGB, ``depth0/data/<t>.png`` uint16 depth in mm stored as the
    EUCLIDEAN ray length from the camera center (InteriorNet dataset
    convention), and a ``cam0.render`` ground-truth file of
    ``timestamp eye(3) lookat(3) up(3)`` rows ('#' comments).  Fixed
    pinhole K fx=fy=600 cx=320 cy=240 (dataset release).  Ray lengths are
    converted to planar z-depth with the fixed K before backprojection;
    poses are built directly in the OpenGL convention via look-at
    (right/up/-forward columns), so no CV conjugation is involved.
    """

    base_dataset = "interiornet"
    frame_gap = 1
    depth_scale = 1000.0
    depth_clamp = (1e-3, 20.0)
    euclidean_depth = True
    K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]], np.float32)

    def __init__(self, root, intrinsics=None, **kwargs):
        # custom-calibration renders (and small test fixtures) may override
        # the release K; the euclidean→planar depth conversion uses it too
        if intrinsics is not None:
            self.K = np.asarray(intrinsics, np.float32).reshape(3, 3)
        super().__init__(root=root, **kwargs)

    @staticmethod
    def _lookat_to_c2w_gl(eye, lookat, up) -> np.ndarray:
        f = lookat - eye
        f = f / np.linalg.norm(f)
        s = np.cross(f, up)
        s = s / np.linalg.norm(s)
        u = np.cross(s, f)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0] = s
        c2w[:3, 1] = u
        c2w[:3, 2] = -f  # OpenGL: camera looks down -z
        c2w[:3, 3] = eye
        return c2w

    def load_scene_index(self, scene_name: str) -> SceneIndex:
        scene_dir = osp.join(self.root, scene_name)
        stamps, poses = [], []
        with open(osp.join(scene_dir, "cam0.render")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                vals = [float(x) for x in line.split()]
                if len(vals) < 10:
                    continue
                stamps.append(vals[0])
                poses.append(
                    self._lookat_to_c2w_gl(
                        np.asarray(vals[1:4]), np.asarray(vals[4:7]),
                        np.asarray(vals[7:10]),
                    )
                )
        stamps = np.asarray(stamps)
        rgb = sorted(glob(osp.join(scene_dir, "cam0", "data", "*.png")))
        img_ts = np.asarray([float(osp.splitext(osp.basename(p))[0]) for p in rgb])
        ii, pi = associate_timestamps(img_ts, stamps, max_diff=np.inf)
        rgb = [rgb[i] for i in ii]
        depth = [
            osp.join(scene_dir, "depth0", "data", osp.basename(p)) for p in rgb
        ]
        w2c_gl = coords.se3_inverse(np.stack([poses[i] for i in pi]))
        rel = [osp.relpath(p, self.root) for p in rgb]
        reld = [osp.relpath(p, self.root) for p in depth]
        K = np.repeat(self.K[None], len(rel), axis=0)
        return SceneIndex(scene_name, rel, reld, w2c_gl, K)

    def load_depth(self, path: str) -> np.ndarray:
        from PIL import Image

        d = np.asarray(Image.open(path), dtype=np.float32) / self.depth_scale
        if not self.euclidean_depth:
            return d
        # euclidean ray length → planar z: z = d / |(x̂, ŷ, 1)|; same pixel
        # grid convention as ops/backproject.py (u - cx, no half-pixel)
        h, w = d.shape
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        xs = (np.arange(w, dtype=np.float32) - cx) / fx
        ys = (np.arange(h, dtype=np.float32) - cy) / fy
        norm = np.sqrt(xs[None, :] ** 2 + ys[:, None] ** 2 + 1.0)
        return d / norm


@DATASETS.register("vkittiDataset")
class VKitti2Dataset(_DiskClipDataset):
    """Virtual KITTI 2 (synthetic driving sequences).

    The reference lists vkitti in its dataset checklist (dataset/Readme.md:4,
    unchecked — no loader shipped); this loader completes the roster.
    Published layout (the rgb/depth/textgt tars extracted into one tree):
    ``SceneXX/<variation>/frames/rgb/Camera_0/rgb_%05d.jpg``,
    ``frames/depth/Camera_0/depth_%05d.png`` (uint16 z-depth in CENTIMETERS,
    sky sentinel 655.35 m), and per-variation ``extrinsic.txt`` /
    ``intrinsic.txt`` tables of ``frame cameraID ...`` rows: extrinsics are
    row-major 4x4 OpenCV w2c matrices, intrinsics are ``fx fy cx cy``.
    Scene names are ``SceneXX/<variation>`` paths.  Camera_0 (left) is
    evaluated, matching the monocular protocol of every other loader.
    Depth /100 to meters; clamp 80 m (the reference's outdoor gt bound,
    eval_depth.py:8) masks the sky sentinel out.
    """

    base_dataset = "vkitti"
    frame_gap = 1
    depth_scale = 100.0
    depth_clamp = (1e-3, 80.0)
    camera_id = 0

    def list_scenes(self, split: str) -> List[str]:
        if self._scene_list is not None:
            return list(self._scene_list)
        split_file = osp.join(self.root, "splits", f"{split}.txt")
        if osp.isfile(split_file):
            with open(split_file) as f:
                return [ln.strip() for ln in f if ln.strip()]
        # fallback: Scene*/variation two-level scan
        out = []
        for scene in sorted(os.listdir(self.root)):
            sdir = osp.join(self.root, scene)
            if not osp.isdir(sdir) or scene == "splits":
                continue
            for var in sorted(os.listdir(sdir)):
                if osp.isfile(osp.join(sdir, var, "extrinsic.txt")):
                    out.append(f"{scene}/{var}")
        return out

    def _read_table(self, path):
        """``frame cameraID v...`` rows (header line skipped), filtered to
        self.camera_id, returned as {frame: [v...]} preserving file order."""
        rows = {}
        with open(path) as f:
            for ln in f:
                parts = ln.split()
                if not parts or not parts[0].lstrip("-").isdigit():
                    continue
                frame, cam = int(parts[0]), int(parts[1])
                if cam == self.camera_id:
                    rows[frame] = [float(x) for x in parts[2:]]
        return rows

    def load_scene_index(self, scene_name: str) -> SceneIndex:
        scene_dir = osp.join(self.root, scene_name)
        extr = self._read_table(osp.join(scene_dir, "extrinsic.txt"))
        intr = self._read_table(osp.join(scene_dir, "intrinsic.txt"))
        cam = f"Camera_{self.camera_id}"
        rel, reld, poses, Ks = [], [], [], []
        for frame in sorted(extr):
            if frame not in intr:
                continue
            rgb = osp.join(scene_name, "frames", "rgb", cam, f"rgb_{frame:05d}.jpg")
            dep = osp.join(
                scene_name, "frames", "depth", cam, f"depth_{frame:05d}.png"
            )
            if not osp.isfile(osp.join(self.root, rgb)):
                continue
            w2c_cv = np.asarray(extr[frame], np.float64).reshape(4, 4)
            c2w_gl = coords.convert_pose_gl_cv(coords.se3_inverse(w2c_cv))
            poses.append(coords.se3_inverse(c2w_gl).astype(np.float32))
            fx, fy, cx, cy = intr[frame][:4]
            Ks.append(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32))
            rel.append(rgb)
            reld.append(dep)
        return SceneIndex(scene_name, rel, reld, np.stack(poses), np.stack(Ks))


@DATASETS.register("matrixcityDataset")
class MatrixCityDataset(_DiskClipDataset):
    """MatrixCity (city-scale synthetic aerial/street renders).

    The reference lists matrixcity in its dataset checklist
    (dataset/Readme.md:3, unchecked — no loader shipped); this loader
    completes the roster.  Published layout per block: an instant-ngp-style
    ``transforms.json`` (global ``fl_x/fl_y/cx/cy`` or ``camera_angle_x``
    intrinsics, ``frames`` with ``file_path`` and a 4x4 c2w
    ``transform_matrix``/``rot_mat`` in the NeRF/OpenGL camera convention —
    so, like Replica, no CV conjugation) with RGB alongside and z-depth as
    single-channel ``.exr`` (decoded by the native codec in data/exr.py).
    Depth EXR resolution order: a frame's ``depth_path`` key, then
    ``<rgb_dir>_depth/<stem>.exr``, then ``<block>/depth/<stem>.exr``.
    MatrixCity stores depth values at a x100 scale (centimeter units);
    ``depth_scale`` is a constructor knob for re-exports that differ.
    """

    base_dataset = "matrixcity"
    frame_gap = 1
    depth_scale = 100.0
    depth_clamp = (1e-3, 80.0)

    def __init__(self, root, depth_scale: float = 100.0,
                 max_depth: float = 80.0, **kwargs):
        self.depth_scale = float(depth_scale)
        self.depth_clamp = (1e-3, float(max_depth))
        super().__init__(root=root, **kwargs)

    @staticmethod
    def _intrinsics_from_meta(meta, frame, w, h):
        src = dict(meta)
        src.update(frame)  # per-frame overrides win
        if "fl_x" in src:
            fx = float(src["fl_x"])
            fy = float(src.get("fl_y", fx))
        else:
            fx = fy = 0.5 * w / np.tan(0.5 * float(src["camera_angle_x"]))
        cx = float(src.get("cx", w / 2.0))
        cy = float(src.get("cy", h / 2.0))
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)

    def _depth_rel_path(self, scene_name: str, rgb_rel: str, frame) -> str:
        if "depth_path" in frame:
            return osp.normpath(osp.join(scene_name, frame["depth_path"]))
        stem = osp.splitext(osp.basename(rgb_rel))[0]
        rgb_dir = osp.dirname(rgb_rel)
        cands = [
            osp.join(rgb_dir + "_depth", stem + ".exr") if rgb_dir else None,
            osp.join(scene_name, "depth", stem + ".exr"),
        ]
        for c in cands:
            if c and osp.isfile(osp.join(self.root, c)):
                return c
        return cands[-1]

    def load_scene_index(self, scene_name: str) -> SceneIndex:
        import json as _json

        with open(osp.join(self.root, scene_name, "transforms.json")) as f:
            meta = _json.load(f)
        frames = sorted(meta["frames"], key=lambda fr: str(fr["file_path"]))
        rel, reld, poses, Ks = [], [], [], []
        for fr in frames:
            fp = str(fr["file_path"])
            if not osp.splitext(fp)[1]:
                fp += ".png"  # instant-ngp convention omits the extension
            rgb = osp.normpath(osp.join(scene_name, fp))
            if not osp.isfile(osp.join(self.root, rgb)):
                continue
            c2w_gl = np.asarray(
                fr.get("transform_matrix", fr.get("rot_mat")), np.float64
            ).reshape(4, 4)
            poses.append(coords.se3_inverse(c2w_gl).astype(np.float32))
            from PIL import Image

            with Image.open(osp.join(self.root, rgb)) as im:
                w, h = im.size
            Ks.append(self._intrinsics_from_meta(meta, fr, w, h))
            rel.append(rgb)
            reld.append(self._depth_rel_path(scene_name, rgb, fr))
        return SceneIndex(scene_name, rel, reld, np.stack(poses), np.stack(Ks))

    def load_depth(self, path: str) -> np.ndarray:
        from unigeo_tpu_torch.data.exr import read_exr

        return np.asarray(read_exr(path), np.float32) / self.depth_scale
