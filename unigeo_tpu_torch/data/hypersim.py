"""Hypersim loader (pair-based, train-oriented), port of
``unigeo_tpu/data/hypersim.py`` (numpy; ``pandas`` and ``h5py`` are imported
only where a CSV or an HDF5 file is read).

(reference: dataset/hypersim/hypersim.py — HDF5 camera keyframes scaled by
meters_per_asset_unit :130-165, intrinsics derived from the projection and
NDC→screen matrices :235-241, tonemap jpg RGB + normal_cam.hdf5 +
position.hdf5 world coordinates :183-214, fix_normal orientation fix :273,
validity clamp 80 m :285.  The reference selects frame pairs by a
mask-score matrix with a 0.7 threshold :83-108 from hypersim_scores.zip —
stripped from the snapshot (.MISSING_LARGE_BLOBS) — so pair selection here
takes an optional scores CSV and falls back to consecutive frames.)

Unlike the video loaders, samples are PAIRS and geometry arrives as world-
space positions (no depth maps), so this dataset builds its clip dict
directly rather than via the depth-backprojection path of ClipDataset.
"""

from __future__ import annotations

import os
import os.path as osp
import re
from glob import glob
from typing import Dict, List, Optional

import numpy as np
import torch

from unigeo_tpu_torch import coords
from unigeo_tpu_torch.data.transforms import ResizeInputs, ResizeTargets
from unigeo_tpu_torch.ops.normals import fix_normal
from unigeo_tpu_torch.registry import DATASETS


def _read_meters_per_asset_unit(detail_dir: str) -> float:
    import pandas as pd

    df = pd.read_csv(osp.join(detail_dir, "metadata_scene.csv"))
    row = df[df.parameter_name == "meters_per_asset_unit"]
    return float(row.parameter_value.iloc[0])


def _intrinsics_from_proj(M_proj: np.ndarray, width: int, height: int) -> np.ndarray:
    """K from the OpenGL projection matrix + integer-screen mapping
    (reference: hypersim.py:113-127, 235-241)."""
    ndc2screen = np.array(
        [
            [0.5 * (width - 1), 0, 0, 0.5 * (width - 1)],
            [0, -0.5 * (height - 1), 0, 0.5 * (height - 1)],
            [0, 0, 0.5, 0.5],
            [0, 0, 0, 1.0],
        ]
    )
    fx = ndc2screen[0, 0] * M_proj[0, 0]
    fy = -1 * ndc2screen[1, 1] * M_proj[1, 1]
    cx = ndc2screen[0, 3]
    cy = ndc2screen[1, 3]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


@DATASETS.register("HyperSimDataset")
class HyperSimDataset:
    def __init__(
        self,
        root: str,
        split: str = "train",
        clip_length: int = 2,  # pairs
        clip_overlap: int = 0,
        input_size=None,
        target_size=None,
        scene_list: Optional[List[str]] = None,
        scores_csv: Optional[str] = None,
        score_threshold: float = 0.7,
        max_pairs_per_camera: int = 20,
        **_: Dict,
    ):
        self.root = root
        self.split = split
        self.pair_len = max(2, clip_length)
        self.input_resize = ResizeInputs(input_size) if input_size else None
        self.target_resize = ResizeTargets(target_size) if target_size else None
        self.scores = self._load_scores(scores_csv) if scores_csv else None
        self.score_threshold = score_threshold
        self.max_pairs_per_camera = max_pairs_per_camera

        if scene_list is not None:
            scenes = scene_list
        else:
            split_file = osp.join(root, "splits", f"{split}.txt")
            if osp.isfile(split_file):
                with open(split_file) as f:
                    scenes = [ln.strip() for ln in f if ln.strip()]
            else:
                scenes = sorted(
                    d for d in os.listdir(root)
                    if osp.isdir(osp.join(root, d)) and d.startswith("ai_")
                )
        self.samples: List[Dict] = []
        for scene in scenes:
            for cam in self._cameras(scene):
                self._index_camera(scene, cam)
        # per-scene/camera caches: the reference re-reads CSVs and reopens
        # camera HDF5s per item; here each is loaded once per dataset
        self._cam_cache: Dict = {}
        self._params_df = None

    @staticmethod
    def _load_scores(path):
        import pandas as pd

        return pd.read_csv(path)

    def _cameras(self, scene: str) -> List[str]:
        detail = osp.join(self.root, scene, "_detail")
        if not osp.isdir(detail):
            return []
        return sorted(
            d for d in os.listdir(detail)
            if d.startswith("cam_") and osp.isdir(osp.join(detail, d))
        )

    def _index_camera(self, scene: str, cam: str) -> None:
        img_dir = osp.join(
            self.root, scene, "images", f"scene_{cam}_final_preview"
        )
        frames = sorted(glob(osp.join(img_dir, "frame.*.tonemap.jpg")))
        ids = [
            int(re.search(r"frame\.(\d+)\.", osp.basename(f)).group(1))
            for f in frames
        ]
        pairs = []
        if self.scores is not None:
            sel = self.scores[
                (self.scores.get("scene") == scene)
                & (self.scores.get("cam") == cam)
                & (self.scores.get("score") >= self.score_threshold)
            ]
            pairs = [tuple(map(int, p)) for p in sel[["frame_a", "frame_b"]].values]
        if not pairs:
            pairs = list(zip(ids[:-1], ids[1:]))  # consecutive fallback
        for a, b in pairs[: self.max_pairs_per_camera]:
            self.samples.append({"scene": scene, "cam": cam, "frames": [a, b]})

    def __len__(self) -> int:
        return len(self.samples)

    # ------------------------------------------------------------------

    def _load_camera(self, scene: str, cam: str):
        """(c2w [N,4,4] OpenGL, meters scale, frame-id → keyframe-row map).

        Cached per (scene, cam).  Hypersim cameras are KEYFRAME tables:
        ``camera_keyframe_frame_indices.hdf5`` names the frame id of each
        row — frame id == row index is NOT guaranteed, so the explicit map
        is built when that file exists (identity fallback otherwise).
        """
        key = (scene, cam)
        if key in self._cam_cache:
            return self._cam_cache[key]
        import h5py

        detail = osp.join(self.root, scene, "_detail")
        cam_dir = osp.join(detail, cam)
        with h5py.File(osp.join(cam_dir, "camera_keyframe_positions.hdf5"), "r") as f:
            positions = f["dataset"][:]
        with h5py.File(
            osp.join(cam_dir, "camera_keyframe_orientations.hdf5"), "r"
        ) as f:
            orientations = f["dataset"][:]
        idx_path = osp.join(cam_dir, "camera_keyframe_frame_indices.hdf5")
        if osp.isfile(idx_path):
            with h5py.File(idx_path, "r") as f:
                frame_ids = f["dataset"][:].astype(np.int64)
            fid_to_row = {int(fid): i for i, fid in enumerate(frame_ids)}
        else:
            fid_to_row = {i: i for i in range(len(positions))}
        scale = _read_meters_per_asset_unit(detail)
        n = len(positions)
        c2w = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        c2w[:, :3, :3] = orientations
        c2w[:, :3, 3] = positions * scale
        self._cam_cache[key] = (c2w, scale, fid_to_row)
        return self._cam_cache[key]

    def _camera_intrinsics(self, scene: str) -> np.ndarray:
        """K for a scene from metadata_camera_parameters.csv (loaded once)."""
        if self._params_df is None:
            import pandas as pd

            self._params_df = pd.read_csv(
                osp.join(self.root, "metadata_camera_parameters.csv"),
                index_col="scene_name",
            )
        row = self._params_df.loc[scene]
        width = int(row["settings_output_img_width"])
        height = int(row["settings_output_img_height"])
        M_proj = np.array(
            [[row[f"M_proj_{i}{j}"] for j in range(4)] for i in range(4)]
        )
        return _intrinsics_from_proj(M_proj, width, height)

    def _frame_paths(self, scene: str, cam: str, fid: int):
        img = osp.join(
            self.root, scene, "images", f"scene_{cam}_final_preview",
            f"frame.{fid:04d}.tonemap.jpg",
        )
        geo = osp.join(self.root, scene, "images", f"scene_{cam}_geometry_hdf5")
        return (
            img,
            osp.join(geo, f"frame.{fid:04d}.normal_cam.hdf5"),
            osp.join(geo, f"frame.{fid:04d}.position.hdf5"),
        )

    def __getitem__(self, index: int) -> Dict:
        import h5py
        from PIL import Image

        rec = self.samples[index]
        scene, cam, fids = rec["scene"], rec["cam"], rec["frames"]
        c2w_gl, scale, fid_to_row = self._load_camera(scene, cam)
        w2c_gl = coords.se3_inverse(c2w_gl)
        K = self._camera_intrinsics(scene)

        images, cam_normals, cam_coords, world_coords, masks = [], [], [], [], []
        extr = []
        for fid in fids:
            img_p, nrm_p, pos_p = self._frame_paths(scene, cam, fid)
            img = np.asarray(Image.open(img_p).convert("RGB"), np.float32)
            images.append(img.transpose(2, 0, 1))
            with h5py.File(nrm_p, "r") as f:
                nrm = f["dataset"][:].astype(np.float32)
            nrm = nrm / (np.linalg.norm(nrm, axis=2, keepdims=True) + 1e-6)
            with h5py.File(pos_p, "r") as f:
                pos = f["dataset"][:].astype(np.float32) * scale
            pos[np.isinf(pos)] = np.nan

            w2c = w2c_gl[fid_to_row[fid]]
            cam_pts = (
                w2c[:3, :3] @ pos.reshape(-1, 3).T + w2c[:3, 3:4]
            ).T.reshape(pos.shape)

            nrm = fix_normal(torch.from_numpy(nrm), torch.from_numpy(cam_pts)).numpy()

            depth = -cam_pts[..., 2]
            invalid = (
                np.isnan(cam_pts).any(-1)
                | np.isnan(nrm).any(-1)
                | (np.nan_to_num(depth) < 1e-3)
                | (np.nan_to_num(depth) > 80.0)
            )
            nrm = np.where(invalid[..., None], 0.0, np.nan_to_num(nrm))
            cam_pts = np.where(invalid[..., None], 0.0, np.nan_to_num(cam_pts))

            cam_normals.append(nrm.transpose(2, 0, 1))
            cam_coords.append(cam_pts.transpose(2, 0, 1))
            masks.append((~invalid).astype(np.float32))
            extr.append(w2c)

        extr = np.stack(extr)
        ref = extr[0]
        world_coords, world_normals = [], []
        for i in range(len(fids)):
            trans = coords.relative_transform(ref, extr[i])
            cc = cam_coords[i].reshape(3, -1)
            cn = cam_normals[i].reshape(3, -1)
            world_coords.append(
                (trans[:3, :3] @ cc + trans[:3, 3:4]).reshape(cam_coords[i].shape)
            )
            world_normals.append((trans[:3, :3] @ cn).reshape(cam_normals[i].shape))

        sample = {
            "scene_name": f"{scene}_{cam}",
            "images": np.stack(images),
            "image_names": [f"frame.{f:04d}" for f in fids],
            "intrinsics": np.repeat(K[None], len(fids), axis=0),
            "extrinsics": coords.rebase_to_keyview(extr, 0).astype(np.float32),
            "cam_coord": np.stack(cam_coords).astype(np.float32),
            "cam_normal": np.stack(cam_normals).astype(np.float32),
            "world_coord": np.stack(world_coords).astype(np.float32),
            "world_normal": np.stack(world_normals).astype(np.float32),
            "mask": np.stack(masks),
            "keyview_idx": 0,
            "_index": index,
            "_dataset": f"hypersim.{self.split}",
        }
        if self.input_resize is not None:
            sample = self.input_resize(sample)
        if self.target_resize is not None:
            sample = self.target_resize(sample)
        return sample
