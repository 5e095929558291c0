"""Trajectory-file readers, port of ``unigeo_tpu/data/trajectories.py``
(numpy; the quaternion conversions of ``metrics/camera.py``, in f32 as in
the JAX package): TUM, Sintel ``.cam`` / ``.dpt`` and flattened-matrix
trajectories, and nearest-timestamp association.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

import torch

from unigeo_tpu_torch.metrics.camera import matrix_to_quaternion, quaternion_to_matrix


def read_tum_trajectory(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """TUM format: ``timestamp tx ty tz qx qy qz qw`` per line (# comments).

    Returns (poses [N,4,4] camera-to-world, timestamps [N]).
    """
    rows = []
    stamps = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.replace(",", " ").split()]
            if len(vals) < 8:
                continue
            stamps.append(vals[0])
            rows.append(vals[1:8])
    data = np.asarray(rows, np.float64)  # [N, 7]: t xyz, q xyzw
    t = data[:, :3]
    q_xyzw = data[:, 3:7]
    q_wxyz = np.concatenate([q_xyzw[:, 3:4], q_xyzw[:, :3]], axis=1)
    R = quaternion_to_matrix(torch.from_numpy(q_wxyz)).numpy()
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, :3] = R
    poses[:, :3, 3] = t
    return poses.astype(np.float32), np.asarray(stamps)


def write_tum_trajectory(path: str, poses: np.ndarray, timestamps=None) -> None:
    """Inverse of read_tum_trajectory (for interop/debugging)."""
    poses = np.asarray(poses)
    if timestamps is None:
        timestamps = np.arange(len(poses), dtype=float)
    q = matrix_to_quaternion(torch.from_numpy(np.ascontiguousarray(poses[:, :3, :3]))).numpy()
    with open(path, "w") as f:
        for i, pose in enumerate(poses):
            t = pose[:3, 3]
            f.write(
                f"{timestamps[i]} {t[0]} {t[1]} {t[2]} "
                f"{q[i,1]} {q[i,2]} {q[i,3]} {q[i,0]}\n"
            )


def read_sintel_cam(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Sintel .cam binary: K [3,3] and w2c extrinsic [3,4] per file.

    (reference: metrics/evo_utils.py handles sintel-format trajectories;
    the MPI-Sintel camdata files store a magic float, then K and E row-major
    as float64.)
    """
    TAG = 202021.25
    with open(path, "rb") as f:
        tag = np.frombuffer(f.read(4), np.float32)[0]
        assert abs(tag - TAG) < 1e-3, f"bad sintel cam file tag {tag}"
        M = np.frombuffer(f.read(8 * 9), np.float64).reshape(3, 3)
        N = np.frombuffer(f.read(8 * 12), np.float64).reshape(3, 4)
    return M.astype(np.float32), N.astype(np.float32)


def read_sintel_trajectory(cam_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """Directory of frame_XXXX.cam files → (c2w poses [N,4,4], K [N,3,3])."""
    import glob as _glob
    import os.path as _osp

    files = sorted(_glob.glob(_osp.join(cam_dir, "*.cam")))
    poses, intrinsics = [], []
    for fp in files:
        K, E = read_sintel_cam(fp)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3] = E
        poses.append(np.linalg.inv(w2c))
        intrinsics.append(K)
    return np.stack(poses), np.stack(intrinsics)


def associate_timestamps(
    query: np.ndarray, ref: np.ndarray, max_diff: float = 0.02
) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-timestamp association (TUM ``associate.py`` semantics).

    For each timestamp in ``query`` find the nearest timestamp in ``ref``;
    keep pairs within ``max_diff`` seconds.  Returns (query_idx, ref_idx)
    integer index arrays.  Vectorized via searchsorted instead of the TUM
    tool's O(N*M) candidate sort; same nearest-neighbor result.
    """
    query = np.asarray(query, np.float64)
    ref = np.asarray(ref, np.float64)
    if len(ref) == 0 or len(query) == 0:  # e.g. comments-only pose file
        empty = np.zeros(0, np.int64)
        return empty, empty
    order = np.argsort(ref)
    ref_sorted = ref[order]
    pos = np.searchsorted(ref_sorted, query)
    pos = np.clip(pos, 1, len(ref_sorted) - 1) if len(ref_sorted) > 1 else (
        np.zeros_like(pos)
    )
    left = ref_sorted[np.maximum(pos - 1, 0)]
    right = ref_sorted[np.minimum(pos, len(ref_sorted) - 1)]
    take_right = np.abs(right - query) < np.abs(left - query)
    nearest = np.where(take_right, np.minimum(pos, len(ref_sorted) - 1),
                       np.maximum(pos - 1, 0))
    ok = np.abs(ref_sorted[nearest] - query) <= max_diff
    return np.nonzero(ok)[0], order[nearest[ok]]


def read_dpt(path: str) -> np.ndarray:
    """MPI-Sintel ``.dpt`` depth file → [H, W] float32 meters.

    Same container as Middlebury ``.flo``: float32 tag 202021.25, int32
    width, int32 height, then H*W float32 depth values row-major (the
    Sintel depth-training SDK's ``depth_read``).
    """
    TAG = 202021.25
    with open(path, "rb") as f:
        tag = np.frombuffer(f.read(4), np.float32)[0]
        assert abs(tag - TAG) < 1e-3, f"bad .dpt tag {tag} in {path}"
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        data = np.frombuffer(f.read(4 * w * h), np.float32)
    return data.reshape(h, w).copy()


def read_matrix_trajectory(path: str, rows_per_matrix: int = 1) -> np.ndarray:
    """Trajectory stored as flattened 4x4 row-major matrices.

    rows_per_matrix=1: one 16-value line per pose (Replica traj_w_cgl.txt).
    rows_per_matrix=4: 4 lines of 4 values per pose (NeuralRGBD poses.txt).
    """
    if rows_per_matrix == 1:
        return np.loadtxt(path).reshape(-1, 4, 4).astype(np.float32)
    with open(path) as f:
        lines = [ln for ln in f.readlines()]
    poses = []
    for i in range(0, len(lines), rows_per_matrix):
        chunk = lines[i : i + rows_per_matrix]
        poses.append([[float(x) for x in ln.split()] for ln in chunk])
    return np.asarray(poses, np.float32)
