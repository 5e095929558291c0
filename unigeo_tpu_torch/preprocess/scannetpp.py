"""ScanNet++ GT preprocessing: render depth and normals from the laser mesh.

Port of ``unigeo_tpu/preprocess/scannetpp.py`` (the reference's
dataset/scannetpp/preprocess_scannetpp_imu.py): IMU-aligned poses from
pose_intrinsic_imu.json, the mesh rendered by the port's z-buffer
(``rasterizer.rasterize_mesh``) on the card in place of pyrender, the
Lanczos rescale with its intrinsics, and the outputs the port's ScanNet++
loader reads: webp RGB, lossless webp world normals, uint16 depth in mm and
scene_metadata.npz (trajectories c2w OpenCV [N, 4, 4], intrinsics
[N, 3, 3], images [N] names).  The mesh, its vertex normals and every
frame's render stay on the device; images are read and written on the host
with PIL.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Optional, Tuple

import numpy as np
import torch

from unigeo_tpu_torch import coords
from unigeo_tpu_torch.device import resolve_device
from unigeo_tpu_torch.preprocess.rasterizer import (
    compute_vertex_normals,
    rasterize_mesh,
    read_ply_mesh,
)


def load_imu_poses(json_path: str):
    """pose_intrinsic_imu.json -> (names, c2w [N, 4, 4] OpenCV float32,
    K [N, 3, 3] float32), numpy on the host."""
    with open(json_path) as f:
        meta = json.load(f)
    names = sorted(meta.keys())
    poses = np.stack([np.asarray(meta[n]["aligned_pose"], np.float32) for n in names])
    intr = np.stack([np.asarray(meta[n]["intrinsic"], np.float32) for n in names])
    return names, poses, intr


def rescale_intrinsics(K: np.ndarray, orig_hw, new_hw) -> np.ndarray:
    return K * coords.intrinsics_resize_scale(orig_hw, new_hw)


def _mesh_on(scene_dir, mesh_name, dev):
    """The scene's mesh on ``dev``: (vertices, faces, vertex normals)."""
    verts, faces = read_ply_mesh(osp.join(scene_dir, "scans", mesh_name))
    verts, faces = torch.from_numpy(verts).to(dev), torch.from_numpy(faces).to(dev)
    return verts, faces, compute_vertex_normals(verts, faces)


def _out_dirs(out_dir):
    for sub in ("images", "depth", "normal"):
        os.makedirs(osp.join(out_dir, sub), exist_ok=True)


def _render_and_save(mesh, w2c, K, h, w, out_dir, name, dev):
    """Render one frame on ``dev`` and write its depth (uint16 mm PNG) and
    world normals (lossless webp, (n + 1) / 2 * 255)."""
    from PIL import Image

    verts, faces, vnormals = mesh
    depth, normal_world = rasterize_mesh(verts, faces, w2c, K, h, w, vnormals, device=dev)
    depth_mm = torch.round(depth * 1000).cpu().numpy().astype(np.uint16)
    Image.fromarray(depth_mm).save(osp.join(out_dir, "depth", f"{name}.png"))
    nrm = ((torch.clamp(normal_world, -1, 1) + 1) * 0.5 * 255).cpu().numpy().astype(np.uint8)
    Image.fromarray(nrm).save(osp.join(out_dir, "normal", f"{name}.webp"), lossless=True)


def _save_metadata(out_dir, poses, intr, names):
    np.savez(osp.join(out_dir, "scene_metadata.npz"), trajectories=np.stack(poses),
             intrinsics=np.stack(intr), images=np.asarray(names))


def process_scene(
    scene_dir: str,
    out_dir: str,
    mesh_name: str = "mesh_aligned_0.05.ply",
    target_hw: Tuple[int, int] = (768, 1024),
    frame_stride: int = 1,
    max_frames: Optional[int] = None,
    verbose: bool = True,
    device="cuda",
):
    """Render GT depth and world-space normals of every selected iPhone
    frame on ``device`` and write scene_metadata.npz in the loader's layout;
    returns the number of frames written."""
    from PIL import Image

    dev = resolve_device(device)
    mesh = _mesh_on(scene_dir, mesh_name, dev)
    names, c2w_cv, intr = load_imu_poses(osp.join(scene_dir, "iphone", "pose_intrinsic_imu.json"))
    names, c2w_cv, intr = names[::frame_stride], c2w_cv[::frame_stride], intr[::frame_stride]
    if max_frames:
        names, c2w_cv, intr = names[:max_frames], c2w_cv[:max_frames], intr[:max_frames]
    _out_dirs(out_dir)

    h, w = target_hw
    kept_names, kept_poses, kept_intr = [], [], []
    for i, name in enumerate(names):
        rgb_path = osp.join(scene_dir, "iphone", "rgb", f"{name}.jpg")
        if not osp.isfile(rgb_path):
            continue
        img = Image.open(rgb_path)
        K = rescale_intrinsics(intr[i], (img.height, img.width), target_hw)
        img = img.resize((w, h), Image.LANCZOS)
        img.save(osp.join(out_dir, "images", f"{name}.webp"))
        _render_and_save(mesh, coords.se3_inverse(c2w_cv[i]), K, h, w, out_dir, name, dev)
        kept_names.append(name)
        kept_poses.append(c2w_cv[i])
        kept_intr.append(K)
        if verbose and len(kept_names) % 50 == 0:
            print(f"  rendered {len(kept_names)} frames")
    _save_metadata(out_dir, kept_poses, kept_intr, kept_names)
    return len(kept_names)


def process_scene_dslr(
    scene_dir: str,
    out_dir: str,
    mesh_name: str = "mesh_aligned_0.05.ply",
    target_hw: Optional[Tuple[int, int]] = None,
    frame_stride: int = 1,
    max_frames: Optional[int] = None,
    balance: float = 0.0,
    verbose: bool = True,
    device="cuda",
):
    """The DSLR path: COLMAP sparse-model poses and fisheye / pinhole
    undistortion on ``device``, then the GT render against the undistorted
    pinhole camera, written as ``process_scene`` writes it."""
    from PIL import Image

    from unigeo_tpu_torch.preprocess.colmap import (
        colmap_to_opencv_intrinsics,
        get_frame_number,
        load_colmap_model,
        undistort_image,
    )

    dev = resolve_device(device)
    mesh = _mesh_on(scene_dir, mesh_name, dev)
    cameras, images, _ = load_colmap_model(osp.join(scene_dir, "dslr", "colmap"))
    entries = sorted(images.values(), key=lambda im: get_frame_number(im.name))[::frame_stride]
    if max_frames:
        entries = entries[:max_frames]
    _out_dirs(out_dir)

    kept_names, kept_poses, kept_intr = [], [], []
    for im in entries:
        rgb_path = osp.join(scene_dir, "dslr", "resized_images", im.name)
        if not osp.isfile(rgb_path):
            rgb_path = osp.join(scene_dir, "dslr", "images", im.name)
            if not osp.isfile(rgb_path):
                continue
        rgb = np.asarray(Image.open(rgb_path).convert("RGB"), np.float32)
        new_k_colmap, und, _ = undistort_image(cameras[im.camera_id], rgb, balance=balance,
                                               device=dev)
        K = colmap_to_opencv_intrinsics(new_k_colmap).cpu().numpy()
        und_img = Image.fromarray(torch.clamp(und, 0, 255).cpu().numpy().astype(np.uint8))
        h, w = und.shape[:2]
        if target_hw is not None:
            K = rescale_intrinsics(K, (h, w), target_hw)
            h, w = target_hw
            und_img = und_img.resize((w, h), Image.LANCZOS)

        name = osp.splitext(im.name)[0]
        und_img.save(osp.join(out_dir, "images", f"{name}.webp"))
        c2w = im.cam_to_world.numpy().astype(np.float32)
        _render_and_save(mesh, coords.se3_inverse(c2w), K, h, w, out_dir, name, dev)
        kept_names.append(name)
        kept_poses.append(c2w)
        kept_intr.append(K)
        if verbose and len(kept_names) % 50 == 0:
            print(f"  rendered {len(kept_names)} frames")
    _save_metadata(out_dir, kept_poses, kept_intr, kept_names)
    return len(kept_names)
