"""The port's camera metrics, trajectory files, geometry ops and secondary
metrics against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.

Tolerances:
* ``camera_pose_evaluation`` and ``_umeyama_np`` are the same numpy f64
  code in both packages: equal floats.
* ``umeyama_alignment`` (f32, a 3x3 SVD through LAPACK in both): R, t, c
  within 1e-5 (seen ~1e-6; the mean-centred sums of 200 points rounded in
  other orders).
* Quaternions (f32 in both, as the JAX package computes them with x64 off):
  within 4 ulps of 1 (1e-6 absolute; a 4-term norm and a sqrt rounded in
  another order), and the matrices back from them within 1e-6; the round
  trip matrix -> quaternion -> matrix within 1e-5 of the input (a component
  near 0 is the square root of a sum near 0, whose f32 rounding it
  amplifies: seen 2.2e-6, in both packages).
* TUM files: the port reads the files the JAX package writes and the other
  way round; poses within 1e-6 (the f32 quaternion path), timestamps equal;
  the other readers (Sintel .cam and .dpt, flattened matrices, timestamp
  association) are numpy: equal.
* ``geometry.py``: exact where both packages compute the same f32 products
  in one order (grids, principal-point shifts, numpy helpers); 1e-6 of the
  largest magnitude for the einsum transforms and the backprojection
  (products and sums in other orders); Procrustes 1e-5 as Umeyama.
* ``extras.py``: completion ratio equal on random points (distances far from
  the threshold); ``align_pcd`` as ICP (tests/test_torch_pointcloud.py,
  1e-5); the global-coordinate depth metrics within 1e-4 relative (two lstsq
  fits over ~2000 pixels, n 2^-24 first-order, as the depth metrics in
  tests/test_torch_eval.py); the evo scraping equal.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigeo_tpu.data import trajectories as jtraj
from unigeo_tpu.metrics import camera as jcam
from unigeo_tpu.metrics import extras as jextras
from unigeo_tpu.ops import geometry as jgeo
from unigeo_tpu_torch.data import trajectories as ptraj
from unigeo_tpu_torch.metrics import camera as pcam
from unigeo_tpu_torch.metrics import extras as pextras
from unigeo_tpu_torch.ops import geometry as pgeo


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rotations(rng, n):
    """n random rotation matrices (QR of Gaussians, det fixed to +1)."""
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q


def _trajectory(rng, n=25):
    """A smooth camera-to-world trajectory [n, 4, 4] (f32)."""
    poses = np.tile(np.eye(4), (n, 1, 1))
    angles = np.cumsum(rng.normal(0, 0.05, (n, 3)), axis=0)
    for i, (a, b, c) in enumerate(angles):
        ca, sa, cb, sb, cc, sc = np.cos(a), np.sin(a), np.cos(b), np.sin(b), np.cos(c), np.sin(c)
        rx = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
        ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
        rz = np.array([[cc, -sc, 0], [sc, cc, 0], [0, 0, 1]])
        poses[i, :3, :3] = rz @ ry @ rx
    poses[:, :3, 3] = np.cumsum(rng.normal(0, 0.1, (n, 3)), axis=0)
    return poses.astype(np.float32)


# --- ATE / RPE ---------------------------------------------------------------------


def test_camera_pose_evaluation_equals_jax_on_a_perturbed_trajectory():
    rng = np.random.default_rng(0)
    gt = _trajectory(rng)
    pred = gt.copy()
    pred[:, :3, 3] = 2.5 * pred[:, :3, 3] + rng.normal(0, 0.01, (25, 3))
    pred[:, :3, :3] = _rotations(rng, 1)[0] @ pred[:, :3, :3]
    pred[5:, :3, :3] = pred[5:, :3, :3] @ _rotations(rng, 1)[0]  # a rotation drift
    ref = jcam.camera_pose_evaluation(pred, gt)
    ours = pcam.camera_pose_evaluation(pred, gt)
    assert ours == ref and all(v > 0 for v in ours)
    ate, rpe_trans, _ = pcam.camera_pose_evaluation(gt, gt)
    assert ate <= 1e-12 and rpe_trans <= 1e-12  # f64 round-off


def test_umeyama_matches_jax():
    rng = np.random.default_rng(1)
    src = rng.normal(size=(200, 3)).astype(np.float32)
    rot = _rotations(rng, 1)[0]
    dst = (1.8 * src @ rot.T + np.array([0.5, -1.0, 2.0])
           + rng.normal(0, 0.01, src.shape)).astype(np.float32)
    for with_scale in (True, False):
        jr, jt, jc = jcam.umeyama_alignment(jnp.asarray(src), jnp.asarray(dst), with_scale)
        pr, pt, pc = pcam.umeyama_alignment(_t(src), _t(dst), with_scale)
        np.testing.assert_allclose(pr.numpy(), np.asarray(jr), atol=1e-5, rtol=0)
        np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=1e-5, rtol=0)
        assert abs(float(pc) - float(jc)) <= 1e-5
    np.testing.assert_allclose(pr.numpy(), rot, atol=1e-2)


# --- quaternions and TUM files -------------------------------------------------------


def test_quaternions_match_jax_and_round_trip():
    rng = np.random.default_rng(2)
    rots = np.concatenate([_rotations(rng, 64), np.eye(3)[None],
                           np.diag([1.0, -1.0, -1.0])[None]]).astype(np.float32)
    jq = np.asarray(jcam.matrix_to_quaternion(jnp.asarray(rots)))
    pq = pcam.matrix_to_quaternion(_t(rots)).numpy()
    np.testing.assert_allclose(pq, jq, atol=1e-6, rtol=0)
    back = pcam.quaternion_to_matrix(_t(pq)).numpy()
    np.testing.assert_allclose(back, rots, atol=1e-5, rtol=0)
    np.testing.assert_allclose(back, np.asarray(jcam.quaternion_to_matrix(jnp.asarray(jq))),
                               atol=1e-6, rtol=0)
    poses = _trajectory(rng, 6)
    tum, tt = pcam.get_tum_poses(poses)
    jtum, jtt = jcam.get_tum_poses(poses)
    assert tum.shape == (6, 7) and np.array_equal(tt, jtt)
    np.testing.assert_allclose(tum, jtum, atol=1e-6, rtol=0)


def test_tum_files_cross_read_with_jax(tmp_path):
    rng = np.random.default_rng(4)
    poses = _trajectory(rng, 12)
    stamps = np.arange(12) * 0.033 + 100.0
    ptraj.write_tum_trajectory(str(tmp_path / "port.txt"), poses, stamps)
    jtraj.write_tum_trajectory(str(tmp_path / "jax.txt"), poses, stamps)
    for path in ("port.txt", "jax.txt"):
        p_poses, p_stamps = ptraj.read_tum_trajectory(str(tmp_path / path))
        j_poses, j_stamps = jtraj.read_tum_trajectory(str(tmp_path / path))
        assert p_poses.dtype == np.float32 and np.array_equal(p_stamps, j_stamps)
        np.testing.assert_allclose(p_poses, j_poses, atol=1e-6, rtol=0)
        np.testing.assert_allclose(p_poses, poses, atol=1e-5, rtol=0)
    with open(tmp_path / "port.txt") as f:
        assert len(f.read().strip().splitlines()) == 12


def test_other_trajectory_readers_equal_jax(tmp_path):
    rng = np.random.default_rng(5)
    tag = np.float32(202021.25).tobytes()
    cams = tmp_path / "cams"
    cams.mkdir()
    for i in range(3):
        k = rng.normal(size=(3, 3))
        e = np.c_[_rotations(rng, 1)[0], rng.normal(size=3)]
        (cams / f"frame_{i:04d}.cam").write_bytes(tag + k.tobytes() + e.tobytes())
    for a, b in zip(ptraj.read_sintel_trajectory(str(cams)),
                    jtraj.read_sintel_trajectory(str(cams))):
        np.testing.assert_array_equal(a, b)
    depth = rng.random((5, 7)).astype(np.float32)
    dpt = tmp_path / "d.dpt"
    dpt.write_bytes(tag + np.int32(7).tobytes() + np.int32(5).tobytes() + depth.tobytes())
    np.testing.assert_array_equal(ptraj.read_dpt(str(dpt)), jtraj.read_dpt(str(dpt)))
    mats = rng.normal(size=(4, 16))
    np.savetxt(tmp_path / "m1.txt", mats)
    np.savetxt(tmp_path / "m4.txt", mats.reshape(16, 4))
    for path, rows in (("m1.txt", 1), ("m4.txt", 4)):
        np.testing.assert_array_equal(
            ptraj.read_matrix_trajectory(str(tmp_path / path), rows),
            jtraj.read_matrix_trajectory(str(tmp_path / path), rows))
    query, ref = np.sort(rng.uniform(0, 2, 40)), rng.uniform(0, 2, 50)
    for a, b in zip(ptraj.associate_timestamps(query, ref), jtraj.associate_timestamps(query, ref)):
        np.testing.assert_array_equal(a, b)


# --- geometry ----------------------------------------------------------------------------


def test_geometry_ops_match_jax():
    rng = np.random.default_rng(6)
    np.testing.assert_array_equal(pgeo.xy_grid(5, 3).numpy(), np.asarray(jgeo.xy_grid(5, 3)))
    np.testing.assert_array_equal(pgeo.xy_grid(5, 3, homogeneous=True).numpy(),
                                  np.asarray(jgeo.xy_grid(5, 3, homogeneous=True)))
    T = _trajectory(rng, 1)[0]
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    ref = np.asarray(jgeo.geotrf(jnp.asarray(T), jnp.asarray(pts)))
    np.testing.assert_allclose(pgeo.geotrf(_t(T), _t(pts)).numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    hom = (np.eye(3) + rng.normal(0, 0.05, (3, 3))).astype(np.float32)
    uv = rng.uniform(0, 100, (20, 2)).astype(np.float32)
    ref = np.asarray(jgeo.geotrf(jnp.asarray(hom), jnp.asarray(uv), norm=True, ncol=2))
    np.testing.assert_allclose(pgeo.geotrf(_t(hom), _t(uv), norm=True, ncol=2).numpy(), ref,
                               rtol=0, atol=1e-6 * np.abs(ref).max())
    depth = rng.uniform(0.5, 5, (2, 6, 8)).astype(np.float32)
    K = np.tile(np.array([[20.0, 0, 4], [0, 22.0, 3], [0, 0, 1]], np.float32), (2, 1, 1))
    ref = np.asarray(jgeo.depthmap_to_pts3d(jnp.asarray(depth), jnp.asarray(K)))
    np.testing.assert_allclose(pgeo.depthmap_to_pts3d(_t(depth), _t(K)).numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    for p_fn, j_fn in ((pgeo.colmap_to_opencv_intrinsics, jgeo.colmap_to_opencv_intrinsics),
                       (pgeo.opencv_to_colmap_intrinsics, jgeo.opencv_to_colmap_intrinsics)):
        np.testing.assert_array_equal(p_fn(_t(K)).numpy(), np.asarray(j_fn(jnp.asarray(K))))
    np.testing.assert_array_equal(pgeo.crop_intrinsics(K[0], (3, 2)),
                                  jgeo.crop_intrinsics(K[0], (3, 2)))
    a, b = _trajectory(rng, 2)
    assert pgeo.pose_distance(a, b) == jgeo.pose_distance(a, b)


def test_matches_and_procrustes_match_jax():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(120, 3)).astype(np.float32)
    b = (a[rng.permutation(120)] + rng.normal(0, 0.05, a.shape)).astype(np.float32)
    jm, ja2b = jgeo.reciprocal_nn_matches(jnp.asarray(a), jnp.asarray(b))
    pm, pa2b = pgeo.reciprocal_nn_matches(_t(a), _t(b))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pa2b.numpy(), np.asarray(ja2b))
    rot = _rotations(rng, 1)[0]
    dst = (0.7 * a @ rot.T + 0.3 + rng.normal(0, 0.01, a.shape)).astype(np.float32)
    w = rng.random(120).astype(np.float32)
    for weights, with_scale in ((None, False), (w, True)):
        ref = np.asarray(jgeo.weighted_procrustes(jnp.asarray(a), jnp.asarray(dst),
                                                  None if weights is None else jnp.asarray(w),
                                                  with_scale=with_scale))
        ours = pgeo.weighted_procrustes(_t(a), _t(dst), None if weights is None else _t(w),
                                        with_scale=with_scale).numpy()
        np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


# --- extras ----------------------------------------------------------------------------


def test_extras_match_jax(tmp_path):
    rng = np.random.default_rng(8)
    gt_pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    rec = (gt_pts[:200] + rng.normal(0, 0.02, (200, 3))).astype(np.float32)
    assert pextras.completion_ratio(gt_pts, rec) == jextras.completion_ratio(gt_pts, rec)
    assert pextras.voxel_iou(rec, gt_pts, 0.25) == jextras.voxel_iou(rec, gt_pts, 0.25)
    jt, jm = jextras.align_pcd(rec, gt_pts[:200])
    pt, pm = pextras.align_pcd(rec, gt_pts[:200])
    np.testing.assert_allclose(pt, jt, atol=1e-5, rtol=0)
    np.testing.assert_allclose(pm, jm, atol=1e-5, rtol=0)

    nf, h, w = 2, 12, 16
    gt_depth = rng.uniform(1, 4, (nf, h, w)).astype(np.float32)
    pred_depth = (0.5 * gt_depth + 0.2 + rng.normal(0, 0.05, gt_depth.shape)).astype(np.float32)
    K = np.tile(np.array([[15.0, 0, 8], [0, 15.0, 6], [0, 0, 1]], np.float32), (nf, 1, 1))
    c2w = _trajectory(rng, nf)
    radius = rng.uniform(1, 5, (nf, h, w)).astype(np.float32)
    ref, ref_aligned = jextras.depth_evaluation_in_global_coord(pred_depth, gt_depth, radius,
                                                                c2w, K)
    ours, aligned = pextras.depth_evaluation_in_global_coord(pred_depth, gt_depth, radius, c2w, K)
    assert ours.keys() == ref.keys()
    for key, val in ref.items():
        tol = 3.0 / (nf * h * w) if key.startswith("delta") else 1e-4 * abs(val) + 1e-6
        assert abs(ours[key] - val) <= tol, (key, ours[key], val)
    np.testing.assert_allclose(aligned, ref_aligned, rtol=1e-4, atol=1e-6)

    (tmp_path / "seqA_eval_metric.txt").write_text(
        "APE w.r.t. translation part (m)\n  rmse 0.125\n"
        "RPE w.r.t. translation part (m)\n  rmse 0.5\n"
        "RPE w.r.t. rotation angle in degrees (deg)\n  rmse 1.75\n")
    (tmp_path / "seqB_metric.txt").write_text("APE w.r.t. translation part (m)\n rmse 2.0\n")
    ours, ref = pextras.process_directory(str(tmp_path)), jextras.process_directory(str(tmp_path))
    assert ours == ref and len(ours) == 2
    assert (pextras.calculate_trajectory_averages(ours)
            == jextras.calculate_trajectory_averages(ref))
    assert pextras.calculate_trajectory_averages([]) == (0.0, 0.0, 0.0)


def test_plot_trajectory_imports_matplotlib_only_when_called(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(10)
    out = pextras.plot_trajectory(_trajectory(rng, 8), _trajectory(rng, 8), "t",
                                  filename=str(tmp_path / "traj.png"))
    assert os.path.getsize(out) > 0
