"""The port's offline preprocessors (``unigeo_tpu_torch/preprocess``) against
the JAX package's (``unigeo_tpu/preprocess``), on the CPU.

The cases of tests/test_preprocess.py and tests/test_colmap.py, each run
through both packages on the same seeded numpy inputs, and the rasterizer
and the depth registration on seeded random scenes.

Tolerances:

* the COLMAP helpers: 1e-12 relative to the values' scale in float64 (the
  port's arctan, tan and integer powers come from another math library;
  sums and products otherwise in the same order); the remap bitwise (the
  same float64 products in the same order); the undistortion maps within
  1e-4 px (float32 maps of float64 values that differ by those ulps) and
  the undistorted images within 1e-3 of their 0..1 range (the maps' offsets
  times the image's slope);
* the rasterizer: depth within 1e-6 relative where both packages hit (the
  same float64 arithmetic on float32 corners whose projections may differ
  by an ulp), the hit masks equal except at pixels on a triangle's edge
  (held to at most 0.2% of the hit pixels), normals within 1e-5 where both
  hit except where the winning face differs (an exact tie at a shared
  edge, held to at most 0.2% of the hit pixels too);
* the depth registration: bitwise (numpy's promotions followed step by
  step, an exact scatter-min).
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import numpy as np
import pytest
import torch

from unigeo_tpu.preprocess import colmap as jcolmap
from unigeo_tpu.preprocess import rasterizer as jras
from unigeo_tpu.preprocess import sevenscenes as jseven
from unigeo_tpu_torch.preprocess import colmap as tcolmap
from unigeo_tpu_torch.preprocess import rasterizer as tras
from unigeo_tpu_torch.preprocess import sevenscenes as tseven

CPU = "cpu"
REL = 1e-12
EDGE_SHARE = 2e-3  # hit-mask and winning-face differences, of the hit pixels


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(ours, theirs, rel=REL):
    ours, theirs = _np(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    scale = max(1.0, float(np.abs(theirs).max()) if theirs.size else 1.0)
    assert np.abs(ours - theirs).max() <= rel * scale, np.abs(ours - theirs).max()


# ---------------------------------------------------------------------------
# rasterizer (tests/test_preprocess.py's cases)
# ---------------------------------------------------------------------------

def _quad_mesh(z=2.0, size=1.0):
    verts = np.array([[-size, -size, z], [size, -size, z], [size, size, z], [-size, size, z]],
                     np.float32)
    return verts, np.array([[0, 1, 2], [0, 2, 3]], np.int64)


K64 = np.array([[50.0, 0, 32], [0, 50.0, 32], [0, 0, 1]], np.float32)


def _both(verts, faces, w2c, K, h, w, **kw):
    jd, jn = jras.rasterize_mesh(verts, faces, w2c, K, h, w)
    td, tn = tras.rasterize_mesh(verts, faces, w2c, K, h, w, device=CPU, **kw)
    return (jd, jn), (_np(td), _np(tn))


def _hold_render(j, t, edge_share=EDGE_SHARE):
    """Depth, hit masks and normals of the two packages within the limits
    above; returns the counts of differing hit pixels and winners."""
    (jd, jn), (td, tn) = j, t
    jhit, thit = jd > 0, td > 0
    both = jhit & thit
    n_hit = max(int(jhit.sum()), 1)
    mask_diff = int((jhit != thit).sum())
    assert mask_diff <= edge_share * n_hit, (mask_diff, n_hit)
    assert np.all(np.abs(td[both] - jd[both]) <= 1e-6 * jd[both])
    nd = np.abs(tn[both] - jn[both]).max(axis=-1)
    winner_diff = int((nd > 1e-5).sum())
    assert winner_diff <= edge_share * n_hit, (winner_diff, n_hit)
    return mask_diff, winner_diff


def test_rasterize_flat_quad():
    verts, faces = _quad_mesh(z=2.0)
    j, t = _both(verts, faces, np.eye(4, dtype=np.float32), K64, 64, 64)
    _hold_render(j, t)
    depth, normal = t
    hit = depth > 0
    assert hit.mean() > 0.3
    assert np.allclose(depth[hit], 2.0, atol=1e-3)
    n = normal[hit]
    assert np.allclose(np.abs(n[:, 2]), 1.0, atol=1e-4) and (n[:, 2] < 0).all()


def test_rasterize_occlusion():
    v1, f1 = _quad_mesh(z=2.0)
    v2, f2 = _quad_mesh(z=1.0, size=0.3)
    verts, faces = np.concatenate([v1, v2]), np.concatenate([f1, f2 + 4])
    j, t = _both(verts, faces, np.eye(4, dtype=np.float32), K64, 64, 64)
    _hold_render(j, t)
    depth = t[0]
    assert np.isclose(depth[32, 32], 1.0, atol=1e-3)
    assert np.isclose(depth[12, 32], 2.0, atol=1e-3)


def test_vertex_normals_sphere_direction():
    n_lat, n_lon = 16, 32
    lat = np.linspace(0.1, np.pi - 0.1, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    pts = np.stack([np.outer(np.sin(lat), np.cos(lon)), np.outer(np.sin(lat), np.sin(lon)),
                    np.outer(np.cos(lat), np.ones(n_lon))], axis=-1).reshape(-1, 3)
    faces = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = (i + 1) * n_lon + j, (i + 1) * n_lon + (j + 1) % n_lon
            faces += [[a, b, c], [b, d, c]]
    pts, faces = pts.astype(np.float32), np.asarray(faces, np.int64)
    ours = _np(tras.compute_vertex_normals(torch.from_numpy(pts), torch.from_numpy(faces)))
    theirs = jras.compute_vertex_normals(pts, faces)
    assert np.abs(ours - theirs).max() <= 1e-6  # float32 sums of the same face normals
    dots = np.abs(np.sum(ours * pts, axis=1))
    assert (dots > 0.95).mean() > 0.95


def test_ply_roundtrip(tmp_path):
    verts, faces = _quad_mesh()
    path = str(tmp_path / "mesh.ply")
    tras.write_ply_mesh(path, verts, faces)
    ours, theirs = tras.read_ply_mesh(path), jras.read_ply_mesh(path)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.allclose(ours[0], verts) and np.array_equal(ours[1], faces)


def _random_soup(rng, n, h, w):
    """n random triangles in front of a camera at the origin, float32,
    some of them large (a tenth span most of the frame)."""
    centre = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.2, 1.2, n),
                       rng.uniform(1.0, 6.0, n)], -1)
    size = np.where(rng.random(n) < 0.1, rng.uniform(0.5, 2.0, n), rng.uniform(0.02, 0.3, n))
    verts = (centre[:, None] + size[:, None, None] * rng.normal(size=(n, 3, 3))).reshape(-1, 3)
    verts[:, 2] = np.maximum(verts[:, 2], 0.05)
    faces = np.arange(3 * n, dtype=np.int64).reshape(n, 3)
    return verts.astype(np.float32), faces


def _grid_mesh(rng, nx, ny):
    """A random heightfield of (nx - 1) (ny - 1) quads, every inner edge
    shared by two faces."""
    xs, ys = np.meshgrid(np.linspace(-2, 2, nx), np.linspace(-1.5, 1.5, ny))
    zs = 3.0 + 0.3 * rng.normal(size=xs.shape)
    verts = np.stack([xs, ys, zs], -1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(nx * ny).reshape(ny, nx)
    a, b, c, d = idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1], idx[1:, 1:]
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([b, d, c], -1).reshape(-1, 3)]).astype(np.int64)
    return verts, faces


def _pose(rng, dtype):
    """A small rotation and shift of the camera, OpenCV world-to-camera."""
    from scipy.spatial.transform import Rotation

    w2c = np.eye(4)
    w2c[:3, :3] = Rotation.from_rotvec(rng.normal(scale=0.05, size=3)).as_matrix()
    w2c[:3, 3] = rng.normal(scale=0.1, size=3)
    return w2c.astype(dtype)


@pytest.mark.parametrize("scene,pose_dtype,seed", [("soup", np.float64, 0),
                                                    ("soup", np.float32, 1),
                                                    ("grid", np.float64, 2),
                                                    ("grid", np.float32, 3)])
def test_rasterize_random_meshes_match_jax(scene, pose_dtype, seed):
    """Seeded random meshes (a triangle soup with overlaps and frame-wide
    faces; a heightfield whose inner edges are all shared) under a float64
    and a float32 pose (the ScanNet++ iPhone path's): depth, hit masks and
    normals within the limits above, also when the faces are cut into
    many chunks."""
    rng = np.random.default_rng(seed)
    h, w = 48, 64
    verts, faces = _random_soup(rng, 300, h, w) if scene == "soup" else _grid_mesh(rng, 24, 18)
    w2c = _pose(rng, pose_dtype)
    K = np.array([[40.0, 0, 31.5], [0, 40.0, 23.5], [0, 0, 1]], np.float32)
    j, t = _both(verts, faces, w2c, K, h, w)
    _hold_render(j, t)
    assert (t[0] > 0).mean() > 0.3
    chunked = tras.rasterize_mesh(verts, faces, w2c, K, h, w, max_pixels=257, device=CPU)
    for a, b in zip(chunked, t):
        assert np.array_equal(_np(a), b)  # the chunks change no bit


def test_rasterize_keeps_a_frame_wide_face():
    """One face next to the camera covers the whole frame: kept, as the JAX
    package keeps it, also with chunks far smaller than its box."""
    verts = np.array([[-50, -50, 0.5], [50, -50, 0.5], [0, 50, 0.5]], np.float32)
    faces = np.array([[0, 1, 2]], np.int64)
    j, t = _both(verts, faces, np.eye(4), K64, 64, 64, max_pixels=100)
    _hold_render(j, t)
    assert (t[0] > 0).all()


# ---------------------------------------------------------------------------
# 7-Scenes depth registration
# ---------------------------------------------------------------------------

def test_depth_registration_identity_rig():
    h, w = 480, 640
    depth = np.full((h, w), 2000, np.uint16)
    kw = dict(depth_K=jseven.DEPTH_K, rgb_K=jseven.DEPTH_K, depth_to_rgb=np.eye(4, dtype=np.float32))
    ours = _np(tseven.register_depth_to_rgb(depth, device=CPU, **kw))
    theirs = jseven.register_depth_to_rgb(depth, **kw)
    assert np.array_equal(ours, theirs.astype(np.int32))
    valid = ours > 0
    assert valid.mean() > 0.99 and np.allclose(ours[valid], 2000, atol=1)


def test_depth_registration_shifts_points():
    h, w = 120, 160
    K = np.array([[100.0, 0, 80], [0, 100.0, 60], [0, 0, 1]], np.float32)
    rig = np.eye(4, dtype=np.float32)
    rig[0, 3] = 0.1
    depth = np.zeros((h, w), np.uint16)
    depth[60, 80] = 1000
    ours = _np(tseven.register_depth_to_rgb(depth, depth_K=K, rgb_K=K, depth_to_rgb=rig,
                                            device=CPU))
    assert np.array_equal(ours, jseven.register_depth_to_rgb(depth, depth_K=K, rgb_K=K,
                                                             depth_to_rgb=rig))
    ys, xs = np.nonzero(ours)
    assert xs.tolist() == [90] and ys.tolist() == [60]


@pytest.mark.parametrize("seed", [0, 1])
def test_depth_registration_random_frame_bitwise(seed):
    """A seeded Kinect frame at 480 x 640 (a noisy slanted wall, holes of 0
    and 65535) through the standard calibration: bitwise the JAX package's."""
    rng = np.random.default_rng(seed)
    h, w = 480, 640
    vv, uu = np.mgrid[0:h, 0:w]
    depth = 1500 + 2.0 * uu + 1.5 * vv + rng.normal(scale=30, size=(h, w))
    depth = np.clip(depth, 1, 65534).astype(np.uint16)
    depth[rng.random((h, w)) < 0.05] = 0
    depth[rng.random((h, w)) < 0.02] = jseven.INVALID_DEPTH
    ours = _np(tseven.register_depth_to_rgb(depth, device=CPU))
    theirs = jseven.register_depth_to_rgb(depth)
    assert np.array_equal(ours, theirs.astype(np.int32))
    assert (ours > 0).mean() > 0.5


# ---------------------------------------------------------------------------
# COLMAP (tests/test_colmap.py's cases)
# ---------------------------------------------------------------------------

@pytest.fixture
def sfm_dir(tmp_path):
    (tmp_path / "cameras.txt").write_text(
        "# Camera list with one line of data per camera:\n"
        "1 OPENCV_FISHEYE 64 48 40.0 40.0 32.0 24.0 0.05 -0.01 0.002 -0.0005\n"
        "2 PINHOLE 64 48 50.0 50.0 32.0 24.0\n")
    (tmp_path / "images.txt").write_text(
        "# Image list with two lines of data per image\n"
        "1 1 0 0 0 0 0 0 1 DSC00001.JPG\n"
        "10.5 20.25 7 30.0 40.0 -1\n"
        "2 0.7071068 0 0.7071068 0 1 2 3 2 DSC00002.JPG\n"
        "\n")
    (tmp_path / "points3D.txt").write_text("# 3D point list\n7 1.0 2.0 3.0 255 0 0 0.5 1 0 2 1\n")
    return str(tmp_path)


def test_parse_colmap_model(sfm_dir):
    cams, imgs, pts = tcolmap.load_colmap_model(sfm_dir)
    jcams, jimgs, jpts = jcolmap.load_colmap_model(sfm_dir)
    for i in (1, 2):
        assert (cams[i].model, cams[i].width, cams[i].height) == \
            (jcams[i].model, jcams[i].width, jcams[i].height)
        assert np.array_equal(cams[i].params, jcams[i].params)
        assert (imgs[i].name, imgs[i].camera_id) == (jimgs[i].name, jimgs[i].camera_id)
        assert np.array_equal(imgs[i].xys, jimgs[i].xys)
        assert np.array_equal(imgs[i].point3d_ids, jimgs[i].point3d_ids)
        _close(imgs[i].cam_to_world, jimgs[i].cam_to_world)
    assert imgs[1].point3d_ids.tolist() == [7, -1]
    assert np.allclose(_np(imgs[1].cam_to_world), np.eye(4))
    assert np.array_equal(pts[7], jpts[7])
    assert tcolmap.get_frame_number("DSC00042.JPG") == 42 == jcolmap.get_frame_number("DSC00042.JPG")


def test_quat_to_rotmat_properties(rng):
    q = rng.normal(size=4)
    R = tcolmap.quat_to_rotmat(q)
    _close(R, jcolmap.quat_to_rotmat(q))
    assert torch.allclose(R @ R.T, torch.eye(3, dtype=torch.float64), atol=1e-12)
    assert np.isclose(torch.linalg.det(R).item(), 1.0)
    _close(tcolmap.quat_to_rotmat(np.array([0, 0, 0, 1.0])), np.diag([-1.0, -1.0, 1.0]))


def test_intrinsics_convention_roundtrip():
    K = np.array([[40.0, 0, 32.0], [0, 40.0, 24.0], [0, 0, 1]])
    ours = tcolmap.colmap_to_opencv_intrinsics(K)
    assert np.array_equal(_np(ours), jcolmap.colmap_to_opencv_intrinsics(K))
    assert np.array_equal(_np(tcolmap.opencv_to_colmap_intrinsics(ours)), K)


def test_fisheye_distortion_inverse(rng):
    dist = np.array([0.03, -0.008, 0.001, -0.0002])
    xy = rng.uniform(-0.6, 0.6, size=(50, 2))
    d = tcolmap.distort_fisheye(xy, dist)
    _close(d, jcolmap.distort_fisheye(xy, dist))
    back = tcolmap._undistort_points_fisheye(d, dist)
    _close(back, jcolmap._undistort_points_fisheye(_np(d), dist))
    assert np.abs(_np(back) - xy).max() < 1e-9
    _close(tcolmap.distort_fisheye(xy, np.zeros(4)), jcolmap.distort_fisheye(xy, np.zeros(4)))


def test_opencv_distortion_zero_is_identity(rng):
    xy = rng.uniform(-0.5, 0.5, size=(20, 2))
    for dist in (np.zeros(5), np.array([0.1, 0, 0, 0]), np.array([0.1, -0.02, 1e-3, -2e-3, 0.01])):
        _close(tcolmap.distort_opencv(xy, dist), jcolmap.distort_opencv(xy, dist))
    assert np.allclose(_np(tcolmap.distort_opencv(xy, np.zeros(5))), xy)


def test_undistort_map_identity_for_pinhole():
    K = np.array([[50.0, 0, 32.0], [0, 50.0, 24.0], [0, 0, 1]])
    for model, dist in (("PINHOLE", np.zeros(4)), ("OPENCV", np.array([0.1, -0.02, 1e-3, -2e-3])),
                        ("OPENCV_FISHEYE", np.array([0.05, -0.01, 0.002, -0.0005]))):
        ours = tcolmap.undistort_rectify_map(K, dist, K, (64, 48), model)
        theirs = jcolmap.undistort_rectify_map(K, dist, K, (64, 48), model)
        assert ours.dtype == torch.float32 and np.abs(_np(ours) - theirs).max() <= 1e-4
    with pytest.raises(ValueError):
        tcolmap.undistort_rectify_map(K, np.zeros(4), K, (64, 48), "FOV")


def test_remap_bilinear_shifts(rng):
    img = np.arange(12.0).reshape(3, 4)
    xs, ys = np.meshgrid(np.arange(4.0) + 1, np.arange(3.0))
    m = np.stack([xs, ys], -1).astype(np.float32)
    ours = tcolmap.remap_bilinear(img, m, fill=-1)
    assert np.array_equal(_np(ours), jcolmap.remap_bilinear(img, m, fill=-1))
    assert np.allclose(_np(ours)[:, :2], img[:, 1:3]) and (_np(ours)[:, -1] == -1).all()
    # random maps over a colour image, the exact border and out-of-range
    # coordinates included: bitwise
    image = rng.random((20, 30, 3)).astype(np.float32)
    m = np.stack([rng.uniform(-2, 31, (25, 35)), rng.uniform(-2, 21, (25, 35))], -1)
    m[0, :5] = [29.0, 19.0]
    m = m.astype(np.float32)
    assert np.array_equal(_np(tcolmap.remap_bilinear(image, m)), jcolmap.remap_bilinear(image, m))


def _fisheye_stripe_camera():
    w, h = 96, 72
    fx = fy = 60.0
    cx, cy = w / 2, h / 2
    dist = np.array([0.08, -0.02, 0.004, -0.001])
    cams = [c.ColmapCamera(1, "OPENCV_FISHEYE", w, h, np.array([fx, fy, cx + 0.5, cy + 0.5, *dist]))
            for c in (tcolmap, jcolmap)]
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    xy_u = jcolmap._undistort_points_fisheye(np.stack([(xs - cx) / fx, (ys - cy) / fy], -1), dist)
    stripe = (np.abs(xy_u[..., 0] - 0.25) < 0.02).astype(np.float32)
    return cams, stripe


def test_undistort_image_fisheye_straightens_lines():
    (tcam, jcam), stripe = _fisheye_stripe_camera()
    new_k, und, mask = tcolmap.undistort_image(tcam, stripe, device=CPU)
    jk, jund, jmask = jcolmap.undistort_image(jcam, stripe)
    _close(new_k, jk)
    assert np.abs(_np(und) - jund).max() <= 1e-3
    assert (_np(mask) != jmask).mean() <= 0.01  # the mask's 0.999 threshold
    new_k_cv = _np(tcolmap.colmap_to_opencv_intrinsics(new_k))
    col = new_k_cv[0, 0] * 0.25 + new_k_cv[0, 2]
    cols = np.where((_np(und) > 0.5) & _np(mask))
    assert cols[1].size > 50
    assert np.abs(cols[1].mean() - col) < 1.5 and cols[1].std() < 2.0


def test_estimate_new_camera_centers_principal():
    K = np.array([[60.0, 0, 48.0], [0, 60.0, 36.0], [0, 0, 1]])
    dist = np.array([0.08, -0.02, 0.004, -0.001])
    for balance, center in ((0.0, True), (0.5, False)):
        ours = tcolmap.estimate_new_camera_fisheye(K, dist, (96, 72), balance=balance,
                                                   center_principal=center)
        _close(ours, jcolmap.estimate_new_camera_fisheye(K, dist, (96, 72), balance=balance,
                                                         center_principal=center))
    newk = _np(tcolmap.estimate_new_camera_fisheye(K, dist, (96, 72)))
    assert newk[0, 2] == 48.0 and newk[1, 2] == 36.0 and newk[0, 0] > 0


def test_entry_points_refuse_a_missing_card():
    """The entry points run on the card unless asked for the CPU: without
    one they raise rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    verts, faces = _quad_mesh()
    with pytest.raises(RuntimeError):
        tras.rasterize_mesh(verts, faces, np.eye(4), K64, 8, 8)
    with pytest.raises(RuntimeError):
        tseven.register_depth_to_rgb(np.zeros((4, 4), np.uint16))
