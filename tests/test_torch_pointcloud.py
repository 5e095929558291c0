"""The port's point-cloud metrics and nearest neighbours against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages in f32;
the JAX functions are the jitted ones of ``unigeo_tpu``.

Tolerances (u = 2^-24, the f32 unit roundoff):

* ``nearest_neighbor`` / ``knn`` on points whose coordinates are multiples
  of 2^-6 below 2 in magnitude: every product and sum of the expansion
  ||q||^2 + ||r||^2 - 2 q.r is exact in f32 in both packages, so the
  indices are equal, ties included (duplicated reference points: the lower
  index first, as ``lax.top_k`` keeps it), and the distances within one
  ulp (2^-23 relative: XLA's vectorized f32 sqrt on the CPU is not always
  correctly rounded; seen on 14 of 2880).  On random f32
  points the squared distances are held to E = 16 u (||q||^2 + ||r||^2),
  the first-order bound of the expansion's roundings (3-term dots, two
  sums) in either package, and the indices are equal.
* ``scale_shift_align``: the medians are order statistics of the same f32
  values, so the shifts are equal; the scales within 4u relative (a 3-term
  norm, rounded in another order); the aligned cloud within 1e-6 of its
  largest magnitude.
* ICP on a perturbed non-planar cloud (4 degrees, 3 cm, 10% gross
  outliers): the transform within 1e-5 and the moved cloud within 1e-5 of
  its largest magnitude of the JAX result (seen: 1.8e-6 and 4.8e-6; the
  same 30 sweeps with f32 sums in other orders and LAPACK's 3x3 SVD); both
  recover the perturbation to 2e-3 (the noise's effect).  Zero inliers:
  both keep the identity exactly.  A planar cloud (rank-deficient H, where
  the SVD's signs are not unique): identity in, the perfect score out.
* ``estimate_normals`` on a noisy curved surface: compared through |dot|
  (the sign of an eigenvector is arbitrary): 1 - |dot| <= 1e-5 (seen 5e-7).
* ``accuracy_completion`` on dyadic points (exact squared distances): the
  medians within one ulp of sqrt, the means within 1e-6 relative (f32 sums
  in JAX, f64 here).
* ``pcd_evaluation`` end to end with downsampling: the same points are
  picked (gt equal, pred within 1e-6 of its largest magnitude), and the
  distance statistics v within 1e-5 max|q| (the moved clouds) + 2 E / v, E
  = 16 u max|q|^2: a distance d carries E / (2 d) of the expansion's
  round-off; the normal consistencies within 1e-4.
"""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigeo_tpu.metrics import pointcloud as jpc
from unigeo_tpu.metrics._masked import masked_median as j_masked_median
from unigeo_tpu.ops.knn import knn as j_knn
from unigeo_tpu.ops.knn import nearest_neighbor as j_nearest_neighbor
from unigeo_tpu_torch.metrics import pointcloud as ppc
from unigeo_tpu_torch.metrics._masked import masked_median
from unigeo_tpu_torch.ops import knn as pknn

U = 2.0**-24


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _dyadic(rng, n, scale=64):
    """Points with coordinates k / 64, |k| < 2 * 64: exact expansions in f32."""
    return (rng.integers(-2 * scale + 1, 2 * scale, (n, 3)) / scale).astype(np.float32)


def _rotation(deg_xyz):
    ax, ay, az = np.radians(deg_xyz)
    rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)], [0, np.sin(ax), np.cos(ax)]])
    ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0], [-np.sin(ay), 0, np.cos(ay)]])
    rz = np.array([[np.cos(az), -np.sin(az), 0], [np.sin(az), np.cos(az), 0], [0, 0, 1]])
    return rz @ ry @ rx


def _surface(rng, n, noise=0.0):
    """A curved, non-planar patch z = 0.3 sin(2x) cos(2y) over [-1, 1]^2."""
    xy = rng.uniform(-1, 1, (n, 2))
    z = 0.3 * np.sin(2 * xy[:, 0]) * np.cos(2 * xy[:, 1])
    return (np.c_[xy, z] + rng.normal(0, noise, (n, 3))).astype(np.float32)


@pytest.mark.parametrize("semantics", ["torch", "numpy"])
@pytest.mark.parametrize("n", [7, 8, 0])
def test_masked_median_semantics_match_jax(semantics, n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(3, 5)).astype(np.float32)
    mask = np.zeros(15, bool)
    mask[rng.permutation(15)[:n]] = True
    mask = mask.reshape(3, 5)
    ref = float(j_masked_median(jnp.asarray(x), jnp.asarray(mask), semantics=semantics))
    assert float(masked_median(_t(x), _t(mask), semantics)) == ref
    with pytest.raises(ValueError):
        masked_median(_t(x), _t(mask), "mean")


# --- nearest neighbours ----------------------------------------------------------


def test_nearest_neighbor_and_knn_exact_on_dyadic_points_with_ties():
    rng = np.random.default_rng(0)
    ref = _dyadic(rng, 150)
    ref = np.concatenate([ref, ref[::-1]])  # every point twice: exact ties
    query = np.concatenate([_dyadic(rng, 200), ref[:40]])
    jd, ji = j_nearest_neighbor(jnp.asarray(query), jnp.asarray(ref))
    pd, pi = pknn.nearest_neighbor(_t(query), _t(ref))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=2.0**-23, atol=0)
    jd, ji = j_knn(jnp.asarray(query), jnp.asarray(ref), k=12)
    pd, pi = pknn.knn(_t(query), _t(ref), k=12)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=2.0**-23, atol=0)
    # a duplicated pair sits side by side, the lower index first
    assert (pd[:, 0] == pd[:, 1]).all() and (pi[:, 0] < pi[:, 1]).all()


@pytest.mark.parametrize("n_ref,k", [(300, 30), (20, 30)], ids=["k<M", "k>M"])
def test_knn_and_nearest_neighbor_match_jax_on_random_points(n_ref, k):
    rng = np.random.default_rng(1)
    query = rng.normal(size=(257, 3)).astype(np.float32)
    ref = rng.normal(size=(n_ref, 3)).astype(np.float32)
    jd, ji = j_knn(jnp.asarray(query), jnp.asarray(ref), k=k)
    pd, pi = pknn.knn(_t(query), _t(ref), k=k)
    assert pd.shape == (257, k) and pi.shape == (257, k)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    bound = 16 * U * ((query**2).sum(-1)[:, None] + (ref**2).sum(-1)[pi.numpy()])
    assert (np.abs(pd.numpy() ** 2 - np.asarray(jd) ** 2) <= bound).all()
    jd1, ji1 = j_nearest_neighbor(jnp.asarray(query), jnp.asarray(ref))
    pd1, pi1 = pknn.nearest_neighbor(_t(query), _t(ref))
    np.testing.assert_array_equal(pi1.numpy(), np.asarray(ji1))
    assert (np.abs(pd1.numpy() ** 2 - np.asarray(jd1) ** 2) <= bound[:, 0]).all()


# --- alignment, ICP, normals -------------------------------------------------------


def test_scale_shift_align_matches_jax():
    rng = np.random.default_rng(2)
    gt = rng.normal(size=(2, 6, 8, 3)).astype(np.float32) + np.float32([0, 0, 3])
    pred = (1.7 * gt + rng.normal(0, 0.05, gt.shape) + np.float32([0.2, 0, -1])).astype(np.float32)
    masks = rng.random((2, 6, 8)) > 0.2
    ja, jg, jm = jpc.scale_shift_align(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(masks))
    pa, pg, pm = ppc.scale_shift_align(_t(pred), _t(gt), _t(masks))
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    for key in ("gt_shift_z", "pred_shift_z"):
        assert float(pm[key]) == float(jm[key]), key
    for key in ("gt_scale", "pred_scale"):
        assert abs(float(pm[key]) - float(jm[key])) <= 4 * U * abs(float(jm[key])), key
    ja = np.asarray(ja)
    assert np.abs(pa.numpy() - ja).max() <= 1e-6 * np.abs(ja).max()


@pytest.fixture(scope="module")
def icp_case():
    rng = np.random.default_rng(3)
    gt = _surface(rng, 300)
    rot = _rotation([3.0, -2.0, 4.0])
    pred = (gt @ rot.T + np.array([0.03, -0.02, 0.01])
            + rng.normal(0, 0.003, gt.shape)).astype(np.float32)
    pred[:30] += rng.normal(0, 0.5, (30, 3)).astype(np.float32)  # gross outliers
    jt, jm = jpc.icp_point_to_point(jnp.asarray(pred), jnp.asarray(gt))
    return gt, pred, rot, np.asarray(jt), np.asarray(jm)


def test_icp_matches_jax_and_recovers_the_perturbation(icp_case):
    gt, pred, rot, jt, jm = icp_case
    pt, pm = ppc.icp_point_to_point(_t(pred), _t(gt))
    assert np.abs(pt.numpy() - jt).max() <= 1e-5
    assert np.abs(pm.numpy() - jm).max() <= 1e-5 * np.abs(jm).max()
    assert np.abs(pt.numpy()[:3, :3] - rot.T).max() <= 2e-3
    inliers = np.linalg.norm(pm.numpy()[30:] - gt[30:], axis=-1)
    assert inliers.mean() <= 1e-2  # the 3 mm noise, not the 3 cm offset


def test_icp_without_inliers_keeps_the_identity(icp_case):
    gt, pred, *_ = icp_case
    far = pred + np.float32([10.0, 0.0, 0.0])
    jt, jm = jpc.icp_point_to_point(jnp.asarray(far), jnp.asarray(gt))
    pt, pm = ppc.icp_point_to_point(_t(far), _t(gt))
    np.testing.assert_array_equal(pt.numpy(), np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(np.asarray(jt), np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(pm.numpy(), far)
    assert np.isfinite(np.asarray(jm)).all()


def test_planar_identity_scores_perfectly():
    """A flat patch (H of rank 2: the SVD's third vectors have either sign)
    aligned to itself: the reflection fix keeps R = I, and the scores are
    perfect up to the expansion's round-off."""
    rng = np.random.default_rng(4)
    xy = rng.uniform(-1, 1, (400, 2))
    plane = np.c_[xy, np.full(400, 2.0)].astype(np.float32)
    t, moved = ppc.icp_point_to_point(_t(plane), _t(plane))
    assert np.abs(t.numpy() - np.eye(4)).max() <= 1e-5
    normals = ppc.estimate_normals(moved)
    stats = ppc.accuracy_completion(moved, _t(plane), normals, ppc.estimate_normals(_t(plane)))
    e = np.sqrt(16 * U * 2 * (plane**2).sum(-1).max())
    assert float(stats["acc"]) <= e and float(stats["comp"]) <= e
    assert float(stats["nc1"]) >= 1 - 1e-5 and float(stats["nc2"]) >= 1 - 1e-5


def test_estimate_normals_match_jax_through_abs_dot():
    rng = np.random.default_rng(5)
    pts = _surface(rng, 400, noise=0.002)
    jn = np.asarray(jpc.estimate_normals(jnp.asarray(pts)))
    pn = ppc.estimate_normals(_t(pts)).numpy()
    assert pn.shape == (400, 3)
    np.testing.assert_allclose(np.linalg.norm(pn, axis=-1), 1.0, atol=1e-5)
    assert (1.0 - np.abs((jn * pn).sum(-1))).max() <= 1e-5


def test_accuracy_completion_matches_jax_on_dyadic_points():
    rng = np.random.default_rng(6)
    gt = _dyadic(rng, 300)
    pred = _dyadic(rng, 280)
    n_gt = _surface(rng, 300)
    n_pred = _surface(rng, 280)
    n_gt /= np.linalg.norm(n_gt, axis=-1, keepdims=True)
    n_pred /= np.linalg.norm(n_pred, axis=-1, keepdims=True)
    ref = jpc.accuracy_completion(*(jnp.asarray(a) for a in (pred, gt, n_pred, n_gt)))
    ours = ppc.accuracy_completion(*(_t(a) for a in (pred, gt, n_pred, n_gt)))
    assert set(ours) == set(ref) == set(ppc.PCD_METRIC_KEYS)
    for key, val in ref.items():
        if key.endswith("_med"):  # order statistics: one ulp of sqrt
            assert abs(float(ours[key]) - float(val)) <= 2.0**-23 * abs(float(val)), key
        else:
            assert abs(float(ours[key]) - float(val)) <= 1e-6 * abs(float(val)), key


# --- the whole chain -----------------------------------------------------------------


def test_pcd_evaluation_matches_jax_with_downsampling():
    rng = np.random.default_rng(7)
    nf, h, w = 3, 12, 16
    gt = _surface(rng, nf * h * w).reshape(nf, h, w, 3) + np.float32([0, 0, 2])
    rot = _rotation([2.0, 3.0, -1.0])
    pred = (1.3 * (gt @ rot.T) + np.float32([0.05, 0.0, 0.4])
            + rng.normal(0, 0.02, gt.shape)).astype(np.float32)
    masks = rng.random((nf, h, w)) > 0.15
    rgbs = rng.random((nf, h, w, 3)).astype(np.float32)
    kw = dict(rgbs=rgbs, downsample_num=300, seed=0)
    ref = jpc.pcd_evaluation(pred, gt, masks, **kw)
    ours = ppc.pcd_evaluation(pred, gt, masks, device="cpu", **kw)
    assert set(ours) == set(ref)
    np.testing.assert_array_equal(ours["gt_pcd"][0], ref["gt_pcd"][0])
    np.testing.assert_array_equal(ours["gt_pcd"][1], ref["gt_pcd"][1])
    assert ours["pred_pcd"][0].shape == (300, 3)
    scale = np.abs(ref["pred_pcd"][0]).max()
    assert np.abs(ours["pred_pcd"][0] - ref["pred_pcd"][0]).max() <= 1e-6 * scale
    q_max = float(np.linalg.norm(gt.reshape(-1, 3), axis=-1).max())
    e = 16 * U * q_max**2
    for key in ppc.PCD_METRIC_KEYS:
        if key.startswith("nc"):
            tol = 1e-4
        else:
            tol = 1e-5 * q_max + 2 * e / ref[key]
        assert abs(ours[key] - ref[key]) <= tol, (key, ours[key], ref[key], tol)
    for key, val in ref["alignment"].items():
        assert abs(ours["alignment"][key] - val) <= 4 * U * abs(val), key
    empty = ppc.pcd_evaluation(pred, gt, np.zeros_like(masks), device="cpu")
    assert all(empty[k] == 0.0 for k in ppc.PCD_METRIC_KEYS)
