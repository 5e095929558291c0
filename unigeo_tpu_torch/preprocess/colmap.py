"""COLMAP text models and camera undistortion, on tensors.

Port of ``unigeo_tpu/preprocess/colmap.py``.  The text parsers and their
dataclasses stay on the host (plain Python and numpy, as read from disk);
everything that computes runs on tensors, on the device of its tensor
arguments (a numpy argument is taken onto the CPU), in float64 as the JAX
package computes in numpy's float64:

  * OPENCV_FISHEYE (equidistant): theta_d = theta (1 + k1 theta^2 + k2
    theta^4 + k3 theta^6 + k4 theta^8); the undistort map is the forward
    distortion evaluated on the target grid (cv2.fisheye's
    initUndistortRectifyMap construction: target pixel -> normalized ray ->
    distort -> source pixel).
  * OPENCV (pinhole + radial / tangential): k1, k2, p1, p2[, k3].

COLMAP puts the pixel origin at the corner of the first pixel (cx ~ W / 2),
OpenCV at its centre: ``colmap_to_opencv_intrinsics`` shifts the principal
point by -0.5.  images.txt stores world-to-camera as (qw, qx, qy, qz, tx,
ty, tz); ``pose_from_qwxyz_txyz`` returns camera-to-world.

``remap_bilinear`` is not ``grid_sample``: it clamps the base cell to
w - 2 (h - 2) before it takes the fraction, counts a pixel valid only for
0 <= x <= w - 1 and 0 <= y <= h - 1, and sums the four taps in float64,
as explicit gathers in the JAX package's order, so the two agree to the bit
where the libraries' elementwise float64 arithmetic does.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from unigeo_tpu_torch.device import resolve_device

F64 = torch.float64


def _t(x, dtype=F64, device=None) -> torch.Tensor:
    """``x`` as a tensor of ``dtype``: a tensor stays on its device, anything
    else goes to ``device`` (the CPU by default)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# parsing (host)
# ---------------------------------------------------------------------------

@dataclass
class ColmapCamera:
    camera_id: int
    model: str  # PINHOLE | OPENCV | OPENCV_FISHEYE | ...
    width: int
    height: int
    params: np.ndarray  # model-specific: fx fy cx cy [distortion...]


@dataclass
class ColmapImage:
    image_id: int
    camera_id: int
    name: str
    qvec: np.ndarray  # (qw, qx, qy, qz) world-to-camera rotation
    tvec: np.ndarray  # (tx, ty, tz) world-to-camera translation
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    point3d_ids: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int64))

    @property
    def cam_to_world(self) -> torch.Tensor:
        """Camera-to-world [4, 4] float64 on the CPU."""
        return pose_from_qwxyz_txyz(self.qvec, self.tvec)


def _data_lines(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    for ln in _data_lines(path):
        parts = ln.split()
        cam = ColmapCamera(camera_id=int(parts[0]), model=parts[1], width=int(parts[2]),
                           height=int(parts[3]), params=np.array([float(p) for p in parts[4:]]))
        cams[cam.camera_id] = cam
    return cams


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    # keep EMPTY lines: an image with no 2D observations still has its
    # (blank) points line, and dropping it would break the 2-line pairing
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f if not ln.startswith("#")]
    while lines and not lines[-1].strip():
        lines.pop()  # a trailing newline at EOF is not a points line
    if len(lines) % 2:
        lines.append("")
    imgs = {}
    for meta, pts in zip(lines[0::2], lines[1::2]):
        parts = meta.split()
        img = ColmapImage(image_id=int(parts[0]), qvec=np.array([float(v) for v in parts[1:5]]),
                          tvec=np.array([float(v) for v in parts[5:8]]),
                          camera_id=int(parts[8]), name=parts[9])
        vals = pts.split()
        if vals:
            arr = np.array(vals, dtype=np.float64).reshape(-1, 3)
            img.xys = arr[:, :2]
            img.point3d_ids = arr[:, 2].astype(np.int64)
        imgs[img.image_id] = img
    return imgs


def read_points3d_text(path: str) -> Dict[int, np.ndarray]:
    pts = {}
    for ln in _data_lines(path):
        parts = ln.split()
        pts[int(parts[0])] = np.array([float(v) for v in parts[1:4]])
    return pts


def load_colmap_model(sfm_dir: str):
    """(cameras, images, points3D) from a COLMAP text model directory."""
    return (read_cameras_text(os.path.join(sfm_dir, "cameras.txt")),
            read_images_text(os.path.join(sfm_dir, "images.txt")),
            read_points3d_text(os.path.join(sfm_dir, "points3D.txt")))


def get_frame_number(name: str) -> int:
    """'DSC01234.JPG' / 'frame_000123.jpg' -> the trailing integer."""
    m = re.findall(r"(\d+)", os.path.splitext(os.path.basename(name))[0])
    return int(m[-1]) if m else -1


# ---------------------------------------------------------------------------
# poses and intrinsics conventions
# ---------------------------------------------------------------------------

def quat_to_rotmat(q) -> torch.Tensor:
    """(qw, qx, qy, qz), not necessarily normalized -> [3, 3] float64."""
    q = _t(q)
    w, x, y, z = q / torch.linalg.vector_norm(q)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])


def pose_from_qwxyz_txyz(qvec, tvec) -> torch.Tensor:
    """COLMAP world-to-camera (q, t) -> camera-to-world [4, 4] float64."""
    rot = quat_to_rotmat(qvec)
    w2c = torch.eye(4, dtype=F64, device=rot.device)
    w2c[:3, :3] = rot
    w2c[:3, 3] = _t(tvec, device=rot.device)
    return torch.linalg.inv(w2c)


def colmap_to_opencv_intrinsics(K) -> torch.Tensor:
    """COLMAP puts the origin at the corner of the first pixel, OpenCV at
    its centre: shift the principal point by -0.5."""
    K = _t(K).clone()
    K[0, 2] -= 0.5
    K[1, 2] -= 0.5
    return K


def opencv_to_colmap_intrinsics(K) -> torch.Tensor:
    K = _t(K).clone()
    K[0, 2] += 0.5
    K[1, 2] += 0.5
    return K


# ---------------------------------------------------------------------------
# distortion models (forward: normalized undistorted -> distorted)
# ---------------------------------------------------------------------------

def _fisheye_poly(theta, dist):
    k1, k2, k3, k4 = (float(c) for c in dist[:4])
    t2 = theta * theta
    return 1 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4


def distort_fisheye(xy, dist) -> torch.Tensor:
    """OPENCV_FISHEYE (equidistant) forward model on normalized coords
    [..., 2]: theta_d = theta (1 + k1 theta^2 + k2 theta^4 + ...)."""
    xy = _t(xy)
    r = torch.sqrt(torch.sum(xy**2, dim=-1, keepdim=True))
    theta = torch.arctan(r)
    theta_d = theta * _fisheye_poly(theta, dist)
    scale = torch.where(r > 1e-8, theta_d / torch.clamp(r, min=1e-12), 1.0)
    return xy * scale


def distort_opencv(xy, dist) -> torch.Tensor:
    """OPENCV (radial k1 k2 [k3] + tangential p1 p2) forward model."""
    xy = _t(xy)
    d = np.zeros(5)
    d[: len(dist)] = np.asarray(dist, np.float64)
    k1, k2, p1, p2, k3 = (float(c) for c in d)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def _undistort_points_fisheye(pts, dist, iters: int = 20) -> torch.Tensor:
    """Invert ``distort_fisheye`` on normalized coords (fixed point on theta)."""
    pts = _t(pts)
    r_d = torch.sqrt(torch.sum(pts**2, dim=-1, keepdim=True))
    theta_d = r_d  # the distorted radius IS theta_d in normalized fisheye coords
    theta = theta_d.clone()
    for _ in range(iters):
        theta = theta_d / _fisheye_poly(theta, dist)
    scale = torch.where(r_d > 1e-8, torch.tan(theta) / torch.clamp(r_d, min=1e-12), 1.0)
    return pts * scale


def estimate_new_camera_fisheye(K, dist, size_wh: Tuple[int, int], balance: float = 0.0,
                                center_principal: bool = True) -> torch.Tensor:
    """New pinhole K [3, 3] float64 for the undistorted fisheye image.

    Undistorts the 4 edge midpoints (the cv2.fisheye estimator's probe
    points), fits the focal between fmin (every probe inside) and fmax (the
    probes fill the frame), blends by ``balance`` (0 = fmax, widest), and
    with ``center_principal`` re-centres the principal point."""
    K = _t(K)
    w, h = size_wh
    probes = torch.tensor([[w / 2, 0.0], [w, h / 2], [w / 2, h], [0.0, h / 2]], dtype=F64,
                          device=K.device)
    norm = (probes - K[:2, 2]) / torch.stack([K[0, 0], K[1, 1]])
    und = _undistort_points_fisheye(norm, dist)
    c = und.mean(dim=0)
    span = (und - c).abs()
    half = torch.tensor([w / 2, h / 2], dtype=F64, device=K.device)
    # per-probe focal that would place it exactly on the image border
    f_each = torch.where(span > 1e-12, half / torch.clamp(span, min=1e-12), torch.inf)
    f_each = f_each[torch.isfinite(f_each).any(dim=-1)]
    finite = f_each[torch.isfinite(f_each)]
    f = balance * finite.min() + (1.0 - balance) * finite.max()
    zero, one = torch.zeros((), dtype=F64, device=K.device), torch.ones((), dtype=F64,
                                                                       device=K.device)
    new_k = torch.stack([torch.stack([f, zero, w / 2 - c[0] * f]),
                         torch.stack([zero, f, h / 2 - c[1] * f]),
                         torch.stack([zero, zero, one])])
    if center_principal:
        new_k[0, 2] = w / 2.0
        new_k[1, 2] = h / 2.0
    return new_k


def undistort_rectify_map(K, dist, new_K, size_wh: Tuple[int, int], model: str) -> torch.Tensor:
    """[H, W, 2] float32 map: target (undistorted, new_K) pixel -> source
    pixel (the cv2 initUndistortRectifyMap construction), on K's device."""
    K = _t(K)
    new_K = _t(new_K, device=K.device)
    w, h = size_wh
    ys, xs = torch.meshgrid(torch.arange(h, dtype=F64, device=K.device),
                            torch.arange(w, dtype=F64, device=K.device), indexing="ij")
    xn = (xs - new_K[0, 2]) / new_K[0, 0]
    yn = (ys - new_K[1, 2]) / new_K[1, 1]
    xy = torch.stack([xn, yn], dim=-1)
    if model == "OPENCV_FISHEYE":
        d = distort_fisheye(xy, dist)
    elif model in ("OPENCV", "PINHOLE"):
        d = distort_opencv(xy, dist if model == "OPENCV" else np.zeros(4))
    else:
        raise ValueError(f"unsupported camera model {model!r}")
    sx = d[..., 0] * K[0, 0] + K[0, 2]
    sy = d[..., 1] * K[1, 1] + K[1, 2]
    return torch.stack([sx, sy], dim=-1).to(torch.float32)


def remap_bilinear(image, src_map, fill: float = 0.0) -> torch.Tensor:
    """Bilinear remap of ``image`` [H, W(, C)] at ``src_map`` [Ho, Wo, 2]
    source coords (x, y) -> float64 [Ho, Wo(, C)], ``fill`` outside.

    Not ``grid_sample``: the base cell is clamped to [0, w - 2] x [0, h - 2]
    BEFORE the fraction is taken, so the exact border (x == w - 1) takes the
    last cell with weight 1; a pixel is valid for 0 <= x <= w - 1 and
    0 <= y <= h - 1 only; the four taps are gathered and summed in float64
    in the JAX package's order."""
    if not isinstance(src_map, torch.Tensor):
        src_map = torch.as_tensor(np.asarray(src_map, np.float32))
    image = _t(image, device=src_map.device)
    h, w = image.shape[:2]
    img = image if image.dim() == 3 else image[..., None]
    x, y = src_map[..., 0], src_map[..., 1]
    valid = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    x0c = torch.clamp(torch.floor(x), 0, w - 2).to(torch.int64)
    y0c = torch.clamp(torch.floor(y), 0, h - 2).to(torch.int64)
    fx = torch.clamp(x.to(F64) - x0c.to(F64), 0.0, 1.0)[..., None]
    fy = torch.clamp(y.to(F64) - y0c.to(F64), 0.0, 1.0)[..., None]
    p00 = img[y0c, x0c]
    p01 = img[y0c, x0c + 1]
    p10 = img[y0c + 1, x0c]
    p11 = img[y0c + 1, x0c + 1]
    out = (p00 * (1 - fx) * (1 - fy) + p01 * fx * (1 - fy)
           + p10 * (1 - fx) * fy + p11 * fx * fy)
    out = torch.where(valid[..., None], out, torch.tensor(fill, dtype=F64, device=out.device))
    return out if image.dim() == 3 else out[..., 0]


def undistort_image(camera: ColmapCamera, image, balance: float = 0.0, device="cuda"):
    """Undistort one image on ``device``: (new_K in COLMAP's convention
    [3, 3] float64, the undistorted image float64 [H, W(, C)], its validity
    mask [H, W] bool).  A fisheye camera gets the estimated new pinhole K,
    any other keeps its focal with the distortion removed."""
    dev = resolve_device(device)
    fx, fy, cx, cy = camera.params[:4]
    dist = camera.params[4:]
    K = colmap_to_opencv_intrinsics(
        torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]], dtype=F64, device=dev))
    size = (camera.width, camera.height)
    if camera.model == "OPENCV_FISHEYE":
        new_k = estimate_new_camera_fisheye(K, dist, size, balance=balance)
    else:
        new_k = K.clone()  # keep the focal; distortion removed on the same frame
    src_map = undistort_rectify_map(K, dist, new_k, size, camera.model)
    image = _t(image, dtype=torch.float32, device=dev).to(dev)
    und = remap_bilinear(image, src_map)
    mask = remap_bilinear(torch.ones(image.shape[:2], dtype=torch.float32, device=dev),
                          src_map, fill=0.0)
    return opencv_to_colmap_intrinsics(new_k), und, mask > 0.999
