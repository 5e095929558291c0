"""Mesh rasterizer: a z-buffer on the card for depth and interpolated normals.

Port of ``unigeo_tpu/preprocess/rasterizer.py``, which renders ScanNet++'s
GT depth and normal maps on the host in numpy, one triangle after another
(the reference renders them with pyrender and GLSL shaders).  Here every
step is a tensor operation on one device:

1. project the vertices (the camera transform and K in the dtype numpy
   promotes the inputs to: float32 vertices with a float64 pose project in
   float64, an all-float32 scene in float32);
2. keep the faces with all three z > near and any z < far, take their
   screen bounding boxes (floor and ceil first, then the clip to the
   frame), and drop the empty ones;
3. split the faces into chunks of about ``max_pixels`` bounding-box
   pixels (a face larger than that is a chunk of its own: a wall next to
   the camera can cover the whole frame, and every face is kept, since
   skipping large ones would punch holes in the GT exactly where geometry
   is closest), and expand each chunk into one row per (face, pixel);
4. barycentrics and perspective-correct depth in float64 (the JAX
   package's arithmetic: the pixel coordinates minus the vertices' screen
   coordinates promote to float64), faces with |det| < 1e-12 skipped;
5. visibility by ``scatter_reduce(..., "amin")`` over one int64 key per
   covered pixel: the float32 depth's bits (positive floats order as their
   bit patterns) above the face index;
6. the winner's barycentrics recomputed, its vertex normals interpolated,
   normalized and flipped to face the camera as the JAX package does.

Ties.  The JAX package visits faces in order and lets a later face take a
pixel only if its float64 depth is strictly below the float32 depth stored
there.  The port takes the smallest float32 depth and, among equal ones,
the lowest face index.  Both keep the smallest float32 depth, so the depth
maps and hit masks agree wherever the two compute the same candidates; the
winning face (and so the normal) can differ only where two faces' depths at
a pixel round to the same float32 value and the later one's float64 depth
lies below that value (the JAX package then takes the later face, the port
keeps the earlier): shared edges and exact ties.  The candidates
themselves can differ only at pixels on a triangle's edge, where a
barycentric within rounding of 0 may land on either side of it (the
products' summation order differs between numpy and the device).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from unigeo_tpu_torch.device import resolve_device

INT64_MAX = torch.iinfo(torch.int64).max


def _t(x, device, dtype=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)


def compute_vertex_normals(vertices, faces) -> torch.Tensor:
    """Area-weighted vertex normals [V, 3], on the vertices' device, in
    their dtype."""
    vertices = _t(vertices, None)
    faces = _t(faces, vertices.device, torch.int64)
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    fn = torch.linalg.cross(v1 - v0, v2 - v0)  # area-weighted
    normals = torch.zeros_like(vertices)
    for i in range(3):
        normals.index_add_(0, faces[:, i], fn)
    norm = torch.linalg.vector_norm(normals, dim=1, keepdim=True)
    return normals / torch.clamp(norm, min=1e-12)


def _project(vertices, w2c, K):
    """Camera-space z and screen (u, v) of every vertex, each product
    written out so no TF32 or library GEMM decides the rounding."""
    cdt = torch.promote_types(vertices.dtype, w2c.dtype)
    R, t = w2c[:3, :3].to(cdt), w2c[:3, 3].to(cdt)
    v = vertices.to(cdt)
    cam = v[:, None, 0] * R[:, 0] + v[:, None, 1] * R[:, 1] + v[:, None, 2] * R[:, 2] + t
    udt = torch.promote_types(cdt, K.dtype)
    cam = cam.to(udt)
    Kd = K.to(udt)
    z = cam[:, 2]
    zc = torch.clamp(z, min=1e-9)
    u = cam[:, 0] / zc * Kd[0, 0] + Kd[0, 2]
    vv = cam[:, 1] / zc * Kd[1, 1] + Kd[1, 2]
    return z, u, vv


def _chunks(npix: torch.Tensor, max_pixels: int):
    """[start, end) runs of consecutive faces, a run being the faces whose
    first pixel falls in one window of ``max_pixels`` pixels of the running
    count: at most ``max_pixels`` plus its last face's pixels (a face larger
    than the window is a run of its own)."""
    if not len(npix):
        return []
    window = (torch.cumsum(npix, 0) - npix) // max_pixels
    _, counts = torch.unique_consecutive(window, return_counts=True)
    ends = np.cumsum(counts.cpu().numpy())
    return list(zip([0, *ends[:-1].tolist()], ends.tolist()))


def _bary(px, py, us, vs):
    """Barycentrics (l0, l1, l2) float64 of pixels (px, py) float64 in the
    triangles with screen corners us, vs [N, 3].  The
    corner differences and det are taken in the corners' dtype, the rest in
    float64, as numpy promotes the JAX package's scalars and pixel grids."""
    ua, ub, uc = us.unbind(1)
    va, vb, vc = vs.unbind(1)
    du_ba, du_ca, dv_ba, dv_ca = ub - ua, uc - ua, vb - va, vc - va
    det = (du_ba * dv_ca - du_ca * dv_ba).to(torch.float64)
    f64 = lambda x: x.to(torch.float64)
    dx, dy = px - f64(ua), py - f64(va)
    l1 = (dx * f64(dv_ca) - dy * f64(du_ca)) / det
    l2 = (dy * f64(du_ba) - dx * f64(dv_ba)) / det
    return 1.0 - l1 - l2, l1, l2


def _candidates(us, vs, zs, x0, y0, bw, npix):
    """Every (face, pixel) row of a chunk: its face (index in the chunk),
    pixel (x, y), whether it lies inside, and its depth (float64, inf
    outside)."""
    dev = us.device
    face = torch.repeat_interleave(torch.arange(len(npix), device=dev), npix)
    first = torch.cumsum(npix, 0) - npix
    off = torch.arange(int(npix.sum()), device=dev) - first[face]
    px = x0[face] + off % bw[face]
    py = y0[face] + off // bw[face]
    l0, l1, l2 = _bary(px.to(torch.float64), py.to(torch.float64), us[face], vs[face])
    inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
    z0, z1, z2 = zs[face].to(torch.float64).unbind(1)
    inv_z = l0 / z0 + l1 / z1 + l2 / z2
    zp = torch.where(inside, 1.0 / torch.clamp(inv_z, min=1e-12), torch.inf)
    return face, px, py, inside, zp


def rasterize_mesh(
    vertices,
    faces,
    w2c_cv,
    K,
    h: int,
    w: int,
    vertex_normals=None,
    near: float = 1e-3,
    far: float = 100.0,
    max_pixels: int = 1 << 22,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render a depth map and a world-space normal map on ``device``.

    Args:
        vertices [V, 3] world coords; faces [F, 3] int; w2c_cv [4, 4] OpenCV
        world-to-camera; K [3, 3]; arrays or tensors (their dtypes decide
        the projection's, as numpy's promotion does in the JAX package).
        max_pixels: bounding-box pixels expanded at once.
    Returns:
        (depth [H, W] float32, normal_world [H, W, 3] float32), zero where no
        geometry; normals flipped to face the camera.
    """
    dev = resolve_device(device)
    vertices = _t(vertices, dev)
    faces = _t(faces, dev, torch.int64)
    w2c = _t(w2c_cv, dev)
    K = _t(K, dev)
    if vertex_normals is None:
        vertex_normals = compute_vertex_normals(vertices, faces)
    vertex_normals = _t(vertex_normals, dev)

    z, u, v = _project(vertices, w2c, K)
    zf, uf, vf = z[faces], u[faces], v[faces]  # [F, 3]
    visible = (zf > near).all(dim=1) & (zf < far).any(dim=1)
    # floor / ceil of the box first, then the clip to the frame
    x0 = torch.clamp(torch.floor(uf.amin(1)), 0, w - 1).to(torch.int64)
    x1 = torch.clamp(torch.ceil(uf.amax(1)), 0, w - 1).to(torch.int64)
    y0 = torch.clamp(torch.floor(vf.amin(1)), 0, h - 1).to(torch.int64)
    y1 = torch.clamp(torch.ceil(vf.amax(1)), 0, h - 1).to(torch.int64)
    ua, ub, uc = uf.unbind(1)
    va, vb, vc = vf.unbind(1)
    det = (ub - ua) * (vc - va) - (uc - ua) * (vb - va)  # in the corners' dtype
    keep = visible & (x1 >= x0) & (y1 >= y0) & (det.abs() >= 1e-12)
    fidx = torch.nonzero(keep).squeeze(1)
    x0, y0, bw = x0[fidx], y0[fidx], (x1 - x0 + 1)[fidx]
    npix = bw * (y1 - y0 + 1)[fidx]
    us, vs, zs = uf[fidx], vf[fidx], zf[fidx]

    key = torch.full((h * w,), INT64_MAX, dtype=torch.int64, device=dev)
    for a, b in _chunks(npix, max_pixels):
        face, px, py, inside, zp = _candidates(us[a:b], vs[a:b], zs[a:b], x0[a:b],
                                                  y0[a:b], bw[a:b], npix[a:b])
        sel = torch.nonzero(inside).squeeze(1)
        bits = zp[sel].to(torch.float32).view(torch.int32).to(torch.int64)
        cand = (bits << 32) | fidx[a:b][face[sel]]
        key.scatter_reduce_(0, py[sel] * w + px[sel], cand, reduce="amin")

    hit = key != INT64_MAX
    pix = torch.nonzero(hit).squeeze(1)
    kwin = key[pix]
    depth = torch.zeros(h * w, dtype=torch.float32, device=dev)
    depth[pix] = (kwin >> 32).to(torch.int32).view(torch.float32)
    normal = torch.zeros(h * w, 3, dtype=torch.float32, device=dev)
    if len(pix):
        f_win = kwin & 0xFFFFFFFF
        # the winner's barycentrics at its pixel, as the JAX package stores
        # them (float32 of the float64 values)
        rank = torch.searchsorted(fidx, f_win)
        px, py = (pix % w).to(torch.float64), (pix // w).to(torch.float64)
        bary = torch.stack(_bary(px, py, us[rank], vs[rank]), dim=-1).to(torch.float32)
        f_hit = faces[f_win]  # [M, 3]
        n_vert = vertex_normals[f_hit]  # [M, 3, 3]
        n_interp = (n_vert * bary[..., None].to(n_vert.dtype)).sum(dim=1)
        n_interp = n_interp / torch.clamp(
            torch.linalg.vector_norm(n_interp, dim=1, keepdim=True), min=1e-12)
        # flip toward the camera (the reference shader view-corrects normals)
        R, t = w2c[:3, :3], w2c[:3, 3]
        cam_pos = -(R.transpose(0, 1) * t[None, :]).sum(dim=1)
        view = vertices[f_hit[:, 0]].to(cam_pos.dtype) - cam_pos
        flip = (n_interp.to(view.dtype) * view).sum(dim=1) > 0
        n_interp = torch.where(flip[:, None], -n_interp, n_interp)
        normal[pix] = n_interp.to(torch.float32)
    return depth.view(h, w), normal.view(h, w, 3)


def read_ply_mesh(path: str):
    """Minimal PLY mesh reader (ascii + binary little-endian, xyz + face
    lists) on the host: (vertices [V, 3] float32, faces [F, 3] int64) numpy."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_vert = n_face = 0
        vert_props = []
        in_vertex = False
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n_vert = int(line.split()[-1])
                in_vertex = True
            elif line.startswith("element face"):
                n_face = int(line.split()[-1])
                in_vertex = False
            elif line.startswith("property") and in_vertex:
                parts = line.split()
                vert_props.append((parts[-1], parts[1]))
            elif line == "end_header":
                break

        type_map = {
            "float": "f4", "float32": "f4", "double": "f8",
            "uchar": "u1", "uint8": "u1", "int": "i4", "int32": "i4",
            "uint": "u4", "ushort": "u2", "short": "i2", "char": "i1",
        }
        if fmt == "ascii":
            verts = []
            for _ in range(n_vert):
                vals = f.readline().split()
                verts.append([float(x) for x in vals[:3]])
            faces = []
            for _ in range(n_face):
                vals = f.readline().split()
                k = int(vals[0])
                idx = [int(x) for x in vals[1: 1 + k]]
                for j in range(1, k - 1):  # fan triangulation
                    faces.append([idx[0], idx[j], idx[j + 1]])
            return np.asarray(verts, np.float32), np.asarray(faces, np.int64)

        dtype = np.dtype([(n, "<" + type_map[t]) for n, t in vert_props])
        raw = np.frombuffer(f.read(n_vert * dtype.itemsize), dtype=dtype)
        verts = np.stack([raw["x"], raw["y"], raw["z"]], axis=1).astype(np.float32)
        faces = []
        for _ in range(n_face):
            k = np.frombuffer(f.read(1), np.uint8)[0]
            idx = np.frombuffer(f.read(4 * k), "<i4")
            for j in range(1, k - 1):
                faces.append([idx[0], idx[j], idx[j + 1]])
        return verts, np.asarray(faces, np.int64)


def write_ply_mesh(path: str, vertices, faces) -> None:
    """Minimal ascii PLY writer (fixtures, tests; ``read_ply_mesh``'s inverse)
    of numpy vertices [V, 3] and faces [F, 3]."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in vertices:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")
