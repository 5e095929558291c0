"""Dataset-root preflight: validate an on-disk dataset layout BEFORE a run.

Port of ``unigeo_tpu/data/preflight.py`` (numpy); its report text is the
JAX package's, character for character.

The reference assumes its documented layouts exist and fails deep inside a
loader when they don't (reference: dataset/Readme.md:17-19 tells the user to
download + preprocess; any mistake surfaces as a stack trace mid-eval).
``eval.py --validate-root`` runs this instead: per-loader checks of the
expected files, depth-scale sanity, pose finiteness/rigidity, and intrinsics
consistency, each with an actionable message — so first contact with a real
dataset download is cheap to debug.

All checks go through the public ClipDataset API (list_scenes /
load_scene_index / __getitem__), so every registered loader gets them for
free.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Any, Dict, List, Optional

import numpy as np


def _check(report: List[Dict], name: str, status: str, detail: str = "",
           scene: Optional[str] = None) -> None:
    report.append({
        "check": name, "status": status, "detail": detail,
        **({"scene": scene} if scene else {}),
    })


def _validate_scene(ds, scene_name: str, report: List[Dict],
                    max_files: int = 4) -> None:
    try:
        index = ds.load_scene_index(scene_name)
    except Exception as e:
        _check(report, "scene_index", "fail",
               f"load_scene_index raised {type(e).__name__}: {e} — the "
               "scene directory layout does not match this loader's "
               "expectation (see the loader's docstring for the layout)",
               scene_name)
        return
    n = len(index.rgb_paths)
    if n == 0:
        _check(report, "scene_index", "fail",
               "scene has zero frames — wrong subdirectory level or empty "
               "download", scene_name)
        return
    _check(report, "scene_index", "ok", f"{n} frames", scene_name)

    if n < ds.clip_length:
        _check(report, "clip_length", "warn",
               f"scene has {n} frames < clip_length={ds.clip_length}; "
               "it will contribute no clips", scene_name)

    # file existence: first / last / evenly spaced middle files.  Datasets
    # with virtual frames (e.g. the synthetic fixture's "scene:frame"
    # tokens) skip the probe — decode below is the real check.
    rgb = [ds._abs(q) for q in index.rgb_paths]
    dep = [ds._abs(q) for q in index.depth_paths]
    if osp.isfile(rgb[0]):
        probe = sorted({0, n - 1,
                        *np.linspace(0, n - 1, max_files, dtype=int)})
        missing = [rgb[i] for i in probe if not osp.isfile(rgb[i])]
        missing += [dep[i] for i in probe if not osp.isfile(dep[i])]
        if missing:
            _check(report, "files_exist", "fail",
                   f"missing files (first: {missing[0]}) — incomplete "
                   "download or wrong root", scene_name)
            return
        _check(report, "files_exist", "ok", f"probed {len(probe)} frames",
               scene_name)

    # first frame decodes
    try:
        img = ds.load_image(rgb[0])
    except Exception as e:
        missing = not osp.isfile(rgb[0])
        _check(report, "rgb_decode", "fail",
               (f"missing file {rgb[0]} — incomplete download "
                "or wrong root" if missing else
                f"{osp.basename(str(rgb[0]))}: "
                f"{type(e).__name__}: {e}"), scene_name)
        return
    h, w = img.shape[-2:]
    _check(report, "rgb_decode", "ok", f"[3, {h}, {w}]", scene_name)

    try:
        depth = ds.load_depth(dep[0])
    except Exception as e:
        _check(report, "depth_decode", "fail",
               f"{osp.basename(str(dep[0]))}: "
               f"{type(e).__name__}: {e}", scene_name)
        return
    finite = np.isfinite(depth)
    valid = finite & (depth > 0)
    frac = float(valid.mean())
    if frac < 0.05:
        _check(report, "depth_valid", "fail",
               f"only {frac:.1%} of depth pixels are finite and > 0 — "
               "wrong depth file pairing or wrong bit depth", scene_name)
    else:
        med = float(np.median(depth[valid]))
        if not (0.05 <= med <= 200.0):
            _check(report, "depth_scale", "warn",
                   f"median depth {med:.3g} m is outside [0.05, 200] — "
                   "check the loader's depth divisor (e.g. mm→m /1000, "
                   "Bonn /5000)", scene_name)
        else:
            _check(report, "depth_scale", "ok",
                   f"median {med:.2f} m, {frac:.0%} valid", scene_name)

    # poses: finite + rigid
    ext = index.extrinsics
    finite_poses = np.isfinite(ext).all(axis=(1, 2))
    if not finite_poses.all():
        _check(report, "pose_finite", "warn",
               f"{int((~finite_poses).sum())}/{n} poses contain NaN/Inf "
               "(loaders drop these frames — expected for 7-Scenes/"
               "NeuralRGBD-style invalid markers, suspicious elsewhere)",
               scene_name)
    ok_ext = ext[finite_poses]
    if len(ok_ext):
        R = ok_ext[:, :3, :3]
        err = np.abs(R @ np.swapaxes(R, 1, 2) - np.eye(3)).max()
        bottom = np.abs(ok_ext[:, 3] - np.array([0, 0, 0, 1])).max()
        if err > 1e-2 or bottom > 1e-4:
            _check(report, "pose_rigid", "fail",
                   f"rotation blocks are not orthonormal (max |RRᵀ−I| = "
                   f"{err:.3g}, bottom-row dev {bottom:.3g}) — pose files "
                   "may be transposed, c2w/w2c-swapped, or not SE(3)",
                   scene_name)
        else:
            _check(report, "pose_rigid", "ok",
                   f"max |RRᵀ−I| = {err:.2g}", scene_name)

    # intrinsics vs image size
    K = index.intrinsics[0]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    if fx <= 0 or fy <= 0:
        _check(report, "intrinsics", "fail",
               f"non-positive focal ({fx:.3g}, {fy:.3g})", scene_name)
    elif not (0 < cx < w and 0 < cy < h):
        # warn, not fail: loaders with a fixed sensor K (7-Scenes 640×480)
        # are valid when the stored frames are at sensor resolution — if
        # you see this on a real download, the frames were resized without
        # updating K (or the wrong image stream was downloaded)
        _check(report, "intrinsics", "warn",
               f"principal point ({cx:.1f}, {cy:.1f}) outside the "
               f"{w}x{h} stored frames — K implies "
               f"~{2 * cx:.0f}x{2 * cy:.0f}; on a real download this "
               "means the frames were resized without updating K",
               scene_name)
    else:
        _check(report, "intrinsics", "ok",
               f"f=({fx:.1f},{fy:.1f}) pp=({cx:.1f},{cy:.1f})", scene_name)

    # normals, if the dataset ships them
    if index.normal_paths:
        p = ds._abs(index.normal_paths[0])
        try:
            nrm = ds.load_normal(p)
            mag = np.linalg.norm(nrm, axis=0)
            unit = float((np.abs(mag - 1.0) < 0.1).mean())
            status = "ok" if unit > 0.5 else "warn"
            _check(report, "normals", status,
                   f"{unit:.0%} of pixels unit-norm (zero-normal pixels "
                   "are invalid-markers)", scene_name)
        except Exception as e:
            missing = not osp.isfile(str(p))
            _check(report, "normals", "fail",
                   f"missing {p}" if missing else f"{type(e).__name__}: {e}",
                   scene_name)


def validate_root(dataset, max_scenes: int = 2) -> Dict[str, Any]:
    """Run the preflight against a constructed ClipDataset.

    Returns {"ok": bool, "checks": [...], "dataset": name}; "ok" is False
    iff any check failed (warnings don't fail the preflight).
    """
    report: List[Dict] = []
    root = getattr(dataset, "root", None)
    if root and not osp.isdir(root):
        _check(report, "root", "fail", f"{root} is not a directory")
        return {"ok": False, "dataset": dataset.name, "checks": report}

    try:
        scenes = dataset.list_scenes(dataset.split)
    except Exception as e:
        _check(report, "scenes", "fail",
               f"list_scenes({dataset.split!r}) raised {type(e).__name__}: "
               f"{e} — missing splits/{dataset.split}.txt and no scene "
               "directories under root")
        return {"ok": False, "dataset": dataset.name, "checks": report}
    if not scenes:
        _check(report, "scenes", "fail",
               f"no scenes for split {dataset.split!r} — empty "
               f"splits/{dataset.split}.txt or wrong root level")
        return {"ok": False, "dataset": dataset.name, "checks": report}
    _check(report, "scenes", "ok", f"{len(scenes)} scenes")

    for scene in scenes[:max_scenes]:
        _validate_scene(dataset, scene, report)

    # one full sample through the clip/GT pipeline
    try:
        if len(dataset):
            from unigeo_tpu_torch.data.sample import validate_sample

            validate_sample(dataset[0])
            _check(report, "sample_contract", "ok",
                   "dataset[0] passes the strict sample contract")
        else:
            _check(report, "sample_contract", "warn",
                   "dataset yields zero clips (scenes shorter than "
                   f"clip_length={dataset.clip_length}?)")
    except Exception as e:
        _check(report, "sample_contract", "fail",
               f"dataset[0] failed: {type(e).__name__}: {e}")

    ok = all(c["status"] != "fail" for c in report)
    return {"ok": ok, "dataset": dataset.name, "checks": report}


def format_report(result: Dict[str, Any]) -> str:
    lines = [f"preflight: {result['dataset']} — "
             f"{'OK' if result['ok'] else 'FAILED'}"]
    mark = {"ok": "✓", "warn": "!", "fail": "✗"}
    for c in result["checks"]:
        scene = f" [{c['scene']}]" if c.get("scene") else ""
        lines.append(
            f"  {mark[c['status']]} {c['check']}{scene}: {c['detail']}"
        )
    return "\n".join(lines)
