"""Render ScanNet++ GT depth and normals from the scenes' meshes.

    python -m unigeo_tpu_torch.tools.preprocess_scannetpp --data-root RAW
        --out-root OUT [--scenes a b c] [--stride 3] [--height 768 --width 1024]
        [--max-frames N] [--camera iphone|dslr] [--balance 0.0] [--device cuda]

The counterpart of ``tools/preprocess_scannetpp.py`` (the reference's
preprocess_scannetpp_imu.py), with the same flags and ``--device`` (the
card by default): per scene, ``unigeo_tpu_torch.preprocess.scannetpp``'s
``process_scene`` (iPhone frames, IMU-aligned poses) or
``process_scene_dslr`` (COLMAP poses, fisheye undistortion) writes images/,
depth/, normal/ and scene_metadata.npz under ``OUT/<scene>``.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data-root", required=True, help="raw ScanNet++ root")
    parser.add_argument("--out-root", required=True)
    parser.add_argument("--scenes", nargs="*", default=None)
    parser.add_argument("--stride", type=int, default=1)
    parser.add_argument("--height", type=int, default=768)
    parser.add_argument("--width", type=int, default=1024)
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--camera", choices=("iphone", "dslr"), default="iphone",
                        help="iphone = IMU-pose path; dslr = COLMAP poses + fisheye "
                             "undistortion")
    parser.add_argument("--balance", type=float, default=0.0,
                        help="fisheye new-camera balance (dslr only)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from unigeo_tpu_torch.device import resolve_device
    from unigeo_tpu_torch.preprocess.scannetpp import process_scene, process_scene_dslr

    dev = resolve_device(args.device)
    scenes = args.scenes or sorted(os.listdir(args.data_root))
    for scene in scenes:
        scene_dir = os.path.join(args.data_root, scene)
        if not os.path.isdir(scene_dir):
            continue
        out_dir = os.path.join(args.out_root, scene)
        print(f"processing {scene} ...")
        common = dict(target_hw=(args.height, args.width), frame_stride=args.stride,
                      max_frames=args.max_frames, device=dev)
        if args.camera == "dslr":
            n = process_scene_dslr(scene_dir, out_dir, balance=args.balance, **common)
        else:
            n = process_scene(scene_dir, out_dir, **common)
        print(f"  {n} frames rendered -> {out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
