"""Dataset QA strips: RGB | stored normals | normals refit from the points.

    python -m unigeo_tpu_torch.tools.vis_dataset --config CFG [--out DIR]
        [--every 5] [--max-samples N] [--device cuda]

The counterpart of ``tools/vis_dataset.py`` (the reference's
test_vis_dataset.py), with the same flags and ``--device`` (the card by
default): loads the config's dataset with the port's loaders, visits every
Nth sample, recomputes the middle frame's normals from its world
coordinates with the port's plane fit (``ops.normals.
surface_normals_from_points``, on the device), so what is checked is the
whole geometry path and not the stored normal maps, and writes one PNG
strip per sample plus a data.csv index.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import List, Optional

import numpy as np
import torch


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--out", default="./debug_vis_dataset")
    parser.add_argument("--every", type=int, default=5)
    parser.add_argument("--max-samples", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from PIL import Image

    from unigeo_tpu_torch.config import EvalConfig
    from unigeo_tpu_torch.device import resolve_device
    from unigeo_tpu_torch.ops.normals import surface_normals_from_points
    from unigeo_tpu_torch.registry import get_dataset_cls
    from unigeo_tpu_torch.utils.vis import normal_to_rgb

    dev = resolve_device(args.device)
    cfg = EvalConfig.from_yaml(args.config)
    dataset = get_dataset_cls(cfg.dataset)(**cfg.dataset_kwargs)
    os.makedirs(args.out, exist_ok=True)

    rows = []
    indices = range(0, len(dataset), args.every)
    if args.max_samples is not None:
        indices = list(indices)[: args.max_samples]
    for idx in indices:
        data = dataset[idx]
        nf = len(data["images"])
        mid = nf // 2
        rgb = np.moveaxis(np.asarray(data["images"][mid]), 0, -1).astype(np.uint8)
        stored = normal_to_rgb(np.moveaxis(np.asarray(data["world_normal"][mid]), 0, -1))
        world_pts = torch.as_tensor(np.moveaxis(np.asarray(data["world_coord"][mid]), 0, -1),
                                    device=dev)  # [H, W, 3]
        recomputed = surface_normals_from_points(world_pts[None])[0].cpu().numpy()
        strip = np.concatenate([rgb, stored, normal_to_rgb(recomputed)], axis=1)
        name = f"{idx:05d}_{data['scene_name']}.png"
        Image.fromarray(strip).save(os.path.join(args.out, name))
        rows.append({"index": idx, "scene": data["scene_name"], "frames": nf,
                     "valid_frac": float(np.mean(np.asarray(data["mask"]))), "file": name})
        print(f"{name}  valid={rows[-1]['valid_frac']:.3f}")

    if not rows:
        print("no samples visited (empty dataset or max-samples 0); no CSV")
        return 0
    with open(os.path.join(args.out, "data.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    print(f"wrote {len(rows)} strips + data.csv to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
