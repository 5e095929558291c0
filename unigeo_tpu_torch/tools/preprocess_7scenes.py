"""Register 7-Scenes' Kinect depth onto the RGB sensor for every sequence.

    python -m unigeo_tpu_torch.tools.preprocess_7scenes --root ROOT
        [--scenes chess ...] [--device cuda]

The counterpart of ``tools/preprocess_7scenes.py`` (the reference's
dataset/sevenScenes/preprocess.py), with the same flags and ``--device``
(the card by default): every ``ROOT/<scene>/<seq>/*.depth.png`` gets a
``*.depth.proj.png`` beside it, registered by
``unigeo_tpu_torch.preprocess.sevenscenes.register_depth_to_rgb``; outputs
already there are kept.  The archives come from the Microsoft 7-Scenes page,
extracted under ``--root`` (the reference's downloader needs the network
and is not ported).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", required=True)
    parser.add_argument("--scenes", nargs="*", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from unigeo_tpu_torch.device import resolve_device
    from unigeo_tpu_torch.preprocess.sevenscenes import process_scene

    dev = resolve_device(args.device)
    scenes = args.scenes or sorted(
        d for d in os.listdir(args.root) if os.path.isdir(os.path.join(args.root, d)))
    total = 0
    for scene in scenes:
        scene_dir = os.path.join(args.root, scene)
        for seq in sorted(os.listdir(scene_dir)):
            seq_dir = os.path.join(scene_dir, seq)
            if not os.path.isdir(seq_dir):
                continue
            print(f"registering {scene}/{seq} ...")
            total += process_scene(seq_dir, device=dev)
    print(f"done: {total} frames registered")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
