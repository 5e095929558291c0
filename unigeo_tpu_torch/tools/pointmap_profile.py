"""Spann3R's f32 clip on the card, with and without torch.profiler, and the
host's cost of one f32 flash launch.

    python -m unigeo_tpu_torch.tools.pointmap_profile [--clips 3] [--launches 200]

It writes the synthetic 7-Scenes scene of ``tools/disk_fixture.py`` (45
frames) to a temporary directory, builds ``configs/spann3r_7scenes.yaml``'s
Spann3R in f32 (TF32 off, random weights from seed 0) and runs its first
20-frame clip: once to build the kernels and warm up, then ``--clips`` warm
clips on the host clock, then one clip under torch.profiler as
``chip_smoke.py``'s pointmap phase profiles it (CPU and CUDA activities,
input shapes recorded) and one under a profiler of the card alone: the wall
ms, the device ms, the device's busy share, and the flash kernels' device
ms and launches.  Last, the host microseconds one f32 flash launch takes at
the decoder's [1, 768, 8, 64]: ``--launches`` calls queued without a sync
and timed on the host before the sync (the card's work takes longer than
their launches, so the queue never fills), bare and under each profiler.

The imports resolve to whichever ``unigeo_tpu_torch`` Python finds first,
so the same file measures another checkout when run by path with that
checkout first on ``PYTHONPATH`` (its ``configs/`` beside its package):

    PYTHONPATH=OTHER python unigeo_tpu_torch/tools/pointmap_profile.py

It prints one JSON object with the card's name and the package's path.  It
needs the card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time
from typing import List, Optional

import torch

CLIP, OVERLAP, FRAMES, H, W = 20, 5, 45, 384, 512  # spann3r_7scenes.yaml's clips
DECODER = (1, 768, 8, 64)  # [B, S, H, D] of one frame's decoder attention


def _profiler(cpu: bool):
    from torch.profiler import ProfilerActivity, profile

    if cpu:
        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       record_shapes=True)
    return profile(activities=[ProfilerActivity.CUDA])


def profiled_clip(run, cpu: bool) -> dict:
    """``run()`` once under a profiler: wall ms, device ms, busy share, the
    flash kernels' device ms and launches."""
    from torch.autograd import DeviceType

    with _profiler(cpu) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    flash = [e for e in kernels if "flash_" in e.key]
    return {"wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms,
            "flash_device_ms": sum(e.self_device_time_total for e in flash) / 1e3,
            "flash_launches": sum(e.count for e in flash),
            "flash_kernels": sorted({e.key for e in flash})}


def launch_host_us(n: int, profiler: Optional[bool]) -> float:
    """Host microseconds per f32 flash launch at DECODER, ``n`` launches
    queued without a sync; under a profiler (``profiler``: with the CPU
    activity or not) or bare (None)."""
    from unigeo_tpu_torch.ops.attention import flash_attention_packed

    b, s, h, d = DECODER
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, s, h * d), generator=gen, device="cuda") for _ in range(3))
    for _ in range(3):
        flash_attention_packed(q, k, v, h)
    torch.cuda.synchronize()
    with _profiler(profiler) if profiler is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        for _ in range(n):
            flash_attention_packed(q, k, v, h)
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
    return host_s / n * 1e6


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clips", type=int, default=3, help="warm clips on the host clock")
    ap.add_argument("--launches", type=int, default=200,
                    help="flash launches timed on the host")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pointmap_profile needs an NVIDIA GPU")
    import yaml

    import unigeo_tpu_torch
    from unigeo_tpu_torch.device import set_exact_f32
    from unigeo_tpu_torch.models.pointmap.spann3r import Spann3R
    from unigeo_tpu_torch.registry import get_dataset_cls
    from unigeo_tpu_torch.tools.disk_fixture import write_seven_scenes

    set_exact_f32()
    dev = torch.device("cuda:0")
    package = os.path.dirname(os.path.abspath(unigeo_tpu_torch.__file__))
    with open(os.path.join(os.path.dirname(package), "configs", "spann3r_7scenes.yaml")) as f:
        params = yaml.safe_load(f)["model_params"]
    result = {"device": torch.cuda.get_device_name(0), "package": package}
    with tempfile.TemporaryDirectory() as work:
        root, cache = os.path.join(work, "7scenes"), os.path.join(work, "lists")
        write_seven_scenes(root, FRAMES, H, W)
        data = get_dataset_cls("sevenScenesDataset")(
            root=root, clip_length=CLIP, clip_overlap=OVERLAP, input_size=(H, W),
            target_size=(H, W), cache_dir=cache)[0]
        torch.manual_seed(0)
        model = Spann3R(**params, device=dev)
        run = lambda: model.forward_tensors(data)
        run()
        torch.cuda.synchronize()
        clips = []
        for _ in range(args.clips):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            clips.append(time.perf_counter() - t0)
        result["warm_clip_s"] = clips
        result["profiled_cpu_and_cuda"] = profiled_clip(run, cpu=True)
        result["profiled_cuda_only"] = profiled_clip(run, cpu=False)
        del model
    torch.cuda.empty_cache()
    result["flash_launch_host_us"] = {
        label: launch_host_us(args.launches, prof)
        for label, prof in (("bare", None), ("cpu_and_cuda", True), ("cuda_only", False))}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
