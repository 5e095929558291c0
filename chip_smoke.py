"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own flushed line with the seconds since start:

  env        the card's name and power limit (nvidia-smi), torch and CUDA
  build      nvcc builds the port's kernels (unigeo_tpu_torch/csrc) into
             unigeo_tpu_torch/_build/
  kernel     the packed flash-attention kernel against its plain version at
             the five main-path shapes (batch 2), with kernel / plain /
             scaled_dot_product_attention times and the bound
  reference  the tiny pipeline in f32 on the card (kernel path) against the
             same weights on the CPU (plain path)
  main path  DepthCrafter.forward at SVD-XT width, 25 x 384 x 512, 5 Euler
             steps, bf16, random weights made on the card; the kernel's
             launch count against the count the configuration predicts;
             depth and normal metrics against an analytic tilted plane

It exits non-zero, and prints no result, when there is no CUDA device or
when any phase fails.  The second-last line is one JSON object with the
kernel's numbers; the last is the run's summary for the device.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

T0 = time.perf_counter()

# bf16 kernel vs plain version: the elementwise limit of
# unigeo_tpu_torch.ops.attention.bf16_error_limit, 1.0625 * (2^-7 |ref| +
# 2^-8 P|V|), from the two roundings in which the versions differ (P to bf16
# before P.V, the output to bf16); a miss at any element fails the phase
# the tiny pipeline in f32 on the card against the CPU: only the order of
# sums differs, amplified by the 5-step loop from sigma_max = 700
REFERENCE_TOL_REL = 1e-3
H100_BF16_FLOPS = 989e12
H100_BYTES_PER_S = 3.35e12


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {phase}: {msg}", flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# main-path shapes of the packed kernel: (name, S, H, D), one clip of 25 frames
MAIN_SHAPES = [
    ("unet_stage0", 3072, 5, 64),
    ("unet_stage1", 768, 10, 64),
    ("unet_stage2", 192, 20, 64),
    ("vae_mid", 3072, 1, 512),
    ("clip_vit_h", 257, 16, 80),
]
KERNEL_BATCH = 2


def bound(b, s, h, d):
    flops = 4.0 * b * h * s * s * d
    nbytes = 2.0 * b * h * d * (2 * s + 2 * s)  # bf16 q,k,v read, o written
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernel(dev):
    from unigeo_tpu_torch.ops.attention import (
        attention_packed_reference,
        bf16_error_limit,
        flash_attention_packed,
    )
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for name, s, h, d in MAIN_SHAPES:
        b = KERNEL_BATCH
        q, k, v = (
            torch.randn((b, s, h * d), generator=gen, device=dev, dtype=torch.bfloat16)
            for _ in range(3)
        )
        out = flash_attention_packed(q, k, v, h)
        torch.cuda.synchronize()
        ref = attention_packed_reference(q, k, v, h)
        limit = bf16_error_limit(q, k, v, h, ref)
        diff = (out.float() - ref.float()).abs()
        err, ratio = diff.max().item(), (diff / limit).max().item()
        if not (np.isfinite(err) and ratio <= 1.0):
            raise AssertionError(f"{name}: kernel vs plain max err/limit {ratio} "
                                 f"(max abs err {err})")
        iters = 20 if s * s * h * d < 1e9 else 5
        kern_ms = time_ms(lambda: flash_attention_packed(q, k, v, h), iters)
        plain_ms = time_ms(lambda: attention_packed_reference(q, k, v, h), iters)
        split = lambda x: x.view(b, s, h, d).transpose(1, 2)
        lib_ms = time_ms(
            lambda: F.scaled_dot_product_attention(split(q), split(k), split(v)), iters
        )
        bms, by = bound(b, s, h, d)
        rows.append(dict(shape=name, b=b, s=s, h=h, d=d, max_abs_err=err,
                         max_err_over_limit=ratio, limit_min=limit.min().item(), ms=kern_ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by))
        log("kernel", f"{name} [B={b},S={s},H={h},D={d}] max_abs_err={err:.3e} "
            f"max_err/limit={ratio:.3f} (limit >= {limit.min().item():.2e}) "
            f"kernel_ms={kern_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} bound_ms={bms:.5f} ({by})")
        del q, k, v, out, ref, limit, diff
    torch.cuda.synchronize()
    return rows


def phase_reference(dev):
    """Tiny pipeline: card (kernel at 256 latent tokens, d = 16 and 32) vs CPU."""
    from unigeo_tpu_torch.device import set_exact_f32
    from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline
    from unigeo_tpu_torch.ops.attention import flash_attention_packed

    set_exact_f32()
    gpu = tiny_pipeline(device=dev, dtype=torch.float32)
    gpu.init_random(torch.Generator(device=dev).manual_seed(3))
    cpu = tiny_pipeline(device="cpu", dtype=torch.float32)
    for m_cpu, m_gpu in zip(cpu.modules(), gpu.modules()):
        m_cpu.load_state_dict({k: v.cpu() for k, v in m_gpu.state_dict().items()})
    rng = np.random.default_rng(5)
    t, h, w = 2, 128, 128
    frames = torch.from_numpy(rng.random((t, h, w, 3)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((t, h // 8, w // 8, 4)).astype(np.float32))
    aug = torch.from_numpy(rng.standard_normal((t, h, w, 3)).astype(np.float32))
    before = flash_attention_packed.launches
    out_gpu = gpu.run_window_staged(frames, noise, 5, aug_noise=aug).cpu()
    torch.cuda.synchronize()
    launched = flash_attention_packed.launches - before
    out_cpu = cpu.run_window_staged(frames, noise, 5, aug_noise=aug)
    rel = ((out_gpu - out_cpu).abs().max() / out_cpu.abs().max()).item()
    if launched == 0 or not np.isfinite(rel) or rel > REFERENCE_TOL_REL:
        raise AssertionError(f"tiny pipeline card vs CPU: rel {rel}, launches {launched}")
    log("reference", f"tiny pipeline 2x128x128 f32 card vs CPU rel dev {rel:.3e} "
        f"(tol {REFERENCE_TOL_REL}), kernel launches {launched}")
    del gpu, cpu
    torch.cuda.empty_cache()


def predicted_launches(unet_cfg, clip_cfg, h, w, steps):
    """Packed-kernel launches of one forward, from the configuration: every
    attention whose query sequence has at least 128 tokens."""
    from unigeo_tpu_torch.ops.attention import MIN_KERNEL_SEQ

    n = len(unet_cfg["block_out_channels"])
    layers = unet_cfg["layers_per_block"]
    hl, wl = h // 8, w // 8
    per_unet = 0
    for stage in range(n - 1):  # the last stage has no attention in the down/up path
        tokens = (hl >> stage) * (wl >> stage)
        if tokens >= MIN_KERNEL_SEQ:
            per_unet += layers + (layers + 1)  # down + up transformers
    if (hl >> (n - 1)) * (wl >> (n - 1)) >= MIN_KERNEL_SEQ:
        per_unet += 1  # mid block
    grid = clip_cfg["image_size"] // clip_cfg["patch_size"]
    clip = clip_cfg["depth"] if grid * grid + 1 >= MIN_KERNEL_SEQ else 0
    vae_tokens = (h // 8) * (w // 8)
    vae = 2 if vae_tokens >= MIN_KERNEL_SEQ else 0  # encoder + decoder mid blocks
    return steps * per_unet + clip + vae


def tilted_plane_clip(t, h, w):
    """An analytic scene: a textured plane tilted about the x axis, seen by
    a static pinhole camera.  Geometry in the clip sample's OpenGL form."""
    fx = fy = 0.8 * w
    cx, cy = w / 2.0, h / 2.0
    vv, uu = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64),
                         indexing="ij")
    # plane n . X = d0 in OpenCV camera space
    n = np.array([0.0, -0.4, -1.0])
    n /= np.linalg.norm(n)
    d0 = -3.0
    rays = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu)], -1)
    z = d0 / (rays @ n)
    pts_cv = rays * z[..., None]
    gl = np.array([1.0, -1.0, -1.0])
    cam_gl = (pts_cv * gl).transpose(2, 0, 1).astype(np.float32)
    normal_gl = np.broadcast_to((n * gl)[:, None, None], (3, h, w)).astype(np.float32)
    checker = ((uu // 32 + vv // 32) % 2)[None]
    base = np.stack([0.3 + 0.5 * checker[0], 0.5 * np.ones_like(uu), 0.2 + 0.3 * vv / h])
    images = []
    for i in range(t):
        shift = np.roll(base, 4 * i, axis=2)
        images.append(np.clip(shift * 255.0, 0, 255).astype(np.uint8))
    k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    return {
        "images": np.stack(images),
        "intrinsics": np.stack([k] * t),
        "extrinsics": np.stack([np.eye(4, dtype=np.float32)] * t),
        "cam_coord": np.stack([cam_gl] * t),
        "cam_normal": np.stack([normal_gl] * t),
        "world_coord": np.stack([cam_gl] * t),
        "world_normal": np.stack([normal_gl] * t),
        "mask": np.ones((t, h, w), np.float32),
    }


def phase_main(dev):
    from unigeo_tpu_torch.data.sample import prepare_gt_label
    from unigeo_tpu_torch.metrics.depth import depth_evaluation
    from unigeo_tpu_torch.metrics.normal import normal_evaluation
    from unigeo_tpu_torch.models.depthcrafter.model import DepthCrafter
    from unigeo_tpu_torch.models.depthcrafter.pipeline import DepthCrafterPipeline
    from unigeo_tpu_torch.ops.attention import flash_attention_packed

    t, h, w, steps = 25, 384, 512, 5
    unet_cfg = dict(block_out_channels=(320, 640, 1280, 1280), layers_per_block=2,
                    num_attention_heads=(5, 10, 20, 20), cross_attention_dim=1024,
                    addition_time_embed_dim=256, head_dim=64)
    clip_cfg = dict(width=1280, depth=32, num_heads=16, patch_size=14,
                    projection_dim=1024, image_size=224)
    t_init = time.perf_counter()
    pipe = DepthCrafterPipeline(unet_config=unet_cfg, clip_config=clip_cfg,
                                dtype=torch.bfloat16, device=dev)
    pipe.init_random(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = {name: sum(p.numel() for p in m.parameters())
                for name, m in zip(("unet", "vae", "clip"), pipe.modules())}
    log("main", f"weights made on the card in {time.perf_counter() - t_init:.2f}s "
        f"(bf16, params {n_params}, total {sum(n_params.values()) / 1e9:.3f} B)")

    data = tilted_plane_clip(t, h, w)
    model = DepthCrafter(pipe, num_inference_steps=steps, seed=42)

    t_first = time.perf_counter()
    model.forward(data)  # first run: cuDNN heuristics, allocator growth
    torch.cuda.synchronize()
    log("main", f"first forward {time.perf_counter() - t_first:.2f}s")

    torch.cuda.reset_peak_memory_stats(dev)
    flash_attention_packed.launches = 0
    t_run = time.perf_counter()
    out = model.forward(data, time_stages=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = flash_attention_packed.launches
    predicted = predicted_launches(unet_cfg, clip_cfg, h, w, steps)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    stage_ms = model.last_stage_ms
    log("main", f"stage_ms {json.dumps({k: round(v, 2) for k, v in stage_ms.items()})} "
        f"forward_s {run_s:.3f} frames_per_s {t / run_s:.3f} peak_mem_gib {peak_gib:.2f}")
    log("main", f"kernel launches {launches}, predicted {predicted}")
    if launches != predicted:
        raise AssertionError(f"kernel launches {launches} != predicted {predicted}")

    depths, normals = out["pred_depths"], out["pred_normals"]
    if depths.shape != (t, h, w) or normals.shape != (t, h, w, 3):
        raise AssertionError(f"shapes {depths.shape} {normals.shape}")
    if not (np.isfinite(depths).all() and np.isfinite(normals).all()):
        raise AssertionError("non-finite depth or normals")
    norm_dev = np.abs(np.linalg.norm(normals, axis=-1) - 1.0).max()
    if norm_dev > 1e-3:
        raise AssertionError(f"normals not unit length: {norm_dev}")
    gt = prepare_gt_label(data)
    dm, _ = depth_evaluation(out["pred_depths"], gt["gt_depths"],
                             custom_mask=gt["gt_masks"], max_depth=80.0)
    nm = normal_evaluation(out["pred_normals"], gt["gt_normals"], custom_mask=gt["gt_masks"])
    scores = {"Abs Rel": dm["Abs Rel"], "delta < 1.25": dm["delta < 1.25"],
              "normal mean": nm["normal mean"]}
    if not all(np.isfinite(v) for v in scores.values()):
        raise AssertionError(f"non-finite metrics {scores}")
    log("main", f"metrics (random weights) {json.dumps(scores)}")
    profile_forward(model, data)
    return launches, stage_ms


def profile_forward(model, data):
    """One more forward under torch.profiler: device time by kernel, the
    packed kernel's share of it, the device's busy share of the wall, and
    the operators that launch the most device time, by input shape."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        model.forward(data)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in kernels)
    flash_ms = sum(r[1] for r in kernels if "flash_packed" in r[0])
    ops = [(e.key, str(e.input_shapes)[:120], e.device_time_total / 1e3, e.count)
           for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == DeviceType.CPU and e.key.startswith("aten::")
           and e.key not in ("aten::copy_", "aten::to", "aten::_to_copy")]
    ops.sort(key=lambda r: -r[2])
    log("profile", json.dumps({
        "wall_ms": round(wall_ms, 2), "device_ms": round(device_ms, 2),
        "device_busy_share": round(device_ms / wall_ms, 4),
        "flash_kernel_ms": round(flash_ms, 2),
        "flash_kernel_share_of_device": round(flash_ms / max(device_ms, 1e-9), 4),
        "top_kernels": [[name[:90], round(ms, 2), n] for name, ms, n in kernels[:12]],
        "top_ops": [[name, shapes, round(ms, 2), n] for name, shapes, ms, n in ops[:12]],
    }))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import unigeo_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from unigeo_tpu_torch import _build

    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("env", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    _build.load_library()
    built = "already built" if _build.build_seconds is None else f"nvcc {_build.build_seconds:.2f}s"
    log("build", f"{built} -> {_build.library_path()}")

    rows = phase_kernel(dev)
    torch.cuda.synchronize()
    phase_reference(dev)
    torch.cuda.synchronize()
    launches, _ = phase_main(dev)
    torch.cuda.synchronize()

    sums = {key: sum(r[key] for r in rows) for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    kernels = [{
        "name": "flash_attention_packed",
        "route": "cuda",
        "source": "unigeo_tpu_torch/csrc/flash_attention_packed.cu",
        "replaces": "unigeo_tpu/ops/attention.py:298",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # sums over the five main-path shapes at batch 2; per shape below
        "ms": sums["ms"],
        "plain_ms": sums["plain_ms"],
        "bound_ms": sums["bound_ms"],
        "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": sums["library_ms"],
        "shapes": rows,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
