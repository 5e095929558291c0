"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own flushed line with the seconds since start:

  env        the card's name and power limit (nvidia-smi), torch and CUDA
  build      nvcc builds the port's kernels (unigeo_tpu_torch/csrc) into
             unigeo_tpu_torch/_build/
  kernel     the packed flash-attention kernel against its plain version at
             the five main-path shapes (batch 2), with kernel / plain /
             scaled_dot_product_attention times and the bound; the
             head-split forward at the same shapes, also bitwise against the
             packed kernel; the fused GEGLU feed-forward at the UNet's four
             shapes (M = 25 x tokens), with the body and plan that ran
             (fused, or the two wgmma passes), its grid and work over the
             useful work, rows past M held to 0, events and device ms, and
             the unfused bf16 layers' time as a yardstick; then the forward-with-logsumexp and the two
             backward kernels (dq, dk/dv) at the three UNet training shapes
             in bf16 and one ragged f32 shape at batch 2, the same numbers
             for each, and the backward pair again at the training path's
             batch 25 ([25, 3072, 5, 64], [25, 768, 10, 64], [25, 192, 20,
             64]) against SDPA's backward and the bounds, each checked on
             frames 0, 1 and 24 against the plain version run on those
             frames alone; the packed, head-split and lse forwards at batch
             25 at all five forward shapes, checked the same way, with
             SDPA's time, the bound, the SFUs' exponential floor, the
             device time of each and of SDPA and the body each ran (wgmma
             at d = 64, 80 and 512, by kernel name); the
             fused LayerNorm -> dense at the UNet's three temporal-
             attention shapes in bf16 (the wgmma body, asserted) and at
             ragged shapes in bf16 and f32 (the body that ran and its grid,
             max err/limit, kernel events and device / plain / unfused-layers
             ms, the bound, rows past M in a zeroed buffer of whole items
             held to 0); the packed kernel's f32 body at d = 64 (the
             register-tiled flash_packed_f32reg_kernel, asserted by name) at
             the pointmap shapes ([25, 768, 12, 64], Spann3R's own [20, 768,
             12, 64] and [1, 768, 8, 64], Dust3R's [20, 768, 16, 64] and [19,
             768, 12, 64], VideoDepthAnything's [25, 972, 16, 64], Cut3R's
             frame-to-state [1, 768 queries, 64 keys, 8, 64] and Aether's
             DiT [1, 3072, 12, 64]) and its f32 body at d = 512 (the
             register-tiled flash_packed_f32w512_kernel, asserted by name)
             at the DepthCrafter trainer's VAE mid attention [25, 3072, 1,
             512], and its CUDA-core f32 body at CLIP's [25, 257, 16, 80]
             (DepthCrafter's f32 forward in the bf16_drift phase), each
             against its plain version, with its events and device ms,
             the plain version's and SDPA's f32 times and the bound at the
             f32 rate; the f32 backward pair (dq,
             dk/dv on the CUDA-core body, by kernel name) at the f32
             training shapes (Aether's DiT, Spann3R's encoder and decoder,
             Dust3R's encoder and decoder on its 16-frame training clip,
             VideoDepthAnything's encoder,
             Cut3R's frame-to-state cross-attention) held elementwise to
             the plain version's limits, with events and device ms, the
             plain versions', SDPA's f32 backward and the bounds
             Then the bf16 CUDA-core bodies (flash_*_kernel<__nv_bfloat16>,
             bwd_{dq,dkv}_f32_kernel<__nv_bfloat16>, asserted by kernel name)
             that every bf16 width no wgmma body takes and rows not aligned
             to 16 bytes run: the forward at [2, 768, 2, 24], [2, 768, 2,
             32], [2, 768, 4, 128] and [2, 768, 4, 64] with misaligned rows,
             the backward at [2, 768, 2, 32] and [2, 257, 16, 80], each
             under its derived limit, with events and device ms, the plain
             versions' and SDPA's times and the bound.  Then the
             column-chunked bodies past the forward's d 512 and the
             backward's d 128 (flash_*_wide_kernel<T>, bwd_{dq,dkv}_wide_
             kernel<T>, asserted by kernel name): the forward at [2, 1024,
             1, 768] f32, [2, 1024, 1, 1024] bf16 and [2, 1024, 2, 520] bf16
             with misaligned rows, the backward at the VAE mid block's [2,
             3072, 1, 512] in bf16 and f32, [2, 1024, 2, 256] bf16 and [2,
             1024, 1, 520] f32, the same numbers
  reference  the tiny pipeline in f32 on the card (kernel path) against the
             same weights on the CPU (plain path); then one step of the tiny
             trainer the same way: loss, every gradient, and the AdamW step
  main path  DepthCrafter.forward at SVD-XT width, 25 x 384 x 512, 5 Euler
             steps, bf16, random weights made on the card; the kernel's
             launch count against the count the configuration predicts;
             depth and normal metrics against an analytic tilted plane
  bf16_drift unigeo_tpu_torch.tools.measure_bf16_drift's two models at full
             width on random f32 master weights made on the card: DepthCrafter
             (SVD-XT, one 25 x 384 x 512 clip, 5 Euler steps) through
             run_window_staged in f32 (TF32 off), in f32 on inputs rounded to
             bf16 (the yardstick) and in bf16 (the weights cast in place);
             Aether (aether_scannetpp.yaml, 16 x 384 x 512, 4 steps, its
             all-equal leaves redrawn) through forward_tensors the same way;
             each bf16 leg's shifts in Abs Rel, delta < 1.25 and normal mean
             on one synthetic GT within 0.5% of the f32 leg's, its mean pixel
             AbsRel from the f32 leg under 0.5%, every figure finite, the
             packed launches of every leg at the configuration's count (109,
             64); one JSON line a model with its seconds
  serving    the same configuration with clips_per_step 2 behind
             unigeo_tpu_torch.serving.HTTPInferenceServer on 127.0.0.1 in
             this process (max_batch 2, a 2 s window), under deterministic
             cuDNN: two distinct clips POSTed at once coalesce into one batch
             (/stats), and again in the other order; each clip's batched
             result bitwise the same in either slot (forward_batch on [A, B]
             and [B, A]), each response bitwise its clip's direct batched
             result, 143 packed launches for the pair; each clip's scores
             (Abs Rel, delta < 1.25, normal mean on the tilted plane) within
             0.5% of its serial forward's; a malformed body gets a 400; one
             more clip, bitwise equal to forward, 109 launches; request
             seconds, clips/s, peak memory, npz encode / decode seconds
  debug_nans run_evaluation(debug_nans=True) on a tiny f32 DepthCrafter on
             the card with one NaN weight planted: FloatingPointError
  eval       the port's evaluator (unigeo_tpu_torch.evaluator.run_evaluation)
             on two synthetic 25 x 384 x 512 clips with DepthCrafter built from
             the config's model_params (random bf16 weights made on the card),
             under UNIGEO_FUSED_GEGLU=1: per-clip seconds and frames/s, the
             CSV, each kernel's launches per clip against the count the
             configuration predicts; a resumed run that skips both clips; then
             one clip with neither switch and with UNIGEO_PACKED_ATTN=0
             (the head-split kernel), whose metrics, and the fused GEGLU
             clip's against the one with neither switch, must agree within
             0.5%
  disk_eval  the port's eval CLI (unigeo_tpu_torch.eval.main) on a copy of
             configs/depthcrafter_7scenes.yaml (clips of 20, overlap 5, 384 x
             512, 5 steps, DepthCrafter at SVD-XT width, random bf16 weights)
             with root at a 7-Scenes-layout scene of 45 frames written by
             unigeo_tpu_torch/tools/disk_fixture.py (480 x 640 when PIL is
             there, else 384 x 512): --validate-root passes every check; a
             run with --num-workers 2 writes 3 rows and the Average, finite;
             its resume runs nothing; clips_per_step 2 (clips 0 and 1 in
             one batched denoise, read on the serial loader) against that
             run; one 45-frame clip in two windows of 25 (overlap 5) held
             exactly against the two windows run alone and their blend
             (under cuDNN's deterministic algorithms); the reader that
             decoded, per-clip seconds and frames/s, peak memory, and the
             packed kernel's launches against the prediction on every path
  svd_family the tiny f32 pipeline on the card against the CPU for Heun,
             the known-frame denoise (its clamped frames exact on the card),
             StableNormal and ChronoDepth; then the eval CLI over the
             7-Scenes fixture (384 x 512, one clip of 15 frames) with Heun
             (DepthCrafter, solver heun), StableNormal, ChronoDepth,
             DepthAnyVideo and UniGeo (no branch, 1 step), each on a copy of its
             configs/ file's model_params at SVD-XT width, all sharing one
             bf16 pipeline made on the card: per-clip seconds, peak memory,
             stage ms, and the packed kernel's launches held to the count
             the configuration predicts (SIBLING_TABLE)
  pointmap   tiny Spann3R in f32 on the card (the f32 kernel) against the
             CPU, the camera recovery card against CPU and with TF32 on in
             the process (the same result: it turns TF32 off inside); then
             the CLI on a copy of configs/spann3r_7scenes.yaml (one clip of
             20, the default Spann3R in f32; then in bf16 on 8 frames, warm,
             against one f32 call) and
             UniGeoCam with its
             geometry branch at full width on all four metric families
             (one clip of 15), the same numbers as svd_family
  pointmap_models
             Dust3R, Cut3R (RoPE100 + DPT) and VideoDepthAnything at tiny
             widths in f32 on the card against the CPU; then the CLI over
             the 7-Scenes fixture, one clip each, in f32: Dust3R and Cut3R on
             copies of configs/{dust3r,cut3r}_7scenes.yaml (clips of 20, their
             full networks), VideoDepthAnything with
             configs/vda_scannetpp.yaml's network (ViT-L, patch 14, clips of
             25): per-clip seconds, peak memory, stage ms, the packed kernel's
             launches held to the count the configuration predicts
             (POINTMAP_TABLE), every scored metric finite
  aether     a small Aether (tools/aether_check.py: 8 frames at 128 x
             128, 256 DiT tokens at d = 64, the f32 kernel) in f32 on the
             card against the same weights on the CPU, its constant leaves
             perturbed (adaLN-zero would make the DiT's output 0), all
             five outputs held (the normals by angle); then the CLI over the 7-Scenes
             fixture with configs/aether_scannetpp.yaml's network (a DiT of
             width 768, depth 16, 12 heads over 3072 tokens; the causal VAE
             at 8x space, 4x time; 4 steps), one clip of 16 in f32: per-clip
             seconds, peak memory, parameters, stage ms (encode, denoise,
             decode, pose), the packed kernel's launches held to the count
             the configuration predicts (aether_launches), every metric of
             the four families finite
  train_models
             the port's trainer (unigeo_tpu_torch.train.main) at the full
             width of spann3r_7scenes.yaml, dust3r_7scenes.yaml,
             cut3r_7scenes.yaml, vda_scannetpp.yaml and aether_scannetpp.yaml
             in f32 with TF32 off over the 7-Scenes fixture, one step of
             one clip each (Dust3R's cut to 16 frames): losses finite, step
             seconds, peak memory held under 90% of the card, the fwd_lse /
             dq / dk-dv launches of every step held to the count the
             configuration predicts; Aether saves its full-width
             checkpoint, which Aether(checkpoint_path=...) loads with every
             output of a clip bitwise equal to the trained module's; then
             one step of ChronoDepth's branch (direct-depth targets) at
             SVD-XT width in bf16 on an 8-frame clip
  train      the port's trainer (unigeo_tpu_torch.train.main) at SVD-XT
             width on synthetic 384 x 512 clips, bf16: one warm-up step and
             two measured steps, no checkpoint saved; losses, step
             seconds, peak memory, each
             kernel's launches per step against the configuration's count,
             and a gradient on every spatial to_q
  tool       the port's LayerNorm -> dense ablation
             (unigeo_tpu_torch.tools.ablate_ln_qkv) in-process at full size,
             its JSON line, and the kernel's launches against the count the
             tool's parameters predict
  preprocess the offline preprocessors (unigeo_tpu_torch/preprocess) on
             the card: the rasterizer on a seeded heightfield of about 1.5 M
             faces at 768 x 1024, timed, and at about 20 k faces held
             against the port's own CPU run; register_depth_to_rgb on a 480
             x 640 Kinect frame (bitwise the CPU run) and undistort_image on
             a 1752 x 1168 fisheye frame, timed; the three CLIs
             (preprocess_7scenes, preprocess_scannetpp on the iPhone and
             the DSLR path, vis_dataset) over fixtures written by the
             phase, each held against its --device cpu run
  metrics    run_evaluation with IdentityModel on the identity config (a
             dict, configs/identity_synthetic.yaml's content) on the card:
             perfect scores on all four families, held against the same
             run on the CPU; then one synthetic 25 x 384 x 512 clip with a
             perturbed point cloud, pcd_downsample_num 10000: the seconds
             of pcd_evaluation and camera_pose_evaluation, and the card's
             metrics against the CPU's at 2500 points
  parallel   unigeo_tpu_torch/parallel on ranks of this machine that share
             the card over gloo (CUDA tensors staged through pinned host
             buffers; the ranks time-share one card, so no speed-up is
             claimed), DepthCrafter at SVD-XT width in bf16, 384 x 512, 5
             steps, under deterministic cuDNN: dp over 2 ranks
             (DepthCrafter.forward_batch on a mesh, ShardedClipExecutor), two
             25-frame clips, each bitwise its serial forward; sp over 2 ranks
             (denoise_context_parallel) on 12 frames (25 has no divisor but 5
             and 25; cut from 24 for time), the scores within EVAL_METRIC_TOL_REL of the unsplit
             denoise's and the latents' largest relative difference;
             Aether's flow sampler over 2 ranks (flow_sample_context_parallel,
             the 16-frame f32 clip of aether_scannetpp.yaml's network with
             random, not adaLN-zero, weights: the f32 flash forward with 1536
             queries over 3072 keys) against its serial sample; pp over 3
             ranks (PipelinedStageExecutor) on the two clips against their
             serial forwards; the eval CLI over 2 ranks on the identity
             config, its merged metrics.csv against one process's; tp:
             ShardedClipExecutor on a (1, 1, 2) mesh (UNet, VAE and CLIP
             placed by parallelize) on a 2-frame clip, 2 steps, its scores within
             EVAL_METRIC_TOL_REL of its serial forward's; training, in the
             2-rank launch: one DiffusionTrainer step at SVD-XT width in
             bf16 on 8-frame clips over dp (2 clips), sp (4 frames a rank)
             and tp 2, and one FlowMatchingTrainer step of Aether's DiT in
             f32 on two 16-frame clips over dp and tp 2, each held to the
             one-process step on the same batch and draws (this process's,
             run first): the loss and the all-reduced gradients' relative
             L2 on named leaves within PAR_TRAIN_TOL, with the step's
             seconds, peak memory and fwd_lse / dq / dk,dv launches a rank.
             Each line names the backend, the seconds and each rank's flash
             launches, held to the count the split predicts

The 7-Scenes fixture is written once a run and read by every phase that
runs the CLI over it; svd_family and the UniGeoCam branch score one clip
of each model.  It exits non-zero, and prints no result, when there is no
CUDA device or when any phase fails.  The second-last line is one JSON object with the
kernels' numbers; the last is the run's summary for the device.
"""

import atexit
import contextlib
import copy
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

T0 = time.perf_counter()

# bf16 kernel vs plain version: the elementwise limit of
# unigeo_tpu_torch.ops.attention.bf16_error_limit, 1.0625 * (2^-7 |ref| +
# 2^-8 P|V|), from the two roundings in which the versions differ (P to bf16
# before P.V, the output to bf16); a miss at any element fails the phase.
# The backward: the elementwise limits of grad_error_limits (see there), in
# bf16 1.0625 * (2^-7 |ref| + 2^-8 T + F), in f32 1.0625 * (2 n 2^-24 T + F).
# f32 forward output: 1e-5 absolute (f32 in both, sums in another order).
F32_OUT_TOL = 1e-5
# the logsumexp, both dtypes: 1e-4 absolute (f32 in both from the same
# inputs; sums in another order and exp2/log2, under 1e-6 relative on
# values of order 10)
LSE_TOL = 1e-4
# the tiny pipeline in f32 on the card against the CPU: only the order of
# sums differs, amplified by the 5-step loop from sigma_max = 700
REFERENCE_TOL_REL = 1e-3
# one step of the tiny trainer in f32, card (kernels, TF32 off) against CPU
# (plain versions): the loss within 1e-4 relative; each gradient within
# 1e-3 of its own largest magnitude plus 1e-5 of the model's largest
# gradient (10x the CPU-vs-JAX bound of tests/test_torch_training.py, for
# cuDNN's choice of convolution algorithms; the floor covers gradients that
# are round-off in exact arithmetic, a bias before a group norm); the AdamW
# step, both sides given the card's gradients, within 2^-22 + 1e-6 lr
TRAIN_LOSS_TOL_REL = 1e-4
TRAIN_GRAD_TOL, TRAIN_GRAD_FLOOR = 1e-3, 1e-5
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12  # CUDA cores (the f32 kernels use no tensor core)
H100_BYTES_PER_S = 3.35e12
# eval: Abs Rel, delta < 1.25 and normal mean of the head-split forward
# against the packed one, and of the fused GEGLU clip against the unfused
# one, relative (BASELINE.json's metric tolerance)
EVAL_METRIC_TOL_REL = 5e-3
SWITCHES = ("UNIGEO_FUSED_GEGLU", "UNIGEO_PACKED_ATTN")
# point-cloud metrics, card against CPU (tests/test_torch_cuda.py): distance
# statistics v within PCD_MOVED_TOL max|q| + 2 E / v, E = 16 u max|q|^2 (the
# expansion's round-off of a distance d is E / (2 d)); normal consistencies
# within PCD_NC_TOL
PCD_MOVED_TOL, PCD_NC_TOL = 1e-5, 1e-4


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


def phase_kernel_headsplit(dev):
    """The head-split forward (``flash_attention`` on [B, S, H, D] views) at
    MAIN_SHAPES: bitwise against the packed kernel on the same bytes, under
    the bf16 limit against the plain version, and its times."""
    from unigeo_tpu_torch.ops.attention import (
        attention_packed_reference,
        bf16_error_limit,
        flash_attention,
        flash_attention_packed,
    )
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(8)
    rows = []
    for name, s, h, d in MAIN_SHAPES:
        b = KERNEL_BATCH
        q, k, v = (
            torch.randn((b, s, h * d), generator=gen, device=dev, dtype=torch.bfloat16)
            for _ in range(3)
        )
        q4, k4, v4 = (x.view(b, s, h, d) for x in (q, k, v))
        out = flash_attention(q4, k4, v4).view(b, s, h * d)
        torch.cuda.synchronize()
        bitwise = torch.equal(out, flash_attention_packed(q, k, v, h))
        ref = attention_packed_reference(q, k, v, h)
        limit = bf16_error_limit(q, k, v, h, ref)
        diff = (out.float() - ref.float()).abs()
        err, ratio = diff.max().item(), (diff / limit).max().item()
        if not (bitwise and np.isfinite(err) and ratio <= 1.0):
            raise AssertionError(f"head-split {name}: bitwise equal to packed {bitwise}, "
                                 f"max err/limit {ratio} (max abs err {err})")
        iters = 20 if s * s * h * d < 1e9 else 5
        kern_ms = time_ms(lambda: flash_attention(q4, k4, v4), iters)
        plain_ms = time_ms(lambda: attention_packed_reference(q, k, v, h), iters)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q4.transpose(1, 2), k4.transpose(1, 2), v4.transpose(1, 2)), iters)
        bms, by = bound(b, s, h, d)
        rows.append(dict(shape=name, b=b, s=s, h=h, d=d, max_abs_err=err,
                         max_err_over_limit=ratio, bitwise_equal_to_packed=bitwise, ms=kern_ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by))
        log("kernel", f"headsplit {name} [B={b},S={s},H={h},D={d}] bitwise_equal_to_packed="
            f"{bitwise} max_abs_err={err:.3e} max_err/limit={ratio:.3f} kernel_ms={kern_ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bms:.5f} ({by})")
        del q, k, v, q4, k4, v4, out, ref, limit, diff
    torch.cuda.synchronize()
    return rows


# main-path shapes of the fused GEGLU feed-forward: (name, M, C, hidden), M =
# 25 frames x tokens at 384 x 512, C_out = C; hidden 4C on one device, and a
# tp rank's 4C / tp under tensor parallelism (its value and gate blocks; the
# partial output is then summed over the tp group)
GEGLU_SHAPES = [
    ("unet_stage0", 76800, 320, 1280),
    ("unet_stage1", 19200, 640, 2560),
    ("unet_stage2", 4800, 1280, 5120),
    ("unet_mid", 1200, 1280, 5120),
    ("unet_stage0_tp2", 76800, 320, 640),
    ("unet_stage1_tp2", 19200, 640, 1280),
    ("unet_stage2_tp2", 4800, 1280, 2560),
    ("unet_stage0_tp4", 76800, 320, 320),
    ("unet_stage1_tp4", 19200, 640, 640),
    ("unet_stage2_tp4", 4800, 1280, 1280),
]


def geglu_bound(m, c, hidden):
    """(least ms, bound_by): the useful products 2 M C 2H + 2 M H C (24 M C^2
    at H = 4C) at the bf16 peak, against x, w1, b1, w2 read and out written
    once in bf16."""
    flops = 4.0 * m * c * hidden + 2.0 * m * hidden * c
    nbytes = 2.0 * (m * c + 2 * hidden * c + 2 * hidden + hidden * c + m * c)
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def geglu_body(plan, c, hidden, c_out):
    """(the body that ran, its grid, the work it does over the useful 2 M C 2H
    + 2 M H C_out): the fused pass computes the up-projection once per
    column group, the two passes each product once."""
    if plan["two_pass"]:
        body = "wgmma two-pass (up-projection, then down-projection)"
        work = 1.0
    else:
        body = "wgmma fused"
        work = (2 * plan["column_groups"] * c + c_out) / (2 * c + c_out)
    grid = {"clusters": plan["blocks"] // 2, "items": plan["items"],
            "column_groups": plan["column_groups"], "hidden_splits": plan["hidden_splits"],
            "x_resident": plan["x_resident"]}
    if plan["two_pass"]:
        grid.update(up_clusters=plan["up_pass_blocks"] // 2, up_items=plan["up_pass_items"],
                    up_hidden_splits=plan["up_pass_hidden_splits"])
    return body, grid, work


def phase_kernel_geglu(dev):
    """The fused GEGLU kernel against its plain version at GEGLU_SHAPES, with
    the body and plan that ran, rows past M of a launch into a buffer of
    whole items filled with NaN held unwritten (in the two-pass plan they
    would be zeros), kernel (events and torch.profiler device) /
    plain / unfused-layers times and the bound.  No one PyTorch call
    computes the function: the unfused bf16 layers (a linear with bias, the
    tanh gelu, a product and a matmul, several calls) are a yardstick only."""
    from unigeo_tpu_torch import _build
    from unigeo_tpu_torch.device import set_exact_f32
    from unigeo_tpu_torch.ops import geglu
    from unigeo_tpu_torch.ops.geglu import geglu_error_limit, geglu_ffn, geglu_ffn_plain
    from unigeo_tpu_torch.tools.forward_variants import profile_device_ms
    import torch.nn.functional as F

    set_exact_f32()  # the f32 plain version in full f32

    def unfused(x, w1, b1, w2):
        hidden = w1.shape[0] // 2
        hg = F.linear(x, w1, b1)
        return (hg[:, :hidden] * F.gelu(hg[:, hidden:], approximate="tanh")) @ w2.T

    lib = _build.load_library()
    gen = torch.Generator(device=dev).manual_seed(9)
    rows = []
    for name, m, c, hidden in GEGLU_SHAPES:
        mk = lambda shape, std: (torch.randn(shape, generator=gen, device=dev) * std).to(
            torch.bfloat16)
        x, w1, b1, w2 = (mk((m, c), 1.0), mk((2 * hidden, c), c**-0.5), mk((2 * hidden,), 0.05),
                         mk((c, hidden), hidden**-0.5))
        out = geglu_ffn(x, w1, b1, w2)
        torch.cuda.synchronize()
        ref = geglu_ffn_plain(x, w1, b1, w2)
        limit = geglu_error_limit(x, w1, b1, w2, ref)
        diff = (out.float() - ref.float()).abs()
        err, ratio = diff.max().item(), (diff / limit).max().item()
        items = -(-m // geglu.BLOCK_M) * geglu.BLOCK_M
        buf = torch.full((items, c), float("nan"), dtype=torch.bfloat16, device=dev)
        geglu._launch(lib, x, w1, b1, w2, buf[:m])
        torch.cuda.synchronize()
        past = int((~torch.isnan(buf[m:].float())).any(dim=1).sum().item())
        if not (np.isfinite(err) and ratio <= 1.0 and past == 0
                and torch.equal(buf[:m], out)):
            raise AssertionError(f"geglu {name}: kernel vs plain max err/limit {ratio} "
                                 f"(max abs err {err}), rows written past M {past}")
        kern_ms = time_ms(lambda: geglu_ffn(x, w1, b1, w2), 10)
        kern_dev_ms = profile_device_ms(lambda: geglu_ffn(x, w1, b1, w2), 10)
        plain_ms = time_ms(lambda: geglu_ffn_plain(x, w1, b1, w2), 3)
        unfused_ms = time_ms(lambda: unfused(x, w1, b1, w2), 10)
        bms, by = geglu_bound(m, c, hidden)
        body, grid, work = geglu_body(geglu.kernel_plan(lib, m, c, hidden, c), c, hidden, c)
        rows.append(dict(shape=name, m=m, c=c, hidden=hidden, max_abs_err=err,
                         max_err_over_limit=ratio, limit_min=limit.min().item(),
                         rows_past_m_written=past, ms=kern_ms, device_ms=kern_dev_ms,
                         plain_ms=plain_ms, library_ms=None, unfused_ms=unfused_ms,
                         bound_ms=bms, bound_by=by, body=body, grid=grid,
                         work_over_useful=work))
        log("kernel", f"geglu {name} [M={m},C={c},H={hidden}] body={body} grid={json.dumps(grid)} "
            f"work/useful={work:.3f} max_abs_err={err:.3e} max_err/limit={ratio:.3f} "
            f"rows_written_past_M={past} kernel_ms={kern_ms:.4f} device_ms={kern_dev_ms:.4f} "
            f"plain_ms={plain_ms:.4f} unfused_layers_ms={unfused_ms:.4f} (several calls, "
            f"yardstick) bound_ms={bms:.5f} ({by})")
        del x, w1, b1, w2, out, ref, limit, diff, buf
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


# shapes of the fused LayerNorm -> dense: (name, M, C, N, dtype); the UNet's
# temporal-attention q/k/v shapes at 25 x 384 x 512 (the ablation tool's),
# and ragged ones (M = 100, N = 2C, C not a multiple of the K tile, with
# and without 16-byte rows)
LN_SHAPES = [
    ("unet_stage0", 76800, 320, 960, torch.bfloat16),
    ("unet_stage1", 19200, 640, 1920, torch.bfloat16),
    ("unet_stage2", 4800, 1280, 3840, torch.bfloat16),
    ("ragged_c200", 100, 200, 400, torch.bfloat16),
    ("ragged_c100", 100, 100, 200, torch.bfloat16),
    ("ragged_c200_f32", 100, 200, 400, torch.float32),
    ("ragged_c100_f32", 100, 100, 200, torch.float32),
]


def phase_kernel_ln_dense(dev):
    """The fused LayerNorm -> dense against its plain version at LN_SHAPES:
    the body that ran (the bf16 wgmma body, the mma.sync body where rows are
    not 16-byte aligned, the f32 body) and its grid, max err/limit, the rows
    past M of a launch into a zeroed buffer of whole items (limit 0), kernel
    (events and torch.profiler device) / plain / unfused-layers times and
    the bound.  No one PyTorch call computes the function: F.layer_norm then
    F.linear (two calls) is a yardstick only."""
    from unigeo_tpu_torch import _build
    from unigeo_tpu_torch.device import set_exact_f32
    from unigeo_tpu_torch.ops import ln_qkv
    from unigeo_tpu_torch.tools.ablate_ln_qkv import bound as ln_bound
    from unigeo_tpu_torch.tools.forward_variants import profile_device_ms
    import torch.nn.functional as F

    set_exact_f32()  # the f32 plain version in full f32
    lib = _build.load_library()
    gen = torch.Generator(device=dev).manual_seed(10)
    rows = []
    for name, m, c, n, dtype in LN_SHAPES:
        mk = lambda shape, std, mean=0.0: (
            torch.randn(shape, generator=gen, device=dev) * std + mean).to(dtype)
        args = (mk((m, c), 1.0, 0.5), mk((c,), 0.2, 1.0), mk((c,), 0.3), mk((n, c), c**-0.5),
                mk((n,), 0.1))
        out = ln_qkv.ln_dense(*args)
        torch.cuda.synchronize()
        ref = ln_qkv.ln_dense_plain(*args)
        diff = (out.float() - ref.float()).abs()
        limit = ln_qkv.ln_dense_error_limit(*args, ref)
        err, ratio = diff.max().item(), (diff / limit).max().item()
        blocks = -(-m // ln_qkv.BLOCK_M) * ln_qkv.BLOCK_M  # whole items
        buf = torch.zeros((blocks, n), dtype=dtype, device=dev)
        ln_qkv._launch(lib, *args, buf[:m], 1e-5)
        torch.cuda.synchronize()
        past = buf[m:].abs().max().item() if blocks > m else 0.0
        if not (np.isfinite(err) and ratio <= 1.0 and past == 0.0
                and torch.equal(buf[:m], out)):
            raise AssertionError(f"ln_dense {name}: kernel vs plain max err/limit {ratio} "
                                 f"(max abs err {err}), rows past M max {past}")
        kern_ms = time_ms(lambda: ln_qkv.ln_dense(*args), 20)
        kern_dev_ms = profile_device_ms(lambda: ln_qkv.ln_dense(*args), 20)
        plain_ms = time_ms(lambda: ln_qkv.ln_dense_plain(*args), 5)
        x, g, b, w, bias = args
        unfused_ms = time_ms(lambda: F.linear(F.layer_norm(x, (c,), g, b, 1e-5), w, bias), 20)
        bms, by = ln_bound(m, c, n, dtype)
        if dtype == torch.float32:
            body, grid = "f32 CUDA cores", {"blocks": [-(-m // ln_qkv.BLOCK_M), -(-n // 64)]}
        else:
            plan = ln_qkv.kernel_plan(lib, *args[:4])
            body = "wgmma" if plan["wgmma"] else "mma.sync (rows not 16-byte aligned)"
            grid = ({"blocks": plan["blocks"], "items": plan["items"],
                     "n_splits": plan["n_splits"], "y_buffers": plan["y_buffers"]}
                    if plan["wgmma"] else {"blocks": [-(-m // ln_qkv.BLOCK_M), -(-n // 128)]})
        if name.startswith("unet") and body != "wgmma":
            raise AssertionError(f"ln_dense {name}: the {body} body ran, not the wgmma body")
        rows.append(dict(shape=name, m=m, c=c, n=n, dtype=str(dtype).split(".")[-1],
                         max_abs_err=err, max_err_over_limit=ratio, rows_past_m_max=past,
                         ms=kern_ms, device_ms=kern_dev_ms, plain_ms=plain_ms, library_ms=None,
                         unfused_ms=unfused_ms, bound_ms=bms, bound_by=by, body=body, grid=grid,
                         work_over_useful=1.0))
        log("kernel", f"ln_dense {name} [M={m},C={c},N={n},{rows[-1]['dtype']}] body={body} "
            f"grid={json.dumps(grid)} max_abs_err={err:.3e} max_err/limit={ratio:.3f} "
            f"rows_past_M_max={past} kernel_ms={kern_ms:.4f} device_ms={kern_dev_ms:.4f} "
            f"plain_ms={plain_ms:.4f} unfused_layers_ms={unfused_ms:.4f} (two calls, yardstick) "
            f"bound_ms={bms:.5f} ({by})")
        del args, out, ref, diff, limit, buf
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


# training shapes of the forward-with-lse and backward kernels: (name, dtype,
# Sq, Sk, H, D); the UNet's three spatial stages and one ragged f32 shape, at
# KERNEL_BATCH = 2 beside the plain versions; the bf16 stages again at the
# training path's own batch (TRAIN_BATCH: the 25 frames of a clip are the
# spatial attention's batch), checked on the frames SLICE_FRAMES
TRAIN_BATCH = 25
SLICE_FRAMES = (0, 1, 24)
TRAIN_SHAPES = [
    ("unet_stage0", torch.bfloat16, 3072, 3072, 5, 64),
    ("unet_stage1", torch.bfloat16, 768, 768, 10, 64),
    ("unet_stage2", torch.bfloat16, 192, 192, 20, 64),
    ("ragged_f32", torch.float32, 257, 100, 4, 64),
]


def train_bounds(dtype, b, sq, sk, h, d):
    """Least times (ms, bound_by) of the three functions on the card: fwd_lse
    (q k^T and P v, q, k, v read, out and lse written), dq (S, dP, dS k;
    q, k, v, dO, lse, delta read, dq written), dk/dv (S, dP, P^T dO,
    dS^T q; the same read, dk and dv written), and the whole backward
    (5 products, 10 B H Sq Sk D)."""
    es = 2 if dtype == torch.bfloat16 else 4
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    mnk = float(b * h * sq * sk * d)
    q_bytes, k_bytes, row_bytes = es * b * sq * h * d, es * b * sk * h * d, 4.0 * b * h * sq

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")

    read = 2 * q_bytes + 2 * k_bytes + 2 * row_bytes  # q, dO, k, v, lse, delta
    return {
        "fwd_lse": bound(4 * mnk, q_bytes + 2 * k_bytes + q_bytes + row_bytes),
        "bwd_dq": bound(6 * mnk, read + q_bytes),
        "bwd_dkv": bound(8 * mnk, read + 2 * k_bytes),
        "bwd": bound(10 * mnk, read + q_bytes + 2 * k_bytes),
    }


def phase_kernel_train(dev):
    """The forward-with-lse and the dq, dk/dv kernels against their plain
    versions at TRAIN_SHAPES, with kernel / plain / library times and the
    bounds.  The backward's inputs (out, lse) are the fwd_lse kernel's,
    the same for kernel and plain version."""
    from unigeo_tpu_torch.device import set_exact_f32
    from unigeo_tpu_torch.ops.attention import (
        _bwd_plain,
        _delta,
        attention_bwd_reference,
        attention_fwd_lse_reference,
        bf16_error_limit,
        flash_attention_bwd,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_fwd_lse,
        grad_error_limits,
    )
    import torch.nn.functional as F

    set_exact_f32()  # the f32 plain versions in full f32
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = {"fwd_lse": [], "bwd_dq": [], "bwd_dkv": []}
    b = KERNEL_BATCH
    for name, dtype, sq, sk, h, d in TRAIN_SHAPES:
        mk = lambda s_: torch.randn((b, s_, h * d), generator=gen, device=dev, dtype=dtype)
        q, k, v, dout = mk(sq), mk(sk), mk(sk), mk(sq)
        # forward with lse
        out, lse = flash_attention_fwd_lse(q, k, v, h)
        torch.cuda.synchronize()
        ref, ref_lse = attention_fwd_lse_reference(q, k, v, h)
        diff = (out.float() - ref.float()).abs()
        if dtype == torch.bfloat16:
            ratio = (diff / bf16_error_limit(q, k, v, h, ref)).max().item()
        else:
            ratio = diff.max().item() / F32_OUT_TOL
        lse_err = (lse - ref_lse).abs().max().item()
        if not (ratio <= 1.0 and lse_err <= LSE_TOL):
            raise AssertionError(f"fwd_lse {name}: max err/limit {ratio}, lse err {lse_err}")
        big = sq * sk * h * d >= 1e9
        iters = 5 if big else 20
        split = lambda x, s_: x.view(b, s_, h, d).transpose(1, 2)
        bounds = train_bounds(dtype, b, sq, sk, h, d)
        fwd = dict(shape=name, dtype=str(dtype).split(".")[-1], b=b, sq=sq, sk=sk, h=h, d=d,
                   max_abs_err=diff.max().item(), max_err_over_limit=ratio, lse_max_abs_err=lse_err,
                   ms=time_ms(lambda: flash_attention_fwd_lse(q, k, v, h), iters),
                   plain_ms=time_ms(lambda: attention_fwd_lse_reference(q, k, v, h), iters),
                   library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                       split(q, sq), split(k, sk), split(v, sk)), iters),
                   bound_ms=bounds["fwd_lse"][0], bound_by=bounds["fwd_lse"][1])
        rows["fwd_lse"].append(fwd)

        # backward, from the kernel's out and lse
        grads = flash_attention_bwd(q, k, v, out, lse, dout, h)
        torch.cuda.synchronize()
        refs = attention_bwd_reference(q, k, v, out, lse, dout, h)
        limits = grad_error_limits(q, k, v, out, lse, dout, h, refs)
        errs = [(g.float() - r.float()).abs() for g, r in zip(grads, refs)]
        ratios = [(e / lim).max().item() for e, lim in zip(errs, limits)]
        if not max(ratios) <= 1.0:
            raise AssertionError(f"bwd {name}: max err/limit dq, dk, dv {ratios}")
        delta = _delta(out, dout, h)
        scale = d**-0.5
        qs, ks, vs = (split(x, s_).detach().requires_grad_()
                      for x, s_ in ((q, sq), (k, sk), (v, sk)))
        sdpa_out = F.scaled_dot_product_attention(qs, ks, vs)
        g_sdpa = split(dout, sq)
        lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
            sdpa_out, (qs, ks, vs), g_sdpa, retain_graph=True), iters)
        whole_plain_ms = time_ms(lambda: attention_bwd_reference(q, k, v, out, lse, dout, h), iters)
        for kernel, wrapper, parts, err, ratio_k in (
            ("bwd_dq", lambda: flash_attention_bwd_dq(q, k, v, dout, lse, delta, h), ("dq",),
             errs[0].max().item(), ratios[0]),
            ("bwd_dkv", lambda: flash_attention_bwd_dkv(q, k, v, dout, lse, delta, h),
             ("dk", "dv"), max(errs[1].max().item(), errs[2].max().item()), max(ratios[1:])),
        ):
            rows[kernel].append(dict(
                shape=name, dtype=fwd["dtype"], b=b, sq=sq, sk=sk, h=h, d=d,
                max_abs_err=err, max_err_over_limit=ratio_k,
                ms=time_ms(wrapper, iters),
                plain_ms=time_ms(lambda: _bwd_plain(q, k, v, dout, lse, delta, h, scale, parts),
                                 iters),
                # one PyTorch call computing dq, dk and dv together
                library_ms=lib_bwd_ms,
                bound_ms=bounds[kernel][0], bound_by=bounds[kernel][1],
                whole_bwd_plain_ms=whole_plain_ms, whole_bwd_bound_ms=bounds["bwd"][0],
            ))
        dq_row, dkv_row = rows["bwd_dq"][-1], rows["bwd_dkv"][-1]
        log("kernel", f"{name} [B={b},Sq={sq},Sk={sk},H={h},D={d},{fwd['dtype']}] fwd_lse: "
            f"max_err/limit={fwd['max_err_over_limit']:.3f} lse_err={lse_err:.2e} "
            f"ms={fwd['ms']:.4f} plain_ms={fwd['plain_ms']:.4f} "
            f"library_ms={fwd['library_ms']:.4f} bound_ms={fwd['bound_ms']:.5f}")
        log("kernel", f"{name} bwd: max_err/limit dq={ratios[0]:.3f} dk={ratios[1]:.3f} "
            f"dv={ratios[2]:.3f} dq_ms={dq_row['ms']:.4f} dkv_ms={dkv_row['ms']:.4f} "
            f"plain_ms dq={dq_row['plain_ms']:.4f} dkv={dkv_row['plain_ms']:.4f} "
            f"whole={whole_plain_ms:.4f} library_bwd_ms={lib_bwd_ms:.4f} bound_ms "
            f"dq={dq_row['bound_ms']:.5f} dkv={dkv_row['bound_ms']:.5f} "
            f"whole={bounds['bwd'][0]:.5f} ({bounds['bwd'][1]})")
        del q, k, v, dout, out, lse, ref, grads, refs, limits, errs, sdpa_out, qs, ks, vs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rows["batch25"] = kernel_train_batch25(dev)
    return rows


def hold_slices(what, ratios):
    """Fail unless every max err/limit in ``ratios`` is at most 1."""
    if not max(ratios) <= 1.0:
        raise AssertionError(f"{what}: max err/limit {ratios} on frames {SLICE_FRAMES}")


def kernel_train_batch25(dev):
    """The backward kernels at the training path's own batch, TRAIN_BATCH: dq
    and dk/dv at the three bf16 UNet stages, from the fwd_lse kernel's out
    and lse, each against one PyTorch call (SDPA's backward under autograd)
    and its bound (the forwards' times at this batch are
    kernel_forward_batch25's).  The plain versions cannot run whole here
    (stage 0's dense f32 intermediates would take some 47 GB), so each
    kernel's output on the frames SLICE_FRAMES is held against the plain
    version run on those frames alone, under the same limits (batch entries
    are independent)."""
    from unigeo_tpu_torch.ops.attention import (
        attention_bwd_reference,
        attention_fwd_lse_reference,
        bf16_error_limit,
        flash_attention_bwd,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_fwd_lse,
        grad_error_limits,
        _delta,
    )
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(12)
    b, idx = TRAIN_BATCH, list(SLICE_FRAMES)
    rows = []
    for name, dtype, sq, sk, h, d in TRAIN_SHAPES:
        if dtype != torch.bfloat16:
            continue
        mk = lambda s_: torch.randn((b, s_, h * d), generator=gen, device=dev, dtype=dtype)
        q, k, v, dout = mk(sq), mk(sk), mk(sk), mk(sq)
        out, lse = flash_attention_fwd_lse(q, k, v, h)
        grads = flash_attention_bwd(q, k, v, out, lse, dout, h)
        torch.cuda.synchronize()
        sl = [x[idx] for x in (q, k, v, out, lse, dout)]
        ref, ref_lse = attention_fwd_lse_reference(*sl[:3], h)
        fwd_ratio = ((out[idx].float() - ref.float()).abs()
                     / bf16_error_limit(*sl[:3], h, ref)).max().item()
        lse_err = (lse[idx] - ref_lse).abs().max().item()
        hold_slices(f"fwd_lse {name} batch {b}", [fwd_ratio, lse_err / LSE_TOL])
        refs = attention_bwd_reference(*sl, h)
        limits = grad_error_limits(*sl, h, refs)
        ratios = [((g[idx].float() - r.float()).abs() / lim).max().item()
                  for g, r, lim in zip(grads, refs, limits)]
        errs = [(g[idx].float() - r.float()).abs().max().item() for g, r in zip(grads, refs)]
        hold_slices(f"bwd {name} batch {b}", ratios)
        del ref, ref_lse, refs, limits, sl
        delta = _delta(out, dout, h)
        split = lambda x, s_: x.view(b, s_, h, d).transpose(1, 2)
        qs, ks, vs = (split(x, s_).detach().requires_grad_()
                      for x, s_ in ((q, sq), (k, sk), (v, sk)))
        sdpa_out = F.scaled_dot_product_attention(qs, ks, vs)
        g_sdpa = split(dout, sq)
        iters = 10
        bounds = train_bounds(dtype, b, sq, sk, h, d)
        row = dict(
            shape=name, dtype="bfloat16", b=b, sq=sq, sk=sk, h=h, d=d,
            checked_frames=idx, max_err_over_limit_dq=ratios[0],
            max_err_over_limit_dkv=max(ratios[1:]), max_abs_err_dq=errs[0],
            max_abs_err_dkv=max(errs[1:]),
            dq_ms=time_ms(lambda: flash_attention_bwd_dq(q, k, v, dout, lse, delta, h), iters),
            dkv_ms=time_ms(lambda: flash_attention_bwd_dkv(q, k, v, dout, lse, delta, h), iters),
            library_bwd_ms=time_ms(lambda: torch.autograd.grad(
                sdpa_out, (qs, ks, vs), g_sdpa, retain_graph=True), iters),
            dq_bound_ms=bounds["bwd_dq"][0], dkv_bound_ms=bounds["bwd_dkv"][0],
            bwd_bound_ms=bounds["bwd"][0], bwd_bound_by=bounds["bwd"][1],
        )
        row["pair_ms"] = row["dq_ms"] + row["dkv_ms"]
        row["pair_bound_ms"] = row["dq_bound_ms"] + row["dkv_bound_ms"]
        rows.append(row)
        log("kernel", f"{name} [B={b},Sq={sq},Sk={sk},H={h},D={d},bf16] bwd: max_err/limit on "
            f"frames {idx} dq={ratios[0]:.3f} dk={ratios[1]:.3f} dv={ratios[2]:.3f} "
            f"dq_ms={row['dq_ms']:.4f} dkv_ms={row['dkv_ms']:.4f} pair_ms={row['pair_ms']:.4f} "
            f"library_bwd_ms={row['library_bwd_ms']:.4f} bound_ms dq={row['dq_bound_ms']:.5f} "
            f"dkv={row['dkv_bound_ms']:.5f} pair={row['pair_bound_ms']:.5f} "
            f"whole={row['bwd_bound_ms']:.5f} ({row['bwd_bound_by']})")
        del q, k, v, dout, out, lse, grads, delta, sdpa_out, qs, ks, vs, g_sdpa
        torch.cuda.empty_cache()
    return rows


# the SFU's rate of ex2, per SM and clock (Hopper)
SFU_EX2_PER_SM_CLOCK = 16


def sm_clock_hz():
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def exp_floor_ms(b, sq, sk, h):
    """The least time the SMs' SFUs take for the forward's B H Sq Sk
    exponentials (one per score) at the card's maximum SM clock; kept beside
    bound_ms, not folded into it."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return b * h * sq * sk / (sms * SFU_EX2_PER_SM_CLOCK * sm_clock_hz()) * 1e3


def forward_body(fn, iters):
    """``iters`` calls of ``fn`` under torch.profiler: the forward body they
    ran, by the kernel's name ("wgmma" for the TMA + wgmma bodies, or the
    name itself), and its mean device ms per call (the kernel alone, no host
    cost)."""
    from unigeo_tpu_torch.tools.forward_variants import profile_flash

    name, ms = profile_flash(fn, iters)
    return ("wgmma" if "_wgmma" in name else name), ms


def kernel_forward_batch25(dev):
    """Rows 1-3 (the packed, head-split and lse forwards) at the training
    path's batch TRAIN_BATCH at every forward shape (MAIN_SHAPES: the three
    UNet stages, the VAE mid block, CLIP), each held against its plain
    version on the frames SLICE_FRAMES (batch entries are independent; the
    whole batch's dense plain version would not fit), the head-split output
    bitwise against the packed one; ms of each, SDPA's, the bound, the
    exponential floor, and the body each ran (by kernel name); each call's
    device ms by torch.profiler beside its events ms, SDPA's too."""
    from unigeo_tpu_torch.ops.attention import (
        attention_fwd_lse_reference,
        bf16_error_limit,
        flash_attention,
        flash_attention_fwd_lse,
        flash_attention_packed,
    )
    from unigeo_tpu_torch.tools.forward_variants import profile_device_ms
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(13)
    b, idx = TRAIN_BATCH, list(SLICE_FRAMES)
    rows = []
    for name, s, h, d in MAIN_SHAPES:
        q, k, v = (torch.randn((b, s, h * d), generator=gen, device=dev, dtype=torch.bfloat16)
                   for _ in range(3))
        q4, k4, v4 = (x.view(b, s, h, d) for x in (q, k, v))
        packed = flash_attention_packed(q, k, v, h)
        split = flash_attention(q4, k4, v4).view(b, s, h * d)
        out, lse = flash_attention_fwd_lse(q, k, v, h)
        torch.cuda.synchronize()
        sl = [x[idx] for x in (q, k, v)]
        ref, ref_lse = attention_fwd_lse_reference(*sl, h)
        limit = bf16_error_limit(*sl, h, ref)
        ratio = {key: ((x[idx].float() - ref.float()).abs() / limit).max().item()
                 for key, x in (("packed", packed), ("headsplit", split), ("fwd_lse", out))}
        err = max((x[idx].float() - ref.float()).abs().max().item() for x in (packed, out))
        lse_err = (lse[idx] - ref_lse).abs().max().item()
        bitwise = torch.equal(split, packed)
        hold_slices(f"forward {name} batch {b}", [*ratio.values(), lse_err / LSE_TOL])
        if not bitwise:
            raise AssertionError(f"head-split {name} batch {b} differs from packed")
        del packed, split, out, lse, ref, ref_lse, limit, sl
        calls = {
            "packed": lambda: flash_attention_packed(q, k, v, h),
            "headsplit": lambda: flash_attention(q4, k4, v4),
            "fwd_lse": lambda: flash_attention_fwd_lse(q, k, v, h),
        }
        iters = 10
        bms, by = bound(b, s, h, d)
        row = dict(shape=name, b=b, s=s, h=h, d=d, checked_frames=idx, max_abs_err=err,
                   lse_err=lse_err, headsplit_bitwise_equal_to_packed=bitwise,
                   bound_ms=bms, bound_by=by, exp_floor_ms=exp_floor_ms(b, s, s, h))
        for key, fn in calls.items():
            row[f"{key}_max_err_over_limit"] = ratio[key]
            row[f"{key}_ms"] = time_ms(fn, iters)
            row[f"{key}_body"], row[f"{key}_device_ms"] = forward_body(fn, iters)
        sdpa = lambda: F.scaled_dot_product_attention(
            q4.transpose(1, 2), k4.transpose(1, 2), v4.transpose(1, 2))
        row["library_ms"] = time_ms(sdpa, iters)
        row["library_device_ms"] = profile_device_ms(sdpa, iters)
        rows.append(row)
        log("kernel", f"forward {name} [B={b},S={s},H={h},D={d}] body {row['packed_body']}: "
            f"max_err/limit on frames {idx} packed={ratio['packed']:.3f} "
            f"headsplit={ratio['headsplit']:.3f} fwd_lse={ratio['fwd_lse']:.3f} "
            f"lse_err={lse_err:.2e} ms packed={row['packed_ms']:.4f} "
            f"headsplit={row['headsplit_ms']:.4f} fwd_lse={row['fwd_lse_ms']:.4f} device_ms "
            f"packed={row['packed_device_ms']:.4f} headsplit={row['headsplit_device_ms']:.4f} "
            f"fwd_lse={row['fwd_lse_device_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} "
            f"library_device_ms={row['library_device_ms']:.4f} bound_ms={bms:.5f} ({by}) "
            f"exp_floor_ms={row['exp_floor_ms']:.5f}")
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()
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


def kernel_wrappers():
    """name -> the wrapper whose ``launches`` counts that kernel."""
    from unigeo_tpu_torch.ops import attention as att
    from unigeo_tpu_torch.ops import geglu, ln_qkv

    return {
        "flash_attention_packed": att.flash_attention_packed,
        "flash_attention_headsplit": att.flash_attention,
        "flash_attention_fwd_lse": att.flash_attention_fwd_lse,
        "flash_attention_bwd_dq": att.flash_attention_bwd_dq,
        "flash_attention_bwd_dkv": att.flash_attention_bwd_dkv,
        "geglu_ffn": geglu.geglu_ffn,
        "ln_dense": ln_qkv.ln_dense,
    }


def reset_counts():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def phase_reference_train(dev):
    """One step of the tiny trainer in f32: card (kernels at 256 latent
    tokens, d = 16; TF32 off) against the same weights, batch and draws on
    the CPU (plain versions).  Loss and every gradient; then the CPU's AdamW
    is given the card's gradients and both parameter sets are compared."""
    from unigeo_tpu_torch.device import set_exact_f32
    from unigeo_tpu_torch.models.depthcrafter.pipeline import init_random_
    from unigeo_tpu_torch.models.depthcrafter.unet import UNetSpatioTemporal, tiny_unet_config
    from unigeo_tpu_torch.parallel.trainer import DiffusionTrainer

    set_exact_f32()
    cfg = tiny_unet_config()
    b, t, hl, wl, lr = 1, 2, 16, 16, 1e-3
    gpu_unet = init_random_(UNetSpatioTemporal(**cfg).to(dev),
                            torch.Generator(device=dev).manual_seed(4))
    cpu_unet = UNetSpatioTemporal(**cfg)
    cpu_unet.load_state_dict({k: v.cpu() for k, v in gpu_unet.state_dict().items()})
    rng = np.random.default_rng(6)
    batch = {
        "latents": rng.standard_normal((b, t, hl, wl, 4)).astype(np.float32),
        "cond_latents": rng.standard_normal((b, t, hl, wl, 4)).astype(np.float32),
        "context": rng.standard_normal((b, t, 1, cfg["cross_attention_dim"])).astype(np.float32),
    }
    n = rng.standard_normal((b, 1, 1, 1, 1)).astype(np.float32)
    noise = rng.standard_normal((b, t, hl, wl, 4)).astype(np.float32)
    gpu_tr = DiffusionTrainer(gpu_unet, learning_rate=lr)
    cpu_tr = DiffusionTrainer(cpu_unet, learning_rate=lr)

    before = read_counts()
    loss_gpu = float(gpu_tr.train_step(batch, n, noise))
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in read_counts().items()}
    loss_cpu = cpu_tr.loss(batch, n, noise)
    loss_cpu.backward()
    loss_rel = abs(loss_gpu - loss_cpu.item()) / abs(loss_cpu.item())

    gpu_params = dict(gpu_unet.named_parameters())
    g_all = max(p.grad.abs().max().item() for p in cpu_tr.params if p.grad is not None)
    grad_ratio = 0.0
    for name, p in cpu_unet.named_parameters():
        g_card = gpu_params[name].grad.cpu()
        g_ref = torch.zeros_like(p) if p.grad is None else p.grad
        limit = TRAIN_GRAD_TOL * g_ref.abs().max().item() + TRAIN_GRAD_FLOOR * g_all
        grad_ratio = max(grad_ratio, (g_card - g_ref).abs().max().item() / limit)
        p.grad = g_card
    cpu_tr.optimizer.step()
    step_tol = 2.0**-22 + 1e-6 * lr
    step_err = max((gpu_params[name].detach().cpu() - p.detach()).abs().max().item()
                   for name, p in cpu_unet.named_parameters())
    kernels = ("flash_attention_fwd_lse", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    if not (loss_rel <= TRAIN_LOSS_TOL_REL and grad_ratio <= 1.0 and step_err <= step_tol
            and all(launched[k] > 0 for k in kernels)):
        raise AssertionError(f"tiny trainer card vs CPU: loss rel {loss_rel}, grad err/limit "
                             f"{grad_ratio}, step err {step_err}, launches {launched}")
    log("reference", f"tiny trainer step 1x2x16x16 latents f32 card vs CPU: loss "
        f"{loss_gpu:.6f} rel dev {loss_rel:.3e} (tol {TRAIN_LOSS_TOL_REL}), max grad "
        f"err/limit {grad_ratio:.3e}, AdamW step max dev {step_err:.3e} (tol {step_tol:.3e}), "
        f"kernel launches {json.dumps(launched)}")
    del gpu_unet, gpu_tr
    torch.cuda.empty_cache()


def unet_kernel_attentions(unet_cfg, h, w):
    """Spatial attentions of one UNet evaluation with at least 128 query
    tokens (the kernel path), from the configuration."""
    from unigeo_tpu_torch.ops.attention import MIN_KERNEL_SEQ

    n = len(unet_cfg["block_out_channels"])
    layers = unet_cfg["layers_per_block"]
    hl, wl = h // 8, w // 8
    count = 0
    for stage in range(n - 1):  # the last stage has no attention in the down/up path
        if (hl >> stage) * (wl >> stage) >= MIN_KERNEL_SEQ:
            count += layers + (layers + 1)  # down + up transformers
    if (hl >> (n - 1)) * (wl >> (n - 1)) >= MIN_KERNEL_SEQ:
        count += 1  # mid block
    return count


def clip_kernel_attentions(clip_cfg):
    from unigeo_tpu_torch.ops.attention import MIN_KERNEL_SEQ

    grid = clip_cfg["image_size"] // clip_cfg["patch_size"]
    return clip_cfg["depth"] if grid * grid + 1 >= MIN_KERNEL_SEQ else 0


def vae_mid_attentions(h, w):
    """1 if the VAE's mid-block attention (at 1/8 resolution) takes the kernel."""
    from unigeo_tpu_torch.ops.attention import MIN_KERNEL_SEQ

    return 1 if (h // 8) * (w // 8) >= MIN_KERNEL_SEQ else 0


def predicted_launches(unet_cfg, clip_cfg, h, w, steps):
    """Packed-kernel launches of one forward, from the configuration: every
    attention whose query sequence has at least 128 tokens (steps UNet
    evaluations, CLIP, the VAE's encoder and decoder mid blocks)."""
    return (steps * unet_kernel_attentions(unet_cfg, h, w) + clip_kernel_attentions(clip_cfg)
            + 2 * vae_mid_attentions(h, w))


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


SVD_XT_UNET = dict(block_out_channels=(320, 640, 1280, 1280), layers_per_block=2,
                   num_attention_heads=(5, 10, 20, 20), cross_attention_dim=1024,
                   addition_time_embed_dim=256, head_dim=64)
SVD_XT_CLIP = dict(width=1280, depth=32, num_heads=16, patch_size=14,
                   projection_dim=1024, image_size=224)


def phase_main(dev):
    from unigeo_tpu_torch.data.sample import prepare_gt_label
    from unigeo_tpu_torch.models.depthcrafter.model import DepthCrafter
    from unigeo_tpu_torch.models.depthcrafter.pipeline import DepthCrafterPipeline

    t, h, w, steps = 25, 384, 512, 5
    unet_cfg, clip_cfg = SVD_XT_UNET, SVD_XT_CLIP
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
    reset_counts()
    t_run = time.perf_counter()
    out = model.forward(data, time_stages=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    counts = read_counts()
    launches = counts["flash_attention_packed"]
    predicted = predicted_launches(unet_cfg, clip_cfg, h, w, steps)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    stage_ms = model.last_stage_ms
    log("main", f"stage_ms {json.dumps({k: round(v, 2) for k, v in stage_ms.items()})} "
        f"forward_s {run_s:.3f} frames_per_s {t / run_s:.3f} peak_mem_gib {peak_gib:.2f}")
    log("main", f"kernel launches {json.dumps(counts)}, packed predicted {predicted}")
    if launches != predicted:
        raise AssertionError(f"kernel launches {launches} != predicted {predicted}")
    if any(n for name, n in counts.items() if name != "flash_attention_packed"):
        raise AssertionError(f"the default forward launched a training, head-split or "
                             f"GEGLU kernel: {counts}")

    check_prediction("main", out, t, h, w)
    scores = clip_scores(out, prepare_gt_label(data))
    if not all(np.isfinite(v) for v in scores.values()):
        raise AssertionError(f"non-finite metrics {scores}")
    log("main", f"metrics (random weights) {json.dumps(scores)}")
    return launches, stage_ms


DRIFT_DEPTHCRAFTER = (25, 384, 512, 5)  # frames, h, w, Euler steps
DRIFT_AETHER = (16, 384, 512)  # frames, h, w; its steps are the config's


def finite_figures(tree):
    """Every number in a result line's nested dicts and lists is finite."""
    if isinstance(tree, dict):
        return all(finite_figures(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(finite_figures(v) for v in tree)
    return not isinstance(tree, float) or bool(np.isfinite(tree))


def phase_bf16_drift(dev):
    """The bf16-vs-f32 numerics tool on both models at full width (ROADMAP
    queue 3 item 2): each result line printed with its seconds, then held:
    every bf16 shift within the 0.5% (``held_within_tolerance``), the mean
    pixel AbsRel of the bf16 depths from the f32 ones under 0.5%
    (``within_tolerance``), every figure finite, every leg's packed launches
    at the configuration's count and no other kernel launched."""
    from unigeo_tpu_torch.tools import measure_bf16_drift as drift

    t, h, w, steps = DRIFT_DEPTHCRAFTER
    at, ah, aw = DRIFT_AETHER
    aether_params = drift.aether_params(tiny=False)
    predicted = {"depthcrafter": predicted_launches(SVD_XT_UNET, SVD_XT_CLIP, h, w, steps),
                 "aether": aether_launches(aether_params, at, ah, aw)}
    results = {}
    for name, run in (("depthcrafter", lambda: drift.depthcrafter_drift(dev, t, h, w, steps)),
                      ("aether", lambda: drift.aether_drift(dev, at, ah, aw))):
        reset_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            res = run()
        torch.cuda.synchronize()
        res["phase_s"] = time.perf_counter() - t0
        counts = read_counts()
        res["predicted_launches"] = predicted[name]
        res["counts"] = counts
        log("bf16_drift", json.dumps(res))
        held = {k: round(c["rel_shift"], 8) for k, c in res["held"].items()}
        log("bf16_drift", f"{name}: shifts over the f32 values {json.dumps(held)} (limit "
            f"{res['north_star_tolerance']}), yardstick's "
            f"{json.dumps(res['yardstick']['metric_shift_vs_fixed_gt'])}, pixel AbsRel "
            f"{res['absrel']:.6f} (yardstick {res['yardstick']['absrel']:.6f}), JAX gate "
            f"{json.dumps(res['jax_gate'])}, launches {json.dumps(res['launches'])} "
            f"(predicted {predicted[name]}), legs s {json.dumps(res['seconds'])}, peak GiB "
            f"{json.dumps(res['peak_gib'])}, {res['phase_s']:.2f}s in all")
        torch.cuda.empty_cache()
        want = {k: 0 for k in counts}
        want["flash_attention_packed"] = len(res["launches"]) * predicted[name]
        if not (res["held_within_tolerance"] and res["within_tolerance"]
                and finite_figures(res) and counts == want
                and all(n == predicted[name] for n in res["launches"].values())):
            raise AssertionError(f"bf16_drift {name}: {json.dumps(res)}")
        results[name] = res
    return results


def check_prediction(what, out, t, h, w):
    """Depths [t,h,w] and normals [t,h,w,3], finite, the normals unit length."""
    depths, normals = out["pred_depths"], out["pred_normals"]
    if depths.shape != (t, h, w) or normals.shape != (t, h, w, 3):
        raise AssertionError(f"{what}: shapes {depths.shape} {normals.shape}")
    if not (np.isfinite(depths).all() and np.isfinite(normals).all()):
        raise AssertionError(f"{what}: non-finite depth or normals")
    norm_dev = np.abs(np.linalg.norm(normals, axis=-1) - 1.0).max()
    if norm_dev > 1e-3:
        raise AssertionError(f"{what}: normals not unit length: {norm_dev}")


def profile_device(phase, run, groups):
    """``run()`` once more under torch.profiler: device time by kernel, the
    device ms and share of each group of kernels (``groups``: label -> a
    substring of the kernel names), the device's busy share of the wall, the
    device time of annotated ranges such as the optimizer step, and the
    operators that launch the most device time, by input shape.  A warm-up
    step (one small kernel) comes first, and PROFILE_PAD_KERNELS spin
    kernels open the recorded window: a trace can lose the first records of
    its window (a prefix of a clip's kernels, on the card), and the pad
    takes that loss in their place.  The pad's kernels are left out of
    every sum; ``pad_kernels_recorded`` counts those the trace kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True, schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        for _ in range(PROFILE_PAD_KERNELS):
            torch.cuda._sleep(PROFILE_PAD_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # user-annotated ranges (the optimizer's step) carry the device time of
    # the kernels inside them, which are listed too: kept apart, not summed
    device = [(e.key, e.self_device_time_total / 1e3, e.count,
               bool(getattr(e, "is_user_annotation", False)))
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    pad = sum(r[2] for r in device if PAD_KERNEL in r[0])
    device = [r for r in device if PAD_KERNEL not in r[0]]
    kernels = sorted((r[:3] for r in device if not r[3]), key=lambda r: -r[1])
    ranges = sorted((r[:3] for r in device if r[3]), key=lambda r: -r[1])
    device_ms = sum(r[1] for r in kernels)
    ops = [(e.key, str(e.input_shapes)[:120], e.device_time_total / 1e3, e.count)
           for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == DeviceType.CPU and e.key.startswith("aten::")
           and e.key not in ("aten::copy_", "aten::to", "aten::_to_copy")]
    ops.sort(key=lambda r: -r[2])
    summary = {"wall_ms": round(wall_ms, 2), "device_ms": round(device_ms, 2),
               "device_busy_share": round(device_ms / wall_ms, 4),
               "pad_kernels_recorded": pad}
    for label, key in groups.items():
        ms = sum(r[1] for r in kernels if key in r[0])
        summary[f"{label}_ms"] = round(ms, 2)
        summary[f"{label}_share_of_device"] = round(ms / max(device_ms, 1e-9), 4)
        summary[f"{label}_launches"] = sum(r[2] for r in kernels if key in r[0])
    summary["top_kernels"] = [[name[:90], round(ms, 2), n] for name, ms, n in kernels[:12]]
    summary["annotated_ranges"] = [[name[:90], round(ms, 2), n] for name, ms, n in ranges[:4]]
    summary["top_ops"] = [[name, shapes, round(ms, 2), n] for name, shapes, ms, n in ops[:12]]
    log(phase, json.dumps(summary))
    return summary


# the spin kernels that open a profiled window (profile_device): about
# 0.5 ms each on the card; the name torch.cuda._sleep's kernel has
PROFILE_PAD_KERNELS, PROFILE_PAD_CYCLES, PAD_KERNEL = 300, 1_000_000, "spin_kernel"

# the eval phase: frames per clip, resolution, Euler steps, clips scored
EVAL_FRAMES, EVAL_H, EVAL_W, EVAL_STEPS, EVAL_CLIPS = 25, 384, 512, 5, 2
EVAL_KEYS = ("Abs Rel", "delta < 1.25", "normal mean")


def eval_config():
    """The eval phase's config, a dict (no YAML): synthetic box clips rendered
    at the eval resolution (no resize, so no PIL), DepthCrafter from
    model_params at SVD-XT width with random weights (no checkpoint), the
    metric sections of configs/depthcrafter_7scenes.yaml, no strips."""
    return {
        "dataset": "SyntheticBoxDataset", "root": None, "h": EVAL_H, "w": EVAL_W,
        "clip_length": EVAL_FRAMES, "clip_overlap": 0, "split": "test",
        "dataset_params": {"render_size": [EVAL_H, EVAL_W], "num_scenes": 1,
                           "frames_per_scene": EVAL_CLIPS * EVAL_FRAMES},
        "model_name": "DepthCrafter",
        "model_params": {"checkpoint_path": None, "num_inference_steps": EVAL_STEPS,
                         "overlap": 25, "seed": 42, "unet_config": SVD_XT_UNET,
                         "clip_config": SVD_XT_CLIP},
        "eval_depth": {"metric_names": ["Abs Rel", "delta < 1.25", "delta < 1.25^2",
                                        "delta < 1.25^3"], "depth_alignment": "lstsq"},
        "eval_normal": {"metric_names": ["normal mean", "normal median", "angle < 7.5",
                                         "angle < 11.25"]},
        "vis_depth": False,
    }


def unet_feed_forwards(unet_cfg):
    """Feed-forwards of one UNet evaluation: every transformer (layers per
    down stage and layers + 1 per up stage at all stages but the last, and
    the mid block) has a spatial ff and a temporal ff_in and ff."""
    n = len(unet_cfg["block_out_channels"])
    layers = unet_cfg["layers_per_block"]
    return 3 * ((n - 1) * (2 * layers + 1) + 1)


@contextlib.contextmanager
def switched(env):
    """The switches set as in ``env`` (the others unset) inside the block."""
    old = {k: os.environ.pop(k, None) for k in SWITCHES}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def forward_counted(model, data, env):
    """(output, launches, seconds) of one model.forward with ``env`` set."""
    with switched(env):
        reset_counts()
        t0 = time.perf_counter()
        out = model.forward(data)
        torch.cuda.synchronize()
        return out, read_counts(), time.perf_counter() - t0


def phase_eval(dev):
    """The port's evaluator on EVAL_CLIPS synthetic clips with the fused
    GEGLU switch; the resumed run; one clip with neither switch and with the
    head-split switch."""
    from unigeo_tpu_torch.config import EvalConfig
    from unigeo_tpu_torch.data.sample import prepare_gt_label
    from unigeo_tpu_torch.evaluator import evaluate_clip, run_evaluation
    from unigeo_tpu_torch.registry import get_dataset_cls, get_model_cls
    from unigeo_tpu_torch.utils.profiling import ClipTimer

    cfg = EvalConfig.from_dict(eval_config())
    t0 = time.perf_counter()
    model = get_model_cls(cfg.model_name)(**cfg.model_params)
    torch.cuda.synchronize()
    dataset = get_dataset_cls(cfg.dataset)(**cfg.dataset_kwargs)
    log("eval", f"{type(model).__name__} from model_params on {model.pipeline.device} "
        f"({model.pipeline.dtype}) in {time.perf_counter() - t0:.2f}s; {len(dataset)} clips "
        f"of {EVAL_FRAMES} x {EVAL_H} x {EVAL_W}")
    if len(dataset) < EVAL_CLIPS:
        raise AssertionError(f"{len(dataset)} clips, not {EVAL_CLIPS}")
    per_clip = {
        "geglu_ffn": EVAL_STEPS * unet_feed_forwards(SVD_XT_UNET),
        "flash_attention_packed": predicted_launches(SVD_XT_UNET, SVD_XT_CLIP, EVAL_H, EVAL_W,
                                                     EVAL_STEPS),
    }
    fused_env = {"UNIGEO_FUSED_GEGLU": "1"}
    save_dir = tempfile.mkdtemp(prefix="unigeo_eval_")
    try:
        timer = ClipTimer(jsonl_path=os.path.join(save_dir, "clips.jsonl"))
        with switched(fused_env):
            reset_counts()
            t_run = time.perf_counter()
            manager = run_evaluation(cfg, save_dir=save_dir, max_clips=EVAL_CLIPS,
                                     dataset=dataset, model=model, timer=timer, verbose=False)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t_run
            counts = read_counts()
        with open(os.path.join(save_dir, "clips.jsonl")) as f:
            clips = [json.loads(line) for line in f]
        for c in clips:
            log("eval", f"clip {c['clip']} (UNIGEO_FUSED_GEGLU=1): {c['seconds']:.3f}s "
                f"{c['fps']:.3f} frames/s")
        with open(os.path.join(save_dir, "metrics.csv")) as f:
            csv_text = f.read()
        log("eval", f"run_evaluation {run_s:.2f}s, metrics.csv {json.dumps(csv_text)}")
        predicted = {name: EVAL_CLIPS * per_clip.get(name, 0) for name in kernel_wrappers()}
        log("eval", f"kernel launches over {EVAL_CLIPS} clips {json.dumps(counts)}, predicted "
            f"{json.dumps(predicted)}")
        if counts != predicted:
            raise AssertionError(f"eval launches {counts} != predicted {predicted}")
        lines = csv_text.strip().splitlines()
        if len(lines) != EVAL_CLIPS + 2 or not lines[-1].startswith("Average,") or len(clips) != 2:
            raise AssertionError(f"expected {EVAL_CLIPS} rows and an Average row: {csv_text}")
        rows = manager.rows()
        if not all(np.isfinite(r[k]) for r in rows for k in cfg.metric_names):
            raise AssertionError(f"non-finite metrics {rows}")

        # resumed: both clips skipped, no kernel launched
        again = ClipTimer()
        with switched(fused_env):
            reset_counts()
            resumed = run_evaluation(cfg, save_dir=save_dir, max_clips=EVAL_CLIPS,
                                     dataset=dataset, model=model, timer=again, verbose=False)
            resumed_counts = read_counts()
        with open(os.path.join(save_dir, "metrics.csv")) as f:
            unchanged = f.read() == csv_text
        skipped = resumed.sequence_names == manager.sequence_names
        log("eval", f"resumed run: {again.count} clips run, launches "
            f"{sum(resumed_counts.values())}, sequences {resumed.sequence_names}, CSV unchanged "
            f"{unchanged}")
        if again.count or any(resumed_counts.values()) or not (skipped and unchanged):
            raise AssertionError(f"resume ran {again.count} clips, launches {resumed_counts}")
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)

    # one clip: the fused switch again, neither switch, the head-split switch
    data = dataset[0]
    gt = prepare_gt_label(data)
    runs = {}
    for label, env in (("fused_geglu", fused_env), ("neither", {}),
                       ("headsplit", {"UNIGEO_PACKED_ATTN": "0"})):
        out, launched, secs = forward_counted(model, data, env)
        check_prediction(f"eval {label}", out, EVAL_FRAMES, EVAL_H, EVAL_W)
        metrics = evaluate_clip(cfg, out, gt)
        runs[label] = dict(out=out, launches=launched, seconds=secs,
                           metrics={k: metrics[k] for k in EVAL_KEYS})
        log("eval", f"clip 0, {label}: forward {secs:.3f}s, launches {json.dumps(launched)}, "
            f"metrics {json.dumps(runs[label]['metrics'])}")
    expect = {
        "fused_geglu": dict(per_clip),
        "neither": {"flash_attention_packed": per_clip["flash_attention_packed"]},
        "headsplit": {"flash_attention_headsplit": per_clip["flash_attention_packed"]},
    }
    for label, want in expect.items():
        want = {name: want.get(name, 0) for name in kernel_wrappers()}
        if runs[label]["launches"] != want:
            raise AssertionError(f"clip 0 {label}: launches {runs[label]['launches']} != {want}")
    same = runs["fused_geglu"]["metrics"] == {k: rows[0][k] for k in EVAL_KEYS}
    log("eval", f"clip 0 under UNIGEO_FUSED_GEGLU=1 scores as in the evaluator's run: {same}")
    plain, split = runs["neither"], runs["headsplit"]
    depth_dev = float(np.abs(split["out"]["pred_depths"] - plain["out"]["pred_depths"]).max())
    rel = {k: abs(split["metrics"][k] - plain["metrics"][k]) / abs(plain["metrics"][k])
           for k in EVAL_KEYS}
    shift = {k: runs["fused_geglu"]["metrics"][k] - plain["metrics"][k] for k in EVAL_KEYS}
    fused_rel = {k: abs(shift[k]) / abs(plain["metrics"][k]) for k in EVAL_KEYS}
    log("eval", f"head-split vs packed: max depth difference {depth_dev:.3e}, metric rel "
        f"dev {json.dumps(rel)} (tol {EVAL_METRIC_TOL_REL}); fused GEGLU vs unfused: metric "
        f"shift {json.dumps(shift)}, rel dev {json.dumps(fused_rel)} (tol "
        f"{EVAL_METRIC_TOL_REL}); clip seconds fused {runs['fused_geglu']['seconds']:.3f}, "
        f"neither {plain['seconds']:.3f}")
    if not all(v <= EVAL_METRIC_TOL_REL for v in rel.values()):
        raise AssertionError(f"head-split metrics off the packed ones: {rel}")
    if not all(v <= EVAL_METRIC_TOL_REL for v in fused_rel.values()):
        raise AssertionError(f"fused GEGLU metrics off the unfused ones: {fused_rel}")
    return dict(launches=counts, launches_per_clip=per_clip, clips=clips,
                headsplit_launches=split["launches"]["flash_attention_headsplit"],
                depth_dev=depth_dev, metric_rel_dev=rel, fused_shift=shift,
                fused_metric_rel_dev=fused_rel,
                clip_seconds={label: runs[label]["seconds"] for label in runs})


# the disk-eval phase: a 7-Scenes-layout scene of DISK_FRAMES frames read
# through configs/depthcrafter_7scenes.yaml's settings (clips of 20 with
# overlap 5: 3 clips), then one clip of all 45 frames in windows of 25
# overlapping by 5 (windows at 0 and 20)
DISK_FRAMES, DISK_CLIP, DISK_OVERLAP, DISK_CLIPS = 45, 20, 5, 3
DISK_H, DISK_W, DISK_STEPS, DISK_SEED = 384, 512, 5, 42
DISK_WINDOW, DISK_WINDOW_OVERLAP = 25, 5
# clips_per_step 2 against the serial run, bf16 at SVD-XT width.  The
# batch changes nothing per clip but the row count M of the UNet's products
# (encode and decode run per clip; attention, group norm and elementwise
# work per clip), so cuBLAS / cuDNN may sum a product's K terms in another
# order.  Two f32 sums of K terms differ by about K 2^-24 of their
# magnitude, so a bf16 output rounds one unit (2^-8) the other way with
# probability p ~ K 2^-16: 0.02 to 0.18 for the UNet's K of 1280 to 11520,
# an rms change of sqrt(p) 2^-8 <= 1.7e-3 of each product output.  Such
# changes add about in quadrature over the ~L = 300 products of the five
# UNet evaluations that feed the last latent: sqrt(L) 1.7e-3 ~ 3e-2 of its
# scale, carried by the decoder into the normalised disparity x = 1 / depth
# - 0.1 in [0, 1].  Held: the mean over pixels of |x_batched - x_serial|
# within 2^-5 (the estimate's upper end), each batched clip nearer its own
# serial clip than any other, and the metrics within EVAL_METRIC_TOL_REL
# (BASELINE.json's 0.5%); the largest |dx| is reported.
BATCH_X_MEAN_TOL = 2.0**-5


def disk_eval_config(root, cache_dir, **model_params):
    """configs/depthcrafter_7scenes.yaml's content as a dict (the machine with
    the card may lack PyYAML), with ``root`` at the fixture, the sample lists
    cached in ``cache_dir``, the SVD-XT widths written out, ``model_params``
    added and vis_depth off (its strips need matplotlib)."""
    return {
        "dataset": "sevenScenesDataset", "root": root, "h": DISK_H, "w": DISK_W,
        "clip_length": DISK_CLIP, "clip_overlap": DISK_OVERLAP, "split": "test",
        "dataset_params": {"cache_dir": cache_dir},
        "model_name": "DepthCrafter",
        "model_params": {"checkpoint_path": None, "num_inference_steps": DISK_STEPS,
                         "overlap": 25, "unet_config": SVD_XT_UNET, "clip_config": SVD_XT_CLIP,
                         **model_params},
        "eval_depth": {"metric_names": ["Abs Rel", "delta < 1.25", "delta < 1.25^2",
                                        "delta < 1.25^3"], "depth_alignment": "lstsq"},
        "eval_normal": {"metric_names": ["normal mean", "normal median", "angle < 7.5",
                                         "angle < 11.25"]},
        "vis_depth": False,
    }


def run_cli(argv):
    """(stdout, exit code or None) of ``unigeo_tpu_torch.eval.main(argv)``."""
    import io

    from unigeo_tpu_torch import eval as eval_cli

    buf = io.StringIO()
    code = None
    with contextlib.redirect_stdout(buf):
        try:
            eval_cli.main(argv)
        except SystemExit as e:  # --validate-root ends with its report's verdict
            code = e.code
    return buf.getvalue(), code


@contextlib.contextmanager
def recorded_outputs(store):
    """Inside the block, every DepthCrafter.forward / forward_batch output is
    also kept in ``store`` under its clip's dataset index (observation only)."""
    from unigeo_tpu_torch.models.depthcrafter.model import DepthCrafter

    forward, forward_batch = DepthCrafter.forward, DepthCrafter.forward_batch

    def forward_kept(self, data, *args, **kwargs):
        out = forward(self, data, *args, **kwargs)
        store[data["_index"]] = out
        return out

    def forward_batch_kept(self, datas, *args, **kwargs):
        outs = forward_batch(self, datas, *args, **kwargs)
        store.update({d["_index"]: o for d, o in zip(datas, outs)})
        return outs

    DepthCrafter.forward, DepthCrafter.forward_batch = forward_kept, forward_batch_kept
    try:
        yield store
    finally:
        DepthCrafter.forward, DepthCrafter.forward_batch = forward, forward_batch


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms inside the block (its
    default heuristics may pick one whose sums land in another order from
    run to run: found for the f32 UNet, tests/test_torch_cuda.py)."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def read_csv_rows(path):
    """metrics.csv's rows as dicts, its unnamed first column as "seq_name"."""
    import csv

    with open(path) as f:
        header, *rows = list(csv.reader(f))
    return [dict(zip(["seq_name"] + header[1:], row)) for row in rows]


def phase_disk_eval(dev):
    """The port's eval CLI over a 7-Scenes-layout fixture: the preflight, a run
    with prefetch, its resume, the serial run (the same CSV, byte for byte),
    the batched denoise (clips_per_step 2) against the serial run, then the
    two-window crossfade held exactly against its windows."""
    import gc

    from unigeo_tpu_torch import native
    from unigeo_tpu_torch.models.depthcrafter.model import DepthCrafter
    from unigeo_tpu_torch.registry import get_dataset_cls

    try:
        import PIL  # noqa: F401  (only whether it is there)
        have_pil = True
    except ImportError:
        have_pil = False
    reader = native.reader_name()
    log("disk_eval", f"PIL {'present' if have_pil else 'absent'}; clip reader {reader}"
        + (f" (native build: {native.build_error})" if native.build_error else ""))
    if not have_pil and reader != "native":
        raise RuntimeError("this machine has neither PIL nor a native clip reader it can build "
                           f"({native.build_error}): no PNG of the fixture can be decoded")
    root, cache = shared_fixture()
    work = tempfile.mkdtemp(prefix="unigeo_disk_")
    summary = {"reader": reader, "pil": have_pil, "frames_hw": list(_FIXTURE["hw"])}
    try:

        def config_file(name, **model_params):
            path = os.path.join(work, f"{name}.json")
            with open(path, "w") as f:
                json.dump(disk_eval_config(root, cache, **model_params), f)
            return path

        serial_cfg = config_file("serial")
        text, code = run_cli(["--config", serial_cfg, "--validate-root"])
        lines = text.splitlines()
        log("disk_eval", f"--validate-root exit {code}: {json.dumps(lines)}")
        if not (code == 0 and lines[0].startswith(f"clip reader: {reader}")
                and lines[1] == "preflight: 7scenes.test — OK"
                and all(ln.startswith("  ✓ ") for ln in lines[2:]) and len(lines) > 8):
            raise AssertionError(f"the preflight did not pass every check: {text}")

        outputs = {}

        def cli_run(label, cfg, workers, out_dir=None):
            out_dir = out_dir or os.path.join(work, label)
            times = os.path.join(work, f"{label}.jsonl")
            gc.collect()
            torch.cuda.synchronize(dev)  # the device's context exists before its stats are reset
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            t_run = time.perf_counter()
            with recorded_outputs(outputs.setdefault(label, {})):
                text, code = run_cli(["--config", cfg, "--output", out_dir, "--num-workers",
                                      str(workers), "--clip-times", times])
            torch.cuda.synchronize()
            run = {"seconds": time.perf_counter() - t_run, "launches": read_counts(),
                   "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                   "csv": os.path.join(out_dir, "metrics.csv"), "clips": []}
            if code is not None or "Averages:" not in text:
                raise AssertionError(f"{label}: the CLI ended with {code}: {text[-2000:]}")
            if os.path.exists(times):
                with open(times) as f:
                    run["clips"] = [json.loads(line) for line in f]
            for c in run["clips"]:
                log("disk_eval", f"{label} clip {c['clip']}: {c['frames']} frames "
                    f"{c['seconds']:.3f}s {c['fps']:.3f} frames/s")
            log("disk_eval", f"{label}: {run['seconds']:.2f}s, peak {run['peak_gib']:.2f} GiB, "
                f"launches {json.dumps(run['launches'])}")
            return run

        def expect_launches(label, run, packed):
            want = {name: 0 for name in kernel_wrappers()}
            want["flash_attention_packed"] = packed
            if run["launches"] != want:
                raise AssertionError(f"{label}: launches {run['launches']} != {want}")

        per_clip = predicted_launches(SVD_XT_UNET, SVD_XT_CLIP, DISK_H, DISK_W, DISK_STEPS)
        unet = DISK_STEPS * unet_kernel_attentions(SVD_XT_UNET, DISK_H, DISK_W)
        per_pair = unet + 2 * (per_clip - unet)
        summary["launches_predicted"] = {"per_clip": per_clip, "per_two_window_clip": 2 * per_clip,
                                         "per_batched_pair": per_pair}

        # prefetch on two threads; every clip's row, the Average, finite
        prefetch = cli_run("prefetch", serial_cfg, 2)
        expect_launches("prefetch", prefetch, DISK_CLIPS * per_clip)
        with open(prefetch["csv"], "rb") as f:
            csv_bytes = f.read()
        rows = read_csv_rows(prefetch["csv"])
        log("disk_eval", f"metrics.csv {json.dumps(csv_bytes.decode())}")
        names = [r["seq_name"] for r in rows]
        want_names = [f"{i:03d}_chess_seq-01" for i in range(DISK_CLIPS)] + ["Average"]
        if names != want_names or len(prefetch["clips"]) != DISK_CLIPS:
            raise AssertionError(f"rows {names}, timed clips {len(prefetch['clips'])}")
        if not all(np.isfinite(float(v)) for r in rows for k, v in r.items() if k != "seq_name"):
            raise AssertionError(f"non-finite metrics: {rows}")
        for i in range(DISK_CLIPS):
            check_prediction(f"disk clip {i}", outputs["prefetch"][i], DISK_CLIP, DISK_H, DISK_W)

        # resumed: every clip skipped, nothing launched, the CSV unchanged
        resumed = cli_run("resumed", serial_cfg, 2, out_dir=os.path.join(work, "prefetch"))
        with open(prefetch["csv"], "rb") as f:
            unchanged = f.read() == csv_bytes
        log("disk_eval", f"resumed: {len(resumed['clips'])} clips run, CSV unchanged {unchanged}")
        if resumed["clips"] or outputs["resumed"] or not unchanged:
            raise AssertionError("the resumed run ran a clip or changed the CSV")
        expect_launches("resumed", resumed, 0)
        # (the run with --num-workers 0, its CSV byte-identical to this one's,
        # was cut to make room for the parallel phase's training lines: the
        # batched run below reads on the serial loader, and
        # tests/test_torch_preflight_prefetch.py holds prefetch to it)

        # clips_per_step 2: clips 0 and 1 in one batched denoise, clip 2 alone
        batched = cli_run("batched", config_file("batched", clips_per_step=2), 0)
        expect_launches("batched", batched, per_pair + per_clip)
        brows = {r["seq_name"]: r for r in read_csv_rows(batched["csv"])}
        disparity = lambda run, i: 1.0 / outputs[run][i]["pred_depths"].astype(np.float64) - 0.1
        x_dev, nearest = {}, {}
        for i in range(DISK_CLIPS):
            d = np.abs(disparity("batched", i) - disparity("prefetch", i))
            x_dev[i] = {"mean": float(d.mean()), "max": float(d.max())}
            nearest[i] = min(range(DISK_CLIPS), key=lambda j: np.abs(
                disparity("batched", i) - disparity("prefetch", j)).mean())
        metric_rel = {
            name: max(abs(float(brows[name][k]) - float(r[k])) / abs(float(r[k]))
                      for k in EVAL_KEYS)
            for name, r in ((r["seq_name"], r) for r in rows if r["seq_name"] != "Average")}
        log("disk_eval", f"batched vs serial: |dx| of x = 1/depth - 0.1 {json.dumps(x_dev)} "
            f"(mean tol {BATCH_X_MEAN_TOL}), nearest serial clip {json.dumps(nearest)}, "
            f"metric rel dev {json.dumps(metric_rel)} (tol "
            f"{EVAL_METRIC_TOL_REL}); clip 2 ran alone through forward_batch, identical to the "
            f"serial forward: {x_dev[2]['max'] == 0.0}")
        if not (all(x_dev[i]["mean"] <= BATCH_X_MEAN_TOL and nearest[i] == i
                    for i in range(DISK_CLIPS))
                and all(v <= EVAL_METRIC_TOL_REL for v in metric_rel.values())):
            raise AssertionError(f"the batched denoise is off the serial run: {x_dev} "
                                 f"{metric_rel}")
        summary.update(
            clip_seconds={k: [c["seconds"] for c in run["clips"]]
                          for k, run in (("prefetch", prefetch), ("batched", batched))},
            clip_fps={k: [c["fps"] for c in run["clips"]]
                      for k, run in (("prefetch", prefetch), ("batched", batched))},
            peak_gib={"prefetch": prefetch["peak_gib"], "batched": batched["peak_gib"]},
            run_seconds={"prefetch": prefetch["seconds"], "batched": batched["seconds"]},
            batched_x_dev=x_dev, batched_metric_rel=metric_rel)
        del outputs
        gc.collect()
        torch.cuda.empty_cache()

        # the two-window crossfade on one 45-frame clip, held exactly against
        # its windows run alone: the same kernels on the same inputs, with
        # cuDNN's deterministic algorithms
        ds = get_dataset_cls("sevenScenesDataset")(
            root=root, clip_length=DISK_FRAMES, clip_overlap=0, input_size=(DISK_H, DISK_W),
            target_size=(DISK_H, DISK_W), cache_dir=cache)
        data = ds[0]
        params = disk_eval_config(root, cache, window_size=DISK_WINDOW,
                                  overlap=DISK_WINDOW_OVERLAP)["model_params"]
        model = DepthCrafter(**params, device=dev)
        pipe = model.pipeline

        frames = pipe.prepare_clip(data["images"])
        starts = list(range(0, DISK_FRAMES - DISK_WINDOW_OVERLAP, DISK_WINDOW - DISK_WINDOW_OVERLAP))
        if starts != [0, 20]:
            raise AssertionError(f"window starts {starts}")
        with deterministic_cudnn():
            reset_counts()
            t_call = time.perf_counter()
            decoded = pipe(frames, num_inference_steps=DISK_STEPS, window_size=DISK_WINDOW,
                           overlap=DISK_WINDOW_OVERLAP, seed=DISK_SEED)
            torch.cuda.synchronize()
            call_s, call_counts = time.perf_counter() - t_call, read_counts()
            wins = []
            for wi, start in enumerate(starts):
                noise, aug = pipe.draw_clip_noise(pipe.window_generator(DISK_SEED, wi),
                                                  DISK_WINDOW, DISK_H, DISK_W)
                wins.append(pipe.run_window_staged(frames[start:start + DISK_WINDOW], noise,
                                                   DISK_STEPS, aug_noise=aug))
        ov = DISK_WINDOW_OVERLAP
        r = torch.from_numpy(np.linspace(0.0, 1.0, ov, endpoint=False)).to(dev).reshape(-1, 1, 1, 1)
        blend = ((1.0 - r) * wins[0][-ov:].double() + r * wins[1][:ov].double()).float()
        max_dev = {
            "frames_0_19": (decoded[:20] - (wins[0][:20] + 1.0) / 2.0).abs().max().item(),
            "frames_20_24": (decoded[20:25] - (blend + 1.0) / 2.0).abs().max().item(),
            "frames_25_44": (decoded[25:] - (wins[1][ov:] + 1.0) / 2.0).abs().max().item(),
        }
        exact = {k: v == 0.0 for k, v in max_dev.items()}
        with deterministic_cudnn():
            reset_counts()
            t_fwd = time.perf_counter()
            out = model.forward(data)
            torch.cuda.synchronize()
            fwd_s, fwd_counts = time.perf_counter() - t_fwd, read_counts()
        check_prediction("windowed forward", out, DISK_FRAMES, DISK_H, DISK_W)
        exact["forward_is_the_call_postprocessed"] = np.array_equal(
            out["pred_depths"], model._finalize(decoded, data)["pred_depths"])
        log("disk_eval", f"two windows of {DISK_WINDOW} (overlap {ov}) on {DISK_FRAMES} frames: "
            f"__call__ {call_s:.3f}s {DISK_FRAMES / call_s:.3f} frames/s, launches "
            f"{call_counts['flash_attention_packed']}; forward {fwd_s:.3f}s, launches "
            f"{fwd_counts['flash_attention_packed']} (predicted {2 * per_clip}); max |dev| "
            f"{json.dumps(max_dev)}, exact {json.dumps(exact)}")
        expect_launches("windowed __call__", {"launches": call_counts}, 2 * per_clip)
        expect_launches("windowed forward", {"launches": fwd_counts}, 2 * per_clip)
        if not all(exact.values()):
            raise AssertionError(f"the crossfade is not its windows: {exact}")
        summary.update(window_call_s=call_s, window_forward_s=fwd_s, window_exact=exact)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("disk_eval", json.dumps(summary))
    return summary


# the training phase: frames per clip, resolution, measured steps after one
# warm-up step
TRAIN_FRAMES, TRAIN_H, TRAIN_W, TRAIN_STEPS = 25, 384, 512, 2


def phase_train(dev):
    """The port's train.main at SVD-XT width, bf16, random weights made on the
    card, on synthetic box clips rendered at the training resolution (no
    resize, so no PIL).  Counts are set to 0 after the warm-up step and read
    after the last; per step they must equal the configuration's count."""
    from unigeo_tpu_torch import train

    config = dict(
        dataset="SyntheticBoxDataset", root=None, h=TRAIN_H, w=TRAIN_W,
        clip_length=TRAIN_FRAMES, clip_overlap=0, split="test", model_name="DepthCrafter",
        dataset_params=dict(render_size=[TRAIN_H, TRAIN_W], num_scenes=1,
                            frames_per_scene=TRAIN_FRAMES),
        model_params=dict(unet_config=SVD_XT_UNET, clip_config=SVD_XT_CLIP),
    )
    steps = []

    def on_step(step, loss, seconds):
        steps.append(dict(step=step, loss=loss, seconds=seconds))
        log("train", f"step {step}{' (warm-up)' if step == 0 else ''}: loss {loss:.6f} "
            f"step_s {seconds:.3f}")
        if step == 0:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()

    log_dir = tempfile.mkdtemp(prefix="unigeo_train_logs_")
    t0 = time.perf_counter()
    try:
        # no checkpoint: the SVD-XT state is about 4.5 GB
        out = train.main(["--steps", str(1 + TRAIN_STEPS), "--log-dir", log_dir,
                          "--ckpt-every", "0"], config=config, on_step=on_step)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    card_gib = torch.cuda.get_device_properties(dev).total_memory / 2**30

    unet = out["trainer"].unet
    n_params = sum(p.numel() for p in unet.parameters())
    # the self-attention query projections, spatial (the kernel path at
    # stages 0-2, the plain one in the 48-token mid block) and temporal
    to_q = {name: p.grad for name, p in unet.named_parameters()
            if name.endswith("transformer_blocks.0.attn1.to_q.weight")}
    spatial = [name for name in to_q if ".transformer_blocks.0." in "." + name]
    no_grad = [name for name, g in to_q.items() if g is None or not torch.any(g != 0)]
    per_step = {
        "flash_attention_fwd_lse": unet_kernel_attentions(SVD_XT_UNET, TRAIN_H, TRAIN_W),
        "flash_attention_bwd_dq": unet_kernel_attentions(SVD_XT_UNET, TRAIN_H, TRAIN_W),
        "flash_attention_bwd_dkv": unet_kernel_attentions(SVD_XT_UNET, TRAIN_H, TRAIN_W),
        # batch building: CLIP, and the VAE encoder's mid block for the RGB
        # conditioning and the depth target
        "flash_attention_packed": clip_kernel_attentions(SVD_XT_CLIP)
        + 2 * vae_mid_attentions(TRAIN_H, TRAIN_W),
        # neither switch is set in training, and no model uses ln_dense
        "flash_attention_headsplit": 0,
        "geglu_ffn": 0,
        "ln_dense": 0,
    }
    predicted = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    measured = steps[1:]
    losses = [r["loss"] for r in measured]
    step_s = [r["seconds"] for r in measured]
    batch_s = out["batch_seconds"][1:]
    log("train", f"{TRAIN_STEPS} steps after warm-up: losses {losses} step_s {step_s} "
        f"batch_s {[round(x, 3) for x in batch_s]} (its encodes; the target's in f32) "
        f"mean_step_s {sum(step_s) / len(step_s):.3f} frames {TRAIN_FRAMES} "
        f"{TRAIN_H}x{TRAIN_W}, UNet params {n_params / 1e9:.3f} B, peak_mem_gib "
        f"{peak_gib:.2f} of {card_gib:.2f}, whole phase {total_s:.1f}s")
    log("train", f"kernel launches over {TRAIN_STEPS} steps {json.dumps(counts)}, "
        f"predicted {json.dumps(predicted)}")
    log("train", f"self-attention to_q with a non-zero gradient: spatial "
        f"{len([n for n in spatial if n not in no_grad])} of {len(spatial)}, temporal "
        f"{len([n for n in to_q if n not in spatial and n not in no_grad])} of "
        f"{len(to_q) - len(spatial)}")
    if not all(np.isfinite(x) for x in [r["loss"] for r in steps]):
        raise AssertionError(f"non-finite training loss: {steps}")
    if counts != predicted:
        raise AssertionError(f"training launches {counts} != predicted {predicted}")
    if no_grad or not spatial:
        raise AssertionError(f"self-attention to_q without a gradient: {no_grad}")
    if peak_gib > 0.9 * card_gib:
        raise AssertionError(f"peak {peak_gib:.2f} GiB leaves less than 10% of {card_gib:.2f}")
    result = dict(losses=losses, step_s=step_s, batch_s=batch_s, peak_mem_gib=peak_gib,
                  frames=TRAIN_FRAMES, launches=counts, launches_per_step=per_step)
    del to_q
    batch = train.build_batch_diffusion([out["dataset"][0]], out["pipe"])
    # one batch's device time: CLIP and the VAE's bf16 encode of the frames,
    # and the f32 encode of the depth target (its mid attention at d = 512
    # on the f32 forward's wide register-tiled body)
    bprof = profile_device("profile", lambda: train.build_batch_diffusion(
        [out["dataset"][0]], out["pipe"]),
        {"flash": "flash_", "flash_f32_d512": "f32w512", "conv_fprop": "fprop",
         "elementwise": "elementwise"})
    # one wrapper call at [25, 3072, 1, 512]: the host plan's kernel launches
    from unigeo_tpu_torch.ops.attention import f32_d512_plan

    whole, rest, _ = f32_d512_plan(TRAIN_FRAMES, TRAIN_H * TRAIN_W // 64, TRAIN_H * TRAIN_W // 64,
                                   1, torch.cuda.get_device_properties(dev).multi_processor_count)
    want = (whole > 0) + (rest > 0)
    if bprof["flash_f32_d512_launches"] != want:
        raise AssertionError(f"the batch's f32 target encode launched the d 512 body "
                             f"{bprof['flash_f32_d512_launches']} times, not {want}")
    log("train", f"one batch: device_ms {bprof['device_ms']}, of which flash "
        f"{bprof['flash_ms']} ms ({bprof['flash_launches']} launches; the f32 d 512 body "
        f"{bprof['flash_f32_d512_ms']} ms)")
    result.update(batch_device_ms=bprof["device_ms"], batch_flash_device_ms=bprof["flash_ms"],
                  batch_flash_f32_d512_device_ms=bprof["flash_f32_d512_ms"])
    # (the training step's own profile was cut to make room for the parallel
    # phase: its kernels' device times are the kernel phase's batch-25 rows)
    del out, unet, batch
    torch.cuda.empty_cache()
    return result


def phase_tool_ln_qkv():
    """The port's ablation tool in-process at full size; the kernel's
    launches against its parameters' count, nothing else launched."""
    from unigeo_tpu_torch.tools import ablate_ln_qkv

    reset_counts()
    t0 = time.perf_counter()
    results = ablate_ln_qkv.main([])  # prints its JSON line
    torch.cuda.synchronize()
    counts = read_counts()
    predicted = {name: 0 for name in counts}
    predicted["ln_dense"] = len(ablate_ln_qkv.SHAPES) * ablate_ln_qkv.launches_per_shape()
    log("tool", f"ablate_ln_qkv {time.perf_counter() - t0:.2f}s, kernel launches "
        f"{json.dumps(counts)}, predicted {json.dumps(predicted)} ({len(ablate_ln_qkv.SHAPES)} "
        f"shapes x (warm-up {ablate_ln_qkv.WARMUP} + chain {ablate_ln_qkv.LENGTH} + check 1))")
    if counts != predicted:
        raise AssertionError(f"tool launches {counts} != predicted {predicted}")
    worst = max(r["max_err_over_limit"] for r in results["shapes"])
    if not worst <= 1.0:
        raise AssertionError(f"ablate_ln_qkv: kernel vs plain max err/limit {worst}")
    return counts["ln_dense"], results


def identity_config():
    """configs/identity_synthetic.yaml as a dict (the card machine has no
    PyYAML)."""
    return {
        "dataset": "SyntheticBoxDataset", "root": None, "h": 96, "w": 128, "clip_length": 8,
        "clip_overlap": 2, "split": "test", "model_name": "IdentityModel", "model_params": {},
        "eval_depth": {"metric_names": ["Abs Rel", "delta < 1.25", "delta < 1.25^2",
                                        "delta < 1.25^3"], "depth_alignment": "lstsq"},
        "eval_normal": {"metric_names": ["normal mean", "normal median", "angle < 7.5",
                                         "angle < 11.25"]},
        "eval_pcd": {"metric_names": ["acc", "comp", "nc1", "nc2"], "pcd_downsample_num": 4000},
        "eval_camera": {"metric_names": ["ATE", "RPE trans", "RPE rot"]},
    }


# the point count at which the metrics phase holds pcd_evaluation on the card
# against the CPU (the card's timing stays at 10000)
PCD_COMPARE_POINTS = 2500


def pcd_tolerance(key, value, q_max):
    """The card-vs-CPU tolerance of one point-cloud statistic."""
    if key.startswith("nc"):
        return PCD_NC_TOL
    return PCD_MOVED_TOL * q_max + 2 * 16 * 2.0**-24 * q_max**2 / max(value, 1e-30)


def phase_metrics(dev):
    """The identity config on the card (all four families, perfect scores)
    against the same run on the CPU; then one 25 x 384 x 512 clip with a
    perturbed cloud at pcd_downsample_num 10000: pcd_evaluation and
    camera_pose_evaluation seconds, and pcd_evaluation at
    PCD_COMPARE_POINTS on the card against the CPU."""
    from unigeo_tpu_torch.config import EvalConfig
    from unigeo_tpu_torch.data.sample import prepare_gt_label
    from unigeo_tpu_torch.evaluator import run_evaluation
    from unigeo_tpu_torch.metrics.camera import camera_pose_evaluation
    from unigeo_tpu_torch.metrics.pointcloud import PCD_METRIC_KEYS, pcd_evaluation
    from unigeo_tpu_torch.registry import get_dataset_cls

    cfg = EvalConfig.from_dict(identity_config())
    dataset = get_dataset_cls(cfg.dataset)(**cfg.dataset_kwargs)
    q_max = 0.0
    for i in range(len(dataset)):
        gt = prepare_gt_label(dataset[i])
        norms = np.linalg.norm(gt["gt_world_pts"][gt["gt_masks"]], axis=-1)
        q_max = max(q_max, float(norms.max()))
    dirs = {d: tempfile.mkdtemp(prefix=f"unigeo_identity_{d}_") for d in ("cuda", "cpu")}
    try:
        runs, csvs = {}, {}
        for device, save_dir in dirs.items():
            reset_counts()
            t0 = time.perf_counter()
            runs[device] = run_evaluation(cfg, save_dir=save_dir, dataset=dataset,
                                          verbose=False, device=device)
            torch.cuda.synchronize()
            with open(os.path.join(save_dir, "metrics.csv")) as f:
                csvs[device] = f.read()
            log("metrics", f"identity config, metrics on {device}: {len(dataset)} clips in "
                f"{time.perf_counter() - t0:.2f}s, kernel launches {sum(read_counts().values())}"
                f", metrics.csv {json.dumps(csvs[device])}")
    finally:
        for save_dir in dirs.values():
            shutil.rmtree(save_dir, ignore_errors=True)
    avg = runs["cuda"].calculate_averages()
    cpu_avg = runs["cpu"].calculate_averages()
    dist_tol = math.sqrt(32 * 2.0**-24) * q_max
    perfect = (avg["Abs Rel"] < 1e-5 and avg["delta < 1.25"] == 1.0 and avg["ATE"] < 1e-6
               and avg["RPE trans"] < 1e-6 and avg["RPE rot"] == cpu_avg["RPE rot"]
               and avg["acc"] < dist_tol and avg["comp"] < dist_tol and avg["nc1"] > 1 - 1e-5
               and avg["nc2"] > 1 - 1e-5 and avg["normal mean"] < 0.1)
    same = {k: avg[k] == cpu_avg[k] for k in avg}
    log("metrics", f"identity averages on the card {json.dumps(avg)}; equal to the CPU run's: "
        f"{json.dumps(same)}; acc/comp round-off bound {dist_tol:.3e}")
    if not perfect:
        raise AssertionError(f"identity scores not perfect on the card: {avg}")
    if any(abs(avg[k] - cpu_avg[k]) > dist_tol for k in ("acc", "comp")):
        raise AssertionError(f"identity acc/comp card {avg} vs CPU {cpu_avg}")

    # one production-size clip, a perturbed prediction of its cloud
    clip = get_dataset_cls("SyntheticBoxDataset")(
        clip_length=EVAL_FRAMES, num_scenes=1, frames_per_scene=EVAL_FRAMES,
        render_size=(EVAL_H, EVAL_W))[0]
    gt = prepare_gt_label(clip)
    rng = np.random.default_rng(13)
    a = math.radians(3.0)
    rot = np.array([[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0], [0, 0, 1]])
    pts = gt["gt_world_pts"]
    pred = (1.1 * pts @ rot.T + np.array([0.02, -0.01, 0.03])
            + rng.normal(0, 0.005, pts.shape)).astype(np.float32)
    poses = gt["gt_poses"].copy()
    poses[:, :3, 3] += rng.normal(0, 0.01, poses[:, :3, 3].shape).astype(np.float32)
    q_max = float(np.linalg.norm(pts[gt["gt_masks"]], axis=-1).max())
    res, secs = {}, {}
    # timed on the card at 10000 points; held against the CPU at
    # PCD_COMPARE_POINTS (the CPU's neighbour search at 10000 took 15 s)
    for label, device, n in (("card_first", "cuda", 10000), ("card", "cuda", 10000),
                             ("card_compared", "cuda", PCD_COMPARE_POINTS),
                             ("cpu", "cpu", PCD_COMPARE_POINTS)):
        t0 = time.perf_counter()
        res[label] = pcd_evaluation(pred, pts, gt["gt_masks"], device=device,
                                    rgbs=gt["gt_rgbs"], downsample_num=n)
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cam = camera_pose_evaluation(poses, gt["gt_poses"])
    cam_s = time.perf_counter() - t0
    pcd = {k: res["card"][k] for k in PCD_METRIC_KEYS}
    ratio = max(abs(res["card_compared"][k] - res["cpu"][k])
                / pcd_tolerance(k, res["cpu"][k], q_max) for k in PCD_METRIC_KEYS)
    log("metrics", f"clip {EVAL_FRAMES}x{EVAL_H}x{EVAL_W}, {int(gt['gt_masks'].sum())} valid "
        f"points, downsample 10000: pcd_evaluation on the card {secs['card']:.3f}s (first call "
        f"{secs['card_first']:.3f}s); at {PCD_COMPARE_POINTS} on the card "
        f"{secs['card_compared']:.3f}s, on the CPU {secs['cpu']:.3f}s; camera_pose_evaluation "
        f"(numpy f64, host) {cam_s:.4f}s; card metrics {json.dumps(pcd)}, ATE/RPE trans/RPE rot "
        f"{json.dumps(cam)}; card vs CPU at {PCD_COMPARE_POINTS} max dev/tol {ratio:.3e}")
    if not (ratio <= 1.0 and all(np.isfinite(v) for v in pcd.values())):
        raise AssertionError(f"pcd metrics card {res['card_compared']} vs CPU {res['cpu']}")
    if not torch.backends.cuda.matmul.allow_tf32 is False:
        raise AssertionError("TF32 is on for the metrics' f32 products")
    return dict(pcd_s=secs["card"], pcd_cpu_s=secs["cpu"], camera_s=cam_s, pcd=pcd, camera=cam)


# --- the SVD-family siblings and the pointmap family ---------------------------

# the launches of the packed kernel each new path makes per clip (SIB_CLIP
# frames; Spann3R's PM_CLIP), as the configuration predicts them
# (sibling_launches); the same numbers worked out by hand from the code, which
# the phases also hold
SIBLING_TABLE = {"heun": 169, "stablenormal": 94, "chronodepth": 217, "depthanyvideo": 217,
                 "unigeo": 49, "unigeo_branch": 207, "spann3r": 128}
# UniGeo without its branch, DepthCrafter's path under another adapter, at
# one Euler step (its 5 steps' clip is the main phase's)
UNIGEO_STEPS = 1
# one clip a model over the 45-frame fixture, of 15 frames (cut from the
# scannetpp configs' 25 to make room for the bf16_drift phase; ChronoDepth
# still crossfades two windows of 10, DepthAnyVideo still runs its keyframes
# and then the rest)
SIB_CLIP, SIB_OVERLAP, SIB_CLIPS = 15, 5, 1
PM_CLIP, PM_OVERLAP, PM_CLIPS = 20, 5, 1  # spann3r_7scenes.yaml's clips, one scored
# the default Spann3R network (Spann3RNetwork's defaults)
PM_ENC_DEPTH, PM_DEC_DEPTH = 8, 6
SPANN3R_BF16_CLIP = 8  # the bf16 Spann3R clip's frames


def sibling_launches(kind, frames, steps=5, window=10, overlap=5, keyframe_gap=4):
    """Packed-kernel launches of one clip of ``frames`` frames at DISK_H x
    DISK_W, from the configuration: every UNet evaluation's spatial
    attentions, CLIP's blocks and the VAE's mid blocks (encoder per encode,
    decoder per decode); the pointmap network's self-attentions (encoder
    layers once over all frames, decoder layers once per frame; its
    cross-attentions are masked and dense)."""
    from unigeo_tpu_torch.ops.attention import MIN_KERNEL_SEQ

    unet = unet_kernel_attentions(SVD_XT_UNET, DISK_H, DISK_W)
    encode = clip_kernel_attentions(SVD_XT_CLIP) + vae_mid_attentions(DISK_H, DISK_W)
    decode = vae_mid_attentions(DISK_H, DISK_W)
    tokens = (DISK_H // 16) * (DISK_W // 16)
    pointmap = (PM_ENC_DEPTH + PM_DEC_DEPTH * frames) if tokens >= MIN_KERNEL_SEQ else 0
    if kind == "heun":
        return encode + (2 * steps - 1) * unet + decode
    if kind == "stablenormal":
        return encode + steps * unet + decode
    if kind == "chronodepth":
        windows = len(range(0, max(frames - overlap, 1), window - overlap))
        return windows * (encode + steps * unet) + decode
    if kind == "depthanyvideo":
        keys = len(set(range(0, frames, keyframe_gap)) | {frames - 1})
        return (1 if keys == frames else 2) * (encode + steps * unet) + decode
    if kind == "unigeo":
        return encode + steps * unet + decode
    if kind == "unigeo_branch":
        return encode + steps * unet + decode + pointmap
    if kind == "spann3r":
        return pointmap
    raise ValueError(kind)


@contextlib.contextmanager
def models_given(extra):
    """Inside the block the eval CLI builds its model with ``extra(name)``'s
    keywords added (a shared pipeline) and keeps each model it builds."""
    from unigeo_tpu_torch import eval as eval_cli

    get = eval_cli.get_model_cls
    built = []

    def factory(name):
        cls = get(name)
        return lambda **kw: built.append(cls(**kw, **extra(name))) or built[-1]

    eval_cli.get_model_cls = factory
    try:
        yield built
    finally:
        eval_cli.get_model_cls = get


@contextlib.contextmanager
def stage_clock():
    """Inside the block each stage's wall ms (the device synchronised around
    it) is summed by name: encode, denoise, decode (the pipeline's stages),
    pointmap_network and camera (the Spann3R, Dust3R and Cut3R networks and
    the camera recovery), vda_network and postprocess (VideoDepthAnything's
    network and its depth and normals), and Aether's encode, denoise (the
    flow sampler), decode and pose (the host's recovery from the raymaps)."""
    from unigeo_tpu_torch.models import aether, vda
    from unigeo_tpu_torch.models.depthcrafter.pipeline import DepthCrafterPipeline
    from unigeo_tpu_torch.models.pointmap import adapter
    from unigeo_tpu_torch.models.pointmap.cut3r import Cut3RNetwork
    from unigeo_tpu_torch.models.pointmap.dust3r import Dust3RNetwork
    from unigeo_tpu_torch.models.pointmap.spann3r import Spann3RNetwork

    sites = [(DepthCrafterPipeline, "_encode_stage", "encode"),
             (DepthCrafterPipeline, "_denoise_loop", "denoise"),
             (DepthCrafterPipeline, "_decode_stage", "decode"),
             (DepthCrafterPipeline, "_decode_frames", "decode"),
             (Spann3RNetwork, "forward", "pointmap_network"),
             (Dust3RNetwork, "forward", "pointmap_network"),
             (Cut3RNetwork, "forward", "pointmap_network"),
             (vda.VDANetwork, "forward", "vda_network"),
             (vda, "postprocess", "postprocess"),
             (adapter, "outputs_from_world_pts", "camera"),
             (aether.AetherNetwork, "encode", "encode"),
             (aether.AetherNetwork, "sample", "denoise"),
             (aether.AetherNetwork, "decode", "decode"),
             (aether, "poses_from_raymaps", "pose")]
    ms = {}
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in sites]

    def timed(fn, name):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            ms[name] = ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return run

    for (owner, attr, name), (_, _, fn) in zip(sites, saved):
        setattr(owner, attr, timed(fn, name))
    try:
        yield ms
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def counted_cli(dev, work, label, cfg, extra, clips):
    """One run of the eval CLI on ``cfg`` (written as JSON) with ``--max-clips
    clips``, its model given ``extra``'s keywords: seconds, launches, peak
    GiB, stage ms summed over the run, each clip's seconds, the CSV rows,
    the models built."""
    import gc

    path = os.path.join(work, f"{label}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    out_dir, times = os.path.join(work, label), os.path.join(work, f"{label}.jsonl")
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    with models_given(extra) as built, stage_clock() as stage_ms:
        text, code = run_cli(["--config", path, "--output", out_dir, "--max-clips", str(clips),
                              "--clip-times", times])
    torch.cuda.synchronize()
    run = {"seconds": time.perf_counter() - t0, "launches": read_counts(),
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "stage_ms": {k: round(v, 2) for k, v in stage_ms.items()}, "models": built}
    if code is not None or "Averages:" not in text:
        raise AssertionError(f"{label}: the CLI ended with {code}: {text[-2000:]}")
    with open(times) as f:
        run["clip_s"] = [json.loads(line)["seconds"] for line in f]
    run["rows"] = read_csv_rows(os.path.join(out_dir, "metrics.csv"))
    return run


def hold_run(phase, label, run, cfg, predicted, clips):
    """The run's rows finite for every metric the config names, one row a
    clip and the Average; the packed kernel launched as predicted per clip
    and no other kernel."""
    names = [n for sec in ("eval_depth", "eval_normal", "eval_pcd", "eval_camera")
             for n in cfg.get(sec, {}).get("metric_names", [])]
    rows = run["rows"]
    if len(rows) != clips + 1 or rows[-1]["seq_name"] != "Average":
        raise AssertionError(f"{label}: rows {[r['seq_name'] for r in rows]}")
    bad = [(r["seq_name"], n, r[n]) for r in rows for n in names
           if not np.isfinite(float(r[n]))]
    if bad:
        raise AssertionError(f"{label}: non-finite metrics {bad}")
    want = {name: 0 for name in kernel_wrappers()}
    want["flash_attention_packed"] = clips * predicted
    table = {**SIBLING_TABLE, **POINTMAP_TABLE, "aether": AETHER_LAUNCHES}.get(label, "-")
    log(phase, f"{label}: {clips} clips in {run['seconds']:.2f}s, per clip "
        f"{json.dumps([round(s, 3) for s in run['clip_s']])}s, peak {run['peak_gib']:.2f} GiB, "
        f"stage_ms (summed over the clips) {json.dumps(run['stage_ms'])}, packed launches "
        f"{run['launches']['flash_attention_packed']} = {clips} x {predicted} predicted "
        f"(table {table}); Average "
        f"{json.dumps({n: rows[-1][n] for n in names})}")
    if run["launches"] != want:
        raise AssertionError(f"{label}: launches {run['launches']} != {want}")


def fixture_config(root, cache, model_name, model_params, sections, clip, overlap):
    """A config over the 7-Scenes fixture at DISK_H x DISK_W (a dict: the
    card machine may lack PyYAML), strips off."""
    return {"dataset": "sevenScenesDataset", "root": root, "h": DISK_H, "w": DISK_W,
            "clip_length": clip, "clip_overlap": overlap, "split": "test",
            "dataset_params": {"cache_dir": cache}, "model_name": model_name,
            "model_params": model_params, **sections, "vis_depth": False}


def read_config(name):
    """A config of configs/ as a dict (PyYAML, which the card machine has;
    imported here only)."""
    import yaml

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", name)) as f:
        return yaml.safe_load(f)


SECTIONS = ("eval_depth", "eval_normal", "eval_pcd", "eval_camera")


_FIXTURE = {}


def shared_fixture():
    """(root, sample-list cache) of the 7-Scenes fixture, DISK_FRAMES frames:
    7-Scenes' own 480 x 640 when PIL can resize it to DISK_H x DISK_W, else
    frames at DISK_H x DISK_W (no resize runs).  Written once a run into a
    temporary directory removed at exit; every phase reads it (the sample
    lists are cached per clip length and overlap)."""
    from unigeo_tpu_torch.tools.disk_fixture import write_seven_scenes

    if "dirs" not in _FIXTURE:
        try:
            import PIL  # noqa: F401  (only whether it is there)
            fh, fw = 480, 640
        except ImportError:
            fh, fw = DISK_H, DISK_W
        work = tempfile.mkdtemp(prefix="unigeo_fixture_")
        atexit.register(shutil.rmtree, work, True)
        root, cache = os.path.join(work, "7scenes"), os.path.join(work, "lists")
        t0 = time.perf_counter()
        write_seven_scenes(root, DISK_FRAMES, fh, fw)
        log("fixture", f"{DISK_FRAMES} frames {fh} x {fw} in {time.perf_counter() - t0:.2f}s")
        _FIXTURE["dirs"], _FIXTURE["hw"] = (root, cache), (fh, fw)
    return _FIXTURE["dirs"]


def sibling_reference(dev):
    """The tiny f32 pipeline at 128 x 128 on the card (the kernel at 256
    latent tokens) against the same weights on the CPU: Heun's latents,
    StableNormal's frames and ChronoDepth's depths within REFERENCE_TOL_REL;
    the known-frame clamp exact on the card."""
    from unigeo_tpu_torch.device import set_exact_f32
    from unigeo_tpu_torch.models.chronodepth import ChronoDepth
    from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline
    from unigeo_tpu_torch.models.stablenormal import StableNormal

    set_exact_f32()
    gpu = tiny_pipeline(device=dev, solver="heun").init_random(
        torch.Generator(device=dev).manual_seed(5))
    cpu = tiny_pipeline(device="cpu", solver="heun")
    for m_cpu, m_gpu in zip(cpu.modules(), gpu.modules()):
        m_cpu.load_state_dict({k: v.cpu() for k, v in m_gpu.state_dict().items()})
    rng = np.random.default_rng(14)
    t, h, w = 4, 128, 128
    cond = torch.from_numpy(rng.standard_normal((1, t, 4, 16, 16)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((1, t, 1, 32)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((1, t, 4, 16, 16)).astype(np.float32))
    rel = lambda a, b: ((a.cpu() - b).abs().max() / b.abs().max()).item()
    reset_counts()
    heun = gpu._denoise_loop(cond.to(dev), ctx.to(dev), noise.to(dev), 3)
    launched = read_counts()["flash_attention_packed"]
    dev_rel = {"heun": rel(heun, cpu._denoise_loop(cond, ctx, noise, 3))}
    known = torch.from_numpy(rng.standard_normal((t, 4, 16, 16)).astype(np.float32))
    mask = torch.tensor([1.0, 1.0, 0.0, 0.0])
    x = gpu._denoise_stage_known(cond[0].to(dev), ctx[0].to(dev), noise[0].to(dev),
                                 known.to(dev), mask, 3)
    exact = bool(torch.equal(x[:2].cpu(), known[:2]))
    dev_rel["known"] = rel(x, cpu._denoise_stage_known(cond[0], ctx[0], noise[0], known, mask, 3))
    gpu.solver = cpu.solver = "euler"
    k = np.array([[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]], np.float32)
    data = {"images": rng.integers(0, 256, (t, 3, h, w)).astype(np.uint8),
            "intrinsics": np.stack([k] * t)}
    # the same draws on both sides (the two devices' generators differ)
    draw = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    frame_noise, frame_aug = draw(1, 16, 16, 4), draw(1, h, w, 3)
    dev_rel["stablenormal"] = rel(
        StableNormal(pipeline=gpu, num_inference_steps=3)._run_frames(
            gpu.prepare_clip(data["images"]), frame_noise, frame_aug),
        StableNormal(pipeline=cpu, num_inference_steps=3)._run_frames(
            cpu.prepare_clip(data["images"]), frame_noise, frame_aug))
    kw = dict(num_inference_steps=3, window_size=3, overlap=1)
    windows = [draw(3, 16, 16, 4), draw(3, 16, 16, 4)]  # starts 0 and 1
    dev_rel["chronodepth"] = rel(
        torch.from_numpy(ChronoDepth(_pipeline=gpu, **kw).forward(data, windows)["pred_depths"]),
        torch.from_numpy(ChronoDepth(_pipeline=cpu, **kw).forward(data, windows)["pred_depths"]))
    log("svd_family", f"tiny pipeline 4x128x128 f32 card vs CPU rel dev "
        f"{json.dumps(dev_rel)} (tol {REFERENCE_TOL_REL}); Heun kernel launches {launched}; "
        f"known frames equal on the card: {exact}")
    if not (exact and launched > 0 and all(v <= REFERENCE_TOL_REL for v in dev_rel.values())):
        raise AssertionError(f"sibling reference: {dev_rel}, exact {exact}, launches {launched}")
    del gpu, cpu
    torch.cuda.empty_cache()


def phase_svd_family(dev):
    """Heun, StableNormal, ChronoDepth, DepthAnyVideo and UniGeoCam (no
    branch) through the eval CLI over the 7-Scenes fixture at DISK_H x
    DISK_W, clips of SIB_CLIP, on copies of their configs' model_params at
    SVD-XT width, sharing one bf16 pipeline made on the card."""
    from unigeo_tpu_torch.models.depthcrafter.pipeline import DepthCrafterPipeline

    sibling_reference(dev)
    work = tempfile.mkdtemp(prefix="unigeo_siblings_")
    summary = {}
    try:
        root, cache = shared_fixture()
        pipe = DepthCrafterPipeline(unet_config=SVD_XT_UNET, clip_config=SVD_XT_CLIP,
                                    dtype=torch.bfloat16, device=dev)
        pipe.init_random(torch.Generator(device=dev).manual_seed(0))
        heun = copy.copy(pipe)  # the same modules, its own solver
        heun.solver = "heun"
        dc = read_config("depthcrafter_7scenes.yaml")
        cd = read_config("chronodepth_scannetpp.yaml")
        dav = read_config("depthanyvideo_scannetpp.yaml")
        sn = read_config("stablenormal_scannetpp.yaml")
        ug = read_config("unigeo_synthetic.yaml")["model_params"]
        # the unigeo config's keys at full width: its tiny widths and sizes
        # dropped, no branch (the pointmap phase runs it), UNIGEO_STEPS steps
        ug_full = {k: v for k, v in ug.items()
                   if not k.endswith("_config") and not k.startswith("init_")}
        ug_full.update(geometry_branch=False, num_inference_steps=UNIGEO_STEPS)
        sections = lambda c: {s: c[s] for s in SECTIONS if s in c}
        runs = [
            ("heun", "DepthCrafter", {**dc["model_params"], "solver": "heun"}, sections(dc),
             lambda name: {"pipeline": heun}, sibling_launches("heun", SIB_CLIP)),
            ("stablenormal", "StableNormal", sn["model_params"], sections(sn),
             lambda name: {"pipeline": pipe},
             sibling_launches("stablenormal", SIB_CLIP, sn["model_params"]["num_inference_steps"])),
            ("chronodepth", "ChronoDepth", cd["model_params"], sections(cd),
             lambda name: {"_pipeline": pipe},
             sibling_launches("chronodepth", SIB_CLIP, window=cd["model_params"]["window_size"],
                              overlap=cd["model_params"]["overlap"])),
            ("depthanyvideo", "DepthAnyVideo", dav["model_params"], sections(dav),
             lambda name: {"_pipeline": pipe},
             sibling_launches("depthanyvideo", SIB_CLIP,
                              keyframe_gap=dav["model_params"]["keyframe_gap"])),
            ("unigeo", "UniGeo", ug_full, sections(dc), lambda name: {"pipeline": pipe},
             sibling_launches("unigeo", SIB_CLIP, UNIGEO_STEPS)),
        ]
        for label, name, params, secs, extra, predicted in runs:
            if predicted != SIBLING_TABLE[label]:
                raise AssertionError(f"{label}: predicted {predicted} != table "
                                     f"{SIBLING_TABLE[label]}")
            cfg = fixture_config(root, cache, name, params, secs, SIB_CLIP, SIB_OVERLAP)
            run = counted_cli(dev, work, label, cfg, extra, SIB_CLIPS)
            hold_run("svd_family", label, run, cfg, predicted, SIB_CLIPS)
            model = run.pop("models")[0]
            used = getattr(model, "pipeline", None) or model.pipe
            if used.unet is not pipe.unet:
                raise AssertionError(f"{label}: the model did not use the shared pipeline")
            summary[label] = {k: run[k] for k in ("seconds", "clip_s", "peak_gib", "stage_ms")}
            summary[label]["launches_per_clip"] = predicted
            del model, used, run
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("svd_family", json.dumps(summary))
    return summary


def pointmap_reference(dev):
    """Spann3R (tiny widths, RoPE100 + DPT) in f32 at 192 x 256 (192 tokens,
    the f32 kernel) on the card against the CPU within 1e-4 relative, and
    the camera recovery on a scene with known cameras, card against CPU:
    rotations within 1e-3 degree, translations within 1e-3 of their norm
    (tests/test_torch_cuda.py's bounds)."""
    from unigeo_tpu_torch.device import set_exact_f32
    from unigeo_tpu_torch.models.camera_solver import solve_depth_and_camera_from_pointmaps
    from unigeo_tpu_torch.models.pointmap.spann3r import Spann3R, tiny_spann3r_config

    set_exact_f32()
    cfg = dict(tiny_spann3r_config(), pos_embed="RoPE100", qkv_bias=True, norm_context=True,
               head_type="dpt")
    card = Spann3R(network_config=cfg, device=dev, seed=3)
    cpu = Spann3R(network_config=cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.network.state_dict().items()})
    rng = np.random.default_rng(15)
    frames = torch.from_numpy(rng.random((3, 192, 256, 3)).astype(np.float32))
    reset_counts()
    with torch.no_grad():
        pts, _ = card.network(frames.to(dev))
        launched = read_counts()["flash_attention_packed"]
        ref, _ = cpu.network(frames)
    net_rel = ((pts.cpu() - ref).abs().max() / ref.abs().max()).item()
    h, w = 48, 64
    uu, vv = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    world = []
    for i in range(3):
        depth = 2.0 + rng.uniform(0, 0.5, (h, w))
        cam = np.stack([(uu - w / 2) * depth / 50.0, (vv - h / 2) * depth / 50.0, depth], -1)
        theta = rng.normal(0, 0.05, 3) * (i > 0)
        kx = np.array([[0, -theta[2], theta[1]], [theta[2], 0, -theta[0]],
                       [-theta[1], theta[0], 0]])
        r = np.eye(3) + kx + kx @ kx / 2.0  # near a rotation; the solver projects
        u, _, vt = np.linalg.svd(r)
        r = u @ vt
        t = rng.normal(0, 0.2, 3) * (i > 0)
        world.append(((cam.reshape(-1, 3) - t) @ r).reshape(h, w, 3))
    world = torch.from_numpy(np.stack(world).astype(np.float32))
    _, ext_c, _ = solve_depth_and_camera_from_pointmaps(world.to(dev))
    _, ext_h, _ = solve_depth_and_camera_from_pointmaps(world)
    # again with TF32 on in the process, as a caller may leave it: the
    # solver turns it off inside (device.exact_f32), so the same result
    from unigeo_tpu_torch.models import camera_solver

    seen, solve = [], camera_solver.solve_pnp_batch

    def solve_seen(*args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return solve(*args, **kwargs)

    camera_solver.solve_pnp_batch = solve_seen
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        _, ext_tf, _ = camera_solver.solve_depth_and_camera_from_pointmaps(world.to(dev))
        after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    finally:
        camera_solver.solve_pnp_batch = solve
        set_exact_f32()
    tf_dev = (ext_tf - ext_c).abs().max().item()
    d = ext_c[:, :3, :3].cpu().double() @ ext_h[:, :3, :3].double().transpose(1, 2)
    angle = float(np.degrees(2 * np.arcsin(np.clip(
        (d - torch.eye(3, dtype=torch.float64)).norm(dim=(1, 2)).max().item()
        / (2 * np.sqrt(2)), 0, 1))))
    t_rel = ((ext_c[1:, :3, 3].cpu() - ext_h[1:, :3, 3]).norm(dim=-1)
             / ext_h[1:, :3, 3].norm(dim=-1)).max().item()
    log("pointmap", f"tiny Spann3R 3x192x256 f32 card vs CPU rel dev {net_rel:.3e} (tol 1e-4), "
        f"f32 kernel launches {launched}; camera recovery card vs CPU: rotation "
        f"{angle:.3e} deg (tol 1e-3), translation rel {t_rel:.3e} (tol 1e-3); with TF32 on in "
        f"the process: flags inside the solver (matmul, cudnn) {seen}, after it {after}, "
        f"extrinsics max |dev| from the TF32-off run {tf_dev:.3e} (tol 1e-6)")
    if not (net_rel <= 1e-4 and launched == 2 + 2 * 3 and angle <= 1e-3 and t_rel <= 1e-3
            and seen == [(False, False)] and after == (True, True) and tf_dev <= 1e-6):
        raise AssertionError(f"pointmap reference: {net_rel} {launched} {angle} {t_rel} "
                             f"{seen} {after} {tf_dev}")


def phase_pointmap(dev):
    """spann3r_7scenes.yaml's copy (clips of 20, the default Spann3R widths
    in f32) through the eval CLI over the 7-Scenes fixture, then UniGeoCam
    with its geometry branch at full width on all four metric families
    (clips of 25), both with TF32 off (phase_reference turned it off)."""
    from unigeo_tpu_torch.models.depthcrafter.pipeline import DepthCrafterPipeline

    pointmap_reference(dev)
    work = tempfile.mkdtemp(prefix="unigeo_pointmap_")
    summary = {}
    try:
        root, cache = shared_fixture()
        sp = read_config("spann3r_7scenes.yaml")
        sp_secs = {s: sp[s] for s in SECTIONS if s in sp}
        cfg = fixture_config(root, cache, "Spann3R", sp["model_params"], sp_secs, PM_CLIP,
                             PM_OVERLAP)
        predicted = sibling_launches("spann3r", PM_CLIP)
        if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
            raise AssertionError("TF32 is on for the pointmap phase's f32 runs")
        run = counted_cli(dev, work, "spann3r", cfg, lambda name: {}, PM_CLIPS)
        hold_run("pointmap", "spann3r", run, cfg, predicted, PM_CLIPS)
        net = run.pop("models")[0].network
        summary["spann3r"] = {k: run[k] for k in ("seconds", "clip_s", "peak_gib",
                                                   "stage_ms")}
        summary["spann3r"]["launches_per_clip"] = predicted
        summary["spann3r"]["params"] = sum(p.numel() for p in net.parameters())
        if (next(net.parameters()).dtype != torch.float32
                or len(net.encoder.blocks.layers) != PM_ENC_DEPTH):
            raise AssertionError("Spann3R is not the default network in f32")
        del net, run
        summary["spann3r_bf16"] = spann3r_bf16(dev, root, cache, sp)
        # UniGeoCam with the branch: the unigeo config's keys at full width
        ug = read_config("unigeo_synthetic.yaml")
        params = {k: v for k, v in ug["model_params"].items()
                  if not k.endswith("_config") and not k.startswith("init_")
                  and k != "num_inference_steps"}
        secs = {s: ug[s] for s in SECTIONS if s in ug}
        secs["eval_pcd"] = dict(secs["eval_pcd"], pcd_downsample_num=10000)
        pipe = DepthCrafterPipeline(unet_config=SVD_XT_UNET, clip_config=SVD_XT_CLIP,
                                    dtype=torch.bfloat16, device=dev)
        pipe.init_random(torch.Generator(device=dev).manual_seed(0))
        cfg = fixture_config(root, cache, "UniGeoCam", params, secs, SIB_CLIP, SIB_OVERLAP)
        predicted = sibling_launches("unigeo_branch", SIB_CLIP)
        run = counted_cli(dev, work, "unigeo_branch", cfg, lambda name: {"pipeline": pipe},
                          SIB_CLIPS)
        hold_run("pointmap", "unigeo_branch", run, cfg, predicted, SIB_CLIPS)
        families = [s for s in SECTIONS if s in secs]
        if len(families) != 4:
            raise AssertionError(f"unigeo_branch scored {families}")
        summary["unigeo_branch"] = {k: run[k] for k in ("seconds", "clip_s", "peak_gib",
                                                         "stage_ms")}
        summary["unigeo_branch"]["launches_per_clip"] = predicted
        summary["unigeo_branch"]["average"] = run["rows"][-1]
        del run, pipe
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("pointmap", json.dumps(summary))
    return summary


def spann3r_bf16(dev, root, cache, sp):
    """The config's Spann3R with ``compute_dtype`` bf16 on one
    SPANN3R_BF16_CLIP-frame fixture clip: warm seconds and launches, and
    its world points' deviation from one call of the same weights in f32.
    (Cut from the 20-frame clip, each dtype warm, to make room for the
    parallel phase's training lines.)"""
    from unigeo_tpu_torch.models.pointmap.spann3r import Spann3R
    from unigeo_tpu_torch.registry import get_dataset_cls

    ds = get_dataset_cls("sevenScenesDataset")(
        root=root, clip_length=SPANN3R_BF16_CLIP, clip_overlap=0, input_size=(DISK_H, DISK_W),
        target_size=(DISK_H, DISK_W), cache_dir=cache)
    data = ds[0]
    f32 = Spann3R(**sp["model_params"], device=dev)
    bf16 = Spann3R(**sp["model_params"], compute_dtype="bfloat16", device=dev)
    bf16.load_state_dict(f32.network.state_dict())
    pts32 = f32.forward_tensors(data)["pred_world_pts"]
    del f32
    bf16.forward_tensors(data)  # first call at the shapes
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    pts16 = bf16.forward_tensors(data)["pred_world_pts"]
    torch.cuda.synchronize()
    res = {"frames": SPANN3R_BF16_CLIP, "seconds": time.perf_counter() - t0,
           "launches": read_counts()["flash_attention_packed"],
           "predicted": sibling_launches("spann3r", SPANN3R_BF16_CLIP),
           "world_pts_rel_dev": ((pts16 - pts32).abs().max() / pts32.abs().max()).item(),
           "world_pts_mean_rel_dev": ((pts16 - pts32).abs().mean()
                                      / pts32.abs().mean()).item()}
    log("pointmap", f"Spann3R (spann3r_7scenes.yaml's network) in bf16, one "
        f"{SPANN3R_BF16_CLIP}-frame clip, warm, against one f32 call: {json.dumps(res)}")
    if not (res["launches"] == res["predicted"] and np.isfinite(res["world_pts_rel_dev"])):
        raise AssertionError(f"Spann3R bf16: {res}")
    del bf16, pts16, pts32
    torch.cuda.empty_cache()
    return res


# the packed kernel's launches per clip on the Dust3R, Cut3R and
# VideoDepthAnything paths at DISK_H x DISK_W (pointmap_launches), worked out
# by hand: Dust3R 24 encoder + 12 layers x 2 streams x (self + cross); Cut3R
# 8 encoder + 20 frames x 6 layers x (self + cross), its state blocks' 64
# queries on the plain version; VideoDepthAnything 24 encoder, its temporal
# blocks' 25 queries on the plain version
POINTMAP_TABLE = {"dust3r": 72, "cut3r": 248, "vda": 24}
VDA_CLIP = 25  # vda_scannetpp.yaml's clips
POINTMAP_MODELS = (("dust3r", "Dust3R", "dust3r_7scenes.yaml", PM_CLIP),
                   ("cut3r", "Cut3R", "cut3r_7scenes.yaml", PM_CLIP),
                   ("vda", "VideoDepthAnything", "vda_scannetpp.yaml", VDA_CLIP))


def network_args(cls, model_params):
    """A network's arguments: ``cls``'s defaults under the config's
    network_config."""
    import inspect

    args = {k: p.default for k, p in inspect.signature(cls.__init__).parameters.items()
            if p.default is not inspect.Parameter.empty}
    args.update(model_params.get("network_config") or {})
    return args


def pointmap_launches(kind, model_params, frames):
    """Packed-kernel launches of one clip of ``frames`` frames at DISK_H x
    DISK_W, from the config: every attention whose queries number at least
    MIN_KERNEL_SEQ, once per call.  Dust3R: the encoder's layers once over
    all frames, each entangled layer's two streams' self- and
    cross-attention once over the pairs; Cut3R: the encoder, then per frame
    each decoder layer's self- and cross-attention (the frame's tokens) and
    its two state blocks' (the state tokens); VideoDepthAnything: the
    encoder, then the four temporal blocks over the frame axis (``frames``
    queries)."""
    from unigeo_tpu_torch.models.pointmap.cut3r import Cut3RNetwork
    from unigeo_tpu_torch.models.pointmap.dust3r import Dust3RNetwork
    from unigeo_tpu_torch.models.vda import VDANetwork
    from unigeo_tpu_torch.ops.attention import MIN_KERNEL_SEQ

    cls = {"dust3r": Dust3RNetwork, "cut3r": Cut3RNetwork, "vda": VDANetwork}[kind]
    a = network_args(cls, model_params)
    p = a["patch_size"]
    tokens = (DISK_H // p) * (DISK_W // p) + (1 if a.get("use_class_token") else 0)
    big = int(tokens >= MIN_KERNEL_SEQ)
    if kind == "dust3r":
        return big * (a["enc_depth"] + a["dec_depth"] * 2 * 2)
    if kind == "cut3r":
        state = int(a["num_state_tokens"] >= MIN_KERNEL_SEQ)
        return big * a["enc_depth"] + frames * (big * a["dec_depth"] * 2 + state * 2 * 2)
    return big * a["depth"] + int(frames >= MIN_KERNEL_SEQ) * 4


def pointmap_models_reference(dev):
    """Dust3R, Cut3R (both RoPE100 + DPT) and VideoDepthAnything at tiny
    widths in f32 at 192 x 256 (192 tokens: the f32 kernel) on the card
    against the same weights on the CPU, every output within 1e-4 of the
    reference's largest magnitude; the kernel's launches as the tiny
    configs predict."""
    from unigeo_tpu_torch.device import set_exact_f32
    from unigeo_tpu_torch.models.pointmap.adapter import init_network_
    from unigeo_tpu_torch.models.pointmap.cut3r import Cut3RNetwork, tiny_cut3r_config
    from unigeo_tpu_torch.models.pointmap.dust3r import Dust3RNetwork, tiny_dust3r_config
    from unigeo_tpu_torch.models.vda import VDANetwork, tiny_vda_config

    set_exact_f32()
    rope = dict(pos_embed="RoPE100", qkv_bias=True, norm_context=True, head_type="dpt")
    frames = torch.from_numpy(np.random.default_rng(17).random((3, 192, 256, 3))
                              .astype(np.float32))
    # (label, network, its call, launches: encoder + decoder as in pointmap_launches)
    cases = [("dust3r", Dust3RNetwork(**tiny_dust3r_config(), **rope),
              lambda net, f: net(f[:1], f[1:]), 2 + 2 * 4),
             ("cut3r", Cut3RNetwork(**tiny_cut3r_config(), **rope), lambda net, f: net(f),
              2 + 3 * 2 * 2),
             ("vda", VDANetwork(**tiny_vda_config()), lambda net, f: net(f), 4)]
    flat = lambda out: (list(out.values()) if isinstance(out, dict)
                        else list(out) if isinstance(out, tuple) else [out])
    res = {}
    for label, cpu_net, run, want in cases:
        init_network_(cpu_net.eval().requires_grad_(False), torch.Generator().manual_seed(3))
        card = copy.deepcopy(cpu_net).to(dev)
        reset_counts()
        with torch.no_grad():
            outs = flat(run(card, frames.to(dev)))
            launched = read_counts()["flash_attention_packed"]
            refs = flat(run(cpu_net, frames))
        rel = max(((o.cpu() - r).abs().max() / r.abs().max()).item() for o, r in zip(outs, refs))
        res[label] = {"rel_dev": rel, "launches": launched, "predicted": want}
        if not (rel <= 1e-4 and launched == want):
            raise AssertionError(f"{label} reference: {res[label]}")
    log("pointmap_models", f"tiny networks 3x192x256 f32 card vs CPU (tol 1e-4): "
        f"{json.dumps(res)}")


def fixture_clip(root, cache, clip, overlap):
    """The 7-Scenes fixture's first clip at DISK_H x DISK_W."""
    from unigeo_tpu_torch.registry import get_dataset_cls

    return get_dataset_cls("sevenScenesDataset")(
        root=root, clip_length=clip, clip_overlap=overlap, input_size=(DISK_H, DISK_W),
        target_size=(DISK_H, DISK_W), cache_dir=cache)[0]


def phase_pointmap_models(dev):
    """Dust3R and Cut3R (their 7-Scenes configs' model_params: clips of 20)
    and VideoDepthAnything (vda_scannetpp.yaml's network: ViT-L, patch 14,
    clips of 25) through the eval CLI over the 7-Scenes fixture, one clip
    each, in f32 with TF32 off: per-clip seconds, peak memory, stage ms, the
    packed kernel's launches held to pointmap_launches and POINTMAP_TABLE,
    every metric the config scores finite.  (Their profiled clips were cut
    to make room for the parallel phase; the kernel phase holds the f32
    body by name at their shapes.)"""
    pointmap_models_reference(dev)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on for the pointmap models' f32 runs")
    work = tempfile.mkdtemp(prefix="unigeo_pointmap_models_")
    summary = {}
    try:
        root, cache = shared_fixture()
        for label, name, config, clip in POINTMAP_MODELS:
            conf = read_config(config)
            predicted = pointmap_launches(label, conf["model_params"], clip)
            if predicted != POINTMAP_TABLE[label]:
                raise AssertionError(f"{label}: predicted {predicted} != table "
                                     f"{POINTMAP_TABLE[label]}")
            secs = {s: conf[s] for s in SECTIONS if s in conf}
            cfg = fixture_config(root, cache, name, conf["model_params"], secs, clip, PM_OVERLAP)
            run = counted_cli(dev, work, label, cfg, lambda name: {}, 1)
            hold_run("pointmap_models", label, run, cfg, predicted, 1)
            model = run.pop("models")[0]
            if next(model.network.parameters()).dtype != torch.float32:
                raise AssertionError(f"{label}: the network is not f32")
            summary[label] = {k: run[k] for k in ("seconds", "clip_s", "peak_gib", "stage_ms")}
            summary[label].update(
                launches_per_clip=predicted, params=sum(p.numel() for p in model.network.parameters()),
                families=[s for s in SECTIONS if s in secs], average=run["rows"][-1])
            del model, run
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("pointmap_models", json.dumps(summary))
    return summary


# Aether on configs/aether_scannetpp.yaml's clips (16, overlap 4) at DISK_H x
# DISK_W, and the packed kernel's launches per clip worked out by hand: the
# DiT's one sequence of 4 latent frames x 24 x 32 patches = 3072 tokens
# attends once in each of 16 blocks at each of 4 steps
AETHER_CLIP, AETHER_OVERLAP, AETHER_LAUNCHES = 16, 4, 64


def aether_launches(model_params, frames, h=DISK_H, w=DISK_W):
    """Packed-kernel launches of one Aether clip of ``frames`` frames at h x
    w, from the config: the DiT's sequence of ceil(T / ct) (h / cs / p)
    (w / cs / p) tokens, once per block per step where it holds
    MIN_KERNEL_SEQ tokens or more."""
    from unigeo_tpu_torch.models.aether import Aether, AetherDiT, CausalVAE3D
    from unigeo_tpu_torch.ops.attention import MIN_KERNEL_SEQ

    dit = network_args(AetherDiT, model_params)
    vae = network_args(CausalVAE3D, {"network_config": model_params.get("vae_config")})
    steps = model_params.get("num_steps", network_args(Aether, {})["num_steps"])
    ct, cs, p = 2 ** sum(map(bool, vae["temporal_down"])), 2 ** len(vae["mults"]), dit["patch"]
    tokens = -(-frames // ct) * (h // cs // p) * (w // cs // p)
    return int(tokens >= MIN_KERNEL_SEQ) * dit["depth"] * steps


def aether_reference(dev):
    """The small Aether of tools/aether_check.py (256 DiT tokens on the f32
    kernel, 2 steps) in f32 on the card against the same weights on the
    CPU, its constant leaves perturbed, both given one noise draw: depths,
    raymaps, world points and poses within 1e-4 of the reference's largest
    magnitude; normals by angle, the median within 0.05 degree and the
    mean within twice the mean turn that one f32 step of depth noise gives
    the CPU's normals (aether_check.within_limits: the plane fit's
    round-off turns some pixels far, ROADMAP queue 3 item 5); the kernel's
    launches as predicted."""
    from unigeo_tpu_torch.device import set_exact_f32
    from unigeo_tpu_torch.tools import aether_check

    set_exact_f32()
    network_config, vae_config = aether_check.kernel_path_configs()
    kw = dict(network_config=network_config, vae_config=vae_config,
              num_steps=aether_check.STEPS)
    want = aether_launches(kw, aether_check.FRAMES, aether_check.SIDE, aether_check.SIDE)
    reset_counts()
    devs, launched = aether_check.run_on_both(
        dev, 5, 18, 19, count=lambda: read_counts()["flash_attention_packed"])
    res = {"deviations": devs, "launches": launched, "predicted": want}
    log("aether", f"kernel-path Aether {aether_check.FRAMES}x{aether_check.SIDE}x"
        f"{aether_check.SIDE} f32 card vs CPU (tol {aether_check.REL_TOL} relative; normals: "
        f"median {aether_check.NORMAL_DEG_TOL} deg, mean {aether_check.NORMAL_FLOOR_FACTOR} x "
        f"the round-off floor): {json.dumps(res)}")
    if not (aether_check.within_limits(devs) and launched == want == aether_check.LAUNCHES):
        raise AssertionError(f"aether reference: {res}")


def phase_aether(dev):
    """Aether with configs/aether_scannetpp.yaml's model_params (a DiT of
    width 768, depth 16, 12 heads; 4 steps; the VAE at cs 8, ct 4) through
    the eval CLI over the 7-Scenes fixture, one clip of 16, in f32 with TF32
    off: per-clip seconds, peak memory, parameters, stage ms, the packed
    kernel's launches held to aether_launches and AETHER_LAUNCHES, every
    metric of the four families finite.  (Its profiled clip was cut to make
    room for the parallel phase.)"""
    aether_reference(dev)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on for Aether's f32 run")
    work = tempfile.mkdtemp(prefix="unigeo_aether_")
    try:
        root, cache = shared_fixture()
        conf = read_config("aether_scannetpp.yaml")
        predicted = aether_launches(conf["model_params"], AETHER_CLIP)
        if predicted != AETHER_LAUNCHES:
            raise AssertionError(f"aether: predicted {predicted} != {AETHER_LAUNCHES}")
        secs = {s: conf[s] for s in SECTIONS if s in conf}
        if len(secs) != len(SECTIONS):
            raise AssertionError(f"aether: the config scores {sorted(secs)}")
        cfg = fixture_config(root, cache, "Aether", conf["model_params"], secs, AETHER_CLIP,
                             AETHER_OVERLAP)
        run = counted_cli(dev, work, "aether", cfg, lambda name: {}, 1)
        hold_run("aether", "aether", run, cfg, predicted, 1)
        model = run.pop("models")[0]
        if {p.dtype for p in model.network.parameters()} != {torch.float32}:
            raise AssertionError("aether: the network is not f32")
        summary = {k: run[k] for k in ("seconds", "clip_s", "peak_gib", "stage_ms")}
        summary.update(
            launches_per_clip=predicted,
            params=sum(p.numel() for p in model.network.parameters()),
            dit_params=sum(p.numel() for p in model.network.dit.parameters()),
            families=list(secs), average=run["rows"][-1])
        del model, run
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("aether", json.dumps(summary))
    return {"aether": summary}


# the training phase of the f32 families (train_models): (label, model name,
# config, frames of the one clip each step trains on); each step launches
# fwd_lse, dq and dk/dv as often as the eval forward launches the packed
# kernel on a clip of those frames (train_launches), the table's counts at
# the configs' clips.  Dust3R's 20-frame clip is cut to 16, the 90% of the
# card that train_family holds every family to being what forces it: at 20
# frames its step peaked at 70.7-75.9 of 79.2 GiB with allocator retries (a
# failed cudaMalloc, the cache freed, the malloc tried again), at 18 at 72.6
# GiB, 4 GiB over a frame's share (cuDNN's workspace turns on the batch), so
# 17 would stand within one workspace of the limit
DUST3R_TRAIN_CLIP = 16
TRAIN_MODELS = (("spann3r", "Spann3R", "spann3r_7scenes.yaml", PM_CLIP),
                ("dust3r", "Dust3R", "dust3r_7scenes.yaml", DUST3R_TRAIN_CLIP),
                ("cut3r", "Cut3R", "cut3r_7scenes.yaml", PM_CLIP),
                ("vda", "VideoDepthAnything", "vda_scannetpp.yaml", VDA_CLIP),
                ("aether", "Aether", "aether_scannetpp.yaml", AETHER_CLIP))
TRAIN_MODELS_TABLE = {"spann3r": 128, "dust3r": 72, "cut3r": 248, "vda": 24, "aether": 16}
# one step each (cut from two to make room for the bf16_drift phase: the
# second step's batch and step took 2.7-6.0 s a family)
TRAIN_MODELS_STEPS = 1


def train_launches(label, model_params, frames):
    """fwd_lse (and dq, dk/dv) launches of one training step on a clip of
    ``frames``: the eval forward's packed launches per clip, Aether's for
    one evaluation of the DiT (the forward's are per sampling step)."""
    if label == "spann3r":
        return sibling_launches("spann3r", frames)
    if label == "aether":
        steps = model_params.get("num_steps", 4)
        return aether_launches(model_params, frames) // steps
    return pointmap_launches(label, model_params, frames)


def aether_checkpoint_reloaded(dev, out, model_params, data):
    """The trained Aether's checkpoint (its {"vae", "dit"} layout) loaded by
    the eval adapter through checkpoint_path: every output of one clip
    bitwise equal to the trained module's in memory (cuDNN's deterministic
    algorithms on both)."""
    from unigeo_tpu_torch.models.aether import Aether

    path = out["checkpoints"][-1]
    trained = out["model"]
    trained.network.requires_grad_(False)
    t0 = time.perf_counter()
    loaded = Aether(**dict(model_params, checkpoint_path=path), device=dev)
    load_s = time.perf_counter() - t0
    with deterministic_cudnn():
        a, b = trained.forward_tensors(data), loaded.forward_tensors(data)
    torch.cuda.synchronize()
    equal = {k: torch.equal(a[k], b[k]) for k in a}
    res = {"checkpoint_bytes": os.path.getsize(path), "load_s": load_s,
           "bitwise_equal": equal,
           "changed_by_training": not torch.equal(
               trained.network.dit.final_proj.weight,
               torch.zeros_like(trained.network.dit.final_proj.weight))}
    log("train_models", f"aether checkpoint {os.path.basename(path)} "
        f"{res['checkpoint_bytes'] / 2**20:.1f} MiB, loaded by Aether(checkpoint_path=...) "
        f"in {load_s:.2f}s: outputs bitwise equal to the trained module's {json.dumps(equal)}")
    if not (all(equal.values()) and res["changed_by_training"]):
        raise AssertionError(f"aether checkpoint reload: {res}")
    del loaded, a, b
    return res


def train_family(dev, label, name, cfg, steps, extra_args, predicted):
    """``steps`` steps of train.main on ``cfg``: the losses, step seconds,
    peak GiB and allocator retries, each step's launches held to
    ``predicted`` (kernel name -> count; the rest 0) and the peak to 90% of
    the card, as phase_train holds the SVD-XT trainer's."""
    import gc

    from unigeo_tpu_torch import train

    counts = []

    def on_step(step, loss, seconds):
        counts.append(read_counts())
        reset_counts()

    log_dir = tempfile.mkdtemp(prefix="unigeo_train_logs_")
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev) / 2**30
    retries = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)
    reset_counts()
    t0 = time.perf_counter()
    try:
        out = train.main(["--steps", str(steps), "--log-dir", log_dir, *extra_args], config=cfg,
                         on_step=on_step)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    torch.cuda.synchronize()
    want = {k: predicted.get(k, 0) for k in kernel_wrappers()}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    # the allocator's retries: a cudaMalloc that failed, its cache freed
    # (device-wide synchronisations) and the malloc tried again
    retries = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0) - retries
    card = torch.cuda.get_device_properties(dev).total_memory / 2**30
    row = {"frames": cfg["clip_length"], "losses": out["losses"],
           "step_s": out["step_seconds"], "batch_s": out["batch_seconds"], "peak_gib": peak,
           "held_before_gib": held, "alloc_retries": retries,
           "params": sum(p.numel() for p in out["trainer"].params),
           "launches_per_step": predicted, "phase_s": time.perf_counter() - t0}
    log("train_models", f"{label}: {steps} steps on {row['frames']} frames, {row['params'] / 1e6:.1f} M "
        f"trained parameters, losses {out['losses']}, step_s "
        f"{[round(x, 3) for x in out['step_seconds']]} (batches "
        f"{[round(x, 3) for x in out['batch_seconds']]}), peak {peak:.2f} of {card:.2f} GiB "
        f"({held:.2f} held before; {retries} allocator retries), "
        f"launches per step {json.dumps([{k: v for k, v in c.items() if v} for c in counts])} "
        f"(predicted {json.dumps(predicted)}), {row['phase_s']:.1f}s in all")
    if not all(np.isfinite(out["losses"])):
        raise AssertionError(f"{label}: non-finite training loss {out['losses']}")
    if counts != [want] * steps:
        raise AssertionError(f"{label}: launches per step {counts} != {want}")
    if peak > 0.9 * card:
        raise AssertionError(f"{label}: peak {peak:.2f} GiB leaves less than 10% of {card:.2f}")
    return out, row


def phase_train_models(dev):
    """train.main at each TRAIN_MODELS config's full width in f32 with TF32
    off over the 7-Scenes fixture, TRAIN_MODELS_STEPS steps of one clip
    (the f32 trainers: the forward with lse, dq and dk/dv on the f32 bodies
    at every attention of 128 queries or more; each config's clip in full
    but Dust3R's, DUST3R_TRAIN_CLIP); Aether saves its checkpoint at full
    width, which its eval adapter reloads (bitwise-equal outputs);
    then one step of the ChronoDepth branch (direct-depth targets, the bf16
    SVD-XT pipeline) on a PAR_TRAIN_T-frame clip."""
    from unigeo_tpu_torch.device import set_exact_f32

    set_exact_f32()
    root, cache = shared_fixture()
    work = tempfile.mkdtemp(prefix="unigeo_train_models_")
    summary = {}
    kernels = ("flash_attention_fwd_lse", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    try:
        for label, name, config, frames in TRAIN_MODELS:
            mp = read_config(config)["model_params"]
            n = train_launches(label, mp, frames)
            cfg = fixture_config(root, cache, name, mp, {}, frames, 0)
            save = label == "aether"
            ckpt = ["--ckpt-dir", os.path.join(work, label),
                    "--ckpt-every", str(TRAIN_MODELS_STEPS if save else 0)]
            out, row = train_family(dev, label, name, cfg, TRAIN_MODELS_STEPS, ckpt,
                                    {k: n for k in kernels})
            row["table"] = TRAIN_MODELS_TABLE[label]
            if save:
                row.update(aether_checkpoint_reloaded(
                    dev, out, mp, fixture_clip(root, cache, frames, 0)))
            summary[label] = row
            del out
        # the SVD branch's direct-depth trainer at SVD-XT width, bf16, on
        # PAR_TRAIN_T frames (cut from 25 to make room for the parallel
        # phase's training lines)
        mp = read_config("chronodepth_scannetpp.yaml")["model_params"]
        cfg = fixture_config(root, cache, "ChronoDepth", mp, {}, PAR_TRAIN_T, 0)
        unet = unet_kernel_attentions(SVD_XT_UNET, DISK_H, DISK_W)
        per_step = {k: unet for k in kernels}
        per_step["flash_attention_packed"] = (clip_kernel_attentions(SVD_XT_CLIP)
                                              + 2 * vae_mid_attentions(DISK_H, DISK_W))
        out, row = train_family(dev, "chronodepth", "ChronoDepth", cfg, 1,
                                ["--ckpt-every", "0"], per_step)
        summary["chronodepth"] = row
        del out
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    log("train_models", json.dumps(summary))
    return summary


def f32_bound(b, sq, sk, h, d):
    """The f32 forward's bound: 4 B H Sq Sk D operations at the CUDA cores'
    f32 rate, q and k, v read and o written once in f32 (4 B H D (2 Sq +
    2 Sk) bytes)."""
    flops = 4.0 * b * h * sq * sk * d
    nbytes = 4.0 * b * h * d * (2 * sq + 2 * sk)
    t_ops, t_bytes = flops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# the f32 body's shapes (name, B, Sq, Sk, H, D) on the pointmap paths at 384 x
# 512 (768 tokens at patch 16, 972 at patch 14): Spann3R's encoder over
# UniGeoCam's 25 frames and over its own clips of 20, its decoder per frame;
# Dust3R's encoder over a 20-frame clip and its decoder over the 19 pairs;
# VideoDepthAnything's encoder over 25 frames (972 = 15 x 64 + 12: ragged
# rows and keys); Cut3R's frame tokens reading its 64 state tokens (one key
# tile); Aether's DiT over a 16-frame clip (4 latent frames of 24 x 32
# patches in one sequence)
F32_POINTMAP_SHAPES = [("pointmap_encoder", 25, 768, 768, 12, 64),
                       ("spann3r_encoder", 20, 768, 768, 12, 64),
                       ("pointmap_decoder", 1, 768, 768, 8, 64),
                       ("dust3r_encoder", 20, 768, 768, 16, 64),
                       ("dust3r_decoder", 19, 768, 768, 12, 64),
                       ("vda_encoder", 25, 972, 972, 16, 64),
                       ("cut3r_state_cross", 1, 768, 64, 8, 64),
                       ("aether_dit", 1, 3072, 3072, 12, 64),
                       # the same over 2 ranks of its frames (flow_sample_
                       # context_parallel): each rank's 1536 queries against
                       # the 3072 gathered keys
                       ("aether_dit_sp2", 1, 1536, 3072, 12, 64),
                       # the same over 2 ranks of its heads (the flow
                       # trainer on a tp 2 mesh): 6 of the 12 heads a rank
                       ("aether_dit_tp2", 1, 3072, 3072, 6, 64),
                       # the DepthCrafter trainer's f32 target encode: the
                       # VAE mid block's one head over 25 frames' 48 x 64
                       # latents (the wide register-tiled body)
                       ("depthcrafter_vae_mid", 25, 3072, 3072, 1, 512),
                       # DepthCrafter's f32 forward (the bf16_drift phase's f32
                       # legs): CLIP ViT-H/14's 257 tokens over 16 heads of 80
                       # per frame, on the CUDA-core body
                       ("depthcrafter_clip", 25, 257, 257, 16, 80)]
# the f32 forward's body by head width (kernel names of the packed entry)
F32_BODIES = {64: "flash_packed_f32reg_kernel", 512: "flash_packed_f32w512_kernel",
              80: "flash_packed_kernel<float"}
F32_WIDE_ITERS = 10  # the d 512 row's calls a timing (about 12 ms each)


def phase_kernel_f32_pointmap(dev):
    """The packed kernel's f32 bodies (by kernel name: F32_BODIES, the
    register-tiled bodies at d = 64 and 512, the CUDA-core body at CLIP's
    d = 80) at the f32 paths' shapes
    against the plain version (F32_OUT_TOL), their events and device ms
    (torch.profiler), the plain version's, SDPA's in f32 (TF32 off; events
    and device ms) and the bound.  The earlier CUDA-core body at d = 64 and
    512 is timed beside them by ``python -m
    unigeo_tpu_torch.tools.forward_variants --f32`` (``earlier_d64``,
    ``earlier_d512``), not here: its second build of the kernels does not
    fit the smoke's time."""
    import torch.nn.functional as F

    from unigeo_tpu_torch.device import set_exact_f32
    from unigeo_tpu_torch.ops.attention import (attention_packed_reference, f32_d512_plan,
                                                flash_attention_packed)
    from unigeo_tpu_torch.tools.forward_variants import profile_device_ms, profile_flash

    set_exact_f32()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(16)
    rows = []
    for name, b, sq, sk, h, d in F32_POINTMAP_SHAPES:
        q = torch.randn((b, sq, h * d), generator=gen, device=dev)
        k, v = (torch.randn((b, sk, h * d), generator=gen, device=dev) for _ in range(2))
        out = flash_attention_packed(q, k, v, h)
        err = (out - attention_packed_reference(q, k, v, h)).abs().max().item()
        if not err <= F32_OUT_TOL:
            raise AssertionError(f"{name}: f32 kernel vs plain max abs err {err}")
        split = lambda x: x.view(b, x.shape[1], h, d).transpose(1, 2)
        kern = lambda: flash_attention_packed(q, k, v, h)
        sdpa = lambda: F.scaled_dot_product_attention(split(q), split(k), split(v))
        iters = 20 if d == 64 else F32_WIDE_ITERS
        ms = time_ms(kern, iters)
        body, device_ms = profile_flash(kern, iters)
        if F32_BODIES[d] not in body:
            raise AssertionError(f"{name}: the f32 forward at d = {d} ran {body}")
        plain_ms = time_ms(lambda: attention_packed_reference(q, k, v, h), iters)
        lib_ms, lib_device_ms = time_ms(sdpa, iters), profile_device_ms(sdpa, iters)
        bms, by = f32_bound(b, sq, sk, h, d)
        body_name = lambda key: " + ".join(re.findall(r"flash_\w+<[^>]*>", key))
        # the host plan at d = 512: (items in whole rounds, left over, their split)
        plan = f32_d512_plan(b, sq, sk, h, sms) if d == 512 else None
        rows.append(dict(shape=name, b=b, sq=sq, sk=sk, h=h, d=d, dtype="float32",
                         max_abs_err=err, plan=plan,
                         body=body_name(body), ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, library_device_ms=lib_device_ms, bound_ms=bms,
                         bound_by=by))
        log("kernel", f"f32 {name} [B={b},Sq={sq},Sk={sk},H={h},D={d}] body {rows[-1]['body']} "
            f"{'' if plan is None else f'plan (whole, rest, split) {plan} '}"
            f"max_abs_err={err:.3e} kernel_ms={ms:.4f} device_ms={device_ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} device {lib_device_ms:.4f} "
            f"(SDPA f32) bound_ms={bms:.5f} ({by})")
        del q, k, v, out
    torch.cuda.empty_cache()
    return rows


# the f32 backward pair's shapes (name, B, Sq, Sk, H, D) on the training
# paths of the f32 families at 384 x 512: Aether's DiT, Spann3R's encoder
# and decoder, Dust3R's encoder and decoder (its training clip of
# DUST3R_TRAIN_CLIP frames), VideoDepthAnything's encoder and Cut3R's
# frame-to-state cross-attention (64 keys: one ragged key tile); Aether's
# DiT on a tp 2 mesh (6 of its 12 heads a rank)
F32_BWD_SHAPES = [("aether_dit", 1, 3072, 3072, 12, 64),
                  ("aether_dit_tp2", 1, 3072, 3072, 6, 64),
                  ("spann3r_encoder", 20, 768, 768, 12, 64),
                  ("dust3r_encoder", DUST3R_TRAIN_CLIP, 768, 768, 16, 64),
                  ("dust3r_decoder", DUST3R_TRAIN_CLIP - 1, 768, 768, 12, 64),
                  ("vda_encoder", 25, 972, 972, 16, 64),
                  ("pointmap_decoder", 1, 768, 768, 8, 64),
                  ("cut3r_state_cross", 1, 768, 64, 8, 64)]


def bwd_device_ms(fn, iters, part):
    """(the one backward kernel whose name holds ``part`` that ``iters``
    calls of ``fn`` launched, its mean device ms per launch)."""
    from unigeo_tpu_torch.tools.forward_variants import _profiled_kernels

    found = [e for e in _profiled_kernels(fn, iters) if part in e.key]
    if len(found) != 1:
        raise AssertionError(f"{iters} calls launched {[(e.key, e.count) for e in found]}")
    return found[0].key, found[0].self_device_time_total / 1e3 / found[0].count


def phase_kernel_f32_bwd(dev):
    """The backward pair in f32 (dq, dk/dv: ``bwd_{dq,dkv}_f32reg_kernel``,
    by name, with the cluster split the host plan picked, held to
    ``attention.f32_bwd_split``) at F32_BWD_SHAPES, from the fwd_lse
    kernel's out and lse, held elementwise against the plain version
    (grad_error_limits: in f32 each
    version sums the last product in its own order, n 2^-24 T, plus the
    error F of S and dP carried through), with events and device ms, the
    plain versions' and SDPA's f32 backward (TF32 off; one call computing
    dq, dk and dv) and the bounds: dq 6, dk/dv 8 B H Sq Sk D operations at
    the f32 rate, the pair 14."""
    import torch.nn.functional as F

    from unigeo_tpu_torch.device import set_exact_f32
    from unigeo_tpu_torch.ops.attention import (
        _bwd_plain,
        _delta,
        attention_bwd_reference,
        f32_bwd_split,
        flash_attention_bwd,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_fwd_lse,
        grad_error_limits,
    )
    from unigeo_tpu_torch.tools.forward_variants import profile_device_ms

    set_exact_f32()
    gen = torch.Generator(device=dev).manual_seed(17)
    rows = []
    for name, b, sq, sk, h, d in F32_BWD_SHAPES:
        mk = lambda s_: torch.randn((b, s_, h * d), generator=gen, device=dev)
        q, k, v, dout = mk(sq), mk(sk), mk(sk), mk(sq)
        out, lse = flash_attention_fwd_lse(q, k, v, h)
        grads = flash_attention_bwd(q, k, v, out, lse, dout, h)
        torch.cuda.synchronize()
        refs = attention_bwd_reference(q, k, v, out, lse, dout, h)
        limits = grad_error_limits(q, k, v, out, lse, dout, h, refs)
        errs = [(g - r).abs() for g, r in zip(grads, refs)]
        ratios = [(e / lim).max().item() for e, lim in zip(errs, limits)]
        if not max(ratios) <= 1.0:
            raise AssertionError(f"f32 bwd {name}: max err/limit dq, dk, dv {ratios}")
        del refs, limits
        torch.cuda.empty_cache()
        delta = _delta(out, dout, h)
        scale = d**-0.5
        iters = 10
        dq_fn = lambda: flash_attention_bwd_dq(q, k, v, dout, lse, delta, h)
        dkv_fn = lambda: flash_attention_bwd_dkv(q, k, v, dout, lse, delta, h)
        dq_body, dq_dev = bwd_device_ms(dq_fn, iters, "bwd_dq")
        dkv_body, dkv_dev = bwd_device_ms(dkv_fn, iters, "bwd_dkv")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits = {}
        for part, body in (("dq", dq_body), ("dkv", dkv_body)):
            m = re.search(rf"bwd_{part}_f32reg_kernel<(\d+), (\d+), (\d+)>", body)
            if m is None or int(m.group(3)) != f32_bwd_split(b, sq, sk, h, part == "dkv", sms):
                raise AssertionError(f"f32 bwd {name}: ran {dq_body}, {dkv_body}")
            splits[part] = int(m.group(3))
        split = lambda x, s_: x.view(b, s_, h, d).transpose(1, 2)
        qs, ks, vs = (split(x, s_).detach().requires_grad_()
                      for x, s_ in ((q, sq), (k, sk), (v, sk)))
        sdpa_out = F.scaled_dot_product_attention(qs, ks, vs)
        sdpa_bwd = lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), split(dout, sq),
                                               retain_graph=True)
        bounds = train_bounds(torch.float32, b, sq, sk, h, d)
        row = dict(
            shape=name, b=b, sq=sq, sk=sk, h=h, d=d, dtype="float32",
            dq_body=re.search(r"bwd_\w+<[^>]*>", dq_body).group(0),
            dkv_body=re.search(r"bwd_\w+<[^>]*>", dkv_body).group(0),
            dq_split=splits["dq"], dkv_split=splits["dkv"],
            max_err_over_limit_dq=ratios[0], max_err_over_limit_dkv=max(ratios[1:]),
            max_abs_err_dq=errs[0].max().item(),
            max_abs_err_dkv=max(errs[1].max().item(), errs[2].max().item()),
            dq_ms=time_ms(dq_fn, iters), dkv_ms=time_ms(dkv_fn, iters),
            dq_device_ms=dq_dev, dkv_device_ms=dkv_dev,
            dq_plain_ms=time_ms(lambda: _bwd_plain(q, k, v, dout, lse, delta, h, scale,
                                                   ("dq",)), 3),
            dkv_plain_ms=time_ms(lambda: _bwd_plain(q, k, v, dout, lse, delta, h, scale,
                                                    ("dk", "dv")), 3),
            library_bwd_ms=time_ms(sdpa_bwd, iters),
            library_bwd_device_ms=profile_device_ms(sdpa_bwd, iters),
            dq_bound_ms=bounds["bwd_dq"][0], dkv_bound_ms=bounds["bwd_dkv"][0],
            bound_by=bounds["bwd_dkv"][1])
        row["pair_ms"] = row["dq_ms"] + row["dkv_ms"]
        row["pair_device_ms"] = dq_dev + dkv_dev
        row["pair_bound_ms"] = row["dq_bound_ms"] + row["dkv_bound_ms"]
        rows.append(row)
        log("kernel", f"f32 bwd {name} [B={b},Sq={sq},Sk={sk},H={h},D={d}] {row['dq_body']} / "
            f"{row['dkv_body']}: max_err/limit dq={ratios[0]:.3f} dk={ratios[1]:.3f} "
            f"dv={ratios[2]:.3f} dq_ms={row['dq_ms']:.4f} ({dq_dev:.4f}) dkv_ms="
            f"{row['dkv_ms']:.4f} ({dkv_dev:.4f}) pair {row['pair_ms']:.4f} ({row['pair_device_ms']:.4f}) "
            f"plain dq={row['dq_plain_ms']:.3f} dkv={row['dkv_plain_ms']:.3f} "
            f"SDPA f32 bwd {row['library_bwd_ms']:.4f} ({row['library_bwd_device_ms']:.4f}) "
            f"bound dq={row['dq_bound_ms']:.4f} dkv={row['dkv_bound_ms']:.4f} pair="
            f"{row['pair_bound_ms']:.4f} ({row['bound_by']})")
        del q, k, v, dout, out, lse, grads, errs, delta, sdpa_out, qs, ks, vs
        torch.cuda.empty_cache()
    return rows


# bf16 shapes no wgmma body takes, run on the CUDA-core body read into f32
# (name, B, Sq, Sk, H, D, rows shifted off 16-byte alignment): the tiny
# pointmap configs' head widths 24 and 32 with compute_dtype bf16, 128, and
# the UNet's 64 with rows the TMA cannot take
BF16_CUDA_CORE_FWD = [("pointmap_tiny_d24", 2, 768, 768, 2, 24, False),
                      ("pointmap_tiny_d32", 2, 768, 768, 2, 32, False),
                      ("d128", 2, 768, 768, 4, 128, False),
                      ("d64_misaligned", 2, 768, 768, 4, 64, True)]
# the backward there: the tiny pointmap width 32, CLIP's 80 (a trainer that
# unfreezes CLIP)
BF16_CUDA_CORE_BWD = [("pointmap_tiny_d32", 2, 768, 768, 2, 32),
                      ("clip_d80", 2, 257, 257, 16, 80)]


def misaligned(x):
    """x's values in a contiguous tensor whose base is 2 bytes past a 16-byte
    boundary."""
    y = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape)
    assert y.is_contiguous() and y.data_ptr() % 16 != 0
    return y


def phase_kernel_bf16_cuda_core(dev):
    """The bf16 CUDA-core bodies (flash_*_kernel<__nv_bfloat16, ...> and
    bwd_{dq,dkv}_f32_kernel<__nv_bfloat16, ...>, asserted by kernel name) at
    BF16_CUDA_CORE_FWD / _BWD against their plain versions under their
    derived limits (bf16_cuda_core_error_limit, grad_error_limits with
    cuda_core), with events ms, the plain versions' and SDPA's times and the
    bounds at the bf16 rate.  No default path launches them."""
    from unigeo_tpu_torch.ops import attention as att
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(11)
    rows = {"fwd": [], "bwd_dq": [], "bwd_dkv": []}
    split = lambda x, b, s_, h, d: x.view(b, s_, h, d).transpose(1, 2)
    for name, b, sq, sk, h, d, shifted in BF16_CUDA_CORE_FWD:
        mk = lambda s_: torch.randn((b, s_, h * d), generator=gen, device=dev,
                                    dtype=torch.bfloat16)
        q, k, v = mk(sq), mk(sk), mk(sk)
        if shifted:
            q, k, v = misaligned(q), misaligned(k), misaligned(v)
        if not att.bf16_fwd_on_cuda_core(q, k, v, d):
            raise AssertionError(f"{name}: not a CUDA-core shape")
        out = att.flash_attention_packed(q, k, v, h)
        torch.cuda.synchronize()
        ref = att.attention_packed_reference(q, k, v, h)
        limit = att.bf16_cuda_core_error_limit(q, k, v, h, ref)
        diff = (out.float() - ref.float()).abs()
        err, ratio = diff.max().item(), (diff / limit).max().item()
        if not (np.isfinite(err) and ratio <= 1.0):
            raise AssertionError(f"bf16 cuda-core {name}: max err/limit {ratio} (err {err})")
        body, device_ms = forward_body(lambda: att.flash_attention_packed(q, k, v, h), 5)
        if "<__nv_bfloat16" not in body:
            raise AssertionError(f"bf16 cuda-core {name} ran {body}")
        bms, by = bound(b, sq, h, d)
        row = dict(shape=name, b=b, sq=sq, sk=sk, h=h, d=d, misaligned=shifted, body=body,
                   max_abs_err=err, max_err_over_limit=ratio,
                   ms=time_ms(lambda: att.flash_attention_packed(q, k, v, h), 20),
                   device_ms=device_ms,
                   plain_ms=time_ms(lambda: att.attention_packed_reference(q, k, v, h), 20),
                   library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                       split(q, b, sq, h, d), split(k, b, sk, h, d), split(v, b, sk, h, d)), 20),
                   bound_ms=bms, bound_by=by)
        rows["fwd"].append(row)
        log("kernel", f"bf16 cuda-core fwd {name} [B={b},S={sq},H={h},D={d}"
            f"{',misaligned' if shifted else ''}] body {body} max_err/limit={ratio:.3f} "
            f"ms={row['ms']:.4f} device_ms={device_ms:.4f} plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} bound_ms={bms:.5f} ({by})")
    for name, b, sq, sk, h, d in BF16_CUDA_CORE_BWD:
        mk = lambda s_: torch.randn((b, s_, h * d), generator=gen, device=dev,
                                    dtype=torch.bfloat16)
        q, k, v, dout = mk(sq), mk(sk), mk(sk), mk(sq)
        out, lse = att.attention_fwd_lse_reference(q, k, v, h)
        if not att.bf16_bwd_on_cuda_core(q, k, v, dout, d):
            raise AssertionError(f"{name}: not a CUDA-core shape")
        grads = att.flash_attention_bwd(q, k, v, out, lse, dout, h)
        torch.cuda.synchronize()
        refs = att.attention_bwd_reference(q, k, v, out, lse, dout, h)
        limits = att.grad_error_limits(q, k, v, out, lse, dout, h, refs, cuda_core=True)
        errs = [(g.float() - r.float()).abs() for g, r in zip(grads, refs)]
        ratios = [(e / lim).max().item() for e, lim in zip(errs, limits)]
        if not max(ratios) <= 1.0:
            raise AssertionError(f"bf16 cuda-core bwd {name}: max err/limit {ratios}")
        delta = att._delta(out, dout, h)
        bounds = train_bounds(torch.bfloat16, b, sq, sk, h, d)
        qs, ks, vs = (split(x, b, s_, h, d).detach().requires_grad_()
                      for x, s_ in ((q, sq), (k, sk), (v, sk)))
        sdpa_out = F.scaled_dot_product_attention(qs, ks, vs)
        lib_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs),
                                                     split(dout, b, sq, h, d),
                                                     retain_graph=True), 20)
        for kernel, fn, parts, ratio in (
                ("bwd_dq", lambda: att.flash_attention_bwd_dq(q, k, v, dout, lse, delta, h),
                 ("dq",), ratios[0]),
                ("bwd_dkv", lambda: att.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, h),
                 ("dk", "dv"), max(ratios[1:]))):
            body, device_ms = bwd_device_ms(fn, 5, kernel + "_f32_kernel")
            if "<__nv_bfloat16" not in body:
                raise AssertionError(f"bf16 cuda-core {kernel} {name} ran {body}")
            row = dict(shape=name, b=b, sq=sq, sk=sk, h=h, d=d, body=body,
                       max_abs_err=max(errs[i].max().item() for i in
                                       ((0,) if kernel == "bwd_dq" else (1, 2))),
                       max_err_over_limit=ratio, ms=time_ms(fn, 20), device_ms=device_ms,
                       plain_ms=time_ms(lambda: att._bwd_plain(q, k, v, dout, lse, delta, h,
                                                               d**-0.5, parts), 20),
                       library_ms=lib_ms, library_computes="dq, dk and dv",
                       bound_ms=bounds[kernel][0], bound_by=bounds[kernel][1])
            rows[kernel].append(row)
            log("kernel", f"bf16 cuda-core {kernel} {name} [B={b},Sq={sq},Sk={sk},H={h},D={d}] "
                f"body {body} max_err/limit={ratio:.3f} ms={row['ms']:.4f} "
                f"device_ms={device_ms:.4f} plain_ms={row['plain_ms']:.4f} "
                f"library_bwd_ms={lib_ms:.4f} bound_ms={row['bound_ms']:.5f}")
    torch.cuda.synchronize()
    return rows


# the column-chunked CUDA-core bodies past the forward's d 512 and the
# backward's d 128 (flash_*_wide_kernel<T>, bwd_{dq,dkv}_wide_kernel<T>):
# (name, dtype, B, Sq, Sk, H, D, misaligned).  No default path reaches them;
# the VAE mid block's one head of 512 over two frames' 48 x 64 latents is
# the backward a trainer that unfroze the VAE would run
WIDE_FWD = [("d768", torch.float32, 2, 1024, 1024, 1, 768, False),
            ("d1024", torch.bfloat16, 2, 1024, 1024, 1, 1024, False),
            ("d520_misaligned", torch.bfloat16, 2, 1024, 1024, 2, 520, True)]
WIDE_BWD = [("vae_mid_d512", torch.bfloat16, 2, 3072, 3072, 1, 512),
            ("vae_mid_d512", torch.float32, 2, 3072, 3072, 1, 512),
            ("d256", torch.bfloat16, 2, 1024, 1024, 2, 256),
            ("d520", torch.float32, 2, 1024, 1024, 1, 520)]


def phase_kernel_wide(dev):
    """The column-chunked bodies at WIDE_FWD / WIDE_BWD against their plain
    versions under their derived limits (bf16_cuda_core_error_limit, its
    2 E alone in f32; grad_error_limits with cuda_core), each body checked
    by kernel name, with events ms, profiler device ms, the plain versions'
    and SDPA's times and the bounds (the bf16 rows at the bf16 tensor-core
    rate, the f32 rows at the f32 rate).  No default path launches them."""
    from unigeo_tpu_torch.device import set_exact_f32
    from unigeo_tpu_torch.ops import attention as att
    import torch.nn.functional as F

    set_exact_f32()  # the f32 plain versions in full f32
    gen = torch.Generator(device=dev).manual_seed(12)
    rows = {"fwd": [], "bwd_dq": [], "bwd_dkv": []}
    split = lambda x, b, s_, h, d: x.view(b, s_, h, d).transpose(1, 2)
    tag = lambda dt: "bf16" if dt == torch.bfloat16 else "f32"
    for name, dtype, b, sq, sk, h, d, shifted in WIDE_FWD:
        mk = lambda s_: torch.randn((b, s_, h * d), generator=gen, device=dev, dtype=dtype)
        q, k, v = mk(sq), mk(sk), mk(sk)
        if shifted:
            q, k, v = misaligned(q), misaligned(k), misaligned(v)
        out = att.flash_attention_packed(q, k, v, h)
        torch.cuda.synchronize()
        ref = att.attention_packed_reference(q, k, v, h)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        ratio = (diff / att.bf16_cuda_core_error_limit(q, k, v, h, ref)).max().item()
        if not (np.isfinite(err) and ratio <= 1.0):
            raise AssertionError(f"wide fwd {name} {tag(dtype)}: max err/limit {ratio} (err {err})")
        body, device_ms = forward_body(lambda: att.flash_attention_packed(q, k, v, h), 3)
        if "flash_packed_wide_kernel<" not in body:
            raise AssertionError(f"wide fwd {name} ran {body}")
        # SDPA's kernels refuse rows not aligned to 16 bytes: it reads aligned copies
        qa, ka, va = (x.clone() for x in (q, k, v))
        bms, by = bound(b, sq, h, d) if dtype == torch.bfloat16 else f32_bound(b, sq, sk, h, d)
        row = dict(shape=name, dtype=tag(dtype), b=b, sq=sq, sk=sk, h=h, d=d,
                   misaligned=shifted, body=body, max_abs_err=err, max_err_over_limit=ratio,
                   ms=time_ms(lambda: att.flash_attention_packed(q, k, v, h), 5),
                   device_ms=device_ms,
                   plain_ms=time_ms(lambda: att.attention_packed_reference(q, k, v, h), 5),
                   library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                       split(qa, b, sq, h, d), split(ka, b, sk, h, d),
                       split(va, b, sk, h, d)), 5),
                   bound_ms=bms, bound_by=by)
        rows["fwd"].append(row)
        log("kernel", f"wide fwd {name} {tag(dtype)} [B={b},S={sq},H={h},D={d}] body {body} "
            f"max_err/limit={ratio:.3f} ms={row['ms']:.4f} device_ms={device_ms:.4f} "
            f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
            f"bound_ms={bms:.5f} ({by})")
    for name, dtype, b, sq, sk, h, d in WIDE_BWD:
        mk = lambda s_: torch.randn((b, s_, h * d), generator=gen, device=dev, dtype=dtype)
        q, k, v, dout = mk(sq), mk(sk), mk(sk), mk(sq)
        out, lse = att.attention_fwd_lse_reference(q, k, v, h)
        grads = att.flash_attention_bwd(q, k, v, out, lse, dout, h)
        torch.cuda.synchronize()
        refs = att.attention_bwd_reference(q, k, v, out, lse, dout, h)
        limits = att.grad_error_limits(q, k, v, out, lse, dout, h, refs, cuda_core=True)
        errs = [(g.float() - r.float()).abs() for g, r in zip(grads, refs)]
        ratios = [(e / lim).max().item() for e, lim in zip(errs, limits)]
        err_max = [e.max().item() for e in errs]
        if not max(ratios) <= 1.0:
            raise AssertionError(f"wide bwd {name} {tag(dtype)}: max err/limit {ratios}")
        del grads, refs, limits, errs
        delta = att._delta(out, dout, h)
        bounds = train_bounds(dtype, b, sq, sk, h, d)
        qs, ks, vs = (split(x, b, s_, h, d).detach().requires_grad_()
                      for x, s_ in ((q, sq), (k, sk), (v, sk)))
        sdpa_out = F.scaled_dot_product_attention(qs, ks, vs)
        lib_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs),
                                                     split(dout, b, sq, h, d),
                                                     retain_graph=True), 5)
        for kernel, fn, parts, ratio, err in (
                ("bwd_dq", lambda: att.flash_attention_bwd_dq(q, k, v, dout, lse, delta, h),
                 ("dq",), ratios[0], err_max[0]),
                ("bwd_dkv", lambda: att.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, h),
                 ("dk", "dv"), max(ratios[1:]), max(err_max[1:]))):
            body, device_ms = bwd_device_ms(fn, 3, kernel + "_wide_kernel<")
            row = dict(shape=name, dtype=tag(dtype), b=b, sq=sq, sk=sk, h=h, d=d, body=body,
                       max_abs_err=err, max_err_over_limit=ratio, ms=time_ms(fn, 5),
                       device_ms=device_ms,
                       plain_ms=time_ms(lambda: att._bwd_plain(q, k, v, dout, lse, delta, h,
                                                               d**-0.5, parts), 5),
                       library_ms=lib_ms, library_computes="dq, dk and dv",
                       bound_ms=bounds[kernel][0], bound_by=bounds[kernel][1])
            rows[kernel].append(row)
            log("kernel", f"wide {kernel} {name} {tag(dtype)} [B={b},S={sq},H={h},D={d}] "
                f"body {body} max_err/limit={ratio:.3f} ms={row['ms']:.4f} "
                f"device_ms={device_ms:.4f} plain_ms={row['plain_ms']:.4f} "
                f"library_bwd_ms={lib_ms:.4f} bound_ms={row['bound_ms']:.5f}")
        del qs, ks, vs, sdpa_out
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


# the serving phase: DepthCrafter at SVD-XT width behind the HTTP server,
# two clips coalesced into one batch of clips_per_step = 2.  The pair is
# posted at once, in no fixed order: since the UNet's convolutions run one
# clip at a time (layers.clipwise), a clip's bits no longer depend on its
# slot in the batch, so the 0.5 s stagger that fixed the order is gone
SERVE_WINDOW_MS = 2000.0


def serving_clips(t, h, w):
    """Three distinct clips as a client sends them (serve.py's wire format):
    images [t, 3, h, w] f32 0..255 (the tilted plane, rolled by 0, 37 and 91
    columns) and intrinsics [t, 3, 3], all DepthCrafter reads."""
    base = tilted_plane_clip(t, h, w)
    return [{"images": np.roll(base["images"], shift, axis=3).astype(np.float32),
             "intrinsics": base["intrinsics"]} for shift in (0, 37, 91)]


def post(port, payload, timeout=600):
    """(status, body bytes, seconds) of one POST to /v1/predict."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/predict", data=payload,
                                 method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), time.perf_counter() - t0
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read(), time.perf_counter() - t0


def get_json(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def clip_scores(out, gt):
    """Abs Rel, delta < 1.25 and the normal mean of one prediction against
    a GT label."""
    from unigeo_tpu_torch.metrics.depth import depth_evaluation
    from unigeo_tpu_torch.metrics.normal import normal_evaluation

    dm, *_ = depth_evaluation(out["pred_depths"], gt["gt_depths"],
                              custom_mask=gt["gt_masks"], max_depth=80.0)
    nm = normal_evaluation(out["pred_normals"], gt["gt_normals"], custom_mask=gt["gt_masks"])
    return {"Abs Rel": dm["Abs Rel"], "delta < 1.25": dm["delta < 1.25"],
            "normal mean": nm["normal mean"]}


def phase_serving(dev):
    """DepthCrafter (SVD-XT width, random bf16 weights made on the card,
    clips_per_step 2, 5 steps) behind unigeo_tpu_torch.serving's
    HTTPInferenceServer on 127.0.0.1 in this process (max_batch 2, a
    SERVE_WINDOW_MS window): two distinct 25 x 384 x 512 clips A and B
    POSTed at once coalesce into one batch (/stats), and again in the other
    order; each clip's batched result is bitwise the same with A first or B
    first (the direct forward_batch on [A, B] and on [B, A]), every response
    bitwise the direct batched result of its clip, with the packed kernel's
    launches held to the pair's count; against each clip's own serial
    forward (the products at half the rows choose other sums) the scores
    Abs Rel, delta < 1.25 and normal mean on the clips' one synthetic GT
    (the tilted plane they all show) within EVAL_METRIC_TOL_REL; one
    malformed body gets a 400; one single clip, bitwise equal to forward,
    its launches held to one clip's count.  Under deterministic cuDNN.
    Request latencies, clips/s, peak memory, npz encode / decode seconds
    per request."""
    from unigeo_tpu_torch.data.sample import prepare_gt_label
    from unigeo_tpu_torch.models.depthcrafter.model import DepthCrafter
    from unigeo_tpu_torch.models.depthcrafter.pipeline import DepthCrafterPipeline
    from unigeo_tpu_torch.serving import HTTPInferenceServer, decode_arrays, encode_arrays
    from concurrent.futures import ThreadPoolExecutor

    t, h, w, steps = 25, 384, 512, 5
    unet_cfg, clip_cfg = SVD_XT_UNET, SVD_XT_CLIP
    pipe = DepthCrafterPipeline(unet_config=unet_cfg, clip_config=clip_cfg,
                                dtype=torch.bfloat16, device=dev)
    pipe.init_random(torch.Generator(device=dev).manual_seed(0))
    model = DepthCrafter(pipe, num_inference_steps=steps, seed=42, clips_per_step=2)
    clips = serving_clips(t, h, w)
    t0 = time.perf_counter()
    payloads = [encode_arrays(c) for c in clips]
    encode_s = (time.perf_counter() - t0) / len(clips)
    t0 = time.perf_counter()
    decoded = [decode_arrays(p) for p in payloads]
    decode_s = (time.perf_counter() - t0) / len(clips)
    mb = len(payloads[0]) / 1e6
    per_clip = predicted_launches(unet_cfg, clip_cfg, h, w, steps)
    # a batch runs each UNet evaluation once for both clips; CLIP and the
    # VAE run per clip
    pair_predicted = (steps * unet_kernel_attentions(unet_cfg, h, w)
                      + 2 * (clip_kernel_attentions(clip_cfg) + 2 * vae_mid_attentions(h, w)))

    def post_pair(first, second):
        """Both bodies in flight at once; (responses in that order, wall s)."""
        t_pair = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            futs = [pool.submit(post, srv.port, payloads[i]) for i in (first, second)]
            got = [f.result() for f in futs]
        return got, time.perf_counter() - t_pair

    with deterministic_cudnn():
        with torch.inference_mode():  # warm up once: cuDNN's first use, the allocator
            model.forward_batch(decoded[:2])
            model.forward(decoded[2])
        torch.cuda.synchronize()
        srv = HTTPInferenceServer(model, host="127.0.0.1", port=0, max_batch=2,
                                  batch_window_ms=SERVE_WINDOW_MS, model_name="DepthCrafter")
        srv.start()
        try:
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            pair, pair_s = post_pair(0, 1)
            pair_counts = read_counts()
            peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
            stats = get_json(srv.port, "/stats")
            swapped, swapped_s = post_pair(1, 0)
            swapped_stats = get_json(srv.port, "/stats")
            bad = post(srv.port, b"not an npz")
            reset_counts()
            single = post(srv.port, payloads[2])
            single_counts = read_counts()
            health = get_json(srv.port, "/healthz")
        finally:
            srv.shutdown()
        with torch.inference_mode():  # the direct calls on the same clips, warm
            direct_ab = model.forward_batch(decoded[:2])
            direct_ba = model.forward_batch([decoded[1], decoded[0]])
            serial = [model.forward(decoded[i]) for i in range(3)]
    statuses = [r[0] for r in pair + swapped] + [bad[0], single[0]]
    if statuses != [200, 200, 200, 200, 400, 200]:
        raise AssertionError(f"serving: statuses {statuses} (pair, swapped pair, malformed, "
                             f"single): {[r[1][:200] for r in pair + swapped + [bad, single]]}")
    if stats["served"] != 2 or stats["mean_batch"] != 2.0 or \
            swapped_stats["served"] != 4 or swapped_stats["mean_batch"] != 2.0:
        raise AssertionError(f"serving: a pair did not coalesce into one batch: {stats} "
                             f"{swapped_stats}")
    if health != {"status": "ok", "model": "DepthCrafter"}:
        raise AssertionError(f"serving: /healthz {health}")
    same = lambda a, b: set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in b)
    # each clip's batched bits in either slot
    for label, x, y in (("A", direct_ab[0], direct_ba[1]), ("B", direct_ab[1], direct_ba[0])):
        if not same(x, y):
            raise AssertionError(f"serving: clip {label}'s batched result depends on its slot: "
                                 f"{[(k, float(np.abs(x[k] - y[k]).max())) for k in x]}")
    direct = {0: direct_ab[0], 1: direct_ab[1]}
    for label, got, ref in (("pair A", decode_arrays(pair[0][1]), direct[0]),
                            ("pair B", decode_arrays(pair[1][1]), direct[1]),
                            ("swapped B", decode_arrays(swapped[0][1]), direct[1]),
                            ("swapped A", decode_arrays(swapped[1][1]), direct[0]),
                            ("single", decode_arrays(single[1]), serial[2])):
        if not same(got, ref):
            raise AssertionError(f"serving: {label} differs from the direct call: "
                                 f"{[(k, float(np.abs(got[k] - ref[k]).max())) for k in ref]}")
        check_prediction(f"serving {label}", got, t, h, w)
    if np.array_equal(direct[0]["pred_depths"], direct[1]["pred_depths"]):
        raise AssertionError("serving: the two clips gave the same depths")
    gt = prepare_gt_label(tilted_plane_clip(t, h, w))
    scores = {label: {"batched": clip_scores(direct[i], gt), "serial": clip_scores(serial[i], gt)}
              for i, label in enumerate("AB")}
    shift = {label: {k: abs(v["batched"][k] - v["serial"][k]) / abs(v["serial"][k])
                     for k in v["serial"]} for label, v in scores.items()}
    bits_vs_serial = {label: same(direct[i], serial[i]) for i, label in enumerate("AB")}
    log("serving", f"each clip bitwise the same in either slot of the batch; against its "
        f"serial forward: bitwise {bits_vs_serial}, scores {json.dumps(scores)}, relative "
        f"shift {json.dumps(shift)} (tol {EVAL_METRIC_TOL_REL})")
    if not all(v <= EVAL_METRIC_TOL_REL for s_ in shift.values() for v in s_.values()):
        raise AssertionError(f"serving: batched vs serial scores shift {shift}")
    pair_launches = pair_counts["flash_attention_packed"]
    single_launches = single_counts["flash_attention_packed"]
    if (pair_launches, single_launches) != (pair_predicted, per_clip):
        raise AssertionError(f"serving: packed launches pair {pair_launches}, single "
                             f"{single_launches}; predicted {pair_predicted}, {per_clip}")
    if any(n for name, n in {**pair_counts, **single_counts}.items()
           if name != "flash_attention_packed"):
        raise AssertionError(f"serving launched another kernel: {pair_counts} {single_counts}")
    result = dict(pair_request_s=[r[2] for r in pair], pair_wall_s=pair_s,
                  swapped_pair_request_s=[r[2] for r in swapped], swapped_pair_wall_s=swapped_s,
                  clips_per_s=2 / pair_s, single_request_s=single[2], malformed_status=bad[0],
                  peak_mem_gib=peak_gib, request_mb=mb, npz_encode_s=encode_s,
                  npz_decode_s=decode_s, launches_pair=pair_launches,
                  launches_single=single_launches, stats=swapped_stats,
                  batch_order_bitwise=True, bitwise_vs_serial=bits_vs_serial,
                  scores_batched_vs_serial=scores, score_shift_vs_serial=shift)
    log("serving", f"pair of clips in one batch of 2 (stats {json.dumps(stats)}): request s "
        f"{[round(r[2], 3) for r in pair]} wall {pair_s:.3f} s, {2 / pair_s:.3f} clips/s, "
        f"peak {peak_gib:.2f} GiB, packed launches {pair_launches} (predicted "
        f"{pair_predicted}); the swapped pair wall {swapped_s:.3f} s; every response bitwise "
        f"its clip's direct batched result")
    log("serving", f"single clip {single[2]:.3f} s, launches {single_launches} (predicted "
        f"{per_clip}), bitwise equal to forward; malformed body -> {bad[0]}, then 200; "
        f"npz {mb:.1f} MB a request: encode {encode_s:.3f} s, decode {decode_s:.3f} s")
    return result


# --- parallel/ on ranks of this machine that share the card -------------------------

# the phase's clips: PAR_T frames for dp and pp, PAR_SP_T for sp (25 has no
# divisor but 5 and 25 for 2 ranks; 12, cut from 24 to make room for the
# bf16_drift phase), at 384 x 512, 5 Euler steps
PAR_T, PAR_SP_T, PAR_H, PAR_W, PAR_STEPS, PAR_SEED = 25, 12, 384, 512, 5, 42
PAR_TIMEOUT = 420  # seconds one launch of ranks may take
PAR_RANKS_MODULE = "chip_smoke"  # the module whose rank functions the launches run
# Aether's flow sampler over 2 ranks against its serial run, f32 with TF32
# off, relative to the serial output's largest magnitude: the keys and values
# are the serial run's, the products run at half the rows
PAR_FLOW_TOL = 1e-4
# The training lines: DepthCrafter's DiffusionTrainer at SVD-XT width in
# bf16 on the first PAR_TRAIN_T frames of two clips (two ranks sharing the
# 80 GB card cannot each hold a 25-frame step's 47 GiB), on dp (one clip a
# rank), sp (one clip, PAR_TRAIN_T / 2 frames a rank) and tp (one clip, half
# the sharded weights a rank); Aether's FlowMatchingTrainer in f32 (TF32 off)
# on two 16-frame clips' latents on dp and tp.  Each mesh step starts from
# the weights, batch and draws of the one-process step this process runs
# first, and is held to it: the loss relative, and each named leaf's
# all-reduced gradient by its relative L2.  bf16: each version rounds its
# activations and gradients in other places (per-clip convolutions, the
# row-parallel partial products rounded before their f32 sum, the frames'
# statistics merged), a few of bf16's 2^-8 a layer; f32: the sums' order.
PAR_TRAIN_T = 8
# the tp executor's clip and Euler steps: every row-parallel layer's partial
# output crosses the host under gloo, the VAE's at full resolution (41.4 s a
# rank for 8 frames and 5 steps on the H100, two ranks sharing it)
PAR_TP_T, PAR_TP_STEPS = 2, 2
PAR_TRAIN_MESHES = {"dp": (2, 1, 1), "sp": (1, 2, 1), "tp": (1, 1, 2)}
PAR_TRAIN_LEAVES = (
    "conv_in.weight",
    "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight",
    "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj.weight",
    "down_blocks.1.resnets.0.spatial_res_block.conv1.weight",
    "down_blocks.1.resnets.0.spatial_res_block.conv2.weight",
    "down_blocks.1.resnets.0.temporal_res_block.conv1.weight",
    "conv_out.weight")
AETHER_TRAIN_LEAVES = ("patchify.weight", "stack.blocks.0.attn.to_q.weight",
                       "stack.blocks.0.attn.to_out.0.weight", "stack.blocks.0.mlp.fc1.weight",
                       "stack.blocks.0.mlp.fc2.weight", "final_proj.weight")
# (loss relative, gradient relative L2) a mesh step may differ by
PAR_TRAIN_TOL = {"bf16": (1e-2, 5e-2), "f32": (1e-5, 1e-4)}


def par_tp_clip():
    """The tp executor's clip, the PAR_TP_T-frame tilted plane, and its GT
    label."""
    from unigeo_tpu_torch.data.sample import prepare_gt_label

    clip = tilted_plane_clip(PAR_TP_T, PAR_H, PAR_W)
    return clip, prepare_gt_label(clip)


def par_unet(dev):
    """The training lines' SVD-XT UNet in bf16, weights from seed 0 drawn on
    the card (the same in every process), taking gradients."""
    from unigeo_tpu_torch.models.depthcrafter.pipeline import init_random_
    from unigeo_tpu_torch.models.depthcrafter.unet import UNetSpatioTemporal

    with torch.device("meta"):
        unet = UNetSpatioTemporal(**SVD_XT_UNET)
    unet = unet.to(dtype=torch.bfloat16).to_empty(device=dev)
    init_random_(unet, torch.Generator(device=dev).manual_seed(0))
    return unet.train().requires_grad_(True)


def par_train_batch(pipe):
    """The DiffusionTrainer batch of two PAR_TRAIN_T-frame tilted-plane
    clips (rolled by 0 and 37 columns) at PAR_H x PAR_W, as numpy."""
    from unigeo_tpu_torch.train import build_batch_diffusion

    base = tilted_plane_clip(PAR_TRAIN_T, PAR_H, PAR_W)
    clips = [dict(base, images=np.roll(base["images"], shift, axis=3)) for shift in (0, 37)]
    with torch.inference_mode():
        batch = build_batch_diffusion(clips, pipe)
    return {k: v.cpu().numpy() for k, v in batch.items()}


def aether_train_batch(net, cond):
    """The FlowMatchingTrainer batch: the 16-frame clip's RGB latents twice
    with two target draws (seeded), [2, T', h, w, C], as numpy."""
    gen = torch.Generator(device=cond.device).manual_seed(PAR_SEED + 1)
    c = cond.permute(0, 2, 3, 1)
    target = torch.randn((2, *c.shape[:3], net.target_channels), generator=gen,
                         device=cond.device)
    return {"cond_latents": torch.stack([c, c]).cpu().numpy(),
            "target_latents": target.cpu().numpy()}


def par_train_step(cls, module, batch, leaves, shape=None):
    """One train_step of ``cls`` over ``module`` on ``batch`` (numpy, the
    whole batch), on a mesh of ``shape`` over this world's 2 ranks or on
    this process alone: the loss, the named leaves' gradients (gathered
    over tp; on the first rank), the seconds and launches of the step, the
    peak memory.  The module keeps its updated weights; its gradients and
    the optimizer are dropped."""
    from unigeo_tpu_torch.parallel.mesh import make_mesh
    from unigeo_tpu_torch.parallel.multihost import is_primary
    from unigeo_tpu_torch.parallel.sharding import gather_params

    trainer = cls(module, mesh=None if shape is None else make_mesh(2, shape))
    local = trainer.local_batch({k: torch.from_numpy(v) for k, v in batch.items()})
    dev = trainer.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    loss = float(trainer.train_step(local))
    torch.cuda.synchronize()
    seconds, launches = time.perf_counter() - t0, read_counts()
    named = dict(module.named_parameters())
    grads = gather_params(module, values={k: named[k].grad for k in leaves})
    out = dict(loss=loss, seconds=seconds, launches=launches,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
               grads={k: g.float().cpu() for k, g in grads.items()} if is_primary() else None)
    module.zero_grad(set_to_none=True)
    del trainer
    torch.cuda.empty_cache()
    return out


def par_train_reference(dev, batch):
    """The one-process steps the mesh steps are held to: DepthCrafter on
    both clips (dp's batch) and on the first (sp's and tp's), Aether on both
    clips of its batch; and that batch."""
    from unigeo_tpu_torch.device import exact_f32
    from unigeo_tpu_torch.parallel.trainer import DiffusionTrainer, FlowMatchingTrainer

    one = {k: v[:1] for k, v in batch.items()}
    ref = {"dp": par_train_step(DiffusionTrainer, par_unet(dev), batch, PAR_TRAIN_LEAVES),
           "sp": par_train_step(DiffusionTrainer, par_unet(dev), one, PAR_TRAIN_LEAVES)}
    ref["tp"] = ref["sp"]
    torch.cuda.empty_cache()
    with exact_f32():
        net, cond, _, _ = aether_par_net(dev)
        aether_batch = aether_train_batch(net, cond)
        dit = net.dit.train().requires_grad_(True)
        ref["aether_dp"] = ref["aether_tp"] = par_train_step(
            FlowMatchingTrainer, dit, aether_batch, AETHER_TRAIN_LEAVES)
    del net, dit, cond
    torch.cuda.empty_cache()
    return ref, aether_batch


def par_train_ranks(dev, job, net):
    """The training lines in a rank of the 2-rank launch: DepthCrafter on
    dp, sp and tp (the UNet drawn anew from its seed before each), then
    Aether's DiT (``net``'s, reloaded before each) on dp and tp under exact
    f32."""
    from unigeo_tpu_torch.device import exact_f32
    from unigeo_tpu_torch.models.depthcrafter.pipeline import init_random_
    from unigeo_tpu_torch.parallel.trainer import DiffusionTrainer, FlowMatchingTrainer

    out, batch = {}, job["train_batch"]
    unet = par_unet(dev)
    for label, shape in PAR_TRAIN_MESHES.items():
        if label != "dp":
            init_random_(unet, torch.Generator(device=dev).manual_seed(0))
        b = batch if label == "dp" else {k: v[:1] for k, v in batch.items()}
        out[label] = par_train_step(DiffusionTrainer, unet, b, PAR_TRAIN_LEAVES, shape)
    del unet
    torch.cuda.empty_cache()
    with exact_f32():
        dit = net.dit.train().requires_grad_(True)
        start = {k: v.clone() for k, v in dit.state_dict().items()}
        for label in ("dp", "tp"):
            if label == "tp":
                dit.load_state_dict(start)
            out[f"aether_{label}"] = par_train_step(FlowMatchingTrainer, dit, job["aether_batch"],
                                                    AETHER_TRAIN_LEAVES, PAR_TRAIN_MESHES[label])
    return out


def rel_l2(a, ref):
    return float((a - ref).norm() / ref.norm().clamp_min(1e-30))


def par_pipeline(dev):
    """The smoke's DepthCrafter pipeline: SVD-XT width, bf16, weights from seed 0."""
    from unigeo_tpu_torch.models.depthcrafter.pipeline import DepthCrafterPipeline

    pipe = DepthCrafterPipeline(unet_config=SVD_XT_UNET, clip_config=SVD_XT_CLIP,
                                dtype=torch.bfloat16, device=dev)
    return pipe.init_random(torch.Generator(device=dev).manual_seed(0))


def par_clips():
    """Two distinct PAR_T-frame clips (the serving phase's A and B) and the
    GT label they share, and the PAR_SP_T-frame tilted plane with its GT."""
    from unigeo_tpu_torch.data.sample import prepare_gt_label

    clips = serving_clips(PAR_T, PAR_H, PAR_W)[:2]
    sp_clip = tilted_plane_clip(PAR_SP_T, PAR_H, PAR_W)
    return (clips, prepare_gt_label(tilted_plane_clip(PAR_T, PAR_H, PAR_W)), sp_clip,
            prepare_gt_label(sp_clip))


def digest(out):
    """sha256 of a prediction's depths and normals: bitwise across processes."""
    import hashlib

    h = hashlib.sha256()
    for k in ("pred_depths", "pred_normals"):
        h.update(np.ascontiguousarray(out[k]).tobytes())
    return h.hexdigest()


def par_summary(out, gt):
    return {"digest": digest(out), "scores": clip_scores(out, gt)}


def sp_latents(model, data, denoise):
    """One clip's encode as run_window_staged runs it (the draws of
    DepthCrafter.forward from the model's seed), then ``denoise(cond,
    context, noise)`` -> the denoised latents [T, 4, h, w] f32."""
    pipe = model.pipeline
    images = np.asarray(data["images"])
    t, h, w = images.shape[0], images.shape[2], images.shape[3]
    frames = pipe.prepare_clip(images)
    gen = torch.Generator(device=pipe.device).manual_seed(model.seed)
    noise, aug = pipe.draw_clip_noise(gen, t, h, w)
    nchw = lambda a: a.permute(0, 3, 1, 2).contiguous()
    cond, ctx = pipe._encode_stage(nchw(frames), nchw(aug))
    return denoise(cond, ctx, noise.contiguous().permute(0, 3, 1, 2))


def sp_finish(model, data, x, gt):
    """Denoised latents -> the clip's scores (decode, post-processing)."""
    decoded = (model.pipeline._decode_stage(x).permute(0, 2, 3, 1) + 1.0) / 2.0
    return clip_scores(model._finalize(decoded, data), gt)


def aether_par_net(dev):
    """aether_scannetpp.yaml's network in f32 with random weights from seed 0
    (not adaLN-zero, so the DiT's velocity is not 0), and the 16-frame
    tilted plane's RGB latents with one noise draw."""
    from unigeo_tpu_torch.models.aether import AetherNetwork
    from unigeo_tpu_torch.models.pointmap.adapter import build_network

    conf = read_config("aether_scannetpp.yaml")["model_params"]
    net = build_network(AetherNetwork, {k: conf[k] for k in ("vae_config", "network_config")},
                        dev, 0).eval().requires_grad_(False)
    raw = torch.from_numpy(tilted_plane_clip(AETHER_CLIP, PAR_H, PAR_W)["images"]).to(dev)
    cond = net.encode(raw.float() / 255.0 * 2.0 - 1.0)
    gen = torch.Generator(device=dev).manual_seed(PAR_SEED)
    noise = torch.randn((cond.shape[0], net.target_channels, *cond.shape[2:]), generator=gen,
                        device=dev)
    return net, cond, noise, conf["num_steps"]


def parallel_ranks(job):
    """The 2-rank launch: dp, sp (DepthCrafter's denoise, Aether's flow
    sampler), tp (the dp executor on a (1, 1, 2) mesh), the training lines
    (``par_train_ranks``) and the eval CLI; each part's seconds and flash
    launches."""
    import torch.distributed as dist

    from unigeo_tpu_torch.device import exact_f32
    from unigeo_tpu_torch.models.depthcrafter.model import DepthCrafter
    from unigeo_tpu_torch.parallel.comm import backend_of
    from unigeo_tpu_torch.parallel.context import (denoise_context_parallel,
                                                   flow_sample_context_parallel)
    from unigeo_tpu_torch.parallel.executor import ShardedClipExecutor
    from unigeo_tpu_torch.parallel.mesh import make_mesh
    from unigeo_tpu_torch.parallel.multihost import rank_device

    dev = rank_device(job["device"])
    rank = dist.get_rank()
    torch.backends.cudnn.deterministic = True
    out = {"rank": rank, "backend": backend_of(), "device": str(dev),
           "started_s": time.time() - job["t_launch"]}
    clips, gt, sp_clip, sp_gt = par_clips()
    with torch.inference_mode():
        dp_mesh = make_mesh(2, (2, 1, 1))
        model = DepthCrafter(par_pipeline(dev), num_inference_steps=PAR_STEPS, seed=PAR_SEED,
                             mesh=dp_mesh)
        torch.cuda.synchronize()
        out["ready_s"] = time.time() - job["t_launch"]
        reset_counts()
        t0 = time.perf_counter()
        preds = model.forward_batch(clips)
        torch.cuda.synchronize()
        out["dp"] = dict(seconds=time.perf_counter() - t0, launches=read_counts(),
                         batch_size=model.eval_batch_size,
                         clips=[par_summary(p, gt) for p in preds])
        del preds

        sp_mesh = make_mesh(2, (1, 2, 1))
        reset_counts()
        t0 = time.perf_counter()
        x = sp_latents(model, sp_clip, lambda c, ctx, n: denoise_context_parallel(
            model.pipeline, c, ctx, n, PAR_STEPS, sp_mesh))
        scores = sp_finish(model, sp_clip, x, sp_gt) if rank == 0 else None
        torch.cuda.synchronize()
        out["sp"] = dict(seconds=time.perf_counter() - t0, launches=read_counts(),
                         latents=x.cpu(), scores=scores)
        del x

        # tp: the PAR_TP_T-frame tilted plane, PAR_TP_STEPS steps, on a (1, 1, 2) mesh, the
        # pipeline's modules placed on tp in place (its last use here)
        tp_clip, tp_gt = par_tp_clip()
        tp_mesh = make_mesh(2, (1, 1, 2))
        t0 = time.perf_counter()
        ex = ShardedClipExecutor(model.pipeline, tp_mesh, num_inference_steps=PAR_TP_STEPS)
        frames = model.pipeline.prepare_clip(tp_clip["images"])[None]
        torch.cuda.synchronize()
        reset_counts()
        t1 = time.perf_counter()
        decoded = ex(frames, seed=PAR_SEED)
        torch.cuda.synchronize()
        out["tp_executor"] = dict(seconds=time.perf_counter() - t1, launches=read_counts(),
                                  place_s=t1 - t0,
                                  clip=par_summary(model._finalize(decoded[0], tp_clip), tp_gt)
                                  if rank == 0 else None)
        del model, ex, frames, decoded
        torch.cuda.empty_cache()

    with exact_f32():
        net, cond, noise, steps = aether_par_net(dev)
        with torch.inference_mode():
            reset_counts()
            t0 = time.perf_counter()
            flow = flow_sample_context_parallel(net, cond, noise, steps, sp_mesh)
            torch.cuda.synchronize()
            out["flow"] = dict(seconds=time.perf_counter() - t0, launches=read_counts(),
                               tokens=[int(cond.shape[0] // 2 * cond.shape[2] * cond.shape[3] // 4),
                                       int(cond.shape[0] * cond.shape[2] * cond.shape[3] // 4)])
            if rank == 0:
                serial = net.sample(cond, noise, steps)
                out["flow"]["rel_dev"] = float((flow - serial).abs().max()
                                               / serial.abs().max())
            del cond, noise, flow
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["train"] = par_train_ranks(dev, job, net)
    out["train_s"] = time.perf_counter() - t0
    del net
    torch.cuda.empty_cache()

    reset_counts()
    t0 = time.perf_counter()
    text, _ = run_cli(["--config", job["identity_config"], "--output", job["eval_dir"],
                       "--device", job["device"]])
    out["eval"] = dict(seconds=time.perf_counter() - t0, launches=read_counts(),
                       first_line=text.splitlines()[1] if len(text.splitlines()) > 1 else text,
                       processed=text.count("processing seq"))
    dist.barrier()
    out["done_s"] = time.time() - job["t_launch"]
    return out


def pp_ranks(job):
    """The 3-rank launch: PipelinedStageExecutor on the two clips (encode on
    rank 0, decode on rank 1, the denoise on rank 2)."""
    import torch.distributed as dist

    from unigeo_tpu_torch.models.depthcrafter.model import DepthCrafter
    from unigeo_tpu_torch.parallel.comm import backend_of
    from unigeo_tpu_torch.parallel.multihost import rank_device
    from unigeo_tpu_torch.parallel.staged import PipelinedStageExecutor

    dev = rank_device(job["device"])
    rank = dist.get_rank()
    torch.backends.cudnn.deterministic = True
    started = time.time() - job["t_launch"]
    clips, gt, _, _ = par_clips()
    with torch.inference_mode():
        model = DepthCrafter(par_pipeline(dev), num_inference_steps=PAR_STEPS, seed=PAR_SEED)
        ex = PipelinedStageExecutor(model.pipeline, num_frames=PAR_T,
                                    num_inference_steps=PAR_STEPS)
        frames = torch.stack([model.pipeline.prepare_clip(c["images"]) for c in clips])
        reset_counts()
        t0 = time.perf_counter()
        decoded = ex(frames, seed=PAR_SEED)
        torch.cuda.synchronize()
        seconds, launches = time.perf_counter() - t0, read_counts()
        summaries = None
        if rank == 1:  # the decode rank kept the VAE, which _finalize does not need
            summaries = [par_summary(model._finalize(decoded[i], c), gt)
                         for i, c in enumerate(clips)]
    return {"rank": rank, "backend": backend_of(), "seconds": seconds, "launches": launches,
            "denoise_ranks": ex.denoise_ranks, "clips": summaries, "started_s": started,
            "done_s": time.time() - job["t_launch"]}


def scores_rel(ours, ref):
    return {k: abs(ours[k] - ref[k]) / max(abs(ref[k]), 1e-12) for k in EVAL_KEYS}


def phase_parallel(dev):
    """See the module docstring ("parallel").  The references (each clip's
    serial forward, the unsplit denoise of the PAR_SP_T frames, one process's eval
    CLI) are run here first, then the ranks (run_ranks) with this process's
    cache of the card emptied."""
    from unigeo_tpu_torch.models.depthcrafter.model import DepthCrafter
    from unigeo_tpu_torch.parallel.launch import run_ranks

    # the packed kernel's launches a clip by stage: CLIP and the encoder's mid
    # block, the UNet's evaluations, the decoder's mid block
    enc = clip_kernel_attentions(SVD_XT_CLIP) + vae_mid_attentions(PAR_H, PAR_W)
    den = PAR_STEPS * unet_kernel_attentions(SVD_XT_UNET, PAR_H, PAR_W)
    dec = vae_mid_attentions(PAR_H, PAR_W)
    clips, gt, sp_clip, sp_gt = par_clips()
    t0 = time.perf_counter()
    with deterministic_cudnn(), torch.inference_mode():
        model = DepthCrafter(par_pipeline(dev), num_inference_steps=PAR_STEPS, seed=PAR_SEED)
        serial = [par_summary(model.forward(c), gt) for c in clips]
        tp_clip, tp_gt = par_tp_clip()
        tp_serial = par_summary(DepthCrafter(model.pipeline, num_inference_steps=PAR_TP_STEPS,
                                             seed=PAR_SEED).forward(tp_clip), tp_gt)
        x_ref = sp_latents(model, sp_clip, lambda c, ctx, n: model.pipeline._denoise_loop(
            c[None], ctx[None], n[None], PAR_STEPS)[0])
        sp_ref = sp_finish(model, sp_clip, x_ref, sp_gt)
        x_ref = x_ref.cpu()
        train_batch = par_train_batch(model.pipeline)
        del model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with deterministic_cudnn():
        train_ref, aether_batch = par_train_reference(dev, train_batch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="unigeo_parallel_")
    try:
        cfg_path = os.path.join(work, "identity.json")
        with open(cfg_path, "w") as f:
            json.dump(identity_config(), f)
        single_dir, multi_dir = os.path.join(work, "single"), os.path.join(work, "multi")
        run_cli(["--config", cfg_path, "--output", single_dir, "--device", dev.type])
        log("parallel", f"references (two serial forwards, the unsplit {PAR_SP_T}-frame clip, the "
            f"one-process training steps, the identity CLI) in {time.perf_counter() - t0:.2f}s")
        job = {"identity_config": cfg_path, "eval_dir": multi_dir, "device": dev.type,
               "train_batch": train_batch, "aether_batch": aether_batch,
               "t_launch": time.time()}
        t0 = time.perf_counter()
        two = run_ranks(f"{PAR_RANKS_MODULE}:parallel_ranks", 2, job, os.path.join(work, "ranks2"),
                        device=dev.type, timeout=PAR_TIMEOUT)
        two_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        three = run_ranks(f"{PAR_RANKS_MODULE}:pp_ranks", 3,
                          {"device": dev.type, "t_launch": time.time()},
                          os.path.join(work, "ranks3"), device=dev.type, timeout=PAR_TIMEOUT)
        three_s = time.perf_counter() - t0
        single_rows = read_csv_rows(os.path.join(single_dir, "metrics.csv"))
        merged_rows = read_csv_rows(os.path.join(multi_dir, "metrics.csv"))
        rank_files = sorted(f for f in os.listdir(multi_dir) if f.startswith("metrics"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    note = "ranks time-share one card: no speed-up is claimed or measurable"
    res, failed = {"launch_s": {"two_ranks": two_s, "three_ranks": three_s}}, []
    flash = lambda r, part: r[part]["launches"]["flash_attention_packed"]

    # dp
    dp_ok = [r["dp"]["clips"][i]["digest"] == serial[i]["digest"] for r in two for i in range(2)]
    dp_launches = [flash(r, "dp") for r in two]
    res["dp"] = dict(backend=two[0]["backend"], seconds=[r["dp"]["seconds"] for r in two],
                     flash_launches=dp_launches, predicted=enc + den + dec,
                     bitwise_serial=dp_ok, batch_size=two[0]["dp"]["batch_size"])
    log("parallel", f"dp 2 ranks ({two[0]['backend']}, {note}): 2 clips of {PAR_T}x{PAR_H}x"
        f"{PAR_W}, {PAR_STEPS} steps: seconds per rank "
        f"{[round(s, 3) for s in res['dp']['seconds']]} (the first forward_batch, set-up "
        f"included), flash launches per rank {dp_launches} (predicted {enc + den + dec}); each "
        f"clip bitwise its serial forward on every rank: {dp_ok}")
    if not (all(dp_ok) and dp_launches == [enc + den + dec] * 2):
        failed.append("dp")

    # sp, DepthCrafter
    x_sp = two[0]["sp"]["latents"]
    lat_rel = float((x_sp - x_ref).abs().max() / x_ref.abs().max())
    sp_rel = scores_rel(two[0]["sp"]["scores"], sp_ref)
    sp_launches = [flash(r, "sp") for r in two]
    sp_pred = [enc + den + dec, enc + den]
    res["sp"] = dict(backend=two[0]["backend"], seconds=[r["sp"]["seconds"] for r in two],
                     flash_launches=sp_launches, predicted=sp_pred, frames=PAR_SP_T,
                     latents_max_rel_dev=lat_rel, scores=two[0]["sp"]["scores"],
                     unsplit_scores=sp_ref, scores_rel_dev=sp_rel,
                     same_on_both=bool(torch.equal(x_sp, two[1]["sp"]["latents"])))
    log("parallel", f"sp 2 ranks ({two[0]['backend']}, {note}): DepthCrafter's denoise over "
        f"{PAR_SP_T} frames (cut from {PAR_T}: 25 has no divisor but 5 and 25 for 2 ranks), "
        f"{PAR_SP_T // 2} a rank: "
        f"seconds per rank (encode, denoise, rank 0 decodes) "
        f"{[round(s, 3) for s in res['sp']['seconds']]}, flash launches per rank "
        f"{sp_launches} (predicted {sp_pred}); latents max relative difference to the unsplit "
        f"denoise {lat_rel:.3e}; scores {json.dumps(two[0]['sp']['scores'])} against the "
        f"unsplit {json.dumps(sp_ref)}, relative {json.dumps(sp_rel)} (tol "
        f"{EVAL_METRIC_TOL_REL}); both ranks' latents equal {res['sp']['same_on_both']}")
    if not (all(v <= EVAL_METRIC_TOL_REL for v in sp_rel.values()) and sp_launches == sp_pred
            and res["sp"]["same_on_both"]):
        failed.append("sp")

    # sp, Aether
    flow_launches = [flash(r, "flow") for r in two]
    flow_pred = AETHER_LAUNCHES
    res["flow"] = dict(backend=two[0]["backend"], seconds=[r["flow"]["seconds"] for r in two],
                       flash_launches=flow_launches, predicted=flow_pred,
                       queries_keys=two[0]["flow"]["tokens"],
                       rel_dev=two[0]["flow"]["rel_dev"], tol=PAR_FLOW_TOL)
    log("parallel", f"sp 2 ranks ({two[0]['backend']}, {note}): Aether's flow sampler "
        f"(aether_scannetpp.yaml's network, random weights, f32, TF32 off) on the "
        f"{AETHER_CLIP}-frame clip, queries / keys per rank {two[0]['flow']['tokens']}: "
        f"seconds per rank {[round(s, 3) for s in res['flow']['seconds']]}, flash launches per "
        f"rank {flow_launches} (predicted {flow_pred}); against the serial sample max relative "
        f"difference {res['flow']['rel_dev']:.3e} (tol {PAR_FLOW_TOL})")
    if not (res["flow"]["rel_dev"] <= PAR_FLOW_TOL and flow_launches == [flow_pred] * 2):
        failed.append("flow")

    # tp: the dp executor on a (1, 1, 2) mesh
    tp_rel = scores_rel(two[0]["tp_executor"]["clip"]["scores"], tp_serial["scores"])
    tp_launches = [flash(r, "tp_executor") for r in two]
    tp_pred = enc + PAR_TP_STEPS * unet_kernel_attentions(SVD_XT_UNET, PAR_H, PAR_W) + dec
    res["tp_executor"] = dict(backend=two[0]["backend"],
                              seconds=[r["tp_executor"]["seconds"] for r in two],
                              place_s=[r["tp_executor"]["place_s"] for r in two],
                              flash_launches=tp_launches, predicted=tp_pred,
                              scores=two[0]["tp_executor"]["clip"]["scores"],
                              serial_scores=tp_serial["scores"], scores_rel_dev=tp_rel)
    log("parallel", f"tp 2 ranks ({two[0]['backend']}, {note}): ShardedClipExecutor on a "
        f"(1, 1, 2) mesh, the {PAR_TP_T}-frame tilted plane, {PAR_TP_STEPS} steps, UNet, VAE and CLIP placed on tp "
        f"(parallelize, {[round(r['tp_executor']['place_s'], 3) for r in two]} s): seconds per "
        f"rank {[round(r['tp_executor']['seconds'], 3) for r in two]}, flash launches per rank "
        f"{tp_launches} (predicted {tp_pred}); scores "
        f"{json.dumps(res['tp_executor']['scores'])} against its serial forward's "
        f"{json.dumps(tp_serial['scores'])}, relative {json.dumps(tp_rel)} (tol "
        f"{EVAL_METRIC_TOL_REL})")
    if not (all(v <= EVAL_METRIC_TOL_REL for v in tp_rel.values())
            and tp_launches == [tp_pred] * 2):
        failed.append("tp_executor")

    # training: one step on each mesh against the one-process step
    aether_steps = read_config("aether_scannetpp.yaml")["model_params"]["num_steps"]
    lse = unet_kernel_attentions(SVD_XT_UNET, PAR_H, PAR_W)
    per_clip_dit = AETHER_LAUNCHES // aether_steps
    res["train"] = {"rank_seconds": [r["train_s"] for r in two]}
    for label in ("dp", "sp", "tp", "aether_dp", "aether_tp"):
        aether = label.startswith("aether")
        ref, runs = train_ref[label], [r["train"][label] for r in two]
        loss_tol, grad_tol = PAR_TRAIN_TOL["f32" if aether else "bf16"]
        loss_rel = abs(runs[0]["loss"] - ref["loss"]) / abs(ref["loss"])
        grad_rel = {k: rel_l2(runs[0]["grads"][k], g) for k, g in ref["grads"].items()}
        # fwd_lse, dq, dk/dv a rank: one per spatial attention of a UNet
        # evaluation (the rank's frames in one launch); the DiT's per clip
        clips = 1 if label == "aether_dp" else 2
        pred = per_clip_dit * clips if aether else lse
        counts = [[r["launches"][k] for k in ("flash_attention_fwd_lse", "flash_attention_bwd_dq",
                                             "flash_attention_bwd_dkv")] for r in runs]
        others = [sum(n for k, n in r["launches"].items() if k not in (
            "flash_attention_fwd_lse", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"))
            for r in runs]
        shape = PAR_TRAIN_MESHES[label.replace("aether_", "")]
        res["train"][label] = dict(
            mesh=shape, backend=two[0]["backend"], seconds=[r["seconds"] for r in runs],
            one_process_seconds=ref["seconds"], peak_gib=[r["peak_gib"] for r in runs],
            one_process_peak_gib=ref["peak_gib"], loss=runs[0]["loss"],
            losses_equal=len({r["loss"] for r in runs}) == 1, one_process_loss=ref["loss"],
            loss_rel=loss_rel, grad_rel_l2=grad_rel, tol=[loss_tol, grad_tol],
            fwd_lse_dq_dkv=counts, predicted=pred, other_launches=others)
        what = (f"Aether's FlowMatchingTrainer (f32, TF32 off; {clips} of the 2 "
                f"{AETHER_CLIP}-frame clips a rank)" if aether else
                f"DepthCrafter's DiffusionTrainer (SVD-XT, bf16, {PAR_H}x{PAR_W}, "
                f"{2 if label == 'dp' else 1} clip(s) of {PAR_TRAIN_T} frames)")
        log("parallel", f"train {label.replace('aether_', '')} on {shape} ({two[0]['backend']}, "
            f"{note}): {what}: step seconds per rank "
            f"{[round(r['seconds'], 3) for r in runs]} (one process {ref['seconds']:.3f}), peak "
            f"GiB per rank {[round(r['peak_gib'], 2) for r in runs]} (one process "
            f"{ref['peak_gib']:.2f}), fwd_lse / dq / dk,dv launches per rank {counts} "
            f"(predicted {pred} each); loss {runs[0]['loss']:.6f} against the one-process "
            f"{ref['loss']:.6f}: relative {loss_rel:.3e} (tol {loss_tol}); the all-reduced "
            f"gradients' relative L2 {json.dumps({k: float(f'{v:.3e}') for k, v in grad_rel.items()})} "
            f"(tol {grad_tol})")
        if not (loss_rel <= loss_tol and all(v <= grad_tol for v in grad_rel.values())
                and res["train"][label]["losses_equal"] and counts == [[pred] * 3] * 2
                and others == [0, 0]):
            failed.append(f"train_{label}")

    # pp
    dec_rank = three[1]
    pp_bitwise = [dec_rank["clips"][i]["digest"] == serial[i]["digest"] for i in range(2)]
    pp_rel = [scores_rel(dec_rank["clips"][i]["scores"], serial[i]["scores"]) for i in range(2)]
    pp_launches = [r["launches"]["flash_attention_packed"] for r in three]
    pp_pred = [2 * enc, 2 * dec, 2 * den]
    res["pp"] = dict(backend=three[0]["backend"], seconds=[r["seconds"] for r in three],
                     flash_launches=pp_launches, predicted=pp_pred,
                     denoise_ranks=three[0]["denoise_ranks"], bitwise_serial=pp_bitwise,
                     scores_rel_dev=pp_rel)
    log("parallel", f"pp 3 ranks ({three[0]['backend']}, {note}): encode on rank 0, decode on "
        f"rank 1, denoise on ranks {three[0]['denoise_ranks']}, the 2 clips in flight: seconds "
        f"per rank {[round(r['seconds'], 3) for r in three]}, flash launches per rank "
        f"{pp_launches} (predicted {pp_pred}); each clip against its serial forward: bitwise "
        f"{pp_bitwise}, scores relative {json.dumps(pp_rel)} (tol {EVAL_METRIC_TOL_REL})")
    if not (all(v <= EVAL_METRIC_TOL_REL for r in pp_rel for v in r.values())
            and pp_launches == pp_pred):
        failed.append("pp")

    # the eval CLI
    same_csv = merged_rows == single_rows
    res["eval"] = dict(backend=two[0]["backend"], seconds=[r["eval"]["seconds"] for r in two],
                       processed=[r["eval"]["processed"] for r in two], files=rank_files,
                       merged_equals_single=same_csv)
    log("parallel", f"eval CLI 2 ranks ({two[0]['backend']}, {note}): the identity config "
        f"({len(single_rows) - 1} clips), clips scored per rank {res['eval']['processed']}, "
        f"seconds per rank {[round(r['eval']['seconds'], 3) for r in two]}, files {rank_files}; "
        f"'{two[0]['eval']['first_line']}'; the merged metrics.csv equal to one process's: "
        f"{same_csv}")
    if not (same_csv and sorted(res["eval"]["processed"]) == [3, 3]
            and rank_files == ["metrics.csv", "metrics.rank0.csv", "metrics.rank1.csv"]):
        failed.append("eval")
    res["rank_clock_s"] = {"two_ranks": [{k: round(r[k], 2) for k in ("started_s", "ready_s",
                                                                        "done_s")} for r in two],
                           "three_ranks": [{k: round(r[k], 2) for k in ("started_s", "done_s")}
                                           for r in three]}
    log("parallel", f"launches of ranks: 2 ranks {two_s:.2f}s, 3 ranks {three_s:.2f}s; each "
        f"rank's seconds since its launch when it started, had its models, ended: "
        f"{json.dumps(res['rank_clock_s'])}")
    if failed:
        raise AssertionError(f"parallel: {failed} failed: {json.dumps(res, default=str)}")
    return res


def phase_debug_nans(dev):
    """run_evaluation with debug_nans on a tiny f32 DepthCrafter on the card
    whose VAE encoder's first convolution holds one NaN weight: it must
    raise FloatingPointError naming that module's class, and leave no hook."""
    from unigeo_tpu_torch.config import EvalConfig
    from unigeo_tpu_torch.evaluator import run_evaluation
    from unigeo_tpu_torch.models.depthcrafter.model import DepthCrafter
    from unigeo_tpu_torch.models.depthcrafter.pipeline import tiny_pipeline

    pipe = tiny_pipeline(device=dev).init_random(torch.Generator(device=dev).manual_seed(5))
    with torch.no_grad():
        pipe.vae.encoder.conv_in.weight[0, 0, 0, 0] = float("nan")
    cfg = EvalConfig.from_dict({
        "dataset": "SyntheticBoxDataset", "root": None, "h": 64, "w": 64, "clip_length": 2,
        "clip_overlap": 0, "split": "test",
        "dataset_params": {"render_size": [64, 64], "num_scenes": 1, "frames_per_scene": 2},
        "model_name": "DepthCrafter", "model_params": {},
        "eval_depth": {"metric_names": ["Abs Rel"], "depth_alignment": "lstsq"}})
    hooks = dict(torch.nn.modules.module._global_forward_hooks)
    with tempfile.TemporaryDirectory() as out:
        try:
            run_evaluation(cfg, save_dir=out, model=DepthCrafter(pipe, num_inference_steps=2),
                           verbose=False, debug_nans=True, device=dev)
        except FloatingPointError as exc:
            message = str(exc)
        else:
            raise AssertionError("debug_nans: the planted NaN weight did not raise")
    if "Conv" not in message or dict(torch.nn.modules.module._global_forward_hooks) != hooks:
        raise AssertionError(f"debug_nans: raised {message!r}, hooks left")
    log("debug_nans", f"planted NaN weight raised FloatingPointError: {message}")


# the rasterizer's synthetic scenes: a noisy heightfield of nx x ny vertices
# (2 (nx - 1) (ny - 1) faces) seen at 768 x 1024, as ScanNet++'s iPhone
# frames are rendered; the large one about 1.5 M faces (a laser mesh at
# 5 cm holds a few million), the small one about 20 k for the CPU run
RASTER_HW = (768, 1024)
RASTER_LARGE, RASTER_SMALL = (1000, 750), (115, 90)
EDGE_SHARE = 2e-3  # hit-mask and winning-face differences, of the hit pixels


def heightfield_mesh(nx, ny, seed):
    """float32 vertices and int64 faces of a noisy heightfield (every inner
    edge shared by two faces) filling a 768 x 1024 view at z ~ 3 m."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.linspace(-2.2, 2.2, nx), np.linspace(-1.7, 1.7, ny))
    zs = 3.0 + 0.3 * np.sin(xs * 3) * np.cos(ys * 2) + 0.01 * rng.normal(size=xs.shape)
    verts = np.stack([xs, ys, zs], -1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(nx * ny).reshape(ny, nx)
    a, b, c, d = idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1], idx[1:, 1:]
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([b, d, c], -1).reshape(-1, 3)]).astype(np.int64)
    return verts, faces


def raster_camera():
    """An OpenCV world-to-camera pose (float64, slightly turned) and K at
    RASTER_HW."""
    h, w = RASTER_HW
    ang = 0.03
    w2c = np.eye(4)
    w2c[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]]
    w2c[:3, 3] = [0.05, -0.02, 0.1]
    k = np.array([[900.0, 0, (w - 1) / 2], [0, 900.0, (h - 1) / 2], [0, 0, 1]], np.float32)
    return w2c, k


def hold_render(label, card, cpu):
    """The card's render against the CPU's: depth within 1e-6 relative where
    both hit, hit masks and winners (normals within 1e-5) differing on at
    most EDGE_SHARE of the hit pixels."""
    (cd, cn), (pd, pn) = [(d.cpu().numpy(), n.cpu().numpy()) for d, n in (card, cpu)]
    chit, phit = cd > 0, pd > 0
    both = chit & phit
    n_hit = max(int(phit.sum()), 1)
    mask_diff = int((chit != phit).sum())
    depth_rel = float((np.abs(cd[both] - pd[both]) / pd[both]).max()) if both.any() else 0.0
    winner_diff = int((np.abs(cn[both] - pn[both]).max(-1) > 1e-5).sum())
    if not (mask_diff <= EDGE_SHARE * n_hit and depth_rel <= 1e-6
            and winner_diff <= EDGE_SHARE * n_hit and phit.mean() > 0.5):
        raise AssertionError(f"{label}: mask diff {mask_diff}, depth rel {depth_rel}, winner "
                             f"diff {winner_diff} of {n_hit} hit pixels")
    return dict(hit_pixels=n_hit, mask_diff=mask_diff, max_depth_rel=depth_rel,
                winner_diff=winner_diff)


def timed_s(fn, dev, reps=3):
    """The least host seconds of ``reps`` calls of fn, each ended by a
    synchronize, after one warm-up call; and fn's last result."""
    out = fn()
    torch.cuda.synchronize(dev)
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    return best, out


def write_preprocess_fixtures(root):
    """The three CLIs' inputs: a 7-Scenes sequence of two 480 x 640 Kinect
    depth frames; a ScanNet++ scene with a heightfield mesh, two iPhone
    frames with IMU poses and two fisheye DSLR frames with a COLMAP model;
    and the identity config's synthetic dataset (nothing on disk)."""
    from PIL import Image

    from unigeo_tpu_torch.preprocess.rasterizer import write_ply_mesh

    rng = np.random.default_rng(21)
    seq = os.path.join(root, "7s", "chess", "seq-01")
    os.makedirs(seq)
    vv, uu = np.mgrid[0:480, 0:640]
    for i in range(2):
        depth = np.clip(1200 + 2.0 * uu + vv + rng.normal(scale=25, size=uu.shape), 1, 65534)
        depth = depth.astype(np.uint16)
        depth[rng.random(depth.shape) < 0.05] = 0
        Image.fromarray(depth).save(os.path.join(seq, f"frame-{i:06d}.depth.png"))
    scene = os.path.join(root, "scannetpp", "scene0")
    for sub in ("scans", "iphone/rgb", "dslr/colmap", "dslr/images"):
        os.makedirs(os.path.join(scene, sub))
    write_ply_mesh(os.path.join(scene, "scans", "mesh_aligned_0.05.ply"),
                   *heightfield_mesh(60, 45, seed=22))
    meta = {}
    for i in range(2):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.05 * i, 0.0, -0.2]
        meta[f"frame_{i:06d}"] = {"aligned_pose": c2w.tolist(),
                                  "intrinsic": [[180.0, 0, 95.5], [0, 180.0, 71.5], [0, 0, 1]]}
        Image.fromarray(rng.integers(0, 256, (144, 192, 3), dtype=np.uint8)).save(
            os.path.join(scene, "iphone", "rgb", f"frame_{i:06d}.jpg"))
    with open(os.path.join(scene, "iphone", "pose_intrinsic_imu.json"), "w") as f:
        json.dump(meta, f)
    w, h = 192, 128
    with open(os.path.join(scene, "dslr", "colmap", "cameras.txt"), "w") as f:
        f.write(f"1 OPENCV_FISHEYE {w} {h} 110.0 110.0 {w / 2 + 0.5} {h / 2 + 0.5} "
                "0.03 -0.005 0.001 -0.0002\n")
    with open(os.path.join(scene, "dslr", "colmap", "images.txt"), "w") as f:
        f.write("1 1 0 0 0 0 0 0.2 1 DSC00001.JPG\n\n2 0.999 0 0.0447 0 0.1 0 0.2 1 "
                "DSC00002.JPG\n\n")
    with open(os.path.join(scene, "dslr", "colmap", "points3D.txt"), "w") as f:
        f.write("# none\n")
    for name in ("DSC00001.JPG", "DSC00002.JPG"):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(scene, "dslr", "images", name))


def phase_preprocess(dev):
    """The offline preprocessors on the card (``unigeo_tpu_torch/preprocess``):
    the rasterizer on a seeded heightfield of about 1.5 M faces at 768 x 1024
    (timed, its z-buffer's candidate rows counted) and, at about 20 k faces,
    held against the port's own CPU run; register_depth_to_rgb on a 480 x
    640 Kinect frame (bitwise the CPU run's) and undistort_image on a 1752 x
    1168 fisheye DSLR frame (ScanNet++'s DSLR size; within 1e-3 of the CPU
    run), both timed; then the three CLIs (preprocess_7scenes,
    preprocess_scannetpp on the iPhone and the DSLR path, vis_dataset) on
    the card over fixtures written here, each held against the same CLI
    run with --device cpu (the 7-Scenes PNGs bitwise, the ScanNet++ depth
    PNGs within 1 mm with equal hit masks and the normal maps within 1 of
    255, the QA strips within 1 of 255 away from the frame's 2-pixel
    border band)."""
    from PIL import Image

    from unigeo_tpu_torch.preprocess import colmap, rasterizer, sevenscenes
    from unigeo_tpu_torch.tools import preprocess_7scenes, preprocess_scannetpp, vis_dataset

    cpu = torch.device("cpu")
    h, w = RASTER_HW
    w2c, k = raster_camera()
    result = {}
    verts, faces = heightfield_mesh(*RASTER_LARGE, seed=20)
    vd, fd = torch.from_numpy(verts).to(dev), torch.from_numpy(faces).to(dev)
    sec, (depth, normal) = timed_s(lambda: rasterizer.rasterize_mesh(vd, fd, w2c, k, h, w,
                                                                      device=dev), dev)
    hit = float((depth > 0).float().mean())
    if not (hit > 0.9 and torch.isfinite(normal).all()):
        raise AssertionError(f"rasterizer: hit share {hit} at {len(faces)} faces")
    result["raster_large"] = dict(faces=len(faces), vertices=len(verts), hw=[h, w],
                                  seconds=sec, hit_share=hit)
    log("preprocess", f"rasterize_mesh {len(faces)} faces at {h} x {w}: {sec * 1e3:.1f} ms "
        f"(best of 3, vertex normals included), hit share {hit:.4f}")
    verts, faces = heightfield_mesh(*RASTER_SMALL, seed=23)
    card = rasterizer.rasterize_mesh(verts, faces, w2c, k, h, w, device=dev)
    t0 = time.perf_counter()
    on_cpu = rasterizer.rasterize_mesh(verts, faces, w2c, k, h, w, device=cpu)
    cpu_s = time.perf_counter() - t0
    held = hold_render("rasterizer card vs cpu", card, on_cpu)
    result["raster_small"] = dict(faces=len(faces), cpu_seconds=cpu_s, **held)
    log("preprocess", f"rasterize_mesh {len(faces)} faces: card vs the port's CPU run {held} "
        f"(CPU {cpu_s:.2f} s)")

    rng = np.random.default_rng(24)
    vv, uu = np.mgrid[0:480, 0:640]
    kinect = np.clip(1500 + 2.0 * uu + 1.5 * vv + rng.normal(scale=30, size=uu.shape), 1, 65534)
    kinect = kinect.astype(np.uint16)
    kinect[rng.random(kinect.shape) < 0.05] = 0
    sec, reg = timed_s(lambda: sevenscenes.register_depth_to_rgb(kinect, device=dev), dev)
    want = sevenscenes.register_depth_to_rgb(kinect, device=cpu)
    if not torch.equal(reg.cpu(), want):
        raise AssertionError("register_depth_to_rgb: the card's frame differs from the CPU's")
    result["register_depth_to_rgb"] = dict(hw=[480, 640], seconds=sec,
                                           valid_share=float((want > 0).float().mean()))
    log("preprocess", f"register_depth_to_rgb 480 x 640: {sec * 1e3:.2f} ms, bitwise the CPU run")

    cam = colmap.ColmapCamera(1, "OPENCV_FISHEYE", 1752, 1168,
                              np.array([790.0, 790.0, 876.5, 584.5, 0.03, -0.005, 0.001, -2e-4]))
    image = rng.integers(0, 256, (1168, 1752, 3)).astype(np.float32)
    sec, (new_k, und, mask) = timed_s(lambda: colmap.undistort_image(cam, image, device=dev), dev)
    want_k, want_und, want_mask = colmap.undistort_image(cam, image, device=cpu)
    und_err = float((und.cpu() - want_und).abs().max()) / 255.0
    if not (und_err <= 1e-3 and torch.allclose(new_k.cpu(), want_k, rtol=1e-12, atol=0)
            and float(mask.float().mean()) > 0.5):
        raise AssertionError(f"undistort_image: card vs cpu {und_err}, K {new_k} {want_k}")
    result["undistort_image"] = dict(hw=[1168, 1752], seconds=sec, max_err_over_255=und_err)
    log("preprocess", f"undistort_image fisheye 1168 x 1752: {sec * 1e3:.2f} ms, "
        f"max |card - cpu| / 255 = {und_err:.2e}")

    with tempfile.TemporaryDirectory() as root:
        write_preprocess_fixtures(root)
        runs = {}
        for dev_name in ("cpu", "cuda"):
            out = os.path.join(root, dev_name)
            shutil.copytree(os.path.join(root, "7s"), os.path.join(out, "7s"))
            t0 = time.perf_counter()
            if preprocess_7scenes.main(["--root", os.path.join(out, "7s"),
                                        "--device", dev_name]) != 0:
                raise AssertionError("preprocess_7scenes failed")
            for camera in ("iphone", "dslr"):
                if preprocess_scannetpp.main([
                        "--data-root", os.path.join(root, "scannetpp"), "--camera", camera,
                        "--out-root", os.path.join(out, camera), "--height", "144",
                        "--width", "192", "--device", dev_name]) != 0:
                    raise AssertionError(f"preprocess_scannetpp {camera} failed")
            if vis_dataset.main(["--config", os.path.join(
                                     os.path.dirname(os.path.abspath(__file__)), "configs",
                                     "identity_synthetic.yaml"),
                                 "--every", "3", "--max-samples", "2",
                                 "--out", os.path.join(out, "vis"), "--device", dev_name]) != 0:
                raise AssertionError("vis_dataset failed")
            runs[dev_name] = time.perf_counter() - t0
        png = lambda *p: np.asarray(Image.open(os.path.join(root, *p))).astype(np.int64)
        for i in range(2):
            name = ("7s", "chess", "seq-01", f"frame-{i:06d}.depth.proj.png")
            if not np.array_equal(png("cuda", *name), png("cpu", *name)):
                raise AssertionError(f"preprocess_7scenes: {name[-1]} differs from the CPU run")
        for camera in ("iphone", "dslr"):
            meta = np.load(os.path.join(root, "cuda", camera, "scene0", "scene_metadata.npz"))
            if len(meta["images"]) != 2:
                raise AssertionError(f"preprocess_scannetpp {camera}: {list(meta['images'])}")
            for name in meta["images"]:
                d = png("cuda", camera, "scene0", "depth", f"{name}.png")
                dc = png("cpu", camera, "scene0", "depth", f"{name}.png")
                n = png("cuda", camera, "scene0", "normal", f"{name}.webp")
                nc = png("cpu", camera, "scene0", "normal", f"{name}.webp")
                if not (np.array_equal(d > 0, dc > 0) and np.abs(d - dc).max() <= 1
                        and np.abs(n - nc).max() <= 1 and (d > 0).mean() > 0.5):
                    raise AssertionError(f"preprocess_scannetpp {camera} {name}: card vs cpu")
        strips = sorted(os.listdir(os.path.join(root, "cuda", "vis")))
        for name in strips:
            if name.endswith(".png"):
                a, b = png("cuda", "vis", name), png("cpu", "vis", name)
                if not (np.array_equal(a[:, :256], b[:, :256])
                        and np.abs(a[2:-2, 258:-2] - b[2:-2, 258:-2]).max() <= 1):
                    raise AssertionError(f"vis_dataset {name}: card vs cpu")
        result["clis_seconds"] = runs
    log("preprocess", f"CLIs on the card: 7-Scenes 2 frames, ScanNet++ iPhone and DSLR 2 "
        f"frames each, vis_dataset 2 strips; each held against its --device cpu run "
        f"(seconds: {json.dumps({k: round(v, 2) for k, v in runs.items()})})")
    return result


def summarize(name, source, replaces, rows, launches, extra=None):
    """One entry of the kernels line: sums over the shapes, each shape below.
    The sums are over the rows given, all at KERNEL_BATCH (the batch-25 rows
    of the training kernels ride along under their own key)."""
    sums = {key: sum(r[key] for r in rows) for key in ("ms", "plain_ms", "bound_ms")}
    # None where no one PyTorch call computes the function
    libs = [r["library_ms"] for r in rows]
    sums["library_ms"] = None if None in libs else sum(libs)
    entry = {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_err_over_limit": max(r["max_err_over_limit"] for r in rows),
        "sums_over": f"the shapes below at batch {KERNEL_BATCH}",
        "ms": sums["ms"],
        "plain_ms": sums["plain_ms"],
        "bound_ms": sums["bound_ms"],
        "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": sums["library_ms"],
    }
    entry.update(extra or {})
    entry["shapes"] = rows
    return entry


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

    for k in SWITCHES:  # the default paths, whatever the caller's environment
        os.environ.pop(k, None)
    rows = phase_kernel(dev)
    headsplit_rows = phase_kernel_headsplit(dev)
    geglu_rows = phase_kernel_geglu(dev)
    ln_rows = phase_kernel_ln_dense(dev)
    train_rows = phase_kernel_train(dev)
    fwd25 = kernel_forward_batch25(dev)
    f32_rows = phase_kernel_f32_pointmap(dev)
    f32_bwd_rows = phase_kernel_f32_bwd(dev)
    cuda_core_rows = phase_kernel_bf16_cuda_core(dev)
    wide_rows = phase_kernel_wide(dev)
    torch.cuda.synchronize()
    phase_reference(dev)
    phase_reference_train(dev)
    torch.cuda.synchronize()
    launches, _ = phase_main(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    drifted = phase_bf16_drift(dev)
    torch.cuda.empty_cache()
    served = phase_serving(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    parallel = phase_parallel(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    phase_debug_nans(dev)
    evaluated = phase_eval(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    phase_disk_eval(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    siblings = phase_svd_family(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    siblings.update(phase_pointmap(dev))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    siblings.update(phase_pointmap_models(dev))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    siblings.update(phase_aether(dev))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    trained_models = phase_train_models(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    trained = phase_train(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ln_launches, _ = phase_tool_ln_qkv()
    torch.cuda.empty_cache()
    phase_preprocess(dev)
    torch.cuda.empty_cache()
    phase_metrics(dev)

    src = "unigeo_tpu_torch/csrc/"
    per_step = trained["launches_per_step"]
    b25 = train_rows["batch25"]
    # launches per training step on the paths this slice added, by family
    new_paths = {label: row["launches_per_step"] for label, row in trained_models.items()}

    def batch25(*keys):
        """The batch-25 rows' fields ``keys`` (with the shape), per shape."""
        return [{"shape": r["shape"], "b": r["b"], "sq": r["sq"], "h": r["h"], "d": r["d"],
                 **{k: r[k] for k in keys if k in r}} for r in b25]

    def forward25(key):
        """Row ``key``'s numbers at batch TRAIN_BATCH per forward shape, and the
        body (wgmma, by kernel name) that served each head width."""
        shapes = [{"shape": r["shape"], "b": r["b"], "s": r["s"], "h": r["h"], "d": r["d"],
                   "body": r[f"{key}_body"], "ms": r[f"{key}_ms"],
                   "device_ms": r[f"{key}_device_ms"],
                   "library_ms": r["library_ms"], "library_device_ms": r["library_device_ms"],
                   "bound_ms": r["bound_ms"],
                   "bound_by": r["bound_by"], "exp_floor_ms": r["exp_floor_ms"],
                   "max_err_over_limit": r[f"{key}_max_err_over_limit"],
                   **({"lse_err": r["lse_err"]} if key == "fwd_lse" else {})} for r in fwd25]
        return {"body_by_head_width": {str(r["d"]): r[f"{key}_body"] for r in fwd25},
                "batch25_forward_shapes": shapes}

    kernels = [
        summarize("flash_attention_packed", src + "flash_attention_packed.cu",
                  "unigeo_tpu/ops/attention.py:298", rows, launches,
                  {"launches_train": trained["launches"]["flash_attention_packed"],
                   "launches_train_per_step": per_step["flash_attention_packed"],
                   "launches_per_clip_new_paths": {k: v["launches_per_clip"]
                                                   for k, v in siblings.items()
                                                   if "launches_per_clip" in v},
                   "launches_serving": {"pair_in_one_batch": served["launches_pair"],
                                        "single_clip": served["launches_single"]},
                   "serving": served,
                   "launches_bf16_drift": {name: {"per_leg": r["launches"],
                                                  "predicted": r["predicted_launches"]}
                                           for name, r in drifted.items()},
                   "bf16_drift": {name: {k: r[k] for k in (
                       "held", "absrel", "absrel_aligned_lstsq", "delta_1p25",
                       "normal_mean_angle_shift_deg", "yardstick", "seconds", "peak_gib")}
                                  for name, r in drifted.items()},
                   "launches_parallel": {part: {"flash_launches_per_rank": v["flash_launches"],
                                                "backend": v["backend"]}
                                         for part, v in parallel.items()
                                         if isinstance(v, dict) and "flash_launches" in v},
                   "parallel": parallel,
                   "bf16_cuda_core_shapes": cuda_core_rows["fwd"],
                   "wide_head_shapes": wide_rows["fwd"],
                   "f32_pointmap_shapes": f32_rows,
                   "f32_body_by_head_width": {str(r["d"]): r["body"] for r in f32_rows},
                   "batch_flash_f32_d512_device_ms": trained["batch_flash_f32_d512_device_ms"],
                   **forward25("packed")}),
        summarize("flash_attention_headsplit", src + "flash_attention_packed.cu",
                  "unigeo_tpu/ops/attention.py:163", headsplit_rows,
                  evaluated["headsplit_launches"],
                  {"launches_on": "one eval forward under UNIGEO_PACKED_ATTN=0",
                   **forward25("headsplit")}),
        summarize("geglu_ffn", src + "geglu_ffn.cu", "unigeo_tpu/ops/geglu.py:72", geglu_rows,
                  evaluated["launches"]["geglu_ffn"],
                  {"sums_over": "the shapes below at the paths' M (25 frames x tokens)",
                   "device_ms": sum(r["device_ms"] for r in geglu_rows),
                   "launches_on": f"the eval run of {EVAL_CLIPS} clips under UNIGEO_FUSED_GEGLU=1",
                   "launches_per_clip": evaluated["launches_per_clip"]["geglu_ffn"],
                   "unfused_ms": sum(r["unfused_ms"] for r in geglu_rows),
                   "unfused_computes": "the unfused bf16 layers, several PyTorch calls "
                                       "(a yardstick, not one library call)"}),
        summarize("flash_attention_fwd_lse", src + "flash_attention_packed.cu",
                  "unigeo_tpu/ops/attention.py:529", train_rows["fwd_lse"],
                  trained["launches"]["flash_attention_fwd_lse"],
                  {"launches_per_step": per_step["flash_attention_fwd_lse"],
                   "launches_per_step_new_paths": {
                       k: v["flash_attention_fwd_lse"] for k, v in new_paths.items()},
                   **forward25("fwd_lse")}),
        summarize("flash_attention_bwd_dq", src + "flash_attention_bwd.cu",
                  "unigeo_tpu/ops/attention.py:582", train_rows["bwd_dq"],
                  trained["launches"]["flash_attention_bwd_dq"],
                  {"launches_per_step": per_step["flash_attention_bwd_dq"],
                   "launches_per_step_new_paths": {
                       k: v["flash_attention_bwd_dq"] for k, v in new_paths.items()},
                   "f32_training_shapes": f32_bwd_rows,
                   "bf16_cuda_core_shapes": cuda_core_rows["bwd_dq"],
                   "wide_head_shapes": wide_rows["bwd_dq"],
                   "library_computes": "dq, dk and dv (scaled_dot_product_attention backward)",
                   "batch25_shapes": batch25("dq_ms", "library_bwd_ms", "dq_bound_ms",
                                             "max_err_over_limit_dq", "max_abs_err_dq",
                                             "pair_ms", "pair_bound_ms", "bwd_bound_ms")}),
        summarize("flash_attention_bwd_dkv", src + "flash_attention_bwd.cu",
                  "unigeo_tpu/ops/attention.py:582", train_rows["bwd_dkv"],
                  trained["launches"]["flash_attention_bwd_dkv"],
                  {"launches_per_step": per_step["flash_attention_bwd_dkv"],
                   "launches_per_step_new_paths": {
                       k: v["flash_attention_bwd_dkv"] for k, v in new_paths.items()},
                   "f32_training_shapes": f32_bwd_rows,
                   "bf16_cuda_core_shapes": cuda_core_rows["bwd_dkv"],
                   "wide_head_shapes": wide_rows["bwd_dkv"],
                   "library_computes": "dq, dk and dv (scaled_dot_product_attention backward)",
                   "batch25_shapes": batch25("dkv_ms", "library_bwd_ms", "dkv_bound_ms",
                                             "max_err_over_limit_dkv", "max_abs_err_dkv",
                                             "pair_ms", "pair_bound_ms", "bwd_bound_ms")}),
        summarize("ln_dense", src + "ln_dense.cu", "unigeo_tpu/ops/ln_qkv.py:49",
                  [r for r in ln_rows if r["shape"].startswith("unet")], ln_launches,
                  {"sums_over": "the shapes below at the paths' M (25 frames x tokens)",
                   "device_ms": sum(r["device_ms"] for r in ln_rows
                                    if r["shape"].startswith("unet")),
                   "launches_on": "python -m unigeo_tpu_torch.tools.ablate_ln_qkv at full size "
                                  "(no model uses it: 0 on the forward, eval and train paths)",
                   "unfused_ms": sum(r["unfused_ms"] for r in ln_rows
                                     if r["shape"].startswith("unet")),
                   "unfused_computes": "F.layer_norm then F.linear, two PyTorch calls "
                                       "(a yardstick, not one library call)",
                   "ragged_shapes": [r for r in ln_rows if not r["shape"].startswith("unet")]}),
    ]
    for k in kernels:
        if not k["launches"] > 0:
            raise AssertionError(f"{k['name']} was not launched on its main path")
    log("done", "every phase passed (the seconds since start are the whole run's)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
