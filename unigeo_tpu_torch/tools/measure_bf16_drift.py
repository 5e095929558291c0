"""bf16-vs-f32 drift of the port's production path at the production shape.

Port of ``tools/measure_bf16_drift.py``.  The 0.5% tolerance of the north
star (``BASELINE.json``: Abs Rel and normal mean within 0.5% of the
reference) is won or lost in the production dtype, so this runs ONE set of
random f32 master weights through three legs on the same inputs:

  * ``f32``: the whole path in f32 with TF32 off (the reference);
  * ``yardstick``: the same f32 path on the inputs rounded to bf16 and back,
    how far a mere rounding of the inputs moves this random network
    (reported, not held);
  * ``bf16``: the master weights cast in place to bf16, the production
    configuration (the bf16 flash bodies);

and scores each leg against one fixed synthetic GT through the port's
metrics, reporting the shift of every headline metric between the bf16 and
the f32 leg, the number the 0.5% is about.

DepthCrafter (``--model depthcrafter``, the default): SVD-XT width, one
25 x 384 x 512 clip (frames uniform in [0, 1) from numpy seed 0), 5 Euler
steps, through ``run_window_staged``; each leg's decode takes the reference
postprocessing (``reference_postproc``) and normals come from its depth by
backprojection with one K.  Aether (``--model aether``):
``configs/aether_scannetpp.yaml``'s model_params at 16 x 384 x 512, its
every all-equal parameter redrawn (a random adaLN-zero DiT outputs 0),
through ``forward_tensors`` under compute_dtype None and then bfloat16;
its own depths and normals are scored, and the raymaps' and poses' largest
relative deviations are reported without being held (camera recovery on a
random network is degenerate).

Held, for each model: |m_bf16 - m_f32| <= 0.005 |m_f32| for Abs Rel,
delta < 1.25 and normal mean (``held``, ``held_within_tolerance``).  The
JAX gate's figures (Abs Rel shift < 1e-3, lstsq-aligned AbsRel < 0.02,
delta_1p25 > 0.99) and the yardstick's shifts are reported beside them,
and so is ``constant_prediction_floor``, what a constant depth scores on
the GT: a random network's depth that the lstsq alignment cannot relate
to the GT scores it in every dtype, and then only the pixel figures (the
f32 leg taken as the truth: ``absrel``, whose JAX-tool tolerance is
``within_tolerance``) and the normals tell the legs apart.

    python -m unigeo_tpu_torch.tools.measure_bf16_drift [--model aether]
        [--frames T --h H --w W --steps N] [--out FILE]

on the card; ``--tiny --device cpu`` runs the tiny f32 models here (the
machinery only).  It prints one JSON line and writes it to ``--out`` when
given, and nowhere else: ``BF16_DRIFT.json`` at the repository root is the
JAX package's gate (``tests/test_bf16_drift_tool.py``), never this tool's.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

TOLERANCE = 0.005  # BASELINE.json: within 0.5% of the reference
HELD_KEYS = ("Abs Rel", "delta < 1.25", "normal mean")
DEPTH_KEYS = ("Abs Rel", "Sq Rel", "RMSE", "delta < 1.25")
NORMAL_KEYS = ("normal mean", "normal median")
AETHER_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "aether_scannetpp.yaml")
SHAPES = {  # (frames, h, w, steps): production, then --tiny
    "depthcrafter": ((25, 384, 512, 5), (4, 64, 64, 2)),
    "aether": ((16, 384, 512, 4), (8, 128, 128, 2)),
}


def reference_postproc(decoded) -> torch.Tensor:
    """Reference depth postprocessing (model/depthcrafter.py:92-97 of the
    reference): the 3-channel mean, min-max normalised over the whole clip,
    then 1 / (x + 0.1).  [T, H, W, 3] -> [T, H, W], on decoded's device."""
    x = torch.as_tensor(decoded).float().mean(dim=-1)
    lo, hi = x.min(), x.max()
    x = (x - lo) / (hi - lo).clamp_min(1e-12)
    return 1.0 / (x + 0.1)


def synthetic_gt(t: int, h: int, w: int) -> np.ndarray:
    """The fixed GT depth field of the JAX tool, [t, h, w] f32 in [1, 3]."""
    yy, xx = np.meshgrid(np.linspace(0, 2, h), np.linspace(0, 2, w), indexing="ij")
    gt = (2.0 + np.sin(xx * 3) * np.cos(yy * 2))[None].repeat(t, 0)
    return gt.astype(np.float32)


def intrinsics(h: int, w: int) -> np.ndarray:
    """The JAX tool's K: focal 0.6 w, the principal point at the centre."""
    return np.array([[0.6 * w, 0, w / 2], [0, 0.6 * w, h / 2], [0, 0, 1]], np.float32)


def depth_normals(depth: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """[T, H, W] depth -> [T, H, W, 3] plane-fit normals (OpenCV camera
    frame), the adapters' recipe: backprojection through K, 5 x 5 fits."""
    from unigeo_tpu_torch.ops.backproject import backproject_to_cv_position
    from unigeo_tpu_torch.ops.normals import surface_normals_from_points

    kt = torch.from_numpy(k).to(depth.device)
    return surface_normals_from_points(backproject_to_cv_position(depth.float(), kt))


def scores(depth: torch.Tensor, normals: torch.Tensor, gt: torch.Tensor,
           gt_normals: torch.Tensor) -> Dict[str, float]:
    """One leg against the fixed GT: DEPTH_KEYS after the lstsq alignment
    the eval recipe uses, NORMAL_KEYS against the GT field's normals."""
    from unigeo_tpu_torch.metrics.depth import depth_evaluation
    from unigeo_tpu_torch.metrics.normal import normal_evaluation

    m = depth_evaluation(depth, gt, alignment="lstsq")[0]
    n = normal_evaluation(normals, gt_normals)
    return {**{k: m[k] for k in DEPTH_KEYS}, **{k: n[k] for k in NORMAL_KEYS}}


def constant_floor(gt: torch.Tensor) -> Dict[str, float]:
    """DEPTH_KEYS of a constant prediction on ``gt`` (lstsq-aligned, it is
    gt's mean): a leg whose depth the alignment cannot relate to the GT
    scores these, whatever its dtype, and its depth shifts say nothing."""
    from unigeo_tpu_torch.metrics.depth import depth_evaluation

    const = torch.ones_like(gt)
    const.view(-1)[0] = 2.0  # two values, so that the fit is determined
    m = depth_evaluation(const, gt, alignment="lstsq")[0]
    return {k: m[k] for k in DEPTH_KEYS}


def drift(test: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
          gt: torch.Tensor, gt_normals: torch.Tensor) -> Dict[str, Any]:
    """The JAX tool's figures of one leg against the reference leg (each
    {"depth", "normals"}, and its "scores" if already taken), the
    reference's depth taken as the truth: pixel AbsRel, its p99 and max, the
    delta < 1.25 share, the AbsRel after an lstsq fit of the test depth onto
    the reference's, the mean angle between the two legs' normals, and each
    metric's shift against the fixed GT (with both legs' values)."""
    d_t = test["depth"].detach().float().cpu().numpy()
    d_r = ref["depth"].detach().float().cpu().numpy()
    rel = np.abs(d_t - d_r) / d_r
    ratio = np.maximum(d_t / d_r, d_r / d_t)
    # the fit in f64: np.polyfit's rcond is len(x) times the eps of x's dtype,
    # which on 4.9 M f32 depths (0.58) truncates the fit
    a, b = np.polyfit(d_t.ravel().astype(np.float64), d_r.ravel().astype(np.float64), 1)
    aligned = a * d_t + b
    n_t = test["normals"].detach().float().cpu().numpy()
    n_r = ref["normals"].detach().float().cpu().numpy()
    dot = np.clip(np.sum(n_t * n_r, axis=-1), -1.0, 1.0)
    s_t, s_r = (leg.get("scores") or scores(leg["depth"], leg["normals"], gt, gt_normals)
                for leg in (test, ref))
    return {
        "absrel": float(rel.mean()),
        "absrel_aligned_lstsq": float(np.mean(np.abs(aligned - d_r) / d_r)),
        "rel_p99": float(np.quantile(rel, 0.99)),
        "rel_max": float(rel.max()),
        "delta_1p25": float((ratio < 1.25).mean()),
        "metric_shift_vs_fixed_gt": {k: abs(s_t[k] - s_r[k]) for k in s_r},
        "normal_mean_angle_shift_deg": float(np.degrees(np.arccos(dot)).mean()),
        "metrics_vs_fixed_gt": {"test": s_t, "reference": s_r},
    }


def held(summary: Dict[str, Any]) -> Dict[str, Any]:
    """HELD_KEYS' shifts against TOLERANCE times the reference leg's value."""
    ref = summary["metrics_vs_fixed_gt"]["reference"]
    out = {}
    for key in HELD_KEYS:
        shift, limit = summary["metric_shift_vs_fixed_gt"][key], TOLERANCE * abs(ref[key])
        out[key] = {"f32": ref[key], "bf16": summary["metrics_vs_fixed_gt"]["test"][key],
                    "shift": shift, "limit": limit, "rel_shift": shift / max(abs(ref[key]), 1e-12),
                    "within": bool(shift <= limit)}
    return out


def jax_gate(summary: Dict[str, Any]) -> Dict[str, bool]:
    """The JAX gate's three figures of ``summary`` (reported, not held)."""
    shift = summary["metric_shift_vs_fixed_gt"]["Abs Rel"]
    return {"abs_rel_shift_lt_1e-3": bool(shift < 1e-3),
            "absrel_aligned_lstsq_lt_0.02": bool(summary["absrel_aligned_lstsq"] < 0.02),
            "delta_1p25_gt_0.99": bool(summary["delta_1p25"] > 0.99)}


def card_name(dev: torch.device) -> str:
    """nvidia-smi's name and power limit of the card, "cpu" off it."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def packed_launches() -> int:
    from unigeo_tpu_torch.ops.attention import flash_attention_packed

    return flash_attention_packed.launches


def run_leg(dev: torch.device, fn: Callable[[], Any], f32: bool):
    """(fn's result, its seconds, the packed kernel's launches in it, the
    device's peak GiB in it or None off the card); TF32 off where ``f32``."""
    from unigeo_tpu_torch.device import exact_f32

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    before = packed_launches()
    t0 = time.perf_counter()
    with exact_f32() if f32 else contextlib.nullcontext():
        out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None
    return out, seconds, packed_launches() - before, peak


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def finish(model: str, title: str, shape: List[int], steps: int, legs: Dict[str, Dict],
           gt: torch.Tensor, gt_normals: torch.Tensor, dev: torch.device,
           extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The result line of one model: the bf16 leg's figures against the f32
    leg (the JAX tool's keys), what is held, the JAX gate, the yardstick's
    figures, and each leg's seconds, launches and peak."""
    t0 = time.perf_counter()
    for leg in legs.values():
        leg["scores"] = scores(leg["depth"], leg["normals"], gt, gt_normals)
    ref = legs["f32"]
    summary = drift(legs["bf16"], ref, gt, gt_normals)
    yard = drift(legs["yardstick"], ref, gt, gt_normals)
    checks = held(summary)
    result = {
        "metric": title,
        "model": model,
        "shape": shape,
        "steps": steps,
        **{k: v for k, v in summary.items() if k != "metrics_vs_fixed_gt"},
        "metrics_vs_fixed_gt": {"f32": summary["metrics_vs_fixed_gt"]["reference"],
                                "bf16": summary["metrics_vs_fixed_gt"]["test"],
                                "yardstick": yard["metrics_vs_fixed_gt"]["test"]},
        "constant_prediction_floor": constant_floor(gt),
        "north_star_tolerance": TOLERANCE,
        "within_tolerance": bool(summary["absrel"] < TOLERANCE),
        "held": checks,
        "held_within_tolerance": all(c["within"] for c in checks.values()),
        "jax_gate": jax_gate(summary),
        "yardstick": {k: v for k, v in yard.items() if k != "metrics_vs_fixed_gt"},
        "seconds": {k: leg["seconds"] for k, leg in legs.items()},
        "scoring_s": time.perf_counter() - t0,
        "launches": {k: leg["launches"] for k, leg in legs.items()},
        "peak_gib": {k: leg["peak_gib"] for k, leg in legs.items()},
        "device": card_name(dev),
        "note": "random weights from a seed (no checkpoint); the f32 leg is held to the JAX "
                "package at small shapes (tests/test_torch_bf16_drift.py)",
    }
    result.update(extra or {})
    return result


# ---------------------------------------------------------------------------
# DepthCrafter
# ---------------------------------------------------------------------------


def depthcrafter_pipeline(dev: torch.device, tiny: bool, seed: int = 0):
    """The f32 master pipeline (SVD-XT, or the tiny configs), random weights
    drawn on ``dev`` from a generator seeded with ``seed`` (built on the
    meta device: no host copy of the weights)."""
    from unigeo_tpu_torch.models.depthcrafter.pipeline import DepthCrafterPipeline, tiny_pipeline
    from unigeo_tpu_torch.tools.order_bisect import SVD_XT_CLIP, SVD_XT_UNET

    if tiny:
        pipe = tiny_pipeline(device=dev, dtype=torch.float32)
    else:
        pipe = DepthCrafterPipeline(unet_config=SVD_XT_UNET, clip_config=SVD_XT_CLIP,
                                    dtype=torch.float32, device=dev)
    return pipe.init_random(torch.Generator(device=dev).manual_seed(seed))


def depthcrafter_inputs(pipe, t: int, h: int, w: int):
    """(frames [t,h,w,3] uniform in [0, 1) from numpy seed 0, noise
    [t,h/8,w/8,4], aug noise [t,h,w,3]), f32 on the pipeline's device; the
    draws from a generator there seeded with 1."""
    frames = np.random.default_rng(0).uniform(size=(t, h, w, 3)).astype(np.float32)
    noise, aug = pipe.draw_clip_noise(torch.Generator(device=pipe.device).manual_seed(1), t, h, w)
    return torch.from_numpy(frames).to(pipe.device), noise, aug


def depthcrafter_legs(pipe, frames, noise, aug, steps: int, k: np.ndarray,
                      decoded: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Dict]:
    """The three legs through ``run_window_staged``, in the order f32,
    yardstick, bf16 (the last casts the pipeline's weights in place, so the
    weights exist in one copy at a time): each leg's postprocessed depth,
    its normals, seconds, packed launches and peak.  ``decoded``, if a dict,
    gets each leg's decoded clip."""
    dev = pipe.device
    rounded = [bf16_round(x) for x in (frames, noise, aug)]
    legs = {}
    for tag, inputs in (("f32", (frames, noise, aug)), ("yardstick", rounded), ("bf16", None)):
        if tag == "bf16":
            pipe.dtype = torch.bfloat16
            pipe.cast_params_to_dtype()
            inputs = (frames, noise, aug)
        f, n, a = inputs
        out, seconds, launches, peak = run_leg(
            dev, lambda: pipe.run_window_staged(f, n, steps, aug_noise=a), f32=tag != "bf16")
        if decoded is not None:
            decoded[tag] = out
        depth = reference_postproc(out)
        legs[tag] = {"depth": depth, "normals": depth_normals(depth, k), "seconds": seconds,
                     "launches": launches, "peak_gib": peak}
        del out
    return legs


def depthcrafter_drift(dev, t: int, h: int, w: int, steps: int,
                       tiny: bool = False) -> Dict[str, Any]:
    """The DepthCrafter result line."""
    dev = torch.device(dev)
    pipe = depthcrafter_pipeline(dev, tiny)
    frames, noise, aug = depthcrafter_inputs(pipe, t, h, w)
    k = intrinsics(h, w)
    legs = depthcrafter_legs(pipe, frames, noise, aug, steps, k)
    gt = torch.from_numpy(synthetic_gt(t, h, w)).to(dev)
    title = (f"bf16-vs-f32 depth drift, DepthCrafter{' (tiny)' if tiny else ''} {t}-frame "
             f"{h}x{w}, {steps} steps, reference postproc")
    return finish("depthcrafter", title, [t, h, w], steps, legs, gt, depth_normals(gt, k), dev)


# ---------------------------------------------------------------------------
# Aether
# ---------------------------------------------------------------------------


def aether_params(tiny: bool) -> Dict[str, Any]:
    """Aether's model_params: ``configs/aether_scannetpp.yaml``'s, or with
    --tiny the smallest Aether whose DiT reaches the flash kernel."""
    if tiny:
        from unigeo_tpu_torch.tools.aether_check import kernel_path_configs

        network_config, vae_config = kernel_path_configs()
        return dict(network_config=network_config, vae_config=vae_config, num_steps=2)
    from unigeo_tpu_torch.config import load_config

    return dict(load_config(AETHER_CONFIG)["model_params"])


def aether_model(dev, tiny: bool, seed: int = 0):
    """The f32 Aether on ``dev`` with random weights, its every all-equal
    parameter redrawn (``aether_check.perturb_constant_``)."""
    from unigeo_tpu_torch.models.aether import Aether
    from unigeo_tpu_torch.tools.aether_check import perturb_constant_

    model = Aether(**aether_params(tiny), seed=seed, device=dev)
    # f32 whatever UNIGEO_COMPUTE_DTYPE says: this is the reference leg
    model.compute_dtype = None
    model.network.float()
    perturb_constant_(model.network, torch.Generator(device=model.device).manual_seed(seed + 1))
    return model


def aether_inputs(model, t: int, h: int, w: int):
    """(a clip of t frames uniform in [0, 255) from numpy seed 0 with the
    tool's K, one f32 noise draw for the sampler from a generator on the
    device seeded with 1)."""
    net = model.network
    k = intrinsics(h, w)
    data = {"images": np.random.default_rng(0).uniform(0, 255, (t, 3, h, w)).astype(np.float32),
            "intrinsics": [k] * t}
    tl = (t + (-t) % net.ct) // net.ct
    noise = torch.randn((tl, net.target_channels, h // net.cs, w // net.cs),
                        generator=torch.Generator(device=model.device).manual_seed(1),
                        device=model.device)
    return data, noise


def aether_legs(model, data, noise) -> Dict[str, Dict]:
    """f32, yardstick (images and noise rounded to bf16 and back), then bf16
    (the network cast in place, the noise given at bf16 as the adapter
    draws it): each leg's depths, normals, raymaps, poses, seconds, packed
    launches and peak."""
    rounded = dict(data, images=bf16_round(torch.from_numpy(data["images"])).numpy())
    legs = {}
    for tag, d, n in (("f32", data, noise), ("yardstick", rounded, bf16_round(noise)),
                      ("bf16", data, noise.to(torch.bfloat16))):
        if tag == "bf16":
            model.compute_dtype = torch.bfloat16
            model.network.to(torch.bfloat16)
        out, seconds, launches, peak = run_leg(
            model.device, lambda: model.forward_tensors(d, noise=n), f32=False)
        legs[tag] = {"depth": out["pred_depths"], "normals": out["pred_normals"],
                     "raymaps": out["raymaps"], "poses": out["pred_poses"],
                     "seconds": seconds, "launches": launches, "peak_gib": peak}
    return legs


def max_rel_dev(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def aether_drift(dev, t: int, h: int, w: int, steps: Optional[int] = None,
                 tiny: bool = False) -> Dict[str, Any]:
    """The Aether result line (``steps``: the sampler's, else the config's)."""
    from unigeo_tpu_torch.models.pointmap.adapter import OPENGL_FLIP

    dev = torch.device(dev)
    model = aether_model(dev, tiny)
    if steps is not None:
        model.num_steps = int(steps)
    data, noise = aether_inputs(model, t, h, w)
    legs = aether_legs(model, data, noise)
    k = intrinsics(h, w)
    gt = torch.from_numpy(synthetic_gt(t, h, w)).to(dev)
    # the adapter's normals are in the OpenGL camera frame
    gt_normals = depth_normals(gt, k) * torch.tensor(OPENGL_FLIP, device=dev)
    camera = {key: {tag: max_rel_dev(legs[tag][key], legs["f32"][key])
                    for tag in ("bf16", "yardstick")} for key in ("raymaps", "poses")}
    title = (f"bf16-vs-f32 depth drift, Aether{' (tiny)' if tiny else ''} {t}-frame {h}x{w}, "
             f"{model.num_steps} steps, the adapter's depths and normals")
    return finish("aether", title, [t, h, w], model.num_steps, legs, gt, gt_normals, dev,
                  {"camera_max_rel_dev": camera,
                   "camera_note": "reported, not held: camera recovery on a random network is "
                                  "degenerate (ROADMAP queue 3 item 7)"})


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=sorted(SHAPES), default="depthcrafter")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny f32 models (DepthCrafter 4 x 64 x 64, Aether 8 x 128 x 128, "
                         "2 steps)")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--h", type=int, default=None)
    ap.add_argument("--w", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args(argv)

    from unigeo_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    t, h, w, steps = SHAPES[args.model][1 if args.tiny else 0]
    t, h, w = args.frames or t, args.h or h, args.w or w
    steps = args.steps or steps
    run = depthcrafter_drift if args.model == "depthcrafter" else aether_drift
    with torch.no_grad():
        result = run(dev, t, h, w, steps, tiny=args.tiny)
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return result


if __name__ == "__main__":
    main()
