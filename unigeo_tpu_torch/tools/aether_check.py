"""The smallest Aether whose DiT reaches the f32 flash kernel, run on the
card and on the CPU with the same weights and the same noise, and the
limits that hold the card's outputs to the CPU's: ``chip_smoke.py``'s
aether phase and ``tests/test_torch_cuda.py`` both use it.

Its configuration (``kernel_path_configs``) is ``tiny_aether``'s VAE under a
DiT of width 128 over 2 heads: 8 frames at 128 x 128 give 4 latent frames
of 8 x 8 patches, one sequence of 256 tokens at d = 64, so each of the 2
blocks attends on the kernel at each of the 2 steps (4 launches).  Its
every all-equal parameter is redrawn (``perturb_constant_``): adaLN-zero
would otherwise make the DiT output 0 and leave the sample the noise.

The limits (``within_limits``): depths, raymaps, world points and poses
within ``REL_TOL`` of the CPU's largest magnitude; the normals' median
angle from the CPU's within ``NORMAL_DEG_TOL`` degrees, and their mean
angle within the larger of ``NORMAL_DEG_TOL`` and ``NORMAL_FLOOR_FACTOR``
times the round-off floor (``normals_floor_deg``): the mean angle by which
the CPU's own normals move when its depths move by ``DEPTH_JITTER``
relative, about one f32 step.  The normals are held by angle, not entry by
entry, and the mean against that floor, because the plane fit behind them
is dominated by rounding where a box's scatter is near degenerate
(ROADMAP queue 3 item 5): on this model's nearly flat random depths a
change of one step turns 3% of the pixels by more than a degree and a
few by more than 90, and on an H100 the card's normals were 1.7 apart
from the CPU's entry by entry, relative to their largest magnitude, with
the depths 1.6e-7 apart.  A frame of normals turned the wrong way, or a
tilt of every normal by 0.1 degree, still fails.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

REL_TOL = 1e-4
NORMAL_DEG_TOL = 0.05
NORMAL_FLOOR_FACTOR = 2.0
DEPTH_JITTER = 1e-7
FRAMES, SIDE, STEPS = 8, 128, 2
LAUNCHES = 4  # 2 blocks x 2 steps
REL_KEYS = ("pred_depths", "raymaps", "pred_world_pts", "pred_poses")


def kernel_path_configs():
    """(network_config, vae_config) of the smallest Aether whose DiT reaches
    the flash kernel at d = 64."""
    from unigeo_tpu_torch.models.aether import tiny_aether_configs

    return (dict(width=128, depth=2, num_heads=2, patch=2, mlp_ratio=2),
            tiny_aether_configs()[1])


@torch.no_grad()
def perturb_constant_(module: nn.Module, generator: torch.Generator, std: float = 0.2):
    """Every parameter whose entries are all equal (the zero modulations and
    output projection of adaLN-zero, biases, GroupNorm scales) redrawn from
    N(0, std): a random network whose output then depends on every
    parameter."""
    for p in module.parameters():
        if bool((p == p.flatten()[0]).all()):
            p.copy_(torch.randn(p.shape, generator=generator, device=generator.device) * std)
    return module


def kernel_path_pair(dev, seed: int):
    """(the Aether on ``dev``, the same weights on the CPU), in f32, from
    a CPU generator seeded with ``seed``."""
    from unigeo_tpu_torch.models.aether import Aether

    network_config, vae_config = kernel_path_configs()
    kw = dict(network_config=network_config, vae_config=vae_config, num_steps=STEPS)
    cpu = Aether(**kw, device="cpu")
    perturb_constant_(cpu.network, torch.Generator().manual_seed(seed))
    card = Aether(**kw, device=dev).load_state_dict(cpu.network.state_dict())
    return card, cpu


def kernel_path_inputs(model, data_seed: int, noise_seed: int):
    """(a clip of FRAMES random frames at SIDE x SIDE with its intrinsics,
    one noise draw for the sampler on the CPU)."""
    k = np.array([[100.0, 0, SIDE / 2], [0, 100.0, SIDE / 2], [0, 0, 1]], np.float32)
    data = {"images": np.random.default_rng(data_seed).uniform(0, 255, (FRAMES, 3, SIDE, SIDE))
            .astype(np.float32), "intrinsics": [k] * FRAMES}
    lat = SIDE // model.network.cs
    noise = torch.randn((FRAMES // model.network.ct, model.network.target_channels, lat, lat),
                        generator=torch.Generator().manual_seed(noise_seed))
    return data, noise


def angles_deg(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    """Per-pixel angle in degrees between two normal maps [..., 3], as the
    atan2 of |a x b| and a . b (exact at 0, where arccos of the dot is
    not)."""
    a, b = a.detach().cpu().double().numpy(), b.detach().cpu().double().numpy()
    return np.degrees(np.arctan2(np.linalg.norm(np.cross(a, b), axis=-1), (a * b).sum(-1)))


def normals_floor_deg(data, refs: Dict[str, torch.Tensor], seed: int = 0) -> float:
    """The mean angle by which the normals of ``refs`` (a run on the CPU)
    move when their depths are multiplied by 1 + DEPTH_JITTER N(0, 1), the
    normals taken as the adapter takes them."""
    from unigeo_tpu_torch.models.pointmap.adapter import OPENGL_FLIP
    from unigeo_tpu_torch.ops.backproject import backproject_to_cv_position
    from unigeo_tpu_torch.ops.normals import surface_normals_from_points

    depths = refs["pred_depths"]
    gen = torch.Generator().manual_seed(seed)
    moved = depths * (1.0 + DEPTH_JITTER * torch.randn(depths.shape, generator=gen))
    intr = torch.from_numpy(np.stack(data["intrinsics"]).astype(np.float32))
    normals = surface_normals_from_points(backproject_to_cv_position(moved, intr))
    return float(angles_deg(normals * torch.tensor(OPENGL_FLIP), refs["pred_normals"]).mean())


def deviations(outs: Dict[str, torch.Tensor], refs: Dict[str, torch.Tensor],
               floor_deg: float) -> Dict[str, float]:
    """Each of REL_KEYS' max abs deviation over the reference's largest
    magnitude; the normals' mean and median angle in degrees, and the
    round-off floor ``floor_deg`` their mean is held against."""
    dev = {key: ((outs[key].cpu() - refs[key]).abs().max() / refs[key].abs().max()).item()
           for key in REL_KEYS}
    angle = angles_deg(outs["pred_normals"], refs["pred_normals"])
    dev.update(pred_normals_mean_deg=float(angle.mean()),
               pred_normals_median_deg=float(np.median(angle)),
               pred_normals_floor_deg=floor_deg)
    return dev


def within_limits(dev: Dict[str, float]) -> bool:
    mean_limit = max(NORMAL_DEG_TOL, NORMAL_FLOOR_FACTOR * dev["pred_normals_floor_deg"])
    return (all(dev[key] <= REL_TOL for key in REL_KEYS)
            and dev["pred_normals_median_deg"] <= NORMAL_DEG_TOL
            and dev["pred_normals_mean_deg"] <= mean_limit)


def run_on_both(dev, seed: int, data_seed: int, noise_seed: int,
                count=None) -> Tuple[Dict[str, float], int]:
    """(``deviations`` of the card's run from the CPU's, the kernel's
    launches in the card's run as ``count()`` reads them before and after
    it; None without ``count``)."""
    card, cpu = kernel_path_pair(dev, seed)
    data, noise = kernel_path_inputs(cpu, data_seed, noise_seed)
    before = count() if count else None
    outs = card.forward_tensors(data, noise=noise)
    torch.cuda.synchronize()
    launched = count() - before if count else None
    refs = cpu.forward_tensors(data, noise=noise)
    return deviations(outs, refs, normals_floor_deg(data, refs)), launched
