"""Device-resident plumbing of the pointmap adapters, port of
``unigeo_tpu/models/pointmap/adapter.py``: raw frames in, the network's world
pointmaps through camera recovery, depths, OpenGL normals and c2w poses, all
on the device; the host sees the clip once on the way in (``raw_clip``) and
the output dict once on the way out (``fetch_outputs``).

``RandomInitAdapter`` is the construction the port's pointmap-family
adapters share: the network built on the device with random weights from a
generator seeded with ``seed`` (checkpoints are ROADMAP queue 1 item 9),
cast to the compute dtype, loadable from the weight bridge.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from unigeo_tpu_torch import coords
from unigeo_tpu_torch.device import resolve_device
from unigeo_tpu_torch.models.camera_solver import solve_depth_and_camera_from_pointmaps
from unigeo_tpu_torch.ops.normals import surface_normals_from_points

# OpenCV -> OpenGL normal flip (normals stay OpenGL in the output contract)
OPENGL_FLIP = (1.0, -1.0, -1.0)
# the bulky fields an f16 transfer narrows (depths and poses stay f32)
TRANSFER_DOWNCAST_KEYS = ("pred_world_pts", "pred_normals", "pred_conf")


def raw_clip(data: Dict[str, Any]) -> np.ndarray:
    """data["images"] -> contiguous f32 [T, 3, H, W] 0..255."""
    return np.ascontiguousarray(np.asarray(data["images"], dtype=np.float32))


def frames_from_raw(raw: torch.Tensor) -> torch.Tensor:
    """raw [T, 3, H, W] f32 0..255 -> [T, H, W, 3] in 0..1, on raw's device."""
    return raw.permute(0, 2, 3, 1) / 255.0


def outputs_from_world_pts(pts: torch.Tensor, conf: torch.Tensor) -> Dict[str, torch.Tensor]:
    """World pointmaps [T, H, W, 3] (+ conf) -> the adapter's output dict:
    camera recovery, depths, OpenGL normals and c2w (OpenCV) poses, in f32."""
    cam_pts, extrinsics, _ = solve_depth_and_camera_from_pointmaps(pts)
    flip = torch.tensor(OPENGL_FLIP, dtype=cam_pts.dtype, device=cam_pts.device)
    return {
        "pred_world_pts": pts,
        "pred_depths": cam_pts[..., 2],
        "pred_normals": surface_normals_from_points(cam_pts) * flip,
        "pred_poses": coords.se3_inverse(extrinsics),
        "pred_conf": conf,
    }


def resolve_compute_dtype(arg: Optional[str]):
    """The network's dtype: None (f32, the default) or torch.bfloat16, from
    ``UNIGEO_COMPUTE_DTYPE`` if set, else ``arg``.  The geometry after the
    network always runs in f32."""
    val = os.environ.get("UNIGEO_COMPUTE_DTYPE") or arg
    if val in (None, "", "float32", "f32"):
        return None
    if val in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"compute_dtype must be float32 or bfloat16, got {val!r}")


def resolve_transfer_dtype(arg: Optional[str]):
    """None (f32 transfers) or torch.float16, from ``UNIGEO_TRANSFER_DTYPE``
    if set, else ``arg``: the bulky fields cross to the host in f16 and are
    widened back to f32 there, as in the JAX package."""
    val = os.environ.get("UNIGEO_TRANSFER_DTYPE") or arg
    if val in (None, "", "float32", "f32"):
        return None
    if val in ("float16", "f16"):
        return torch.float16
    raise ValueError(f"transfer_dtype must be float32 or float16, got {val!r}")


def fetch_outputs(outs: Dict[str, torch.Tensor], transfer_dtype=None) -> Dict[str, np.ndarray]:
    """The output dict on the host, the bulky fields through
    ``transfer_dtype`` (f16 widened back to f32) when one is given."""
    host = {}
    for k, v in outs.items():
        if transfer_dtype is not None and k in TRANSFER_DOWNCAST_KEYS:
            v = v.to(transfer_dtype)
        host[k] = v.cpu().numpy().astype(np.float32, copy=False)
    return host


class BatchedPointmapForward:
    """``forward_batch`` of the pointmap adapters.  On one GPU the evaluator
    hands over one clip at a time (the data-parallel executor over several
    GPUs is ROADMAP queue 1 item 11), and a list of clips is scored one by
    one."""

    @property
    def eval_batch_size(self) -> int:
        return 1

    def forward_batch(self, datas):
        return [self.forward(d) for d in datas]


# learned tables initialised N(0, 0.02), as the JAX package's normal(0.02):
# Cut3R's state tokens, VideoDepthAnything's class token and position table
_TABLES = ("state_tokens", "cls_token", "pos_embed")


@torch.no_grad()
def init_network_(network: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights in place with the JAX package's initialisers
    (lecun-normal kernels, zero biases, unit LayerNorm scales, N(0, 0.02)
    tables); a transposed conv's fan-in is in_channels x kh x kw, as flax
    counts it."""
    from unigeo_tpu_torch.models.depthcrafter.pipeline import init_random_

    init_random_(network, generator)
    for mod in network.modules():
        if isinstance(mod, nn.ConvTranspose2d):
            w = mod.weight  # [in, out, kh, kw]
            w.normal_(0.0, (w.shape[0] * w.shape[2] * w.shape[3]) ** -0.5, generator=generator)
            mod.bias.zero_()
        for pname, p in mod.named_parameters(recurse=False):
            if pname in _TABLES:
                p.normal_(0.0, 0.02, generator=generator)
    return network


class RandomInitAdapter(BatchedPointmapForward):
    """``network`` built from ``network_cls(**network_config)`` on the
    device, random weights drawn from a generator there, cast to the compute
    dtype (f32 unless ``compute_dtype`` or ``UNIGEO_COMPUTE_DTYPE`` says
    bfloat16, where ``takes_dtypes``); ``forward`` is ``forward_tensors``
    fetched to the host through the transfer dtype."""

    network_cls: type
    # False where the JAX adapter runs in f32 whatever the dtype keys say
    takes_dtypes = True

    def _build(self, network_config, checkpoint_path, seed, compute_dtype, transfer_dtype,
               device):
        if checkpoint_path:
            raise NotImplementedError(
                f"checkpoint_path={checkpoint_path!r}: checkpoint IO is not ported yet "
                "(ROADMAP queue 1 item 9); leave it null for random weights")
        self.device = resolve_device(device)
        self.compute_dtype = self.transfer_dtype = None
        if self.takes_dtypes:
            self.compute_dtype = resolve_compute_dtype(compute_dtype)
            self.transfer_dtype = resolve_transfer_dtype(transfer_dtype)
        with torch.device("meta"):
            self.network = self.network_cls(**(network_config or {}))
        self.network.to_empty(device=self.device).eval().requires_grad_(False)
        init_network_(self.network, torch.Generator(device=self.device).manual_seed(seed))
        self._cast()

    def _cast(self):
        if self.compute_dtype is not None:
            self.network.to(self.compute_dtype)

    def load_state_dict(self, state_dict) -> "RandomInitAdapter":
        """Load the network's weights strictly (e.g. from
        ``utils/weights.py::pointmap_state_dict``), at the compute dtype."""
        self.network.load_state_dict(state_dict, strict=True)
        self._cast()
        return self

    def frames(self, data: Dict[str, Any]) -> torch.Tensor:
        """The clip as [T, H, W, 3] in 0..1 on the device, at the compute dtype."""
        frames = frames_from_raw(torch.from_numpy(raw_clip(data)).to(self.device))
        return frames if self.compute_dtype is None else frames.to(self.compute_dtype)

    def forward(self, data: Dict[str, Any]) -> Dict[str, Any]:
        return fetch_outputs(self.forward_tensors(data), self.transfer_dtype)
