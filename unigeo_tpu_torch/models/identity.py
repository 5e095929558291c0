"""GT-passthrough model, port of ``unigeo_tpu/models/identity.py``.

It predicts the ground truth it is given, so the eval pipeline must score it
perfectly; the optional noise (``depth_noise``, ``normal_noise_deg``,
``pose_noise``) comes from a numpy generator seeded with ``seed`` and
advances as the JAX package's does, so both give the same predictions.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from unigeo_tpu_torch.data.sample import prepare_gt_label
from unigeo_tpu_torch.registry import MODELS


@MODELS.register("IdentityModel")
class IdentityModel:
    def __init__(
        self,
        depth_noise: float = 0.0,
        normal_noise_deg: float = 0.0,
        pose_noise: float = 0.0,
        seed: int = 0,
        **_: Dict,
    ):
        self.depth_noise = depth_noise
        self.normal_noise_deg = normal_noise_deg
        self.pose_noise = pose_noise
        self.rng = np.random.default_rng(seed)

    def forward(self, data: Dict[str, Any]) -> Dict[str, Any]:
        gt = prepare_gt_label(data)
        depths = gt["gt_depths"].copy()
        normals = gt["gt_normals"].copy()
        poses = gt["gt_poses"].copy()
        world_pts = gt["gt_world_pts"].copy()

        if self.depth_noise > 0:
            depths = depths * (
                1.0 + self.rng.normal(0, self.depth_noise, depths.shape)
            ).astype(np.float32)
        if self.normal_noise_deg > 0:
            jitter = self.rng.normal(
                0, np.deg2rad(self.normal_noise_deg), normals.shape
            ).astype(np.float32)
            normals = normals + jitter
            normals = normals / np.maximum(
                np.linalg.norm(normals, axis=-1, keepdims=True), 1e-8
            )
        if self.pose_noise > 0:
            poses[:, :3, 3] += self.rng.normal(
                0, self.pose_noise, poses[:, :3, 3].shape
            ).astype(np.float32)

        return {
            "pred_world_pts": world_pts,
            "pred_depths": depths,
            "pred_normals": normals,
            "pred_poses": poses,
        }

    def forward_batch(self, datas) -> list:
        """The batched contract (so ``data_parallel=True`` is accepted, as in
        the JAX package): ``forward`` on each clip in order."""
        return [self.forward(d) for d in datas]
