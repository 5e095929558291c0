"""The model interface, port of ``unigeo_tpu/models/base.py``.

A model is constructed with ``**model_params`` from the config and exposes
``forward(data) -> dict`` with any subset of:

  pred_world_pts  [Nf, H, W, 3]  world-space pointmaps, OpenCV, frame 0 = world
  pred_depths     [Nf, H, W]     per-frame depth
  pred_normals    [Nf, H, W, 3]  camera-space normals, OpenGL convention
  pred_poses      [Nf, 4, 4]     camera-to-world, OpenCV

as numpy arrays on the host, whatever device the model runs on.
"""

from __future__ import annotations

from typing import Any, Dict, Protocol, runtime_checkable

PREDICTION_KEYS = ("pred_world_pts", "pred_depths", "pred_normals", "pred_poses")


@runtime_checkable
class GeometryModel(Protocol):
    def forward(self, data: Dict[str, Any]) -> Dict[str, Any]:
        ...
