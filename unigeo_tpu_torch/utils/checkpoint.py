"""Checkpoints of the port, counterpart of ``unigeo_tpu/utils/checkpoint.py``.

A checkpoint is one file written by ``torch.save``: a nested dict of state
dicts with the port's (upstream) key names, the layout the trainer of each
family exports and its eval adapter loads through ``checkpoint_path``:

  SVD family (DepthCrafter, UniGeo(Cam), StableNormal, ChronoDepth,
  DepthAnyVideo)        {"unet": ..., "vae": ..., "clip": ...}
  Aether                {"vae": ..., "dit": ...}
  Spann3R, Dust3R, Cut3R, VideoDepthAnything
                        the network's state dict

``load_params`` reads with ``weights_only=True`` straight onto the given
device (no host copy of the weights).  ``save_params`` writes to a hidden
temporary name beside the target and renames it, so a save that is cut
leaves nothing that ``TrainStateSaver.list_steps`` reads as a checkpoint.
"""

from __future__ import annotations

import os
import re
from typing import Any, Mapping

import torch
import torch.nn as nn

_STEP_RE = re.compile(r"state-iter-(\d+)$")


class TrainStateSaver:
    """Rotating checkpoints ``state-iter-{step:09d}`` under ``base_dir``,
    the ``max_to_keep`` newest kept."""

    def __init__(self, base_dir: str, max_to_keep: int = 3):
        self.base_dir = os.path.abspath(base_dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.base_dir, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.base_dir, f"state-iter-{step:09d}")

    def list_steps(self):
        steps = []
        for name in os.listdir(self.base_dir):
            m = _STEP_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def save(self, state: Any, step: int) -> str:
        path = self.path(step)
        save_params(state, path)
        for old in self.list_steps()[: -self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def load_latest(self, device=None):
        """(params, step) of the newest checkpoint."""
        steps = self.list_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.base_dir}")
        return load_params(self.path(steps[-1]), device), steps[-1]


def save_params(params: Any, path: str) -> None:
    """``torch.save`` of ``params`` to ``path``, atomically."""
    path = os.path.abspath(path)
    tmp = os.path.join(os.path.dirname(path), f".{os.path.basename(path)}.tmp-{os.getpid()}")
    try:
        torch.save(params, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_params(path: str, device=None) -> Any:
    """The nested dict of tensors saved at ``path``, its tensors on
    ``device`` (where they were saved when None)."""
    return torch.load(path, map_location=device, weights_only=True)


def load_strict(module: nn.Module, state_dict: Mapping[str, torch.Tensor],
                what: str = "checkpoint") -> nn.Module:
    """``module.load_state_dict(state_dict, strict=True)``, naming the
    missing and unexpected keys and the mismatched shapes when they differ
    (each tensor is copied into the module's storage at its dtype)."""
    own = module.state_dict()
    missing = sorted(set(own) - set(state_dict))
    unexpected = sorted(set(state_dict) - set(own))
    shapes = sorted(k for k in set(own) & set(state_dict)
                    if tuple(own[k].shape) != tuple(state_dict[k].shape))
    if missing or unexpected or shapes:
        raise KeyError(
            f"{what} does not fit {type(module).__name__}: {len(missing)} missing "
            f"{missing[:8]}, {len(unexpected)} unexpected {unexpected[:8]}, "
            f"{len(shapes)} of another shape "
            f"{[(k, tuple(state_dict[k].shape), tuple(own[k].shape)) for k in shapes[:4]]}")
    module.load_state_dict(state_dict, strict=True)
    return module

