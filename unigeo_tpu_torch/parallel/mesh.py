"""The device mesh, port of ``unigeo_tpu/parallel/mesh.py``.

Axes, as in the JAX package:

  dp   data (clips)      sp   sequence (frames)      tp   tensor (weights)

The JAX package is single-controller: one process sees n devices and XLA
derives the collectives from the arrays' shardings.  The port is
multi-controller: one process a rank, a ``torch.distributed.device_mesh.
DeviceMesh`` over the ranks with dims ("dp", "sp", "tp"), whose per-dim
process groups the executors hand to the collectives of ``comm.py``.  Rank
r sits at (r // (sp * tp), r // tp % sp, r % tp), so an sp x tp block is
consecutive ranks (one node's, under torchrun).

``make_mesh`` initialises the default process group first if it is not
(``multihost.initialize_distributed``; a single process gets a one-rank
gloo group over an in-process store) with the backend ``multihost.
backend_for`` states: NCCL when every rank has a card of its own, gloo
otherwise.  (``init_device_mesh("cuda")`` alone would pick NCCL and put
rank r on ``cuda:{r % count}``.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("dp", "sp", "tp")


def _factor(n: int) -> Tuple[int, int, int]:
    """Split n devices into (dp, sp, tp) preferring data parallelism."""
    tp = 2 if n % 2 == 0 and n >= 8 else 1
    rem = n // tp
    sp = 2 if rem % 2 == 0 and rem >= 4 else 1
    dp = rem // sp
    return dp, sp, tp


def mesh_shape(n: int, shape: Optional[Tuple[int, int, int]] = None) -> Tuple[int, int, int]:
    """The (dp, sp, tp) shape ``make_mesh`` lays n ranks out in."""
    shape = tuple(shape) if shape is not None else _factor(n)
    if len(shape) != 3 or shape[0] * shape[1] * shape[2] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return shape


def make_mesh(n_devices: Optional[int] = None, shape: Optional[Tuple[int, int, int]] = None,
              axis_names: Sequence[str] = AXES, device: str = "cuda"):
    """A ``DeviceMesh`` of ``n_devices`` ranks (all of them by default) in
    ``shape`` (``_factor``'s by default), dims named ``axis_names``.

    ``device`` is the ranks' device type ("cuda", or "cpu" when asked for);
    every rank calls this with the same arguments."""
    from torch.distributed.device_mesh import DeviceMesh

    from unigeo_tpu_torch.parallel.multihost import initialize_distributed

    if not initialize_distributed(device=device):
        # one process: a one-rank gloo group over an in-process store
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} ranks over a world of {world}: the port runs one "
                         f"process per device")
    shape = mesh_shape(n, shape)
    mesh_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(mesh_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis: str) -> int:
    """The size of ``mesh``'s dim ``axis`` (1 for a dim it does not have)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


@dataclass(frozen=True)
class Placement:
    """What a rank holds of an array laid out over a mesh: the process group
    of the mesh dims it is split over (None: not split, the whole array on
    every rank), this rank's index in that group and the group's size."""

    group: Optional[object]
    index: int
    size: int

    @property
    def replicated(self) -> bool:
        return self.size == 1


def replicated(mesh) -> Placement:
    """The whole array on every rank."""
    return Placement(None, 0, 1)


def data_sharding(mesh, batch_axes: Tuple[Optional[str], ...]) -> Placement:
    """The array's leading dim split over the mesh dim ``batch_axes[0]``
    (one named dim; None: replicated), as ``P(*batch_axes)`` splits it."""
    axes = [a for a in batch_axes if a is not None]
    if not axes:
        return replicated(mesh)
    if len(axes) > 1 or batch_axes[0] is None:
        raise NotImplementedError(f"only the leading dim over one mesh dim, not {batch_axes}")
    sub = mesh[axes[0]]
    return Placement(sub.get_group(), sub.get_local_rank(), sub.size())
