"""Processes and ranks, port of ``unigeo_tpu/parallel/multihost.py``.

The JAX package's multi-host touch points, on ``torch.distributed``:

  * ``initialize_distributed()`` starts the default process group from
    explicit arguments, else from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``); with neither it
    returns False and the single-process path is unchanged.
  * ``make_hybrid_mesh()``: dp spans the nodes, sp x tp stay inside one
    node's ``LOCAL_WORLD_SIZE`` ranks.
  * ``shard_indices`` (round-robin clip indices), ``process_allgather_rows``
    (the per-sequence metric rows of every rank, in rank order) and
    ``is_primary``: the eval over several processes.

The backend is chosen by one stated rule (``backend_for``): NCCL when the
ranks run on the card and each rank of a node has a card of its own; gloo
on the CPU and when ranks share a card (NCCL refuses two ranks on one
device; ``comm.py`` then stages CUDA tensors through the host).  Nothing
is swapped when a backend fails: the error stands.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def backend_for(device="cuda", local_world_size: Optional[int] = None) -> str:
    """"nccl" when ``device`` is the card and the node's ranks
    (``local_world_size``, by default ``LOCAL_WORLD_SIZE``, else 1) are no
    more than its cards; "gloo" otherwise."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local = local_world_size or _env_int("LOCAL_WORLD_SIZE") or 1
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` for "cuda"
    (ranks beyond the node's cards share them), ``device`` otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        local = _env_int("LOCAL_RANK")
        if local is None:
            local = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def initialize_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                           rank: Optional[int] = None, backend: Optional[str] = None,
                           device="cuda") -> bool:
    """Start the default process group when the ranks are known.

    Resolution order: the explicit arguments, then torchrun's ``RANK`` /
    ``WORLD_SIZE`` / ``MASTER_ADDR`` (``init_method="env://"``).  ``backend``
    defaults to ``backend_for(device)``; on the card the rank's device is
    set first (``rank_device``).  Returns True when a group is up (also one
    started before), False on the unchanged single-process path."""
    if dist.is_initialized():
        return True
    rank = rank if rank is not None else _env_int("RANK")
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    if init_method is None or world_size is None or rank is None:
        return False
    backend = backend or backend_for(device)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return True


def world() -> Tuple[int, int]:
    """(ranks, this rank): (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_hybrid_mesh(ici_shape: Optional[Tuple[int, int]] = None, device="cuda"):
    """A mesh whose dp dim spans the nodes while each sp x tp block is
    consecutive ranks of one node (``LOCAL_WORLD_SIZE`` of them, all by
    default).  ici_shape: (sp, tp), default (1, 1), pure dp."""
    from unigeo_tpu_torch.parallel.mesh import make_mesh

    n, _ = world()
    sp, tp = ici_shape or (1, 1)
    local = _env_int("LOCAL_WORLD_SIZE") or n
    if local % (sp * tp) or n % (sp * tp):
        raise ValueError(f"an sp x tp block of {sp} x {tp} does not fit a node of {local} "
                         f"ranks ({n} in all)")
    return make_mesh(n, shape=(n // (sp * tp), sp, tp), device=device)


def shard_indices(n: int) -> List[int]:
    """This process's share of eval-clip indices (round-robin, so resumable
    CSV rows interleave deterministically)."""
    p, pid = world()
    return [i for i in range(n) if i % p == pid]


def process_allgather_rows(rows: List[Dict]) -> List[Dict]:
    """Every process's metric rows (picklable dicts), in process order;
    the identity with one process."""
    if world()[0] == 1:
        return list(rows)
    from unigeo_tpu_torch.parallel.comm import all_gather_objects

    return [row for part in all_gather_objects(list(rows)) for row in part]


def is_primary() -> bool:
    return world()[1] == 0
