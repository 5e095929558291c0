"""The collectives the port's parallel executors use, on ``torch.distributed``.

The JAX package is single-controller: XLA inserts the collectives from the
arrays' shardings.  The port is multi-controller (one process a rank), so
every executor calls these by hand.

Transport.  NCCL moves CUDA tensors between ranks that each have their own
card.  Gloo moves CPU tensors; it has no CUDA ``all_gather``, ``send`` or
``recv``, so a CUDA tensor under gloo is staged through a pinned host buffer
(copied to the host, moved, copied back to its device).  That is how ranks
that share one card talk (NCCL refuses two ranks on one device): the work
stays on the card and only the bytes cross the host.  ``backend_of`` names
the transport a group uses.

Data moves as raw bytes (a ``uint8`` view), so every dtype crosses every
backend; nothing here sums (the sharded group norm merges gathered moments
itself, in f32).

``FrameShard`` is the handle the model layers read inside
``models/layers.py::frames_sharded``: a clip's frames split in equal
consecutive blocks over the ranks of one group.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def backend_of(group=None) -> str:
    """"nccl" or "gloo": the backend of ``group`` (the default group)."""
    return str(dist.get_backend(group))


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and backend_of(group) != "nccl"


def _raw(t: torch.Tensor) -> torch.Tensor:
    """t's bytes, a flat uint8 view of a contiguous copy."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _host(raw: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a flat CUDA byte tensor."""
    host = torch.empty(raw.numel(), dtype=torch.uint8, pin_memory=True)
    host.copy_(raw)
    return host


def _from_raw(raw: torch.Tensor, like_dtype: torch.dtype, shape, device) -> torch.Tensor:
    return raw.to(device).view(like_dtype).reshape(shape)


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in the
    group's rank order, on ``t``'s device."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    raw = _raw(t)
    if _staged(t, group):
        raw = _host(raw)
    bufs = [torch.empty_like(raw) for _ in range(n)]
    dist.all_gather(bufs, raw, group=group)
    parts = [_from_raw(b, t.dtype, t.shape, t.device) for b in bufs]
    return torch.cat(parts, dim=dim)


def gather_stacked(t: torch.Tensor, group=None) -> torch.Tensor:
    """[n, *t.shape]: every rank's ``t`` stacked in the group's rank order."""
    return all_gather(t[None], group, dim=0)


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """The global rank ``src``'s ``t`` on every rank of ``group`` (``t``
    gives the shape and dtype elsewhere), on ``t``'s device."""
    if dist.get_world_size(group) == 1:
        return t
    # a copy either way: the receiving ranks' ``t`` is left as it was
    raw = _host(_raw(t)) if _staged(t, group) else _raw(t).clone()
    dist.broadcast(raw, src=src, group=group)
    return _from_raw(raw, t.dtype, t.shape, t.device)


class Send:
    """An ``isend`` in flight: the request and the buffer it reads."""

    def __init__(self, t: torch.Tensor, dst: int, tag: int, group=None):
        raw = _raw(t)
        self.buf = _host(raw) if _staged(t, group) else raw
        self.work = dist.isend(self.buf, dst=dst, group=group, tag=tag)

    def wait(self) -> None:
        self.work.wait()


class Recv:
    """An ``irecv`` in flight; ``wait()`` returns the tensor on ``device``."""

    def __init__(self, shape: Sequence[int], dtype: torch.dtype, device, src: int, tag: int,
                 group=None):
        self.shape, self.dtype, self.device = tuple(shape), dtype, torch.device(device)
        nbytes = torch.empty((), dtype=dtype).element_size()
        for s in self.shape:
            nbytes *= s
        pin = self.device.type == "cuda"
        staged = pin and backend_of(group) != "nccl"
        self.buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=staged,
                               device="cpu" if staged or not pin else self.device)
        self.work = dist.irecv(self.buf, src=src, group=group, tag=tag)

    def wait(self) -> torch.Tensor:
        self.work.wait()
        return _from_raw(self.buf, self.dtype, self.shape, self.device)


def all_gather_objects(obj, group=None) -> List:
    """Every rank's picklable ``obj``, in the group's rank order."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


class FrameShard:
    """A clip's frames split over the ranks of ``group`` in equal
    consecutive blocks: rank i of the group holds frames [i * n, (i + 1) *
    n) of every clip.  With no group it is one rank holding every frame."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group) if group is not None else 1
        self.index = dist.get_rank(group) if group is not None else 0
        self.first_rank = dist.get_global_rank(group, 0) if group is not None else 0

    def offset(self, local_frames: int) -> int:
        """The global index of this rank's first frame."""
        return self.index * local_frames

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's block of ``x`` along ``dim``, in frame order."""
        return x if self.size == 1 else all_gather(x, self.group, dim)

    def stacked(self, x: torch.Tensor) -> torch.Tensor:
        """[size, *x.shape], the ranks' ``x`` in frame order."""
        return x[None] if self.size == 1 else gather_stacked(x, self.group)

    def from_first(self, x: torch.Tensor) -> torch.Tensor:
        """The first rank's ``x`` (it holds frame 0) on every rank."""
        return x if self.size == 1 else broadcast(x, self.first_rank, self.group)

    def halo(self, x: torch.Tensor, dim: int, width: int) -> torch.Tensor:
        """``x`` with ``width`` frames of each neighbour's block around it
        along ``dim`` (zeros before the clip's first frame and after its
        last): what a convolution over the frames with zero padding
        ``width`` reads."""
        n = x.shape[dim]
        if width > n:
            raise ValueError(f"a halo of {width} frames needs at least {width} frames a rank, "
                             f"not {n}")
        zeros = torch.zeros_like(x.narrow(dim, 0, width))
        if self.size == 1:
            return torch.cat([zeros, x, zeros], dim)
        ends = self.stacked(torch.cat([x.narrow(dim, 0, width), x.narrow(dim, n - width, width)],
                                      dim))
        i = self.index
        before = ends[i - 1].narrow(dim, width, width) if i > 0 else zeros
        after = ends[i + 1].narrow(dim, 0, width) if i + 1 < self.size else zeros
        return torch.cat([before, x, after], dim)


def split_frames(x: torch.Tensor, shard: FrameShard, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (its length divisible by
    the shard's size, as the JAX package's ``P("sp")`` requires)."""
    t = x.shape[dim]
    if t % shard.size:
        raise ValueError(f"{t} frames do not split evenly over {shard.size} ranks")
    n = t // shard.size
    return x.narrow(dim, shard.index * n, n)


def new_groups(rank_lists: Sequence[Sequence[int]]):
    """One ``dist.new_group`` per list (every rank calls this with the same
    lists, as ``new_group`` requires); this rank's group, or None."""
    mine = None
    me = dist.get_rank()
    for ranks in rank_lists:
        g = dist.new_group(ranks=list(ranks))
        if me in ranks:
            mine = g
    return mine
