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

Gathers and hand-offs move raw bytes (a ``uint8`` view), so every dtype
crosses every backend.  The sums (``all_reduce``, ``reduce_scatter``,
``all_reduce_mean_``) are one ``dist.all_reduce`` of an f32 copy (f64 stays
f64), rounded once into the input's dtype.  A CUDA tensor under gloo is
cast to f32 and summed on the host in ``STAGE_CHUNK`` pieces through reused
pinned buffers, so the card holds one piece beyond the tensor itself.

Training needs each collective's adjoint, so every one the model layers
call has a ``torch.autograd.Function`` here whose backward is written out:

  sp (a clip's frames over the group)      forward          backward
    ``GatherFrames``   keys / values        all-gather       reduce-scatter (sum):
                                                             every rank's queries
                                                             read every frame
    ``Halo``           temporal convs       neighbours'      each halo frame's
                                            edge frames      gradient back to the
                                                             rank that sent it
    ``FromFirst``      frame 0's context    broadcast        the group's sum to the
                                                             first rank, zeros
                                                             elsewhere
    ``Stacked``        group-norm moments   stacked gather   reduce-scatter (sum)
  tp (Megatron's four)
    ``CopyToGroup``    column input         identity         all-reduce
    ``ReduceFromGroup`` row output          all-reduce       identity
    ``GatherFromGroup`` column output       all-gather       this rank's slice
                                                             (every rank consumes
                                                             the gathered tensor
                                                             alike: no sum)
    ``ScatterToGroup``  row input           this rank's      all-gather
                                            slice
  dp
    ``AllReduceSum``   a batch-wide sum     all-reduce       all-reduce (every
                       (the pointmap loss)                   rank's loss reads the
                                                             sum; the trainer
                                                             averages the ranks'
                                                             gradients)

``FrameShard``'s methods and the layers' tp helpers always call these
``Function``s: under ``torch.no_grad`` or ``inference_mode`` a ``Function``
runs only its forward, the plain collective, and records nothing.

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


# bytes a staged gather moves through the host at a time: pinned buffers
# of this size are allocated once and reused (page-locking a multi-GB
# buffer for each call, such as a gradient bucket, costs seconds)
STAGE_CHUNK = 64 << 20


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in the
    group's rank order, on ``t``'s device."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    raw = _raw(t)
    if _staged(t, group):
        parts = _staged_all_gather(raw, n, group)
        return torch.cat([p.view(t.dtype).reshape(t.shape) for p in parts], dim=dim)
    bufs = [torch.empty_like(raw) for _ in range(n)]
    dist.all_gather(bufs, raw, group=group)
    return torch.cat([b.view(t.dtype).reshape(t.shape) for b in bufs], dim=dim)


def _staged_all_gather(raw: torch.Tensor, n: int, group) -> torch.Tensor:
    """[n, bytes] on ``raw``'s card: every rank's flat CUDA bytes, moved
    through pinned host buffers in STAGE_CHUNK pieces."""
    size = raw.numel()
    out = torch.empty((n, size), dtype=torch.uint8, device=raw.device)
    chunk = min(size, STAGE_CHUNK)
    send = torch.empty(chunk, dtype=torch.uint8, pin_memory=True)
    recv = [torch.empty(chunk, dtype=torch.uint8, pin_memory=True) for _ in range(n)]
    for start in range(0, size, chunk):
        m = min(chunk, size - start)
        send[:m].copy_(raw[start:start + m])
        dist.all_gather([r[:m] for r in recv], send[:m], group=group)
        for r, buf in enumerate(recv):
            out[r, start:start + m].copy_(buf[:m])
    return out


def _sum_dtype(dtype: torch.dtype) -> torch.dtype:
    return dtype if dtype in (torch.float32, torch.float64) else torch.float32


def _reduce_(t: torch.Tensor, group, divisor: int = 1) -> None:
    """A contiguous ``t`` replaced in place by the sum over the group's
    ranks of ``t``, divided by ``divisor``: added in f32 at least and
    rounded once into ``t``'s dtype."""
    dtype = _sum_dtype(t.dtype)
    flat = t.view(-1)
    if not _staged(t, group):
        acc = flat.to(dtype)
        dist.all_reduce(acc, group=group)
        if divisor != 1:
            acc.div_(divisor)
        if acc.data_ptr() != flat.data_ptr():
            flat.copy_(acc)
        return
    size = flat.numel()
    chunk = min(size, STAGE_CHUNK // torch.empty((), dtype=dtype).element_size())
    host = torch.empty(chunk, dtype=dtype, pin_memory=True)
    card = torch.empty(chunk, dtype=dtype, device=t.device)
    for start in range(0, size, chunk):
        m = min(chunk, size - start)
        card[:m].copy_(flat[start:start + m])
        host[:m].copy_(card[:m])
        dist.all_reduce(host[:m], group=group)
        card[:m].copy_(host[:m])
        if divisor != 1:
            card[:m].div_(divisor)
        flat[start:start + m].copy_(card[:m])


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``t`` (equal shapes) on every rank, added in
    f32 at least and returned in ``t``'s dtype on its device (a new
    tensor)."""
    if dist.get_world_size(group) == 1:
        return t
    out = t.detach().clone(memory_format=torch.contiguous_format)
    _reduce_(out, group)
    return out


def reduce_scatter(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The sum over ranks of ``t`` (equal shapes), split in the group's
    size equal blocks along ``dim``: rank i gets block i of the sum.  Added in
    f32 at least (as ``all_reduce``, which it is followed by this rank's
    slice: gloo has no reduce-scatter of its own)."""
    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} does not split over "
                         f"{n} ranks")
    m = t.shape[dim] // n
    return all_reduce(t, group).narrow(dim, dist.get_rank(group) * m, m).contiguous()


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Each tensor replaced in place by its mean over the group's ranks: one
    flattened bucket per dtype, one sum each (``_reduce_``)."""
    n = dist.get_world_size(group)
    if n == 1:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        _reduce_(flat, group, divisor=n)
        start = 0
        for t in ts:
            t.copy_(flat[start:start + t.numel()].view_as(t))
            start += t.numel()


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


class GatherFrames(torch.autograd.Function):
    """sp: every rank's block along ``dim`` (``all_gather``); backward the
    sum over ranks of the gathered gradient, this rank's block of it.

    ``GatherFrames.apply(x, group, dim)``."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class Halo(torch.autograd.Function):
    """sp: ``FrameShard.halo``'s forward; backward this rank's own frames'
    gradient plus the gradients its neighbours' halos took from its edge
    frames.  ``Halo.apply(x, shard, dim, width)``."""

    @staticmethod
    def forward(ctx, x, shard, dim, width):
        ctx.shard, ctx.dim, ctx.width, ctx.n = shard, dim, width, x.shape[dim]
        return shard._halo(x, dim, width)

    @staticmethod
    def backward(ctx, g):
        shard, dim, w, n = ctx.shard, ctx.dim, ctx.width, ctx.n
        own = g.narrow(dim, w, n).clone()
        # [size, ...]: every rank's (before, after) halo gradients
        sent = gather_stacked(torch.cat([g.narrow(dim, 0, w), g.narrow(dim, w + n, w)], dim),
                              shard.group)
        i = shard.index
        if i > 0:  # rank i - 1's after-halo read this rank's first frames
            own.narrow(dim, 0, w).add_(sent[i - 1].narrow(dim, w, w))
        if i + 1 < shard.size:  # rank i + 1's before-halo read its last frames
            own.narrow(dim, n - w, w).add_(sent[i + 1].narrow(dim, 0, w))
        return own, None, None, None


class FromFirst(torch.autograd.Function):
    """sp: the group's first rank's ``x`` on every rank (``broadcast``);
    backward the sum over ranks to the first rank, zeros elsewhere.
    ``FromFirst.apply(x, shard)``."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return broadcast(x, shard.first_rank, shard.group)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce(g, ctx.shard.group)
        return (total if ctx.shard.index == 0 else torch.zeros_like(total)), None


class Stacked(torch.autograd.Function):
    """sp: [size, *x.shape], every rank's ``x`` stacked (``gather_stacked``);
    backward the sum over ranks of row i of the gradient, on rank i.
    ``Stacked.apply(x, group)``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_stacked(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, 0)[0], None


class CopyToGroup(torch.autograd.Function):
    """tp, a column-parallel layer's input: identity; backward the sum over
    the group (each rank's weights saw the whole input).
    ``CopyToGroup.apply(x, group)``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class ReduceFromGroup(torch.autograd.Function):
    """tp, a row-parallel layer's partial output: the sum over the group;
    backward identity.  ``ReduceFromGroup.apply(x, group)``."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class GatherFromGroup(torch.autograd.Function):
    """tp, a column-parallel layer's output: every rank's features
    concatenated along ``dim``; backward this rank's slice of the gradient,
    not summed (every rank consumes the gathered tensor alike).
    ``GatherFromGroup.apply(x, group, dim)``."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None


class ScatterToGroup(torch.autograd.Function):
    """tp, a row-parallel layer's input: this rank's equal slice along
    ``dim``; backward every rank's slice gathered.
    ``ScatterToGroup.apply(x, group, dim)``."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group_slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class AllReduceSum(torch.autograd.Function):
    """dp, a sum over the whole batch that every rank's loss reads: the sum
    over the group; backward the sum over the group too (the adjoint of a
    sum whose result every rank uses; with the trainer averaging the ranks'
    gradients, each rank's terms then get the global loss's gradient).
    ``AllReduceSum.apply(x, group)``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def group_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``, split in the group's size
    equal blocks (raises, naming the shape, where it does not divide)."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    m = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * m, m)


class FrameShard:
    """A clip's frames split over the ranks of ``group`` in equal
    consecutive blocks: rank i of the group holds frames [i * n, (i + 1) *
    n) of every clip.  With no group it is one rank holding every frame.

    Each method past one rank is its ``Function`` above (its backward
    recorded where autograd records)."""

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
        if self.size == 1:
            return x
        return GatherFrames.apply(x, self.group, dim)

    def stacked(self, x: torch.Tensor) -> torch.Tensor:
        """[size, *x.shape], the ranks' ``x`` in frame order."""
        if self.size == 1:
            return x[None]
        return Stacked.apply(x, self.group)

    def from_first(self, x: torch.Tensor) -> torch.Tensor:
        """The first rank's ``x`` (it holds frame 0) on every rank."""
        if self.size == 1:
            return x
        return FromFirst.apply(x, self)

    def halo(self, x: torch.Tensor, dim: int, width: int) -> torch.Tensor:
        """``x`` with ``width`` frames of each neighbour's block around it
        along ``dim`` (zeros before the clip's first frame and after its
        last): what a convolution over the frames with zero padding
        ``width`` reads."""
        n = x.shape[dim]
        if width > n:
            raise ValueError(f"a halo of {width} frames needs at least {width} frames a rank, "
                             f"not {n}")
        if self.size == 1:
            return self._halo(x, dim, width)
        return Halo.apply(x, self, dim, width)

    def _halo(self, x: torch.Tensor, dim: int, width: int) -> torch.Tensor:
        n = x.shape[dim]
        zeros = torch.zeros_like(x.narrow(dim, 0, width))
        if self.size == 1:
            return torch.cat([zeros, x, zeros], dim)
        ends = gather_stacked(torch.cat([x.narrow(dim, 0, width),
                                         x.narrow(dim, n - width, width)], dim), self.group)
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
