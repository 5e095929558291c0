"""Brute-force nearest neighbours, port of ``unigeo_tpu/ops/knn.py``.

An exact scan of the distance matrix in chunks of queries, as in the JAX
package: at the point counts the metrics use (at most ~10k after
downsampling) one [chunk, 3] x [3, M] product per chunk is cheap on the
card, and no tree is needed.  Squared distances use the same expansion
||q||^2 + ||r||^2 - 2 q.r, clamped at 0 (``torch.cdist`` rounds otherwise),
so a point's distance to itself is f32 round-off, as in the JAX package.
Everything runs on the device of the inputs.

Ties: ``nearest_neighbor`` takes the first of equal minima (``argmin``'s
documented rule, ``jnp.argmin``'s too); ``knn`` orders its neighbours by
distance and then by index, as ``lax.top_k`` keeps the lower index first,
through a composite integer key (``torch.topk`` alone promises no order
among equal values on the card).
"""

from __future__ import annotations

import torch


def _sq_dists(q: torch.Tensor, ref: torch.Tensor, ref_sq: torch.Tensor) -> torch.Tensor:
    """[chunk, M] squared distances (||q||^2 + ||r||^2) - 2 q.r, clamped at
    0; in place, the scan is bound by these passes over the matrix."""
    d2 = (q * q).sum(dim=-1, keepdim=True) + ref_sq[None, :]
    return d2.sub_(q @ ref.T, alpha=2.0).clamp_min_(0.0)


def nearest_neighbor(query, ref, chunk: int = 2048):
    """For every query point [N, 3], its nearest reference point [M, 3]:
    (dist [N], idx [N]), the Euclidean distance and the index into ref."""
    query, ref = query.float(), ref.float()
    ref_sq = (ref * ref).sum(dim=-1)
    dists, idxs = [], []
    for i in range(0, query.shape[0], chunk):
        d2 = _sq_dists(query[i:i + chunk], ref, ref_sq)
        idx = d2.argmin(dim=-1)
        dists.append(d2.gather(-1, idx[:, None])[:, 0].sqrt())
        idxs.append(idx)
    if not dists:
        return query.new_zeros((0,)), torch.zeros((0,), dtype=torch.long, device=query.device)
    return torch.cat(dists), torch.cat(idxs)


def _smallest(d2: torch.Tensor, k: int):
    """The k smallest entries of each row of d2 (>= 0), ascending, ties to
    the lower index: the bit pattern of a non-negative f32 orders as the
    value, so (bits * M + index) is a key without ties (-0.0, whose bits
    are negative, is taken as +0)."""
    m = d2.shape[-1]
    bits = d2.view(torch.int32).clamp_min(0).to(torch.int64)
    key = bits * m + torch.arange(m, device=d2.device)
    _, pos = torch.topk(key, k, dim=-1, largest=False, sorted=True)
    return d2.gather(-1, pos), pos


def knn(query, ref, k: int, chunk: int = 1024):
    """The k nearest reference points of every query point: (dists [N, k],
    idx [N, k]) ascending by distance.  With fewer than k reference points,
    all of them, and the last column repeated (as the JAX package pads)."""
    query, ref = query.float(), ref.float()
    k_eff = min(k, ref.shape[0])
    ref_sq = (ref * ref).sum(dim=-1)
    dists, idxs = [], []
    for i in range(0, query.shape[0], chunk):
        d2, idx = _smallest(_sq_dists(query[i:i + chunk], ref, ref_sq), k_eff)
        dists.append(d2.sqrt())
        idxs.append(idx)
    dists = torch.cat(dists) if dists else query.new_zeros((0, k_eff))
    idx = torch.cat(idxs) if idxs else torch.zeros((0, k_eff), dtype=torch.long,
                                                  device=query.device)
    if k_eff < k:
        pad = k - k_eff
        dists = torch.cat([dists, dists[:, -1:].expand(-1, pad)], dim=1)
        idx = torch.cat([idx, idx[:, -1:].expand(-1, pad)], dim=1)
    return dists, idx
