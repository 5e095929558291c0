"""2D rotary position embeddings (RoPE) of the pointmap backbones, port of
``unigeo_tpu/ops/rope.py``.

Each head's D channels split in two halves: the first is rotated by the
token's y, the second by its x, each a 1-D RoPE (rotate-half pairing) with
inv_freq[j] = freq^(-2j / (D/2)) duplicated to fill its half.  A position
with y < 0 (a token without a grid slot) is left unrotated.
"""

from __future__ import annotations

import torch


def grid_positions(gh: int, gw: int, device=None) -> torch.Tensor:
    """Patch-grid (y, x) positions, row-major -> [gh*gw, 2] int32."""
    ys, xs = torch.meshgrid(torch.arange(gh, device=device), torch.arange(gw, device=device),
                            indexing="ij")
    return torch.stack([ys.reshape(-1), xs.reshape(-1)], dim=-1).to(torch.int32)


def rope_2d_cos_sin(head_dim: int, positions: torch.Tensor, freq: float = 100.0,
                    dtype=torch.float32):
    """positions [..., 2] (y, x) -> (cos, sin), each [..., head_dim],
    computed in f32 and cast to ``dtype`` at the end."""
    d_half = head_dim // 2
    if head_dim % 2 or d_half % 2:
        raise ValueError(f"head_dim must be a multiple of 4, not {head_dim}")
    inv = 1.0 / freq ** (
        torch.arange(0, d_half, 2, dtype=torch.float32, device=positions.device) / d_half)

    def cs(pos1d):
        f = pos1d.float()[..., None] * inv
        f = torch.cat([f, f], dim=-1)
        valid = (pos1d >= 0)[..., None]
        return (torch.where(valid, torch.cos(f), 1.0), torch.where(valid, torch.sin(f), 0.0))

    cy, sy = cs(positions[..., 0])
    cx, sx = cs(positions[..., 1])
    return torch.cat([cy, cx], dim=-1).to(dtype), torch.cat([sy, sx], dim=-1).to(dtype)


def _rotate_half(u: torch.Tensor) -> torch.Tensor:
    a, b = u.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def apply_rope_2d(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate t [..., S, H, D] by (cos, sin) [..., S, D] (broadcast over H)."""
    dh = t.shape[-1] // 2
    rotated = torch.cat([_rotate_half(t[..., :dh]), _rotate_half(t[..., dh:])], dim=-1)
    return t * cos[..., None, :] + rotated * sin[..., None, :]
