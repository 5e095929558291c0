"""Pose encodings, port of ``unigeo_tpu/models/posecodec.py``: the 7-DoF
absT_quaR codec ([tx ty tz qw qx qy qz] <-> 4x4 camera-to-world, the
encoding Cut3R's pose head emits) and the NeRF harmonic embedding.

The quaternion helpers are ``metrics/camera.py``'s.  The harmonic embedding
and ``PoseEmbedding`` are on no eval path; they keep the JAX package's
layout (sin block, cos block, then the raw input).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from unigeo_tpu_torch.metrics.camera import matrix_to_quaternion, quaternion_to_matrix


def camera_to_pose_encoding(c2w: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> [..., 7] (absT_quaR)."""
    return torch.cat([c2w[..., :3, 3], matrix_to_quaternion(c2w[..., :3, :3])], dim=-1)


def pose_encoding_to_camera(enc: torch.Tensor) -> torch.Tensor:
    """[..., 7] (absT_quaR) -> [..., 4, 4] camera-to-world, f32."""
    enc = enc.float()
    out = torch.eye(4, device=enc.device).expand(enc.shape[:-1] + (4, 4)).clone()
    out[..., :3, :3] = quaternion_to_matrix(enc[..., 3:7])
    out[..., :3, 3] = enc[..., :3]
    return out


def harmonic_frequencies(n_harmonic_functions: int = 6, omega_0: float = 1.0,
                         logspace: bool = True, device=None) -> torch.Tensor:
    """[N] frequencies: powers of 2 (logspace) or linspace(1, 2^(N-1))."""
    if logspace:
        freqs = 2.0 ** torch.arange(n_harmonic_functions, dtype=torch.float32, device=device)
    else:
        freqs = torch.linspace(1.0, 2.0 ** (n_harmonic_functions - 1), n_harmonic_functions,
                               dtype=torch.float32, device=device)
    return freqs * omega_0


def harmonic_embedding(x: torch.Tensor, n_harmonic_functions: int = 6, omega_0: float = 1.0,
                       logspace: bool = True, append_input: bool = True,
                       diag_cov: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NeRF / MIP-NeRF positional encoding of ``x`` [..., dim] ->
    [..., dim * (2N + append_input)]: the sin block ([sin(f_1 x_1) ..
    sin(f_N x_1), sin(f_1 x_2) ..]), the cos block, then the input;
    ``diag_cov`` damps each harmonic by exp(-0.5 f^2 cov)."""
    freqs = harmonic_frequencies(n_harmonic_functions, omega_0, logspace, x.device)
    embed = x[..., None] * freqs  # [..., dim, N]
    phases = torch.tensor([0.0, 0.5 * math.pi], dtype=x.dtype, device=x.device)
    embed = torch.sin(embed[..., None, :, :] + phases[:, None, None])  # [..., 2, dim, N]
    if diag_cov is not None:
        damp = torch.exp(-0.5 * diag_cov[..., None] * freqs**2)  # [..., dim, N]
        embed = embed * damp[..., None, :, :]
    embed = embed.reshape(*x.shape[:-1], -1)
    return torch.cat([embed, x], dim=-1) if append_input else embed


def harmonic_embedding_dim(input_dims: int, n_harmonic_functions: int,
                           append_input: bool = True) -> int:
    """The output width of ``harmonic_embedding``."""
    return input_dims * (2 * n_harmonic_functions + int(append_input))


class PoseEmbedding:
    """Harmonic embedding of a ``target_dim``-wide pose encoding into
    ``out_dim`` features."""

    def __init__(self, target_dim: int, n_harmonic_functions: int = 10,
                 append_input: bool = True):
        self.target_dim = target_dim
        self.n_harmonic_functions = n_harmonic_functions
        self.append_input = append_input
        self.out_dim = harmonic_embedding_dim(target_dim, n_harmonic_functions, append_input)

    def __call__(self, pose_encoding: torch.Tensor) -> torch.Tensor:
        return harmonic_embedding(pose_encoding, n_harmonic_functions=self.n_harmonic_functions,
                                  append_input=self.append_input)
