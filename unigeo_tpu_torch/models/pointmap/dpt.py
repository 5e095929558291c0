"""DPT regression head of the pointmap family, port of
``unigeo_tpu/models/pointmap/dpt.py`` (dust3r's ``dpt_block.py`` layout):

  act_postprocess_{0..3}   1x1 conv to layer_dims[k] + resample
                           (x4 and x2 transposed convs, identity, a stride-2
                           3x3 conv)
  layer{1..4}_rn           3x3 conv to the feature width (no bias)
  refinenet{4..1}          fusion blocks: residual conv units, x2 upsample,
                           1x1 conv
  head_{0,2,4}             3x3 conv, x2 upsample, 3x3 conv, ReLU, 1x1

Convs run NCHW; the token maps and the output are NHWC as in the JAX
package.  The resizes are the JAX package's: bilinear with aligned corners
(``F.interpolate(..., align_corners=True)``), nearest with half-pixel
centres when a side is 1 (``mode="nearest-exact"``), and the final
``jax.image.resize`` "bilinear" (half-pixel centres, antialiased when it
shrinks) by ``vit.resize_bilinear``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from unigeo_tpu_torch.models.layers import mlp_pair
from unigeo_tpu_torch.models.pointmap.network import _points_and_conf
from unigeo_tpu_torch.models.vit import resize_bilinear


def _resize_to(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """NCHW bilinear resize with align_corners=True (nearest, half-pixel
    centres, when a side is 1)."""
    h, w = x.shape[-2:]
    if (h, w) == (oh, ow):
        return x
    if h <= 1 or w <= 1:
        return F.interpolate(x, size=(oh, ow), mode="nearest-exact")
    return F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=True)


def _conv(cin, cout, k, **kw):
    return nn.Conv2d(cin, cout, k, padding=k // 2, **kw)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = _conv(features, features, 3)
        self.conv2 = _conv(features, features, 3)

    def forward(self, x):
        return x + mlp_pair(self.conv1, self.conv2, F.relu(x), F.relu)


class FeatureFusionBlock(nn.Module):
    """Fuse the skip (resConfUnit1, only where there is one), refine
    (resConfUnit2), upsample x2, 1x1 projection.  The deeper map is resized
    to the skip's grid first (a no-op on even grids)."""

    def __init__(self, features: int, with_skip: bool = True):
        super().__init__()
        if with_skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = _conv(features, features, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = _resize_to(x, skip.shape[2], skip.shape[3]) + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = _resize_to(x, 2 * x.shape[2], 2 * x.shape[3])
        return self.out_conv(x)


class DPTHead(nn.Module):
    """4 hooked token sets [B, N, C_i] -> [B, gh*16, gw*16, out_channels]."""

    def __init__(self, hook_dims: Sequence[int], out_channels: int = 4, feature_dim: int = 256,
                 layer_dims: Sequence[int] = (96, 192, 384, 768), head_dim: int = 128):
        super().__init__()
        d0, d1, d2, d3 = layer_dims
        c0, c1, c2, c3 = hook_dims
        self.act_postprocess_0_proj = _conv(c0, d0, 1)
        self.act_postprocess_0_resample = nn.ConvTranspose2d(d0, d0, 4, stride=4)
        self.act_postprocess_1_proj = _conv(c1, d1, 1)
        self.act_postprocess_1_resample = nn.ConvTranspose2d(d1, d1, 2, stride=2)
        self.act_postprocess_2_proj = _conv(c2, d2, 1)
        self.act_postprocess_3_proj = _conv(c3, d3, 1)
        self.act_postprocess_3_resample = nn.Conv2d(d3, d3, 3, stride=2, padding=1)
        f = feature_dim
        for i, d in enumerate(layer_dims, start=1):
            setattr(self, f"layer{i}_rn", _conv(d, f, 3, bias=False))
        self.refinenet4 = FeatureFusionBlock(f, with_skip=False)
        self.refinenet3 = FeatureFusionBlock(f)
        self.refinenet2 = FeatureFusionBlock(f)
        self.refinenet1 = FeatureFusionBlock(f)
        self.head_0 = _conv(f, head_dim, 3)
        self.head_2 = _conv(head_dim, head_dim, 3)
        self.head_4 = _conv(head_dim, out_channels, 1)

    def forward(self, hooked, grid: Tuple[int, int]):
        if len(hooked) != 4:
            raise ValueError("DPT expects 4 hooked layers")
        gh, gw = grid
        maps = [t.transpose(1, 2).reshape(t.shape[0], t.shape[2], gh, gw) for t in hooked]
        l0 = self.act_postprocess_0_resample(self.act_postprocess_0_proj(maps[0]))
        l1 = self.act_postprocess_1_resample(self.act_postprocess_1_proj(maps[1]))
        l2 = self.act_postprocess_2_proj(maps[2])
        l3 = self.act_postprocess_3_resample(self.act_postprocess_3_proj(maps[3]))
        r0, r1, r2, r3 = (self.layer1_rn(l0), self.layer2_rn(l1), self.layer3_rn(l2),
                          self.layer4_rn(l3))
        p = self.refinenet4(r3)
        p = self.refinenet3(p, r2)
        p = self.refinenet2(p, r1)
        p = self.refinenet1(p, r0)
        h = self.head_0(p)
        h = _resize_to(h, 2 * h.shape[2], 2 * h.shape[3])
        h = F.relu(self.head_2(h))
        return self.head_4(h).permute(0, 2, 3, 1)


class DPTPointmapHead(nn.Module):
    """The DPT trunk and DUSt3R's postprocess (exp z, 1 + exp confidence):
    [B, gh*p, gw*p, 3] points, [B, gh*p, gw*p] confidence; a patch other
    than 16 resizes the trunk's x16 output to the pixel grid."""

    def __init__(self, hook_dims: Sequence[int], patch_size: int = 16, feature_dim: int = 256,
                 layer_dims: Sequence[int] = (96, 192, 384, 768)):
        super().__init__()
        self.patch_size = patch_size
        self.dpt = DPTHead(hook_dims, out_channels=4, feature_dim=feature_dim,
                           layer_dims=layer_dims)

    def forward(self, hooked, grid: Tuple[int, int]):
        gh, gw = grid
        out = self.dpt(hooked, grid)
        th, tw = gh * self.patch_size, gw * self.patch_size
        if out.shape[1:3] != (th, tw):
            out = resize_bilinear(out.permute(0, 3, 1, 2), th, tw).to(out.dtype).permute(0, 2, 3, 1)
        return _points_and_conf(out)
