"""Conditioning sub-networks for the spatial and frustum volumes.

Counterpart of the JAX package's `models/conditioner.py` (NoisyTargetViewEncoder,
SMPLFeatureExtractor with pooled inputs, FrustumTV3DNet, and SpatialTime3DNet,
which runs only with `use_spatial_volume`). Layout is
channels-first: 2D maps (B, C, H, W), 3D volumes (B, C, D, H, W); time and
view embeddings are (B, t_dim) and (B, v_dim).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from morphablediffusion_torch.models.layers import (
    Conv2d,
    Conv3d,
    ConvTranspose3dTorch,
    GroupNorm,
    Linear,
)


def _bcast(e, ndim):
    """(B, C) -> (B, C, 1, ...) for an ndim-dimensional map."""
    return e.reshape(e.shape + (1,) * (ndim - 2))


class Image2DResBlockWithTV(nn.Module):
    """x + conv(x + t_proj + v_proj); conv = (GN8+SiLU+3x3) x2."""

    def __init__(self, dim, t_dim, v_dim, dtype=torch.float32):
        super().__init__()
        self.time_embed = Linear(t_dim, dim, dtype=dtype)
        self.view_embed = Linear(v_dim, dim, dtype=dtype)
        self.norm0 = GroupNorm(8, dim, act="silu")
        self.conv0 = Conv2d(dim, dim, 3, dtype=dtype)
        self.norm1 = GroupNorm(8, dim, act="silu")
        self.conv1 = Conv2d(dim, dim, 3, dtype=dtype)

    def forward(self, x, t, v):
        h = x + _bcast(self.time_embed(t), 4) + _bcast(self.view_embed(v), 4)
        h = self.conv0(self.norm0(h))
        h = self.conv1(self.norm1(h))
        return x + h


class NoisyTargetViewEncoder(nn.Module):
    """Noisy latent (B, 4, h, w) + t/v embeddings -> (B, out, h, w)."""

    def __init__(self, t_dim, v_dim, in_dim=4, run_dim=16, output_dim=16,
                 dtype=torch.float32):
        super().__init__()
        self.init_conv = Conv2d(in_dim, run_dim, 3, dtype=dtype)
        for i in range(3):
            self.add_module(f"res_{i}", Image2DResBlockWithTV(run_dim, t_dim, v_dim, dtype))
        self.final_norm = GroupNorm(8, run_dim, act="silu")
        self.final_conv = Conv2d(run_dim, output_dim, 3, dtype=dtype)

    def forward(self, x, t, v):
        h = self.init_conv(x)
        for i in range(3):
            h = getattr(self, f"res_{i}")(h, t, v)
        return self.final_conv(self.final_norm(h))


class SMPLFeatureExtractor(nn.Module):
    """Per-vertex linear on view-pooled features: (B, Nv, C_in) -> (B, Nv,
    C_out). The pooled form is exact: the per-point linear commutes with the
    mean over views."""

    def __init__(self, in_features=16, features=16, dtype=torch.float32):
        super().__init__()
        self.conv0 = Linear(in_features, features, dtype=dtype)

    def forward(self, x):
        return self.conv0(x)


class FrustumTVBlock(nn.Module):
    """(x + t_proj + v_proj) -> GN8 -> SiLU -> conv3 stride s."""

    def __init__(self, in_dim, out_dim, stride, t_dim, v_dim, dtype=torch.float32):
        super().__init__()
        self.t_conv = Linear(t_dim, in_dim, dtype=dtype)
        self.v_conv = Linear(v_dim, in_dim, dtype=dtype)
        self.bn = GroupNorm(8, in_dim, act="silu")
        self.conv = Conv3d(in_dim, out_dim, 3, stride=stride, dtype=dtype)

    def forward(self, x, t, v):
        h = x + _bcast(self.t_conv(t), 5) + _bcast(self.v_conv(v), 5)
        return self.conv(self.bn(h))


class FrustumTVUpBlock(nn.Module):
    """(x + t + v) -> GN8 -> SiLU -> 2x transposed conv."""

    def __init__(self, in_dim, out_dim, t_dim, v_dim, dtype=torch.float32):
        super().__init__()
        self.t_conv = Linear(t_dim, in_dim, dtype=dtype)
        self.v_conv = Linear(v_dim, in_dim, dtype=dtype)
        self.norm = GroupNorm(8, in_dim, act="silu")
        self.conv = ConvTranspose3dTorch(in_dim, out_dim, dtype=dtype)

    def forward(self, x, t, v):
        h = x + _bcast(self.t_conv(t), 5) + _bcast(self.v_conv(v), 5)
        return self.conv(self.norm(h))


class FrustumTV3DNet(nn.Module):
    """3D UNet over the (D, w, w) frustum; returns the 4-scale feature dict
    {w: (B, d0, D, w, w), w/2: (B, d1, D/2, ..), w/4: .., w/8: ..}."""

    def __init__(self, in_dim, t_dim, v_dim, dims: Sequence[int] = (64, 128, 256, 512),
                 dtype=torch.float32):
        super().__init__()
        d0, d1, d2, d3 = dims
        tv = (t_dim, v_dim, dtype)
        self.conv0 = Conv3d(in_dim, d0, 3, dtype=dtype)
        self.conv1 = FrustumTVBlock(d0, d1, 2, *tv)
        self.conv2 = FrustumTVBlock(d1, d1, 1, *tv)
        self.conv3 = FrustumTVBlock(d1, d2, 2, *tv)
        self.conv4 = FrustumTVBlock(d2, d2, 1, *tv)
        self.conv5 = FrustumTVBlock(d2, d3, 2, *tv)
        self.conv6 = FrustumTVBlock(d3, d3, 1, *tv)
        self.up0 = FrustumTVUpBlock(d3, d2, *tv)
        self.up1 = FrustumTVUpBlock(d2, d1, *tv)
        self.up2 = FrustumTVUpBlock(d1, d0, *tv)

    def forward(self, x, t, v) -> Dict[int, torch.Tensor]:
        w = x.shape[-1]
        x0 = self.conv0(x)
        x1 = self.conv2(self.conv1(x0, t, v), t, v)
        x2 = self.conv4(self.conv3(x1, t, v), t, v)
        x3 = self.conv6(self.conv5(x2, t, v), t, v)
        x2 = self.up0(x3, t, v) + x2
        x1 = self.up1(x2, t, v) + x1
        x0 = self.up2(x1, t, v) + x0
        return {w: x0, w // 2: x1, w // 4: x2, w // 8: x3}


class SpatialTimeBlock(nn.Module):
    """(x + t_proj) -> GN8 -> SiLU -> conv3 stride s (network.py:222-233)."""

    def __init__(self, in_dim, out_dim, stride, t_dim, dtype=torch.float32):
        super().__init__()
        self.t_conv = Linear(t_dim, in_dim, dtype=dtype)
        self.bn = GroupNorm(8, in_dim, act="silu")
        self.conv = Conv3d(in_dim, out_dim, 3, stride=stride, dtype=dtype)

    def forward(self, x, t):
        return self.conv(self.bn(x + _bcast(self.t_conv(t), 5)))


class SpatialUpTimeBlock(nn.Module):
    """(x + t_proj) -> GN8 -> SiLU -> 2x transposed conv."""

    def __init__(self, in_dim, out_dim, t_dim, dtype=torch.float32):
        super().__init__()
        self.t_conv = Linear(t_dim, in_dim, dtype=dtype)
        self.norm = GroupNorm(8, in_dim, act="silu")
        self.conv = ConvTranspose3dTorch(in_dim, out_dim, dtype=dtype)

    def forward(self, x, t):
        return self.conv(self.norm(x + _bcast(self.t_conv(t), 5)))


class SpatialTime3DNet(nn.Module):
    """3D UNet over the V^3 multi-view volume (network.py:235-283): x (B,
    in_dim, V, V, V), in_dim = views x 16 view-major; t (B, t_dim) ->
    (B, dims[0], V, V, V)."""

    def __init__(self, in_dim, t_dim, dims: Sequence[int] = (64, 128, 256, 512),
                 dtype=torch.float32):
        super().__init__()
        d0, d1, d2, d3 = dims
        self.init_conv = Conv3d(in_dim, d0, 3, dtype=dtype)
        for name, cin, cout, stride in (
                ("conv0", d0, d0, 1), ("conv1", d0, d1, 2), ("conv2_0", d1, d1, 1),
                ("conv2_1", d1, d1, 1), ("conv3", d1, d2, 2), ("conv4_0", d2, d2, 1),
                ("conv4_1", d2, d2, 1), ("conv5", d2, d3, 2), ("conv6_0", d3, d3, 1),
                ("conv6_1", d3, d3, 1)):
            self.add_module(name, SpatialTimeBlock(cin, cout, stride, t_dim, dtype))
        self.conv7 = SpatialUpTimeBlock(d3, d2, t_dim, dtype)
        self.conv8 = SpatialUpTimeBlock(d2, d1, t_dim, dtype)
        self.conv9 = SpatialUpTimeBlock(d1, d0, t_dim, dtype)

    def forward(self, x, t):
        conv0 = self.conv0(self.init_conv(x), t)
        conv2 = self.conv2_1(self.conv2_0(self.conv1(conv0, t), t), t)
        conv4 = self.conv4_1(self.conv4_0(self.conv3(conv2, t), t), t)
        x = self.conv6_1(self.conv6_0(self.conv5(conv4, t), t), t)
        x = conv4 + self.conv7(x, t)
        x = conv2 + self.conv8(x, t)
        return conv0 + self.conv9(x, t)
