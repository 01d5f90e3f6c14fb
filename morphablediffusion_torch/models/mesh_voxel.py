"""Mesh-vertex voxel feature network (the coarse dense replacement of spconv).

Counterpart of the JAX package's `models/mesh_voxel.py::MeshVoxelNet`:
scatter-mean the per-vertex features into a coarse dense grid, run a 7-layer
bias-free 3D CNN with masked instance norm (eps 1e-3) and ReLU, re-zeroing
inactive voxels (the mask dilates one voxel per conv from layer 2 on), then
query the final grid trilinearly. Grids are channels-first
(B, C, Gd, Gh, Gw); "dhw" coordinates are (z, y, x).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from morphablediffusion_torch.models.layers import Conv3d
from morphablediffusion_torch.ops.grid_sample import grid_sample_3d


def scatter_mean_voxels(vert_features, vert_idx, vert_mask, grid_shape):
    """Scatter-mean per-vertex features into dense voxel grids.

    vert_features: (B, Nv, C); vert_idx: (B, Nv, 3) int dhw voxel indices;
    vert_mask: (B, Nv) {0, 1}; grid_shape: (Gd, Gh, Gw). Out-of-grid and
    masked vertices are dropped. Returns (grid (B, C, Gd, Gh, Gw),
    occupancy (B, 1, Gd, Gh, Gw)).
    """
    Gd, Gh, Gw = grid_shape
    B, Nv, C = vert_features.shape
    G = Gd * Gh * Gw
    d, h, w = vert_idx.unbind(-1)
    inb = ((d >= 0) & (d < Gd) & (h >= 0) & (h < Gh) & (w >= 0) & (w < Gw)
           & (vert_mask > 0))
    flat = ((d.clamp(0, Gd - 1) * Gh + h.clamp(0, Gh - 1)) * Gw + w.clamp(0, Gw - 1))
    flat = flat + torch.arange(B, device=flat.device)[:, None] * G
    weights = inb.to(vert_features.dtype)
    feat_sum = torch.zeros(B * G, C, dtype=vert_features.dtype, device=vert_features.device)
    feat_sum.index_add_(0, flat.reshape(-1), (vert_features * weights[..., None]).reshape(-1, C))
    count = torch.zeros(B * G, dtype=vert_features.dtype, device=vert_features.device)
    count.index_add_(0, flat.reshape(-1), weights.reshape(-1))
    grid = feat_sum / torch.clamp(count, min=1.0)[:, None]
    occ = (count > 0).to(vert_features.dtype)
    grid = grid.reshape(B, Gd, Gh, Gw, C).permute(0, 4, 1, 2, 3)
    return grid, occ.reshape(B, 1, Gd, Gh, Gw)


class MaskedInstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over the active voxels only,
    fp32 statistics, eps 1e-3. x: (B, C, ...); mask: (B, 1, ...) {0, 1}."""

    def __init__(self, channels, epsilon=1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, mask):
        B, C = x.shape[:2]
        xf = x.reshape(B, C, -1).float()
        m = mask.reshape(B, 1, -1).float()
        n = torch.clamp(m.sum(-1), min=1.0)  # (B, 1)
        mean = (xf * m).sum(-1) / n
        var = torch.clamp((xf * xf * m).sum(-1) / n - mean * mean, min=0.0)
        a = torch.rsqrt(var + self.epsilon) * self.weight.float()
        b = self.bias.float() - mean * a
        shape = (B, C) + (1,) * (x.ndim - 2)
        y = x * a.to(x.dtype).reshape(shape) + b.to(x.dtype).reshape(shape)
        return y * mask.to(x.dtype)


class MeshVoxelNet(nn.Module):
    """Dense scatter + 3D CNN + trilinear query (coarse mode)."""

    def __init__(self, in_channels=16, grid_shape: Tuple[int, int, int] = (48, 48, 48),
                 voxel_size: float = 0.02,
                 channels: Sequence[int] = (16, 16, 32, 32, 64, 64, 64),
                 dtype=torch.float32):
        super().__init__()
        self.grid_shape = tuple(grid_shape)
        self.voxel_size = voxel_size
        self.dtype = dtype
        self.num_layers = len(channels)
        cin = in_channels
        for i, ch in enumerate(channels):
            self.add_module(f"conv{i}", Conv3d(cin, ch, 3, bias=False, dtype=dtype))
            self.add_module(f"norm{i}", MaskedInstanceNorm(ch))
            cin = ch

    def forward(self, vert_features, vert_dhw, min_dhw, vert_mask, query_dhw):
        """vert_features (B, Nv, C); vert_dhw (B, Nv, 3) metric (z, y, x);
        min_dhw (B, 3); vert_mask (B, Nv); query_dhw (B, ..., 3) metric.
        Returns (B, channels[-1], ...)."""
        B = vert_features.shape[0]
        idx = torch.round((vert_dhw - min_dhw[:, None, :]) / self.voxel_size).to(torch.int64)
        h, occ = scatter_mean_voxels(vert_features.to(self.dtype), idx, vert_mask,
                                     self.grid_shape)
        mask = occ
        for i in range(self.num_layers):
            if i >= 2:
                mask = F.max_pool3d(mask, 3, stride=1, padding=1)
            h = getattr(self, f"conv{i}")(h)
            h = getattr(self, f"norm{i}")(h, mask)
            h = torch.relu(h) * mask

        Gd, Gh, Gw = self.grid_shape
        q = (query_dhw - min_dhw.reshape((B,) + (1,) * (query_dhw.ndim - 2) + (3,))
             ) / self.voxel_size
        scale = torch.tensor([Gw - 1, Gh - 1, Gd - 1], dtype=q.dtype, device=q.device)
        q_xyz = q.flip(-1) / scale * 2.0 - 1.0
        return grid_sample_3d(h, q_xyz)
