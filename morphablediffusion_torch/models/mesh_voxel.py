"""Mesh-vertex voxel feature networks (dense replacements of spconv).

Counterpart of the JAX package's `models/mesh_voxel.py`:

  * `MeshVoxelNet` (coarse mode): scatter-mean the per-vertex features into a
    coarse dense grid, run a 7-layer bias-free 3D CNN with masked instance
    norm (eps 1e-3) and ReLU, re-zeroing inactive voxels (the mask dilates
    one voxel per conv from layer 2 on), then query the final grid
    trilinearly.
  * `FineMeshVoxelNet` (fine mode, the reference's own conditioner):
    scatter onto the 0.005 m fine grid, run `FineSparseConvNet`, the
    dense-masked emulation of the reference's spconv `SparseConvNet` (whose
    published `xyzc_net` weights it takes, BatchNorm in its frozen
    running-statistics form, `BNActive`), and query the 64-channel field
    with the reference's coordinate normalization by the per-sample extent.

Grids are channels-first (B, C, Gd, Gh, Gw); "dhw" coordinates are (z, y, x).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from morphablediffusion_torch.models.layers import Conv3d
from morphablediffusion_torch.ops.grid_sample import grid_sample_3d


def scatter_mean_voxels(vert_features, vert_idx, vert_mask, grid_shape, ordered=False):
    """Scatter-mean per-vertex features into dense voxel grids.

    vert_features: (B, Nv, C); vert_idx: (B, Nv, 3) int dhw voxel indices;
    vert_mask: (B, Nv) {0, 1}; grid_shape: (Gd, Gh, Gw). Out-of-grid and
    masked vertices are dropped. Returns (grid (B, C, Gd, Gh, Gw),
    occupancy (B, 1, Gd, Gh, Gw)).

    On the card `index_add_` adds a voxel's vertices by atomics, in any
    order; ordered=True adds them in index order (`index_put_` with
    accumulate sorts them, as `index_add_` does under torch's deterministic
    algorithms), so the grid has the same bits in every call. Every serving
    call scatters in order (`MorphableDiffusion.predict_eps_cfg`): an
    avatar is reproducible from its seed, and the ranks of a mesh, which
    each build the whole volume, agree to the bit. Training keeps the
    atomics. The occupancy count adds weights of 0.0 and 1.0, a sum that
    is exact in any order, so it takes `index_add_` either way.
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
    values = (vert_features * weights[..., None]).reshape(-1, C)
    if ordered:
        feat_sum.index_put_((flat.reshape(-1),), values, accumulate=True)
    else:
        feat_sum.index_add_(0, flat.reshape(-1), values)
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

    def forward(self, vert_features, vert_dhw, min_dhw, vert_mask, query_dhw, ordered=False):
        """vert_features (B, Nv, C); vert_dhw (B, Nv, 3) metric (z, y, x);
        min_dhw (B, 3); vert_mask (B, Nv); query_dhw (B, ..., 3) metric;
        ordered: see scatter_mean_voxels. Returns (B, channels[-1], ...)."""
        B = vert_features.shape[0]
        idx = torch.round((vert_dhw - min_dhw[:, None, :]) / self.voxel_size).to(torch.int64)
        h, occ = scatter_mean_voxels(vert_features.to(self.dtype), idx, vert_mask,
                                     self.grid_shape, ordered)
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


class BNActive(nn.Module):
    """BatchNorm1d over active sites (eps 1e-3) in its inference form: a
    frozen per-channel affine from the running statistics. `mean` and `var`
    are parameters of the JAX tree (imported running statistics, not
    trained). x: (B, C, ...)."""

    def __init__(self, channels, epsilon=1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.mean = nn.Parameter(torch.zeros(channels))
        self.var = nn.Parameter(torch.ones(channels))

    def forward(self, x):
        r = torch.rsqrt(self.var.float() + self.epsilon) * self.weight.float()
        shape = (1, -1) + (1,) * (x.ndim - 2)
        k = r.to(x.dtype).reshape(shape)
        b = (self.bias.float() - self.mean.float() * r).to(x.dtype).reshape(shape)
        return x * k + b


def _clip_extent(x, mask, extent):
    """Zero x and mask outside the per-sample extent (B, 3) of (d, h, w)
    cells; extent None leaves them as they are."""
    if extent is None:
        return x, mask
    valid = torch.ones((x.shape[0], 1) + x.shape[2:5], dtype=torch.bool, device=x.device)
    for ax in range(3):
        size = x.shape[2 + ax]
        iota = torch.arange(size, device=x.device).reshape(
            (1, 1) + (1,) * ax + (size,) + (1,) * (2 - ax))
        valid = valid & (iota < extent[:, ax].reshape(-1, 1, 1, 1, 1))
    return x * valid.to(x.dtype), mask * valid.to(mask.dtype)


class FineSparseConvNet(nn.Module):
    """Dense-masked emulation of the reference spconv `SparseConvNet`
    (network.py:74-96): submanifold convs are dense convs re-masked to the
    input active set; a stride-2 sparse conv is a dense stride-2 conv whose
    active set is the 3^3 stride-2 max-pool of the input's; BatchNorm over
    active rows is `BNActive`, then re-masked. Channel plan 16 -> 16 ->
    32 (s2) -> 32 -> 64 (s2) -> 64, kernel 3, bias-free; module names follow
    the torch Sequential indices (conv0.0 -> conv0_0)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        conv = lambda cin, cout, stride=1: Conv3d(cin, cout, 3, stride=stride, padding=1,
                                                  bias=False, dtype=dtype)
        self.conv0_0, self.conv0_1 = conv(16, 16), BNActive(16)
        self.conv0_3, self.conv0_4 = conv(16, 16), BNActive(16)
        self.down0_0, self.down0_1 = conv(16, 32, 2), BNActive(32)
        self.conv1_0, self.conv1_1 = conv(32, 32), BNActive(32)
        self.conv1_3, self.conv1_4 = conv(32, 32), BNActive(32)
        self.down1_0, self.down1_1 = conv(32, 64, 2), BNActive(64)
        self.conv2_0, self.conv2_1 = conv(64, 64), BNActive(64)
        self.conv2_3, self.conv2_4 = conv(64, 64), BNActive(64)
        self.conv2_6, self.conv2_7 = conv(64, 64), BNActive(64)

    def forward(self, grid, occ, out_sh=None):
        """grid: (B, 16, Gd, Gh, Gw); occ: (B, 1, Gd, Gh, Gw) {0, 1}; out_sh:
        optional (B, 3) per-sample dense extents of the reference grid
        (multiples of 4). Returns ((B, 64, Gd/4, Gh/4, Gw/4), its mask).

        The reference's strided convs produce dense grids of exactly
        out_sh//2 and then out_sh//4 cells; on the larger static grid,
        activity and values are clipped to those extents after each
        downsample, or a phantom active plane would feed the next conv."""

        def subm(x, mask, conv, bn):
            return torch.relu(bn(conv(x))) * mask

        def down(x, mask, conv, bn, div):
            y = conv(x)
            mask = F.max_pool3d(mask, 3, stride=2, padding=1)
            y, mask = _clip_extent(y, mask, None if out_sh is None else out_sh // div)
            return torch.relu(bn(y)) * mask, mask

        h, mask = grid, occ.to(grid.dtype)
        h = subm(h, mask, self.conv0_0, self.conv0_1)
        h = subm(h, mask, self.conv0_3, self.conv0_4)
        h, mask = down(h, mask, self.down0_0, self.down0_1, 2)
        h = subm(h, mask, self.conv1_0, self.conv1_1)
        h = subm(h, mask, self.conv1_3, self.conv1_4)
        h, mask = down(h, mask, self.down1_0, self.down1_1, 4)
        h = subm(h, mask, self.conv2_0, self.conv2_1)
        h = subm(h, mask, self.conv2_3, self.conv2_4)
        h = subm(h, mask, self.conv2_6, self.conv2_7)
        return h, mask


class FineMeshVoxelNet(nn.Module):
    """The reference's mesh conditioner: scatter the vertex features onto the
    0.005 m fine grid, run `FineSparseConvNet` (as `net`), and query the
    64-channel coarse field with the reference's coordinate normalization
    (morphable_diffusion.py:234-255). The grid is static (multiples of 4);
    the per-sample `out_sh` of the reference batch is recomputed from the
    masked vertex bounds (ceil(extent / voxel) | 3) + 1 and enters only the
    coordinate arithmetic and the extent clipping."""

    def __init__(self, in_channels=16, grid_shape: Tuple[int, int, int] = (128, 128, 128),
                 voxel_size: float = 0.005, dtype=torch.float32):
        super().__init__()
        if in_channels != 16:
            raise ValueError("the fine conditioner takes 16 vertex channels")
        self.grid_shape = tuple(grid_shape)
        self.voxel_size = voxel_size
        self.dtype = dtype
        self.net = FineSparseConvNet(dtype)

    def forward(self, vert_features, vert_dhw, min_dhw, vert_mask, query_dhw, ordered=False):
        """Same contract as MeshVoxelNet.forward."""
        B = vert_features.shape[0]
        Gd, Gh, Gw = self.grid_shape
        idx = torch.round((vert_dhw - min_dhw[:, None, :]) / self.voxel_size).to(torch.int64)
        grid, occ = scatter_mean_voxels(vert_features.to(self.dtype), idx, vert_mask,
                                        self.grid_shape, ordered)
        max_dhw = torch.where(vert_mask[..., None] > 0, vert_dhw,
                              torch.full_like(vert_dhw, -1e9)).amax(1)
        out_sh = torch.ceil((max_dhw - min_dhw) / self.voxel_size).to(torch.int64)
        out_sh = (out_sh | 3) + 1  # (B, 3), the next multiple of 4
        vol, _ = self.net(grid, occ, out_sh)

        lead = (B,) + (1,) * (query_dhw.ndim - 2) + (3,)
        f = (query_dhw - min_dhw.reshape(lead)) / self.voxel_size
        # reference: g = f / out_sh * 2 - 1, align_corners over the out_sh//4
        # grid, so the dense pixel is f / out_sh * (out_sh//4 - 1); renormalize
        # it for the static coarse extent
        coarse = (out_sh // 4).to(f.dtype).reshape(lead)
        p = f / out_sh.to(f.dtype).reshape(lead) * (coarse - 1.0)
        static_c = torch.tensor([Gw // 4 - 1, Gh // 4 - 1, Gd // 4 - 1], dtype=f.dtype,
                                device=f.device)
        return grid_sample_3d(vol, p.flip(-1) / static_c * 2.0 - 1.0)
