"""Bilinear / trilinear grid sampling with PyTorch semantics.

The JAX package's `ops/grid_sample.py` reproduces exactly
`F.grid_sample(mode='bilinear', padding_mode='zeros', align_corners=True)`,
so here that call is the implementation. Features are channels-first; the
sample grid keeps the JAX layout, coordinates (x, y[, z]) in [-1, 1] on the
last axis, with any number of point axes in between. Sampling runs in fp32
(coordinates in bf16 would cost sub-pixel accuracy) and the result is cast
back to the feature dtype.
"""

from __future__ import annotations

import torch.nn.functional as F


def grid_sample_2d(feat, grid):
    """feat: (B, C, H, W); grid: (B, ..., 2) -> (B, C, ...)."""
    B, C = feat.shape[:2]
    pts = grid.shape[1:-1]
    g = grid.reshape(B, 1, -1, 2).float()
    out = F.grid_sample(feat.float(), g, mode="bilinear", padding_mode="zeros",
                        align_corners=True)  # (B, C, 1, P)
    return out.reshape((B, C) + pts).to(feat.dtype)


def grid_sample_3d(feat, grid):
    """feat: (B, C, D, H, W); grid: (B, ..., 3) with x indexing W, y H and
    z D -> (B, C, ...). Zeros outside the volume."""
    B, C = feat.shape[:2]
    pts = grid.shape[1:-1]
    g = grid.reshape(B, 1, 1, -1, 3).float()
    out = F.grid_sample(feat.float(), g, mode="bilinear", padding_mode="zeros",
                        align_corners=True)  # (B, C, 1, 1, P)
    return out.reshape((B, C) + pts).to(feat.dtype)
