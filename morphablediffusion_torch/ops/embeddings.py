"""Sinusoidal time embeddings and relative-viewpoint embeddings.

Counterpart of the JAX package's `ops/embeddings.py`. The time embedding
concatenates cos THEN sin, as the reference does.
"""

from __future__ import annotations

import math

import torch


def timestep_embedding(timesteps, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding. timesteps: (B,) int or float -> (B, dim) f32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def viewpoint_embedding(input_elevation_deg, input_azimuth_deg,
                        target_elevation_deg, target_azimuth_deg):
    """Relative viewpoint embedding, (B, N, 4) f32: (d_elev, sin d_azim,
    cos d_azim, 0). Inputs: (B, 1), (B, 1), (B, N), (B, N) degrees."""
    d2r = math.pi / 180.0
    d_e = (target_elevation_deg - input_elevation_deg) * d2r
    d_a = (target_azimuth_deg - input_azimuth_deg) * d2r
    return torch.stack(
        [d_e, torch.sin(d_a), torch.cos(d_a), torch.zeros_like(d_a)], dim=-1)
