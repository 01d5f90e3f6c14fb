"""GroupNorm with fp32 statistics and an optional fused activation.

Counterpart of the plain functions of the JAX package's `ops/group_norm.py`
(`_reference` and `group_norm_shifted`). Layout is channels-first:
x (B, C, *spatial). Statistics are one-pass E[x^2] - E[x]^2 in fp32 with the
variance clamped at 0; the output is cast back to x's dtype.

The JAX package's Pallas GroupNorm kernel is off by default there and not on
the serving path; its Hopper port is queued (ROADMAP B4).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_ACTS = {
    None: lambda x: x,
    "silu": F.silu,
    "relu": F.relu,
}


def _stats(colsum, colsq, num_groups: int, n: int, epsilon: float):
    """Per-channel sums (B, C) -> per-channel mean and inverse std (B, C)."""
    B, C = colsum.shape
    mean = colsum.reshape(B, num_groups, -1).sum(-1) / n
    ex2 = colsq.reshape(B, num_groups, -1).sum(-1) / n
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    inv = torch.rsqrt(var + epsilon)
    cg = C // num_groups
    return (mean.repeat_interleave(cg, dim=1), inv.repeat_interleave(cg, dim=1))


def group_norm(x, gamma, beta, num_groups: int = 32, epsilon: float = 1e-5,
               act: str | None = None):
    """GroupNorm(+act). x: (B, C, ...); gamma/beta: (C,)."""
    return group_norm_shifted(x, None, gamma, beta, num_groups, epsilon, act)


def group_norm_shifted(x, shift, gamma, beta, num_groups: int = 32,
                       epsilon: float = 1e-5, act: str | None = None):
    """GroupNorm(x + shift[:, :, None, ...]) without materializing x + shift.

    shift: (B, C) or None. Adding a per-(sample, channel) constant moves the
    statistics analytically: colsum' = colsum + S*t and
    colsq' = colsq + 2*t*colsum + S*t^2, and the apply is a per-(B, C) affine.
    """
    B, C = x.shape[:2]
    if C % num_groups:
        raise ValueError(f"GroupNorm: channels {C} not divisible by "
                         f"num_groups {num_groups}")
    xf = x.reshape(B, C, -1).float()
    S = xf.shape[-1]
    colsum = xf.sum(-1)
    colsq = (xf * xf).sum(-1)
    if shift is not None:
        t = shift.float()
        colsq = colsq + 2.0 * t * colsum + S * t * t
        colsum = colsum + S * t
    mean, inv = _stats(colsum, colsq, num_groups, S * (C // num_groups), epsilon)
    A = inv * gamma.float()[None]
    B2 = beta.float()[None] - mean * A
    if shift is not None:
        B2 = B2 + shift.float() * A
    y = xf * A[..., None] + B2[..., None]
    return _ACTS[act](y).to(x.dtype).reshape(x.shape)
