"""GroupNorm with fp32 statistics, an optional shift and a fused activation
(kernel K4).

Counterpart of the JAX package's `ops/group_norm.py`: its plain functions
(`_reference`, `group_norm_shifted`) and its Pallas kernel `_kernel`, whose
Hopper port is `csrc/group_norm.cu`. Layout is channels-first: x (B, C,
*spatial). Statistics are one-pass E[x^2] - E[x]^2 in fp32 with the variance
clamped at 0; the output is cast back to x's dtype.

`group_norm` and `group_norm_shifted` take the plain version, `_reference`,
for a tensor on the CPU. For a CUDA tensor they launch K4 or raise, inside a
`torch.autograd.Function` whose backward recomputes through `_reference`
(the JAX package's custom VJP `_bwd` does the same) and returns gradients for
x, gamma, beta and the shift. Every GroupNorm of the port goes through here.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from morphablediffusion_torch.ops import _cuda

STATS_KERNEL = _cuda.CudaKernel(
    "group_norm_stats", "group_norm.cu", "md_group_norm_stats",
    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
APPLY_KERNEL = _cuda.CudaKernel(
    "group_norm_apply", "group_norm.cu", "md_group_norm_apply",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
KERNELS = (STATS_KERNEL, APPLY_KERNEL)  # one call launches each once

# elements of a row (one sample's channel) that one warp of the statistics
# launch sums; longer rows are cut into ceil(S / STATS_CHUNK) chunks
STATS_CHUNK = 4096
_ACT_CODE = {None: 0, "silu": 1, "relu": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

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


def _check_groups(C: int, num_groups: int) -> None:
    if C % num_groups:
        raise ValueError(f"GroupNorm: channels {C} not divisible by "
                         f"num_groups {num_groups}")


def _reference(x, shift, gamma, beta, num_groups: int = 32, epsilon: float = 1e-5,
               act: str | None = None):
    """Plain GroupNorm(x + shift[:, :, None, ...]) without materializing
    x + shift. shift: (B, C) or None.

    Adding a per-(sample, channel) constant moves the statistics
    analytically: colsum' = colsum + S*t and colsq' = colsq + 2*t*colsum +
    S*t^2, and the apply is a per-(B, C) affine."""
    B, C = x.shape[:2]
    _check_groups(C, num_groups)
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


def group_norm_kernel(x, shift, gamma, beta, num_groups: int, epsilon: float,
                      act: str | None):
    """Launch K4 (statistics, then apply; no autograd). x (B, C, ...)
    contiguous bf16 or fp32; gamma, beta (C,) fp32; shift (B, C) of any
    float dtype (cast to fp32 here) or None; all on one card, else this
    raises. Returns y like x."""
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"group_norm: the kernel takes bfloat16 or float32, got {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"group_norm: x must be (B, C, ...), got {tuple(x.shape)}")
    _cuda.check_cuda("group_norm", x.dtype, x)
    B, C = x.shape[:2]
    _check_groups(C, num_groups)
    params = [gamma, beta]
    if shift is not None:
        shift = shift.float().contiguous()
        params.append(shift)
    _cuda.check_cuda("group_norm", torch.float32, *params, device=x.device)
    if (gamma.shape != (C,) or beta.shape != (C,)
            or (shift is not None and shift.shape != (B, C))):
        raise ValueError(f"group_norm: gamma, beta must be ({C},) and shift ({B}, {C})")
    S = math.prod(x.shape[2:])
    splits = -(-S // STATS_CHUNK)
    part = torch.empty((B * C * splits, 2), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    stream, dt = _cuda.stream_of(x), _DTYPE_CODE[x.dtype]
    STATS_KERNEL.launch(_cuda.ptr(x), _cuda.ptr(part), B, C, S, splits, dt, stream)
    APPLY_KERNEL.launch(_cuda.ptr(x), _cuda.ptr(part), _cuda.ptr(gamma), _cuda.ptr(beta),
                        None if shift is None else _cuda.ptr(shift), _cuda.ptr(y),
                        B, C, num_groups, S, splits, epsilon, _ACT_CODE[act], dt, stream)
    return y


def recompute_grads(x, shift, gamma, beta, grad_out, num_groups: int, epsilon: float,
                    act: str | None, needs=(True, True, True, True)):
    """Gradients (x, shift, gamma, beta) of `_reference` at these inputs for
    the cotangent grad_out, None where `needs` says no or the input is None:
    the backward of the kernel's autograd Function."""
    return _cuda.recompute_grads(
        lambda *t: _reference(*t, num_groups, epsilon, act), (x, shift, gamma, beta),
        needs, grad_out)


class _GroupNorm(torch.autograd.Function):
    """Forward: the K4 kernel. Backward: recompute through `_reference`."""

    @staticmethod
    def forward(ctx, x, shift, gamma, beta, num_groups: int, epsilon: float, act):
        ctx.save_for_backward(x, shift, gamma, beta)
        ctx.args = (num_groups, epsilon, act)
        return group_norm_kernel(x, shift, gamma, beta, num_groups, epsilon, act)

    @staticmethod
    def backward(ctx, g):
        grads = recompute_grads(*ctx.saved_tensors, g, *ctx.args,
                                needs=ctx.needs_input_grad[:4])
        return grads + (None,) * 3


def group_norm_shifted(x, shift, gamma, beta, num_groups: int = 32,
                       epsilon: float = 1e-5, act: str | None = None):
    """GroupNorm(x + shift[:, :, None, ...]) (+act) without materializing
    x + shift. x (B, C, ...); shift (B, C) or None; gamma, beta (C,).

    CPU tensors take `_reference`; CUDA tensors the K4 kernel (x contiguous
    bf16 or fp32, gamma and beta fp32, else this raises), differentiable
    through `_GroupNorm`."""
    if not x.is_cuda:
        return _reference(x, shift, gamma, beta, num_groups, epsilon, act)
    return _GroupNorm.apply(x, shift, gamma, beta, num_groups, epsilon, act)


def group_norm(x, gamma, beta, num_groups: int = 32, epsilon: float = 1e-5,
               act: str | None = None):
    """GroupNorm(+act). x: (B, C, ...); gamma/beta: (C,)."""
    return group_norm_shifted(x, None, gamma, beta, num_groups, epsilon, act)
