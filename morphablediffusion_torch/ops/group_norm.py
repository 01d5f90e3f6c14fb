"""GroupNorm with fp32 statistics, an optional shift and a fused activation
(kernel K4).

Counterpart of the JAX package's `ops/group_norm.py`: its plain functions
(`_reference`, `group_norm_shifted`) and its Pallas kernel `_kernel`, whose
Hopper port is `csrc/group_norm.cu`. Shapes are channels-first: x (B, C,
*spatial). In memory x is contiguous (NCHW, NCDHW, ...) or, for a 4-D map,
channels-last (NHWC), and the output keeps x's layout: `kernel_layout` is
the rule, and on the card each layout takes its own design of the kernel in
the same entry point. Statistics are one-pass E[x^2] - E[x]^2 in fp32 with
the variance clamped at 0; the output is cast back to x's dtype.

`group_norm` and `group_norm_shifted` take the plain version, `_reference`,
for a tensor on the CPU. For a CUDA tensor they launch K4 or raise: one
launch per call, planned by shape and dtype (`gn_plan`). Where a gradient is
needed, the launch sits inside a `torch.autograd.Function` whose backward
recomputes through `_reference` (the JAX package's custom VJP `_bwd` does
the same) and returns gradients for x, gamma, beta and the shift; where none
is (inference, or no input that requires one), the kernel is called
directly. Every GroupNorm of the port goes through here. `nhwc_launches`
counts the launches that took the channels-last design, beside
`KERNEL.launches`, which counts all of them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from morphablediffusion_torch.ops import _cuda

KERNEL = _cuda.CudaKernel(
    "group_norm", "group_norm.cu", "md_group_norm",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
    + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
KERNELS = (KERNEL,)  # one call launches it once
nhwc_launches = 0  # of KERNEL.launches, those in the channels-last layout

NCHW, NHWC = 0, 1  # x's layout in memory: the entry point's `layout`

_ACT_CODE = {None: 0, "silu": 1, "relu": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SHIFT_CODE = {torch.float32: 1, torch.bfloat16: 2}

# The plan of a launch (csrc/group_norm.cu::Plan). A block has GN_THREADS
# threads. A (sample, group) pair's span of cg*S elements goes to a cluster
# of up to GN_MAX_CLUSTER blocks, enough that each takes at most
# GN_TARGET_BYTES of it, and more (down to GN_MIN_CHUNK_BYTES a block) while
# the grid has fewer than GN_FILL blocks. A block holds up to
# GN_MAX_HELD_BYTES of its share in shared memory (six blocks an SM) and
# reads the rest twice: on the H100, blocks that held 64 or 128 KiB ran
# slower than blocks that held 32 KiB and read the rest twice
# (chip_smoke.py::gn_alternatives times them; PERF.md). Spans too small to
# give every thread of a block a vector go several to a block.
GN_THREADS = 256
GN_MAX_CLUSTER = 8
GN_TARGET_BYTES = 32 * 1024
GN_MIN_CHUNK_BYTES = 4 * 1024
GN_MAX_HELD_BYTES = 32 * 1024
GN_FILL = 132  # a block for each of the H100's 132 SMs
GN_MAX_PACK = 8    # pairs per block: one warp each at most
GN_RED_BYTES = 400  # the kernel's reduction scratch (csrc/group_norm.cu::RED_BYTES)
GN_MAX_TABLE = 232448 // 12  # per-channel entries (shift, A, B2) a block may hold
GN_MAX_SMEM = 232448  # the most shared memory a block may have
# A channels-last block takes `pack` rows of C / vec threads at once, as
# many as fit GN_NHWC_THREADS while each thread keeps GN_NHWC_MIN_ROWS of
# the block's rows; a row's slices are at most GN_NHWC_MAX_THREADS threads.
# A block holds all its rows where they take GN_NHWC_RESIDENT_BYTES or less,
# else GN_MAX_HELD_BYTES of them: on the H100, blocks that held 64 KiB to
# 200 KiB of a larger share ran slower than blocks that held 32 KiB and read
# the rest twice, and 256 or 1 024 threads slower than 512 at the VAE's maps
# (PERF.md §6).
GN_NHWC_THREADS = 512
GN_NHWC_MIN_ROWS = 8
GN_NHWC_MAX_THREADS = 1024
GN_NHWC_RESIDENT_BYTES = 128 * 1024


class GnPlan(NamedTuple):
    """How K4 runs one call. NCHW: `cluster` blocks per (sample, group)
    pair, or `pack` pairs per block; `chunk` elements of a pair's span per
    block, of which a block holds the first `held` in shared memory (and
    reads the rest twice); `vec` elements per load. NHWC: `cluster` blocks
    per sample; `chunk` pixel rows per block, `pack` of them at once, the
    first `held` of them held; `vec` channels a thread's slice. Both:
    `blocks` in the grid, `smem` bytes and `threads` a block, and x's
    `layout`."""
    cluster: int
    pack: int
    chunk: int
    held: int
    vec: int
    blocks: int
    smem: int
    layout: int = NCHW
    threads: int = 256

    @property
    def resident(self) -> bool:
        """Whether x is read from device memory once."""
        return self.held == self.chunk


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def _gn_smem(cg: int, pack: int, held: int, esize: int) -> int:
    """A block's shared memory (csrc/group_norm.cu::Plan): the elements it
    holds, the shift, A and B2 of its channels, the reduction scratch."""
    return _up16(pack * held * esize) + 3 * _up16(pack * cg * 4) + GN_RED_BYTES


def _gn_smem_nhwc(C: int, G: int, ry: int, held: int, esize: int) -> int:
    """A channels-last block's shared memory (csrc/group_norm.cu::PlanN):
    the rows it holds, the shift, A and B2 of the channels, its
    per-channel sums, the rows' sums (then the cluster's), the groups'
    statistics."""
    return (_up16(held * C * esize) + 3 * _up16(C * 4) + _up16(2 * C * 4)
            + _up16(max(ry, 2) * C * 4) + _up16(2 * G * 4))


def nhwc_rows(C: int, vec: int, chunk: int) -> int:
    """Rows a channels-last block takes at once (its plan's `pack`)."""
    return max(1, min(GN_NHWC_THREADS // (C // vec), chunk // GN_NHWC_MIN_ROWS))


def kernel_layout(x) -> int | None:
    """K4's layout for x on the card: NCHW where x is contiguous (a map that
    is both, such as (B, C, 1, 1), counts as NCHW), NHWC where a 4-D x is
    contiguous in `torch.channels_last`, else None (the caller copies x to
    NCHW first)."""
    if x.is_contiguous():
        return NCHW
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return NHWC
    return None


@functools.lru_cache(maxsize=1024)
def gn_plan(shape, dtype: torch.dtype, num_groups: int, aligned: bool = True,
            layout: int = NCHW) -> GnPlan:
    """K4's plan for x of `shape` (B, C, ...) and `dtype` in `num_groups`
    groups, laid out as `layout` (NCHW or NHWC, `kernel_layout`); `aligned`:
    x starts 16-byte aligned (else every load is one element). Raises
    ValueError for what the kernel cannot take. Cached: the port makes a
    few dozen shapes, each thousands of times."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"group_norm: the kernel takes bfloat16 or float32, got {dtype}")
    if len(shape) < 2 or min(shape) < 1:
        raise ValueError(f"group_norm: x must be a non-empty (B, C, ...), got {tuple(shape)}")
    if layout not in (NCHW, NHWC):
        raise ValueError(f"group_norm: layout {layout} is neither NCHW ({NCHW}) nor NHWC "
                         f"({NHWC})")
    B, C = shape[:2]
    _check_groups(C, num_groups)
    S = math.prod(shape[2:])
    esize = 4 if dtype == torch.float32 else 2
    if layout == NHWC:
        return _gn_plan_nhwc(B, C, S, len(shape), num_groups, esize, aligned)
    cg = C // num_groups
    span, pairs = cg * S, B * num_groups
    if span >= 2**31:
        raise ValueError(f"group_norm: a group's {span} elements exceed 2^31")
    vec = 16 // esize if aligned and S % (16 // esize) == 0 else 1
    pack = 1
    while pack < GN_MAX_PACK and span * pack < GN_THREADS * vec:
        pack *= 2
    cluster = 1
    if pack == 1:
        span_bytes = span * esize
        while cluster < GN_MAX_CLUSTER and (
                span_bytes > cluster * GN_TARGET_BYTES
                or (pairs * cluster < GN_FILL
                    and span_bytes >= 2 * cluster * GN_MIN_CHUNK_BYTES)):
            cluster *= 2
    chunk = -(-span // (cluster * vec)) * vec
    held = chunk if pack > 1 else min(chunk, GN_MAX_HELD_BYTES // (esize * vec) * vec)
    if pack * cg > GN_MAX_TABLE:
        raise ValueError(f"group_norm: {cg} channels per group exceed the kernel's "
                         f"{GN_MAX_TABLE}")
    return GnPlan(cluster, pack, chunk, held, vec, -(-pairs // pack) * cluster,
                  _gn_smem(cg, pack, held, esize))


def _gn_plan_nhwc(B: int, C: int, S: int, ndim: int, G: int, esize: int,
                  aligned: bool) -> GnPlan:
    """gn_plan for a channels-last map: a cluster per sample, split like a
    pair's span in NCHW (at most GN_TARGET_BYTES a block, more blocks while
    the grid is short of GN_FILL), in whole pixel rows."""
    if ndim != 4:
        raise ValueError(f"group_norm: the channels-last layout takes a 4-D map, got {ndim}-D")
    if S * C >= 2**31:
        raise ValueError(f"group_norm: a sample's {S * C} elements exceed 2^31")
    full = 16 // esize
    vec = full if aligned and C % full == 0 else 1
    if C // vec > GN_NHWC_MAX_THREADS:
        raise ValueError(f"group_norm: a channels-last row of {C} channels in slices of "
                         f"{vec} exceeds the kernel's {GN_NHWC_MAX_THREADS} threads")
    sample_bytes = S * C * esize
    cluster = 1
    while cluster < GN_MAX_CLUSTER and cluster < S and (
            sample_bytes > cluster * GN_TARGET_BYTES
            or (B * cluster < GN_FILL and sample_bytes >= 2 * cluster * GN_MIN_CHUNK_BYTES)):
        cluster *= 2
    chunk = -(-S // cluster)
    ry = nhwc_rows(C, vec, chunk)
    row = C * esize
    held = chunk if chunk * row <= GN_NHWC_RESIDENT_BYTES else min(chunk, GN_MAX_HELD_BYTES // row)
    held = max(0, min(held, (GN_MAX_SMEM - _gn_smem_nhwc(C, G, ry, 0, esize)) // row))
    smem = _gn_smem_nhwc(C, G, ry, held, esize)
    if smem > GN_MAX_SMEM:
        raise ValueError(f"group_norm: {C} channels' tables exceed a block's shared memory")
    return GnPlan(cluster, ry, chunk, held, vec, B * cluster, smem, NHWC, C // vec * ry)


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
                      act: str | None, plan: GnPlan | None = None):
    """Launch K4 once (no autograd). x (B, C, ...) bf16 or fp32, contiguous
    or a channels-last 4-D map (`kernel_layout`); gamma, beta (C,) fp32;
    shift (B, C) contiguous bf16 or fp32, read as given, or None; all on one
    card, else this raises. `plan` defaults to `gn_plan`'s (chip_smoke.py
    also times others). Returns y like x, in x's layout."""
    global nhwc_launches
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"group_norm: the kernel takes bfloat16 or float32, got {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"group_norm: x must be (B, C, ...), got {tuple(x.shape)}")
    layout = kernel_layout(x)
    if layout is None:
        raise ValueError("group_norm: x must be contiguous, or a channels-last 4-D map")
    if not x.is_cuda:
        raise ValueError("group_norm: all tensors must be on one CUDA device")
    B, C = x.shape[:2]
    _check_groups(C, num_groups)
    _cuda.check_cuda("group_norm", torch.float32, gamma, beta, device=x.device)
    if shift is not None:
        if shift.dtype not in _SHIFT_CODE:
            raise ValueError(f"group_norm: the shift must be bfloat16 or float32, "
                             f"got {shift.dtype}")
        _cuda.check_cuda("group_norm", shift.dtype, shift, device=x.device)
    if (gamma.shape != (C,) or beta.shape != (C,)
            or (shift is not None and shift.shape != (B, C))):
        raise ValueError(f"group_norm: gamma, beta must be ({C},) and shift ({B}, {C})")
    if plan is None:
        plan = gn_plan(x.shape, x.dtype, num_groups, x.data_ptr() % 16 == 0, layout)
    elif plan.layout != layout:
        raise ValueError(f"group_norm: a plan for layout {plan.layout}, x in {layout}")
    y = torch.empty_like(x)
    KERNEL.launch(_cuda.ptr(x), _cuda.ptr(gamma), _cuda.ptr(beta),
                  None if shift is None else _cuda.ptr(shift), _cuda.ptr(y),
                  B, C, num_groups, math.prod(x.shape[2:]), plan.pack, plan.cluster,
                  plan.chunk, plan.held, plan.vec, epsilon, _ACT_CODE[act],
                  _DTYPE_CODE[x.dtype], 0 if shift is None else _SHIFT_CODE[shift.dtype],
                  layout, _cuda.stream_of(x))
    nhwc_launches += layout == NHWC
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

    CPU tensors take `_reference`; CUDA tensors the K4 kernel (x bf16 or
    fp32, contiguous or a channels-last 4-D map, gamma and beta fp32, the
    shift bf16 or fp32, else this raises): through `_GroupNorm` where
    autograd needs a gradient, else launched directly."""
    if not x.is_cuda:
        return _reference(x, shift, gamma, beta, num_groups, epsilon, act)
    if _cuda.needs_autograd(x, shift, gamma, beta):
        return _GroupNorm.apply(x, shift, gamma, beta, num_groups, epsilon, act)
    return group_norm_kernel(x, shift, gamma, beta, num_groups, epsilon, act)


def group_norm(x, gamma, beta, num_groups: int = 32, epsilon: float = 1e-5,
               act: str | None = None):
    """GroupNorm(+act). x: (B, C, ...); gamma/beta: (C,)."""
    return group_norm_shifted(x, None, gamma, beta, num_groups, epsilon, act)
