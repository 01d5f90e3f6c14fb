"""Depth-wise attention and the fused depth-context chain (kernel K1).

Counterpart of the JAX package's `ops/depth_attention.py`. The paper's
3D-aware attention attends over the frustum depth axis only: for every pixel
and head, softmax over d of <q, k_d> * hd^-1/2, then the depth-weighted sum of
v_d.

At serving, every DepthTransformer runs the fused context chain
proj_context -> GroupNorm(relu) -> to_k/to_v -> depth attention. The
GroupNorm statistics of the bias-free projection follow from the context's
first and second moments (`ctx_moments`, `_ctx_affine`, plain fp32 torch,
outside the kernel), so the norm folds into a per-(sample, channel) affine
y = relu(p * A + B2), and the kernel `csrc/depth_attention_ctx.cu` streams
the raw context once without writing any (B, C, D, H, W) tensor. It has three
designs, chosen by shape before launch (`ctx_design`): the Hopper one (TMA,
wgmma, the chain in registers) at the two wide levels, the cluster one
(`csrc/depth_attention_ctx_cluster.cu`: a thread-block cluster per 64-row
tile that splits the projection and the heads, y shared over distributed
shared memory; planned by `ctx_cluster_plan`) at the two narrow levels, and
the WMMA one for every other shape.

Layout is channels-first: q (B, Ci, H, W), context (B, Cc, D, H, W), k/v
(B, C, D, H, W), outputs (B, Ci, H, W). Weights are nn.Linear (out, in).

Training keeps the unfused chain where the fused kernel does not run (the
W=4 middle block): proj_context -> GroupNorm(relu) -> to_k/to_v ->
`depth_attention`, whose Hopper kernel `csrc/depth_attention.cu` (K3)
replaces the JAX package's Pallas `_kernel`.

Every wrapper takes its plain version for a tensor on the CPU, which autograd
differentiates. For a CUDA tensor it launches the kernel or raises, inside a
`torch.autograd.Function` whose backward recomputes through the plain
version, as the JAX package's custom VJPs do (`_bwd`, `_ctx_bwd`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from morphablediffusion_torch.ops import _cuda

_CTX_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
KERNEL = _cuda.CudaKernel(  # K1, the WMMA design
    "depth_attention_ctx", "depth_attention_ctx.cu", "md_depth_attention_ctx_fwd", _CTX_ARGS)
WGMMA_KERNEL = _cuda.CudaKernel(  # K1, the Hopper design
    "depth_attention_ctx_wgmma", "depth_attention_ctx.cu", "md_depth_attention_ctx_wgmma",
    _CTX_ARGS)
CLUSTER_KERNEL = _cuda.CudaKernel(  # K1, the cluster design
    "depth_attention_ctx_cluster", "depth_attention_ctx_cluster.cu",
    "md_depth_attention_ctx_cluster",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
DEPTH_KERNEL = _cuda.CudaKernel(  # K3
    "depth_attention", "depth_attention.cu", "md_depth_attention_fwd",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])


def _reference(q, k, v, num_heads: int):
    """Plain depth attention: q (B, C, H, W); k, v (B, C, D, H, W) ->
    (B, C, H, W). Logits and softmax in fp32, weights cast to v's dtype."""
    B, C, H, W = q.shape
    D = k.shape[2]
    hd = C // num_heads
    qh = q.reshape(B, num_heads, hd, H * W).float()
    kh = k.reshape(B, num_heads, hd, D, H * W).float()
    vh = v.reshape(B, num_heads, hd, D, H * W)
    sim = torch.einsum("bncs,bncds->bnds", qh, kh) * hd**-0.5
    attn = torch.softmax(sim, dim=2).to(v.dtype)
    out = torch.einsum("bnds,bncds->bncs", attn, vh)
    return out.reshape(B, C, H, W)


def ctx_moments(ctx):
    """Per-sample first and second moments of the context channels, fp32:
    mean_x (B, Cc) and m2 (B, Cc, Cc) = E[x x^T] over depth and pixels.
    Computed once per frustum width and shared by the blocks that read it."""
    B, Cc = ctx.shape[:2]
    flat = ctx.reshape(B, Cc, -1).float()
    S = flat.shape[-1]
    mean_x = flat.sum(-1) / S
    m2 = torch.bmm(flat, flat.transpose(1, 2)) / S
    return mean_x, m2


def _ctx_affine(mean_x, m2, Wp, gn_scale, gn_bias, num_groups: int, eps: float):
    """Fold proj + GroupNorm into per-(B, Cc) affine A, B2 (fp32).

    E[p] = Wp E[x] and E[p_f^2] = (Wp M2 Wp^T)_ff; Wp is (out, in)."""
    B, Cc = mean_x.shape
    cg = Cc // num_groups
    wp = Wp.float()
    mean_p = mean_x @ wp.t()
    e2 = ((m2 @ wp.t()) * wp.t()[None]).sum(1)
    mu_g = mean_p.reshape(B, num_groups, cg).sum(-1) / cg
    e2_g = e2.reshape(B, num_groups, cg).sum(-1) / cg
    var = torch.clamp(e2_g - mu_g * mu_g, min=0.0)
    inv = torch.rsqrt(var + eps)
    A = gn_scale.float()[None] * inv.repeat_interleave(cg, dim=1)
    B2 = gn_bias.float()[None] - mu_g.repeat_interleave(cg, dim=1) * A
    return A, B2


def _ctx_reference(q, ctx, Wp, A, B2, Wk, Wv, num_heads: int):
    """Plain fused-chain version of the kernel (same math, unfused)."""
    p = torch.einsum("oc,bcdhw->bodhw", Wp.to(ctx.dtype), ctx)
    y = torch.relu(p.float() * A[:, :, None, None, None]
                   + B2[:, :, None, None, None]).to(ctx.dtype)
    k = torch.einsum("oc,bcdhw->bodhw", Wk.to(y.dtype), y)
    v = torch.einsum("oc,bcdhw->bodhw", Wv.to(y.dtype), y)
    return _reference(q, k, v, num_heads)


def _tile(B: int, S: int, num_heads: int) -> int:
    """Pixels per block of the WMMA design: 64 where that still gives >= 256
    blocks, else 16."""
    return 64 if S % 64 == 0 and B * (S // 64) * num_heads >= 256 else 16


# (Cc, head_dim) -> (G, blocks per SM) for each number of heads per block G
# that the Hopper design is built for, fewest FLOPs first
# (csrc/depth_attention_ctx.cu::MD_CTX_WGMMA_CONFIGS; the blocks per SM are
# what the card reports for each configuration's shared memory and
# registers, logged by chip_smoke.py::k1_resources)
WGMMA_GROUPS = {(64, 32): ((4, 2), (2, 3)), (128, 64): ((2, 1), (1, 2))}
WGMMA_TILE = 64  # pixels per block: the rows of a wgmma tile
# blocks that fill the H100's 132 SMs once: the main path's grids come in
# multiples of 64 blocks, and 128 leaves 4 SMs idle
WGMMA_FILL = 128


# K1's cluster design (csrc/depth_attention_ctx_cluster.cu): a cluster of
# Cc / CLUSTER_NP blocks per tile of CLUSTER_ROWS rows (sample, pixel), or
# per two tiles (a warpgroup each); a block owns CLUSTER_NP channels of the
# projection and CLUSTER_KV of k and of v, holds its Wk and Wv rows and all
# of y, and streams ctx and its Wp rows by TMA through a ring of up to
# CLUSTER_MAX_STAGES 64-channel slots.
CLUSTER_CC = (256, 512)  # the Cc it is built for: clusters of 8 and 16
CLUSTER_ROWS = 64
CLUSTER_NP = 32
CLUSTER_KV = 64
CLUSTER_MAX_STAGES = 8
CLUSTER_PIXELS = (16, 32, 64)  # H*W it takes: a tile holds 64 / (H*W) samples
CLUSTER_TPC = {256: (1, 2), 512: (1,)}  # the tiles a cluster it is built for, by Cc
# clusters of 8 and of 16 blocks of the design that an H100 holds at once
# (cudaOccupancyMaxActiveClusters, logged by chip_smoke.py): more tiles
# than these at one tile a cluster would run in two waves
CLUSTER_RESIDENT = {8: 15, 16: 7}
MAX_BLOCK_SMEM = 232448  # the most shared memory an H100 block may have


class ClusterPlan(NamedTuple):
    """How K1's cluster design runs one call: clusters of `cluster` blocks,
    each taking `tpc` tiles of 64 rows (a warpgroup of a block each) that
    hold `samples` samples' pixels; `tiles` tiles, `blocks` in the grid;
    `held` is what a block loads once and keeps, `streamed` what flows
    through its ring of `stages` slots per depth; `smem` bytes a block."""
    cluster: int
    tpc: int
    samples: int
    tiles: int
    blocks: int
    stages: int
    held: str
    streamed: str
    smem: int


def _cluster_smem(Cc: int, stages: int, tpc: int = 1) -> int:
    """A block's shared memory (csrc/depth_attention_ctx_cluster.cu::Clu)
    at `tpc` tiles a cluster: the Wk and Wv slices, y per tile, the ring,
    per tile the head's partial logits for two depths, the mbarriers, 1024
    bytes of alignment."""
    row = 128  # bytes of a 64-channel row
    cluster = Cc // CLUSTER_NP
    held = 2 * (Cc // 64) * CLUSTER_KV * row + tpc * CLUSTER_ROWS * Cc * 2
    ring = stages * (tpc * 64 * row + CLUSTER_NP * row)
    part = tpc * 2 * cluster * CLUSTER_ROWS * 4
    return held + ring + part + 8 * (1 + tpc + CLUSTER_MAX_STAGES) + 1024


def ctx_cluster_plan(B: int, S: int, D: int, Cc: int, Ci: int, num_heads: int,
                     tpc: int | None = None) -> ClusterPlan:
    """K1's cluster-design plan for q (B, Ci, S) and ctx (B, Cc, D, S).

    The cluster is Cc / 32 blocks (8 at Cc = 256, 16 at 512), which needs
    Ci = 2 Cc and a head_dim that is a multiple of 64 (a head is head_dim /
    64 blocks); a tile is 64 rows, 64 / S samples of S pixels (S 16, 32 or
    64), the last one zero-filled past B. A cluster takes two tiles (`tpc`)
    where it is built for two and there are more tiles than the card holds
    clusters at once (CLUSTER_RESIDENT; else one, or `tpc` if given). The
    ring takes as many stages as fit next to the held slices, up to 8.
    Raises ValueError for a shape the kernel cannot take."""
    if num_heads < 1 or Ci % num_heads:
        raise ValueError(f"depth_attention_ctx: {Ci} channels do not split into "
                         f"{num_heads} heads")
    hd = Ci // num_heads
    if Ci != 2 * Cc or hd % CLUSTER_KV or Cc % CLUSTER_NP:
        raise ValueError(f"depth_attention_ctx cluster design: needs Ci = 2 Cc and head_dim "
                         f"a multiple of {CLUSTER_KV}; got Cc={Cc}, Ci={Ci}, head_dim={hd}")
    if min(B, D) < 1 or S not in CLUSTER_PIXELS:
        raise ValueError(f"depth_attention_ctx cluster design: needs H*W in "
                         f"{CLUSTER_PIXELS} and B, D >= 1; got H*W={S}, B={B}, D={D}")
    cluster, samples = Cc // CLUSTER_NP, CLUSTER_ROWS // S
    tiles = -(-B // samples)
    if tpc is None:
        tpc = 2 if tiles > CLUSTER_RESIDENT.get(cluster, tiles) and 2 in CLUSTER_TPC.get(
            Cc, ()) else 1
    room = MAX_BLOCK_SMEM - _cluster_smem(Cc, 0, tpc)
    stages = min(CLUSTER_MAX_STAGES,
                 room // (_cluster_smem(Cc, 1, tpc) - _cluster_smem(Cc, 0, tpc)))
    if stages < 2:
        raise ValueError(f"depth_attention_ctx cluster design: Cc={Cc} at {tpc} tiles a "
                         f"cluster overruns a block's shared memory "
                         f"({_cluster_smem(Cc, 2, tpc)} B with two ring stages > "
                         f"{MAX_BLOCK_SMEM})")
    if tpc not in CLUSTER_TPC.get(Cc, ()):
        raise ValueError(f"depth_attention_ctx cluster design: not built for Cc={Cc} at "
                         f"{tpc} tiles a cluster (built for {CLUSTER_TPC})")
    return ClusterPlan(cluster, tpc, samples, tiles, -(-tiles // tpc) * cluster, stages,
                       f"Wk, Wv slices {2 * CLUSTER_KV} x {Cc}, y 64 x {Cc} per tile",
                       f"ctx 64 x 64 + Wp slice {CLUSTER_NP} x 64 per slot (TMA)",
                       _cluster_smem(Cc, stages, tpc))


class CtxDesign(NamedTuple):
    """Which K1 design runs a shape: `kernel` "wgmma" (the Hopper design),
    "cluster" (the cluster design) or "wmma" (the port's first); `group` is
    heads per block (the cluster design: blocks per cluster), `tile` pixels
    per block (the cluster design: rows per cluster, 64 a tile)."""
    kernel: str
    group: int
    tile: int

    def blocks(self, B: int, S: int, num_heads: int) -> int:
        if self.kernel == "cluster":
            return -(-B // (self.tile // S)) * self.group
        return B * (S // self.tile) * (num_heads // self.group)


def ctx_design(B: int, S: int, Cc: int, Ci: int, num_heads: int) -> CtxDesign:
    """The K1 design for q (B, Ci, S) and ctx (B, Cc, D, S) at num_heads.

    The cluster design takes every shape `ctx_cluster_plan` takes: the main
    path's W=8 and W=4 (its plan does not depend on D). The Hopper design takes (Cc, head_dim) in `WGMMA_GROUPS` with S a
    multiple of 64: the main path's W=32 and W=16. Its G is the largest that
    divides num_heads and whose grid still fills the card at its blocks per
    SM (WGMMA_FILL of them per block an SM holds), else the smallest: on the
    H100 fewer FLOPs won wherever the grid filled the card, more blocks
    where it did not (chip_smoke.py times every G; PERF.md). Every other
    shape takes the WMMA design (Cc and head_dim multiples of 16, S a
    multiple of its tile). Raises ValueError for a shape that neither
    takes."""
    if num_heads < 1 or Ci % num_heads:
        raise ValueError(f"depth_attention_ctx: {Ci} channels do not split into "
                         f"{num_heads} heads")
    hd = Ci // num_heads
    try:
        plan = ctx_cluster_plan(B, S, 1, Cc, Ci, num_heads)
        return CtxDesign("cluster", plan.cluster, CLUSTER_ROWS * plan.tpc)
    except ValueError:
        pass
    options = [(CtxDesign("wgmma", g, WGMMA_TILE), per_sm)
               for g, per_sm in WGMMA_GROUPS.get((Cc, hd), ()) if num_heads % g == 0]
    if options and S % WGMMA_TILE == 0:
        return next((o for o, per_sm in options
                     if o.blocks(B, S, num_heads) >= WGMMA_FILL * per_sm), options[-1][0])
    tile = _tile(B, S, num_heads)
    if hd % 16 or Cc % 16 or S % tile:
        raise ValueError(f"depth_attention_ctx: needs Cc, head_dim multiples of "
                         f"16 and H*W a multiple of {tile}; got Cc={Cc}, "
                         f"head_dim={hd}, H*W={S}")
    return CtxDesign("wmma", 1, tile)


def ctx_attention(q, ctx, Wp, A, B2, Wk, Wv, num_heads: int):
    """relu((Wp ctx) * A + B2) -> k, v -> depth attention with q.

    q (B, Ci, H, W); ctx (B, Cc, D, H, W); Wp (Cc, Cc); A, B2 (B, Cc) fp32;
    Wk, Wv (Ci, Cc). Returns (B, Ci, H, W), before to_out. CPU tensors take
    `_ctx_reference`; CUDA tensors go to the kernel of `ctx_design`, which
    takes bf16 (16-byte aligned for the Hopper design's tensor maps and the
    cluster design's 16-byte copies).
    """
    if not q.is_cuda:
        return _ctx_reference(q, ctx, Wp, A, B2, Wk, Wv, num_heads)
    B, Ci, H, W = q.shape
    return _launch_ctx(q, ctx, Wp, A, B2, Wk, Wv, num_heads,
                       ctx_design(B, H * W, ctx.shape[1], Ci, num_heads))


# the CudaKernel of each K1 design
CTX_KERNELS = {"wmma": KERNEL, "wgmma": WGMMA_KERNEL, "cluster": CLUSTER_KERNEL}


def _launch_ctx(q, ctx, Wp, A, B2, Wk, Wv, num_heads: int, design: CtxDesign):
    """Launch `design`'s kernel (`ctx_attention` passes `ctx_design`'s;
    chip_smoke.py also times the other designs a shape could take)."""
    _cuda.check_cuda("depth_attention_ctx", torch.bfloat16, q, ctx, Wp, Wk, Wv)
    _cuda.check_cuda("depth_attention_ctx", torch.float32, A, B2, device=q.device)
    B, Ci, H, W = q.shape
    Cc, D = ctx.shape[1], ctx.shape[2]
    if (ctx.shape != (B, Cc, D, H, W) or Wp.shape != (Cc, Cc)
            or Wk.shape != (Ci, Cc) or Wv.shape != (Ci, Cc)
            or A.shape != (B, Cc) or B2.shape != (B, Cc) or D < 1):
        raise ValueError("depth_attention_ctx: inconsistent shapes")
    out = torch.empty_like(q)
    args = [_cuda.ptr(t) for t in (q, ctx, Wp, A, B2, Wk, Wv, out)]
    if design.kernel in ("wgmma", "cluster"):
        _cuda.check_aligned("depth_attention_ctx", q, ctx, Wp, Wk, Wv)
    if design.kernel == "cluster":
        plan = ctx_cluster_plan(B, H * W, D, Cc, Ci, num_heads, design.tile // CLUSTER_ROWS)
        CLUSTER_KERNEL.launch(*args, B, D, H * W, Cc, Ci, num_heads, plan.cluster, plan.tpc,
                              (Ci // num_heads) ** -0.5, _cuda.stream_of(q))
    elif design.kernel == "wgmma":
        WGMMA_KERNEL.launch(*args, B, D, H * W, Cc, Ci, num_heads, design.group,
                            (Ci // num_heads) ** -0.5, _cuda.stream_of(q))
    else:
        KERNEL.launch(*args, B, D, H * W, Cc, Ci, num_heads, design.tile,
                      (Ci // num_heads) ** -0.5, _cuda.stream_of(q))
    return out


# K3's plan (csrc/depth_attention.cu): blocks of K3_THREADS threads; a
# cluster of up to K3_MAX_CLUSTER blocks splits a head's channels, each block
# keeping at least K3_MIN_SLICE of them; a block's shared memory (its slices
# of q, k, v and the D x P logits) stays within K3_MAX_SMEM, which holds
# three blocks on an SM.
K3_THREADS = 128
K3_MAX_CLUSTER = 8
K3_MIN_SLICE = 16
K3_MAX_SMEM = 64 * 1024
K3_TILES = (32, 16, 8)  # pixels per block where H*W > 64


class DepthPlan(NamedTuple):
    """How K3 runs one call: a cluster of `cluster` blocks per (sample,
    head, tile of `tile` pixels), each owning head_dim / cluster channels;
    `vec` elements per copy (8: 16 bytes); `blocks` in the grid; `smem`
    bytes a block."""
    cluster: int
    tile: int
    vec: int
    blocks: int
    smem: int


def _k3_smem(cs: int, D: int, P: int) -> int:
    """A block's shared memory (csrc/depth_attention.cu::Layout): k and v
    slices, the q slice, the partial logits and the probabilities."""
    up16 = lambda n: -(-n // 16) * 16
    return 2 * up16(cs * D * P * 2) + up16(cs * P * 2) + 2 * up16(D * P * 4)


def depth_plan(B: int, C: int, D: int, S: int, heads: int) -> DepthPlan:
    """K3's plan for q (B, C, S) and k, v (B, C, D, S) in `heads` heads.

    The cluster is the largest of 8, 4, 2 that divides head_dim and leaves
    each block K3_MIN_SLICE channels or more, else 1. The tile is all of H*W
    where that is at most 64 pixels (one contiguous run per channel), else
    32 pixels, halved until the block fits K3_MAX_SMEM. Raises ValueError
    for a shape the kernel cannot take."""
    if heads < 1 or C % heads:
        raise ValueError(f"depth_attention: {C} channels do not split into {heads} heads")
    if min(B, D, S) < 1:
        raise ValueError(f"depth_attention: empty shape B={B} D={D} H*W={S}")
    hd = C // heads
    cluster = next((c for c in (8, 4, 2) if c <= K3_MAX_CLUSTER and hd % c == 0
                    and hd // c >= K3_MIN_SLICE), 1)
    cs = hd // cluster
    tiles = ([S] if S <= 64 else []) + [p for p in K3_TILES if p < S]
    tile = next((p for p in tiles if _k3_smem(cs, D, p) <= K3_MAX_SMEM), None)
    if tile is None:
        raise ValueError(f"depth_attention: head_dim {hd} over D={D} depths does not fit "
                         f"a block ({_k3_smem(cs, D, tiles[-1])} B of shared memory at "
                         f"{tiles[-1]} pixels > {K3_MAX_SMEM})")
    vec = 8 if S % 8 == 0 and tile % 8 == 0 else 1
    return DepthPlan(cluster, tile, vec, B * heads * -(-S // tile) * cluster,
                     _k3_smem(cs, D, tile))


def attention_kernel(q, k, v, num_heads: int):
    """Launch the depth-attention kernel once (no autograd): q (B, C, H, W);
    k, v (B, C, D, H, W); contiguous bf16 on one card (16-byte aligned where
    the plan copies 16 bytes at a time), else this raises."""
    _cuda.check_cuda("depth_attention", torch.bfloat16, q, k, v)
    B, C, H, W = q.shape
    D = k.shape[2]
    if k.shape != (B, C, D, H, W) or v.shape != k.shape or C % num_heads:
        raise ValueError(f"depth_attention: bad shapes {q.shape} {k.shape} "
                         f"{v.shape} for {num_heads} heads")
    S, hd = H * W, C // num_heads
    plan = depth_plan(B, C, D, S, num_heads)
    if plan.vec > 1:
        _cuda.check_aligned("depth_attention", q, k, v)
    out = torch.empty_like(q)
    DEPTH_KERNEL.launch(_cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(out),
                        B, C, D, S, num_heads, plan.tile, plan.cluster, plan.vec, hd**-0.5,
                        _cuda.stream_of(q))
    return out


class _DepthAttention(torch.autograd.Function):
    """Forward: the K3 kernel. Backward: recompute through `_reference`."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads = num_heads
        return attention_kernel(q, k, v, num_heads)

    @staticmethod
    def backward(ctx, g):
        heads = ctx.num_heads
        grads = _cuda.recompute_grads(lambda q, k, v: _reference(q, k, v, heads),
                                 ctx.saved_tensors, ctx.needs_input_grad[:3], g)
        return grads + (None,)


def depth_attention(q, k, v, num_heads: int):
    """Depth attention on projected q (B, C, H, W), k, v (B, C, D, H, W) ->
    (B, C, H, W). CPU tensors take `_reference`; CUDA tensors the K3 kernel
    (contiguous bf16, else this raises), differentiable through
    `_DepthAttention`."""
    if not q.is_cuda:
        return _reference(q, k, v, num_heads)
    return _DepthAttention.apply(q, k, v, num_heads)


def _ctx_full(q, ctx, mean_x, m2, Wp, gn_scale, gn_bias, Wk, Wv, num_heads: int,
              num_groups: int, eps: float):
    """Plain version of `depth_attention_ctx` (the JAX package's `_ctx_full`
    with use_kernel=False)."""
    A, B2 = _ctx_affine(mean_x, m2, Wp, gn_scale, gn_bias, num_groups, eps)
    return _ctx_reference(q, ctx, Wp, A, B2, Wk, Wv, num_heads)


class _DepthAttentionCtx(torch.autograd.Function):
    """Forward: the K1 kernel. Backward: recompute through `_ctx_full` and
    return gradients for all nine tensor inputs (`_ctx_bwd`)."""

    @staticmethod
    def forward(ctx, q, x, mean_x, m2, Wp, gn_scale, gn_bias, Wk, Wv, num_heads: int,
                num_groups: int, eps: float):
        ctx.save_for_backward(q, x, mean_x, m2, Wp, gn_scale, gn_bias, Wk, Wv)
        ctx.args = (num_heads, num_groups, eps)
        A, B2 = _ctx_affine(mean_x, m2, Wp, gn_scale, gn_bias, num_groups, eps)
        return ctx_attention(q, x, Wp, A, B2, Wk, Wv, num_heads)

    @staticmethod
    def backward(ctx, g):
        args = ctx.args
        grads = _cuda.recompute_grads(lambda *t: _ctx_full(*t, *args), ctx.saved_tensors,
                                 ctx.needs_input_grad[:9], g)
        return grads + (None,) * 3


def depth_attention_ctx(q, ctx, mean_x, m2, Wp, gn_scale, gn_bias, Wk, Wv,
                        num_heads: int, num_groups: int = 8, eps: float = 1e-5):
    """Fused proj_context + GroupNorm(relu) + k/v + depth attention.

    (mean_x, m2) = ctx_moments(ctx), computed outside so that the gradient
    also reaches ctx through them; gn_scale/gn_bias (Cc,). Shapes as in
    `ctx_attention`. CPU tensors take `_ctx_full`; CUDA tensors the K1
    kernel, differentiable through `_DepthAttentionCtx`.
    """
    if not q.is_cuda:
        return _ctx_full(q, ctx, mean_x, m2, Wp, gn_scale, gn_bias, Wk, Wv, num_heads,
                         num_groups, eps)
    return _DepthAttentionCtx.apply(q, ctx, mean_x, m2, Wp, gn_scale, gn_bias, Wk, Wv,
                                    num_heads, num_groups, eps)
