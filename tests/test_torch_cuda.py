"""The port's CUDA kernels on the card, against their plain versions.

Marked `cuda`; every test skips without a CUDA card. This file imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Inputs are bf16 on the card; each kernel is held to its plain PyTorch
version on the same bf16 inputs within relative L2 1e-2 (the two round the
bf16 products at different places; chip_smoke.py holds the same bar at the
main path's shapes); the backward kernels are held to autograd of the plain
version and to their own plain versions (`backward_dkv_reference`,
`backward_dq_reference`) at the same bar, and the forward's fp32 row
logsumexp to 1e-4.
"""

import pytest
import torch

from morphablediffusion_torch.ops import depth_attention as da
from morphablediffusion_torch.ops import flash_attention as fa
from morphablediffusion_torch.ops import group_norm as gn

pytestmark = pytest.mark.cuda
REL_L2 = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(g, *shape, std=1.0):
    return (torch.randn(*shape, generator=g, device=g.device) * std).bfloat16()


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


def _ctx_args(dev, B, W, D, Cc, Ci, heads, seed=0, q_scale=1.0):
    g = torch.Generator(dev).manual_seed(seed)
    q, ctx = _randn(g, B, Ci, W, W, std=q_scale), _randn(g, B, Cc, D, W, W)
    Wp, Wk, Wv = (_randn(g, o, Cc, std=Cc ** -0.5) for o in (Cc, Ci, Ci))
    mean_x, m2 = da.ctx_moments(ctx)
    scale = 1.0 + 0.1 * torch.randn(Cc, generator=g, device=dev)
    bias = 0.1 * torch.randn(Cc, generator=g, device=dev)
    A, B2 = da._ctx_affine(mean_x, m2, Wp, scale, bias, 8, 1e-5)
    return q, ctx, Wp, A, B2, Wk, Wv, heads


def _ctx_launches():
    return {k.name: k.launches for k in da.CTX_KERNELS.values()}


@pytest.mark.parametrize("B,W,D,Cc,Ci,heads,q_scale,design", [
    (2, 4, 6, 32, 64, 4, 1.0, "wmma"),        # 16-pixel tiles, head_dim 16
    (16, 8, 12, 64, 128, 4, 1.0, "wgmma"),    # H*W = 64, head_dim 32: one pixel tile
    (1, 8, 5, 128, 256, 2, 1.0, "wmma"),      # odd depth, head_dim 128
    (3, 16, 3, 16, 64, 1, 1.0, "wmma"),       # one head
    (16, 16, 24, 256, 512, 4, 1.0, "wmma"),   # WMMA's 64-pixel tiles
    (16, 32, 48, 64, 128, 4, 1.0, "wgmma"),   # the main path's W=32 at serving, G = 4
    (16, 16, 24, 128, 256, 4, 1.0, "wgmma"),  # W=16 at serving
    (8, 32, 48, 64, 128, 4, 1.0, "wgmma"),    # W=32 in training, G = 2
    (8, 16, 24, 128, 256, 4, 1.0, "wgmma"),   # W=16 in training
    (2, 8, 1, 64, 128, 4, 1.0, "wgmma"),      # D = 1
    (2, 8, 7, 64, 128, 4, 1.0, "wgmma"),      # D = 7: not a multiple of the ring's 4 stages
    (2, 16, 1, 128, 256, 4, 1.0, "wgmma"),    # D = 1 at Cc 128
    (2, 16, 5, 128, 256, 4, 1.0, "wgmma"),    # D = 5: not a multiple of 2 or 3 stages
    (4, 32, 48, 64, 128, 4, 8.0, "wgmma"),    # q x 8: the running max moves across depth
    (4, 16, 24, 128, 256, 4, 8.0, "wgmma"),
    (16, 8, 12, 256, 512, 4, 1.0, "cluster"),   # the main path's W=8 at serving: 2 tiles a cluster
    (17, 8, 3, 256, 512, 4, 1.0, "cluster"),    # 2 tiles a cluster, the last cluster's second empty
    (8, 8, 12, 256, 512, 4, 1.0, "cluster"),    # W=8 in training
    (4, 8, 12, 256, 512, 4, 1.0, "cluster"),    # W=8 at the validation chunk's B=4
    (16, 4, 6, 512, 1024, 4, 1.0, "cluster"),   # the main path's W=4 at serving
    (4, 4, 6, 512, 1024, 4, 1.0, "cluster"),    # W=4, one tile of four samples
    (1, 4, 6, 512, 1024, 4, 1.0, "cluster"),    # W=4, a tile of one sample: zero-filled rows
    (3, 4, 6, 512, 1024, 4, 1.0, "cluster"),    # W=4, a ragged tile of three samples
    (2, 8, 1, 256, 512, 4, 1.0, "cluster"),     # D = 1
    (2, 8, 7, 256, 512, 4, 1.0, "cluster"),     # D = 7: the ring's 8 stages wrap mid-depth
    (5, 4, 5, 512, 1024, 4, 1.0, "cluster"),    # D = 5, two tiles, the second ragged
    (2, 8, 12, 256, 512, 2, 1.0, "cluster"),    # 2 heads: a head is 4 blocks of the cluster
    (4, 8, 12, 256, 512, 4, 8.0, "cluster"),    # q x 8: the running max moves across depth
    (4, 4, 6, 512, 1024, 4, 8.0, "cluster"),
])
def test_depth_attention_ctx_kernel(dev, B, W, D, Cc, Ci, heads, q_scale, design):
    """One launch of the design `ctx_design` picks (asserted), and none of
    the others, within REL_L2 of the plain version."""
    args = _ctx_args(dev, B, W, D, Cc, Ci, heads, q_scale=q_scale)
    assert da.ctx_design(B, W * W, Cc, Ci, heads).kernel == design
    kernel = da.CTX_KERNELS[design]
    before = _ctx_launches()
    out = da.ctx_attention(*args)
    torch.cuda.synchronize()
    assert _ctx_launches() == dict(before, **{kernel.name: before[kernel.name] + 1})
    assert out.shape == args[0].shape and out.dtype == torch.bfloat16
    assert _rel(out, da._ctx_reference(*args)) <= REL_L2


@pytest.mark.parametrize("B,W,D,Cc,Ci,heads", [(4, 32, 9, 64, 128, 4), (4, 16, 9, 128, 256, 4),
                                               (2, 8, 3, 64, 64, 2)])
def test_depth_attention_ctx_every_group(dev, B, W, D, Cc, Ci, heads):
    """Every G the Hopper design is built for at (Cc, head_dim), as
    chip_smoke.py times them, and the WMMA design on the same inputs."""
    args = _ctx_args(dev, B, W, D, Cc, Ci, heads, seed=11)
    want = da._ctx_reference(*args)
    designs = [da.CtxDesign("wgmma", g, 64) for g, _ in da.WGMMA_GROUPS[(Cc, Ci // heads)]
               if heads % g == 0] + [da.CtxDesign("wmma", 1, 16)]
    for design in designs:
        out = da._launch_ctx(*args, design)
        torch.cuda.synchronize()
        assert _rel(out, want) <= REL_L2, design


@pytest.mark.parametrize("B,W,D,Cc", [(4, 8, 5, 256), (3, 4, 3, 512), (16, 8, 4, 256)])
def test_depth_attention_ctx_cluster_and_wmma_designs_agree(dev, B, W, D, Cc):
    """At the cluster design's shapes the WMMA design and the other number
    of tiles a cluster, which chip_smoke.py times beside it, hold the same
    bar on the same inputs; two launches of the cluster design agree bit for
    bit (each head's partial logits are added in rank order)."""
    args = _ctx_args(dev, B, W, D, Cc, 2 * Cc, 4, seed=18)
    want = da._ctx_reference(*args)
    chosen = da.ctx_design(B, W * W, Cc, 2 * Cc, 4)
    assert chosen.kernel == "cluster"
    out = da._launch_ctx(*args, chosen)
    assert torch.equal(out, da._launch_ctx(*args, chosen))
    assert _rel(out, want) <= REL_L2
    for tpc in da.CLUSTER_TPC[Cc]:
        other = da._launch_ctx(*args, chosen._replace(tile=da.CLUSTER_ROWS * tpc))
        assert _rel(other, want) <= REL_L2, tpc
    wmma = da._launch_ctx(*args, da.CtxDesign("wmma", 1, da._tile(B, W * W, 4)))
    torch.cuda.synchronize()
    assert _rel(wmma, want) <= REL_L2


def test_depth_attention_ctx_cluster_plan_matches_the_kernel(dev):
    """The kernel's shared memory (its ring stages included) is the plan's at both
    Cc and at one and two tiles a cluster, and the card holds at least one
    cluster of each (at two tiles a cluster, all of B=16's)."""
    import ctypes

    da.CLUSTER_KERNEL._load()
    lib = ctypes.CDLL(str(da.CLUSTER_KERNEL.lib_path()))
    for S, Cc, tpc in [(64, 256, 1), (64, 256, 2), (16, 512, 1)]:
        plan = da.ctx_cluster_plan(16, S, 6, Cc, 2 * Cc, 4, tpc)
        assert lib.md_depth_attention_ctx_cluster_smem_bytes(Cc, tpc) == plan.smem
        # at two tiles a cluster, all 8 of B=16's clusters at once
        assert lib.md_depth_attention_ctx_cluster_max_clusters(Cc, tpc) >= (
            plan.tiles // tpc if tpc > 1 else 1)


@pytest.mark.parametrize("B,W,D,Cc", [(2, 8, 5, 256), (3, 4, 3, 512)])
def test_depth_attention_ctx_cluster_reads_nothing_past_its_tensors(dev, B, W, D, Cc):
    """q, ctx and the weights at the start of buffers whose tail is NaN,
    for the cluster design at W=8 and at W=4 with a ragged tile (its last
    sample's rows are zero-filled, not read)."""
    Ci, heads = 2 * Cc, 4

    def padded(t):
        buf = torch.full((t.numel() + 4096,), float("nan"), device=dev, dtype=t.dtype)
        buf[:t.numel()] = t.reshape(-1)
        return buf[:t.numel()].view(t.shape)

    q, ctx, Wp, A, B2, Wk, Wv, _ = _ctx_args(dev, B, W, D, Cc, Ci, heads, seed=19)
    q, ctx, Wp, Wk, Wv, A, B2 = (padded(t) for t in (q, ctx, Wp, Wk, Wv, A, B2))
    before = da.CLUSTER_KERNEL.launches
    out = da.ctx_attention(q, ctx, Wp, A, B2, Wk, Wv, heads)
    torch.cuda.synchronize()
    assert da.CLUSTER_KERNEL.launches == before + 1
    assert torch.isfinite(out).all()
    assert _rel(out, da._ctx_reference(q, ctx, Wp, A, B2, Wk, Wv, heads)) <= REL_L2


def test_depth_attention_ctx_cluster_gradients(dev):
    """The gradient through `depth_attention_ctx` at the main path's W=8
    (cluster design forward, backward recomputed through `_ctx_full`)
    reaches all nine inputs, close to autograd of the plain version."""
    g = torch.Generator(dev).manual_seed(20)
    B, W, D, Cc, Ci, heads = 2, 8, 12, 256, 512, 4
    ctx = _randn(g, B, Cc, D, W, W)
    mean_x, m2 = da.ctx_moments(ctx)
    nine = [_randn(g, B, Ci, W, W), ctx, mean_x, m2, _randn(g, Cc, Cc, std=Cc ** -0.5),
            1.0 + 0.1 * torch.randn(Cc, generator=g, device=dev),
            0.1 * torch.randn(Cc, generator=g, device=dev),
            _randn(g, Ci, Cc, std=Cc ** -0.5), _randn(g, Ci, Cc, std=Cc ** -0.5)]
    w = torch.randn((B, Ci, W, W), generator=g, device=dev)

    def grads(fn):
        leaves = [t.detach().requires_grad_(True) for t in nine]
        out = fn(*leaves)
        (out.float() * w).sum().backward()
        return out, [t.grad for t in leaves]

    before = _ctx_launches()
    out, got = grads(lambda *t: da.depth_attention_ctx(*t, heads))
    assert _ctx_launches() == dict(before, **{da.CLUSTER_KERNEL.name:
                                              before[da.CLUSTER_KERNEL.name] + 1})
    want_out, want = grads(lambda *t: da._ctx_full(*t, heads, 8, 1e-5))
    assert _rel(out, want_out) <= REL_L2
    for a, b in zip(got, want):
        assert a is not None and a.float().abs().sum() > 0
        assert _rel(a, b) <= REL_L2


def test_depth_attention_ctx_reads_nothing_past_its_tensors(dev):
    """q, ctx and the weights at the start of buffers whose tail is NaN, at
    W=16 (the Hopper design): its TMA boxes end at each tensor's last
    element and must read nothing beyond it."""
    B, W, D, Cc, Ci, heads = 2, 16, 5, 128, 256, 4

    def padded(t):
        buf = torch.full((t.numel() + 4096,), float("nan"), device=dev, dtype=t.dtype)
        buf[:t.numel()] = t.reshape(-1)
        return buf[:t.numel()].view(t.shape)

    q, ctx, Wp, A, B2, Wk, Wv, _ = _ctx_args(dev, B, W, D, Cc, Ci, heads, seed=12)
    q, ctx, Wp, Wk, Wv = (padded(t) for t in (q, ctx, Wp, Wk, Wv))
    before = da.WGMMA_KERNEL.launches
    out = da.ctx_attention(q, ctx, Wp, A, B2, Wk, Wv, heads)
    torch.cuda.synchronize()
    assert da.WGMMA_KERNEL.launches == before + 1
    assert torch.isfinite(out).all()
    assert _rel(out, da._ctx_reference(q, ctx, Wp, A, B2, Wk, Wv, heads)) <= REL_L2


def test_depth_attention_ctx_kernel_is_the_fused_chain(dev):
    """The public entry (moments folded into the affine) against the
    unfused chain proj -> GroupNorm(relu) -> k/v -> depth attention, fp32
    (plain versions)."""
    B, W, D, Cc, Ci, heads = 2, 8, 6, 32, 64, 4
    g = torch.Generator(dev).manual_seed(1)
    q, ctx = _randn(g, B, Ci, W, W), _randn(g, B, Cc, D, W, W)
    Wp, Wk, Wv = (_randn(g, o, Cc, std=Cc ** -0.5) for o in (Cc, Ci, Ci))
    scale, bias = torch.ones(Cc, device=dev), torch.zeros(Cc, device=dev)
    mean_x, m2 = da.ctx_moments(ctx)
    out = da.depth_attention_ctx(q, ctx, mean_x, m2, Wp, scale, bias, Wk, Wv, heads)
    f = lambda t: t.float()
    p = torch.einsum("oc,bcdhw->bodhw", f(Wp), f(ctx))
    y = gn._reference(p, None, scale, bias, 8, 1e-5, "relu")
    k = torch.einsum("oc,bcdhw->bodhw", f(Wk), y)
    v = torch.einsum("oc,bcdhw->bodhw", f(Wv), y)
    assert _rel(out, da._reference(f(q), k, v, heads)) <= REL_L2


@pytest.mark.parametrize("B,L,heads,hd,logit_scale", [
    (2, 1024, 8, 40, 1.0),   # the main path's head_dim, padded to 48 in Q K^T
    (1, 1000, 2, 64, 1.0),   # ragged last tile
    (3, 64, 4, 16, 1.0),
    (1, 200, 3, 8, 1.0),
    (32, 1024, 8, 40, 1.0),  # the serving shape
    (2, 1024, 8, 40, 8.0),   # q and k scaled by 8: large logits, the running max moves
    (3, 1, 2, 40, 1.0),      # L = 1: one partial tile of one key
    (2, 65, 4, 40, 1.0),     # a last key tile of one key
    (2, 300, 4, 48, 1.0),    # head_dim 48: three k-steps, no padding
])
def test_flash_attention_kernel(dev, B, L, heads, hd, logit_scale):
    """One launch per call with and without a gradient, the output within
    REL_L2 of the plain version and the row logsumexp within 1e-4."""
    g = torch.Generator(dev).manual_seed(2)
    q, k = (_randn(g, B, L, heads * hd, std=logit_scale) for _ in range(2))
    v = _randn(g, B, L, heads * hd)
    want = fa.attention_reference(q, k, v, heads)
    for grad in (False, True):
        leaves = [t.detach().requires_grad_(grad) for t in (q, k, v)]
        before = fa.KERNEL.launches
        with torch.set_grad_enabled(grad):
            out = fa.flash_attention(*leaves, heads)
        torch.cuda.synchronize()
        assert fa.KERNEL.launches == before + 1
        assert (out.grad_fn is not None) == grad
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        assert _rel(out, want) <= REL_L2
    out2, lse = fa._forward(q, k, v, heads)
    assert torch.equal(out2, out.detach())
    assert lse.shape == (B, heads, L) and lse.dtype == torch.float32
    assert _rel(lse, fa.logsumexp_reference(q, k, heads)) <= 1e-4


def test_flash_attention_reads_nothing_past_its_tensors(dev):
    """q, k, v at the start of buffers whose tail is NaN, at a ragged L and
    head_dim 40: the TMA boxes (64 columns, 128 or 64 rows) reach past the
    last head's columns and the last sample's rows, and must see zeros
    there, not the next bytes in memory."""
    g = torch.Generator(dev).manual_seed(8)
    B, L, heads, hd = 2, 65, 4, 40
    n = B * L * heads * hd

    def padded():
        buf = torch.full((n + 64 * heads * hd,), float("nan"), device=dev, dtype=torch.bfloat16)
        buf[:n] = _randn(g, n)
        return buf[:n].view(B, L, heads * hd)

    q, k, v = padded(), padded(), padded()
    out = fa.flash_attention(q, k, v, heads)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _rel(out, fa.attention_reference(q, k, v, heads)) <= REL_L2


@pytest.mark.parametrize("B,H,W,D,C,heads,cluster", [
    (8, 4, 4, 6, 1024, 4, 8),     # the training path's W=4 middle block, head_dim 256
    (8, 8, 8, 12, 512, 4, 8),     # the other plain-path widths at B=8
    (8, 16, 16, 24, 256, 4, 4),
    (8, 32, 32, 48, 128, 4, 2),
    (2, 32, 32, 48, 128, 4, 2),
    (2, 16, 16, 24, 256, 4, 4),
    (2, 8, 8, 12, 512, 4, 8),
    (3, 5, 5, 7, 96, 3, 2),       # H*W = 25: one ragged tile, scalar copies, odd depth
    (2, 6, 12, 9, 128, 4, 2),     # H*W = 72: 16-byte copies, a last tile of 8 of 32 pixels
    (2, 10, 10, 3, 192, 3, 4),    # H*W = 100: scalar copies, a ragged last tile
    (2, 4, 4, 6, 64, 4, 1),       # head_dim 16: no cluster
    (1, 8, 8, 1, 256, 2, 8),      # D = 1
])
def test_depth_attention_kernel(dev, B, H, W, D, C, heads, cluster):
    """One launch of the plan `depth_plan` picks (its cluster asserted),
    within REL_L2 of the plain version, with and without a gradient."""
    assert da.depth_plan(B, C, D, H * W, heads).cluster == cluster
    g = torch.Generator(dev).manual_seed(4)
    q, k, v = _randn(g, B, C, H, W), _randn(g, B, C, D, H, W), _randn(g, B, C, D, H, W)
    want = da._reference(q, k, v, heads)
    for grad in (False, True):
        leaves = [t.detach().requires_grad_(grad) for t in (q, k, v)]
        before = da.DEPTH_KERNEL.launches
        with torch.set_grad_enabled(grad):
            out = da.depth_attention(*leaves, heads)
        torch.cuda.synchronize()
        assert da.DEPTH_KERNEL.launches == before + 1
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        assert _rel(out, want) <= REL_L2


def test_depth_attention_is_deterministic(dev):
    """The cluster adds its partial logits in rank order: two launches on
    the same inputs agree bit for bit."""
    g = torch.Generator(dev).manual_seed(13)
    q, k, v = _randn(g, 8, 1024, 4, 4), _randn(g, 8, 1024, 6, 4, 4), _randn(g, 8, 1024, 6, 4, 4)
    assert torch.equal(da.attention_kernel(q, k, v, 4), da.attention_kernel(q, k, v, 4))


@pytest.mark.parametrize("H,W,D,C,heads", [(4, 4, 6, 1024, 4), (5, 5, 7, 96, 3),
                                           (6, 12, 9, 128, 4)])
def test_depth_attention_reads_nothing_past_its_tensors(dev, H, W, D, C, heads):
    """q, k and v at the start of buffers whose tail is NaN: the copies of
    the last sample's last channels, and the ragged tiles, stop at each
    tensor's last element."""
    g = torch.Generator(dev).manual_seed(14)

    def padded(t):
        buf = torch.full((t.numel() + 4096,), float("nan"), device=dev, dtype=t.dtype)
        buf[:t.numel()] = t.reshape(-1)
        return buf[:t.numel()].view(t.shape)

    q, k, v = (padded(t) for t in (_randn(g, 2, C, H, W), _randn(g, 2, C, D, H, W),
                                   _randn(g, 2, C, D, H, W)))
    out = da.depth_attention(q, k, v, heads)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _rel(out, da._reference(q, k, v, heads)) <= REL_L2


def test_depth_attention_plan_matches_the_kernel(dev):
    """The kernel's shared-memory layout is the plan's at every width, and
    the card holds at least one cluster of each plan."""
    import ctypes

    da.DEPTH_KERNEL._load()
    lib = ctypes.CDLL(str(da.DEPTH_KERNEL.lib_path()))
    for B, C, D, S, heads in [(8, 1024, 6, 16, 4), (8, 512, 12, 64, 4), (8, 256, 24, 256, 4),
                              (8, 128, 48, 1024, 4), (3, 96, 7, 25, 3)]:
        plan = da.depth_plan(B, C, D, S, heads)
        assert lib.md_depth_attention_smem_bytes(C, D, heads, plan.tile, plan.cluster) == plan.smem
        assert lib.md_depth_attention_max_clusters(C, D, S, heads, plan.tile, plan.cluster,
                                                   plan.vec) >= 1


def _bwd_rel(got, want, floor):
    """Relative L2 of a gradient, against at least `floor` (at L = 1 the
    exact dq and dk are 0: one key takes all the weight)."""
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).norm() / max(float(want.norm()), floor))


@pytest.mark.parametrize("B,L,heads,hd", [(8, 1024, 8, 40)] + [  # the training path's shape
    (2 if L < 1000 else 1, L, 3 if L < 1000 else 2, hd)
    for L in (1, 65, 200, 300, 1000, 1024) for hd in (8, 16, 40, 64)])  # ragged L, head_dim
def test_flash_attention_backward_kernels(dev, B, L, heads, hd):
    """K2-dkv and K2-dq against autograd of the plain version and against
    their own plain versions (on the same lse and di), and the forward's
    row logsumexp against the plain one."""
    g = torch.Generator(dev).manual_seed(5)
    q, k, v, dout = (_randn(g, B, L, heads * hd) for _ in range(4))
    out, lse = fa._forward(q, k, v, heads)
    assert _rel(lse, fa.logsumexp_reference(q, k, heads)) <= 1e-4
    n_dkv, n_dq = fa.BWD_DKV_KERNEL.launches, fa.BWD_DQ_KERNEL.launches
    dq, dk, dv = fa.flash_attention_backward(q, k, v, out, lse, dout, heads)
    torch.cuda.synchronize()
    assert (fa.BWD_DKV_KERNEL.launches, fa.BWD_DQ_KERNEL.launches) == (n_dkv + 1, n_dq + 1)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(fa.attention_reference(*leaves, heads), leaves, dout)
    di = fa.row_dot(out, dout, heads)
    plain = (fa.backward_dq_reference(q, k, v, dout, lse, di, heads),
             *fa.backward_dkv_reference(q, k, v, dout, lse, di, heads))
    floor = float(ref[2].float().norm())
    for got, want, own in zip((dq, dk, dv), ref, plain):
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        assert _bwd_rel(got, want, floor) <= REL_L2
        assert _bwd_rel(got, own, floor) <= REL_L2


def test_flash_attention_backward_reads_nothing_past_its_tensors(dev):
    """q, k, v, dout, lse and di at the start of buffers whose tail is NaN,
    at a ragged L and head_dim 40: the backward kernels' TMA boxes reach
    past the last head's columns and the last sample's rows, and must see
    zeros there; their plain loads of lse and di stop at L."""
    g = torch.Generator(dev).manual_seed(9)
    B, L, heads, hd = 2, 65, 4, 40

    def padded(t):
        buf = torch.full((t.numel() + 64 * heads * hd,), float("nan"), device=dev, dtype=t.dtype)
        buf[:t.numel()] = t.reshape(-1)
        return buf[:t.numel()].view(t.shape)

    q, k, v, dout = (padded(_randn(g, B, L, heads * hd)) for _ in range(4))
    out, lse = fa._forward(q, k, v, heads)
    di = padded(fa.row_dot(out, dout, heads))
    lse = padded(lse)
    dk, dv = fa.backward_dkv(q, k, v, dout, lse, di, heads)
    dq = fa.backward_dq(q, k, v, dout, lse, di, heads)
    torch.cuda.synchronize()
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(fa.attention_reference(*leaves, heads), leaves, dout)
    for got, want in zip((dq, dk, dv), ref):
        assert torch.isfinite(got).all()
        assert _rel(got, want) <= REL_L2


def test_flash_attention_backward_raises_on_misaligned_dout(dev):
    """dout 8 bytes off 16-byte alignment (a contiguous view can be) has no
    tensor map: both wrappers raise and launch nothing."""
    g = torch.Generator(dev).manual_seed(10)
    q, k, v, dout = (_randn(g, 2, 64, 2 * 40) for _ in range(4))
    out, lse = fa._forward(q, k, v, 2)
    di = fa.row_dot(out, dout, 2)
    shifted = torch.empty(dout.numel() + 4, device=dev, dtype=dout.dtype)[4:].view(dout.shape)
    shifted.copy_(dout)
    n_dkv, n_dq = fa.BWD_DKV_KERNEL.launches, fa.BWD_DQ_KERNEL.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.backward_dkv(q, k, v, shifted, lse, di, 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.backward_dq(q, k, v, shifted, lse, di, 2)
    assert (fa.BWD_DKV_KERNEL.launches, fa.BWD_DQ_KERNEL.launches) == (n_dkv, n_dq)


@pytest.mark.parametrize("shape,groups,act,eps", [
    ((32, 128, 32, 32), 8, "relu", 1e-5),         # DepthTransformer at width 32
    ((32, 1280, 4, 4), 32, "silu", 1e-5),         # the UNet's bottom, S = 16: packed
    ((16, 64, 48, 32, 32), 8, "silu", 1e-5),      # frustum net, 3-D: clusters of 8, part held
    ((2, 128, 256, 256), 32, "silu", 1e-6),       # VAE decoder, 512 KiB spans (bf16)
    ((32, 16, 32, 32), 8, "silu", 1e-5),          # target encoder, cg = 2
    ((1, 512), 8, "relu", 1e-5),                  # zero-context row, S = 1
    ((3, 40, 5, 7), 4, None, 1e-6),               # S not a multiple of 8
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shift_dtype", [None, torch.bfloat16, torch.float32])
def test_group_norm_kernel(dev, shape, groups, act, eps, dtype, shift_dtype):
    """One launch per call, within REL_L2 (bf16) or 1e-5 (fp32) of the plain
    version, the shift read as given (none, bf16, fp32)."""
    g = torch.Generator(dev).manual_seed(7)
    B, C = shape[:2]
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(C, generator=g, device=dev)
    beta = 0.1 * torch.randn(C, generator=g, device=dev)
    shift = (None if shift_dtype is None
             else torch.randn(B, C, generator=g, device=dev).to(shift_dtype))
    before = [k.launches for k in gn.KERNELS]
    out = gn.group_norm_shifted(x, shift, gamma, beta, groups, eps, act)
    torch.cuda.synchronize()
    assert [k.launches for k in gn.KERNELS] == [n + 1 for n in before]
    assert out.shape == x.shape and out.dtype == dtype
    want = gn._reference(x, shift, gamma, beta, groups, eps, act)
    assert _rel(out, want) <= (REL_L2 if dtype == torch.bfloat16 else 1e-5)


# shapes that take each cluster size, packing, and a share of a span too
# large to hold, part of it read twice (plan asserted): (shape, dtype,
# groups, (cluster, pack, resident))
GN_PLANS = [
    ((16, 64, 64, 64), torch.bfloat16, 32, (1, 1, True)),       # 16 KiB spans, 512 blocks
    ((4, 512, 16, 16), torch.bfloat16, 32, (2, 1, True)),
    ((8, 128, 128, 128), torch.bfloat16, 32, (4, 1, True)),     # 128 KiB spans
    ((4, 128, 32, 32), torch.bfloat16, 8, (8, 1, True)),        # 32 KiB spans, 32 pairs
    ((2, 64, 48, 32, 32), torch.bfloat16, 8, (8, 1, False)),    # 96 KiB a block, 32 held
    ((2, 256, 256, 256), torch.float32, 32, (8, 1, False)),     # 256 KiB a block, 32 held
    ((8, 1280, 4, 4), torch.float32, 32, (1, 2, True)),         # packed, 2 pairs a block
    ((4, 1280, 4, 4), torch.bfloat16, 32, (1, 4, True)),        # packed, 4
    ((3, 64, 1), torch.float32, 32, (1, 8, True)),              # packed, 8 (one warp a pair)
]


@pytest.mark.parametrize("shape,dtype,groups,plan", GN_PLANS)
@pytest.mark.parametrize("act", [None, "silu", "relu"])
def test_group_norm_every_plan(dev, shape, dtype, groups, plan, act):
    """Each kind of plan, with a shift, against the plain version; the
    cluster's fixed-order reduction gives the same bits twice."""
    p = gn.gn_plan(shape, dtype, groups)
    assert (p.cluster, p.pack, p.resident) == plan
    g = torch.Generator(dev).manual_seed(15)
    B, C = shape[:2]
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
    gamma = 1.0 + 0.1 * torch.randn(C, generator=g, device=dev)
    beta = 0.1 * torch.randn(C, generator=g, device=dev)
    shift = torch.randn(B, C, generator=g, device=dev).to(dtype)
    out = gn.group_norm_kernel(x, shift, gamma, beta, groups, 1e-5, act)
    assert torch.equal(out, gn.group_norm_kernel(x, shift, gamma, beta, groups, 1e-5, act))
    want = gn._reference(x, shift, gamma, beta, groups, 1e-5, act)
    assert _rel(out, want) <= (REL_L2 if dtype == torch.bfloat16 else 1e-5)


def test_group_norm_plan_matches_the_kernel(dev):
    """The kernel's shared-memory layout is the plan's for every kind of
    plan, and the card holds at least one cluster of each."""
    import ctypes

    gn.KERNEL._load()
    lib = ctypes.CDLL(str(gn.KERNEL.lib_path()))
    for shape, dtype, groups, _ in GN_PLANS + [((16, 128, 256, 256), torch.bfloat16, 32, 0)]:
        p = gn.gn_plan(shape, dtype, groups)
        args = (shape[1], groups, int(torch.tensor(shape[2:]).prod()), p.pack, p.cluster,
                p.chunk, p.held, p.vec, gn._DTYPE_CODE[dtype], gn.NCHW)
        assert lib.md_group_norm_smem_bytes(*args) == p.smem
        assert lib.md_group_norm_max_clusters(*args) >= 1


def test_group_norm_reads_nothing_past_its_tensors(dev):
    """x, gamma, beta and the shift at the start of buffers whose tail is
    NaN, for a packed plan whose last block has fewer pairs than it packs
    and for a cluster plan: nothing past the last element is read."""
    g = torch.Generator(dev).manual_seed(16)

    def padded(t):
        buf = torch.full((t.numel() + 4096,), float("nan"), device=dev, dtype=t.dtype)
        buf[:t.numel()] = t.reshape(-1)
        return buf[:t.numel()].view(t.shape)

    for shape, groups in (((3, 1280, 4, 4), 32), ((2, 64, 48, 32, 32), 8)):
        B, C = shape[:2]
        x = padded(_randn(g, *shape))
        gamma = padded(1.0 + 0.1 * torch.randn(C, generator=g, device=dev))
        beta = padded(0.1 * torch.randn(C, generator=g, device=dev))
        shift = padded(_randn(g, B, C))
        out = gn.group_norm_shifted(x, shift, gamma, beta, groups, 1e-5, "silu")
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        assert _rel(out, gn._reference(x, shift, gamma, beta, groups, 1e-5, "silu")) <= REL_L2


def test_group_norm_takes_a_misaligned_x_and_skips_autograd_without_grad(dev):
    """x 8 bytes off 16-byte alignment (a contiguous view can be) is loaded
    an element at a time; without a gradient to record the wrapper launches
    the kernel directly (no grad_fn), with one through the autograd
    Function; one launch either way."""
    g = torch.Generator(dev).manual_seed(17)
    x = _randn(g, 4, 64, 16, 16)
    shifted = torch.empty(x.numel() + 4, device=dev, dtype=x.dtype)[4:].view(x.shape)
    shifted.copy_(x)
    gamma = (1.0 + 0.1 * torch.randn(64, generator=g, device=dev)).requires_grad_(True)
    beta = torch.zeros(64, device=dev)
    want = gn._reference(x, None, gamma, beta, 32, 1e-5, "silu")
    for grad in (False, True):
        before = gn.KERNEL.launches
        with torch.set_grad_enabled(grad):
            out = gn.group_norm_shifted(shifted, None, gamma, beta, 32, 1e-5, "silu")
        torch.cuda.synchronize()
        assert gn.KERNEL.launches == before + 1
        assert (out.grad_fn is not None) == grad
        assert _rel(out, want) <= REL_L2


def test_gradients_reach_every_input_through_each_wrapper(dev):
    """Each CUDA wrapper is an autograd Function: its output keeps the graph
    and non-zero gradients reach q, k and v (and all nine inputs of the
    depth-context chain), close to the plain version's."""
    g = torch.Generator(dev).manual_seed(6)

    def grads(fn, tensors):
        leaves = [t.detach().requires_grad_(True) for t in tensors]
        out = fn(*leaves)
        assert out.grad_fn is not None
        w = torch.randn(out.shape, generator=g, device=dev)
        (out.float() * w).sum().backward()
        return out, [t.grad for t in leaves]

    qkv = [_randn(g, 2, 1024, 2 * 40) for _ in range(3)]
    _, got = grads(lambda q, k, v: fa.flash_attention(q, k, v, 2), qkv)
    assert all(t is not None and t.float().abs().sum() > 0 for t in got)

    q, k, v = _randn(g, 2, 64, 4, 4), _randn(g, 2, 64, 6, 4, 4), _randn(g, 2, 64, 6, 4, 4)
    _, got = grads(lambda q, k, v: da.depth_attention(q, k, v, 4), (q, k, v))
    assert all(t is not None and t.float().abs().sum() > 0 for t in got)

    B, W, D, Cc, Ci = 2, 8, 6, 32, 64
    ctx = _randn(g, B, Cc, D, W, W)
    mean_x, m2 = da.ctx_moments(ctx)
    nine = [_randn(g, B, Ci, W, W), ctx, mean_x, m2, _randn(g, Cc, Cc, std=Cc ** -0.5),
            1.0 + 0.1 * torch.randn(Cc, generator=g, device=dev),
            0.1 * torch.randn(Cc, generator=g, device=dev),
            _randn(g, Ci, Cc, std=Cc ** -0.5), _randn(g, Ci, Cc, std=Cc ** -0.5)]
    before = da.KERNEL.launches
    out, got = grads(lambda *t: da.depth_attention_ctx(*t, 4), nine)
    assert da.KERNEL.launches == before + 1
    assert all(t is not None and t.float().abs().sum() > 0 for t in got)
    assert _rel(out, da._ctx_full(*nine, 4, 8, 1e-5)) <= REL_L2

    # K4, with the ResBlock's shift: gradients for x, shift, gamma and beta
    x = _randn(g, 2, 64, 8, 8)
    four = [x, _randn(g, 2, 64), 1.0 + 0.1 * torch.randn(64, generator=g, device=dev),
            0.1 * torch.randn(64, generator=g, device=dev)]
    before = gn.KERNEL.launches
    out, got = grads(lambda *t: gn.group_norm_shifted(*t, 32, 1e-5, "silu"), four)
    assert gn.KERNEL.launches == before + 1
    assert all(t is not None and t.float().abs().sum() > 0 for t in got)
    assert _rel(out, gn._reference(*four, 32, 1e-5, "silu")) <= REL_L2


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    g = torch.Generator(dev).manual_seed(3)
    q, k, v = (_randn(g, 2, 64, 2 * 40) for _ in range(3))
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention(q.float(), k.float(), v.float(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1), 2)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, k, v, 8)  # head_dim 10
    shifted = torch.empty(q.numel() + 4, device=dev, dtype=q.dtype)[4:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention(shifted, k, v, 2)  # 8 bytes off: no tensor map
    args = list(_ctx_args(dev, 2, 4, 6, 32, 64, 4))
    args[1] = args[1].transpose(3, 4)
    with pytest.raises(ValueError, match="contiguous"):
        da.ctx_attention(*args)
    args = list(_ctx_args(dev, 2, 4, 6, 32, 96, 4))  # head_dim 24
    with pytest.raises(ValueError, match="head_dim"):
        da.ctx_attention(*args)
    for W, Cc in ((8, 64), (8, 256), (4, 512)):  # Hopper's tensor maps; cluster's copies
        args = list(_ctx_args(dev, 2, W, 3, Cc, 2 * Cc, 4))
        shifted = torch.empty(args[1].numel() + 4, device=dev, dtype=torch.bfloat16)[4:]
        args[1] = shifted.view(args[1].shape).copy_(args[1])
        before = _ctx_launches()
        with pytest.raises(ValueError, match="16-byte aligned"):
            da.ctx_attention(*args)
        assert _ctx_launches() == before
    k = _randn(g, 2, 64, 6, 4, 4)
    with pytest.raises(ValueError, match="contiguous"):
        da.depth_attention(_randn(g, 2, 64, 4, 4), k.transpose(3, 4), k, 4)
    with pytest.raises(ValueError, match="head_dim"):  # no tile of it fits a block
        da.depth_attention(_randn(g, 1, 2048, 8, 8), *(_randn(g, 1, 2048, 64, 8, 8),) * 2, 1)
    q4, k4 = _randn(g, 2, 64, 4, 4), _randn(g, 2, 64, 6, 4, 4)
    shifted = torch.empty(k4.numel() + 4, device=dev, dtype=k4.dtype)[4:].view(k4.shape)
    shifted.copy_(k4)
    before = da.DEPTH_KERNEL.launches
    with pytest.raises(ValueError, match="16-byte aligned"):  # 16-byte copies
        da.depth_attention(q4, shifted, k4, 4)
    assert da.DEPTH_KERNEL.launches == before
    x, gamma, beta = _randn(g, 2, 64, 8, 8), torch.ones(64, device=dev), torch.zeros(64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        gn.group_norm(x.transpose(2, 3), gamma, beta, 32)
    with pytest.raises(ValueError, match="one CUDA device"):
        gn.group_norm(x, gamma.cpu(), beta, 32)
    with pytest.raises(ValueError, match="not divisible"):
        gn.group_norm(x, gamma, beta, 24)
    with pytest.raises(ValueError, match="float32"):
        gn.group_norm(x, gamma.bfloat16(), beta, 32)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        gn.group_norm(x.half(), gamma, beta, 32)
    with pytest.raises(ValueError, match="shift must be bfloat16 or float32"):
        gn.group_norm_shifted(x, _randn(g, 2, 64).half(), gamma, beta, 32)
    with pytest.raises(ValueError, match="shift"):
        gn.group_norm_shifted(x, _randn(g, 2, 32), gamma, beta, 32)
