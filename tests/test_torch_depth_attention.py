"""Port parity of the kernel modules' plain versions on the CPU, fp32.

K1 (depth_attention_ctx): the port's plain fused chain against the JAX
Pallas kernel run in interpret mode and against the JAX unfused module chain
(2e-4, the JAX package's own bar: tests/test_depth_attention.py), and its
gradients for all nine inputs against jax.grad (1e-4). K3
(depth_attention): forward and gradients against the JAX depth_attention
under jax.vjp (2e-5). The autograd Functions of the CUDA path, with their
kernels replaced by the plain versions, against autograd of the plain
versions (1e-6). K2 (flash
attention): the port's plain attention against JAX `layers.attention` on the
CPU (1e-5). On the CPU the wrappers take the plain versions and launch
nothing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphablediffusion_torch.models import layers as t_layers
from morphablediffusion_torch.ops import depth_attention as t_da
from morphablediffusion_torch.ops import flash_attention as t_fa
from morphablediffusion_tpu.models import layers as j_layers
from morphablediffusion_tpu.ops import depth_attention as j_da
from morphablediffusion_tpu.ops.group_norm import group_norm as j_group_norm
from tests.torch_parity import assert_close, cf, cl, tt


def _ctx_inputs(rng, B, D, H, W, Cc, inner):
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return dict(q=f(B, H, W, inner), ctx=f(B, D, H, W, Cc), Wp=f(Cc, Cc, scale=0.3),
                scale=1.0 + f(Cc, scale=0.1), bias=f(Cc, scale=0.1),
                Wk=f(Cc, inner, scale=0.3), Wv=f(Cc, inner, scale=0.3))


def _port_ctx(a, heads):
    """The port's public fused entry on the same inputs (Linear weights are
    the transposed JAX Dense kernels)."""
    mean_x, m2 = t_da.ctx_moments(cf(a["ctx"]))
    out = t_da.depth_attention_ctx(cf(a["q"]), cf(a["ctx"]), mean_x, m2, tt(a["Wp"]).T,
                                   tt(a["scale"]), tt(a["bias"]), tt(a["Wk"]).T,
                                   tt(a["Wv"]).T, heads)
    return cl(out)


@pytest.mark.parametrize("B,D,H,W,Cc,heads,inner", [(2, 12, 4, 4, 16, 4, 128),
                                                     (1, 6, 2, 8, 32, 4, 64)])
def test_ctx_plain_matches_jax_kernel_interpret(rng, B, D, H, W, Cc, heads, inner):
    a = _ctx_inputs(rng, B, D, H, W, Cc, inner)
    mean_x, m2 = j_da.ctx_moments(jnp.asarray(a["ctx"]))
    A, B2 = j_da._ctx_affine(mean_x, m2, jnp.asarray(a["Wp"]), jnp.asarray(a["scale"]),
                             jnp.asarray(a["bias"]), 8, 1e-5)
    ref = j_da._ctx_pallas(jnp.asarray(a["q"]), jnp.asarray(a["ctx"]), jnp.asarray(a["Wp"]),
                           A, B2, jnp.asarray(a["Wk"]), jnp.asarray(a["Wv"]), heads,
                           interpret=True)
    assert_close(_port_ctx(a, heads), ref, 2e-4)


def test_ctx_chain_matches_jax_module_chain(rng):
    """Moments folded into an affine == proj -> GroupNorm(relu) -> k/v ->
    depth attention, done the unfused way in JAX."""
    B, D, H, W, Cc, heads, inner = 2, 6, 4, 4, 16, 2, 16
    a = _ctx_inputs(rng, B, D, H, W, Cc, inner)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    p = jnp.einsum("bdhwc,ce->bdhwe", j["ctx"], j["Wp"])
    y = j_group_norm(p, j["scale"], j["bias"], 8, 1e-5, "relu")
    k = jnp.einsum("bdhwc,ce->bdhwe", y, j["Wk"])
    v = jnp.einsum("bdhwc,ce->bdhwe", y, j["Wv"])
    assert_close(_port_ctx(a, heads), j_da._reference(j["q"], k, v, heads), 2e-4)


def test_ctx_moments_and_affine(rng):
    a = _ctx_inputs(rng, 2, 5, 3, 4, 16, 32)
    jm, jm2 = j_da.ctx_moments(jnp.asarray(a["ctx"]))
    tm, tm2 = t_da.ctx_moments(cf(a["ctx"]))
    assert_close(tm, jm, 1e-5)
    assert_close(tm2, jm2, 1e-5)
    jA, jB = j_da._ctx_affine(jm, jm2, jnp.asarray(a["Wp"]), jnp.asarray(a["scale"]),
                              jnp.asarray(a["bias"]), 8, 1e-5)
    tA, tB = t_da._ctx_affine(tm, tm2, tt(a["Wp"]).T, tt(a["scale"]), tt(a["bias"]), 8, 1e-5)
    assert_close(tA, jA, 1e-5)
    assert_close(tB, jB, 1e-5)


def test_depth_attention_reference(rng):
    """The plain depth attention (the training path; its kernel is queued)."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    q, k, v = f(2, 3, 4, 16), f(2, 7, 3, 4, 16), f(2, 7, 3, 4, 16)
    out = t_da._reference(cf(q), cf(k), cf(v), 4)
    assert_close(cl(out), j_da._reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4),
                 1e-5)


@pytest.mark.parametrize("B,L,heads,hd,logit_scale", [
    (1, 1024, 2, 8, 1.0), (2, 64, 3, 16, 1.0), (1, 1000, 2, 8, 1.0), (2, 200, 2, 64, 1.0),
    (1, 1024, 2, 8, 8.0)],
    ids=["1-1024-2-8", "2-64-3-16", "ragged-1000", "hd64", "large-logits"])
def test_flash_plain_matches_jax_attention(rng, B, L, heads, hd, logit_scale):
    """L=1024 is where both packages dispatch to flash; L=64 compares the
    plain version off that path. The cases the card tests hold the kernel
    to (a ragged L, head_dim 64, q and k scaled by 8 for large logits) hold
    its yardstick, the plain version, to the JAX package's attention."""
    f = lambda s=1.0: (rng.normal(size=(B, L, heads * hd)) * s).astype(np.float32)
    q, k, v = f(logit_scale), f(logit_scale), f()
    ref = j_layers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads)
    assert_close(t_fa.flash_attention(tt(q), tt(k), tt(v), heads), ref, 1e-5)
    assert_close(t_layers.attention(tt(q), tt(k), tt(v), heads), ref, 1e-5)


def test_cpu_wrappers_take_plain_versions_and_launch_nothing(rng):
    kernels = (t_da.KERNEL, t_da.DEPTH_KERNEL, t_fa.KERNEL, t_fa.BWD_DKV_KERNEL,
               t_fa.BWD_DQ_KERNEL)
    for k in kernels:
        k.launches = 0
    a = _ctx_inputs(rng, 1, 3, 2, 4, 16, 32)
    _port_ctx(a, 2)
    x = tt(rng.normal(size=(1, 1024, 16))).requires_grad_(True)
    t_layers.attention(x, x, x, 2).sum().backward()
    q = tt(rng.normal(size=(1, 8, 2, 2))).requires_grad_(True)
    t_da.depth_attention(q, q[:, :, None], q[:, :, None], 2).sum().backward()
    assert all(k.launches == 0 for k in kernels)
    assert all(k._fn is None for k in kernels)  # nothing built


def test_wrappers_reject_what_the_kernels_do_not_take():
    """Shape checks run before any launch (no card needed to reach them)."""
    q = torch.zeros(1, 64, 4, 4)
    with pytest.raises(ValueError):
        t_da._cuda.check_cuda("x", torch.bfloat16, q)
    assert t_da._tile(16, 1024, 4) == 64 and t_da._tile(16, 64, 4) == 16


# every K1 shape of the main path (4 heads, Ci = 2 Cc): serving at B=16,
# training at B=8 (W >= 8), with the design, G (the cluster design: blocks
# per cluster) and tile (its rows per cluster) expected, and the grid
@pytest.mark.parametrize("B,W,Cc,design,blocks", [
    (16, 32, 64, ("wgmma", 4, 64), 256), (16, 16, 128, ("wgmma", 2, 64), 128),
    (16, 8, 256, ("cluster", 8, 128), 64), (16, 4, 512, ("cluster", 16, 64), 64),
    (8, 32, 64, ("wgmma", 2, 64), 256), (8, 16, 128, ("wgmma", 1, 64), 128),
    (8, 8, 256, ("cluster", 8, 64), 64)])
def test_ctx_design_of_the_main_path(B, W, Cc, design, blocks):
    """The shape rule (`ctx_design`): the two wide levels take the Hopper
    design, with the largest G whose grid fills the card at its blocks per
    SM (else the smallest); the narrow levels the cluster design, a
    cluster per tile of 64 rows (one sample at W=8, four at W=4), or per
    two tiles at W=8, B=16 (16 clusters of 8 would be one more than an H100
    holds at once)."""
    got = t_da.ctx_design(B, W * W, Cc, 2 * Cc, 4)
    assert tuple(got) == design
    assert got.blocks(B, W * W, 4) == blocks


@pytest.mark.parametrize("B,S,Cc,Ci,heads", [
    (2, 16, 32, 96, 4),     # head_dim 24: not a multiple of 16
    (2, 20, 32, 64, 4),     # H*W not a multiple of the 16-pixel tile
    (2, 64, 40, 80, 4),     # Cc 40
    (2, 64, 64, 128, 3),    # 128 channels do not split into 3 heads
])
def test_ctx_design_refuses_what_neither_design_takes(B, S, Cc, Ci, heads):
    with pytest.raises(ValueError, match="depth_attention_ctx"):
        t_da.ctx_design(B, S, Cc, Ci, heads)


def test_ctx_design_of_other_shapes():
    """(Cc, head_dim) the Hopper design is built for but H*W not a multiple
    of 64 takes the WMMA design; the Hopper design's G divides the heads."""
    assert tuple(t_da.ctx_design(2, 48, 64, 128, 4)) == ("wmma", 1, 16)
    assert tuple(t_da.ctx_design(2, 64, 64, 64, 2)) == ("wgmma", 2, 64)
    assert tuple(t_da.ctx_design(1, 64, 128, 64, 1)) == ("wgmma", 1, 64)
    assert tuple(t_da.ctx_design(1, 64, 128, 256, 2)) == ("wmma", 1, 16)  # head_dim 128


@pytest.mark.parametrize("B,D,H,W,C,heads", [(2, 6, 4, 4, 64, 4),   # W < 8: folded in JAX
                                             (1, 5, 3, 8, 32, 2)])
def test_depth_attention_forward_and_gradients(rng, B, D, H, W, C, heads):
    """K3's plain version (the CPU path of `depth_attention`) against the JAX
    `depth_attention`, forward and the gradients of q, k, v under jax.vjp,
    and against the Pallas kernel in interpret mode (which folds W < 8 to
    H*W rows); 2e-5."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    q, k, v, g = f(B, H, W, C), f(B, D, H, W, C), f(B, D, H, W, C), f(B, H, W, C)
    ref, vjp = jax.vjp(lambda q, k, v: j_da.depth_attention(q, k, v, heads),
                       *map(jnp.asarray, (q, k, v)))
    ref_grads = vjp(jnp.asarray(g))
    leaves = [cf(a).requires_grad_(True) for a in (q, k, v)]
    out = t_da.depth_attention(*leaves, heads)
    out.backward(cf(g))
    assert_close(cl(out), ref, 2e-5)
    for got, want in zip(leaves, ref_grads):
        assert_close(cl(got.grad), want, 2e-5)
    # the Pallas kernel itself (interpret mode), which folds W < 8 to H*W rows
    kernel = j_da._pallas_forward(*map(jnp.asarray, (q, k, v)), heads, interpret=True)
    assert_close(cl(out), kernel, 2e-5)


def test_depth_attention_ctx_gradients_of_all_nine_inputs(rng):
    """K1's autograd gradients (plain chain on the CPU) for q, ctx, mean_x,
    m2, Wp, gn_scale, gn_bias, Wk, Wv against jax.grad through the JAX
    depth_attention_ctx (its custom VJP); 1e-4 of each gradient's largest
    magnitude."""
    B, D, H, W, Cc, heads, inner = 2, 6, 4, 4, 16, 2, 32
    a = _ctx_inputs(rng, B, D, H, W, Cc, inner)
    cot = rng.normal(size=(B, H, W, inner)).astype(np.float32)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    mean_x, m2 = j_da.ctx_moments(j["ctx"])
    names = ("q", "ctx", "mean_x", "m2", "Wp", "scale", "bias", "Wk", "Wv")
    jargs = (j["q"], j["ctx"], mean_x, m2, j["Wp"], j["scale"], j["bias"], j["Wk"], j["Wv"])
    ref = jax.grad(lambda *t: jnp.sum(j_da.depth_attention_ctx(*t, heads) * cot),
                   argnums=tuple(range(9)))(*jargs)
    tm, tm2 = t_da.ctx_moments(cf(a["ctx"]))
    # the port's layouts: channels-first maps, nn.Linear (out, in) weights
    leaves = [cf(a["q"]), cf(a["ctx"]), tm, tm2, tt(a["Wp"]).T.contiguous(), tt(a["scale"]),
              tt(a["bias"]), tt(a["Wk"]).T.contiguous(), tt(a["Wv"]).T.contiguous()]
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    (t_da.depth_attention_ctx(*leaves, heads) * cf(cot)).sum().backward()
    back = {0: cl, 1: cl, 4: lambda t: t.T, 7: lambda t: t.T, 8: lambda t: t.T}
    for i, (name, got, want) in enumerate(zip(names, leaves, ref)):
        bound = 1e-4 * float(np.abs(np.asarray(want)).max())
        np.testing.assert_allclose(back.get(i, lambda t: t)(got.grad).detach().numpy(),
                                   np.asarray(want), rtol=0, atol=bound, err_msg=name)


def test_autograd_functions_backward_through_the_plain_versions(rng, monkeypatch):
    """The CUDA path's autograd Functions, run on the CPU with their kernel
    launchers replaced by the plain versions: the backward recomputes through
    the plain chain and returns what autograd of the plain version gives,
    for all nine inputs of K1 and for q, k, v of K3; the cotangent is cast
    to the recomputed output's dtype."""
    monkeypatch.setattr(t_da, "ctx_attention", t_da._ctx_reference)
    monkeypatch.setattr(t_da, "attention_kernel", t_da._reference)
    a = _ctx_inputs(rng, 2, 6, 4, 4, 16, 32)
    mean_x, m2 = t_da.ctx_moments(cf(a["ctx"]))
    nine = [cf(a["q"]), cf(a["ctx"]), mean_x, m2, tt(a["Wp"]).T, tt(a["scale"]),
            tt(a["bias"]), tt(a["Wk"]).T, tt(a["Wv"]).T]
    cot = tt(rng.normal(size=(2, 32, 4, 4)))

    def grads(fn, tensors):
        leaves = [t.detach().clone().requires_grad_(True) for t in tensors]
        (fn(*leaves) * cot).sum().backward()
        return [t.grad for t in leaves]

    via_fn = grads(lambda *t: t_da._DepthAttentionCtx.apply(*t, 2, 8, 1e-5), nine)
    plain = grads(lambda *t: t_da._ctx_full(*t, 2, 8, 1e-5), nine)
    for got, want in zip(via_fn, plain):
        assert_close(got, want, 1e-6)
    qkv = [tt(rng.normal(size=s)) for s in ((2, 32, 4, 4), (2, 32, 6, 4, 4), (2, 32, 6, 4, 4))]
    via_fn = grads(lambda *t: t_da._DepthAttention.apply(*t, 4), qkv)
    plain = grads(lambda *t: t_da._reference(*t, 4), qkv)
    for got, want in zip(via_fn, plain):
        assert_close(got, want, 1e-6)


# K3's plan (`depth_plan`) at the training path's four widths (B=8, 4 heads,
# C = 2 Cc, D halving with W) and at other shapes the kernel takes
K3_SHAPES = [(8, 1024, 6, 16, 4), (8, 512, 12, 64, 4), (8, 256, 24, 256, 4),
             (8, 128, 48, 1024, 4), (16, 1024, 6, 16, 4), (3, 96, 7, 25, 3),
             (2, 64, 6, 16, 4), (1, 32, 5, 24, 2), (2, 128, 9, 72, 4), (1, 2048, 2, 36, 1),
             (4, 384, 6, 100, 3)]


@pytest.mark.parametrize("B,C,D,S,heads", K3_SHAPES)
def test_depth_plan_tiles_channels_and_pixels(B, C, D, S, heads):
    """The cluster is at most 8 and divides the grid; its blocks' channel
    slices tile head_dim exactly; the tiles cover H*W; a block's shared
    memory stays within the plan's limit; 16-byte copies only where rows
    and tiles are multiples of 8 pixels."""
    plan = t_da.depth_plan(B, C, D, S, heads)
    hd = C // heads
    assert plan.cluster in (1, 2, 4, 8) and plan.blocks % plan.cluster == 0
    assert hd % plan.cluster == 0
    cs = hd // plan.cluster
    assert cs >= min(hd, t_da.K3_MIN_SLICE)
    assert [r * cs for r in range(plan.cluster + 1)][-1] == hd
    tiles = -(-S // plan.tile)
    assert 1 <= plan.tile <= S and (tiles - 1) * plan.tile < S <= tiles * plan.tile
    assert plan.blocks == B * heads * tiles * plan.cluster
    assert plan.smem == t_da._k3_smem(cs, D, plan.tile) <= t_da.K3_MAX_SMEM
    assert plan.vec == (8 if S % 8 == 0 and plan.tile % 8 == 0 else 1)


def test_depth_plan_of_the_training_shape():
    """W=4, B=8, head_dim 256: clusters of 8 blocks of 32 channels, one
    tile of all 16 pixels, 8 x 4 x 8 = 256 blocks (one block per head and tile
    would be 32)."""
    assert tuple(t_da.depth_plan(8, 1024, 6, 16, 4)) == (8, 16, 8, 256, 14080)


@pytest.mark.parametrize("B,C,D,S,heads", [
    (2, 128, 6, 16, 3),      # 128 channels do not split into 3 heads
    (1, 2048, 64, 64, 1),    # head_dim 2048 over 64 depths: no tile fits a block
    (0, 128, 6, 16, 4),      # empty batch
    (2, 128, 0, 16, 4),      # no depth
])
def test_depth_plan_refuses_what_the_kernel_cannot_take(B, C, D, S, heads):
    with pytest.raises(ValueError, match="depth_attention"):
        t_da.depth_plan(B, C, D, S, heads)


# K1's cluster-design plan at the main path's narrow shapes (4 heads, Ci =
# 2 Cc): serving B=16, training B=8, the validation chunk's B=4, and W=4's
# ragged tiles at B=1, 2, 3; W=8 past 15 tiles (two tiles a cluster, the
# last cluster's second tile empty at B=17): (B, W, D, Cc) -> (cluster,
# tiles a cluster, samples a tile, tiles, blocks, stages, shared memory)
CLUSTER_PLANS = [
    ((16, 8, 12, 256), (8, 2, 1, 16, 64, 4, 222296)),
    ((8, 8, 12, 256), (8, 1, 1, 8, 64, 8, 201808)),
    ((4, 8, 12, 256), (8, 1, 1, 4, 32, 8, 201808)),
    ((16, 4, 6, 512), (16, 1, 4, 4, 64, 2, 230480)),
    ((4, 4, 6, 512), (16, 1, 4, 1, 16, 2, 230480)),
    ((1, 4, 6, 512), (16, 1, 4, 1, 16, 2, 230480)),
    ((2, 4, 6, 512), (16, 1, 4, 1, 16, 2, 230480)),
    ((3, 4, 6, 512), (16, 1, 4, 1, 16, 2, 230480)),
    ((15, 8, 12, 256), (8, 1, 1, 15, 120, 8, 201808)),
    ((17, 8, 12, 256), (8, 2, 1, 17, 72, 4, 222296)),
]


@pytest.mark.parametrize("shape,want", CLUSTER_PLANS)
def test_ctx_cluster_plan_of_the_narrow_levels(shape, want):
    """Cc / 32 blocks a cluster (32 projection channels and 64 k and v
    channels each: they tile Cc and Ci exactly), one or two tiles of 64
    rows a cluster, the ring as deep as fits beside the held Wk, Wv slices
    and y, within the H100's 227 KB a block; `ctx_design` takes it."""
    B, W, D, Cc = shape
    plan = t_da.ctx_cluster_plan(B, W * W, D, Cc, 2 * Cc, 4)
    assert (plan.cluster, plan.tpc, plan.samples, plan.tiles, plan.blocks, plan.stages,
            plan.smem) == want
    assert plan.blocks == -(-plan.tiles // plan.tpc) * plan.cluster
    assert plan.cluster * t_da.CLUSTER_NP == Cc and plan.cluster * t_da.CLUSTER_KV == 2 * Cc
    assert plan.samples * W * W == t_da.CLUSTER_ROWS
    assert (plan.tiles - 1) * plan.samples < B <= plan.tiles * plan.samples
    assert plan.smem == t_da._cluster_smem(Cc, plan.stages, plan.tpc) <= t_da.MAX_BLOCK_SMEM
    assert t_da._cluster_smem(Cc, plan.stages + 1, plan.tpc) > t_da.MAX_BLOCK_SMEM or (
        plan.stages == t_da.CLUSTER_MAX_STAGES)
    design = t_da.ctx_design(B, W * W, Cc, 2 * Cc, 4)
    assert design == ("cluster", plan.cluster, t_da.CLUSTER_ROWS * plan.tpc)
    assert design.blocks(B, W * W, 4) == plan.blocks


@pytest.mark.parametrize("B,S,D,Cc,Ci,heads,match", [
    (16, 64, 12, 256, 512, 3, "do not split"),      # heads do not divide Ci
    (16, 64, 12, 256, 512, 16, "head_dim"),         # head_dim 32: not a multiple of 64
    (16, 64, 12, 256, 256, 4, "Ci = 2 Cc"),         # Ci != 2 Cc
    (16, 64, 12, 128, 256, 4, "not built for"),     # Cc 128: clusters of 4 are not built
    (16, 64, 12, 768, 1536, 4, "shared memory"),    # Cc 768: Wk, Wv and y overrun a block
    (16, 256, 24, 256, 512, 4, "H\\*W"),           # 256 pixels: more than a tile's 64 rows
    (16, 36, 12, 256, 512, 4, "H\\*W"),            # 36 pixels: not a tile's divisor
    (0, 64, 12, 256, 512, 4, "B, D"),               # empty batch
    (16, 64, 0, 256, 512, 4, "B, D"),               # no depth
])
def test_ctx_cluster_plan_refuses_what_the_kernel_cannot_take(B, S, D, Cc, Ci, heads, match):
    with pytest.raises(ValueError, match=match):
        t_da.ctx_cluster_plan(B, S, D, Cc, Ci, heads)


@pytest.mark.parametrize("Cc,tpc,match", [
    (512, 2, "shared memory"),   # two tiles' y beside Wk, Wv at Cc 512: more than 227 KB
    (256, 3, "shared memory"),
    (256, 0, "not built for"),
])
def test_ctx_cluster_plan_refuses_tiles_a_cluster_it_is_not_built_for(Cc, tpc, match):
    with pytest.raises(ValueError, match=match):
        t_da.ctx_cluster_plan(16, 64 if Cc == 256 else 16, 6, Cc, 2 * Cc, 4, tpc)


@pytest.mark.parametrize("B,S,Cc,Ci,heads,design", [
    (16, 64, 256, 512, 16, ("wmma", 1, 64)),   # head_dim 32
    (2, 64, 128, 256, 2, ("wmma", 1, 16)),     # Cc 128, head_dim 128
    (16, 256, 256, 512, 4, ("wmma", 1, 64)),   # 256 pixels
    (1, 64, 256, 256, 4, ("wmma", 1, 16)),     # Ci = Cc
    (2, 16, 32, 64, 4, ("wmma", 1, 16)),       # the card tests' small W=4 shape
])
def test_wmma_design_takes_what_the_cluster_plan_refuses(B, S, Cc, Ci, heads, design):
    """Shapes the cluster plan refuses keep the port's first, WMMA design."""
    with pytest.raises(ValueError):
        t_da.ctx_cluster_plan(B, S, 6, Cc, Ci, heads)
    assert tuple(t_da.ctx_design(B, S, Cc, Ci, heads)) == design
