"""Port parity of models/unet.py against the JAX package on the CPU, fp32.

On the CPU the JAX DepthTransformer runs the unfused chain, while the port
runs the fused context chain's plain version (moments folded into an affine)
where the JAX gate on the TPU would (`unet.fused_ok`: inner width 128 here,
at serving), so those comparisons use the JAX package's own
fused-vs-unfused bar, 2e-4. The port's train path at W=4 is the unfused
chain: 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphablediffusion_torch.models import unet as T
from morphablediffusion_tpu.models import unet as J
from tests.torch_parity import assert_close, cf, cl, load_into, seeded_tree, tt


def _depth_tf(rng, B, Bc):
    C, CTX, D, H, W = 32, 64, 6, 4, 4  # inner width 4 x 32: fused at serving
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    ctx = rng.normal(size=(Bc, D, H, W, CTX)).astype(np.float32)
    jmod = J.DepthTransformer(num_heads=4, head_dim=32, out_channels=C, ctx_dim=CTX)
    params = seeded_tree(jmod.init(jax.random.key(0), jnp.asarray(x[:Bc]), jnp.asarray(ctx)))
    port = load_into(T.DepthTransformer(4, 32, C, C, CTX), params)
    return x, ctx, jmod, params, port


@pytest.mark.parametrize("train,tol", [(False, 2e-4), (True, 1e-4)])
def test_depth_transformer(rng, train, tol):
    x, ctx, jmod, params, port = _depth_tf(rng, 2, 2)
    ref = jmod.apply(params, jnp.asarray(x), jnp.asarray(ctx))
    with torch.no_grad():
        out = port(cf(x), cf(ctx), train=train)
    assert_close(cl(out), ref, tol)


def test_depth_transformer_cfg_doubled(rng):
    """The analytic zero-context half (depth-1 attention = to_out(to_v(c_u)))
    against the JAX cfg_doubled path, and against the port's own explicit
    zero-context full batch (exact up to fp32 rounding)."""
    x, ctx, jmod, params, port = _depth_tf(rng, 4, 2)
    ref = jmod.apply(params, jnp.asarray(x), jnp.asarray(ctx), True)
    with torch.no_grad():
        out = port(cf(x), cf(ctx), cfg_doubled=True)
        full = torch.cat([cf(ctx), torch.zeros_like(cf(ctx))])
        explicit = port(cf(x), full)
    assert_close(cl(out), ref, 2e-4)
    assert_close(out, explicit, 1e-5)


def test_depth_transformer_rejects_batch_mismatch(rng):
    x, ctx, _, _, port = _depth_tf(rng, 4, 2)
    with pytest.raises(ValueError):
        port(cf(x), cf(ctx))


@pytest.mark.parametrize("cfg_doubled", [False, True])
def test_tiny_unet(rng, cfg_doubled):
    """A tiny DepthWiseUNet (model_channels 32, volume dims 8..64, 8x8
    latent): inner widths 16 to 128, the 128 one on a 1x1 frustum, so every
    DepthTransformer takes the unfused chain."""
    B = 4 if cfg_doubled else 2
    Bc = B // 2 if cfg_doubled else B
    dims = (8, 16, 32, 64)
    x = rng.normal(size=(B, 8, 8, 8)).astype(np.float32)
    t = np.array([3, 500, 999, 41][:B])
    context = rng.normal(size=(B, 1, 768)).astype(np.float32)
    src = {w: rng.normal(size=(Bc, w, w, w, c)).astype(np.float32)
           for w, c in zip((8, 4, 2, 1), dims)}
    kw = dict(model_channels=32, num_heads=4, volume_dims=dims)
    jmod = J.DepthWiseUNet(**kw)
    jsrc = {w: jnp.asarray(v) for w, v in src.items()}
    params = seeded_tree(jax.eval_shape(  # the init's tree; values are seeded
        lambda a, b, c, d: jmod.init(jax.random.key(0), a, b, c, d),
        jnp.asarray(x[:Bc]), jnp.asarray(t[:Bc]), jnp.asarray(context[:Bc]), jsrc))
    ref = jax.jit(lambda p, a, b, c, d: jmod.apply(p, a, b, c, d, cfg_doubled=cfg_doubled))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(context), jsrc)
    port = load_into(T.DepthWiseUNet(**kw), params)
    with torch.no_grad():
        out = port(cf(x), torch.from_numpy(t), tt(context),
                   {w: cf(v) for w, v in src.items()}, cfg_doubled=cfg_doubled)
    assert out.dtype == torch.float32
    assert_close(cl(out), ref, 2e-4)


def test_depth_transformer_hands_the_kernel_contiguous_tensors(rng, monkeypatch):
    """cuDNN may return channels-last maps (SpatialTransformer's permute feeds
    them); the kernel wrapper takes contiguous NCHW / NCDHW only."""
    from morphablediffusion_torch.ops import depth_attention as da

    seen = []
    fused = da.depth_attention_ctx

    def spy(q, ctx, *rest):
        seen.append((q.is_contiguous(), ctx.is_contiguous()))
        return fused(q, ctx, *rest)

    x, ctx, jmod, params, port = _depth_tf(rng, 2, 2)
    monkeypatch.setattr(da, "depth_attention_ctx", spy)
    xc = cf(x).to(memory_format=torch.channels_last)
    cc = cf(ctx).to(memory_format=torch.channels_last_3d)
    assert not xc.is_contiguous() and not cc.is_contiguous()
    with torch.no_grad():
        out = port(xc, cc)
    assert seen == [(True, True)]
    assert_close(cl(out), jmod.apply(params, jnp.asarray(x), jnp.asarray(ctx)), 2e-4)
