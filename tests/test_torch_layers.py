"""Port parity of the layer zoo (models/layers.py) against the JAX package on
the CPU in fp32, one parametrized case per layer. Parameters come from the
JAX module's init (names, shapes), redrawn from a seed, carried across with
from_jax_params (strict load). Tolerance 1e-4: a few chained fp32 products
and normalizations whose sums run in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphablediffusion_torch.models import layers as T
from morphablediffusion_torch.weights import from_jax_params
from morphablediffusion_tpu.models import layers as J
from tests.torch_parity import assert_close, cf, cl, load_into, seeded_tree, tt

TOL = 1e-4

# name -> (JAX module, port module factory, input kinds, input shapes)
# kind "map": channels-last in JAX, channels-first in the port; "raw": as is.
CASES = {
    "group_norm_silu": (J.GroupNorm(8, act="silu"), lambda: T.GroupNorm(8, 16, act="silu"),
                        ["map"], [(2, 4, 4, 16)]),
    "group_norm_eps6": (J.GroupNorm(32, epsilon=1e-6), lambda: T.GroupNorm(32, 32, 1e-6),
                        ["map"], [(2, 3, 5, 32)]),
    "resblock_skip": (J.ResBlock(64), lambda: T.ResBlock(32, 64, 48), ["map", "raw"],
                      [(2, 4, 4, 32), (2, 48)]),
    "resblock_identity": (J.ResBlock(32), lambda: T.ResBlock(32, 32, 64), ["map", "raw"],
                          [(2, 4, 4, 32), (2, 64)]),
    "upsample": (J.Upsample(16), lambda: T.Upsample(16), ["map"], [(2, 3, 4, 16)]),
    "downsample": (J.Downsample(16), lambda: T.Downsample(16), ["map"], [(2, 6, 5, 16)]),
    "self_attention": (J.CrossAttention(2, 8), lambda: T.CrossAttention(16, 16, 2, 8),
                       ["raw"], [(2, 10, 16)]),
    "cross_attention": (J.CrossAttention(2, 8), lambda: T.CrossAttention(16, 24, 2, 8),
                        ["raw", "raw"], [(2, 10, 16), (2, 5, 24)]),
    "single_key_attention": (J.CrossAttention(2, 8), lambda: T.CrossAttention(16, 24, 2, 8),
                             ["raw", "raw"], [(2, 10, 16), (2, 1, 24)]),
    "geglu": (J.GEGLUFeedForward(), lambda: T.GEGLUFeedForward(16), ["raw"], [(2, 10, 16)]),
    "transformer_block": (J.BasicTransformerBlock(2, 8),
                          lambda: T.BasicTransformerBlock(16, 24, 2, 8), ["raw", "raw"],
                          [(2, 10, 16), (2, 1, 24)]),
    "spatial_transformer": (J.SpatialTransformer(2, 16),
                            lambda: T.SpatialTransformer(32, 2, 16, 1, 24), ["map", "raw"],
                            [(2, 4, 4, 32), (2, 3, 24)]),
    "timestep_mlp": (J.TimestepMLP(32), lambda: T.TimestepMLP(16, 32), ["raw"], [(2, 16)]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_layer_parity(rng, name):
    jmod, make, kinds, shapes = CASES[name]
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    params = seeded_tree(jmod.init(jax.random.key(0), *map(jnp.asarray, xs)))
    ref = jmod.apply(params, *map(jnp.asarray, xs))
    port = load_into(make(), params)
    args = [cf(x) if k == "map" else tt(x) for k, x in zip(kinds, xs)]
    with torch.no_grad():
        out = port(*args)
    assert_close(cl(out) if kinds[0] == "map" else out, ref, TOL)


def test_conv_transpose3d_parity(rng):
    """The flipped conv-style kernel is recognized by its place in the tree
    (FrustumTV3DNet's up<i>/conv), so the bridge is given that path."""
    x = rng.normal(size=(2, 3, 4, 5, 6)).astype(np.float32)
    jmod = J.ConvTranspose3dTorch(8)
    params = seeded_tree(jmod.init(jax.random.key(0), jnp.asarray(x)))
    flat = {f"up0/conv/{k}": np.asarray(v) for k, v in params["params"].items()}
    sd = {k.removeprefix("up0.conv."): v for k, v in from_jax_params(flat, device="cpu").items()}
    port = T.ConvTranspose3dTorch(6, 8)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = port(cf(x))
    assert out.shape == (2, 8, 6, 8, 10)
    assert_close(cl(out), jmod.apply(params, jnp.asarray(x)), TOL)


def test_group_norm_shift_parity(rng):
    """GroupNorm(x + shift) with the add folded into the statistics."""
    x = rng.normal(size=(2, 4, 4, 16)).astype(np.float32)
    s = rng.normal(size=(2, 16)).astype(np.float32)
    jmod = J.GroupNorm(8, act="silu")
    params = seeded_tree(jmod.init(jax.random.key(0), jnp.asarray(x)))
    ref = jmod.apply(params, jnp.asarray(x), jnp.asarray(s))
    out = load_into(T.GroupNorm(8, 16, act="silu"), params)(cf(x), shift=tt(s))
    assert_close(cl(out), ref, TOL)


def test_single_key_shortcut_equals_general_path(rng):
    """The single-key shortcut is exact: a context of two identical keys
    takes the general path and gives the same output."""
    mod = T.CrossAttention(16, 24, 2, 8).eval()
    x = tt(rng.normal(size=(2, 10, 16)))
    c = tt(rng.normal(size=(2, 1, 24)))
    with torch.no_grad():
        assert_close(mod(x, c), mod(x, torch.cat([c, c], dim=1)), 1e-5)


@pytest.mark.parametrize("B,L,heads,hd", [(1, 1024, 2, 8), (2, 40, 3, 16)])
def test_attention_core_gradients(rng, B, L, heads, hd):
    """The attention core's gradients (the flash path at L = 1024, SDPA
    elsewhere; plain versions on the CPU) against jax.grad of
    jax.nn.dot_product_attention; 2e-5."""
    q, k, v, g = (rng.normal(size=(B, L, heads * hd)).astype(np.float32) for _ in range(4))
    split = lambda t: jnp.asarray(t).reshape(B, L, heads, hd)
    ref = jax.grad(lambda q, k, v: jnp.sum(jax.nn.dot_product_attention(
        split(q), split(k), split(v)).reshape(B, L, -1) * g), argnums=(0, 1, 2))(q, k, v)
    leaves = [tt(t).requires_grad_(True) for t in (q, k, v)]
    (T.attention(*leaves, heads) * tt(g)).sum().backward()
    for got, want in zip(leaves, ref):
        assert_close(got.grad, want, 2e-5)
