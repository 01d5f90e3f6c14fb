"""Port parity of the two kernel modules' plain versions on the CPU, fp32.

K1 (depth_attention_ctx): the port's plain fused chain against the JAX
Pallas kernel run in interpret mode and against the JAX unfused module chain
(2e-4, the JAX package's own bar: tests/test_depth_attention.py). K2 (flash
attention): the port's plain attention against JAX `layers.attention` on the
CPU (1e-5). On the CPU the wrappers take the plain versions and launch
nothing."""

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


@pytest.mark.parametrize("B,L,heads,hd", [(1, 1024, 2, 8), (2, 64, 3, 16)])
def test_flash_plain_matches_jax_attention(rng, B, L, heads, hd):
    """L=1024 is where both packages dispatch to flash; L=64 compares the
    plain version off that path."""
    f = lambda: rng.normal(size=(B, L, heads * hd)).astype(np.float32)
    q, k, v = f(), f(), f()
    ref = j_layers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads)
    assert_close(t_fa.flash_attention(tt(q), tt(k), tt(v), heads), ref, 1e-5)
    assert_close(t_layers.attention(tt(q), tt(k), tt(v), heads), ref, 1e-5)


def test_cpu_wrappers_take_plain_versions_and_launch_nothing(rng):
    t_da.KERNEL.launches = t_fa.KERNEL.launches = 0
    a = _ctx_inputs(rng, 1, 3, 2, 4, 16, 32)
    _port_ctx(a, 2)
    x = tt(rng.normal(size=(1, 1024, 16)))
    t_layers.attention(x, x, x, 2)
    assert t_da.KERNEL.launches == 0 and t_fa.KERNEL.launches == 0
    assert t_da.KERNEL._fn is None and t_fa.KERNEL._fn is None  # nothing built


def test_wrappers_reject_what_the_kernels_do_not_take():
    """Shape checks run before any launch (no card needed to reach them)."""
    q = torch.zeros(1, 64, 4, 4)
    with pytest.raises(ValueError):
        t_da._cuda.check_cuda("x", torch.bfloat16, q)
    assert t_da._tile(16, 1024, 4) == 64 and t_da._tile(16, 64, 4) == 16
