"""K4's function on the CPU: the port's plain GroupNorm (`_reference`, which
the kernel `csrc/group_norm.cu` is held to on the card) and the backward of
its autograd Function, against the JAX package's GroupNorm, fp32.

Inputs are drawn with numpy from a seed and handed to both sides; the JAX
side is channels-last, the port channels-first. Tolerances: 2e-5 against the
JAX plain functions (the same one-pass fp32 formula, summed in another
order), 2e-4 against the Pallas kernel run in interpret mode (as
tests/test_group_norm.py holds it to its reference), 1e-4 for the gradients
(fp32 reductions over whole groups in both directions)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from morphablediffusion_torch.ops import group_norm as t_gn
from morphablediffusion_tpu.ops import group_norm as j_gn
from tests.torch_parity import assert_close, cf, cl, tt

# (channels-last shape, groups): 2-D maps and 3-D volumes, cg = 2 and wider
SHAPES = [((2, 6, 6, 16), 8),
          ((2, 8, 8, 64), 32),
          ((2, 4, 6, 6, 32), 8),
          ((1, 3, 4, 4, 64), 8)]
ACTS = [None, "silu", "relu"]


def _inputs(seed, shape, shifted):
    rng = np.random.default_rng(seed)
    B, C = shape[0], shape[-1]
    x = rng.normal(size=shape).astype(np.float32) * 1.5 + 0.3
    gamma = (1.0 + 0.2 * rng.normal(size=(C,))).astype(np.float32)
    beta = (0.2 * rng.normal(size=(C,))).astype(np.float32)
    shift = rng.normal(size=(B, C)).astype(np.float32) if shifted else None
    return x, shift, gamma, beta


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape,groups", SHAPES)
def test_plain_matches_jax_reference(shape, groups, act, eps):
    x, _, gamma, beta = _inputs(0, shape, False)
    ref = j_gn._reference(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups,
                          eps, act)
    out = t_gn._reference(cf(x), None, tt(gamma), tt(beta), groups, eps, act)
    assert_close(cl(out), ref, 2e-5)
    # the public entry on a CPU tensor is the plain version
    assert torch.equal(t_gn.group_norm(cf(x), tt(gamma), tt(beta), groups, eps, act), out)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape,groups", SHAPES)
def test_plain_matches_pallas_kernel_in_interpret_mode(shape, groups, act):
    """The JAX package's `_kernel`, launched as tests/test_group_norm.py
    launches it: one sample per grid step, spatial axes flattened."""
    x, _, gamma, beta = _inputs(1, shape, False)
    B, C = shape[0], shape[-1]
    S = int(np.prod(shape[1:-1]))
    kernel = functools.partial(j_gn._kernel, num_groups=groups, epsilon=1e-5, act=act)
    want = pl.pallas_call(
        kernel,
        grid=(B,),
        in_specs=[
            pl.BlockSpec((1, S, C), lambda b: (b, 0, 0)),
            pl.BlockSpec((1, C), lambda b: (0, 0)),
            pl.BlockSpec((1, C), lambda b: (0, 0)),
        ],
        out_specs=pl.BlockSpec((1, S, C), lambda b: (b, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, S, C), jnp.float32),
        interpret=True,
    )(jnp.asarray(x).reshape(B, S, C), jnp.asarray(gamma).reshape(1, C),
      jnp.asarray(beta).reshape(1, C))
    out = t_gn._reference(cf(x), None, tt(gamma), tt(beta), groups, 1e-5, act)
    assert_close(cl(out), np.asarray(want).reshape(shape), 2e-4)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape,groups", SHAPES)
def test_shifted_matches_jax(shape, groups, act, eps):
    x, shift, gamma, beta = _inputs(2, shape, True)
    ref = j_gn.group_norm_shifted(jnp.asarray(x), jnp.asarray(shift), jnp.asarray(gamma),
                                  jnp.asarray(beta), groups, eps, act)
    out = t_gn.group_norm_shifted(cf(x), tt(shift), tt(gamma), tt(beta), groups, eps, act)
    assert_close(cl(out), ref, 2e-5)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape,groups", SHAPES[::2])
def test_backward_matches_jax_vjp(shape, groups, act, shifted):
    """`recompute_grads`, the backward of the kernel's autograd Function,
    against jax.vjp of the JAX functions: x, gamma, beta and the shift."""
    x, shift, gamma, beta = _inputs(3, shape, shifted)
    g = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    if shifted:
        _, vjp = jax.vjp(lambda x, s, gm, bt: j_gn.group_norm_shifted(x, s, gm, bt, groups,
                                                                      1e-5, act),
                         *map(jnp.asarray, (x, shift, gamma, beta)))
        want = vjp(jnp.asarray(g))
    else:
        _, vjp = jax.vjp(lambda x, gm, bt: j_gn.group_norm(x, gm, bt, groups, 1e-5, act),
                         *map(jnp.asarray, (x, gamma, beta)))
        dx, dgamma, dbeta = vjp(jnp.asarray(g))
        want = (dx, None, dgamma, dbeta)
    got = t_gn.recompute_grads(cf(x), None if shift is None else tt(shift), tt(gamma),
                               tt(beta), cf(g), groups, 1e-5, act)
    assert_close(cl(got[0]), want[0], 1e-4)
    for a, b in zip(got[1:], want[1:]):
        assert (a is None) == (b is None)
        if b is not None:
            assert_close(a, b, 1e-4)


def test_backward_takes_only_what_is_needed():
    x, shift, gamma, beta = _inputs(5, (2, 6, 6, 16), True)
    got = t_gn.recompute_grads(cf(x), tt(shift), tt(gamma), tt(beta), cf(x), 8, 1e-5,
                               "silu", needs=(True, False, False, True))
    assert got[0] is not None and got[3] is not None and got[1] is None and got[2] is None


def test_constant_input_stays_finite():
    """Channel-wise constant input: E[x^2] - E[x]^2 cancels; the clamp keeps
    it finite and the output is act(0) (tests/test_group_norm.py:73-85)."""
    x = torch.linspace(-2.0, 2.0, 32).reshape(1, 32, 1, 1).expand(2, 32, 8, 8).contiguous()
    for act in ACTS:
        y = t_gn.group_norm(x, torch.ones(32), torch.zeros(32), 32, 1e-5, act)
        assert torch.isfinite(y).all()
        np.testing.assert_allclose(y.numpy(), 0.0, atol=1e-3)


def test_cpu_tensors_launch_no_kernel():
    x, shift, gamma, beta = _inputs(6, (2, 6, 6, 16), True)
    before = [k.launches for k in t_gn.KERNELS]
    t_gn.group_norm_shifted(cf(x).requires_grad_(True), tt(shift), tt(gamma), tt(beta), 8)
    assert [k.launches for k in t_gn.KERNELS] == before == [0, 0]
