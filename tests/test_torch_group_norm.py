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
    assert [k.launches for k in t_gn.KERNELS] == before == [0]


def test_shifted_with_and_without_grad_agree_and_launch_nothing():
    """`group_norm_shifted` where autograd needs a gradient (an input that
    requires one) and where it does not (no_grad, inference mode, plain
    tensors): the same result on the CPU, which takes the plain version
    and launches nothing."""
    x, shift, gamma, beta = _inputs(7, (2, 6, 6, 16), True)
    args = lambda grad: (cf(x).requires_grad_(grad), tt(shift), tt(gamma), tt(beta))
    before = [k.launches for k in t_gn.KERNELS]
    with_grad = t_gn.group_norm_shifted(*args(True), 8, 1e-5, "silu")
    plain = t_gn.group_norm_shifted(*args(False), 8, 1e-5, "silu")
    with torch.no_grad():
        no_grad = t_gn.group_norm_shifted(*args(True), 8, 1e-5, "silu")
    with torch.inference_mode():
        inference = t_gn.group_norm_shifted(*args(False), 8, 1e-5, "silu")
    assert with_grad.grad_fn is not None and no_grad.grad_fn is None
    for out in (plain, no_grad, inference):
        assert torch.equal(out, with_grad.detach())
    assert [k.launches for k in t_gn.KERNELS] == before


def test_needs_autograd():
    """The rule by which a CUDA wrapper skips its autograd Function."""
    a, b = torch.zeros(2), torch.zeros(2, requires_grad=True)
    assert not t_gn._cuda.needs_autograd(a, None)
    assert t_gn._cuda.needs_autograd(a, None, b)
    with torch.no_grad():
        assert not t_gn._cuda.needs_autograd(a, b)
    with torch.inference_mode():
        assert not t_gn._cuda.needs_autograd(b)


# K4's plan (`gn_plan`) at GroupNorm calls like those of the censuses: the
# UNet at serving (CFG-doubled 16 views) and in training, its bottom (S =
# 16), the DepthTransformers, the frustum and spatial-time volumes, the VAE
# encode and decode, the zero-context row, and odd sizes
GN_SHAPES = [((32, 320, 32, 32), 32), ((32, 640, 16, 16), 32), ((32, 1280, 8, 8), 32),
             ((32, 1280, 4, 4), 32), ((32, 2560, 4, 4), 32), ((8, 1280, 4, 4), 32),
             ((32, 128, 32, 32), 8), ((32, 512, 4, 4), 8), ((16, 64, 48, 32, 32), 8),
             ((16, 32, 48, 32, 32), 8), ((1, 256, 32, 32, 32), 8), ((1, 64, 128, 144, 128), 8),
             ((16, 128, 256, 256), 32), ((16, 256, 256, 256), 32), ((1, 128, 256, 256), 32),
             ((16, 512, 32, 32), 32), ((1, 512, 32, 32), 32), ((1, 512), 8),
             ((3, 40, 5, 7), 4), ((2, 96, 3), 3)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,groups", GN_SHAPES)
def test_gn_plan_covers_every_span(shape, groups, dtype):
    """The cluster is at most 8 and divides the grid; a cluster's chunks
    cover the span; a block holds its share of the span in shared memory,
    or as much as the budget allows and reads the rest twice; 16-byte loads
    only where S allows them."""
    plan = t_gn.gn_plan(shape, dtype, groups)
    B, C = shape[:2]
    S = int(np.prod(shape[2:]))
    span, esize = C // groups * S, 4 if dtype == torch.float32 else 2
    assert plan.cluster in (1, 2, 4, 8) and plan.pack in (1, 2, 4, 8)
    assert plan.cluster == 1 or plan.pack == 1
    assert plan.blocks % plan.cluster == 0
    assert plan.blocks == -(-B * groups // plan.pack) * plan.cluster
    assert plan.vec == (16 // esize if S % (16 // esize) == 0 else 1)
    assert plan.chunk % plan.vec == 0
    assert plan.chunk * plan.cluster >= span > plan.chunk * (plan.cluster - 1)
    # a block holds its share, or the budget's worth of it and reads the rest twice
    assert plan.held % plan.vec == 0 and 0 < plan.held <= plan.chunk
    if plan.pack > 1:
        assert plan.held == plan.chunk == span
    else:
        assert plan.held == min(plan.chunk, t_gn.GN_MAX_HELD_BYTES // esize)
    assert plan.resident == (plan.held == plan.chunk)
    assert plan.smem == t_gn._gn_smem(C // groups, plan.pack, plan.held, esize) <= 232448
    if plan.pack > 1:  # packed only where one pair gives a block's threads no vector each
        assert span * plan.pack // 2 < t_gn.GN_THREADS * plan.vec
    if plan.cluster > 1:  # split only to bound a block's share or to fill the card
        assert (span * esize > plan.cluster // 2 * t_gn.GN_TARGET_BYTES
                or B * groups * plan.cluster // 2 < t_gn.GN_FILL)


def test_gn_plan_of_the_largest_spans():
    """The VAE decode's (16, 128, 256^2) bf16 span (512 KiB) goes to a
    cluster of 8 at 64 KiB a block, of which each holds 32 KiB and reads
    the rest twice; so at 256 channels (1 MiB) and in fp32. A 128 KiB span
    goes to 4 blocks that hold all of it. The UNet's bottom packs 4 pairs a
    block."""
    big = t_gn.gn_plan((16, 128, 256, 256), torch.bfloat16, 32)
    assert (big.cluster, big.chunk * 2, big.held * 2, big.resident) == (8, 65536, 32768, False)
    wide = t_gn.gn_plan((16, 256, 256, 256), torch.float32, 32)
    assert (wide.cluster, wide.chunk * 4, wide.held * 4, wide.resident) == (8, 262144, 32768,
                                                                             False)
    whole = t_gn.gn_plan((8, 128, 128, 128), torch.bfloat16, 32)
    assert (whole.cluster, whole.held * 2, whole.resident) == (4, 32768, True)
    bottom = t_gn.gn_plan((32, 1280, 4, 4), torch.bfloat16, 32)
    assert (bottom.pack, bottom.cluster, bottom.blocks) == (4, 1, 256)
    # a misaligned x: one element per load
    assert t_gn.gn_plan((32, 1280, 4, 4), torch.bfloat16, 32, aligned=False).vec == 1


@pytest.mark.parametrize("shape,dtype,groups,match", [
    ((2, 64, 8, 8), torch.float16, 32, "bfloat16 or float32"),
    ((2, 64, 8, 8), torch.bfloat16, 24, "not divisible"),
    ((2,), torch.bfloat16, 1, "non-empty"),
    ((2, 64, 0, 8), torch.bfloat16, 32, "non-empty"),
    ((1, 2, 2**16, 2**15), torch.bfloat16, 1, "2\\^31"),
    ((1, 40000, 4), torch.bfloat16, 1, "channels per group"),
])
def test_gn_plan_refuses_what_the_kernel_cannot_take(shape, dtype, groups, match):
    with pytest.raises(ValueError, match=match):
        t_gn.gn_plan(shape, dtype, groups)
