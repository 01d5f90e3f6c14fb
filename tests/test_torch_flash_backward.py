"""The function of the flash-attention backward kernels (K2-dkv, K2-dq) on
the CPU: the port's plain versions `backward_dkv_reference` and
`backward_dq_reference`, which the kernels of `csrc/flash_attention_bwd.cu`
are held to on the card, against `jax.grad` of `jax.nn.dot_product_attention`.

The references take the row statistics as the kernels do: lse from the
port's `logsumexp_reference` and di = rowsum(dO * O) from `row_dot` over the
port's plain attention output. Inputs are drawn with numpy from a seed, fp32;
a ragged L (not a multiple of the kernels' 64-row tiles) is where their
masking lives. Tolerance 2e-5: the same fp32 products summed in another
order, and di in place of JAX's rowsum(P * dP).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from morphablediffusion_torch.ops import flash_attention as t_fa
from tests.torch_parity import assert_close, tt

# (B, L, heads, head_dim)
SHAPES = [(1, 1024, 2, 8), (2, 65, 3, 40), (1, 200, 2, 64)]
TOL = 2e-5


@functools.lru_cache(maxsize=None)
def _case(B, L, heads, hd):
    """Inputs (numpy), the references' (dq, dk, dv) and JAX's."""
    rng = np.random.default_rng(B * 1000 + L + hd)
    q, k, v, dout = (rng.normal(size=(B, L, heads * hd)).astype(np.float32) for _ in range(4))

    split = lambda x: jnp.asarray(x).reshape(B, L, heads, hd)
    _, vjp = jax.vjp(lambda *a: jax.nn.dot_product_attention(*a), split(q), split(k), split(v))
    want = [np.asarray(g).reshape(B, L, heads * hd) for g in vjp(split(dout))]

    tq, tk, tv, tdo = (tt(x) for x in (q, k, v, dout))
    lse = t_fa.logsumexp_reference(tq, tk, heads)
    di = t_fa.row_dot(t_fa.attention_reference(tq, tk, tv, heads), tdo, heads)
    dk, dv = t_fa.backward_dkv_reference(tq, tk, tv, tdo, lse, di, heads)
    dq = t_fa.backward_dq_reference(tq, tk, tv, tdo, lse, di, heads)
    return (dq, dk, dv), want


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_dkv_reference_matches_jax_grad(shape):
    (_, dk, dv), (_, want_dk, want_dv) = _case(*shape)
    assert dk.shape == dv.shape == want_dk.shape
    assert_close(dk, want_dk, TOL)
    assert_close(dv, want_dv, TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_dq_reference_matches_jax_grad(shape):
    (dq, _, _), (want_dq, _, _) = _case(*shape)
    assert dq.shape == want_dq.shape
    assert_close(dq, want_dq, TOL)
