"""`use_spatial_volume=True` in the port, against the JAX package on the CPU,
fp32: `SpatialTime3DNet` alone, and the slice as a whole (a tiny sampler
trajectory, as tests/test_torch_sampler.py runs it and under its stated
known limit). Tolerance 1e-4, as there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphablediffusion_torch.models import conditioner as Tc
from morphablediffusion_tpu.models import conditioner as Jc
from tests.tiny import tiny_config
from tests.torch_parity import (assert_close, assert_slice_matches, cf, cl, load_into,
                                sampler_run, seeded_tree, tt)

TOL = 1e-4


def test_spatial_time_3d_net(rng):
    """Narrow dims, an 8^3 volume of 2 views x 16 channels; the up blocks'
    transposed convs (conv7-conv9) load through the weight bridge's flip."""
    dims = (8, 16, 32, 64)
    x = rng.normal(size=(2, 8, 8, 8, 32)).astype(np.float32)
    t = rng.normal(size=(2, 256)).astype(np.float32)
    jmod = Jc.SpatialTime3DNet(dims)
    args = (jnp.asarray(x), jnp.asarray(t))
    params = seeded_tree(jax.eval_shape(lambda *a: jmod.init(jax.random.key(0), *a), *args))
    want = jax.jit(jmod.apply)(params, *args)
    port = load_into(Tc.SpatialTime3DNet(32, 256, dims), params)
    with torch.no_grad():
        got = port(cf(x), tt(t))
    assert got.shape == (2, 8, 8, 8, 8)
    assert_close(cl(got), want, TOL)


@pytest.fixture(scope="module")
def spatial_time_run():
    cfg = tiny_config(view_num=2)
    cfg.model.use_spatial_volume = True
    return sampler_run(cfg)


def test_spatial_volume_sampler_trajectory(spatial_time_run):
    assert_slice_matches(spatial_time_run)
