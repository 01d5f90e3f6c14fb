"""The fine mesh-voxel conditioner (`mesh_voxel_mode='fine'`) in the port,
against the JAX package on the CPU, fp32: `FineMeshVoxelNet` alone, the
weight bridge of its tree, and the slice as a whole (a tiny sampler
trajectory, as tests/test_torch_sampler.py runs it and under its stated
known limit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphablediffusion_torch.models import mesh_voxel as Tm
from morphablediffusion_torch.weights import (
    NORM_MODULES,
    cast_for_serving,
    flatten_tree,
    seeded_params,
    to_jax_layout,
)
from morphablediffusion_tpu.models import mesh_voxel as Jm
from tests.tiny import tiny_config
from tests.torch_parity import (assert_close, assert_slice_matches, cl, load_into,
                                sampler_run, seeded_tree, tt)

TOL = 1e-4


def _with_running_stats(params, rng):
    """BNActive leaves (those of a mesh_voxel tree, or of a bare fine net) as
    tests/test_mesh_voxel_fine.py sets them on its oracle: running mean
    N(0, 0.3^2), running variance U(0.5, 2), scale N(1, 0.2^2), bias
    N(0, 0.2^2); everything else as given."""
    def leaf(path, v):
        names = [str(k.key) for k in path]
        if "net" not in names:
            return v
        name = names[-1]
        draw = {"mean": lambda: rng.normal(0, 0.3, v.shape),
                "var": lambda: rng.uniform(0.5, 2.0, v.shape),
                "scale": lambda: rng.normal(1.0, 0.2, v.shape),
                "bias": lambda: rng.normal(0, 0.2, v.shape)}.get(name)
        return v if draw is None else draw().astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, params)


def test_fine_mesh_voxel_net(rng):
    """Two samples with different extents on one static grid: the per-sample
    out_sh arithmetic, the extent clipping after each downsample, and the
    query renormalization (within 2e-4, as the JAX package holds itself to
    its spconv oracle)."""
    voxel, static = 0.005, (32, 28, 24)
    B, Nv, P = 2, 40, 64
    extents = [np.array([26, 22, 18]), np.array([14, 26, 10])]
    min_dhw = np.asarray([[0.3, -0.2, 0.1], [-1.0, 0.5, 0.25]], np.float32)
    feats, dhw, mask, query = [], [], [], []
    for b in range(B):
        D, H, W = extents[b]
        cells = rng.permutation((D - 2) * (H - 2) * (W - 2))[:Nv - 4]
        coords = np.stack(np.unravel_index(cells, (D - 2, H - 2, W - 2)), -1)
        coords[0], coords[1] = (0, 0, 0), (D - 2, H - 2, W - 2)
        coords = np.concatenate([coords, np.zeros((4, 3), np.int64)])
        feats.append(np.concatenate([rng.normal(size=(Nv - 4, 16)), np.zeros((4, 16))]))
        dhw.append(min_dhw[b] + coords * voxel)
        mask.append(np.concatenate([np.ones(Nv - 4), np.zeros(4)]))
        query.append(min_dhw[b] + rng.uniform(-3.0, max(extents[b]) + 3.0, (P, 3)) * voxel)
    args = [np.stack(a).astype(np.float32) for a in (feats, dhw)] + [min_dhw] + [
        np.stack(a).astype(np.float32) for a in (mask, query)]

    jnet = Jm.FineMeshVoxelNet(grid_shape=static, voxel_size=voxel)
    jargs = tuple(map(jnp.asarray, args))
    params = _with_running_stats(seeded_tree(jax.eval_shape(
        lambda *a: jnet.init(jax.random.key(0), *a), *jargs)), np.random.default_rng(3))
    want = jax.jit(jnet.apply)(params, *jargs)
    port = load_into(Tm.FineMeshVoxelNet(16, static, voxel), params)
    with torch.no_grad():
        got = port(*map(tt, args))
    assert got.shape == (B, 64, P)
    assert float(got.abs().max()) > 0
    assert_close(cl(got), want, 2e-4)


def test_fine_weights_bridge():
    """BNActive's mean and var load by their JAX names, seed to 0 and 1, stay
    fp32 when the model is cast, and map back to the JAX tree."""
    net = seeded_params(Tm.FineMeshVoxelNet(16, (16, 16, 16), 0.05), seed=0)
    bn = net.net.conv2_7
    assert isinstance(bn, NORM_MODULES)
    assert torch.equal(bn.mean, torch.zeros(64)) and torch.equal(bn.var, torch.ones(64))
    cast_for_serving(net)
    assert bn.var.dtype == torch.float32 and net.net.conv2_6.weight.dtype == torch.bfloat16
    jax_names = set(to_jax_layout(net, dict(net.named_parameters())))
    jnet = Jm.FineMeshVoxelNet(grid_shape=(16, 16, 16), voxel_size=0.05)
    shapes = jax.eval_shape(lambda: jnet.init(
        jax.random.key(0), jnp.zeros((1, 8, 16)), jnp.zeros((1, 8, 3)), jnp.zeros((1, 3)),
        jnp.ones((1, 8)), jnp.zeros((1, 4, 3))))
    assert jax_names == set(flatten_tree(shapes["params"]))


@pytest.fixture(scope="module")
def fine_run():
    cfg = tiny_config(view_num=2)
    cfg.model.mesh_voxel_mode = "fine"
    cfg.model.fine_grid_shape = (16, 16, 16)
    cfg.model.fine_voxel_size = 0.05
    return sampler_run(cfg, adjust=lambda p: _with_running_stats(p, np.random.default_rng(5)))


def test_fine_mode_sampler_trajectory(fine_run):
    assert_slice_matches(fine_run)
