"""Port parity of the plain ops: schedules, embeddings, geometry (both
projections), grid sampling and GroupNorm, against the JAX package on the
CPU in fp32. Tolerance 1e-5 (fp32 rounding of identical formulas)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphablediffusion_torch.ops import embeddings as t_emb
from morphablediffusion_torch.ops import geometry as t_geo
from morphablediffusion_torch.ops import grid_sample as t_gs
from morphablediffusion_torch.ops import group_norm as t_gn
from morphablediffusion_torch.ops import schedules as t_sched
from morphablediffusion_tpu.ops import embeddings as j_emb
from morphablediffusion_tpu.ops import geometry as j_geo
from morphablediffusion_tpu.ops import grid_sample as j_gs
from morphablediffusion_tpu.ops import group_norm as j_gn
from morphablediffusion_tpu.ops import schedules as j_sched
from tests.torch_parity import assert_close, cf, cl, tt

TOL = 1e-5


def test_schedule_tables():
    js = j_sched.make_diffusion_schedule()
    ts = t_sched.make_diffusion_schedule()
    for f in ("betas", "alphas_cumprod", "sqrt_alphas_cumprod",
              "sqrt_one_minus_alphas_cumprod", "posterior_log_variance_clipped"):
        assert_close(getattr(ts, f), getattr(js, f), TOL)
    jd = j_sched.make_ddim_schedule(js, 50, 1.0)
    td = t_sched.make_ddim_schedule(ts, 50, 1.0)
    np.testing.assert_array_equal(td.timesteps.numpy(), np.asarray(jd.timesteps))
    for f in ("alphas", "alphas_prev", "sqrt_one_minus_alphas", "sigmas"):
        assert_close(getattr(td, f), getattr(jd, f), TOL)


@pytest.mark.parametrize("index,with_noise", [(0, False), (17, True), (49, True)])
def test_add_noise_and_ddim_step(rng, index, with_noise):
    js = j_sched.make_diffusion_schedule()
    ts = t_sched.make_diffusion_schedule()
    jd, td = j_sched.make_ddim_schedule(js, 50), t_sched.make_ddim_schedule(ts, 50)
    x = rng.normal(size=(2, 3, 4, 4, 4)).astype(np.float32)
    eps = rng.normal(size=x.shape).astype(np.float32)
    noise = rng.normal(size=x.shape).astype(np.float32) if with_noise else None
    t = np.array([5, 900])
    assert_close(t_sched.add_noise(tt(x), tt(eps), torch.from_numpy(t), ts),
                 j_sched.add_noise(jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t), js), TOL)
    out = t_sched.ddim_step(tt(x), tt(eps), index, td,
                            None if noise is None else tt(noise))
    ref = j_sched.ddim_step(jnp.asarray(x), jnp.asarray(eps), index, jd,
                            None if noise is None else jnp.asarray(noise))
    assert_close(out, ref, TOL)


@pytest.mark.parametrize("dim", [256, 33])
def test_timestep_embedding(dim):
    """Tolerance 1e-4: the phase t * freq at t ~ 1000 carries the fp32 ulp of
    1000 (6e-5), and the two frameworks' exp may differ by one ulp."""
    t = np.array([0, 1, 21, 981])
    assert_close(t_emb.timestep_embedding(torch.from_numpy(t), dim),
                 j_emb.timestep_embedding(jnp.asarray(t), dim), 1e-4)


def test_viewpoint_embedding(rng):
    args = [rng.uniform(-90, 90, s).astype(np.float32) for s in [(2, 1), (2, 1), (2, 5), (2, 5)]]
    assert_close(t_emb.viewpoint_embedding(*map(tt, args)),
                 j_emb.viewpoint_embedding(*map(jnp.asarray, args)), TOL)


def _cameras(rng, B, projection):
    poses = []
    for _ in range(B):
        a = rng.uniform(-0.5, 0.5)
        R = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]])
        t = np.array([0.05, -0.02, 4.0]) + 0.1 * rng.normal(size=3)
        poses.append(np.concatenate([R, t[:, None]], 1))
    K = np.eye(4)
    if projection == "perspective":
        K[:3, :3] = [[80.0, 0, 32], [0, 80.0, 32], [0, 0, 1]]
    else:
        K[0, 0] = K[1, 1] = 1 / 0.6
    return (np.stack(poses).astype(np.float32),
            np.broadcast_to(K, (B, 4, 4)).astype(np.float32))


@pytest.mark.parametrize("projection", ["perspective", "orthographic"])
def test_projection_and_warp(rng, projection):
    poses, Ks = _cameras(rng, 2, projection)
    pts = rng.uniform(-0.5, 0.5, (2, 2, 3, 3, 3)).astype(np.float32)
    out = t_geo.get_warp_coordinates(tt(pts), 8, 64, tt(Ks), tt(poses), projection)
    ref = j_geo.get_warp_coordinates(jnp.asarray(pts), 8, 64, jnp.asarray(Ks),
                                     jnp.asarray(poses), projection)
    assert_close(out, ref, TOL)
    proj_t = t_geo.construct_project_matrix(0.5, 0.5, tt(Ks), tt(poses), projection)
    proj_j = j_geo.construct_project_matrix(0.5, 0.5, jnp.asarray(Ks), jnp.asarray(poses),
                                            projection)
    assert_close(proj_t, proj_j, TOL)


def test_near_far_and_camera_positions(rng):
    poses, _ = _cameras(rng, 3, "perspective")
    for a, b in zip(t_geo.near_far_from_unit_sphere(tt(poses)),
                    j_geo.near_far_from_unit_sphere(jnp.asarray(poses))):
        assert_close(a, b, TOL)
    assert_close(t_geo.camera_positions(tt(poses)), j_geo.camera_positions(jnp.asarray(poses)),
                 TOL)


@pytest.mark.parametrize("projection,explicit", [("perspective", True), ("perspective", False),
                                                 ("orthographic", True)])
def test_create_target_volume(rng, projection, explicit):
    poses, Ks = _cameras(rng, 2, projection)
    near = far = None
    if explicit:
        near = np.array([3.1, 3.3], np.float32)
        far = near + 1.7
    to = lambda f, x: None if x is None else f(x)
    xyz_t, d_t = t_geo.create_target_volume(6, 8, 64, tt(poses), tt(Ks), to(tt, near),
                                            to(tt, far), projection)
    xyz_j, d_j = j_geo.create_target_volume(6, 8, 64, jnp.asarray(poses), jnp.asarray(Ks),
                                            to(jnp.asarray, near), to(jnp.asarray, far),
                                            projection)
    assert_close(d_t, d_j, TOL)
    assert_close(xyz_t, xyz_j, 2e-5 * 4)  # |xyz| ~ 4: same relative bar


@pytest.mark.parametrize("H,W", [(8, 8), (80, 70)])
def test_grid_sample_2d(rng, H, W):
    """Both JAX formulations (matmul form H*W <= 4096, gathers above)."""
    feat = rng.normal(size=(2, H, W, 5)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 3, 4, 5, 2)).astype(np.float32)
    out = t_gs.grid_sample_2d(cf(feat), tt(grid))
    ref = j_gs.grid_sample_2d(jnp.asarray(feat), jnp.asarray(grid))
    assert_close(cl(out), ref, TOL)


@pytest.mark.parametrize("P", [40, 900])
def test_grid_sample_3d(rng, P):
    """P >= D*H*W takes the JAX overlapped-table path, P < D*H*W the gather."""
    feat = rng.normal(size=(2, 6, 7, 8, 3)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, P, 3)).astype(np.float32)
    out = t_gs.grid_sample_3d(cf(feat), tt(grid))
    ref = j_gs.grid_sample_3d(jnp.asarray(feat), jnp.asarray(grid))
    assert_close(cl(out), ref, TOL)


def test_grid_sample_out_of_range_is_zero(rng):
    """A point more than one cell outside the volume reads exact zeros (the
    cells are 2/3 wide here: size 4 over [-1, 1])."""
    feat = rng.normal(size=(1, 4, 4, 4, 2)).astype(np.float32)
    far = np.array([[[2.0, 0.0, 0.0], [0.0, -2.5, 0.3], [0.2, 0.1, 1.7]]], np.float32)
    out = t_gs.grid_sample_3d(cf(feat), tt(far))
    assert torch.equal(out, torch.zeros(1, 2, 3))
    assert_close(cl(out), j_gs.grid_sample_3d(jnp.asarray(feat), jnp.asarray(far)), TOL)
    far2 = tt(np.array([[[1.7, 0.0], [0.0, -3.0]]]))
    assert torch.equal(t_gs.grid_sample_2d(cf(feat)[:, :, 0], far2), torch.zeros(1, 2, 2))


@pytest.mark.parametrize("act,eps,shift", [(None, 1e-5, False), ("silu", 1e-6, False),
                                           ("relu", 1e-5, False), ("silu", 1e-5, True)])
def test_group_norm(rng, act, eps, shift):
    x = (rng.normal(size=(2, 5, 6, 32)) * 3 + 1).astype(np.float32)
    g = rng.normal(size=32).astype(np.float32)
    b = rng.normal(size=32).astype(np.float32)
    if shift:
        s = rng.normal(size=(2, 32)).astype(np.float32)
        out = t_gn.group_norm_shifted(cf(x), tt(s), tt(g), tt(b), 8, eps, act)
        ref = j_gn.group_norm_shifted(jnp.asarray(x), jnp.asarray(s), jnp.asarray(g),
                                      jnp.asarray(b), 8, eps, act)
    else:
        out = t_gn.group_norm(cf(x), tt(g), tt(b), 8, eps, act)
        ref = j_gn._reference(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 8, eps, act)
    assert_close(cl(out), ref, TOL)
