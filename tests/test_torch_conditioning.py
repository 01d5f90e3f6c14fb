"""Port parity of the conditioning path against the JAX package on the CPU,
fp32: NoisyTargetViewEncoder, FrustumTV3DNet, MeshVoxelNet and
SpatialVolumeNet (spatial volume and frustum volumes) at tests/tiny.py's
sizes. Tolerance 1e-4: chains of fp32 convs and normalizations, plus grid
sampling whose weights the two packages form in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from morphablediffusion_torch.models import conditioner as Tc
from morphablediffusion_torch.models import mesh_voxel as Tm
from morphablediffusion_torch.models import spatial_volume as Ts
from morphablediffusion_tpu.models import conditioner as Jc
from morphablediffusion_tpu.models import mesh_voxel as Jm
from morphablediffusion_tpu.models import spatial_volume as Js
from tests.tiny import tiny_batch, tiny_config
from tests.torch_parity import assert_close, cf, cl, load_into, seeded_tree, tt

TOL = 1e-4


def _jit_init(mod, *args, method=None):
    """The init's parameter tree (shapes), with seeded values."""
    return seeded_tree(jax.eval_shape(
        lambda *a: mod.init(jax.random.key(0), *a, method=method), *args))


def test_noisy_target_view_encoder(rng):
    x = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
    t = rng.normal(size=(3, 256)).astype(np.float32)
    v = rng.normal(size=(3, 4)).astype(np.float32)
    jmod = Jc.NoisyTargetViewEncoder()
    args = tuple(map(jnp.asarray, (x, t, v)))
    params = _jit_init(jmod, *args)
    port = load_into(Tc.NoisyTargetViewEncoder(256, 4), params)
    with torch.no_grad():
        out = port(cf(x), tt(t), tt(v))
    assert_close(cl(out), jmod.apply(params, *args), TOL)


def test_frustum_tv3d_net(rng):
    dims = (8, 16, 32, 64)
    x = rng.normal(size=(2, 8, 8, 8, 64)).astype(np.float32)
    t = rng.normal(size=(2, 256)).astype(np.float32)
    v = rng.normal(size=(2, 4)).astype(np.float32)
    jmod = Jc.FrustumTV3DNet(dims)
    args = tuple(map(jnp.asarray, (x, t, v)))
    params = _jit_init(jmod, *args)
    ref = jax.jit(jmod.apply)(params, *args)
    port = load_into(Tc.FrustumTV3DNet(64, 256, 4, dims), params)
    with torch.no_grad():
        out = port(cf(x), tt(t), tt(v))
    assert sorted(out) == sorted(ref) == [1, 2, 4, 8]
    for w in ref:
        assert_close(cl(out[w]), ref[w], TOL)


def test_mesh_voxel_net(rng):
    B, Nv = 2, 64
    verts = rng.uniform(-0.2, 0.2, (B, Nv, 3)).astype(np.float32)
    feats = rng.normal(size=(B, Nv, 16)).astype(np.float32)
    mask = (rng.uniform(size=(B, Nv)) > 0.2).astype(np.float32)
    vert_dhw = verts[..., ::-1].copy()
    min_dhw = np.where(mask[..., None] > 0, vert_dhw, 1e9).min(1).astype(np.float32)
    query = rng.uniform(-0.3, 0.3, (B, 5, 6, 3)).astype(np.float32)
    jmod = Jm.MeshVoxelNet(grid_shape=(16, 16, 16))
    args = tuple(map(jnp.asarray, (feats, vert_dhw, min_dhw, mask, query)))
    params = _jit_init(jmod, *args)
    ref = jax.jit(jmod.apply)(params, *args)
    port = load_into(Tm.MeshVoxelNet(16, (16, 16, 16)), params)
    with torch.no_grad():
        out = port(*map(tt, (feats, vert_dhw, min_dhw, mask, query)))
    assert_close(cl(out), ref, TOL)


def test_spatial_volume_net():
    """construct_spatial_volume, then construct_view_frustum_volume on the
    JAX package's volume (each stage on the same inputs).

    The time/view embeddings are drawn at 0.1 scale: at unit scale their
    per-channel offsets dwarf the frustum features (which are zero outside
    the volume), and the one-pass GroupNorm variance E[x^2] - E[x]^2 that
    both packages use then cancels to a few digits, in another order in each,
    which would test the conditioning of the input and not the port. Even at
    0.1 scale, empty frustum space carries conv biases only, so the frustum
    volumes are held at 5e-4 (measured 1.7e-4 at the width-2 level)."""
    cfg = tiny_config(view_num=2)
    m = cfg.model
    batch = tiny_batch(cfg, with_targets=False)
    rng = np.random.default_rng(1)
    N, h = m.view_num, m.latent_size
    x = rng.normal(size=(1, N, h, h, 4)).astype(np.float32)
    t_emb = 0.1 * rng.normal(size=(1, 256)).astype(np.float32)
    v_emb = 0.1 * rng.normal(size=(1, N, 4)).astype(np.float32)
    kw = dict(view_num=N, input_image_size=m.image_size,
              spatial_volume_size=m.spatial_volume_size,
              frustum_volume_depth=m.frustum_volume_depth,
              voxel_grid_shape=m.voxel_grid_shape, volume_dims=m.unet.volume_dims)
    jmod = Js.SpatialVolumeNet(**kw)
    vol_args = (jnp.asarray(x), jnp.asarray(t_emb), jnp.asarray(v_emb), batch["target_K"],
                batch["target_RT"], batch["vertices"], batch["vertex_mask"])

    def both(mod, *a):
        vol = mod.construct_spatial_volume(*a)
        return mod.construct_view_frustum_volume(vol, a[1], a[2], a[4], a[3])

    params = _jit_init(jmod, *vol_args, method=both)
    vol_ref = jax.jit(lambda p, *a: jmod.apply(p, *a, method="construct_spatial_volume"))(
        params, *vol_args)
    fr_ref, depth_ref = jax.jit(lambda p, *a: jmod.apply(
        p, *a, method="construct_view_frustum_volume"))(
        params, vol_ref, vol_args[1], vol_args[2], batch["target_RT"], batch["target_K"])

    kw.pop("view_num")
    port = load_into(Ts.SpatialVolumeNet(**kw), params)
    tb = {k: tt(v) for k, v in batch.items()}
    with torch.no_grad():
        vol = port.construct_spatial_volume(
            tt(x).permute(0, 1, 4, 2, 3), tt(t_emb), tt(v_emb), tb["target_K"],
            tb["target_RT"], tb["vertices"], tb["vertex_mask"])
        fr, depth = port.construct_view_frustum_volume(
            cf(vol_ref), tt(t_emb), tt(v_emb), tb["target_RT"], tb["target_K"])
    assert vol.shape == (1, 64) + (m.spatial_volume_size,) * 3
    assert_close(cl(vol), vol_ref, TOL)
    assert_close(depth, depth_ref, 1e-5)
    for w in fr_ref:
        assert_close(cl(fr[w]), fr_ref[w], 5e-4)
