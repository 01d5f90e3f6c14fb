"""The slice as a whole: the port's SyncDDIMSampler against the JAX package's,
at tests/tiny.py's config on the CPU in fp32.

The JAX noise stream (`split`, then `fold_in(rng, index)` per step,
sampling/ddim.py:75-96) is regenerated and injected into the port, and the
port is held to `denoise_latents(collect_trajectory=True)` after every step,
to the prepared encodings, and to the decoded images. Tolerance 1e-4 (fp32
through two CFG denoising steps of the whole network, with the fused
depth-context fold in the port against the unfused chain in JAX).

Weights: kernels are seeded N(0, 1/fan_in); biases 0 and norm scales 1 as
in the JAX init; the frustum net's time/view projections (t_conv, v_conv)
are zero. With them on, their per-channel offsets dominate the frustum
features in the empty part of the frustum, and the one-pass fp32 GroupNorm
variance of both packages cancels to ~1e-3: the JAX package then disagrees
with itself (jit vs eager) by more than with the port. Those projections are
held to 1e-4 on well-conditioned inputs in test_torch_conditioning.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphablediffusion_torch.models.diffusion import MorphableDiffusion as TModel
from morphablediffusion_torch.ops import depth_attention as t_da
from morphablediffusion_torch.ops import flash_attention as t_fa
from morphablediffusion_torch.sampling import SyncDDIMSampler as TSampler
from morphablediffusion_tpu.models.diffusion import MorphableDiffusion as JModel
from morphablediffusion_tpu.sampling import SyncDDIMSampler as JSampler
from tests.tiny import tiny_batch, tiny_config
from tests.torch_parity import (assert_close, load_into, port_model_config, seeded_tree, tt,
                                well_conditioned)

TOL = 1e-4


def _init_inference(m, batch):
    """Touches every module the serving path uses."""
    prep = m.prepare_inference(batch)
    B = batch["input_image"].shape[0]
    N, h = m.cfg.view_num, m.cfg.latent_size
    x = jnp.zeros((B, N, h, h, 4))
    t = jnp.zeros((B,), jnp.int32)
    eps = m.predict_eps_cfg(x, t, prep["clip_embed"], prep["x_input"], prep["v_embed"],
                            batch, 2.0)
    return m.decode_views(eps)


@pytest.fixture(scope="module")
def slice_run():
    cfg = tiny_config(view_num=2)
    jmodel = JModel(cfg.model)
    batch = tiny_batch(cfg, with_targets=False)
    params = well_conditioned(seeded_tree(jax.eval_shape(
        lambda b: jmodel.init(jax.random.key(0), b, method=_init_inference), batch)))
    jsampler = JSampler(jmodel, sample_steps=cfg.model.sample_steps)
    rng = jax.random.key(7)
    prep = jax.jit(lambda p, b: jmodel.apply(p, b, method="prepare_inference"))(params, batch)
    latents, traj = jax.jit(lambda p, b, pr, r: jsampler.denoise_latents(
        p, b, pr, r, 2.0, collect_trajectory=True))(params, batch, prep, rng)
    images = jax.jit(lambda p, z: jmodel.apply(p, z, method="decode_views"))(params, latents)

    # the JAX sampler's noise stream, regenerated for injection
    m = cfg.model
    shape = (1, m.view_num, m.latent_size, m.latent_size, 4)
    step_rng, init_rng = jax.random.split(rng)
    x_init = jax.random.normal(init_rng, shape, jnp.float32)
    noises = [jax.random.normal(jax.random.fold_in(step_rng, i), shape, jnp.float32)
              for i in range(m.sample_steps)]

    t_da.KERNEL.launches = t_fa.KERNEL.launches = 0
    port = load_into(TModel(port_model_config(m), device="cpu"), params)
    tb = {k: tt(v) for k, v in batch.items()}
    tsampler = TSampler(port, sample_steps=m.sample_steps)
    t_prep = port.prepare_inference(tb)
    t_lat, t_traj = tsampler.denoise_latents(tb, t_prep, 2.0, x_init=tt(x_init),
                                             noises=[tt(n) for n in noises],
                                             collect_trajectory=True)
    t_images, t_lat2 = tsampler.sample(tb, 2.0, x_init=tt(x_init),
                                       noises=[tt(n) for n in noises])
    return dict(prep=prep, traj=traj, latents=latents, images=images, t_prep=t_prep,
                t_traj=t_traj, t_lat=t_lat, t_images=t_images, t_lat2=t_lat2,
                launches=(t_da.KERNEL.launches, t_fa.KERNEL.launches))


def test_prepared_encodings(slice_run):
    r = slice_run
    for k in ("x_input", "clip_embed", "v_embed"):
        assert_close(r["t_prep"][k], r["prep"][k], TOL)


def test_trajectory_every_step(slice_run):
    r = slice_run
    assert len(r["t_traj"]) == r["traj"].shape[0] == 2
    for step, (t_x, j_x) in enumerate(zip(r["t_traj"], r["traj"])):
        assert_close(t_x, j_x, TOL)
    assert_close(r["t_lat"], r["latents"], TOL)


def test_decoded_images(slice_run):
    r = slice_run
    assert r["t_images"].shape == (1, 2, 64, 64, 3)
    assert torch.isfinite(r["t_images"]).all()
    assert_close(r["t_images"], r["images"], TOL)
    assert torch.equal(r["t_lat2"], r["t_lat"])  # sample() == denoise + decode


def test_cpu_run_launches_no_kernel(slice_run):
    assert slice_run["launches"] == (0, 0)
