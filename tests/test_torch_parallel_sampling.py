"""View-parallel sampling on the port (`SyncDDIMSampler(mesh=...)`, the
counterpart of the JAX sampler's `view_sharding`), with W ranks spawned as
processes on the CPU under gloo (tests/torch_ranks.py), at tests/tiny.py's
config with 4 views, fp32.

Cases: W=2 and W=4; `use_spatial_volume` (the unprojected views gathered
across the ranks); `batch_view_num=1` (view chunks within a rank); B=2.
Each is held to

  * the port in one process on the same weights and the same injected
    noise: latents, every step of the trajectory and the decoded images
    within relative 1e-5 (the view mean is a sum over ranks then a division,
    not `mean(1)`);
  * the JAX sampler with `view_sharding` over `create_view_mesh` of W of
    conftest's 8 CPU devices, its noise stream regenerated and injected as
    `tests/torch_parity.py::sampler_run` does: `assert_slice_matches`'
    1e-4 (the sharded JAX graph compiles in seconds at this size, so the
    comparison is against it and not against the one-device graph; the
    batch_view_num case against the unchunked JAX graph, whose numbers
    chunking does not change);
  * every rank's spatial volume, at every step, bitwise equal to every
    other rank's (else the ranks' views would drift apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphablediffusion_torch.models.diffusion import MorphableDiffusion as TModel
from morphablediffusion_torch.sampling import SyncDDIMSampler as TSampler
from morphablediffusion_tpu.models.diffusion import MorphableDiffusion as JModel
from morphablediffusion_tpu.parallel.mesh import create_view_mesh, view_sharding
from morphablediffusion_tpu.sampling import SyncDDIMSampler as JSampler
from tests.tiny import tiny_batch, tiny_config
from tests.torch_parity import (_init_inference, assert_close, load_into, port_model_config,
                                seeded_tree, tt, well_conditioned)
from tests.torch_ranks import run_ranks, sampling_rank

TOL_WORLD_ONE, TOL_JAX = 1e-5, 1e-4
# name: (world, use_spatial_volume, batch_view_num, B)
CASES = {"w2": (2, False, 0, 1), "w4": (4, False, 0, 1), "spatial_volume": (2, True, 0, 1),
         "view_chunks": (2, False, 1, 1), "b2": (2, False, 0, 2)}


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _config(spatial: bool):
    cfg = tiny_config(view_num=4)
    cfg.model.use_spatial_volume = spatial
    return cfg


_jax_cache = {}


def _jax_sharded(world: int, spatial: bool, B: int):
    """The JAX side at (world, spatial, B): weights, batch, the injected
    noise, and the view-sharded sampler's prepared encodings, trajectory,
    latents and images (one compile per key)."""
    key = (world, spatial, B)
    if key in _jax_cache:
        return _jax_cache[key]
    cfg = _config(spatial)
    jmodel = JModel(cfg.model)
    batch = tiny_batch(cfg, B=B, with_targets=False)
    params = well_conditioned(seeded_tree(jax.eval_shape(
        lambda b: jmodel.init(jax.random.key(0), b, method=_init_inference), batch)))
    sh = view_sharding(create_view_mesh(jax.devices()[:world]))
    jsampler = JSampler(jmodel, sample_steps=cfg.model.sample_steps)
    rng = jax.random.key(7)
    prep = jax.jit(lambda p, b: jmodel.apply(p, b, method="prepare_inference"))(params, batch)
    latents, traj = jax.jit(lambda p, b, pr, r: jsampler.denoise_latents(
        p, b, pr, r, 2.0, view_sharding=sh, collect_trajectory=True))(params, batch, prep, rng)
    images = jax.jit(lambda p, z: jmodel.apply(p, z, method="decode_views"))(params, latents)
    m = cfg.model
    shape = (B, m.view_num, m.latent_size, m.latent_size, 4)
    step_rng, init_rng = jax.random.split(rng)
    x_init = jax.random.normal(init_rng, shape, jnp.float32)
    noises = [jax.random.normal(jax.random.fold_in(step_rng, i), shape, jnp.float32)
              for i in range(m.sample_steps)]
    _jax_cache[key] = out = dict(cfg=cfg, batch=batch, params=params, prep=prep, traj=traj,
                                 latents=latents, images=images, x_init=tt(x_init),
                                 noises=[tt(n) for n in noises])
    return out


@pytest.fixture(scope="module", params=list(CASES))
def case(request, tmp_path_factory):
    world, spatial, bvn, B = CASES[request.param]
    j = _jax_sharded(world, spatial, B)
    m = j["cfg"].model
    port = load_into(TModel(port_model_config(m), device="cpu"), j["params"])
    tb = {k: tt(v) for k, v in j["batch"].items()}
    # the port in one process
    sampler = TSampler(port, sample_steps=m.sample_steps, batch_view_num=bvn)
    kw = dict(x_init=j["x_init"], noises=j["noises"])
    prep = port.prepare_inference(tb)
    one_lat, one_traj = sampler.denoise_latents(tb, prep, 2.0, collect_trajectory=True, **kw)
    one_images, _ = sampler.sample(tb, 2.0, **kw)
    # the port on `world` ranks
    tmp = tmp_path_factory.mktemp(request.param)
    payload = tmp / "payload.pt"
    torch.save(dict(cfg=port_model_config(m), state=port.state_dict(), batch=tb,
                    steps=m.sample_steps, bvn=bvn, **kw), payload)
    run_ranks(sampling_rank, world, tmp, str(payload), str(tmp))
    ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(world)]
    return dict(j, world=world, ranks=ranks, one_lat=one_lat, one_traj=one_traj,
                one_images=one_images, t_prep=prep)


def test_ranks_match_the_port_in_one_process(case):
    for r in case["ranks"]:
        assert len(r["traj"]) == len(case["one_traj"]) == 2
        for got, want in zip(r["traj"], case["one_traj"]):
            assert rel_l2(got, want) <= TOL_WORLD_ONE
        assert rel_l2(r["latents"], case["one_lat"]) <= TOL_WORLD_ONE
        assert r["images"].shape == case["one_images"].shape
        assert rel_l2(r["images"], case["one_images"]) <= TOL_WORLD_ONE
        assert torch.equal(r["latents2"], r["latents"])  # sample() == denoise + decode


def test_ranks_match_the_view_sharded_jax_sampler(case):
    for k in ("x_input", "clip_embed", "v_embed"):
        assert_close(case["t_prep"][k], case["prep"][k], TOL_JAX)
    for r in case["ranks"]:
        assert len(r["traj"]) == case["traj"].shape[0]
        for got, want in zip(r["traj"], case["traj"]):
            assert_close(got, want, TOL_JAX)
        assert_close(r["latents"], case["latents"], TOL_JAX)
        assert_close(r["images"], case["images"], TOL_JAX)


def test_every_rank_builds_the_same_volume_bitwise(case):
    first = case["ranks"][0]["volumes"]
    # denoise (2 steps) then sample (2 more)
    assert len(first) == 4
    for r in case["ranks"][1:]:
        assert len(r["volumes"]) == len(first)
        for a, b in zip(r["volumes"], first):
            assert torch.equal(a, b)
