"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

The JAX package is the reference. A parameter tree comes from the JAX
module's own `init` (its names and shapes); its values are then redrawn from
numpy with a seed, so that zero-initialized output convs do not hide a branch
from the comparison. The tree is carried to the port with
`weights.from_jax_params` and loaded with strict=True. Inputs are numpy
arrays handed to both sides; the port runs on the CPU in fp32.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from morphablediffusion_torch.utils import config as port_config
from morphablediffusion_torch.weights import flatten_tree, from_jax_params

torch.set_num_threads(2)


def port_model_config(jax_model_cfg) -> port_config.ModelConfig:
    """The JAX package's ModelConfig -> the port's own copy of it."""
    d = dataclasses.asdict(jax_model_cfg)
    unet = port_config.UNetConfig(**d.pop("unet"))
    clip = port_config.CLIPConfig(**d.pop("clip"))
    return port_config.ModelConfig(**d, unet=unet, clip=clip)


def seeded_tree(tree, seed: int = 0):
    """Same structure as `tree` (a flax variable tree or its eval_shape),
    numpy float32 values: norm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2),
    kernels N(0, 1/fan_in), other 1-D leaves N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        shape = tuple(s.shape)
        if name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "bias":
            v = 0.1 * rng.standard_normal(shape)
        elif len(shape) >= 2:
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            v = 0.02 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def well_conditioned(params):
    """Biases 0, norm scales 1 (as the JAX init) and the frustum net's
    time/view projections (t_conv, v_conv) 0. With those projections on,
    their per-channel offsets dominate the frustum features in the empty part
    of the frustum and the one-pass fp32 GroupNorm variance of both packages
    cancels to ~1e-3; they are held to 1e-4 on well-conditioned inputs in
    test_torch_conditioning.py."""
    def leaf(path, v):
        names = [str(k.key) for k in path]
        if names[-1] == "bias":
            return np.zeros_like(v)
        if names[-1] == "scale":
            return np.ones_like(v)
        if "frustum_volume_feats" in names and ("t_conv" in names or "v_conv" in names):
            return np.zeros_like(v)
        return v
    return jax.tree_util.tree_map_with_path(leaf, params)


def load_into(module: torch.nn.Module, params) -> torch.nn.Module:
    """Load a flax {'params': ...} tree into a port module (strict)."""
    module.load_state_dict(from_jax_params(flatten_tree(params["params"]), device="cpu"), strict=True)
    return module.eval()


def tt(x) -> torch.Tensor:
    """numpy / jax array -> float32 CPU tensor."""
    return torch.from_numpy(np.array(x, dtype=np.float32))


def to_np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def cl(x: torch.Tensor) -> torch.Tensor:
    """channels-first (B, C, ...) -> channels-last (B, ..., C)."""
    return x.movedim(1, -1)


def cf(x) -> torch.Tensor:
    """channels-last (B, ..., C) array -> channels-first tensor."""
    return tt(x).movedim(-1, 1).contiguous()


def assert_close(actual, expected, tol: float):
    np.testing.assert_allclose(to_np(actual), to_np(expected), rtol=tol, atol=tol)


# training (tests/test_torch_train*.py) ------------------------------------

STEP_NAMES = ["time", "noise", "view", "vae", "drop"]


def jax_training_draws(m, batch):
    """Method for the JAX MorphableDiffusion: the random draws of its
    training_loss, in its make_rng order (vae, vae, time, noise, view,
    drop), in the port's TrainingDraws layout."""
    N, h = m.cfg.view_num, m.cfg.latent_size
    n = batch["target_image"].shape[0]
    vae_target = jax.random.normal(m.make_rng("vae"), (n * N, h, h, 4), jnp.float32)
    vae_input = jax.random.normal(m.make_rng("vae"), (n, h, h, 4), jnp.float32)
    return {
        "vae_target": vae_target, "vae_input": vae_input,
        "t": jax.random.randint(m.make_rng("time"), (n,), 0, 1000),
        "noise": jax.random.normal(m.make_rng("noise"), (n, N, h, h, 4), jnp.float32),
        "target_index": jax.random.randint(m.make_rng("view"), (n, 1), 0, N),
        "r": jax.random.uniform(m.make_rng("drop"), (n,)),
    }


def step_rngs(rng, step: int):
    """The JAX Trainer's rngs of micro-step `step` (trainer.py:234-236)."""
    return dict(zip(STEP_NAMES, jax.random.split(jax.random.fold_in(rng, step), 5)))


def port_train_config(jcfg) -> port_config.Config:
    """The JAX package's Config -> the port's (model and train sections)."""
    return port_config.Config(model=port_model_config(jcfg.model),
                              train=port_config.TrainConfig(**dataclasses.asdict(jcfg.train)))


def torch_draws(jmodel, params, batch, rngs):
    d = jmodel.apply(params, batch, method=jax_training_draws, rngs=rngs)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def train_config():
    """tests/tiny.py's config, twice as wide in the UNet and the frustum net,
    so that every GroupNorm group holds at least two channels. With one
    channel per group (tiny.py's 32 UNet channels under GroupNorm(32), its
    8 frustum channels under GroupNorm(8)) the norm removes any per-channel
    constant, and the gradients of the biases and time shifts ahead of it
    are zero up to rounding, which no relative bound can hold."""
    from tests.tiny import tiny_config

    jcfg = tiny_config(view_num=2)
    jcfg.model.unet.model_channels = 64
    jcfg.model.unet.volume_dims = (16, 32, 64, 128)
    return jcfg


def train_setup(B: int = 2, jcfg=None, adjust=None, mesh_voxel: bool = False):
    """jcfg's model (default train_config's) and a B-sample batch;
    well-conditioned seeded parameters (then `adjust(params)` if given) with
    VAE and CLIP stored in bf16 (the JAX Trainer's cast_frozen); and a root
    key whose step-0 drop uniforms drop a condition of sample 0 and none of
    sample 1, and whose step 0 keeps the UNet's ReLU inputs clear of 0
    (`relu_margin`), and with mesh_voxel those of the mesh-voxel net too."""
    from morphablediffusion_tpu.models.diffusion import MorphableDiffusion
    from morphablediffusion_tpu.parallel.mesh import create_mesh
    from morphablediffusion_tpu.training.trainer import Trainer
    from tests.tiny import tiny_batch

    jcfg = jcfg or train_config()
    jmodel = MorphableDiffusion(jcfg.model)
    batch = tiny_batch(jcfg, B=B)
    init_rngs = dict(zip(["params"] + STEP_NAMES, jax.random.split(jax.random.key(0), 6)))
    params = well_conditioned(seeded_tree(jax.eval_shape(
        lambda b: jmodel.init(init_rngs, b, method="init_fn"), batch)))
    if adjust is not None:
        params = adjust(params)
    params = Trainer(jcfg, mesh=create_mesh(jax.devices()[:1])).cast_frozen(
        jax.tree.map(jnp.asarray, params))
    s = dict(jcfg=jcfg, jmodel=jmodel, batch=batch, params=params,
             tb={k: tt(v) for k, v in batch.items()})
    port, _ = port_train_model(s)
    for k in range(200):
        rng = jax.random.key(k)
        draws = torch_draws(jmodel, params, batch, step_rngs(rng, 0))
        r = draws["r"].numpy()
        if (r[0] <= 0.2 < r[1] and relu_margin(port, s["tb"], draws) > 3e-6
                and (not mesh_voxel or relu_margin(port, s["tb"], draws, True) > 1e-6)):
            return dict(s, rng=rng)
    raise AssertionError("no step key meets the conditions")


def relu_margin(model, batch, draws, mesh_voxel: bool = False) -> float:
    """The smallest non-zero |input| of the UNet's GroupNorm ReLUs (the
    DepthTransformers' context and output norms, and the fused chain's) in
    the port's training loss, and with mesh_voxel also of the mesh-voxel
    net's (`torch.relu`, coarse and fine). A ReLU's derivative jumps at 0:
    an input within rounding (~1e-6 here) of 0 may take the other branch in
    the JAX package, which moves the gradient of every weight that sums over
    that location by ~1e-2 of its size (~1e-4 in the mesh-voxel net, whose
    sums run over a whole voxel grid). train_setup picks a step key whose
    inputs keep clear of it."""
    import torch.nn.functional as F

    from morphablediffusion_torch.ops import depth_attention as da
    from morphablediffusion_torch.ops import group_norm

    seen = []

    def note(y):
        mag = y.detach().abs()
        mag = mag[mag > 0]
        if mag.numel():
            seen.append(float(mag.min()))

    def gn_relu(x):
        note(x)
        return F.relu(x)

    def ctx_full(q, ctx, mean_x, m2, Wp, gn_scale, gn_bias, Wk, Wv, heads, groups, eps):
        A, B2 = da._ctx_affine(mean_x, m2, Wp, gn_scale, gn_bias, groups, eps)
        p = torch.einsum("oc,bcdhw->bodhw", Wp.to(ctx.dtype), ctx)
        note(p.float() * A[:, :, None, None, None] + B2[:, :, None, None, None])
        return full(q, ctx, mean_x, m2, Wp, gn_scale, gn_bias, Wk, Wv, heads, groups, eps)

    def mv_relu(x):
        note(x)
        return relu(x)

    full, saved, relu = da._ctx_full, group_norm._ACTS["relu"], torch.relu
    da._ctx_full, group_norm._ACTS["relu"] = ctx_full, gn_relu
    if mesh_voxel:  # the mesh-voxel nets call torch.relu
        torch.relu = mv_relu
    try:
        with torch.no_grad():
            model.training_loss(batch, draws=draws)
    finally:
        da._ctx_full, group_norm._ACTS["relu"] = full, saved
        torch.relu = relu
    return min(seen)


def port_train_model(s, jcfg=None):
    """The port's model on train_setup's parameters (VAE and CLIP in bf16,
    as the port's Trainer stores them) and the port's Config."""
    from morphablediffusion_torch.models.diffusion import MorphableDiffusion
    from morphablediffusion_torch.training.trainer import cast_frozen

    pcfg = port_train_config(jcfg or s["jcfg"])
    model = load_into(MorphableDiffusion(pcfg.model, device="cpu"), s["params"])
    cast_frozen(model)
    return model, pcfg


# the slice as a whole (tests/test_torch_sampler.py and the configuration
# tests) ------------------------------------------------------------------


def _init_inference(m, batch):
    """Method for the JAX MorphableDiffusion that touches every module the
    serving path uses."""
    prep = m.prepare_inference(batch)
    B = batch["input_image"].shape[0]
    N, h = m.cfg.view_num, m.cfg.latent_size
    x = jnp.zeros((B, N, h, h, 4))
    t = jnp.zeros((B,), jnp.int32)
    eps = m.predict_eps_cfg(x, t, prep["clip_embed"], prep["x_input"], prep["v_embed"],
                            batch, 2.0)
    return m.decode_views(eps)


def sampler_run(cfg, adjust=None):
    """The JAX SyncDDIMSampler and the port's on cfg (a JAX Config) and
    tests/tiny.py's batch, from the same well-conditioned seeded weights
    (then `adjust(params)` if given) and the same noise stream.

    The JAX noise stream (`split`, then `fold_in(rng, index)` per step,
    sampling/ddim.py:75-96) is regenerated and injected into the port.
    Returns both sides' prepared encodings, trajectories, final latents and
    decoded images, and the kernel launches the port's CPU run made."""
    from morphablediffusion_torch.models.diffusion import MorphableDiffusion as TModel
    from morphablediffusion_torch.ops import depth_attention as t_da
    from morphablediffusion_torch.ops import flash_attention as t_fa
    from morphablediffusion_torch.ops import group_norm as t_gn
    from morphablediffusion_torch.sampling import SyncDDIMSampler as TSampler
    from morphablediffusion_tpu.models.diffusion import MorphableDiffusion as JModel
    from morphablediffusion_tpu.sampling import SyncDDIMSampler as JSampler
    from tests.tiny import tiny_batch

    jmodel = JModel(cfg.model)
    batch = tiny_batch(cfg, with_targets=False)
    params = well_conditioned(seeded_tree(jax.eval_shape(
        lambda b: jmodel.init(jax.random.key(0), b, method=_init_inference), batch)))
    if adjust is not None:
        params = adjust(params)
    jsampler = JSampler(jmodel, sample_steps=cfg.model.sample_steps)
    rng = jax.random.key(7)
    prep = jax.jit(lambda p, b: jmodel.apply(p, b, method="prepare_inference"))(params, batch)
    latents, traj = jax.jit(lambda p, b, pr, r: jsampler.denoise_latents(
        p, b, pr, r, 2.0, collect_trajectory=True))(params, batch, prep, rng)
    images = jax.jit(lambda p, z: jmodel.apply(p, z, method="decode_views"))(params, latents)

    m = cfg.model
    shape = (1, m.view_num, m.latent_size, m.latent_size, 4)
    step_rng, init_rng = jax.random.split(rng)
    x_init = jax.random.normal(init_rng, shape, jnp.float32)
    noises = [jax.random.normal(jax.random.fold_in(step_rng, i), shape, jnp.float32)
              for i in range(m.sample_steps)]

    kernels = (t_da.KERNEL, t_da.DEPTH_KERNEL, t_fa.KERNEL, *t_gn.KERNELS)
    for k in kernels:
        k.launches = 0
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
                launches=tuple(k.launches for k in kernels))


def assert_slice_matches(r, tol: float = 1e-4):
    """sampler_run's two sides agree: the prepared encodings, every step of
    the trajectory, the decoded images (sample() is denoise + decode), and
    the port's CPU run launched no kernel."""
    for k in ("x_input", "clip_embed", "v_embed"):
        assert_close(r["t_prep"][k], r["prep"][k], tol)
    assert len(r["t_traj"]) == r["traj"].shape[0]
    for t_x, j_x in zip(r["t_traj"], r["traj"]):
        assert_close(t_x, j_x, tol)
    assert_close(r["t_images"], r["images"], tol)
    assert torch.equal(r["t_lat2"], r["t_lat"])
    assert r["launches"] == (0,) * len(r["launches"])


REPO = Path(__file__).resolve().parents[1]


def jax_tool(name: str):
    """The repository's JAX tool tools/<name>.py as a module (`tools/` is no
    package), for the port's tool tests."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
