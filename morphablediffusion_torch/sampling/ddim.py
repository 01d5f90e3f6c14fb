"""Synchronized multi-view DDIM sampler.

Counterpart of the JAX package's `sampling/ddim.py::SyncDDIMSampler`:
uniform 50-step discretization with eta = 1.0; each step rebuilds the spatial
volume from the current noisy latents of ALL views, then denoises every view
jointly with classifier-free guidance. The steps are a Python loop.

With a `parallel.Mesh` (the JAX sampler's `view_sharding`) each rank runs
its contiguous views (`view_range`): the initial latent and every
eta-noise are drawn at the full (B, N, ...) shape from the one generator on
every rank and then sliced, so the stream is the one-process stream; the
loop, the frustum and UNet work and the VAE decode run on the rank's views,
the spatial volume couples them across the ranks, and the final latents and
images are gathered in view order. A world of one rank runs the one-process
code.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from morphablediffusion_torch.models.diffusion import MorphableDiffusion
from morphablediffusion_torch.ops import schedules
from morphablediffusion_torch.parallel.collectives import all_gather_cat
from morphablediffusion_torch.parallel.mesh import view_range
from morphablediffusion_torch.utils.spans import span


class SyncDDIMSampler:
    """Sampler bound to a model.

        sampler = SyncDDIMSampler(model, sample_steps=50, eta=1.0)
        images, latents = sampler.sample(batch, cfg_scale=2.0, generator=g)
    """

    def __init__(self, model: MorphableDiffusion, sample_steps: int = 50,
                 eta: float = 1.0, batch_view_num: int = 0, mesh=None):
        """batch_view_num: views per UNet and VAE-decoder call (0: all, of
        this rank's views); see MorphableDiffusion.predict_eps_cfg. mesh: a
        `parallel.Mesh` whose ranks share the views (None: one process)."""
        self.model = model
        self.batch_view_num = batch_view_num
        self.mesh = mesh
        sched = schedules.make_diffusion_schedule(device=model.device)
        self.ddim = schedules.make_ddim_schedule(sched, sample_steps, eta)
        self.timesteps = schedules.make_ddim_timesteps(sample_steps, sched.num_timesteps)

    @torch.inference_mode()
    def denoise_latents(self, batch, prep, cfg_scale: float, generator=None,
                        x_init=None, noises: Optional[Sequence] = None,
                        collect_trajectory: bool = False):
        """Run the reverse process. Returns the final latents (B, N, h, w, 4),
        and with collect_trajectory=True also the list of post-update latents
        of every step.

        x_init: the initial latent, else drawn from `generator`.
        noises: noises[s] is the eta-noise added at DDIM index s (s = S-1 ...
        1; entry 0 is not used), else drawn from `generator`.
        """
        cfg = self.model.cfg
        dev = self.model.device
        B = batch["input_image"].shape[0]
        shape = (B, cfg.view_num, cfg.latent_size, cfg.latent_size, 4)
        lo, hi = view_range(self.mesh, cfg.view_num)
        x = (torch.randn(shape, generator=generator, device=dev)
             if x_init is None else x_init.to(dev, torch.float32))[:, lo:hi]
        traj = []
        for index in range(self.ddim.num_steps - 1, -1, -1):
            t = torch.full((B,), int(self.timesteps[index]), dtype=torch.int64, device=dev)
            eps = self.model.predict_eps_cfg(x, t, prep["clip_embed"], prep["x_input"],
                                             prep["v_embed"], batch, cfg_scale,
                                             self.batch_view_num, mesh=self.mesh)
            with span("md.ddim"):
                noise = None
                if index != 0:
                    noise = (torch.randn(shape, generator=generator, device=dev)
                             if noises is None
                             else noises[index].to(dev, torch.float32))[:, lo:hi]
                x = schedules.ddim_step(x, eps, index, self.ddim, noise)
            if collect_trajectory:
                traj.append(all_gather_cat(x, 1, self.mesh))
        x = all_gather_cat(x, 1, self.mesh)
        return (x, traj) if collect_trajectory else x

    @torch.inference_mode()
    def sample(self, batch, cfg_scale: float = 2.0, generator=None, x_init=None,
               noises=None):
        """prepare -> denoise -> VAE decode. Returns (images (B, N, H, W, 3) in
        [-1, 1], latents (B, N, h, w, 4))."""
        with span("md.sample"):
            prep = self.model.prepare_inference(batch)
            latents = self.denoise_latents(batch, prep, cfg_scale, generator, x_init, noises)
            lo, hi = view_range(self.mesh, latents.shape[1])
            images = self.model.decode_views(latents[:, lo:hi], self.batch_view_num)
            return all_gather_cat(images, 1, self.mesh), latents
