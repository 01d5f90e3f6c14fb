"""Synchronized multi-view DDIM sampler.

Counterpart of the JAX package's `sampling/ddim.py::SyncDDIMSampler`:
uniform 50-step discretization with eta = 1.0; each step rebuilds the spatial
volume from the current noisy latents of ALL views, then denoises every view
jointly with classifier-free guidance. The steps are a Python loop.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from morphablediffusion_torch.models.diffusion import MorphableDiffusion
from morphablediffusion_torch.ops import schedules


class SyncDDIMSampler:
    """Sampler bound to a model.

        sampler = SyncDDIMSampler(model, sample_steps=50, eta=1.0)
        images, latents = sampler.sample(batch, cfg_scale=2.0, generator=g)
    """

    def __init__(self, model: MorphableDiffusion, sample_steps: int = 50,
                 eta: float = 1.0, batch_view_num: int = 0):
        """batch_view_num: views per UNet and VAE-decoder call (0: all);
        see MorphableDiffusion.predict_eps_cfg."""
        self.model = model
        self.batch_view_num = batch_view_num
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
        x = (torch.randn(shape, generator=generator, device=dev)
             if x_init is None else x_init.to(dev, torch.float32))
        traj = []
        for index in range(self.ddim.num_steps - 1, -1, -1):
            t = torch.full((B,), int(self.timesteps[index]), dtype=torch.int64, device=dev)
            eps = self.model.predict_eps_cfg(x, t, prep["clip_embed"], prep["x_input"],
                                             prep["v_embed"], batch, cfg_scale,
                                             self.batch_view_num)
            noise = None
            if index != 0:
                noise = (torch.randn(shape, generator=generator, device=dev)
                         if noises is None else noises[index].to(dev, torch.float32))
            x = schedules.ddim_step(x, eps, index, self.ddim, noise)
            if collect_trajectory:
                traj.append(x)
        return (x, traj) if collect_trajectory else x

    @torch.inference_mode()
    def sample(self, batch, cfg_scale: float = 2.0, generator=None, x_init=None,
               noises=None):
        """prepare -> denoise -> VAE decode. Returns (images (B, N, H, W, 3) in
        [-1, 1], latents (B, N, h, w, 4))."""
        prep = self.model.prepare_inference(batch)
        latents = self.denoise_latents(batch, prep, cfg_scale, generator, x_init, noises)
        return self.model.decode_views(latents, self.batch_view_num), latents
