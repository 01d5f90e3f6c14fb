"""Diffusion noise schedules and DDIM tables.

Counterpart of the JAX package's `ops/schedules.py`: a "scaled-linear" beta
schedule (linear_start=8.5e-4, linear_end=1.2e-2, T=1000) and a uniform DDIM
discretization with the reference's +1 offset. Tables are computed in float64
numpy and stored as float32 tensors on the requested device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """DDPM forward-process tables, all shape (T,) float32."""

    num_timesteps: int
    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Per-DDIM-step tables, all shape (S,) float32 (S = #ddim steps).

    Index s corresponds to DDPM timestep ``timesteps[s]``; sampling walks
    s = S-1 ... 0.
    """

    num_steps: int
    timesteps: torch.Tensor  # int64, DDPM t for each DDIM index
    alphas: torch.Tensor
    alphas_prev: torch.Tensor
    sqrt_one_minus_alphas: torch.Tensor
    sigmas: torch.Tensor
    eta: float


def make_diffusion_schedule(num_timesteps: int = 1000,
                            linear_start: float = 0.00085,
                            linear_end: float = 0.0120,
                            device=None) -> DiffusionSchedule:
    """Scaled-linear beta schedule (Stable Diffusion convention)."""
    betas = np.linspace(linear_start**0.5, linear_end**0.5, num_timesteps,
                        dtype=np.float64) ** 2
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    log_var = np.clip(np.log(np.clip(posterior_variance, 1e-20, None)), -10, None)

    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return DiffusionSchedule(
        num_timesteps=num_timesteps,
        betas=f32(betas),
        alphas=f32(alphas),
        alphas_cumprod=f32(alphas_cumprod),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(log_var),
    )


def make_ddim_timesteps(num_ddim_steps: int, num_ddpm_steps: int = 1000) -> np.ndarray:
    """Uniform DDIM discretization with the +1 offset, exactly num_ddim_steps
    entries (50 steps of 1000: [1, 21, ..., 981])."""
    c = num_ddpm_steps // num_ddim_steps
    return np.arange(num_ddim_steps) * c + 1


def make_ddim_schedule(schedule: DiffusionSchedule, num_steps: int = 50,
                       eta: float = 1.0) -> DDIMSchedule:
    timesteps = make_ddim_timesteps(num_steps, schedule.num_timesteps)
    acp = schedule.alphas_cumprod.cpu().numpy().astype(np.float64)
    alphas = acp[timesteps]
    alphas_prev = np.concatenate([acp[0:1], acp[timesteps[:-1]]])
    sigmas = eta * np.sqrt(
        (1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    device = schedule.alphas_cumprod.device
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return DDIMSchedule(
        num_steps=len(timesteps),
        timesteps=torch.as_tensor(timesteps, dtype=torch.int64, device=device),
        alphas=f32(alphas),
        alphas_prev=f32(alphas_prev),
        sqrt_one_minus_alphas=f32(np.sqrt(1.0 - alphas)),
        sigmas=f32(sigmas),
        eta=eta,
    )


def add_noise(x_start, noise, t, schedule: DiffusionSchedule):
    """q(x_t | x_0). x_start, noise: (B, ...); t: (B,) int."""
    bshape = (x_start.shape[0],) + (1,) * (x_start.ndim - 1)
    sac = schedule.sqrt_alphas_cumprod[t].reshape(bshape)
    somac = schedule.sqrt_one_minus_alphas_cumprod[t].reshape(bshape)
    return sac * x_start + somac * noise


def ddim_step(x_t, noise_pred, index: int, ddim: DDIMSchedule, sigma_noise=None):
    """One synchronized DDIM update.

    x_t, noise_pred: same shape; index: the DDIM index (Python int).
    sigma_noise: pre-drawn standard normal of x_t's shape, or None for the
    final (index == 0) step.
    """
    a_t = ddim.alphas[index]
    a_prev = ddim.alphas_prev[index]
    sqrt_one_minus_at = ddim.sqrt_one_minus_alphas[index]
    sigma_t = ddim.sigmas[index]

    pred_x0 = (x_t - sqrt_one_minus_at * noise_pred) / torch.sqrt(a_t)
    dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma_t**2, min=1e-7)) * noise_pred
    x_prev = torch.sqrt(a_prev) * pred_x0 + dir_xt
    if sigma_noise is not None:
        x_prev = x_prev + sigma_t * sigma_noise
    return x_prev
