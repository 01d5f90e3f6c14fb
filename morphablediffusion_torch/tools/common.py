"""Shared pieces of the port's measurement tools: the card's name, the
flagship-shaped synthetic batch and the tiny test configuration."""

from __future__ import annotations

import subprocess

import numpy as np
import torch


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def device_line(device) -> str:
    """What a tool prints beside its numbers: the card line, or 'cpu'."""
    return card_line() if torch.device(device).type == "cuda" else "cpu"


def flagship_batch(cfg, device, seed: int = 0, B: int = 1, with_targets: bool = False):
    """Synthetic flagship-shaped batch, the JAX layout (the JAX tools'
    `tests/tiny.py` batch at the config's sizes): B samples, view_num
    targets on a ring of cameras at distance 4 looking at the origin,
    image_size^2 input image, max_vertices vertices in [-0.2, 0.2]^3, and
    with_targets the view_num target images (training)."""
    m = cfg.model
    rng = np.random.default_rng(seed)
    N, S, Nv = m.view_num, m.image_size, m.max_vertices
    poses = []
    for i in range(N):
        a = 2 * np.pi * i / max(N, 1) * 0.2
        R = np.asarray([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]])
        t = -R @ (R.T @ np.asarray([0, 0, -4.0]))
        poses.append(np.concatenate([R, t[:, None]], axis=1))
    K = np.eye(4)
    if m.projection == "perspective":
        K[:3, :3] = [[80.0, 0, S / 2], [0, 80.0, S / 2], [0, 0, 1]]
    else:
        K[0, 0] = K[1, 1] = 1 / 0.6
    verts = rng.uniform(-0.2, 0.2, size=(B, Nv, 3))  # drawn first, as bench.py's batch
    arrays = {
        "input_image": rng.uniform(-1, 1, (B, S, S, 3)),
        "input_elevation": np.zeros((B, 1)),
        "input_azimuth": np.zeros((B, 1)),
        "target_elevation": np.zeros((B, N)),
        "target_azimuth": np.zeros((B, N)),
        "target_K": np.broadcast_to(K, (B, N, 4, 4)),
        "target_RT": np.broadcast_to(np.stack(poses), (B, N, 3, 4)),
        "vertices": verts,
        "vertex_mask": np.ones((B, Nv)),
    }
    if with_targets:
        arrays["target_image"] = rng.uniform(-1, 1, (B, N, S, S, 3))
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in arrays.items()}


def tiny_config(view_num: int = 2, projection: str = "perspective"):
    """The repository's tiny test configuration (`tests/tiny.py`) in the
    port's config: 64^2 images, an 8^3 volume, UNet width 32, a 2-layer
    CLIP, fp32, no remat; the tools' `--tiny`."""
    from morphablediffusion_torch.utils.config import (CLIPConfig, Config, ModelConfig,
                                                       UNetConfig)

    cfg = Config()
    cfg.model = ModelConfig(
        view_num=view_num, image_size=64, spatial_volume_size=8, frustum_volume_depth=8,
        voxel_grid_shape=(16, 16, 16), max_vertices=64, sample_steps=2,
        projection=projection, dtype="float32", vae_ch=32, vae_ch_mult=(1, 1, 1, 1),
        vae_num_res_blocks=1,
        unet=UNetConfig(model_channels=32, num_heads=4, volume_dims=(8, 16, 32, 64),
                        use_checkpoint=False),
        clip=CLIPConfig(width=64, layers=2, num_heads=2, patch_size=14, output_dim=768))
    return cfg
