"""MorphableDiffusion: the synchronized multi-view latent diffusion model.

Counterpart of the inference methods of the JAX package's
`models/diffusion.py::MorphableDiffusion`. The methods keep the JAX layout at
their boundaries, so they compare like with like: images (B, N, H, W, 3) in
[-1, 1], latents (B, N, h, w, 4), and the batch dict of the JAX package
(`input_image` (B, H, W, 3), `target_K` (B, N, 3+, 3+), `target_RT`
(B, N, 3, 4), `vertices` (B, Nv, 3), `vertex_mask` (B, Nv), elevations and
azimuths). Submodules run channels-first.

Classifier-free guidance runs as a doubled batch: conditional half first,
then the unconditional half with zero CLIP context, zero concat latent and
(analytically, inside the DepthTransformers) zero frustum volumes.
"""

from __future__ import annotations

import torch
from torch import nn

from morphablediffusion_torch.models.clip import CLIPImageEncoder
from morphablediffusion_torch.models.layers import TimestepMLP
from morphablediffusion_torch.models.spatial_volume import SpatialVolumeNet
from morphablediffusion_torch.models.unet import DepthWiseUNet
from morphablediffusion_torch.models.vae import AutoencoderKL
from morphablediffusion_torch.ops.embeddings import timestep_embedding, viewpoint_embedding
from morphablediffusion_torch.utils import resolve_device, torch_dtype
from morphablediffusion_torch.utils.config import ModelConfig

FIRST_STAGE_SCALE = 0.18215


class MorphableDiffusion(nn.Module):
    """The model at inference. `device` defaults to the CUDA card and raises
    without one; pass device="cpu" to run on the CPU. Only the coarse
    mesh-voxel mode without the spatial-time net and without W8A8 is
    ported."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.mesh_voxel_mode != "coarse" or cfg.use_spatial_volume or cfg.unet.w8a8:
            raise NotImplementedError("the port runs mesh_voxel_mode='coarse' "
                                      "without use_spatial_volume or unet.w8a8")
        dev = resolve_device(device)
        self.cfg = cfg
        dtype = torch_dtype(cfg.dtype)
        with torch.device(dev):
            self.first_stage = AutoencoderKL(4, cfg.vae_ch, cfg.vae_ch_mult,
                                             cfg.vae_num_res_blocks, dtype)
            c = cfg.clip
            self.clip_image_encoder = CLIPImageEncoder(
                c.width, c.layers, c.num_heads, c.patch_size, c.output_dim,
                dtype=dtype)
            self.time_embed = TimestepMLP(cfg.time_embed_dim, cfg.time_embed_dim,
                                          torch.float32)
            self.spatial_volume = SpatialVolumeNet(
                t_dim=cfg.time_embed_dim, v_dim=cfg.viewpoint_dim,
                input_image_size=cfg.image_size,
                spatial_volume_size=cfg.spatial_volume_size,
                spatial_volume_length=cfg.spatial_volume_length,
                frustum_volume_depth=cfg.frustum_volume_depth,
                frustum_volume_length=cfg.frustum_volume_length,
                projection=cfg.projection,
                voxel_grid_shape=cfg.voxel_grid_shape,
                coarse_voxel_size=cfg.coarse_voxel_size,
                volume_dims=cfg.unet.volume_dims, dtype=dtype)
            u = cfg.unet
            self.unet = DepthWiseUNet(
                u.in_channels, u.model_channels, u.out_channels, u.num_res_blocks,
                u.attention_ds, u.channel_mult, u.num_heads, u.transformer_depth,
                u.context_dim, u.volume_dims, dtype)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # encoding

    def encode_image(self, images):
        """images (..., H, W, 3) in [-1, 1] -> scaled latents (..., H/8, W/8, 4),
        the posterior mode."""
        lead = images.shape[:-3]
        flat = images.reshape((-1,) + images.shape[-3:]).permute(0, 3, 1, 2)
        mean, _ = self.first_stage.encode_moments(flat)
        z = mean.float().permute(0, 2, 3, 1) * FIRST_STAGE_SCALE
        return z.reshape(lead + z.shape[1:])

    def decode_views(self, latents):
        """latents (B, N, h, w, 4) scaled -> images (B, N, H, W, 3) fp32."""
        B, N = latents.shape[:2]
        flat = latents.reshape((B * N,) + latents.shape[2:]).permute(0, 3, 1, 2)
        img = self.first_stage.decode(flat / FIRST_STAGE_SCALE).float()
        img = img.permute(0, 2, 3, 1)
        return img.reshape((B, N) + img.shape[1:])

    def encode_clip(self, images):
        """(B, H, W, 3) in [-1, 1] -> (B, 1, 768)."""
        return self.clip_image_encoder(images.permute(0, 3, 1, 2))

    def embed_time(self, t):
        return self.time_embed(timestep_embedding(t, self.cfg.time_embed_dim))

    def embed_viewpoints(self, batch):
        return viewpoint_embedding(batch["input_elevation"], batch["input_azimuth"],
                                   batch["target_elevation"], batch["target_azimuth"])

    # denoising

    def apply_unet(self, x, t, clip_embed, volume_feats, x_concat,
                   cfg_doubled: bool = False):
        """Channels-first UNet call with the concat un-scaling:
        x, x_concat (B, 4, h, w) -> eps (B, 4, h, w) fp32."""
        x_in = torch.cat([x, x_concat / FIRST_STAGE_SCALE], dim=1)
        return self.unet(x_in, t, clip_embed, volume_feats, cfg_doubled=cfg_doubled)

    def predict_eps_cfg(self, x_noisy, t, clip_embed, x_input_latent, v_embed, batch,
                        cfg_scale: float):
        """CFG noise prediction for all N views in one doubled-batch UNet call.

        x_noisy (B, N, h, w, 4); t (B,); clip_embed (B, 1, 768);
        x_input_latent (B, h, w, 4); v_embed (B, N, 4). Returns (B, N, h, w, 4).
        """
        B, N, h, w, C = x_noisy.shape
        t_embed = self.embed_time(t)
        x_cf = x_noisy.permute(0, 1, 4, 2, 3)  # (B, N, C, h, w)
        sv = self.spatial_volume
        volume = sv.construct_spatial_volume(
            x_cf, t_embed, v_embed, batch["target_K"], batch["target_RT"],
            batch["vertices"], batch["vertex_mask"])
        volume_feats, _ = sv.construct_view_frustum_volume(
            volume, t_embed, v_embed, batch["target_RT"], batch["target_K"])

        x_flat = x_cf.reshape(B * N, C, h, w)
        t_flat = t.repeat_interleave(N)
        clip_flat = clip_embed.repeat_interleave(N, dim=0)
        concat = x_input_latent.permute(0, 3, 1, 2)[:, None].expand(B, N, C, h, w)
        concat = concat.reshape(B * N, C, h, w)

        eps2 = self.apply_unet(
            torch.cat([x_flat, x_flat]), torch.cat([t_flat, t_flat]),
            torch.cat([clip_flat, torch.zeros_like(clip_flat)]), volume_feats,
            torch.cat([concat, torch.zeros_like(concat)]), cfg_doubled=True)
        s, s_uc = eps2.chunk(2)
        eps = s_uc + cfg_scale * (s - s_uc)
        return eps.reshape(B, N, C, h, w).permute(0, 1, 3, 4, 2)

    def prepare_inference(self, batch):
        """CLIP + VAE encode the input view (posterior mode)."""
        return {"x_input": self.encode_image(batch["input_image"]),
                "clip_embed": self.encode_clip(batch["input_image"]),
                "v_embed": self.embed_viewpoints(batch)}
