"""MorphableDiffusion: the synchronized multi-view latent diffusion model.

Counterpart of the JAX package's `models/diffusion.py::MorphableDiffusion`:
inference (`prepare_inference`, `predict_eps_cfg`, `decode_views`) and the
training loss (`training_loss`). The methods keep the JAX layout at
their boundaries, so they compare like with like: images (B, N, H, W, 3) in
[-1, 1], latents (B, N, h, w, 4), and the batch dict of the JAX package
(`input_image` (B, H, W, 3), `target_K` (B, N, 3+, 3+), `target_RT`
(B, N, 3, 4), `vertices` (B, Nv, 3), `vertex_mask` (B, Nv), elevations and
azimuths). Submodules run channels-first.

Classifier-free guidance runs as a doubled batch: conditional half first,
then the unconditional half with zero CLIP context, zero concat latent and
(analytically, inside the DepthTransformers) zero frustum volumes.

The frozen first stage and CLIP encoder run without gradients. Training
draws its noise from an explicit `torch.Generator`, or takes every draw
injected (`TrainingDraws`), which is how the tests replay the JAX
package's random stream.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from morphablediffusion_torch.models.clip import CLIPImageEncoder
from morphablediffusion_torch.models.layers import TimestepMLP
from morphablediffusion_torch.models.spatial_volume import SpatialVolumeNet
from morphablediffusion_torch.models.unet import DepthWiseUNet
from morphablediffusion_torch.models.vae import AutoencoderKL, sample_diagonal_gaussian
from morphablediffusion_torch.ops import schedules
from morphablediffusion_torch.ops.embeddings import timestep_embedding, viewpoint_embedding
from morphablediffusion_torch.parallel.mesh import view_range
from morphablediffusion_torch.utils import resolve_device, torch_dtype
from morphablediffusion_torch.utils.config import ModelConfig
from morphablediffusion_torch.utils.spans import span

FIRST_STAGE_SCALE = 0.18215

# the random draws of one training step, in the JAX package's order
# (models/diffusion.py::training_loss): the VAE posterior draws of the
# targets and of the input view (JAX layout (M, h, w, 4), M images), the
# timesteps t (B,), the noise (B, N, h, w, 4), the target view index (B, 1)
# and the condition-drop uniforms r (B,)
TrainingDraws = Dict[str, torch.Tensor]


class MorphableDiffusion(nn.Module):
    """The model. `device` defaults to the CUDA card and raises without one;
    pass device="cpu" to run on the CPU. `cfg.unet.w8a8` serves the UNet's
    internal convs W8A8 (serving only)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
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
                volume_dims=cfg.unet.volume_dims, dtype=dtype, view_num=cfg.view_num,
                use_spatial_volume=cfg.use_spatial_volume,
                mesh_voxel_mode=cfg.mesh_voxel_mode,
                fine_grid_shape=cfg.fine_grid_shape,
                fine_voxel_size=cfg.fine_voxel_size)
            u = cfg.unet
            self.unet = DepthWiseUNet(
                u.in_channels, u.model_channels, u.out_channels, u.num_res_blocks,
                u.attention_ds, u.channel_mult, u.num_heads, u.transformer_depth,
                u.context_dim, u.volume_dims, dtype, w8a8=u.w8a8)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # encoding

    @torch.no_grad()
    def encode_image(self, images, eps: Optional[torch.Tensor] = None):
        """images (..., H, W, 3) in [-1, 1] -> scaled latents (..., H/8, W/8, 4)
        fp32, without gradients (the first stage is frozen).

        eps None gives the posterior mode; else eps, a standard normal draw
        of the flat latents (M, h, w, 4) (M = images in the batch), gives a
        posterior sample. More than `vae_encode_chunk` images (a multiple of
        it) stream through the encoder in chunks of that many, which bounds
        its activation memory."""
        lead = images.shape[:-3]
        flat = images.reshape((-1,) + images.shape[-3:]).permute(0, 3, 1, 2)
        M, chunk = flat.shape[0], self.cfg.vae_encode_chunk
        if not (chunk and M > chunk and M % chunk == 0):
            chunk = M
        moments = [self.first_stage.encode_moments(flat[i:i + chunk])
                   for i in range(0, M, chunk)]
        mean = torch.cat([m for m, _ in moments])
        if eps is not None:
            logvar = torch.cat([lv for _, lv in moments])
            eps = eps.reshape((M,) + eps.shape[-3:]).permute(0, 3, 1, 2)
            mean = sample_diagonal_gaussian(mean, logvar, eps)
        z = mean.float().permute(0, 2, 3, 1) * FIRST_STAGE_SCALE
        return z.reshape(lead + z.shape[1:])

    def decode_views(self, latents, batch_view_num: int = 0):
        """latents (B, N, h, w, 4) scaled -> images (B, N, H, W, 3) fp32.

        0 < batch_view_num < N (dividing B*N) decodes that many views per VAE
        call, which bounds the decoder's activation memory; 0 decodes all."""
        B, N = latents.shape[:2]
        flat = latents.reshape((B * N,) + latents.shape[2:]).permute(0, 3, 1, 2)
        chunk = batch_view_num if 0 < batch_view_num < N else N
        if N % chunk:
            chunk = N
        with span("md.decode"):
            img = torch.cat([
                self.first_stage.decode(flat[i:i + chunk] / FIRST_STAGE_SCALE).float()
                for i in range(0, B * N, chunk)])
        img = img.permute(0, 2, 3, 1)
        return img.reshape((B, N) + img.shape[1:])

    @torch.no_grad()
    def encode_clip(self, images):
        """(B, H, W, 3) in [-1, 1] -> (B, 1, 768), without gradients (frozen)."""
        return self.clip_image_encoder(images.permute(0, 3, 1, 2))

    def embed_time(self, t):
        return self.time_embed(timestep_embedding(t, self.cfg.time_embed_dim))

    def embed_viewpoints(self, batch):
        return viewpoint_embedding(batch["input_elevation"], batch["input_azimuth"],
                                   batch["target_elevation"], batch["target_azimuth"])

    # denoising

    def apply_unet(self, x, t, clip_embed, volume_feats, x_concat,
                   cfg_doubled: bool = False, train: bool = False, remat: bool = False):
        """Channels-first UNet call with the concat un-scaling:
        x, x_concat (B, 4, h, w) -> eps (B, 4, h, w) fp32."""
        x_in = torch.cat([x, x_concat / FIRST_STAGE_SCALE], dim=1)
        return self.unet(x_in, t, clip_embed, volume_feats, cfg_doubled=cfg_doubled,
                         train=train, remat=remat)

    def _volume(self, x_cf, t_embed, v_embed, batch, views=None, mesh=None,
                ordered=False):
        """All N noisy views (B, N, 4, h, w) -> the shared spatial volume.
        On a mesh, x_cf holds this rank's views [lo, hi) = views of the
        batch's N, and the per-view inputs are sliced to them. ordered: the
        mesh-voxel scatter in index order (serving: the same bits every
        call)."""
        lo, hi = views or (0, v_embed.shape[1])
        return self.spatial_volume.construct_spatial_volume(
            x_cf, t_embed, v_embed[:, lo:hi], batch["target_K"][:, lo:hi],
            batch["target_RT"][:, lo:hi], batch["vertices"], batch["vertex_mask"], mesh=mesh,
            ordered=ordered)

    def _frustum(self, volume, t_embed, v_embed, batch, views):
        """Frustum volumes of the views `views` ((B, TN) long) ->
        {width: (B*TN, ...)}."""
        take = lambda a: torch.take_along_dim(
            a, views.reshape(views.shape + (1,) * (a.ndim - 2)), dim=1)
        feats, _ = self.spatial_volume.construct_view_frustum_volume(
            volume, t_embed, take(v_embed), take(batch["target_RT"]),
            take(batch["target_K"]))
        return feats

    def predict_eps_cfg(self, x_noisy, t, clip_embed, x_input_latent, v_embed, batch,
                        cfg_scale: float, batch_view_num: int = 0, mesh=None):
        """CFG noise prediction for all N views with doubled-batch UNet calls.

        x_noisy (B, N, h, w, 4); t (B,); clip_embed (B, 1, 768);
        x_input_latent (B, h, w, 4); v_embed (B, N, 4). Returns (B, N, h, w, 4).

        The spatial volume is always built from all N views (that is the
        synchronization). batch_view_num 0 (or >= N) runs the frustum and
        UNet work of all views in one call; 0 < batch_view_num < N dividing
        N runs it over chunks of that many views, which bounds activation
        memory; both give the same numbers.

        mesh: a `parallel.Mesh` (the JAX sampler's `view_sharding`): x_noisy
        holds this rank's views `view_range(mesh, N)` of the batch's N
        (v_embed and the batch keep all N); the volume couples them across
        the ranks and the rest runs on this rank's views, whose eps it
        returns.

        The mesh-voxel scatter adds in index order, so a call gives the same
        bits every time (an avatar is reproducible from its seed; the ranks
        of a mesh agree to the bit).
        """
        with span("md.step"):
            return self._predict_eps_cfg(x_noisy, t, clip_embed, x_input_latent, v_embed,
                                         batch, cfg_scale, batch_view_num, mesh)

    def _predict_eps_cfg(self, x_noisy, t, clip_embed, x_input_latent, v_embed, batch,
                         cfg_scale, batch_view_num, mesh):
        B, n, h, w, C = x_noisy.shape
        lo, hi = view_range(mesh, v_embed.shape[1])
        if hi - lo != n:
            raise ValueError(f"x_noisy holds {n} views, this rank's are [{lo}, {hi})")
        t_embed = self.embed_time(t)
        x_cf = x_noisy.permute(0, 1, 4, 2, 3)  # (B, n, C, h, w)
        volume = self._volume(x_cf, t_embed, v_embed, batch, (lo, hi), mesh, ordered=True)
        chunk = batch_view_num if 0 < batch_view_num < n else n
        if n % chunk:
            chunk = n

        out = []
        for v0 in range(0, n, chunk):
            views = torch.arange(lo + v0, lo + v0 + chunk,
                                 device=x_noisy.device).expand(B, chunk)
            volume_feats = self._frustum(volume, t_embed, v_embed, batch, views)
            x_flat = x_cf[:, v0:v0 + chunk].reshape(B * chunk, C, h, w)
            t_flat = t.repeat_interleave(chunk)
            clip_flat = clip_embed.repeat_interleave(chunk, dim=0)
            concat = x_input_latent.permute(0, 3, 1, 2)[:, None].expand(B, chunk, C, h, w)
            concat = concat.reshape(B * chunk, C, h, w)
            eps2 = self.apply_unet(
                torch.cat([x_flat, x_flat]), torch.cat([t_flat, t_flat]),
                torch.cat([clip_flat, torch.zeros_like(clip_flat)]), volume_feats,
                torch.cat([concat, torch.zeros_like(concat)]), cfg_doubled=True)
            s, s_uc = eps2.chunk(2)
            out.append((s_uc + cfg_scale * (s - s_uc)).reshape(B, chunk, C, h, w))
        return torch.cat(out, dim=1).permute(0, 1, 3, 4, 2)

    # training

    def draw_training_noise(self, B: int, generator: torch.Generator,
                            num_timesteps: int = 1000) -> TrainingDraws:
        """The random draws of one training step from `generator`, in the
        shapes and dtypes `training_loss` takes (see TrainingDraws)."""
        cfg, dev = self.cfg, self.device
        N, h = cfg.view_num, cfg.latent_size
        dt = torch_dtype(cfg.dtype)
        normal = lambda *s, dtype=torch.float32: torch.randn(
            s, generator=generator, device=dev, dtype=dtype)
        return {
            "vae_target": normal(B * N, h, h, 4, dtype=dt),
            "vae_input": normal(B, h, h, 4, dtype=dt),
            "t": torch.randint(0, num_timesteps, (B,), generator=generator, device=dev),
            "noise": normal(B, N, h, h, 4),
            "target_index": torch.randint(0, N, (B, 1), generator=generator, device=dev),
            "r": torch.rand((B,), generator=generator, device=dev),
        }

    @staticmethod
    def drop_masks(r):
        """5%-band condition dropping from uniforms r (B,): keep masks (fp32)
        of the CLIP context, the frustum volumes and the concat latent (the
        JAX package's `_drop_masks`)."""
        drop_all = r <= 0.05
        keep = lambda d: 1.0 - (d | drop_all).float()
        return (keep((r > 0.15) & (r <= 0.2)), keep((r > 0.1) & (r <= 0.15)),
                keep((r > 0.05) & (r <= 0.1)))

    def training_loss(self, batch, draws: Optional[TrainingDraws] = None,
                      generator: Optional[torch.Generator] = None):
        """One training step's loss: noise-MSE on one random target view per
        sample, while the spatial volume consumes all N noisy views.

        batch: the JAX package's batch dict with `target_image`
        (B, N, H, W, 3). draws: every random draw injected (TrainingDraws);
        else they come from `generator`. Returns a fp32 scalar."""
        cfg = self.cfg
        B = batch["target_image"].shape[0]
        sched = schedules.make_diffusion_schedule(device=self.device)
        if draws is None:
            draws = self.draw_training_noise(B, generator, sched.num_timesteps)

        with span("md.encode"):
            x = self.encode_image(batch["target_image"], draws["vae_target"])
            x_concat = self.encode_image(batch["input_image"], draws["vae_input"])
            clip_embed = self.encode_clip(batch["input_image"])

        t, noise = draws["t"], draws["noise"]
        x_noisy = schedules.add_noise(x, noise, t, sched)
        target_index = draws["target_index"].long()
        v_embed = self.embed_viewpoints(batch)
        t_embed = self.embed_time(t)

        x_cf = x_noisy.permute(0, 1, 4, 2, 3)  # (B, N, 4, h, w)
        volume = self._volume(x_cf, t_embed, v_embed, batch)
        volume_feats = self._frustum(volume, t_embed, v_embed, batch, target_index)

        rows = torch.arange(B, device=x.device)
        x_noisy_sel = x_cf[rows, target_index[:, 0]]
        noise_sel = noise[rows, target_index[:, 0]].permute(0, 3, 1, 2)
        x_concat = x_concat.permute(0, 3, 1, 2)

        if cfg.drop_conditions:
            # each mask multiplies in its tensor's own dtype: a fp32 mask
            # would promote the bf16 frustum volumes to fp32
            keep_clip, keep_vol, keep_cat = self.drop_masks(draws["r"])
            clip_embed = clip_embed * keep_clip[:, None, None].to(clip_embed.dtype)
            volume_feats = {k: v * keep_vol[:, None, None, None, None].to(v.dtype)
                            for k, v in volume_feats.items()}
            x_concat = x_concat * keep_cat[:, None, None, None].to(x_concat.dtype)

        eps = self.apply_unet(x_noisy_sel, t, clip_embed, volume_feats, x_concat,
                              train=True, remat=cfg.unet.use_checkpoint)
        return torch.mean((eps - noise_sel) ** 2)

    def prepare_inference(self, batch):
        """CLIP + VAE encode the input view (posterior mode)."""
        with span("md.prepare"):
            return {"x_input": self.encode_image(batch["input_image"]),
                    "clip_embed": self.encode_clip(batch["input_image"]),
                    "v_embed": self.embed_viewpoints(batch)}
