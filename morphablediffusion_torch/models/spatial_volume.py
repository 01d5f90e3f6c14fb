"""Spatial-volume conditioning orchestrator.

Counterpart of the JAX package's `models/spatial_volume.py::SpatialVolumeNet`:

  * `construct_spatial_volume` encodes all N noisy views, unprojects a shared
    V^3 grid in [-L, L]^3 into every view, samples the view-MEAN volume at the
    mesh vertices (exact: trilinear sampling is linear in the volume, and the
    per-vertex linear commutes with the mean), runs the mesh voxel net (the
    coarse `MeshVoxelNet`, or `FineMeshVoxelNet` with mesh_voxel_mode='fine')
    and queries it back on the grid -> (B, 64, V, V, V). With
    `use_spatial_volume` the SpatialTime3DNet of the view-major unprojected
    volume (B, N*16, V, V, V) is added to it.
  * on a mesh (`parallel/mesh.py`) a rank passes its own views: the view
    mean is its fp32 sum over the rank's views, summed over the ranks
    (`all_reduce_sum`) and divided by the global view count, and with
    `use_spatial_volume` the unprojected views are gathered in view order.
    The rest of the volume is the same computation on every rank, its
    mesh-voxel scatter in index order (its atomics on the card would make
    the bits vary from call to call), so all ranks hold a bitwise-identical
    volume;
  * `construct_view_frustum_volume` builds a (D, h, w) camera-frustum ray
    volume per target view with near/far = camera distance -+ L_f, samples the
    spatial volume along it, and runs FrustumTV3DNet -> {width: volume}.

Volumes are channels-first with array axes (d, h, w) = (z, y, x); world xyz
coordinates keep the JAX layout, xyz on the last axis.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from morphablediffusion_torch.models.conditioner import (
    FrustumTV3DNet,
    NoisyTargetViewEncoder,
    SMPLFeatureExtractor,
    SpatialTime3DNet,
)
from morphablediffusion_torch.models.mesh_voxel import FineMeshVoxelNet, MeshVoxelNet
from morphablediffusion_torch.ops import geometry
from morphablediffusion_torch.parallel.collectives import all_gather_cat, all_reduce_sum
from morphablediffusion_torch.ops.grid_sample import grid_sample_2d, grid_sample_3d
from morphablediffusion_torch.utils.spans import span


def spatial_grid_xyz(size: int, length: float, device=None, dtype=torch.float32):
    """(V, V, V, 3) world xyz of the shared volume; array axes are (z, y, x)."""
    lin = torch.linspace(-length, length, size, dtype=dtype, device=device)
    z, y, x = torch.meshgrid(lin, lin, lin, indexing="ij")
    return torch.stack([x, y, z], dim=-1)


class SpatialVolumeNet(nn.Module):
    def __init__(self, t_dim=256, v_dim=4, input_image_size=256,
                 spatial_volume_size=32, spatial_volume_length=0.5,
                 frustum_volume_depth=48, frustum_volume_length=0.86603,
                 projection="perspective",
                 voxel_grid_shape: Tuple[int, int, int] = (48, 48, 48),
                 coarse_voxel_size=0.02,
                 volume_dims: Tuple[int, ...] = (64, 128, 256, 512),
                 dtype=torch.float32, view_num=16, use_spatial_volume=False,
                 mesh_voxel_mode="coarse",
                 fine_grid_shape: Tuple[int, int, int] = (128, 144, 128),
                 fine_voxel_size=0.005):
        super().__init__()
        self.input_image_size = input_image_size
        self.spatial_volume_size = spatial_volume_size
        self.spatial_volume_length = spatial_volume_length
        self.frustum_volume_depth = frustum_volume_depth
        self.frustum_volume_length = frustum_volume_length
        self.projection = projection
        self.target_encoder = NoisyTargetViewEncoder(t_dim, v_dim, 4, 16, 16, dtype)
        self.smpl_feature_extractor = SMPLFeatureExtractor(16, 16, dtype)
        if mesh_voxel_mode == "fine":
            self.mesh_voxel = FineMeshVoxelNet(16, fine_grid_shape, fine_voxel_size, dtype)
        elif mesh_voxel_mode == "coarse":
            self.mesh_voxel = MeshVoxelNet(16, voxel_grid_shape, coarse_voxel_size,
                                           dtype=dtype)
        else:
            raise ValueError(f"mesh_voxel_mode {mesh_voxel_mode!r}: coarse or fine")
        self.frustum_volume_feats = FrustumTV3DNet(64, t_dim, v_dim, volume_dims, dtype)
        self.use_spatial_volume = use_spatial_volume
        if use_spatial_volume:
            self.spatial_volume_feats = SpatialTime3DNet(view_num * 16, t_dim,
                                                         (64, 128, 256, 512), dtype)

    @property
    def frustum_volume_size(self) -> int:
        return self.input_image_size // 8

    def construct_spatial_volume(self, x, t_embed, v_embed, target_Ks, target_RTs,
                                 vertices, vert_mask, mesh=None, ordered=False):
        """x: (B, N, 4, h, w) noisy latents; t_embed: (B, td); v_embed:
        (B, N, vd); target_Ks: (B, N, 3+, 3+); target_RTs: (B, N, 3, 4);
        vertices: (B, Nv, 3) world xyz; vert_mask: (B, Nv).
        Returns (B, C_vol, V, V, V).

        mesh: a `parallel.Mesh` with a group: x and the per-view inputs are
        this rank's N views of the world's N * mesh.world. ordered: the
        mesh-voxel scatter adds in index order (`scatter_mean_voxels`); the
        serving path asks for it, training does not."""
        with span("md.volume"):
            return self._spatial_volume(x, t_embed, v_embed, target_Ks, target_RTs, vertices,
                                        vert_mask, mesh, ordered)

    def _spatial_volume(self, x, t_embed, v_embed, target_Ks, target_RTs, vertices,
                        vert_mask, mesh, ordered):
        B, N, C_in, h, w = x.shape
        V, L = self.spatial_volume_size, self.spatial_volume_length

        x_flat = x.reshape(B * N, C_in, h, w)
        t_flat = t_embed[:, None].expand(B, N, t_embed.shape[-1]).reshape(B * N, -1)
        v_flat = v_embed.reshape(B * N, v_embed.shape[-1])
        feats = self.target_encoder(x_flat, t_flat, v_flat)  # (B*N, 16, h, w)

        grid_xyz = spatial_grid_xyz(V, L, device=x.device)
        grid_b = grid_xyz[None].expand(B * N, V, V, V, 3)
        Ks_flat = target_Ks.reshape((B * N,) + target_Ks.shape[2:])
        RT_flat = target_RTs.reshape(B * N, 3, 4)
        coords = geometry.get_warp_coordinates(
            grid_b, feats.shape[-2], self.input_image_size, Ks_flat, RT_flat,
            self.projection)  # (B*N, V, V, V, 2)
        unproj = grid_sample_2d(feats, coords)  # (B*N, 16, V, V, V)
        C = unproj.shape[1]
        if mesh is None or mesh.group is None:
            vol_mean = unproj.reshape(B, N, C, V, V, V).float().mean(1).to(unproj.dtype)
        else:
            total = all_reduce_sum(unproj.reshape(B, N, C, V, V, V).float().sum(1), mesh)
            vol_mean = (total / (N * mesh.world)).to(unproj.dtype)

        vert_feats = grid_sample_3d(vol_mean, vertices / L)  # (B, 16, Nv)
        smpl_feats = self.smpl_feature_extractor(vert_feats.transpose(1, 2))

        vert_dhw = vertices.flip(-1)
        big = torch.tensor(1e9, dtype=vertices.dtype, device=vertices.device)
        min_dhw = torch.where(vert_mask[..., None] > 0, vert_dhw, big).amin(1)
        query_dhw = grid_xyz.flip(-1)[None].expand(B, V, V, V, 3)
        with span("md.mesh_voxel"):
            volume = self.mesh_voxel(smpl_feats, vert_dhw, min_dhw, vert_mask, query_dhw,
                                     ordered=ordered)
        if self.use_spatial_volume:
            # view-major channels n * 16 + c, as the JAX package's
            # (B, V, V, V, N*16) volume
            mv = all_gather_cat(unproj.reshape(B, N, C, V, V, V), 1, mesh)
            mv = mv.reshape(B, -1, V, V, V)
            volume = volume + self.spatial_volume_feats(mv, t_embed)
        return volume

    def construct_view_frustum_volume(self, spatial_volume, t_embed, v_embed_sel,
                                      poses, Ks):
        """spatial_volume: (B, C, V, V, V); t_embed: (B, td); v_embed_sel:
        (B, TN, vd); poses: (B, TN, 3, 4); Ks: (B, TN, 3+, 3+).
        Returns ({width: (B*TN, C', D', w, w)}, depth (B*TN, D, h, w))."""
        with span("md.frustum"):
            return self._frustum_volume(spatial_volume, t_embed, v_embed_sel, poses, Ks)

    def _frustum_volume(self, spatial_volume, t_embed, v_embed_sel, poses, Ks):
        B, TN = poses.shape[:2]
        Hf = self.frustum_volume_size
        D = self.frustum_volume_depth
        L = self.spatial_volume_length

        poses_flat = poses.reshape(B * TN, 3, 4)
        Ks_flat = Ks.reshape((B * TN,) + Ks.shape[2:])
        dist = torch.linalg.norm(geometry.camera_positions(poses_flat), dim=-1)
        near = dist - self.frustum_volume_length
        far = dist + self.frustum_volume_length
        xyz, depth = geometry.create_target_volume(
            D, Hf, self.input_image_size, poses_flat, Ks_flat, near, far,
            self.projection)  # (B*TN, D, Hf, Hf, 3)

        grid = (xyz / L).reshape(B, TN * D * Hf * Hf, 3)
        frustum = grid_sample_3d(spatial_volume, grid)  # (B, C, TN*D*Hf*Hf)
        C = frustum.shape[1]
        frustum = frustum.reshape(B, C, TN, D, Hf, Hf).transpose(1, 2)
        frustum = frustum.reshape(B * TN, C, D, Hf, Hf)

        t_flat = t_embed[:, None].expand(B, TN, t_embed.shape[-1]).reshape(B * TN, -1)
        v_flat = v_embed_sel.reshape(B * TN, -1)
        return self.frustum_volume_feats(frustum, t_flat, v_flat), depth
