"""Projective / orthographic camera geometry (pure functions).

Counterpart of the JAX package's `ops/geometry.py`, with the same layout:
point sets are (..., N, 3) with xyz last and pixel/grid coordinates are
(..., 2) with (x, y) last. Normalized image coordinates follow the
align_corners=True convention (-1 -> pixel 0, +1 -> pixel L-1).

All products here are tiny (4x4 matrices) and run in float32; the port never
enables TF32 for matmuls, so they stay full fp32 on the card.
"""

from __future__ import annotations

import torch

PERSPECTIVE = "perspective"
ORTHOGRAPHIC = "orthographic"


def _bottom(poses):
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=poses.dtype, device=poses.device)
    return row.expand(poses.shape[0], 1, 4)


def construct_project_matrix(x_ratio, y_ratio, Ks, poses, projection=PERSPECTIVE):
    """Full 4x4 projection matrix from intrinsics and world-to-cam pose.

    Ks: (B, 3, 3)/(B, 4, 4) (perspective uses the top-left 3x3; orthographic
    the full 4x4). poses: (B, 3, 4) world-to-camera [R|t]. Returns (B, 4, 4).
    """
    if projection == PERSPECTIVE:
        scale = torch.diag(torch.tensor([x_ratio, y_ratio, 1.0], dtype=poses.dtype,
                                        device=poses.device))
        prj = scale[None] @ Ks[:, :3, :3] @ poses  # (B, 3, 4)
        return torch.cat([prj, _bottom(poses)], dim=1)
    if projection == ORTHOGRAPHIC:
        return Ks @ torch.cat([poses, _bottom(poses)], dim=1)
    raise NotImplementedError(projection)


def project_and_normalize(points, proj, length, projection=PERSPECTIVE):
    """World points (B, N, 3) -> normalized image coords (B, N, 2)."""
    p = points @ proj[:, :3, :3].transpose(-1, -2) + proj[:, None, :3, 3]
    if projection == PERSPECTIVE:
        div = torch.clamp(p[..., 2:3], min=1e-4)
        xy = p[..., :2] / div
        return xy / ((length - 1) / 2.0) - 1.0
    if projection == ORTHOGRAPHIC:
        return p[..., :2]
    raise NotImplementedError(projection)


def get_warp_coordinates(volume_xyz, warp_size, input_size, Ks, pose,
                         projection=PERSPECTIVE):
    """Normalized sample coords of 3D grid points in a camera's feature map.

    volume_xyz: (B, D, H, W, 3) world points; returns (B, D, H, W, 2).
    """
    B, D, H, W, _ = volume_xyz.shape
    ratio = warp_size / input_size
    proj = construct_project_matrix(ratio, ratio, Ks, pose, projection)
    coords = project_and_normalize(volume_xyz.reshape(B, D * H * W, 3), proj,
                                   warp_size, projection)
    return coords.reshape(B, D, H, W, 2)


def near_far_from_unit_sphere(poses):
    """near/far of the unit sphere along each camera's optical axis.

    poses: (B, 3, 4) world-to-cam. Returns (near, far) each (B, 1).
    """
    R = poses[..., :3, :3]
    t = poses[..., :3, 3:]
    origin = (-(R.transpose(-1, -2) @ t))[..., 0]
    orient = R.transpose(-1, -2)[..., :3, 2]
    a = torch.sum(orient**2, dim=-1, keepdim=True)
    b = -torch.sum(orient * origin, dim=-1, keepdim=True)
    mid = b / a
    return mid - 1.0, mid + 1.0


def camera_positions(poses):
    """World-space camera centers from world-to-cam [R|t]. (..., 3, 4) -> (..., 3)."""
    R = poses[..., :3, :3]
    t = poses[..., :3, 3:]
    return (-(R.transpose(-1, -2) @ t))[..., 0]


def create_target_volume(depth_size, volume_size, input_image_size, poses, Ks,
                         near=None, far=None, projection=PERSPECTIVE):
    """Back-project a per-pixel depth ramp into world space.

    poses: (B, 3, 4); Ks: (B, 3, 3)/(B, 4, 4). near/far: (B,) or (B, H, W)
    metric depths; None -> unit-sphere bounds. Returns (xyz (B, D, H, W, 3),
    depth (B, D, H, W)).
    """
    D, H, W = depth_size, volume_size, volume_size
    B = poses.shape[0]
    dtype, device = poses.dtype, poses.device

    if near is None or far is None:
        near, far = near_far_from_unit_sphere(poses)
        near, far = near[:, 0], far[:, 0]

    def bcast(v):
        v = v.reshape(B, 1, 1, 1) if v.ndim == 1 else v.reshape(B, 1, H, W)
        return v.expand(B, 1, H, W)

    near, far = bcast(near), bcast(far)
    ramp = torch.linspace(0.0, 1.0, D, dtype=dtype, device=device).reshape(1, D, 1, 1)
    depth = ramp * (far - near) + near  # (B, D, H, W)

    ys, xs = torch.meshgrid(torch.arange(H, dtype=dtype, device=device),
                            torch.arange(W, dtype=dtype, device=device),
                            indexing="ij")
    ratio = volume_size / input_image_size

    if projection == PERSPECTIVE:
        pix = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)  # (H, W, 3)
        grid = pix[None, None] * depth[..., None]  # (B, D, H, W, 3)
        proj = construct_project_matrix(ratio, ratio, Ks, poses, projection)
        inv = torch.linalg.inv(proj)
        xyz = (grid.reshape(B, D * H * W, 3) @ inv[:, :3, :3].transpose(-1, -2)
               + inv[:, None, :3, 3])
    elif projection == ORTHOGRAPHIC:
        ndc = torch.stack([2 * xs / (H - 1) - 1, 2 * ys / (H - 1) - 1,
                           torch.ones_like(xs)], dim=-1)  # (H, W, 3)
        K_inv = torch.linalg.inv(Ks)
        cam = ndc.reshape(1, H * W, 3) @ K_inv[:, :3, :3].transpose(-1, -2)
        cam = cam[:, None].expand(B, D, H * W, 3).clone()
        cam[..., 2] = depth.reshape(B, D, H * W)
        eye = torch.eye(4, dtype=dtype, device=device).expand(B, 4, 4)
        RT = construct_project_matrix(1, 1, eye, poses, projection)
        inv = torch.linalg.inv(RT)
        xyz = (cam.reshape(B, D * H * W, 3) @ inv[:, :3, :3].transpose(-1, -2)
               + inv[:, None, :3, 3])
    else:
        raise NotImplementedError(projection)

    return xyz.reshape(B, D, H, W, 3), depth
