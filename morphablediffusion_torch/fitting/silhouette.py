"""Silhouette term of the FLAME fitter.

The PyTorch port's own copy of the JAX package's `fitting/silhouette.py`.
The reference's in-the-wild quality rests on metrical-tracker's
photometric stage (third_party/metrical-tracker/tracker.py:117-144, a
~1000-step Adam loop through a pytorch3d rasterizer). Its shape-
constraining half, "the rendered head must cover exactly the photographed
head", is a silhouette consistency term that needs only a subject matte
(`preprocessing/matting.py`).

Formulation (distance-transform silhouette coupling, LM-friendly so it
drops into `fit.py`'s damped normal-equation stages):

* **inside term**: every visible projected vertex samples the Euclidean
  distance transform of the region outside the target mask (bilinear, so
  it is differentiable in the projection); vertices inside read exactly 0.
* **contour term**: point-to-plane ICP residuals against correspondences
  fixed per round on the host (`contour_correspondences`).
* **visibility**: per-vertex occlusion from the C++ z-buffer rasterizer
  (`preprocessing/raster.py`) on the current fit, outside the LM stage and
  held fixed within it.

The distance transforms, contours, correspondences and visibility stay on
the host in numpy/scipy (`_verts_px` in float64 through scipy's
`Rotation`); `sample_dt` and `silhouette_residuals` are tensors on the
fit's device, inside the stage's Jacobian.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from morphablediffusion_torch.fitting.flame import FlameModel, flame_forward

# --------------------------------------------------------------------- #
# host side: masks, distance transforms, contours, visibility


def _hw(image_size) -> tuple:
    """int S -> (S, S); an (h, w) tuple passes through (non-square photos)."""
    if isinstance(image_size, (tuple, list)):
        return int(image_size[0]), int(image_size[1])
    return int(image_size), int(image_size)


def render_silhouette(model: FlameModel, params: dict, K: np.ndarray, image_size) -> np.ndarray:
    """Rasterize the posed FLAME mesh into an (h, w) bool mask with the C++
    z-buffer rasterizer."""
    return _render_depth(model, params, K, image_size) > 0.0


def _verts_px(model: FlameModel, params: dict, K: np.ndarray) -> np.ndarray:
    """(V, 3) [x_px, y_px, z_cam] of the posed mesh under the fit camera;
    the vertices from the model's device, the camera on the host."""
    from scipy.spatial.transform import Rotation

    dev = model.device
    with torch.no_grad():
        v = flame_forward(
            model, *(torch.as_tensor(np.asarray(params[k]), dtype=torch.float32, device=dev)
                     for k in ("shape", "exp", "pose"))).cpu().numpy()
    R = Rotation.from_rotvec(np.asarray(params["cam_r"])).as_matrix()
    cam = v @ R.T + np.asarray(params["cam_t"])
    z = np.maximum(cam[:, 2], 1e-6)
    K = np.asarray(K, np.float32)
    x = cam[:, 0] / z * K[0, 0] + K[0, 2]
    y = cam[:, 1] / z * K[1, 1] + K[1, 2]
    return np.stack([x, y, z], axis=1).astype(np.float32)


def _render_depth(model: FlameModel, params: dict, K: np.ndarray, image_size) -> np.ndarray:
    from morphablediffusion_torch.preprocessing.raster import rasterize_depth_px

    h, w = _hw(image_size)
    vpx = _verts_px(model, params, K)
    return rasterize_depth_px(vpx, model.faces.cpu().numpy().astype(np.int32), h, w)


def vertex_visibility(model: FlameModel, params: dict, K: np.ndarray, image_size,
                      rel_eps: float = 0.02) -> np.ndarray:
    """(V,) float 1.0 where the vertex wins (or nearly wins) the z-buffer.

    A vertex is visible when its camera depth is within ``rel_eps``
    (relative) of the rasterized depth at its pixel. Off-screen vertices
    are invisible.
    """
    h, w = _hw(image_size)
    vpx = _verts_px(model, params, K)
    depth = _render_depth(model, params, K, image_size)
    xi = np.clip(np.round(vpx[:, 0]).astype(int), 0, w - 1)
    yi = np.clip(np.round(vpx[:, 1]).astype(int), 0, h - 1)
    on = (vpx[:, 0] >= 0) & (vpx[:, 0] <= w - 1) & (vpx[:, 1] >= 0) & (vpx[:, 1] <= h - 1)
    zbuf = depth[yi, xi]
    vis = on & (zbuf > 0) & (vpx[:, 2] <= zbuf * (1.0 + rel_eps))
    return vis.astype(np.float32)


def mask_to_dt(mask: np.ndarray) -> np.ndarray:
    """(H, W) bool subject mask -> float32 px distance to the mask for
    points outside it (exactly 0 everywhere inside)."""
    from scipy import ndimage

    return ndimage.distance_transform_edt(~mask.astype(bool)).astype(np.float32)


def mask_contour(mask: np.ndarray, n: int = 96) -> np.ndarray:
    """(n, 2) float32 (x, y) pixel coords subsampled from the mask boundary
    (mask pixels with at least one non-mask 4-neighbour)."""
    m = mask.astype(bool)
    pad = np.pad(m, 1)
    boundary = m & ~(pad[:-2, 1:-1] & pad[2:, 1:-1] & pad[1:-1, :-2] & pad[1:-1, 2:])
    ys, xs = np.nonzero(boundary)
    if len(xs) == 0:
        return np.zeros((0, 2), np.float32)
    idx = np.linspace(0, len(xs) - 1, min(n, len(xs))).astype(int)
    return np.stack([xs[idx], ys[idx]], axis=1).astype(np.float32)


# --------------------------------------------------------------------- #
# on the device: differentiable residuals


def sample_dt(dt: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an (H, W) map at (N, 2) pixel coords (x, y),
    clamped to the border (the DT keeps growing outward, so clamping keeps
    a useful inward gradient for far-out vertices)."""
    H, W = dt.shape
    x = torch.clamp(uv[:, 0], 0.0, W - 1.0)
    y = torch.clamp(uv[:, 1], 0.0, H - 1.0)
    x0 = torch.clamp(torch.floor(x), 0, W - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(y), 0, H - 2).to(torch.int64)
    fx, fy = x - x0, y - y0
    d00 = dt[y0, x0]
    d01 = dt[y0, x0 + 1]
    d10 = dt[y0 + 1, x0]
    d11 = dt[y0 + 1, x0 + 1]
    return (d00 * (1 - fx) * (1 - fy) + d01 * fx * (1 - fy)
            + d10 * (1 - fx) * fy + d11 * fx * fy)


def silhouette_residuals(
    verts2d: torch.Tensor,       # (V, 2) projected vertices, pixels
    vis: torch.Tensor,           # (V,) 1.0 = visible under the current fit
    dt_out: torch.Tensor,        # (H, W) outside-distance transform
    corr_vids: torch.Tensor,     # (C,) vertex id matched to each contour sample
    corr_pts: torch.Tensor,      # (C, 2) matched target-contour pixels
    corr_normals: torch.Tensor,  # (C, 2) outward contour normals
    corr_w: torch.Tensor,        # (C,) 0/1 validity of each correspondence
    px_scale: float,             # residual px -> reference-px scale (300 / fx)
    w_inside: float,
    w_cover: float,
    deadband_px: float = 0.0,    # hinge: the inside term acts only beyond this
) -> Tuple[torch.Tensor, torch.Tensor]:
    """LM residual blocks (inside, contour ICP); cost = 0.5 * sum(r**2).

    * inside: hinged DT pull-in of visible vertices, the hinge at the
      projected inter-vertex spacing (an unhinged term measured double the
      vertex RMS at sigma=0 in the JAX package's study).
    * contour: point-to-plane residuals against correspondences fixed per
      round: only the component along the contour normal counts.
    """
    d_in = torch.clamp_min(sample_dt(dt_out, verts2d) - deadband_px, 0.0)
    r_in = math.sqrt(w_inside) * px_scale * d_in * vis
    if corr_vids.shape[0]:
        diff = verts2d[corr_vids] - corr_pts
        d_n = torch.sum(diff * corr_normals, dim=-1) * corr_w
        r_cov = math.sqrt(w_cover) * px_scale * d_n
    else:
        r_cov = verts2d.new_zeros((0,))
    return r_in, r_cov


def contour_correspondences(
    target_contour: np.ndarray,   # (C, 2) px samples of the photo silhouette
    mesh_mask: np.ndarray,        # (S, S) rendered mask of the current fit
    verts2d: np.ndarray,          # (V, 2) current projected vertices
    vis: np.ndarray,              # (V,) current visibility
    max_px: float,                # reject matches farther than this
    target_mask: np.ndarray = None,  # (S, S) photo mask, for the normals
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """ICP correspondence: target contour sample -> nearest pixel of the
    rendered mesh contour -> nearest visible vertex to that pixel. Returns
    (vertex_ids, target_pts, normals, weights) with weight 0 for matches
    beyond ``max_px``. Normals are outward unit gradients of the target
    mask's signed distance field at the contour samples."""
    C = len(target_contour)

    def empty():
        z = np.zeros((0,), np.int32)
        zp = np.zeros((0, 2), np.float32)
        return z, zp, zp, np.zeros((0,), np.float32)

    if C == 0:
        return empty()
    mesh_c = mask_contour(mesh_mask, n=4 * C)
    pts = np.asarray(verts2d, np.float32)
    vi = np.asarray(vis) > 0.5
    if len(mesh_c) == 0 or vi.sum() < 3:
        return empty()
    d_tm = np.linalg.norm(target_contour[:, None, :] - mesh_c[None, :, :], axis=-1)
    j = d_tm.argmin(axis=1)                       # nearest mesh-contour px
    w = (d_tm[np.arange(C), j] <= max_px).astype(np.float32)
    vid_pool = np.nonzero(vi)[0]
    d_mv = np.linalg.norm(mesh_c[j][:, None, :] - pts[vid_pool][None, :, :], axis=-1)
    vids = vid_pool[d_mv.argmin(axis=1)].astype(np.int32)
    normals = contour_normals(target_mask, target_contour)
    return vids, target_contour.astype(np.float32), normals, w


def contour_normals(mask: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """(C, 2) outward unit normals of the mask boundary at pixel points,
    from the gradient of the signed distance field (dt_out - dt_in)."""
    from scipy import ndimage

    m = mask.astype(bool)
    sdf = (ndimage.distance_transform_edt(~m) - ndimage.distance_transform_edt(m)).astype(
        np.float32)
    gy, gx = np.gradient(sdf)
    xi = np.clip(np.round(pts[:, 0]).astype(int), 0, m.shape[1] - 1)
    yi = np.clip(np.round(pts[:, 1]).astype(int), 0, m.shape[0] - 1)
    n = np.stack([gx[yi, xi], gy[yi, xi]], axis=1)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(norm, 1e-6)).astype(np.float32)


def vertex_spacing_px(verts2d: np.ndarray, vis: np.ndarray) -> float:
    """Median nearest-neighbour distance of the visible projected vertices:
    the deadband of the hinged silhouette residuals."""
    pts = np.asarray(verts2d)[np.asarray(vis) > 0.5]
    if len(pts) < 2:
        return 2.0
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return float(np.median(np.sqrt(d2.min(axis=1))))
