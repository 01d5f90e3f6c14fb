"""Cross-view color calibration for multi-camera captures.

The PyTorch port's own copy of the JAX package's
`preprocessing/color_calib.py` (numpy; depth from the port's rasterizer).

Same algorithm family as the reference (preprocessing/facescape/
calibrate_colors.py, DINER-derived): sample the shared mesh's vertex colors
in every view, average them across views to get a reference color per
vertex, robust-fit one affine color transform (3x4) per view mapping that
view's colors onto the average, and rewrite the images. Views whose initial
error or dark-red-outlier ratio is too high are skipped with a warning; a
view whose fit does not improve its error is copied through unchanged.

Implementation differences: visibility comes from the native depth
rasterizer (preprocessing.raster) instead of pyrender; the robust fit is a
plain Huber IRLS in numpy (sklearn used only if present).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
from PIL import Image

from morphablediffusion_torch.preprocessing.raster import render_depth_cv

SPECULAR_THR = 0.7
L1_THR = 0.085
RED_OUTLIER_THR = 0.3
RED_OUTLIER_RATIO_THR = 0.03
VISIBILITY_DEPTH_TOL = 0.003


def _huber_irls(X, y, epsilon=1.0, iters=50, tol=1e-8):
    """Huber-loss linear regression via iteratively reweighted least squares.
    X: (N, D), y: (N,) -> coef (D,). No intercept (X carries a ones column)."""
    coef = np.linalg.lstsq(X, y, rcond=None)[0]
    for _ in range(iters):
        r = y - X @ coef
        med = np.median(np.abs(r))
        if med < 1e-9:  # already an (near-)exact fit; reweighting would
            break       # divide by ~0 and destabilize a degenerate system
        scale = max(med / 0.6745, 1e-8)
        a = np.abs(r) / scale
        w = np.where(a <= epsilon, 1.0, epsilon / np.maximum(a, 1e-12))
        Xw = X * w[:, None]
        new = np.linalg.lstsq(Xw.T @ X, Xw.T @ y, rcond=None)[0]
        if np.max(np.abs(new - coef)) < tol:
            coef = new
            break
        coef = new
    return coef


def _fit_affine_correction(colors, target):
    """Per-channel robust affine fit: target - colors ~ [colors|1] @ a.
    Returns A (3, 4) with identity folded in, as in the reference (:178-193)."""
    X = np.concatenate([colors, np.ones_like(colors[:, :1])], axis=-1)
    A = []
    for ch in range(3):
        a = _huber_irls(X, target[:, ch] - colors[:, ch])
        a[ch] += 1.0
        A.append(a)
    return np.stack(A, axis=0)


def _sample_bilinear(img, uv):
    """img: (H, W, C) float; uv: (N, 2) pixel coords -> (N, C), border clamp."""
    H, W = img.shape[:2]
    x = np.clip(uv[:, 0] - 0.5, 0, W - 1)
    y = np.clip(uv[:, 1] - 0.5, 0, H - 1)
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    return (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x1] * fx * (1 - fy)
        + img[y1, x0] * (1 - fx) * fy
        + img[y1, x1] * fx * fy
    )


def calibrate_colors(
    scan_dir: Path,
    verts: np.ndarray,
    faces: np.ndarray,
    rgb_in_fname: str = "rgba.png",
    rgb_out_fname: str = "rgba_colorcalib.png",
    verbose: bool = False,
):
    scan_dir = Path(scan_dir)
    cam_dict = json.loads((scan_dir / "cameras.json").read_text())
    cam_ids = sorted(cam_dict.keys(), key=int)

    view_colors, view_idcs = [], []
    for camid in cam_ids:
        img_path = scan_dir / f"view_{int(camid):05d}" / rgb_in_fname
        rgba = np.asarray(Image.open(img_path), dtype=np.float32) / 255.0
        h, w = rgba.shape[:2]
        K = np.asarray(cam_dict[camid]["intrinsics"], np.float64)
        Rt = np.asarray(cam_dict[camid]["extrinsics"], np.float64)

        depth = render_depth_cv(verts, faces, K, Rt, (h, w))
        cam = verts @ Rt[:3, :3].T + Rt[:3, 3]
        z = cam[:, 2]
        uvw = cam @ K.T
        uv = uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-12)

        inb = (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
        d = np.zeros(len(verts), np.float32)
        ui = np.clip(uv[:, 0].astype(int), 0, w - 1)
        vi = np.clip(uv[:, 1].astype(int), 0, h - 1)
        d[inb] = depth[vi[inb], ui[inb]]
        visible = inb & (d > 0) & (np.abs(d - z) < VISIBILITY_DEPTH_TOL)

        colors = _sample_bilinear(rgba[..., :3], uv)
        specular = colors.mean(axis=-1) >= SPECULAR_THR
        mask = visible & ~specular
        view_colors.append(colors[mask])
        view_idcs.append(np.where(mask)[0])

    # reference color = visibility-weighted mean across views (:137-143)
    mean_colors = np.zeros((len(verts), 3), np.float64)
    counts = np.zeros(len(verts), np.float64)
    for c, i in zip(view_colors, view_idcs):
        np.add.at(mean_colors, i, c)
        np.add.at(counts, i, 1.0)
    mean_colors /= counts[:, None] + 1e-4

    l1, red_ratio, correctors = [], [], []
    for c, i in zip(view_colors, view_idcs):
        err = np.abs(mean_colors[i] - c)
        l1.append(err.mean() if len(c) else np.inf)
        red_ratio.append(
            float(
                ((err[:, 0] > RED_OUTLIER_THR) & np.all(c < 50 / 255.0, axis=-1)).mean()
            )
            if len(c)
            else 1.0
        )
        correctors.append(
            _fit_affine_correction(c, mean_colors[i]) if len(c) > 8 else np.eye(3, 4)
        )

    for idx, camid in enumerate(cam_ids):
        view_dir = scan_dir / f"view_{int(camid):05d}"
        src, dst = view_dir / rgb_in_fname, view_dir / rgb_out_fname
        c, i, A = view_colors[idx], view_idcs[idx], correctors[idx]
        if l1[idx] > L1_THR:
            print(f"WARNING: {src} not corrected (l1 {l1[idx]:.3f} too high)")
            continue
        if red_ratio[idx] > RED_OUTLIER_RATIO_THR:
            print(f"WARNING: {src} not corrected (red outlier ratio "
                  f"{red_ratio[idx]:.3f} too high)")
            continue
        ch = np.concatenate([c, np.ones_like(c[:, :1])], -1)
        l1_fixed = np.abs(mean_colors[i] - ch @ A.T).mean() if len(c) else np.inf
        if l1[idx] < l1_fixed:
            if verbose:
                print(f"{src}: fit did not improve ({l1[idx]:.3f} -> "
                      f"{l1_fixed:.3f}), copying unchanged")
            shutil.copy(src, dst)
            continue
        rgba = np.asarray(Image.open(src), dtype=np.float32) / 255.0
        rgb, alpha = rgba[..., :3], rgba[..., 3:]
        flat = rgb.reshape(-1, 3)
        flat = np.concatenate([flat, np.ones_like(flat[:, :1])], -1) @ A.T
        out = np.concatenate([flat.reshape(rgb.shape), alpha], -1)
        out = np.clip(out * 255.0, 0, 255).astype(np.uint8)
        Image.fromarray(out, "RGBA").save(dst)
