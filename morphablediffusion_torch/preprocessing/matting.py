"""In-repo background matting: the plain-photo path of generate_face.

The PyTorch port's own copy of the JAX package's `preprocessing/matting.py`
(numpy and scipy only). The reference runs carvekit's Tracer-B7 (a CUDA
model-zoo download) inside its CLI so that a photo without alpha works end
to end; this module gives the same in-pipeline capability with no external
model: a border-seeded color-model segmentation (k-means background model
from the image frame + center-prior foreground model, a few EM refinement
rounds, then an edge-aware guided-filter alpha). Portrait inputs — the only
inputs this pipeline sees — have centered subjects and comparatively
uniform backgrounds, which is exactly the regime where the color-model
approach is reliable.

Backends (pick with `matte(..., backend=...)`):
  "auto"    — carvekit or rembg if importable (same models the reference
              uses, GPU optional), else "native".
  "native"  — the in-repo algorithm below (numpy only, deterministic).
  "none"    — treat the image as already clean (alpha = 1 everywhere).
"""

from __future__ import annotations

import numpy as np


def _kmeans(x: np.ndarray, k: int, iters: int = 12, seed: int = 0) -> np.ndarray:
    """Plain k-means on (N, C) rows -> (k, C) centers (deterministic)."""
    rng = np.random.default_rng(seed)
    centers = x[rng.choice(len(x), size=min(k, len(x)), replace=False)]
    for _ in range(iters):
        d = ((x[:, None] - centers[None]) ** 2).sum(-1)  # (N, k)
        assign = d.argmin(1)
        for j in range(len(centers)):
            sel = x[assign == j]
            if len(sel):
                centers[j] = sel.mean(0)
    return centers


def _box_blur(x: np.ndarray, r: int) -> np.ndarray:
    """Separable box filter with edge-replicate padding (any trailing dims)."""
    if r <= 0:
        return x
    for axis in (0, 1):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (r, r)
        xp = np.pad(x, pad, mode="edge")
        c = np.cumsum(xp, axis=axis, dtype=np.float64)
        # window sum for output i is sum(xp[i .. i+2r]) = c[i+2r] - c[i] + xp[i]
        # with c the inclusive cumsum (the subtracted prefix removes xp[i]
        # itself, so it must be added back PER-INDEX, not as the constant
        # xp[0] — that bug biased every window toward the first padded row).
        lead = np.take(c, np.arange(2 * r, 2 * r + x.shape[axis]), axis=axis)
        lag = np.take(c, np.arange(x.shape[axis]), axis=axis)
        edge = np.take(xp, np.arange(x.shape[axis]), axis=axis)
        x = ((lead - lag + edge) / (2 * r + 1)).astype(np.float32)
    return x


def _guided_filter(guide: np.ndarray, src: np.ndarray, r: int = 8,
                   eps: float = 1e-3) -> np.ndarray:
    """He et al.-style guided filter with a grayscale guide: snaps the alpha
    estimate to image edges without any learned model."""
    g = guide.mean(-1)
    mean_g = _box_blur(g, r)
    mean_s = _box_blur(src, r)
    cov = _box_blur(g * src, r) - mean_g * mean_s
    var = _box_blur(g * g, r) - mean_g**2
    a = cov / (var + eps)
    b = mean_s - a * mean_g
    return _box_blur(a, r) * g + _box_blur(b, r)


def estimate_alpha(img: np.ndarray, k_bg: int = 4, k_fg: int = 4,
                   refine_rounds: int = 3) -> np.ndarray:
    """(H, W, 3) float [0,1] -> (H, W) float alpha in [0,1]."""
    H, W = img.shape[:2]
    border = max(2, int(0.03 * min(H, W)))
    frame = np.concatenate([
        img[:border].reshape(-1, 3), img[-border:].reshape(-1, 3),
        img[:, :border].reshape(-1, 3), img[:, -border:].reshape(-1, 3),
    ])
    bg_centers = _kmeans(frame, k_bg, seed=0)

    flat = img.reshape(-1, 3)
    d_bg = np.sqrt(((flat[:, None] - bg_centers[None]) ** 2).sum(-1).min(1))

    # center prior: subjects are centered in this pipeline's inputs
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    center = np.exp(-(((yy / H - 0.5) / 0.35) ** 2
                      + ((xx / W - 0.5) / 0.35) ** 2)).reshape(-1)

    # initial foreground pool: central pixels that the background model
    # explains poorly
    thresh = np.quantile(d_bg, 0.7)
    fg_pool = flat[(d_bg > thresh) & (center > 0.5)]
    if len(fg_pool) < k_fg:
        fg_pool = flat[np.argsort(-d_bg * center)[: max(64, k_fg)]]
    fg_centers = _kmeans(fg_pool, k_fg, seed=1)

    alpha = None
    for _ in range(refine_rounds):
        d_fg = np.sqrt(((flat[:, None] - fg_centers[None]) ** 2).sum(-1).min(1))
        # log-ratio of distances, biased by the center prior
        score = (d_bg - d_fg) / (d_bg + d_fg + 1e-6) + 0.35 * (center - 0.5)
        alpha = (score > 0).astype(np.float32)
        fg_sel, bg_sel = flat[alpha > 0.5], flat[alpha <= 0.5]
        if len(fg_sel) >= k_fg:
            fg_centers = _kmeans(fg_sel, k_fg, seed=1)
        if len(bg_sel) >= k_bg:
            bg_centers = _kmeans(bg_sel, k_bg, seed=0)
            d_bg = np.sqrt(((flat[:, None] - bg_centers[None]) ** 2)
                           .sum(-1).min(1))

    alpha = alpha.reshape(H, W)
    alpha = _fill_interior_background(alpha)
    alpha = _guided_filter(img, alpha, r=max(4, min(H, W) // 32))
    return np.clip(alpha, 0.0, 1.0)


def _fill_interior_background(alpha: np.ndarray) -> np.ndarray:
    """True background is connected to the image border; any 'background'
    region that is fully enclosed by foreground (eyes, teeth, shadowed
    nostrils — dark features the color model confuses with a dark backdrop)
    is a hole and belongs to the subject. Pure connectivity, no color."""
    try:
        from scipy import ndimage
    except ImportError:  # pragma: no cover - scipy is baked into the image
        return alpha
    bg = alpha <= 0.5
    labels, n = ndimage.label(bg)
    if n == 0:
        return alpha
    border_labels = np.unique(
        np.concatenate([labels[0], labels[-1], labels[:, 0], labels[:, -1]])
    )
    hole = bg & ~np.isin(labels, border_labels[border_labels > 0])
    out = alpha.copy()
    out[hole] = 1.0
    return out


def matte(img_uint8: np.ndarray, backend: str = "auto") -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W, 4) uint8 RGBA (the reference
    BackgroundRemoval __call__ contract, generate_face.py:63-69)."""
    if backend not in ("auto", "native", "none"):
        raise ValueError(f"unknown matting backend {backend!r}")
    if backend == "none":
        alpha = np.full(img_uint8.shape[:2], 255, np.uint8)
        return np.dstack([img_uint8, alpha])
    if backend == "auto":
        out = _external_matte(img_uint8)
        if out is not None:
            return out
    img = img_uint8.astype(np.float32) / 255.0
    # run the color models at reduced resolution, refine at full
    scale = max(1, min(img.shape[:2]) // 256)
    small = img[::scale, ::scale]
    alpha_s = estimate_alpha(small)
    if scale > 1:
        alpha = np.kron(alpha_s, np.ones((scale, scale), np.float32))
        alpha = alpha[: img.shape[0], : img.shape[1]]
        pady, padx = img.shape[0] - alpha.shape[0], img.shape[1] - alpha.shape[1]
        if pady or padx:
            alpha = np.pad(alpha, ((0, pady), (0, padx)), mode="edge")
        alpha = _guided_filter(img, alpha, r=max(4, min(img.shape[:2]) // 64))
    else:
        alpha = alpha_s
    return np.dstack([img_uint8, np.uint8(np.clip(alpha, 0, 1) * 255)])


def _external_matte(img_uint8: np.ndarray):
    """carvekit / rembg when available (the reference's own backend)."""
    try:
        from carvekit.api.high import HiInterface  # type: ignore
        from PIL import Image

        interface = HiInterface(object_type="object", device="cpu",
                                batch_size_seg=1, batch_size_matting=1)
        return np.asarray(interface([Image.fromarray(img_uint8)])[0])
    except Exception:
        pass
    try:
        import rembg  # type: ignore

        return np.asarray(rembg.remove(img_uint8))
    except Exception:
        return None
