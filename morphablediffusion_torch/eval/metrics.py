"""Evaluation metrics (no lpips/torchmetrics/dlib dependencies).

The PyTorch port's own copy of the JAX package's `eval/metrics.py`. The
reference's metric definitions (eval/eval_2d_facescape.py:110-139):
  * SSIM between generated and (alpha-masked) ground-truth views
  * LPIPS (VGG): `eval/lpips_vgg.py`
  * FID: Frechet distance over pluggable features (InceptionV3 in the
    reference; `clip_features` here)
  * PCK@0.2: 68-keypoint accuracy, threshold 0.2 x intercanthal distance
    (:135-137)
  * Re-ID rate: fraction of views whose face-descriptor distance to the
    ground truth is below a threshold (:97-108)

The metric functions take numpy arrays; images are float in [0, 1], shape
(..., H, W, C). Only `clip_features` runs a network, on the encoder's device.
The one change from the JAX copy: `frechet_distance` calls scipy's `sqrtm`
without `disp` (newer scipy removed it; the value is the same).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import linalg as scipy_linalg
from scipy.ndimage import uniform_filter


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10 * np.log10(data_range**2 / mse))


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0,
         win_size: int = 7) -> float:
    """Mean SSIM with uniform window (scikit-image default semantics)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    if a.ndim == 3:  # (H, W, C): average over channels
        return float(
            np.mean([ssim(a[..., c], b[..., c], data_range, win_size)
                     for c in range(a.shape[-1])])
        )
    K1, K2 = 0.01, 0.03
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    f = lambda x: uniform_filter(x, size=win_size)
    mu_a, mu_b = f(a), f(b)
    NP = win_size**2
    cov_norm = NP / (NP - 1)
    var_a = cov_norm * (f(a * a) - mu_a**2)
    var_b = cov_norm * (f(b * b) - mu_b**2)
    cov = cov_norm * (f(a * b) - mu_a * mu_b)
    num = (2 * mu_a * mu_b + C1) * (2 * cov + C2)
    den = (mu_a**2 + mu_b**2 + C1) * (var_a + var_b + C2)
    s = num / den
    pad = (win_size - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray,
                     eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussian fits of feature sets (N, D)."""
    mu1, mu2 = feats_a.mean(0), feats_b.mean(0)
    s1 = np.cov(feats_a, rowvar=False)
    s2 = np.cov(feats_b, rowvar=False)
    diff = mu1 - mu2
    # the JAX package passes disp=False, which newer scipy no longer takes;
    # the default returns the same root (and only the root)
    covmean = scipy_linalg.sqrtm(s1 @ s2)
    if not np.isfinite(covmean).all():
        offset = np.eye(s1.shape[0]) * eps
        covmean = scipy_linalg.sqrtm((s1 + offset) @ (s2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2 * np.trace(covmean))


def pck(pred_kpts: np.ndarray, gt_kpts: np.ndarray,
        threshold: float = 0.2) -> float:
    """PCK with interocular normalization (eval_2d_facescape.py:135-137).

    pred/gt: (N, 68, 2). The reference normalizes by the INTERCANTHAL
    distance — inner eye corners, kpts 39 and 42 (`gt_kpts_all[:, 39] -
    gt_kpts_all[:, 42]`) — not the outer 36/45 pair.
    """
    interocular = np.linalg.norm(gt_kpts[:, 39] - gt_kpts[:, 42], axis=-1)
    dist = np.linalg.norm(pred_kpts - gt_kpts, axis=-1)  # (N, 68)
    ok = dist < threshold * interocular[:, None]
    return float(ok.mean())


def reid_rate(descriptor_distances: np.ndarray, threshold: float = 0.6) -> float:
    """Fraction of generated views re-identified as the input person
    (eval_2d_facescape.py:97-108)."""
    return float((np.asarray(descriptor_distances) < threshold).mean())


def masked(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """White-composite by GT alpha before comparison (eval_2d_facescape.py:95)."""
    mask = mask.reshape(mask.shape[:2] + (1,))
    return img * mask + (1.0 - mask)


@torch.no_grad()
def clip_features(images: np.ndarray, encoder) -> np.ndarray:
    """FID features from the model's CLIP tower (`models.clip.CLIPImageEncoder`,
    fp32, on its own device): (N, H, W, 3) in [0, 1] -> (N, output_dim)."""
    device = next(encoder.parameters()).device
    x = torch.as_tensor(np.asarray(images, np.float32), device=device).permute(0, 3, 1, 2)
    return encoder(x * 2.0 - 1.0)[:, 0].float().cpu().numpy()
