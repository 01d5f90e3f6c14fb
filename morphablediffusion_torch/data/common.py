"""Shared data-pipeline helpers: image loading, vertex padding, batching.

The PyTorch port's own copy of the JAX package's `data/common.py`, with PIL
imported only where an image is loaded. Batches are dicts of numpy arrays
('vertex_mask' marks real vs. padded vertices).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def load_rgba_white(path, image_size: int) -> np.ndarray:
    """RGBA png -> white-composited RGB in [-1, 1], (S, S, 3) float32.

    Matches facescape.py:47-59 load_im/process_im: float composite over
    white, re-quantize to uint8, bicubic resize, scale to [-1, 1].
    """
    from PIL import Image  # only image loading needs PIL

    img = np.asarray(Image.open(path)).astype(np.float32) / 255.0
    if img.shape[-1] == 4:
        mask = img[:, :, 3:]
        rgb = img[:, :, :3] * mask + 1.0 - mask
    else:
        rgb = img[:, :, :3]
    pil = Image.fromarray(np.uint8(rgb * 255.0))
    pil = pil.resize((image_size, image_size), resample=Image.BICUBIC)
    return np.asarray(pil).astype(np.float32) / 255.0 * 2.0 - 1.0


def load_mask(path, image_size: int) -> np.ndarray:
    """Alpha channel resized to (S, S), float32 in [0, 1]."""
    from PIL import Image

    img = np.asarray(Image.open(path))
    alpha = img[..., 3] if img.shape[-1] == 4 else np.full(img.shape[:2], 255, np.uint8)
    pil = Image.fromarray(alpha).resize((image_size, image_size), Image.BILINEAR)
    return np.asarray(pil).astype(np.float32) / 255.0


def pad_vertices(verts: np.ndarray, max_vertices: int):
    """(N, 3) -> ((max, 3), (max,)) with zero padding + mask."""
    n = verts.shape[0]
    if n > max_vertices:
        raise ValueError(
            f"mesh has {n} vertices > max_vertices={max_vertices}; raise "
            "model.max_vertices in the config"
        )
    out = np.zeros((max_vertices, 3), np.float32)
    out[:n] = verts
    mask = np.zeros((max_vertices,), np.float32)
    mask[:n] = 1.0
    return out, mask


def collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-item dicts into a batch along a new leading axis."""
    return {
        k: np.stack([it[k] for it in items], axis=0) for k in items[0].keys()
    }
