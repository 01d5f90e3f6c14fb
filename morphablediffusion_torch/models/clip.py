"""OpenAI CLIP ViT-L/14 image tower (frozen conditioning encoder).

Counterpart of the JAX package's `models/clip.py`: 14x14 patchify conv (no
bias) -> class token + positional embedding -> pre-LN -> pre-norm blocks
(QuickGELU MLP x4) -> post-LN on the class token -> projection (no bias),
returning (B, 1, output_dim). LayerNorm eps is 1e-6 throughout, as flax's
default is.

`preprocess_clip` reproduces `jax.image.resize(..., "cubic")` exactly: Keys
cubic (a = -0.5), half-pixel centres, and antialiasing when downscaling
(jax's default, so the 256 -> 224 resize is low-pass filtered), as two
separable weight matrices.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from morphablediffusion_torch.models.layers import Linear, LayerNorm

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _keys_cubic(x):
    f32 = np.float32
    out = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    out = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), out)
    return np.where(x >= 2.0, f32(0.0), out).astype(f32)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) matrix of jax.image.resize's cubic resampling with
    antialias=True (jax/_src/image/scale.py compute_weight_mat), computed in
    float32 with the same operations so that the weights agree bit for bit."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    valid = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(valid[None, :], w, f32(0.0))
    return np.ascontiguousarray(w.T, dtype=f32)


def preprocess_clip(x, size: int = 224):
    """x: (B, 3, H, W) in [-1, 1] -> (B, 3, size, size) CLIP-normalized, fp32."""
    B, C, H, W = x.shape
    wy = torch.as_tensor(resize_weights(H, size), device=x.device)
    wx = torch.as_tensor(resize_weights(W, size), device=x.device)
    y = torch.einsum("oh,bchw,pw->bcop", wy, x.float(), wx)
    y = (y + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(CLIP_STD, device=x.device)[None, :, None, None]
    return (y - mean) / std


class CLIPAttention(nn.Module):
    def __init__(self, width, num_heads, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj = Linear(width, 3 * width, dtype=dtype)
        self.out_proj = Linear(width, width, dtype=dtype)

    def forward(self, x):
        B, L, C = x.shape
        hd = C // self.num_heads
        q, k, v = self.in_proj(x).reshape(B, L, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.out_proj(out.transpose(1, 2).reshape(B, L, C))


class CLIPBlock(nn.Module):
    def __init__(self, width, num_heads, dtype=torch.float32):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = CLIPAttention(width, num_heads, dtype)
        self.ln_2 = LayerNorm(width)
        self.mlp_fc = Linear(width, 4 * width, dtype=dtype)
        self.mlp_proj = Linear(4 * width, width, dtype=dtype)

    def forward(self, x):
        d = x.dtype
        x = x + self.attn(self.ln_1(x).to(d))
        h = self.mlp_fc(self.ln_2(x).to(d))
        h = h * torch.sigmoid(1.702 * h)  # QuickGELU
        return x + self.mlp_proj(h)


class CLIPImageEncoder(nn.Module):
    """ViT-L/14 image tower. forward takes (B, 3, H, W) images in [-1, 1] and
    returns (B, 1, output_dim) fp32."""

    def __init__(self, width=1024, layers=24, num_heads=16, patch_size=14,
                 output_dim=768, image_size=224, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layers = layers
        self.image_size = image_size
        n_patches = (image_size // patch_size) ** 2
        self.patch_conv = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(torch.zeros(n_patches + 1, width))
        self.ln_pre = LayerNorm(width)
        for i in range(layers):
            self.add_module(f"block_{i}", CLIPBlock(width, num_heads, dtype))
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(torch.zeros(width, output_dim))

    def forward(self, x):
        dt = self.dtype
        x = preprocess_clip(x, self.image_size).to(dt)
        h = F.conv2d(x, self.patch_conv.weight.to(dt), stride=self.patch_conv.stride)
        B, W = h.shape[:2]
        h = h.flatten(2).transpose(1, 2)  # (B, n_patches, width), row-major patches
        cls = self.class_embedding.to(dt).expand(B, 1, W)
        h = torch.cat([cls, h], dim=1) + self.positional_embedding.to(dt)
        h = self.ln_pre(h).to(dt)
        for i in range(self.layers):
            h = getattr(self, f"block_{i}")(h)
        cls_out = self.ln_post(h[:, 0])
        out = (cls_out @ self.proj.float()).float()
        return out[:, None, :]
