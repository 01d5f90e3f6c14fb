"""Stable Diffusion KL-f8 autoencoder (frozen first stage), channels-first.

Counterpart of the JAX package's `models/vae.py`: ch 128, ch_mult
(1, 2, 4, 4), 2 res blocks, z=4 with double_z, mid attention only,
GroupNorm eps 1e-6, SD's asymmetric (0, 1) pad before each stride-2 conv.
Images are (B, 3, H, W) in [-1, 1]; latents (B, 4, H/8, W/8) unscaled (the
caller applies the 0.18215 factor).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from morphablediffusion_torch.models.layers import Conv2d, GroupNorm, nearest_upsample_2d


class VAEResnetBlock(nn.Module):
    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__()
        self.norm1 = GroupNorm(32, cin, epsilon=1e-6, act="silu")
        self.conv1 = Conv2d(cin, cout, 3, dtype=dtype)
        self.norm2 = GroupNorm(32, cout, epsilon=1e-6, act="silu")
        self.conv2 = Conv2d(cout, cout, 3, dtype=dtype)
        self.nin_shortcut = (Conv2d(cin, cout, 1, padding=0, dtype=dtype)
                             if cin != cout else None)

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head spatial self-attention (SDPA, as the JAX package uses
    jax.nn.dot_product_attention here)."""

    def __init__(self, ch, dtype=torch.float32):
        super().__init__()
        self.norm = GroupNorm(32, ch, epsilon=1e-6)
        self.q = Conv2d(ch, ch, 1, padding=0, dtype=dtype)
        self.k = Conv2d(ch, ch, 1, padding=0, dtype=dtype)
        self.v = Conv2d(ch, ch, 1, padding=0, dtype=dtype)
        self.proj_out = Conv2d(ch, ch, 1, padding=0, dtype=dtype)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)
        tok = lambda t: t.reshape(B, 1, C, H * W).transpose(-1, -2)  # (B, 1, HW, C)
        out = F.scaled_dot_product_attention(tok(self.q(h)), tok(self.k(h)), tok(self.v(h)))
        out = out.transpose(-1, -2).reshape(B, C, H, W)
        return x + self.proj_out(out)


class Encoder(nn.Module):
    def __init__(self, ch=128, ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks=2,
                 z_channels=4, double_z=True, dtype=torch.float32):
        super().__init__()
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        self.conv_in = Conv2d(3, ch, 3, dtype=dtype)
        cin = ch
        for level, mult in enumerate(self.ch_mult):
            cout = ch * mult
            for i in range(num_res_blocks):
                self.add_module(f"down_{level}_block_{i}", VAEResnetBlock(cin, cout, dtype))
                cin = cout
            if level != len(self.ch_mult) - 1:
                self.add_module(f"down_{level}_downsample",
                                Conv2d(cout, cout, 3, stride=2, padding=0, dtype=dtype))
        self.mid_block_1 = VAEResnetBlock(cin, cin, dtype)
        self.mid_attn_1 = VAEAttnBlock(cin, dtype)
        self.mid_block_2 = VAEResnetBlock(cin, cin, dtype)
        self.norm_out = GroupNorm(32, cin, epsilon=1e-6, act="silu")
        self.conv_out = Conv2d(cin, z_channels * (2 if double_z else 1), 3, dtype=dtype)

    def forward(self, x):
        h = self.conv_in(x)
        for level in range(len(self.ch_mult)):
            for i in range(self.num_res_blocks):
                h = getattr(self, f"down_{level}_block_{i}")(h)
            if level != len(self.ch_mult) - 1:
                h = getattr(self, f"down_{level}_downsample")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        return self.conv_out(self.norm_out(h))


class Decoder(nn.Module):
    def __init__(self, ch=128, ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks=2,
                 z_channels=4, out_ch=3, dtype=torch.float32):
        super().__init__()
        self.ch_mult = tuple(ch_mult)
        self.num_res_blocks = num_res_blocks
        block_in = ch * self.ch_mult[-1]
        self.conv_in = Conv2d(z_channels, block_in, 3, dtype=dtype)
        self.mid_block_1 = VAEResnetBlock(block_in, block_in, dtype)
        self.mid_attn_1 = VAEAttnBlock(block_in, dtype)
        self.mid_block_2 = VAEResnetBlock(block_in, block_in, dtype)
        cin = block_in
        for level in reversed(range(len(self.ch_mult))):
            cout = ch * self.ch_mult[level]
            for i in range(num_res_blocks + 1):
                self.add_module(f"up_{level}_block_{i}", VAEResnetBlock(cin, cout, dtype))
                cin = cout
            if level != 0:
                self.add_module(f"up_{level}_upsample", Conv2d(cout, cout, 3, dtype=dtype))
        self.norm_out = GroupNorm(32, cin, epsilon=1e-6, act="silu")
        self.conv_out = Conv2d(cin, out_ch, 3, dtype=dtype)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        for level in reversed(range(len(self.ch_mult))):
            for i in range(self.num_res_blocks + 1):
                h = getattr(self, f"up_{level}_block_{i}")(h)
            if level != 0:
                h = getattr(self, f"up_{level}_upsample")(nearest_upsample_2d(h))
        return self.conv_out(self.norm_out(h))


class AutoencoderKL(nn.Module):
    """encode_moments -> (mean, logvar); decode."""

    def __init__(self, embed_dim=4, ch=128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks=2, dtype=torch.float32):
        super().__init__()
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, embed_dim, True, dtype)
        self.decoder = Decoder(ch, ch_mult, num_res_blocks, embed_dim, 3, dtype)
        self.quant_conv = Conv2d(2 * embed_dim, 2 * embed_dim, 1, padding=0, dtype=dtype)
        self.post_quant_conv = Conv2d(embed_dim, embed_dim, 1, padding=0, dtype=dtype)

    def encode_moments(self, x):
        """x: (B, 3, H, W) in [-1, 1] -> (mean, logvar) each (B, 4, H/8, W/8)."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


def sample_diagonal_gaussian(mean, logvar, eps):
    """A posterior sample mean + exp(logvar / 2) * eps, with the standard
    normal draw eps in the mean's dtype, as the JAX package draws it
    (`models/vae.py::sample_diagonal_gaussian`)."""
    return mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)
