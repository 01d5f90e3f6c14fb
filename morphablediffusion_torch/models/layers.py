"""Shared NN building blocks: norms, convs, attention, transformer blocks.

Counterpart of the JAX package's `models/layers.py`. Shapes are
channels-first for feature maps ((B, C, H, W), volumes (B, C, D, H, W)) and
(B, L, C) for token sequences. In memory a 4-D map is NCHW-contiguous or
channels-last, as the op that made it left it (the port's images and
latents are (..., H, W, C), so their maps arrive channels-last, and convs,
adds, pads and GroupNorm keep the layout); volumes are contiguous.

Every module takes a compute `dtype`, the flax `dtype` of its counterpart:
inputs and weights are cast to it (a no-op once the weights are cast for
serving), while norm statistics stay fp32. Parameter names follow the flax
tree (`weights.from_jax_params` maps `kernel`/`scale` onto `weight`).

Numerics kept from the JAX package:
  * LayerNorm eps 1e-6 (flax default), GroupNorm eps 1e-5 unless stated
    (1e-6 in SpatialTransformer.norm and the VAE).
  * GEGLU uses the tanh GELU (flax `nn.gelu` default).
  * `attention` takes the Hopper flash kernel exactly where the JAX code takes
    Pallas flash: min(Lq, Lk) >= 1024 with both divisible by 1024.
  * `int8=True` convs (the JAX package's `Conv8`) serve W8A8 (`ops.int8`)
    with the same parameters, so every checkpoint loads unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from morphablediffusion_torch.ops import flash_attention as flash
from morphablediffusion_torch.ops import group_norm as gn
from morphablediffusion_torch.ops import int8 as q8


class Linear(nn.Linear):
    """nn.Linear computing in `dtype` (flax Dense); applies to the last axis."""

    def __init__(self, in_features, out_features, bias=True, dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)

    def channels(self, x):
        """Apply to dim 1 of a channels-first tensor (a 1x1(x1) conv)."""
        dt = self.dtype
        w = self.weight.to(dt).reshape(self.weight.shape + (1,) * (x.ndim - 2))
        conv = F.conv2d if x.ndim == 4 else F.conv3d
        b = None if self.bias is None else self.bias.to(dt)
        return conv(x.to(dt), w, b)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in `dtype`; padding defaults to (k-1)//2.

    int8=True serves it W8A8 (the JAX package's Conv8): the weight as it is
    stored (bf16 once cast for serving) is quantized once per load and kept
    (`quantized_weight`), the input on every call."""

    def __init__(self, cin, cout, kernel=3, stride=1, padding=None, bias=True,
                 dtype=torch.float32, int8=False):
        pad = (kernel - 1) // 2 if padding is None else padding
        super().__init__(cin, cout, kernel, stride=stride, padding=pad, bias=bias)
        self.dtype = dtype
        self.int8 = int8
        self._quantized = None  # (weight version key, int8 weight, scales)

    @torch.no_grad()
    def quantized_weight(self):
        """(int8 weight, fp32 per-channel scales) of the current weight,
        recomputed only after the weight was loaded, cast or moved."""
        w = self.weight
        key = (w.data_ptr(), w._version, w.dtype, w.device)
        if self._quantized is None or self._quantized[0] != key:
            self._quantized = (key, *q8.quantize_weight_per_channel(w.detach()))
        return self._quantized[1:]

    def forward(self, x):
        if self.int8:
            w8, sw = self.quantized_weight()
            return q8.conv2d_w8a8(x, w8, sw, self.bias, self.stride[0], self.padding[0],
                                  out_dtype=self.dtype)
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), b)


class Conv3d(nn.Conv3d):
    """nn.Conv3d computing in `dtype`; padding defaults to (k-1)//2."""

    def __init__(self, cin, cout, kernel=3, stride=1, padding=None, bias=True,
                 dtype=torch.float32):
        pad = (kernel - 1) // 2 if padding is None else padding
        super().__init__(cin, cout, kernel, stride=stride, padding=pad, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), b)


class ConvTranspose3dTorch(nn.ConvTranspose3d):
    """ConvTranspose3d(k=3, stride 2, padding 1, output_padding 1): exactly 2x
    every spatial dim. The JAX package stores this kernel conv-style and
    spatially flipped; `weights.from_jax_params` undoes the flip."""

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__(cin, cout, 3, stride=2, padding=1, output_padding=1)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        return F.conv_transpose3d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                                  stride=2, padding=1, output_padding=1)


class GroupNorm(nn.Module):
    """GroupNorm with fp32 statistics and an optional fused activation; the
    output keeps the input dtype. `shift` (B, C) normalizes x + shift without
    materializing it (the ResBlock time-embedding path). On the card it runs
    the K4 kernel (`ops.group_norm`)."""

    def __init__(self, num_groups, channels, epsilon=1e-5, act: Optional[str] = None):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.act = act
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, shift=None):
        if x.is_cuda and gn.kernel_layout(x) is None:
            # the kernel takes x in the layout it comes in, NCHW-contiguous
            # (any rank) or a channels-last 4-D map, and returns that layout;
            # any other strides are copied to NCHW. The plain version on the
            # CPU takes any layout, and a copy would move the rounding of its
            # backward.
            x = x.contiguous()
        return gn.group_norm_shifted(x, shift, self.weight, self.bias, self.num_groups,
                                     self.epsilon, self.act)


class LayerNorm(nn.LayerNorm):
    """flax nn.LayerNorm(dtype=float32): eps 1e-6, fp32 math; the caller casts."""

    def __init__(self, dim, eps=1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps)


def nearest_upsample_2d(x):
    """2x nearest-neighbour upsample of (B, C, H, W)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Upsample(nn.Module):
    """Nearest 2x + 3x3 conv."""

    def __init__(self, channels, dtype=torch.float32, int8=False):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, dtype=dtype, int8=int8)

    def forward(self, x):
        return self.conv(nearest_upsample_2d(x))


class Downsample(nn.Module):
    """Stride-2 3x3 conv."""

    def __init__(self, channels, dtype=torch.float32, int8=False):
        super().__init__()
        self.op = Conv2d(channels, channels, 3, stride=2, dtype=dtype, int8=int8)

    def forward(self, x):
        return self.op(x)


class ResBlock(nn.Module):
    """GN(32)+SiLU -> conv3x3 -> +emb_proj(silu(emb)) folded into GN+SiLU ->
    conv3x3, with a 1x1 (or identity) skip; int8 serves the convs W8A8."""

    def __init__(self, cin, cout, emb_dim, dtype=torch.float32, int8=False):
        super().__init__()
        self.norm_in = GroupNorm(32, cin, act="silu")
        self.conv_in = Conv2d(cin, cout, 3, dtype=dtype, int8=int8)
        self.emb_proj = Linear(emb_dim, cout, dtype=dtype)
        self.norm_out = GroupNorm(32, cout, act="silu")
        self.conv_out = Conv2d(cout, cout, 3, dtype=dtype, int8=int8)
        if cin != cout:
            self.skip = Conv2d(cin, cout, 1, padding=0, dtype=dtype, int8=int8)
        else:
            self.skip = None

    def forward(self, x, emb):
        h = self.conv_in(self.norm_in(x))
        emb_out = self.emb_proj(F.silu(emb))
        h = self.conv_out(self.norm_out(h, shift=emb_out))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


def flash_ok(Lq: int, Lk: int) -> bool:
    """Whether attention over Lq queries and Lk keys takes the flash kernel
    (K2): both at least 1024 and multiples of 1024, the JAX package's gate."""
    return min(Lq, Lk) >= 1024 and Lq % 1024 == 0 and Lk % 1024 == 0


def attention(q, k, v, num_heads: int):
    """Multi-head attention core. q (B, Lq, H*hd), k/v (B, Lk, H*hd) ->
    (B, Lq, H*hd). Where `flash_ok` it runs the flash kernel (plain version
    on the CPU); elsewhere SDPA, which is what jax.nn.dot_product_attention
    is in the JAX package."""
    B, Lq, inner = q.shape
    Lk = k.shape[1]
    if flash_ok(Lq, Lk):
        return flash.flash_attention(q, k, v, num_heads)
    hd = inner // num_heads
    split = lambda t, L: t.reshape(B, L, num_heads, hd).transpose(1, 2)
    out = F.scaled_dot_product_attention(split(q, Lq), split(k, Lk), split(v, Lk))
    return out.transpose(1, 2).reshape(B, Lq, inner)


class CrossAttention(nn.Module):
    """Self-attention when context is None, else cross-attention."""

    def __init__(self, query_dim, context_dim, num_heads, head_dim, dtype=torch.float32):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads = num_heads
        self.to_q = Linear(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Linear(context_dim, inner, bias=False, dtype=dtype)
        self.to_v = Linear(context_dim, inner, bias=False, dtype=dtype)
        self.to_out = Linear(inner, query_dim, dtype=dtype)

    def forward(self, x, context=None):
        context = x if context is None else context
        if context.shape[1] == 1:
            # Single key (the (B, 1, 768) CLIP context): softmax over one logit
            # is exactly 1, so the output is to_out(to_v(context)) for every
            # query; to_q, the attention core and the per-query to_out cancel.
            out = self.to_out(self.to_v(context))
            return out.expand(x.shape[:-1] + (out.shape[-1],))
        out = attention(self.to_q(x), self.to_k(context), self.to_v(context),
                        self.num_heads)
        return self.to_out(out)


class GEGLUFeedForward(nn.Module):
    """GEGLU MLP, mult 4, tanh GELU on the gate."""

    def __init__(self, dim, dtype=torch.float32):
        super().__init__()
        self.proj_in = Linear(dim, dim * 8, dtype=dtype)
        self.proj_out = Linear(dim * 4, dim, dtype=dtype)

    def forward(self, x):
        h, gate = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(h * F.gelu(gate, approximate="tanh"))


class BasicTransformerBlock(nn.Module):
    """Pre-LN self-attention -> cross-attention(context) -> GEGLU FF."""

    def __init__(self, dim, context_dim, num_heads, head_dim, dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = CrossAttention(dim, dim, num_heads, head_dim, dtype)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, context_dim, num_heads, head_dim, dtype)
        self.norm3 = LayerNorm(dim)
        self.ff = GEGLUFeedForward(dim, dtype)

    def forward(self, x, context):
        d = x.dtype
        x = self.attn1(self.norm1(x).to(d)) + x
        x = self.attn2(self.norm2(x).to(d), context) + x
        return self.ff(self.norm3(x).to(d)) + x


class SpatialTransformer(nn.Module):
    """GN(32, eps 1e-6) -> 1x1 in -> transformer blocks on (B, HW, C) ->
    1x1 out + skip (int8: both 1x1s W8A8). x: (B, C, H, W)."""

    def __init__(self, channels, num_heads, head_dim, depth, context_dim,
                 dtype=torch.float32, int8=False):
        super().__init__()
        inner = num_heads * head_dim
        self.depth = depth
        self.norm = GroupNorm(32, channels, epsilon=1e-6)
        self.proj_in = Conv2d(channels, inner, 1, padding=0, dtype=dtype, int8=int8)
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(
                inner, context_dim, num_heads, head_dim, dtype))
        self.proj_out = Conv2d(inner, channels, 1, padding=0, dtype=dtype, int8=int8)

    def forward(self, x, context):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x))
        inner = h.shape[1]
        h = h.permute(0, 2, 3, 1).reshape(B, H * W, inner)
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, context)
        h = h.reshape(B, H, W, inner).permute(0, 3, 1, 2)
        return self.proj_out(h) + x


class TimestepMLP(nn.Module):
    """Linear -> SiLU -> Linear time-embedding MLP."""

    def __init__(self, in_features, features, dtype=torch.float32):
        super().__init__()
        self.dense0 = Linear(in_features, features, dtype=dtype)
        self.dense1 = Linear(features, features, dtype=dtype)

    def forward(self, t_emb):
        return self.dense1(F.silu(self.dense0(t_emb)))
