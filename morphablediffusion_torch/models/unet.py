"""SD-style denoiser UNet with depth-wise 3D-aware attention.

Counterpart of the JAX package's `models/unet.py`. Feature maps are
channels-first (B, C, H, W); frustum volumes are (B, C, D, H, W) and arrive
in `source_dict` keyed by their width.

A DepthTransformer takes the fused context chain
(`ops.depth_attention.depth_attention_ctx`, kernel K1) where `fused_ok`
says so, the JAX package's gate on the TPU (`models/unet.py::_fused_ok`):
inner width a multiple of 128, and H*W >= 8 at serving or W >= 8 in
training. Every other block takes the unfused module chain (proj_context ->
GroupNorm(relu) -> to_k/to_v -> `depth_attention`, kernel K3). Under
`Config()` that is every block at serving and the W=4 middle block in
training. On the card the kernels run inside autograd Functions; on the
CPU their plain versions.

`w8a8=True` serves the internal convs W8A8 (`ops.int8`): the ResBlocks',
Up/Downsample's, the SpatialTransformers' 1x1s and the DepthTransformers'
proj_in and proj_out convs; `input_conv` and `out_conv` stay in `dtype`.
The parameters are the same, so every checkpoint loads unchanged.

`remat=True` (the config's `use_checkpoint`) recomputes every ResBlock,
SpatialTransformer and DepthTransformer in the backward pass
(`torch.utils.checkpoint`, non-reentrant). It is separate from `train`.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from morphablediffusion_torch.models.layers import (
    Conv2d,
    Downsample,
    GroupNorm,
    Linear,
    ResBlock,
    SpatialTransformer,
    TimestepMLP,
    Upsample,
)
from morphablediffusion_torch.ops import depth_attention as da
from morphablediffusion_torch.ops.embeddings import timestep_embedding
from morphablediffusion_torch.utils.spans import span

# decoder output block -> index of the frustum width its DepthTransformer
# reads (width = latent >> index); the middle block reads index 3
OUT_COND_CTX = {3: 2, 4: 2, 5: 1, 6: 1, 7: 1, 8: 0, 9: 0, 10: 0, 11: 0}
MIDDLE_COND_CTX = 3
# the fused depth-context chain needs an inner width that is a multiple of
# FUSED_INNER_MULTIPLE, and at least SERVING_FUSED_MIN_PIXELS pixels at
# serving or a frustum width of TRAIN_FUSED_MIN_WIDTH in training
FUSED_INNER_MULTIPLE = 128
SERVING_FUSED_MIN_PIXELS = 8
TRAIN_FUSED_MIN_WIDTH = 8


def fused_ok(num_heads: int, head_dim: int, H: int, W: int, train: bool) -> bool:
    """Whether a DepthTransformer of num_heads x head_dim on an H x W
    frustum takes the fused chain (K1): the JAX package's `_fused_ok` on the
    TPU, as a function of shapes."""
    if num_heads * head_dim % FUSED_INNER_MULTIPLE:
        return False
    if train:
        return W >= TRAIN_FUSED_MIN_WIDTH
    return H * W >= SERVING_FUSED_MIN_PIXELS


class DepthAttention(nn.Module):
    """Per-pixel attention over the frustum depth axis.

    x: (B, inner, H, W) pre-projected queries' source; context: (B, Cc, D, H,
    W) -> (B, inner, H, W). The projections are Linear layers over channels.
    """

    def __init__(self, num_heads, head_dim, ctx_dim, dtype=torch.float32):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads = num_heads
        self.to_q = Linear(inner, inner, bias=False, dtype=dtype)
        self.to_k = Linear(ctx_dim, inner, bias=False, dtype=dtype)
        self.to_v = Linear(ctx_dim, inner, bias=False, dtype=dtype)
        self.to_out = Linear(inner, inner, bias=False, dtype=dtype)

    def forward(self, x, context):
        # the kernel takes contiguous NCHW / NCDHW; cuDNN may hand back
        # channels-last maps
        q = self.to_q.channels(x).contiguous()
        k = self.to_k.channels(context).contiguous()
        v = self.to_v.channels(context).contiguous()
        return self.to_out.channels(da.depth_attention(q, k, v, self.num_heads))


class DepthTransformer(nn.Module):
    """proj_in(2D) + proj_context(3D) -> DepthAttention -> zero-out conv + skip.

    x: (B, in_ch, H, W); context: (Bc, ctx_dim, D, H, W) with Bc == B, or
    Bc == B/2 under the CFG-doubled contract (`cfg_doubled=True`: the second
    half of x is the unconditional branch, whose context is all zeros).
    int8 serves proj_in_conv and the proj_out convs W8A8.
    """

    def __init__(self, num_heads, head_dim, in_channels, out_channels, ctx_dim,
                 dtype=torch.float32, int8=False):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads = num_heads
        self.inner = inner
        self.proj_in_conv = Conv2d(in_channels, inner, 1, padding=0, dtype=dtype, int8=int8)
        self.proj_in_norm = GroupNorm(8, inner, act="silu")
        self.proj_context_conv = Linear(ctx_dim, ctx_dim, bias=False, dtype=dtype)
        self.proj_context_norm = GroupNorm(8, ctx_dim, act="relu")
        self.depth_attn = DepthAttention(num_heads, head_dim, ctx_dim, dtype)
        self.proj_out_norm0 = GroupNorm(8, inner, act="relu")
        self.proj_out_conv0 = Conv2d(inner, inner, 3, bias=False, dtype=dtype, int8=int8)
        self.proj_out_norm1 = GroupNorm(8, inner, act="relu")
        self.proj_out_conv1 = Conv2d(inner, out_channels, 3, bias=False, dtype=dtype,
                                     int8=int8)

    def fused(self, context, train: bool) -> bool:
        """Whether this block takes the fused chain on `context`."""
        return fused_ok(self.num_heads, self.inner // self.num_heads, *context.shape[-2:],
                        train)

    def forward(self, x, context, cfg_doubled: bool = False, train: bool = False,
                moments=None):
        """moments: ctx_moments(context), shared by the blocks that read the
        same frustum width, or None to compute it here (fused chain only)."""
        B, Bc = x.shape[0], context.shape[0]
        if cfg_doubled and B != 2 * Bc:
            raise ValueError(f"cfg_doubled expects batch {2 * Bc} (2x context), got {B}")
        if not cfg_doubled and B != Bc:
            raise ValueError(f"batch mismatch: x {B} vs context {Bc} (pass "
                             "cfg_doubled=True for the CFG doubled-batch path)")
        xc = x[:Bc] if cfg_doubled else x
        h = self.proj_in_norm(self.proj_in_conv(xc))

        att = self.depth_attn
        if not self.fused(context, train):
            c = self.proj_context_norm(self.proj_context_conv.channels(context))
            h = att(h, c)
        else:
            mean_x, m2 = da.ctx_moments(context) if moments is None else moments
            dt = att.to_q.dtype
            # the kernel takes contiguous NCHW / NCDHW; cuDNN may hand back
            # channels-last maps (SpatialTransformer's permute feeds them)
            out = da.depth_attention_ctx(
                att.to_q.channels(h).contiguous(), context.to(dt).contiguous(), mean_x, m2,
                self.proj_context_conv.weight.to(dt), self.proj_context_norm.weight,
                self.proj_context_norm.bias, att.to_k.weight.to(dt),
                att.to_v.weight.to(dt), self.num_heads)
            h = att.to_out.channels(out)

        if cfg_doubled:
            # Zero context: GroupNorm(0) = beta exactly, so k/v are constant
            # over depth and a softmax over one depth is exactly 1; the
            # unconditional output is to_out(to_v(relu(beta))) for every pixel.
            zero = torch.zeros(1, context.shape[1], dtype=context.dtype,
                               device=context.device)
            c_u = self.proj_context_norm(self.proj_context_conv(zero))  # (1, Cc)
            h_u = att.to_out(att.to_v(c_u))  # (1, inner)
            h_u = h_u.to(h.dtype)[:, :, None, None].expand((B - Bc,) + h.shape[1:])
            h = torch.cat([h, h_u], dim=0)

        h = self.proj_out_conv0(self.proj_out_norm0(h))
        h = self.proj_out_conv1(self.proj_out_norm1(h))
        return h + x


class DepthWiseUNet(nn.Module):
    """The full denoiser. volume_dims: frustum channels per width (w, w/2,
    w/4, w/8). Module names follow the flax tree."""

    def __init__(self, in_channels=8, model_channels=320, out_channels=4,
                 num_res_blocks=2, attention_ds: Sequence[int] = (1, 2, 4),
                 channel_mult: Sequence[int] = (1, 2, 4, 4), num_heads=8,
                 transformer_depth=1, context_dim=768,
                 volume_dims: Sequence[int] = (64, 128, 256, 512),
                 dtype=torch.float32, w8a8: bool = False):
        super().__init__()
        mc = model_channels
        self.model_channels = mc
        self.dtype = dtype
        self.num_res_blocks = num_res_blocks
        self.attention_ds = tuple(attention_ds)
        self.channel_mult = tuple(channel_mult)
        self.time_embed = TimestepMLP(mc, mc * 4, dtype)
        emb = mc * 4

        def res(cin, cout):
            return ResBlock(cin, cout, emb, dtype, int8=w8a8)

        def st(ch):
            return SpatialTransformer(ch, num_heads, ch // num_heads,
                                      transformer_depth, context_dim, dtype, int8=w8a8)

        def depth_tf(ctx_dim, cin, cout):
            # heads=4, dim_head=ctx//2
            return DepthTransformer(4, ctx_dim // 2, cin, cout, ctx_dim, dtype, int8=w8a8)

        self.input_conv = Conv2d(in_channels, mc, 3, dtype=dtype)
        hs = [mc]
        ch_in, ds, block = mc, 1, 1
        for level, mult in enumerate(self.channel_mult):
            ch = mult * mc
            for _ in range(num_res_blocks):
                self.add_module(f"in_{block}_res", res(ch_in, ch))
                if ds in self.attention_ds:
                    self.add_module(f"in_{block}_attn", st(ch))
                ch_in = ch
                hs.append(ch)
                block += 1
            if level != len(self.channel_mult) - 1:
                self.add_module(f"in_{block}_down", Downsample(ch, dtype, int8=w8a8))
                hs.append(ch)
                block += 1
                ds *= 2

        ch = self.channel_mult[-1] * mc
        self.mid_res0 = res(ch_in, ch)
        self.mid_attn = st(ch)
        self.mid_res1 = res(ch, ch)
        self.middle_conditions = depth_tf(volume_dims[MIDDLE_COND_CTX], ch, ch)
        ch_in = ch

        # decoder; DepthTransformers after output blocks 3..11
        block = 0
        for level, mult in list(enumerate(self.channel_mult))[::-1]:
            ch = mult * mc
            for i in range(num_res_blocks + 1):
                self.add_module(f"out_{block}_res", res(ch_in + hs.pop(), ch))
                if ds in self.attention_ds:
                    self.add_module(f"out_{block}_attn", st(ch))
                if level and i == num_res_blocks:
                    self.add_module(f"out_{block}_up", Upsample(ch, dtype, int8=w8a8))
                    ds //= 2
                if block in OUT_COND_CTX:
                    cd = volume_dims[OUT_COND_CTX[block]]
                    self.add_module(f"out_{block}_cond", depth_tf(cd, ch, ch))
                ch_in = ch
                block += 1

        self.out_norm = GroupNorm(32, ch_in, act="silu")
        self.out_conv = Conv2d(ch_in, out_channels, 3, dtype=dtype)

    def forward(self, x, timesteps, context, source_dict: Dict[int, torch.Tensor],
                cfg_doubled: bool = False, train: bool = False, remat: bool = False):
        """x: (B, in_ch, H, W); timesteps: (B,); context: (B, M, 768);
        source_dict: {width: (B or B/2, C, D, width, width)}. cfg_doubled
        declares the CFG doubled-batch contract (conditional half first);
        train selects the training gate of the DepthTransformers; remat
        recomputes the blocks in the backward pass. Returns fp32
        (B, out_ch, H, W)."""
        with span("md.unet"):
            return self._forward(x, timesteps, context, source_dict, cfg_doubled, train, remat)

    def _forward(self, x, timesteps, context, source_dict, cfg_doubled, train, remat):
        dt = self.dtype
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels).to(dt))
        x = x.to(dt)
        context = context.to(dt)
        moments = {}  # ctx_moments per frustum width, for the blocks that fuse

        def call(name, *args):
            block = getattr(self, name)
            if remat and torch.is_grad_enabled():
                return checkpoint(block, *args, use_reentrant=False)
            return block(*args)

        def run(name, *args):  # a ResBlock or a SpatialTransformer
            with span("md.unet.attn" if name.endswith("attn") else "md.unet.res"):
                return call(name, *args)

        def cond(name, h):  # a DepthTransformer, its context moments included
            with span("md.unet.cond"):
                w = h.shape[-1]
                ctx = source_dict[w]
                if getattr(self, name).fused(ctx, train) and w not in moments:
                    moments[w] = da.ctx_moments(ctx)
                return call(name, h, ctx, cfg_doubled, train, moments.get(w))

        h = self.input_conv(x)
        hs = [h]
        ds, block = 1, 1
        for level in range(len(self.channel_mult)):
            for _ in range(self.num_res_blocks):
                h = run(f"in_{block}_res", h, emb)
                if ds in self.attention_ds:
                    h = run(f"in_{block}_attn", h, context)
                hs.append(h)
                block += 1
            if level != len(self.channel_mult) - 1:
                h = getattr(self, f"in_{block}_down")(h)
                hs.append(h)
                block += 1
                ds *= 2

        h = run("mid_res0", h, emb)
        h = run("mid_attn", h, context)
        h = run("mid_res1", h, emb)
        h = cond("middle_conditions", h)

        block = 0
        for level in reversed(range(len(self.channel_mult))):
            for i in range(self.num_res_blocks + 1):
                h = torch.cat([h, hs.pop()], dim=1)
                h = run(f"out_{block}_res", h, emb)
                if ds in self.attention_ds:
                    h = run(f"out_{block}_attn", h, context)
                if level and i == self.num_res_blocks:
                    h = getattr(self, f"out_{block}_up")(h)
                    ds //= 2
                if block in OUT_COND_CTX:
                    h = cond(f"out_{block}_cond", h)
                block += 1

        h = self.out_conv(self.out_norm(h))
        return h.float()
