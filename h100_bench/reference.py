"""Plain float32 reference of the morphable-diffusion model, its DDIM step
and its training loss.

Written from the model's description with plain `torch` operations: no
kernel, no fused chain, no doubled batch, no analytic shortcut. Module and
parameter names follow the flax tree that the measured program also uses,
so one state dict loads into both (`load_state_dict(strict=True)` proves
that every leaf is covered). It imports nothing of the program.

Departures from the program's formulation, on purpose:
  * classifier-free guidance runs the UNet twice, conditional and
    unconditional (zero CLIP context, zero concat latent, zero frustum
    volumes), instead of one doubled batch;
  * depth attention builds k and v from proj_context -> GroupNorm(relu) on
    the context, instead of folding the norm into moments;
  * every attention is explicit softmax attention, in blocks of rows;
  * the fine conditioner is a sparse convolution over the active sites
    (the spconv `SparseConvNet` of network.py:74-96), with a neighbour table,
    instead of a masked dense grid.

With `Quant.mode = "fp8"` every convolution and linear map computes on
operands rounded to float8 e4m3 at one scale per tensor (amax / 448), the
gradients passing straight through: the control of the correctness check,
one precision below the bfloat16 that the configurations state.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FIRST_STAGE_SCALE = 0.18215
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
OUT_COND_CTX = {3: 2, 4: 2, 5: 1, 6: 1, 7: 1, 8: 0, 9: 0, 10: 0, 11: 0}
MIDDLE_COND_CTX = 3
ATTN_BLOCK_ELEMS = 1 << 28  # logits per block of rows in `attention`


class Quant:
    """The rounding applied to every operand of a conv or linear map."""

    mode: Optional[str] = None


def fq(t):
    """t rounded to float8 e4m3 at one per-tensor scale under
    Quant.mode == 'fp8', the gradient passing straight through; else t."""
    if Quant.mode != "fp8":
        return t
    s = t.detach().abs().amax().clamp_min(1e-12) / 448.0
    q = (t.detach() / s).to(torch.float8_e4m3fn).float() * s
    return t + (q - t).detach()


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


# ---------------------------------------------------------------- layers


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(fq(x), fq(self.weight), self.bias)

    def channels(self, x):
        """Over dim 1 of a channels-first map."""
        return self(x.movedim(1, -1)).movedim(-1, 1)


class Conv2d(nn.Conv2d):
    def __init__(self, cin, cout, k=3, stride=1, padding=None, bias=True):
        super().__init__(cin, cout, k, stride, (k - 1) // 2 if padding is None else padding,
                         bias=bias)

    def forward(self, x):
        return self._conv_forward(fq(x), fq(self.weight), self.bias)


class Conv3d(nn.Conv3d):
    def __init__(self, cin, cout, k=3, stride=1, padding=None, bias=True):
        super().__init__(cin, cout, k, stride, (k - 1) // 2 if padding is None else padding,
                         bias=bias)

    def forward(self, x):
        return self._conv_forward(fq(x), fq(self.weight), self.bias)


class ConvTranspose3d(nn.ConvTranspose3d):
    """k 3, stride 2, padding 1, output padding 1: twice every dim."""

    def __init__(self, cin, cout):
        super().__init__(cin, cout, 3, stride=2, padding=1, output_padding=1)

    def forward(self, x):
        return F.conv_transpose3d(fq(x), fq(self.weight), self.bias, stride=2, padding=1,
                                  output_padding=1)


ACTS = {None: lambda x: x, "silu": F.silu, "relu": F.relu}


class GroupNorm(nn.Module):
    def __init__(self, groups, channels, eps=1e-5, act=None):
        super().__init__()
        self.groups, self.eps, self.act = groups, eps, act
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, shift=None):
        if shift is not None:
            x = x + shift.reshape(shift.shape + (1,) * (x.ndim - 2))
        return ACTS[self.act](F.group_norm(x, self.groups, self.weight, self.bias, self.eps))


class LayerNorm(nn.LayerNorm):
    def __init__(self, dim):
        super().__init__(dim, eps=1e-6)


def attention(q, k, v, heads: int):
    """Softmax attention, q (B, Lq, H*hd), k, v (B, Lk, H*hd), in blocks of
    samples so that the logits stay within ATTN_BLOCK_ELEMS."""
    B, Lq, inner = q.shape
    Lk, hd = k.shape[1], inner // heads
    step = max(1, ATTN_BLOCK_ELEMS // (heads * Lq * Lk))
    out = []
    for i in range(0, B, step):
        sl = lambda t, L: t[i:i + step].reshape(-1, L, heads, hd).transpose(1, 2)
        s = sl(q, Lq) @ sl(k, Lk).transpose(-1, -2) * hd ** -0.5
        o = torch.softmax(s, -1) @ sl(v, Lk)
        out.append(o.transpose(1, 2).reshape(-1, Lq, inner))
    return torch.cat(out)


def upsample2x(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def bcast(e, ndim):
    return e.reshape(e.shape + (1,) * (ndim - 2))


# ------------------------------------------------------------------ UNet


class ResBlock(nn.Module):
    def __init__(self, cin, cout, emb):
        super().__init__()
        self.norm_in = GroupNorm(32, cin, act="silu")
        self.conv_in = Conv2d(cin, cout)
        self.emb_proj = Linear(emb, cout)
        self.norm_out = GroupNorm(32, cout, act="silu")
        self.conv_out = Conv2d(cout, cout)
        self.skip = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, emb):
        h = self.conv_in(self.norm_in(x))
        h = self.conv_out(self.norm_out(h, self.emb_proj(F.silu(emb))))
        return (x if self.skip is None else self.skip(x)) + h


class CrossAttention(nn.Module):
    def __init__(self, qdim, cdim, heads, hd):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(qdim, heads * hd, bias=False)
        self.to_k = Linear(cdim, heads * hd, bias=False)
        self.to_v = Linear(cdim, heads * hd, bias=False)
        self.to_out = Linear(heads * hd, qdim)

    def forward(self, x, context=None):
        c = x if context is None else context
        return self.to_out(attention(self.to_q(x), self.to_k(c), self.to_v(c), self.heads))


class FeedForward(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.proj_in = Linear(dim, dim * 8)
        self.proj_out = Linear(dim * 4, dim)

    def forward(self, x):
        h, gate = self.proj_in(x).chunk(2, -1)
        return self.proj_out(h * F.gelu(gate, approximate="tanh"))


class TransformerBlock(nn.Module):
    def __init__(self, dim, cdim, heads, hd):
        super().__init__()
        self.norm1, self.attn1 = LayerNorm(dim), CrossAttention(dim, dim, heads, hd)
        self.norm2, self.attn2 = LayerNorm(dim), CrossAttention(dim, cdim, heads, hd)
        self.norm3, self.ff = LayerNorm(dim), FeedForward(dim)

    def forward(self, x, context):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    def __init__(self, ch, heads, hd, depth, cdim):
        super().__init__()
        self.depth = depth
        self.norm = GroupNorm(32, ch, eps=1e-6)
        self.proj_in = Conv2d(ch, heads * hd, 1)
        for i in range(depth):
            self.add_module(f"block_{i}", TransformerBlock(heads * hd, cdim, heads, hd))
        self.proj_out = Conv2d(heads * hd, ch, 1)

    def forward(self, x, context):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x))
        h = h.flatten(2).transpose(1, 2)
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, context)
        return self.proj_out(h.transpose(1, 2).reshape(B, -1, H, W)) + x


class DepthAttention(nn.Module):
    def __init__(self, heads, hd, cdim):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(heads * hd, heads * hd, bias=False)
        self.to_k = Linear(cdim, heads * hd, bias=False)
        self.to_v = Linear(cdim, heads * hd, bias=False)
        self.to_out = Linear(heads * hd, heads * hd, bias=False)

    def forward(self, x, c):
        """x (B, inner, H, W); c (B, Cc, D, H, W): softmax over depth."""
        q, k, v = self.to_q.channels(x), self.to_k.channels(c), self.to_v.channels(c)
        B, C, D, H, W = k.shape
        hd = C // self.heads
        q = q.reshape(B, self.heads, hd, 1, H * W)
        k = k.reshape(B, self.heads, hd, D, H * W)
        v = v.reshape(B, self.heads, hd, D, H * W)
        a = torch.softmax((q * k).sum(2, keepdim=True) * hd ** -0.5, dim=3)
        return self.to_out.channels((a * v).sum(3).reshape(B, C, H, W))


class DepthTransformer(nn.Module):
    def __init__(self, heads, hd, cin, cout, cdim):
        super().__init__()
        inner = heads * hd
        self.proj_in_conv = Conv2d(cin, inner, 1)
        self.proj_in_norm = GroupNorm(8, inner, act="silu")
        self.proj_context_conv = Linear(cdim, cdim, bias=False)
        self.proj_context_norm = GroupNorm(8, cdim, act="relu")
        self.depth_attn = DepthAttention(heads, hd, cdim)
        self.proj_out_norm0 = GroupNorm(8, inner, act="relu")
        self.proj_out_conv0 = Conv2d(inner, inner, bias=False)
        self.proj_out_norm1 = GroupNorm(8, inner, act="relu")
        self.proj_out_conv1 = Conv2d(inner, cout, bias=False)

    def forward(self, x, context):
        h = self.proj_in_norm(self.proj_in_conv(x))
        c = self.proj_context_norm(self.proj_context_conv.channels(context))
        h = self.depth_attn(h, c)
        h = self.proj_out_conv0(self.proj_out_norm0(h))
        return self.proj_out_conv1(self.proj_out_norm1(h)) + x


class TimestepMLP(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.dense0, self.dense1 = Linear(cin, cout), Linear(cout, cout)

    def forward(self, t):
        return self.dense1(F.silu(self.dense0(t)))


def timestep_embedding(t, dim, max_period=10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


class DepthWiseUNet(nn.Module):
    def __init__(self, u):
        super().__init__()
        mc, self.mult, self.nres, self.attn_ds = (u["model_channels"], u["channel_mult"],
                                                  u["num_res_blocks"], u["attention_ds"])
        self.mc = mc
        heads, cdim, vdims = u["num_heads"], u["context_dim"], u["volume_dims"]
        emb = mc * 4
        self.time_embed = TimestepMLP(mc, emb)
        st = lambda ch: SpatialTransformer(ch, heads, ch // heads, u["transformer_depth"], cdim)
        dtf = lambda cd, ch: DepthTransformer(4, cd // 2, ch, ch, cd)
        self.input_conv = Conv2d(u["in_channels"], mc)
        hs, ch_in, ds, block = [mc], mc, 1, 1
        for level, m in enumerate(self.mult):
            ch = m * mc
            for _ in range(self.nres):
                self.add_module(f"in_{block}_res", ResBlock(ch_in, ch, emb))
                if ds in self.attn_ds:
                    self.add_module(f"in_{block}_attn", st(ch))
                ch_in = ch
                hs.append(ch)
                block += 1
            if level != len(self.mult) - 1:
                self.add_module(f"in_{block}_down", nn.Module())
                getattr(self, f"in_{block}_down").op = Conv2d(ch, ch, 3, 2)
                hs.append(ch)
                block += 1
                ds *= 2
        ch = self.mult[-1] * mc
        self.mid_res0, self.mid_attn = ResBlock(ch_in, ch, emb), st(ch)
        self.mid_res1 = ResBlock(ch, ch, emb)
        self.middle_conditions = dtf(vdims[MIDDLE_COND_CTX], ch)
        ch_in, block = ch, 0
        for level, m in list(enumerate(self.mult))[::-1]:
            ch = m * mc
            for i in range(self.nres + 1):
                self.add_module(f"out_{block}_res", ResBlock(ch_in + hs.pop(), ch, emb))
                if ds in self.attn_ds:
                    self.add_module(f"out_{block}_attn", st(ch))
                if level and i == self.nres:
                    self.add_module(f"out_{block}_up", nn.Module())
                    getattr(self, f"out_{block}_up").conv = Conv2d(ch, ch)
                    ds //= 2
                if block in OUT_COND_CTX:
                    self.add_module(f"out_{block}_cond", dtf(vdims[OUT_COND_CTX[block]], ch))
                ch_in = ch
                block += 1
        self.out_norm = GroupNorm(32, ch_in, act="silu")
        self.out_conv = Conv2d(ch_in, u["out_channels"])

    def forward(self, x, t, context, vols: Dict[int, torch.Tensor]):
        emb = self.time_embed(timestep_embedding(t, self.mc))
        h = self.input_conv(x)
        hs, ds, block = [h], 1, 1
        for level in range(len(self.mult)):
            for _ in range(self.nres):
                h = getattr(self, f"in_{block}_res")(h, emb)
                if ds in self.attn_ds:
                    h = getattr(self, f"in_{block}_attn")(h, context)
                hs.append(h)
                block += 1
            if level != len(self.mult) - 1:
                h = getattr(self, f"in_{block}_down").op(h)
                hs.append(h)
                block += 1
                ds *= 2
        h = self.mid_res1(self.mid_attn(self.mid_res0(h, emb), context), emb)
        h = self.middle_conditions(h, vols[h.shape[-1]])
        block = 0
        for level in reversed(range(len(self.mult))):
            for i in range(self.nres + 1):
                h = getattr(self, f"out_{block}_res")(torch.cat([h, hs.pop()], 1), emb)
                if ds in self.attn_ds:
                    h = getattr(self, f"out_{block}_attn")(h, context)
                if level and i == self.nres:
                    h = getattr(self, f"out_{block}_up").conv(upsample2x(h))
                    ds //= 2
                if block in OUT_COND_CTX:
                    h = getattr(self, f"out_{block}_cond")(h, vols[h.shape[-1]])
                block += 1
        return self.out_conv(self.out_norm(h))


# ------------------------------------------------------------ VAE, CLIP


class VAEResBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm1, self.conv1 = GroupNorm(32, cin, 1e-6, "silu"), Conv2d(cin, cout)
        self.norm2, self.conv2 = GroupNorm(32, cout, 1e-6, "silu"), Conv2d(cout, cout)
        self.nin_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        return (x if self.nin_shortcut is None else self.nin_shortcut(x)) + h


class VAEAttn(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.norm = GroupNorm(32, ch, 1e-6)
        self.q, self.k, self.v, self.proj_out = (Conv2d(ch, ch, 1) for _ in range(4))

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)
        tok = lambda t: t.flatten(2).transpose(1, 2)
        o = attention(tok(self.q(h)), tok(self.k(h)), tok(self.v(h)), 1)
        return x + self.proj_out(o.transpose(1, 2).reshape(B, C, H, W))


class Encoder(nn.Module):
    def __init__(self, ch, mult, nres):
        super().__init__()
        self.mult, self.nres = mult, nres
        self.conv_in = Conv2d(3, ch)
        cin = ch
        for level, m in enumerate(mult):
            for i in range(nres):
                self.add_module(f"down_{level}_block_{i}", VAEResBlock(cin, ch * m))
                cin = ch * m
            if level != len(mult) - 1:
                self.add_module(f"down_{level}_downsample", Conv2d(cin, cin, 3, 2, 0))
        self.mid_block_1, self.mid_attn_1, self.mid_block_2 = (
            VAEResBlock(cin, cin), VAEAttn(cin), VAEResBlock(cin, cin))
        self.norm_out, self.conv_out = GroupNorm(32, cin, 1e-6, "silu"), Conv2d(cin, 8)

    def forward(self, x):
        h = self.conv_in(x)
        for level in range(len(self.mult)):
            for i in range(self.nres):
                h = getattr(self, f"down_{level}_block_{i}")(h)
            if level != len(self.mult) - 1:
                h = getattr(self, f"down_{level}_downsample")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        return self.conv_out(self.norm_out(h))


class Decoder(nn.Module):
    def __init__(self, ch, mult, nres):
        super().__init__()
        self.mult, self.nres = mult, nres
        cin = ch * mult[-1]
        self.conv_in = Conv2d(4, cin)
        self.mid_block_1, self.mid_attn_1, self.mid_block_2 = (
            VAEResBlock(cin, cin), VAEAttn(cin), VAEResBlock(cin, cin))
        for level in reversed(range(len(mult))):
            for i in range(nres + 1):
                self.add_module(f"up_{level}_block_{i}", VAEResBlock(cin, ch * mult[level]))
                cin = ch * mult[level]
            if level:
                self.add_module(f"up_{level}_upsample", Conv2d(cin, cin))
        self.norm_out, self.conv_out = GroupNorm(32, cin, 1e-6, "silu"), Conv2d(cin, 3)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        for level in reversed(range(len(self.mult))):
            for i in range(self.nres + 1):
                h = getattr(self, f"up_{level}_block_{i}")(h)
            if level:
                h = getattr(self, f"up_{level}_upsample")(upsample2x(h))
        return self.conv_out(self.norm_out(h))


class AutoencoderKL(nn.Module):
    def __init__(self, ch, mult, nres):
        super().__init__()
        self.encoder, self.decoder = Encoder(ch, mult, nres), Decoder(ch, mult, nres)
        self.quant_conv, self.post_quant_conv = Conv2d(8, 8, 1), Conv2d(4, 4, 1)

    def moments(self, x):
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, 1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) antialiased Keys-cubic resampling (a = -0.5), half-pixel
    centres: the image resize the CLIP tower's preprocessing specifies."""
    inv = n_in / n_out
    ks = max(inv, 1.0)
    centres = (np.arange(n_out) + 0.5) * inv - 0.5
    w = _keys_cubic(np.abs(centres[:, None] - np.arange(n_in)[None]) / ks)
    w = w / w.sum(1, keepdims=True)
    return w.astype(np.float32)


class CLIPBlock(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.heads = heads
        self.ln_1, self.ln_2 = LayerNorm(width), LayerNorm(width)
        self.attn = nn.Module()
        self.attn.in_proj, self.attn.out_proj = Linear(width, 3 * width), Linear(width, width)
        self.mlp_fc, self.mlp_proj = Linear(width, 4 * width), Linear(4 * width, width)

    def forward(self, x):
        q, k, v = self.attn.in_proj(self.ln_1(x)).chunk(3, -1)
        x = x + self.attn.out_proj(attention(q, k, v, self.heads))
        h = self.mlp_fc(self.ln_2(x))
        return x + self.mlp_proj(h * torch.sigmoid(1.702 * h))


class CLIPImageEncoder(nn.Module):
    def __init__(self, c, image_size=224):
        super().__init__()
        self.size, self.layers, self.patch = image_size, c["layers"], c["patch_size"]
        w = c["width"]
        self.patch_conv = nn.Conv2d(3, w, self.patch, self.patch, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.positional_embedding = nn.Parameter(torch.zeros((image_size // self.patch) ** 2 + 1,
                                                             w))
        self.ln_pre, self.ln_post = LayerNorm(w), LayerNorm(w)
        for i in range(self.layers):
            self.add_module(f"block_{i}", CLIPBlock(w, c["num_heads"]))
        self.proj = nn.Parameter(torch.zeros(w, c["output_dim"]))

    def forward(self, x):
        """x (B, 3, H, W) in [-1, 1] -> (B, 1, output_dim)."""
        H, W = x.shape[-2:]
        ry = torch.as_tensor(resize_matrix(H, self.size), device=x.device)
        rx = torch.as_tensor(resize_matrix(W, self.size), device=x.device)
        y = (torch.einsum("oh,bchw,pw->bcop", ry, x, rx) + 1.0) / 2.0
        mean = torch.tensor(CLIP_MEAN, device=x.device)[:, None, None]
        std = torch.tensor(CLIP_STD, device=x.device)[:, None, None]
        h = F.conv2d(fq((y - mean) / std), fq(self.patch_conv.weight), stride=self.patch)
        h = h.flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(h.shape[0], 1, -1)
        h = self.ln_pre(torch.cat([cls, h], 1) + self.positional_embedding)
        for i in range(self.layers):
            h = getattr(self, f"block_{i}")(h)
        return (fq(self.ln_post(h[:, 0])) @ fq(self.proj))[:, None]


# ------------------------------------------------------ conditioning nets


class TVResBlock(nn.Module):
    def __init__(self, dim, td, vd):
        super().__init__()
        self.time_embed, self.view_embed = Linear(td, dim), Linear(vd, dim)
        self.norm0, self.conv0 = GroupNorm(8, dim, act="silu"), Conv2d(dim, dim)
        self.norm1, self.conv1 = GroupNorm(8, dim, act="silu"), Conv2d(dim, dim)

    def forward(self, x, t, v):
        h = x + bcast(self.time_embed(t), 4) + bcast(self.view_embed(v), 4)
        return x + self.conv1(self.norm1(self.conv0(self.norm0(h))))


class TargetViewEncoder(nn.Module):
    def __init__(self, td, vd):
        super().__init__()
        self.init_conv = Conv2d(4, 16)
        for i in range(3):
            self.add_module(f"res_{i}", TVResBlock(16, td, vd))
        self.final_norm, self.final_conv = GroupNorm(8, 16, act="silu"), Conv2d(16, 16)

    def forward(self, x, t, v):
        h = self.init_conv(x)
        for i in range(3):
            h = getattr(self, f"res_{i}")(h, t, v)
        return self.final_conv(self.final_norm(h))


class FrustumBlock(nn.Module):
    def __init__(self, cin, cout, stride, td, vd, up=False):
        super().__init__()
        self.t_conv, self.v_conv = Linear(td, cin), Linear(vd, cin)
        if up:
            self.norm, self.conv = GroupNorm(8, cin, act="silu"), ConvTranspose3d(cin, cout)
        else:
            self.bn, self.conv = GroupNorm(8, cin, act="silu"), Conv3d(cin, cout, 3, stride)

    def forward(self, x, t, v):
        h = x + bcast(self.t_conv(t), 5) + bcast(self.v_conv(v), 5)
        norm = self.norm if hasattr(self, "norm") else self.bn
        return self.conv(norm(h))


class FrustumNet(nn.Module):
    def __init__(self, td, vd, dims):
        super().__init__()
        d0, d1, d2, d3 = dims
        self.conv0 = Conv3d(64, d0)
        for name, a, b, s in (("conv1", d0, d1, 2), ("conv2", d1, d1, 1), ("conv3", d1, d2, 2),
                              ("conv4", d2, d2, 1), ("conv5", d2, d3, 2), ("conv6", d3, d3, 1)):
            self.add_module(name, FrustumBlock(a, b, s, td, vd))
        for name, a, b in (("up0", d3, d2), ("up1", d2, d1), ("up2", d1, d0)):
            self.add_module(name, FrustumBlock(a, b, 1, td, vd, up=True))

    def forward(self, x, t, v):
        w = x.shape[-1]
        x0 = self.conv0(x)
        x1 = self.conv2(self.conv1(x0, t, v), t, v)
        x2 = self.conv4(self.conv3(x1, t, v), t, v)
        x3 = self.conv6(self.conv5(x2, t, v), t, v)
        x2 = self.up0(x3, t, v) + x2
        x1 = self.up1(x2, t, v) + x1
        x0 = self.up2(x1, t, v) + x0
        return {w: x0, w // 2: x1, w // 4: x2, w // 8: x3}


def scatter_mean(feats, idx, mask, shape):
    """Mean of the vertex features (B, Nv, C) that fall in each voxel of a
    dense grid `shape` (dhw indices idx (B, Nv, 3), masked and out-of-grid
    vertices dropped) -> (grid (B, C, *shape), occupancy (B, 1, *shape))."""
    B, Nv, C = feats.shape
    G = math.prod(shape)
    upper = torch.tensor(shape, device=idx.device)
    inside = (mask > 0) & (idx >= 0).all(-1) & (idx < upper).all(-1)
    flat = (idx[..., 0] * shape[1] + idx[..., 1]) * shape[2] + idx[..., 2]
    flat = torch.where(inside, flat + torch.arange(B, device=idx.device)[:, None] * G, B * G)
    total = torch.zeros(B * G + 1, C, device=feats.device).index_add_(0, flat.reshape(-1),
                                                                       feats.reshape(-1, C))
    count = torch.zeros(B * G + 1, device=feats.device).index_add_(
        0, flat.reshape(-1), torch.ones(B * Nv, device=feats.device))
    grid = (total / count.clamp(min=1.0)[:, None])[:-1].reshape(B, *shape, C)
    return grid.permute(0, 4, 1, 2, 3), (count[:-1] > 0).float().reshape(B, 1, *shape)


class MaskedInstanceNorm(nn.Module):
    def __init__(self, ch, eps=1e-3):
        super().__init__()
        self.eps = eps
        self.weight, self.bias = nn.Parameter(torch.ones(ch)), nn.Parameter(torch.zeros(ch))

    def forward(self, x, mask):
        n = mask.sum((2, 3, 4), keepdim=True).clamp(min=1.0)
        mean = (x * mask).sum((2, 3, 4), keepdim=True) / n
        var = (((x - mean) * mask) ** 2).sum((2, 3, 4), keepdim=True) / n
        y = (x - mean) / torch.sqrt(var + self.eps)
        return (y * bcast(self.weight, 5) + bcast(self.bias, 5)) * mask


def trilinear(vol, grid):
    """vol (B, C, D, H, W); grid (B, ..., 3) xyz in [-1, 1], align_corners,
    zeros outside -> (B, C, ...)."""
    B, C = vol.shape[:2]
    out = F.grid_sample(vol, grid.reshape(B, 1, 1, -1, 3), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out.reshape((B, C) + grid.shape[1:-1])


class CoarseMeshVoxelNet(nn.Module):
    """Scatter-mean onto the coarse grid, seven bias-free 3^3 convs with a
    masked instance norm and ReLU (the mask dilated by one voxel a conv from
    the third on), trilinear query."""

    CHANNELS = (16, 16, 32, 32, 64, 64, 64)

    def __init__(self, grid, voxel):
        super().__init__()
        self.grid, self.voxel = tuple(grid), voxel
        cin = 16
        for i, ch in enumerate(self.CHANNELS):
            self.add_module(f"conv{i}", Conv3d(cin, ch, bias=False))
            self.add_module(f"norm{i}", MaskedInstanceNorm(ch))
            cin = ch

    def forward(self, feats, vdhw, min_dhw, mask, query_dhw):
        idx = torch.round((vdhw - min_dhw[:, None]) / self.voxel).long()
        h, m = scatter_mean(feats, idx, mask, self.grid)
        for i in range(len(self.CHANNELS)):
            if i >= 2:
                m = F.max_pool3d(m, 3, 1, 1)
            h = torch.relu(getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(h), m)) * m
        B = feats.shape[0]
        q = (query_dhw - min_dhw.reshape(B, 1, 1, 1, 3)) / self.voxel
        size = torch.tensor(self.grid[::-1], device=q.device, dtype=q.dtype) - 1
        return trilinear(h, q.flip(-1) / size * 2 - 1)


class BNActive(nn.Module):
    def __init__(self, ch, eps=1e-3):
        super().__init__()
        self.eps = eps
        self.weight, self.bias = nn.Parameter(torch.ones(ch)), nn.Parameter(torch.zeros(ch))
        self.mean, self.var = nn.Parameter(torch.zeros(ch)), nn.Parameter(torch.ones(ch))

    def forward(self, x):
        """x (n, C) rows of active sites."""
        return (x - self.mean) / torch.sqrt(self.var + self.eps) * self.weight + self.bias


OFFSETS = torch.tensor([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)])


class SparseSites:
    """The active sites of one sample's sparse tensor: integer dhw
    coordinates (n, 3) in a grid of `shape`, and their row in a dense table."""

    def __init__(self, coords, shape):
        self.coords, self.shape = coords, tuple(int(s) for s in shape)
        d, h, w = self.shape
        self.table = torch.full((d * h * w + 1,), -1, dtype=torch.long, device=coords.device)
        self.table[self.flat(coords)] = torch.arange(len(coords), device=coords.device)

    def flat(self, c):
        d, h, w = self.shape
        ok = ((c >= 0) & (c < torch.tensor(self.shape, device=c.device))).all(-1)
        return torch.where(ok, (c[:, 0] * h + c[:, 1]) * w + c[:, 2], d * h * w)

    def lookup(self, c):
        """Row of each coordinate (n, 3), -1 where it is not active."""
        return self.table[self.flat(c)]


def sparse_conv(x, sites_in, sites_out, weight, stride):
    """Sparse 3^3 conv, padding 1: out[o] = sum over the 27 offsets of
    W[:, :, offset] x[stride * o + offset], over the active inputs only.
    x (n_in, Cin); weight (Cout, Cin, 3, 3, 3) -> (n_out, Cout)."""
    out = torch.zeros(len(sites_out.coords), weight.shape[0], device=x.device)
    w = fq(weight).reshape(weight.shape[0], weight.shape[1], 27)
    xq = fq(x)
    offs = OFFSETS.to(x.device)
    for j in range(27):
        rows = sites_in.lookup(sites_out.coords * stride + offs[j])
        hit = rows >= 0
        out[hit] += xq[rows[hit]] @ w[:, :, j].t()
    return out


def down_sites(sites, out_shape):
    """Active outputs of a stride-2 sparse conv: every cell of `out_shape`
    whose 3^3 window, stride 2, padding 1, holds an active input."""
    cand = (sites.coords[:, None] - OFFSETS.to(sites.coords.device)[None])
    cand = cand[(cand % 2 == 0).all(-1)] // 2
    cand = cand[((cand >= 0) & (cand < torch.tensor(out_shape, device=cand.device))).all(-1)]
    return SparseSites(torch.unique(cand, dim=0), out_shape)


class SparseConvNet(nn.Module):
    """The spconv SparseConvNet of the published fine conditioner: subm 16,
    subm 16, down 32, subm 32, subm 32, down 64, subm 64 x3, each followed by
    BatchNorm (running statistics) and ReLU on the active sites."""

    PLAN = (("conv0_0", 16, 16, 0), ("conv0_3", 16, 16, 0), ("down0_0", 16, 32, 2),
            ("conv1_0", 32, 32, 0), ("conv1_3", 32, 32, 0), ("down1_0", 32, 64, 2),
            ("conv2_0", 64, 64, 0), ("conv2_3", 64, 64, 0), ("conv2_6", 64, 64, 0))

    def __init__(self):
        super().__init__()
        for name, cin, cout, _ in self.PLAN:
            self.add_module(name, Conv3d(cin, cout, bias=False))
            bn = name[:-1] + str(int(name[-1]) + 1)
            self.add_module(bn, BNActive(cout))

    def forward(self, x, sites, out_sh):
        """x (n, 16) features of the active sites of a grid out_sh ->
        (rows (m, 64), their sites in the out_sh // 4 grid)."""
        for name, _, _, stride in self.PLAN:
            if stride:
                new = down_sites(sites, [int(s) // 2 for s in sites.shape])
                x = sparse_conv(x, sites, new, getattr(self, name).weight, 2)
                sites = new
            else:
                x = sparse_conv(x, sites, sites, getattr(self, name).weight, 1)
            bn = name[:-1] + str(int(name[-1]) + 1)
            x = torch.relu(getattr(self, bn)(x))
        return x, sites


class FineMeshVoxelNet(nn.Module):
    """The published conditioner (morphable_diffusion.py:234-255): voxelize
    the vertices at `voxel` metres relative to the masked minimum, into a
    sparse tensor of spatial shape out_sh = (ceil(extent / voxel) | 3) + 1;
    the mean feature per occupied voxel; SparseConvNet; the dense
    out_sh // 4 result sampled at the query points normalized as
    f / out_sh * 2 - 1 (align_corners)."""

    def __init__(self, voxel):
        super().__init__()
        self.voxel = voxel
        self.net = SparseConvNet()

    def forward(self, feats, vdhw, min_dhw, mask, query_dhw):
        outs = []
        for b in range(feats.shape[0]):
            keep = mask[b] > 0
            v = vdhw[b][keep]
            out_sh = (torch.ceil((v.amax(0) - min_dhw[b]) / self.voxel).long() | 3) + 1
            idx = torch.round((v - min_dhw[b]) / self.voxel).long()
            coords, inv = torch.unique(idx, dim=0, return_inverse=True)
            total = torch.zeros(len(coords), feats.shape[-1], device=feats.device)
            total.index_add_(0, inv, feats[b][keep])
            count = torch.zeros(len(coords), device=feats.device).index_add_(
                0, inv, torch.ones(len(inv), device=feats.device))
            sites = SparseSites(coords, out_sh.tolist())
            rows, sites = self.net(total / count[:, None], sites, out_sh)
            dense = torch.zeros(64, *sites.shape, device=feats.device)
            c = sites.coords
            dense[:, c[:, 0], c[:, 1], c[:, 2]] = rows.t()
            f = (query_dhw[b] - min_dhw[b]) / self.voxel
            g = (f / out_sh.float() * 2 - 1).flip(-1)
            outs.append(trilinear(dense[None], g[None])[0])
        return torch.stack(outs)


class SpatialVolumeNet(nn.Module):
    def __init__(self, m):
        super().__init__()
        self.m = m
        td, vd = m["time_embed_dim"], m["viewpoint_dim"]
        self.target_encoder = TargetViewEncoder(td, vd)
        self.smpl_feature_extractor = nn.Module()
        self.smpl_feature_extractor.conv0 = Linear(16, 16)
        if m["mesh_voxel_mode"] == "fine":
            self.mesh_voxel = FineMeshVoxelNet(m["fine_voxel_size"])
        else:
            self.mesh_voxel = CoarseMeshVoxelNet(m["voxel_grid_shape"], m["coarse_voxel_size"])
        self.frustum_volume_feats = FrustumNet(td, vd, m["unet"]["volume_dims"])


# ---------------------------------------------------------- camera geometry


def projection(ratio, K, RT):
    """(B, 4, 4) perspective projection of world points to pixels of a map
    `ratio` times the input image's size."""
    S = torch.diag(torch.tensor([ratio, ratio, 1.0], device=K.device))
    P = S @ K[:, :3, :3] @ RT
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=K.device).expand(K.shape[0], 1, 4)
    return torch.cat([P, bottom], 1)


def spatial_grid(V, L, device):
    lin = torch.linspace(-L, L, V, device=device)
    z, y, x = torch.meshgrid(lin, lin, lin, indexing="ij")
    return torch.stack([x, y, z], -1)


# ------------------------------------------------------------------ model


class Reference(nn.Module):
    """The model, from a configuration file's `model` object."""

    def __init__(self, m: dict):
        super().__init__()
        if m["projection"] != "perspective" or m["use_spatial_volume"]:
            raise ValueError("the reference covers the perspective model without the "
                             "spatial-time volume")
        self.m = m
        self.first_stage = AutoencoderKL(m["vae_ch"], m["vae_ch_mult"], m["vae_num_res_blocks"])
        self.clip_image_encoder = CLIPImageEncoder(m["clip"])
        self.time_embed = TimestepMLP(m["time_embed_dim"], m["time_embed_dim"])
        self.spatial_volume = SpatialVolumeNet(m)
        self.unet = DepthWiseUNet(m["unet"])

    # inputs

    def encode(self, images, eps=None, chunk=16):
        """(M, H, W, 3) in [-1, 1] -> scaled latents (M, h, w, 4): the
        posterior mode, or with eps (M, h, w, 4) a posterior sample."""
        out = []
        for i in range(0, images.shape[0], chunk):
            mean, logvar = self.first_stage.moments(images[i:i + chunk].permute(0, 3, 1, 2))
            if eps is not None:
                mean = mean + torch.exp(0.5 * logvar) * eps[i:i + chunk].permute(0, 3, 1, 2)
            out.append(mean.permute(0, 2, 3, 1) * FIRST_STAGE_SCALE)
        return torch.cat(out)

    def decode(self, latents, chunk=16):
        """(M, h, w, 4) scaled -> (M, H, W, 3)."""
        out = [self.first_stage.decode(latents[i:i + chunk].permute(0, 3, 1, 2)
                                       / FIRST_STAGE_SCALE).permute(0, 2, 3, 1)
               for i in range(0, latents.shape[0], chunk)]
        return torch.cat(out)

    def clip(self, images):
        return self.clip_image_encoder(images.permute(0, 3, 1, 2))

    @staticmethod
    def viewpoints(batch):
        d2r = math.pi / 180
        de = (batch["target_elevation"] - batch["input_elevation"]) * d2r
        da = (batch["target_azimuth"] - batch["input_azimuth"]) * d2r
        return torch.stack([de, torch.sin(da), torch.cos(da), torch.zeros_like(da)], -1)

    # volumes

    def spatial_volume_of(self, x, t_embed, v_embed, batch):
        """x (B, N, h, w, 4) noisy latents of every view -> (B, 64, V, V, V)."""
        m, sv = self.m, self.spatial_volume
        B, N, h, w, _ = x.shape
        V, L = m["spatial_volume_size"], m["spatial_volume_length"]
        t = t_embed[:, None].expand(B, N, -1).reshape(B * N, -1)
        feats = sv.target_encoder(x.reshape(B * N, h, w, 4).permute(0, 3, 1, 2), t,
                                  v_embed.reshape(B * N, -1))
        grid = spatial_grid(V, L, x.device)
        P = projection(h / m["image_size"], batch["target_K"].reshape(B * N, 4, 4),
                       batch["target_RT"].reshape(B * N, 3, 4))
        pts = grid.reshape(1, -1, 3) @ P[:, :3, :3].transpose(1, 2) + P[:, None, :3, 3]
        xy = pts[..., :2] / pts[..., 2:3].clamp(min=1e-4) / ((h - 1) / 2) - 1
        per_view = F.grid_sample(feats, xy.reshape(B * N, 1, -1, 2), align_corners=True)
        mean = per_view.reshape(B, N, 16, V, V, V).mean(1)
        verts = batch["vertices"]
        vf = trilinear(mean, verts / L).transpose(1, 2)
        vf = sv.smpl_feature_extractor.conv0(vf)
        vdhw = verts.flip(-1)
        mask = batch["vertex_mask"]
        min_dhw = torch.where(mask[..., None] > 0, vdhw, torch.full_like(vdhw, 1e9)).amin(1)
        return sv.mesh_voxel(vf, vdhw, min_dhw, mask, grid.flip(-1)[None].expand(B, -1, -1, -1, -1))

    def frustum_of(self, volume, t_embed, v_embed, batch, views):
        """Frustum volumes of `views` (B, T) -> {width: (B*T, C, D, w, w)}."""
        m = self.m
        take = lambda a: torch.stack([a[b, views[b]] for b in range(a.shape[0])])
        RT, K = take(batch["target_RT"]), take(batch["target_K"])
        B, T = views.shape
        RT, K = RT.reshape(B * T, 3, 4), K.reshape(B * T, 4, 4)
        D, Hf, L = m["frustum_volume_depth"], m["image_size"] // 8, m["spatial_volume_length"]
        centre = -(RT[:, :3, :3].transpose(1, 2) @ RT[:, :3, 3:])[..., 0]
        dist = centre.norm(dim=-1)
        near, far = dist - m["frustum_volume_length"], dist + m["frustum_volume_length"]
        depth = (torch.linspace(0, 1, D, device=RT.device)[None] * (far - near)[:, None]
                 + near[:, None])  # (BT, D)
        ys, xs = torch.meshgrid(torch.arange(Hf, device=RT.device, dtype=torch.float32),
                                torch.arange(Hf, device=RT.device, dtype=torch.float32),
                                indexing="ij")
        pix = torch.stack([xs, ys, torch.ones_like(xs)], -1)
        cam = pix[None, None] * depth[:, :, None, None, None]  # (BT, D, H, W, 3)
        Pinv = torch.linalg.inv(projection(Hf / m["image_size"], K, RT))
        xyz = cam.reshape(B * T, -1, 3) @ Pinv[:, :3, :3].transpose(1, 2) + Pinv[:, None, :3, 3]
        vols = trilinear(volume, (xyz / L).reshape(B, -1, 3))  # (B, C, T*D*H*W)
        vols = vols.reshape(B, -1, T, D, Hf, Hf).transpose(1, 2).reshape(B * T, -1, D, Hf, Hf)
        t = t_embed[:, None].expand(B, T, -1).reshape(B * T, -1)
        v = take(v_embed).reshape(B * T, -1)
        return self.spatial_volume.frustum_volume_feats(vols, t, v)

    # denoising

    def unet_eps(self, x, t, clip, vols, concat):
        """x, concat (M, h, w, 4) -> eps (M, h, w, 4)."""
        inp = torch.cat([x, concat / FIRST_STAGE_SCALE], -1).permute(0, 3, 1, 2)
        return self.unet(inp, t, clip, vols).permute(0, 2, 3, 1)

    def eps_cfg(self, x, t, clip, x_input, v_embed, batch, cfg_scale, views_per_call=4,
                volume=None):
        """CFG noise prediction for every view: x (B, N, h, w, 4), t (B,);
        from `volume` where given, else from the spatial volume of x."""
        B, N = x.shape[:2]
        t_embed = self.time_embed(timestep_embedding(t, self.m["time_embed_dim"]))
        if volume is None:
            volume = self.spatial_volume_of(x, t_embed, v_embed, batch)
        out = []
        for v0 in range(0, N, views_per_call):
            views = torch.arange(v0, v0 + views_per_call, device=x.device).expand(B, -1)
            vols = self.frustum_of(volume, t_embed, v_embed, batch, views)
            n = views.shape[1]
            xs = x[:, v0:v0 + n].reshape(B * n, *x.shape[2:])
            ts = t.repeat_interleave(n)
            cl = clip.repeat_interleave(n, 0)
            cat = x_input[:, None].expand(B, n, *x_input.shape[1:]).reshape(B * n, *x.shape[2:])
            cond = self.unet_eps(xs, ts, cl, vols, cat)
            zero_vols = {k: torch.zeros_like(v) for k, v in vols.items()}
            uncond = self.unet_eps(xs, ts, torch.zeros_like(cl), zero_vols, torch.zeros_like(cat))
            out.append((uncond + cfg_scale * (cond - uncond)).reshape(B, n, *x.shape[2:]))
        return torch.cat(out, 1)

    def training_loss(self, batch, draws):
        """Noise MSE on one target view a sample; the spatial volume takes
        every view. draws: the step's random inputs (see the traffic's
        generator)."""
        B, N = batch["target_image"].shape[:2]
        with torch.no_grad():
            x = self.encode(batch["target_image"].reshape(B * N, *batch["target_image"].shape[2:]),
                            draws["vae_target"].float()).reshape(B, N, *draws["noise"].shape[2:])
            concat = self.encode(batch["input_image"], draws["vae_input"].float())
            clip = self.clip(batch["input_image"])
        t, noise = draws["t"], draws["noise"]
        acp = ddpm_alphas_cumprod(x.device)[t].reshape(B, 1, 1, 1, 1)
        x_noisy = acp.sqrt() * x + (1 - acp).sqrt() * noise
        v_embed = self.viewpoints(batch)
        t_embed = self.time_embed(timestep_embedding(t, self.m["time_embed_dim"]))
        volume = self.spatial_volume_of(x_noisy, t_embed, v_embed, batch)
        sel = draws["target_index"].long()
        vols = self.frustum_of(volume, t_embed, v_embed, batch, sel)
        rows = torch.arange(B, device=x.device)
        eps = self.unet_eps(x_noisy[rows, sel[:, 0]], t, clip, vols, concat)
        return ((eps - noise[rows, sel[:, 0]]) ** 2).mean()


# ------------------------------------------------------------- schedules


def ddpm_alphas_cumprod(device, T=1000, start=0.00085, end=0.0120):
    betas = np.linspace(start ** 0.5, end ** 0.5, T, dtype=np.float64) ** 2
    return torch.as_tensor(np.cumprod(1.0 - betas), dtype=torch.float32, device=device)


def ddim_tables(steps: int, eta: float, T: int = 1000):
    """(timesteps, alphas, alphas_prev, sigmas) of the uniform DDIM
    discretization with the +1 offset, in float64."""
    acp = ddpm_alphas_cumprod("cpu", T).double().numpy()
    betas = np.linspace(0.00085 ** 0.5, 0.0120 ** 0.5, T, dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas)
    ts = np.arange(steps) * (T // steps) + 1
    a = acp[ts]
    a_prev = np.concatenate([acp[:1], acp[ts[:-1]]])
    sig = eta * np.sqrt((1 - a_prev) / (1 - a) * (1 - a / a_prev))
    return ts, a, a_prev, sig


def ddim_update(x, eps, index: int, tables, noise=None):
    """x_{t-1} from x_t and the noise prediction at DDIM index `index`."""
    _, a, a_prev, sig = tables
    a, ap, s = float(a[index]), float(a_prev[index]), float(sig[index])
    x0 = (x - math.sqrt(1 - a) * eps) / math.sqrt(a)
    out = math.sqrt(ap) * x0 + math.sqrt(max(1 - ap - s * s, 1e-7)) * eps
    return out if noise is None else out + s * noise


def build(m: dict, device) -> Reference:
    """The reference on `device` with uninitialized parameters."""
    with torch.device("meta"):
        ref = Reference(m)
    return ref.to_empty(device=device)


def named_leaves(m: dict):
    """[(name, shape, kind, fan_in)] of every parameter, kind 'norm_scale',
    'norm_shift', 'bn_var' or 'dense'; built on the meta device."""
    with torch.device("meta"):
        ref = Reference(m)
    out = []
    for mod_name, mod in ref.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            if isinstance(mod, (GroupNorm, LayerNorm, MaskedInstanceNorm, BNActive)):
                kind = {"weight": "norm_scale", "var": "bn_var"}.get(name, "norm_shift")
                out.append((full, tuple(p.shape), kind, 0))
                continue
            if isinstance(mod, nn.ConvTranspose3d) and name == "weight":
                fan = p.shape[0] * math.prod(p.shape[2:])
            elif p.ndim >= 2 and isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d)):
                fan = math.prod(p.shape[1:])
            elif p.ndim >= 2:
                fan = p.shape[0]
            else:
                fan = 0
            out.append((full, tuple(p.shape), "dense", fan))
    return out
