"""W8A8 int8 convolution for UNet serving.

Counterpart of the JAX package's `ops/int8.py` (standard W8A8 post-training
quantization of the UNet's internal convs):

  * weights: symmetric per-output-channel scales (max|w| over the receptive
    field / 127), computed in the weight's own dtype (the serving weights
    are bf16, as the JAX package's are when it quantizes them), rounded
    half to even and saturated to int8. A module quantizes once per weight
    load and keeps the result (`models/layers.py::Conv2d`);
  * activations: a symmetric dynamic per-tensor scale (max|x| / 127) in
    fp32, measured on every call;
  * an s8 x s8 -> s32 product, then dequantized in fp32 (sx * sw per output
    channel) plus the bias, and cast to the output dtype.

The product is `torch._int_mm` on the card (cuBLASLt) and on the CPU (an
exact integer matmul): a 1x1 conv is one product over the channels of an
NHWC view, a 3x3 conv an im2col (a strided view of the zero-padded NHWC
map, copied) times the weights as a (kh * kw * cin, cout) matrix. Zero
padding is exact under symmetric quantization (q(0) = 0). `_int_mm`'s shape
rules on the card (rows > 16, k and n multiples of 8) are met by zero rows
and columns, which change no sum. These are PyTorch library calls: in the
JAX package this conv is XLA's, not a Pallas kernel. Serving only; no
gradient.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def quantize_weight_per_channel(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cout, cin, kh, kw) in its own dtype -> (int8 weight, fp32 (cout,)
    scales)."""
    amax = weight.abs().amax(dim=tuple(range(1, weight.ndim)))
    sw = amax.clamp_min(1e-8) / 127.0
    w8 = torch.round(weight / sw.reshape((-1,) + (1,) * (weight.ndim - 1)))
    return w8.clamp(-128, 127).to(torch.int8), sw.float()


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 tensor, fp32 scalar scale). Dynamic symmetric per-tensor."""
    xf = x.float()
    sx = xf.abs().amax().clamp_min(1e-8) / 127.0
    return torch.round(torch.clamp(xf / sx, -127, 127)).to(torch.int8), sx


def _pad_to(t: torch.Tensor, dim: int, multiple: int, least: int = 0) -> torch.Tensor:
    size = t.shape[dim]
    want = max(-(-size // multiple) * multiple, least)
    if want == size:
        return t
    pad = [0, 0] * (t.ndim - 1 - dim) + [0, want - size]
    return F.pad(t, pad)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact (m, k) int8 x (k, n) int8 -> (m, n) int32 through torch._int_mm,
    padded with zeros to its shape rules (m > 16, k and n multiples of 8)."""
    m, n = a.shape[0], b.shape[1]
    a = _pad_to(_pad_to(a, 1, 8), 0, 1, least=17)
    b = _pad_to(_pad_to(b, 0, 8), 1, 8)
    return torch._int_mm(a.contiguous(), b)[:m, :n]


def conv2d_int8(x8: torch.Tensor, w8: torch.Tensor, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """The int32 accumulators of an NCHW int8 conv: x8 (B, cin, H, W), w8
    (cout, cin, kh, kw) -> (B, Ho, Wo, cout) int32 (NHWC)."""
    B, C, H, W = x8.shape
    O, _, kh, kw = w8.shape
    xh = x8.permute(0, 2, 3, 1)
    if padding:
        xh = F.pad(xh, (0, 0, padding, padding, padding, padding))
    xh = xh.contiguous()
    Hp, Wp = xh.shape[1:3]
    Ho, Wo = (Hp - kh) // stride + 1, (Wp - kw) // stride + 1
    if kh == kw == 1:
        cols = xh[:, ::stride, ::stride].reshape(B * Ho * Wo, C)
    else:
        sb, sh, sw, sc = xh.stride()
        cols = xh.as_strided((B, Ho, Wo, kh, kw, C),
                             (sb, sh * stride, sw * stride, sh, sw, sc))
        cols = cols.reshape(B * Ho * Wo, kh * kw * C)
    wmat = w8.permute(0, 2, 3, 1).reshape(O, kh * kw * C).t()
    return int_matmul(cols, wmat).reshape(B, Ho, Wo, O)


def conv2d_w8a8(x: torch.Tensor, w8: torch.Tensor, sw: torch.Tensor,
                bias: Optional[torch.Tensor], stride: int = 1, padding: int = 0,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """NCHW conv of x with a quantized weight (w8, sw from
    quantize_weight_per_channel): x quantized per tensor, s32 products,
    fp32 dequantize plus bias. Returns (B, cout, Ho, Wo) in out_dtype."""
    x8, sx = quantize_activation(x)
    y = conv2d_int8(x8, w8, stride, padding).float() * (sx * sw)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype).permute(0, 3, 1, 2)
