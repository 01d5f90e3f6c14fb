"""Self-attention at L >= 1024 on a hand-written Hopper flash kernel.

Counterpart of the Pallas TPU flash-attention call in the JAX package's
`models/layers.py::attention` (:277-297), which serves the 1024-token
self-attention of the five ds=1 SpatialTransformers (B=32, 8 heads,
head_dim 40). The kernel is `csrc/flash_attention.cu`.

Layout: q, k, v (B, L, num_heads * head_dim), the layout the to_q/to_k/to_v
projections produce; the output has the same shape.

`flash_attention` takes the plain version for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from morphablediffusion_torch.ops import _cuda

KERNEL = _cuda.CudaKernel(
    "flash_attention", "flash_attention.cu", "md_flash_attention_fwd",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])


def attention_reference(q, k, v, num_heads: int):
    """Plain softmax attention: q (B, Lq, H*hd), k/v (B, Lk, H*hd) ->
    (B, Lq, H*hd). Logits and softmax in fp32, probabilities cast to v's
    dtype, as jax.nn.dot_product_attention does."""
    B, Lq, inner = q.shape
    Lk = k.shape[1]
    hd = inner // num_heads
    qh = q.reshape(B, Lq, num_heads, hd).transpose(1, 2).float()
    kh = k.reshape(B, Lk, num_heads, hd).transpose(1, 2).float()
    vh = v.reshape(B, Lk, num_heads, hd).transpose(1, 2)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * hd**-0.5
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.matmul(p, vh)
    return out.transpose(1, 2).reshape(B, Lq, inner)


def flash_attention(q, k, v, num_heads: int):
    """softmax(q k^T / sqrt(hd)) v, self-attention shapes (Lq == Lk).

    CPU tensors take `attention_reference`; CUDA tensors must be contiguous
    bf16 with head_dim a multiple of 8 and at most 64, else this raises.
    """
    if not q.is_cuda:
        return attention_reference(q, k, v, num_heads)
    _cuda.check_cuda("flash_attention", torch.bfloat16, q, k, v)
    B, L, inner = q.shape
    if k.shape != q.shape or v.shape != q.shape or inner % num_heads:
        raise ValueError(f"flash_attention: bad shapes {q.shape} {k.shape} "
                         f"{v.shape} for {num_heads} heads")
    hd = inner // num_heads
    if hd % 8 or hd > 64:
        raise ValueError(f"flash_attention: head_dim {hd} is not a multiple "
                         "of 8 up to 64")
    out = torch.empty_like(q)
    KERNEL.launch(_cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(out),
                  B, L, num_heads, hd, hd**-0.5, _cuda.stream_of(q))
    return out
