"""Self-attention at L >= 1024 on hand-written Hopper flash kernels.

Counterpart of the Pallas TPU flash-attention call in the JAX package's
`models/layers.py::attention` (:277-297), which serves the 1024-token
self-attention of the five ds=1 SpatialTransformers (head_dim 40, 8 heads;
B=32 at serving, B=8 in training), and of that library's custom VJP, whose
two backward kernels (dK/dV over key tiles, dQ over query tiles) run in
training. The kernels are `csrc/flash_attention.cu` (forward: wgmma, TMA
and a register-resident online softmax; it always writes each row's
logsumexp) and `csrc/flash_attention_bwd.cu` (K2-dkv and K2-dq on the same
machinery, `csrc/flash_common.cuh`, which read that logsumexp).

Layout: q, k, v (B, L, num_heads * head_dim), the layout the to_q/to_k/to_v
projections produce; the output has the same shape.

`flash_attention` takes the plain version for a tensor on the CPU. For a
CUDA tensor it launches the kernels or raises, always through
`_FlashAttention`: the forward kernel (with the row logsumexp), and the
backward kernels when a gradient is wanted.
"""

from __future__ import annotations

import ctypes

import torch

from morphablediffusion_torch.ops import _cuda

KERNEL = _cuda.CudaKernel(
    "flash_attention", "flash_attention.cu", "md_flash_attention_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
BWD_DKV_KERNEL = _cuda.CudaKernel(
    "flash_attention_bwd_dkv", "flash_attention_bwd.cu", "md_flash_attention_bwd_dkv",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
BWD_DQ_KERNEL = _cuda.CudaKernel(
    "flash_attention_bwd_dq", "flash_attention_bwd.cu", "md_flash_attention_bwd_dq",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])


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


def logsumexp_reference(q, k, num_heads: int):
    """Plain row statistics of the forward kernel: (B, H, Lq) fp32
    logsumexp of the scaled logits."""
    B, Lq, inner = q.shape
    hd = inner // num_heads
    qh = q.reshape(B, Lq, num_heads, hd).transpose(1, 2).float()
    kh = k.reshape(B, -1, num_heads, hd).transpose(1, 2).float()
    return torch.logsumexp(torch.matmul(qh, kh.transpose(-1, -2)) * hd**-0.5, dim=-1)


def row_dot(out, dout, num_heads: int):
    """di = sum over head_dim of out * dout: (B, L, H*hd) -> (B, H, L) fp32,
    the backward kernels' per-row term (computed outside them, as the
    library does)."""
    B, L, inner = out.shape
    prod = out.float() * dout.float()
    return prod.reshape(B, L, num_heads, inner // num_heads).sum(-1).transpose(1, 2).contiguous()


def _bwd_terms(q, k, v, dout, lse, di, num_heads: int):
    """The backward kernels' per-head operands and their P and dZ, fp32, by
    the kernels' own formulas: P = exp(scale q k^T - lse), dZ = P (dO v^T -
    di). Returns (q, k, dout, P, dZ, scale), heads split out."""
    B, L, inner = q.shape
    hd = inner // num_heads
    qh, kh, vh, doh = (t.reshape(B, -1, num_heads, hd).transpose(1, 2).float()
                       for t in (q, k, v, dout))
    scale = hd**-0.5
    p = torch.exp(torch.matmul(qh, kh.transpose(-1, -2)) * scale - lse.float()[..., None])
    dz = p * (torch.matmul(doh, vh.transpose(-1, -2)) - di.float()[..., None])
    return qh, kh, doh, p, dz, scale


def _merge_heads(t):
    B, H, L, hd = t.shape
    return t.transpose(1, 2).reshape(B, L, H * hd)


def backward_dkv_reference(q, k, v, dout, lse, di, num_heads: int):
    """Plain version of the K2-dkv kernel's function: (dk, dv) in fp32 from
    the row statistics lse and di as the kernel reads them. The tests and
    chip_smoke.py hold the kernel to it; the port never calls it."""
    qh, _, doh, p, dz, scale = _bwd_terms(q, k, v, dout, lse, di, num_heads)
    return (_merge_heads(torch.matmul(dz.transpose(-1, -2), qh) * scale),
            _merge_heads(torch.matmul(p.transpose(-1, -2), doh)))


def backward_dq_reference(q, k, v, dout, lse, di, num_heads: int):
    """Plain version of the K2-dq kernel's function: dq in fp32, as
    `backward_dkv_reference`."""
    _, kh, _, _, dz, scale = _bwd_terms(q, k, v, dout, lse, di, num_heads)
    return _merge_heads(torch.matmul(dz, kh) * scale)


def _check(q, k, v, num_heads: int) -> int:
    _cuda.check_cuda("flash_attention", torch.bfloat16, q, k, v)
    B, L, inner = q.shape
    if k.shape != q.shape or v.shape != q.shape or inner % num_heads:
        raise ValueError(f"flash_attention: bad shapes {q.shape} {k.shape} "
                         f"{v.shape} for {num_heads} heads")
    hd = inner // num_heads
    if hd % 8 or hd > 64:
        raise ValueError(f"flash_attention: head_dim {hd} is not a multiple "
                         "of 8 up to 64")
    _cuda.check_aligned("flash_attention", q, k, v)
    return hd


def _forward(q, k, v, num_heads: int):
    """Launch the forward kernel; returns (out, lse), lse (B, H, L) fp32."""
    hd = _check(q, k, v, num_heads)
    B, L, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, num_heads, L), dtype=torch.float32, device=q.device)
    KERNEL.launch(_cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(out), _cuda.ptr(lse),
                  B, L, num_heads, hd, hd**-0.5, _cuda.stream_of(q))
    return out, lse


def _bwd_check(q, k, v, dout, lse, di, num_heads: int) -> int:
    hd = _check(q, k, v, num_heads)
    _cuda.check_cuda("flash_attention_backward", torch.bfloat16, q, dout)
    _cuda.check_cuda("flash_attention_backward", torch.float32, lse, di, device=q.device)
    B, L, _ = q.shape
    if dout.shape != q.shape or lse.shape != (B, num_heads, L) or di.shape != lse.shape:
        raise ValueError(f"flash_attention_backward: dout {dout.shape}, lse {lse.shape}, "
                         f"di {di.shape} for q {q.shape} and {num_heads} heads")
    _cuda.check_aligned("flash_attention_backward", dout)
    return hd


def backward_dkv(q, k, v, dout, lse, di, num_heads: int):
    """The K2-dkv kernel: (dk, dv). q, k, v, dout bf16; lse, di (B, H, L)
    fp32; all contiguous on one card."""
    hd = _bwd_check(q, k, v, dout, lse, di, num_heads)
    B, L, _ = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    BWD_DKV_KERNEL.launch(_cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(dout),
                          _cuda.ptr(lse), _cuda.ptr(di), _cuda.ptr(dk), _cuda.ptr(dv),
                          B, L, num_heads, hd, hd**-0.5, _cuda.stream_of(q))
    return dk, dv


def backward_dq(q, k, v, dout, lse, di, num_heads: int):
    """The K2-dq kernel: dq. Inputs as in `backward_dkv`."""
    hd = _bwd_check(q, k, v, dout, lse, di, num_heads)
    B, L, _ = q.shape
    dq = torch.empty_like(q)
    BWD_DQ_KERNEL.launch(_cuda.ptr(q), _cuda.ptr(k), _cuda.ptr(v), _cuda.ptr(dout),
                         _cuda.ptr(lse), _cuda.ptr(di), _cuda.ptr(dq),
                         B, L, num_heads, hd, hd**-0.5, _cuda.stream_of(q))
    return dq


def flash_attention_backward(q, k, v, out, lse, dout, num_heads: int):
    """dq, dk, dv of softmax attention from the forward's output and row
    logsumexp: di in plain torch, then the K2-dkv and K2-dq kernels."""
    di = row_dot(out, dout, num_heads)
    dk, dv = backward_dkv(q, k, v, dout, lse, di, num_heads)
    return backward_dq(q, k, v, dout, lse, di, num_heads), dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward kernel (with row logsumexp), backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int):
        out, lse = _forward(q, k, v, num_heads)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.to(torch.bfloat16).contiguous()
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout, ctx.num_heads)
        return dq, dk, dv, None


def flash_attention(q, k, v, num_heads: int):
    """softmax(q k^T / sqrt(hd)) v, self-attention shapes (Lq == Lk).

    CPU tensors take `attention_reference`; CUDA tensors must be contiguous
    bf16 with head_dim a multiple of 8 and at most 64, else this raises.
    """
    if not q.is_cuda:
        return attention_reference(q, k, v, num_heads)
    return _FlashAttention.apply(q, k, v, num_heads)
