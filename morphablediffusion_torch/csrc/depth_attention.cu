// Depth-wise attention on projected q, k, v (the DepthTransformers' plain
// path, which training takes at the W=4 middle block).
//
// Replaces: the JAX package's ops/depth_attention.py::_kernel (:56-78,
// launched by _pallas_forward :81-113, W < 8 folded to H*W rows :88-100).
// Per pixel s of sample b and head n:
//   out[:, s] = sum_d softmax_d(q[:, s] . k[:, d, s] * hd^-1/2) v[:, d, s]
// over the D frustum depths, with the logits and softmax in fp32.
//
// What bounds it on the H100: 4*B*C*D*S FLOPs against one read of q, k, v
// and one write of out (2*B*C*S*(2*D + 2) bytes in bf16): ~0.5 FLOP per
// byte, so bound by memory (training shape B=8, C=1024, D=6, S=16: 3.4 MB,
// ~1 us). Nothing of size (B, D, H, W) is written.
//
// Design (simple and right first):
//  * one block of 128 threads per (sample, head, tile of P pixels), P = 32
//    (or 16 / 8 when H*W is smaller); thread t owns pixel t % P and the
//    channels g, g + G, g + 2G, ... of the head (g = t / P, G = 128 / P), so
//    neighbouring threads read neighbouring pixels of one (channel, depth)
//    row of the channels-first layout;
//  * the TPU kernel holds all D logits in VMEM; here depth is a loop with an
//    ONLINE softmax (running max and sum per pixel in fp32) and the head_dim
//    accumulator sits in registers (NC values per thread);
//  * the per-pixel dot product over head_dim is a partial sum per thread,
//    reduced across the G channel groups through shared memory, double
//    buffered by depth parity so each depth needs one barrier.
// Layout: q, out (B, C, S); k, v (B, C, D, S); C = heads * hd; S = H * W;
// bf16, contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NTHREADS = 128;

template <int NC>
__global__ void __launch_bounds__(NTHREADS)
    depth_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out, int C, int D, int S,
                      int heads, int P, float scale_log2) {
  __shared__ float red[2][NTHREADS];
  const int hd = C / heads;
  const int G = NTHREADS / P;
  const int tiles = (S + P - 1) / P;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % heads;
  const int b = blockIdx.x / (tiles * heads);
  const int p = threadIdx.x % P, g = threadIdx.x / P;
  const int s = tile * P + p;
  const bool live = s < S;
  const long c0 = (long)b * C + (long)h * hd;  // first channel row of this head

  float qr[NC], acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = g + i * G;
    qr[i] = (live && c < hd) ? __bfloat162float(q[(c0 + c) * S + s]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int d = 0; d < D; ++d) {
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = g + i * G;
      if (live && c < hd) part += qr[i] * __bfloat162float(k[((c0 + c) * D + d) * S + s]);
    }
    float* buf = red[d & 1];
    buf[threadIdx.x] = part;
    __syncthreads();
    float logit = 0.f;
    for (int j = 0; j < G; ++j) logit += buf[j * P + p];
    logit *= scale_log2;
    const float m_new = fmaxf(m, logit);
    const float corr = exp2f(m - m_new), pr = exp2f(logit - m_new);
    l = l * corr + pr;
    m = m_new;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = g + i * G;
      const float vv = (live && c < hd) ? __bfloat162float(v[((c0 + c) * D + d) * S + s]) : 0.f;
      acc[i] = acc[i] * corr + pr * vv;
    }
  }

  if (!live) return;
  const float inv = 1.f / l;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = g + i * G;
    if (c < hd) out[(c0 + c) * S + s] = __float2bfloat16(acc[i] * inv);
  }
}

template <int NC>
int launch(const void* q, const void* k, const void* v, void* out, int batch, int C, int D,
           int S, int heads, int P, float scale, cudaStream_t stream) {
  const int blocks = batch * heads * ((S + P - 1) / P);
  depth_attn_kernel<NC><<<blocks, NTHREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), C, D, S, heads, P, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out (B, C, S); k, v (B, C, D, S); bf16, contiguous. P (pixels per
// block) is 8, 16 or 32; head_dim = C / heads must be at most 64 * (128 / P).
// Returns cudaGetLastError().
int md_depth_attention_fwd(const void* q, const void* k, const void* v, void* out, int batch,
                           int C, int D, int S, int heads, int P, float scale, void* stream) {
  if (heads <= 0 || C % heads != 0 || D <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if (P != 8 && P != 16 && P != 32) return (int)cudaErrorInvalidValue;
  const int G = NTHREADS / P;
  const int nc = (C / heads + G - 1) / G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nc <= 8) return launch<8>(q, k, v, out, batch, C, D, S, heads, P, scale, s);
  if (nc <= 16) return launch<16>(q, k, v, out, batch, C, D, S, heads, P, scale, s);
  if (nc <= 32) return launch<32>(q, k, v, out, batch, C, D, S, heads, P, scale, s);
  if (nc <= 64) return launch<64>(q, k, v, out, batch, C, D, S, heads, P, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* md_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
