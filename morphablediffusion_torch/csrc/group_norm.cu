// GroupNorm with fp32 statistics, an optional per-(sample, channel) shift and
// an optional fused activation (kernel K4).
//
// Replaces: the JAX package's ops/group_norm.py::_kernel (:79-110, launched
// by _pallas_forward :113-136): per sample, fp32 sums of x and x^2 per
// channel, then per group; var = max(E[x^2] - E[x]^2, 0); rsqrt(var + eps);
// the affine; silu / relu; the output in x's dtype. It also covers
// group_norm_shifted (:159-199): a (B, C) shift t is folded into the
// per-channel sums as colsum + S*t and colsq + 2*t*colsum + S*t^2, so the
// statistics are those of x + t without writing x + t.
//
// What bounds it on the H100: memory. About 6-9 fp32 operations per element
// against 2 bytes read and 2 written (bf16), far below the card's ratio of
// operations to bytes; the least traffic is one read of x and one write of y.
// This design reads x twice (once per launch): at the serving and training
// shapes most maps (up to 268 MB at the VAE decode) do not stay in the 50 MB
// L2, so it moves about 1.5x the bound's bytes.
//
// Design (simple and right first; two launches, no atomics, deterministic):
//  * stats: one warp per (row, chunk), a row being the S elements of one
//    (sample, channel), cut into `splits` chunks (the wrapper picks about
//    4096 elements a chunk); 16-byte loads where S and the pointer allow,
//    fp32 sums of x and x^2 in registers, a warp-shuffle reduction, one
//    float2 partial per (row, chunk). A long row (S up to 65 536 at the VAE
//    decode) is split so that enough warps are in flight; a short one
//    (S = 16 at the UNet's bottom) leaves lanes idle.
//  * apply: one block of 256 threads per (sample, group, chunk of the
//    group's contiguous cg*S elements). The block first adds up the
//    partials of the group's cg channels (and folds the shift), reduces them
//    to the group's mean and inverse std, and keeps per-channel A = inv *
//    gamma and B2 = beta - mean * A (+ t * A) in shared memory; then it
//    writes act(x * A + B2) in x's dtype over its chunk.
// Layout: x, y (B, C, S) contiguous, bf16 or fp32; gamma, beta (C,) fp32;
// shift (B, C) fp32 or null; partials (B * C * splits) float2. Offsets into
// x are 64-bit (the VAE decode has 16 * 128 * 256^2 elements).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NTHREADS = 256;
constexpr int APPLY_CHUNK = 4096;  // elements of a group's span per apply block
constexpr int ACT_SILU = 1, ACT_RELU = 2;  // 0: no activation

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = p[j];
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = __bfloat162float(p[j]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = v[j];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = t;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = __float2bfloat16(v[j]);
  }
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_SILU) return v / (1.f + __expf(-v));
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  return v;
}

// One warp per (row, chunk of the row): part[row * splits + k] = (sum x, sum x^2).
template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
    gn_stats_kernel(const T* __restrict__ x, float2* __restrict__ part, long rows, int S,
                    int splits, int chunk) {
  const int lane = threadIdx.x & 31;
  const long item = (long)blockIdx.x * (NTHREADS / 32) + threadIdx.x / 32;
  if (item >= rows * splits) return;  // whole warps leave together
  const long row = item / splits;
  const int beg = (int)(item % splits) * chunk;
  const int end = min(S, beg + chunk);
  const T* p = x + row * (long)S;
  float s = 0.f, q = 0.f;
  for (int i = beg + lane * VEC; i < end; i += 32 * VEC) {
    float v[VEC];
    load_vec<VEC>(p + i, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      s += v[j];
      q = fmaf(v[j], v[j], q);
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    q += __shfl_xor_sync(0xffffffffu, q, o);
  }
  if (lane == 0) part[item] = make_float2(s, q);
}

// Sum of v over the block (NTHREADS threads); every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read from a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < NTHREADS / 32; ++w) t += red[w];
  return t;
}

// One block per (sample, group, chunk of the group's cg*S elements).
template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
    gn_apply_kernel(const T* __restrict__ x, const float2* __restrict__ part,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const float* __restrict__ shift, T* __restrict__ y, int C, int G, int S,
                    int splits, int chunks, float eps, int act) {
  extern __shared__ float coef[];  // A[cg], then B2[cg]
  __shared__ float red[NTHREADS / 32];
  const int cg = C / G;
  float* A = coef;
  float* B2 = coef + cg;
  const long grp = blockIdx.x / chunks;  // b * G + g
  const int chunk = blockIdx.x % chunks;
  const int g = (int)(grp % G);
  const long row0 = (grp / G) * C + (long)g * cg;  // the group's first (b, c) row

  // per-channel sums of x + t, then the group's
  float s = 0.f, q = 0.f;
  for (int c = threadIdx.x; c < cg; c += NTHREADS) {
    float cs = 0.f, cq = 0.f;
    for (int k = 0; k < splits; ++k) {
      const float2 pk = part[(row0 + c) * splits + k];
      cs += pk.x;
      cq += pk.y;
    }
    if (shift != nullptr) {
      const float t = shift[row0 + c];
      cq = cq + 2.f * t * cs + (float)S * t * t;
      cs = cs + (float)S * t;
    }
    s += cs;
    q += cq;
  }
  s = block_sum(s, red);
  q = block_sum(q, red);
  const float n = (float)((long)S * cg);
  const float mean = s / n;
  const float var = fmaxf(q / n - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);
  for (int c = threadIdx.x; c < cg; c += NTHREADS) {
    const float a = inv * gamma[g * cg + c];
    float b2 = beta[g * cg + c] - mean * a;
    if (shift != nullptr) b2 += shift[row0 + c] * a;
    A[c] = a;
    B2[c] = b2;
  }
  __syncthreads();

  const long base = row0 * (long)S;
  const int span = cg * S;
  const int end = min(span, (chunk + 1) * APPLY_CHUNK);
  for (int i = chunk * APPLY_CHUNK + threadIdx.x * VEC; i < end; i += NTHREADS * VEC) {
    const int c = i / S;  // S % VEC == 0: a vector never straddles channels
    const float a = A[c], b2 = B2[c];
    float v[VEC];
    load_vec<VEC>(x + base + i, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = activate(fmaf(v[j], a, b2), act);
    store_vec<VEC>(y + base + i, v);
  }
}

template <typename T>
constexpr int full_vec() {
  return 16 / (int)sizeof(T);
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int stats(const void* x, void* part, int batch, int C, int S, int splits, cudaStream_t st) {
  constexpr int V = full_vec<T>();
  const bool vec = S % V == 0 && aligned(x);
  int chunk = (S + splits - 1) / splits;
  if (vec) chunk = (chunk + V - 1) / V * V;
  const long rows = (long)batch * C;
  const long warps = rows * splits;
  const long blocks = (warps + NTHREADS / 32 - 1) / (NTHREADS / 32);
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  float2* pp = static_cast<float2*>(part);
  if (vec)
    gn_stats_kernel<T, V><<<(unsigned)blocks, NTHREADS, 0, st>>>(xp, pp, rows, S, splits, chunk);
  else
    gn_stats_kernel<T, 1><<<(unsigned)blocks, NTHREADS, 0, st>>>(xp, pp, rows, S, splits, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int apply(const void* x, const void* part, const float* gamma, const float* beta,
          const float* shift, void* y, int batch, int C, int G, int S, int splits, float eps,
          int act, cudaStream_t st) {
  constexpr int V = full_vec<T>();
  const bool vec = S % V == 0 && aligned(x) && aligned(y);
  const int cg = C / G;
  const int chunks = (int)(((long)cg * S + APPLY_CHUNK - 1) / APPLY_CHUNK);
  const long blocks = (long)batch * G * chunks;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)cg * sizeof(float);
  const T* xp = static_cast<const T*>(x);
  const float2* pp = static_cast<const float2*>(part);
  T* yp = static_cast<T*>(y);
  if (vec)
    gn_apply_kernel<T, V><<<(unsigned)blocks, NTHREADS, smem, st>>>(
        xp, pp, gamma, beta, shift, yp, C, G, S, splits, chunks, eps, act);
  else
    gn_apply_kernel<T, 1><<<(unsigned)blocks, NTHREADS, smem, st>>>(
        xp, pp, gamma, beta, shift, yp, C, G, S, splits, chunks, eps, act);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch 1. x (B, C, S), contiguous; dtype 0 = fp32, 1 = bf16. part receives
// B * C * splits float2 partial sums (sum x, sum x^2), each row of S elements
// cut into `splits` chunks. Returns cudaGetLastError().
int md_group_norm_stats(const void* x, void* part, int batch, int C, int S, int splits,
                        int dtype, void* stream) {
  if (batch <= 0 || C <= 0 || S <= 0 || splits <= 0 || splits > S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return stats<float>(x, part, batch, C, S, splits, st);
  if (dtype == 1) return stats<bf16>(x, part, batch, C, S, splits, st);
  return (int)cudaErrorInvalidValue;
}

// Launch 2. y = act((x + t - mean) * inv * gamma + beta) per group of C / G
// channels, from the partials of launch 1 (same batch, C, S, splits, dtype).
// gamma, beta (C,) fp32; shift (B, C) fp32 or null; act 0 none, 1 silu,
// 2 relu; y like x. cg * S must stay below 2^31 and cg at most 4096 (its
// coefficients live in shared memory).
// Returns cudaGetLastError().
int md_group_norm_apply(const void* x, const void* part, const void* gamma, const void* beta,
                        const void* shift, void* y, int batch, int C, int G, int S, int splits,
                        float eps, int act, int dtype, void* stream) {
  if (batch <= 0 || C <= 0 || G <= 0 || S <= 0 || splits <= 0 || C % G != 0)
    return (int)cudaErrorInvalidValue;
  if ((long)(C / G) * S > 0x7fffffffL || C / G > 4096 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* t = static_cast<const float*>(shift);
  if (dtype == 0) return apply<float>(x, part, g, b, t, y, batch, C, G, S, splits, eps, act, st);
  if (dtype == 1) return apply<bf16>(x, part, g, b, t, y, batch, C, G, S, splits, eps, act, st);
  return (int)cudaErrorInvalidValue;
}

const char* md_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
