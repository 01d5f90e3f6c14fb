// Flash attention forward for the UNet's 1024-token self-attention.
//
// Replaces: the Pallas TPU flash-attention kernel called by the JAX
// package's models/layers.py::attention (:277-297) for self-attention with min(Lq, Lk) >= 1024 (the five ds=1 SpatialTransformers:
// B=32, 8 heads, head_dim 40, L=1024, bf16).
//
// What bounds it on the H100: 4*B*H*L^2*hd = 43 GFLOP per call against 84 MB
// of q/k/v/out, so it is bound by tensor-core operations (~44 us at the
// published bf16 peak), not by memory. The (L, L) logits are the bytes to
// keep out of device memory.
//
// Design (simple and right first; no wgmma/TMA/pipelining yet):
//  * one block of 4 warps per (batch*head, 64-query tile); each warp owns 16
//    query rows for the whole key loop;
//  * K and V tiles of 64 keys are staged through shared memory and shared by
//    the 4 warps;
//  * Q.K^T and P.V run on the tensor cores through WMMA (mma.sync) in bf16
//    with fp32 accumulation. head_dim 40 is not a multiple of 16, so the
//    tiles are padded with zero columns to 48 (HDP); the padding adds nothing
//    to the logits and its output columns are never written;
//  * online softmax in fp32 (running max and sum per row, log2 domain); the
//    output accumulator lives in shared memory in fp32 and is rescaled per
//    key tile; the (L, L) matrix never exists.
//  * for training, the kernel also writes each row's fp32 logsumexp of the
//    scaled logits, lse (B, num_heads, L), which the backward kernels
//    (flash_attention_bwd.cu) read to rebuild P without a second softmax;
//    serving passes a null pointer and writes nothing more.
// Layout: q, k, v, out are (B, L, num_heads * head_dim) row-major, the layout
// the to_q/to_k/to_v projections produce, so no transpose is needed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;  // queries per block
constexpr int BK = 64;  // keys per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;

template <int HDP>
struct Layout {
  static constexpr int LDH = HDP + 8;  // bf16 stride of the Q/K/V tiles
  static constexpr int LDS = BK + 4;   // fp32 stride of S (and the P.V stage)
  static constexpr int LDP = BK + 8;   // bf16 stride of P
  static constexpr int LDO = HDP + 4;  // fp32 stride of the O accumulator
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BQ * LDH * 2;
  static constexpr int V_OFF = K_OFF + BK * LDH * 2;
  static constexpr int S_OFF = V_OFF + BK * LDH * 2;
  static constexpr int P_OFF = S_OFF + BQ * LDS * 4;
  static constexpr int O_OFF = P_OFF + BQ * LDP * 2;
  static constexpr int M_OFF = O_OFF + BQ * LDO * 4;
  static constexpr int BYTES = M_OFF + 3 * BQ * 4;
  static_assert(HDP % 16 == 0 && HDP <= BK, "padded head_dim must be 16..64");
  static_assert(K_OFF % 32 == 0 && V_OFF % 32 == 0 && S_OFF % 32 == 0 &&
                    P_OFF % 32 == 0 && O_OFF % 32 == 0,
                "WMMA tiles need 32-byte aligned shared memory");
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy `rows` rows of head_dim bf16 values (16-byte vectors) from a
// (L, row_stride) slab into a shared tile of stride LDH; rows past L are 0.
template <int LDH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0, int rows,
                                          int L, long row_stride, int head_dim) {
  const int vecs = head_dim / 8;
  for (int i = threadIdx.x; i < rows * vecs; i += NTHREADS) {
    const int r = i / vecs, c = (i % vecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < L) val = *reinterpret_cast<const uint4*>(src + (long)(r0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

template <int HDP>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int L, int num_heads, int head_dim,
                     float scale_log2) {
  using Lt = Layout<HDP>;
  constexpr int LDH = Lt::LDH, LDS = Lt::LDS, LDP = Lt::LDP, LDO = Lt::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + Lt::Q_OFF);
  bf16* Ks = reinterpret_cast<bf16*>(smem + Lt::K_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(smem + Lt::V_OFF);
  float* Ss = reinterpret_cast<float*>(smem + Lt::S_OFF);
  bf16* Ps = reinterpret_cast<bf16*>(smem + Lt::P_OFF);
  float* Os = reinterpret_cast<float*>(smem + Lt::O_OFF);
  float* row_m = reinterpret_cast<float*>(smem + Lt::M_OFF);
  float* row_l = row_m + BQ;
  float* row_c = row_l + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / num_heads, h = blockIdx.y % num_heads;
  const long row_stride = (long)num_heads * head_dim;
  const long base = (long)b * L * row_stride + (long)h * head_dim;

  // zero the Q/K/V tiles (their padding columns stay 0) and the accumulators
  for (int i = tid; i < (BQ + 2 * BK) * LDH; i += NTHREADS) Qs[i] = __float2bfloat16(0.f);
  for (int i = tid; i < BQ * LDO; i += NTHREADS) Os[i] = 0.f;
  for (int i = tid; i < BQ; i += NTHREADS) {
    row_m[i] = -INFINITY;
    row_l[i] = 0.f;
  }
  __syncthreads();
  load_rows<LDH>(Qs, q + base, q0, BQ, L, row_stride, head_dim);

  const int r_own = warp * 16;  // this warp's first query row in the tile
  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<LDH>(Ks, k + base, k0, BK, L, row_stride, head_dim);
    load_rows<LDH>(Vs, v + base, k0, BK, L, row_stride, head_dim);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < HDP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + r_own * LDH + kk, LDH);
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
          wmma::load_matrix_sync(bt, Ks + n * 16 * LDH + kk, LDH);
          wmma::mma_sync(acc[n], a, bt, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BK / 16; ++n)
        wmma::store_matrix_sync(Ss + r_own * LDS + n * 16, acc[n], LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this key tile, one row at a time, 2 keys per lane
    for (int r = 0; r < 16; ++r) {
      const int row = r_own + r;
      float s0 = (k0 + lane < L) ? Ss[row * LDS + lane] * scale_log2 : -INFINITY;
      float s1 = (k0 + lane + 32 < L) ? Ss[row * LDS + lane + 32] * scale_log2 : -INFINITY;
      const float m_old = row_m[row];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = exp2f(s0 - m_new), p1 = exp2f(s1 - m_new);
      const float sum = warp_sum(p0 + p1);
      Ps[row * LDP + lane] = __float2bfloat16(p0);
      Ps[row * LDP + lane + 32] = __float2bfloat16(p1);
      if (lane == 0) {
        const float c = exp2f(m_old - m_new);
        row_c[row] = c;
        row_l[row] = row_l[row] * c + sum;
        row_m[row] = m_new;
      }
    }
    __syncwarp();

    // P V for the warp's rows, staged through its rows of S, then O = O*c + PV
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[HDP / 16];
#pragma unroll
      for (int n = 0; n < HDP / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Ps + r_own * LDP + kk, LDP);
#pragma unroll
        for (int n = 0; n < HDP / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
          wmma::load_matrix_sync(bv, Vs + kk * LDH + n * 16, LDH);
          wmma::mma_sync(acc[n], a, bv, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < HDP / 16; ++n)
        wmma::store_matrix_sync(Ss + r_own * LDS + n * 16, acc[n], LDS, wmma::mem_row_major);
    }
    __syncwarp();
    for (int i = lane; i < 16 * HDP; i += 32) {
      const int row = r_own + i / HDP, c = i % HDP;
      Os[row * LDO + c] = Os[row * LDO + c] * row_c[row] + Ss[row * LDS + c];
    }
  }
  __syncwarp();

  for (int i = lane; i < 16 * head_dim; i += 32) {
    const int row = r_own + i / head_dim, c = i % head_dim;
    if (q0 + row < L)
      out[base + (long)(q0 + row) * row_stride + c] =
          __float2bfloat16(Os[row * LDO + c] / row_l[row]);
  }
  if (lse != nullptr && lane < 16 && q0 + r_own + lane < L) {
    // natural-log logsumexp of the scaled logits: (m + log2 l) * ln 2
    const int row = r_own + lane;
    lse[(long)blockIdx.y * L + q0 + row] =
        (row_m[row] + log2f(row_l[row])) * 0.6931471805599453f;
  }
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int batch,
           int L, int num_heads, int head_dim, float scale, cudaStream_t stream) {
  const int bytes = Layout<HDP>::BYTES;
  cudaFuncSetAttribute(flash_fwd_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  dim3 grid((L + BQ - 1) / BQ, batch * num_heads);
  flash_fwd_kernel<HDP><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), L, num_heads, head_dim,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out: (batch, L, num_heads * head_dim) bf16, contiguous; lse:
// (batch, num_heads, L) fp32, or null to skip it. head_dim must be a multiple
// of 8 and at most 64. Returns cudaGetLastError().
int md_flash_attention_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                           int batch, int L, int num_heads, int head_dim, float scale,
                           void* stream) {
  if (head_dim % 8 != 0 || head_dim > 64 || head_dim <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((head_dim + 15) / 16) {
    case 1: return launch<16>(q, k, v, out, lse, batch, L, num_heads, head_dim, scale, s);
    case 2: return launch<32>(q, k, v, out, lse, batch, L, num_heads, head_dim, scale, s);
    case 3: return launch<48>(q, k, v, out, lse, batch, L, num_heads, head_dim, scale, s);
    default: return launch<64>(q, k, v, out, lse, batch, L, num_heads, head_dim, scale, s);
  }
}

const char* md_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
