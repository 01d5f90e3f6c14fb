// Flash attention backward for the UNet's 1024-token self-attention.
//
// Replaces: the two backward Pallas TPU kernels of the library flash
// attention that the JAX package's models/layers.py::attention (:277-297)
// calls, reached through its custom VJP (_flash_attention_bwd):
//   _flash_attention_dkv_kernel -> dK, dV   (md_flash_attention_bwd_dkv)
//   _flash_attention_dq_kernel  -> dQ       (md_flash_attention_bwd_dq)
// Training shape: B=8 samples (one target view each), L=1024, 8 heads,
// head_dim 40, bf16.
//
// With Z = scale * Q K^T, P = exp(Z - lse) (lse from the forward kernel),
// di = rowsum(dO * O) (computed in plain torch, as the library computes it
// outside its kernels):
//   dV = P^T dO,  dP = dO V^T,  dZ = P * (dP - di),
//   dQ = scale * dZ K,  dK = scale * dZ^T Q.
//
// What bounds it on the H100: the two kernels do 4 + 3 products of
// 2*L^2*hd each per (sample, head) (P and dP are rebuilt in both), about
// 7*2*B*H*L^2*hd = 75 GFLOP at the training shape against ~63 MB of q, k, v,
// dO, dq, dk, dv and the row statistics: bound by tensor-core operations
// (~76 us at the published bf16 peak), not by memory.
//
// Design (simple and right first; no wgmma/TMA/pipelining yet), FlashAttention-2's
// split into two kernels so that no atomics are needed:
//  * dkv: one block of 4 warps per (batch*head, 64-key tile); each warp owns
//    16 keys and keeps its dK and dV accumulators in WMMA fragments for the
//    whole loop over 64-query tiles, which are staged through shared memory
//    (Q, dO, lse, di) and shared by the 4 warps;
//  * dq: one block of 4 warps per (batch*head, 64-query tile); each warp owns
//    16 queries and keeps its dQ accumulator in fragments over the loop over
//    64-key tiles (K, V);
//  * every product runs on the tensor cores through WMMA (mma.sync) in bf16
//    with fp32 accumulation; P and dZ are formed in fp32 and rounded to bf16
//    only as product operands. head_dim 40 is zero-padded to 48 (HDP) in
//    shared memory as in the forward kernel: the padding adds nothing to the
//    logits or to dP, and its output columns are never written;
//  * out-of-range queries get P = 0 (they contribute nothing); out-of-range
//    keys get P = 0 in dq; rows past L are never written.
// Layout: q, k, v, dO, dq, dk, dv are (B, L, num_heads * head_dim) row-major;
// lse and di are (B, num_heads, L) fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BT = 64;  // rows of every tile (keys or queries)
constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;
constexpr float LOG2E = 1.4426950408889634f;

template <int HDP>
struct Layout {
  static constexpr int LDH = HDP + 8;  // bf16 stride of the Q/K/V/dO tiles
  static constexpr int LDS = BT + 4;   // fp32 stride of P and dP
  static constexpr int LDP = BT + 8;   // bf16 stride of the P / dZ operand
  static constexpr int A_OFF = 0;      // the block's own tile pair (K, V) or (Q, dO)
  static constexpr int B_OFF = A_OFF + BT * LDH * 2;
  static constexpr int C_OFF = B_OFF + BT * LDH * 2;  // the streamed tile pair
  static constexpr int D_OFF = C_OFF + BT * LDH * 2;
  static constexpr int S_OFF = D_OFF + BT * LDH * 2;  // P, fp32
  static constexpr int T_OFF = S_OFF + BT * LDS * 4;  // dP, fp32
  static constexpr int P_OFF = T_OFF + BT * LDS * 4;  // P or dZ, bf16
  static constexpr int R_OFF = P_OFF + BT * LDP * 2;  // lse*log2e and di
  static constexpr int BYTES = R_OFF + 2 * BT * 4;
  static_assert(HDP % 16 == 0 && HDP <= 64, "padded head_dim must be 16..64");
  static_assert(B_OFF % 32 == 0 && C_OFF % 32 == 0 && D_OFF % 32 == 0 && S_OFF % 32 == 0 &&
                    T_OFF % 32 == 0 && P_OFF % 32 == 0,
                "WMMA tiles need 32-byte aligned shared memory");
};

// Copy `rows` rows of head_dim bf16 values (16-byte vectors) from a
// (L, row_stride) slab into a shared tile of stride LDH; rows past L are 0.
// The padding columns [head_dim, HDP) are zeroed once and never written.
template <int LDH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0, int L,
                                          long row_stride, int head_dim) {
  const int vecs = head_dim / 8;
  for (int i = threadIdx.x; i < BT * vecs; i += NTHREADS) {
    const int r = i / vecs, c = (i % vecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < L) val = *reinterpret_cast<const uint4*>(src + (long)(r0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

// C (16 x 64, fp32, stride ldc) = A (16 x HDP, row-major) times B^T, where B
// is a 64 x HDP row-major tile (so B^T is read col-major).
template <int HDP>
__device__ __forceinline__ void rows_times_tile_t(const bf16* A, int lda, const bf16* Bt,
                                                  int ldb, float* C, int ldc) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BT / 16];
#pragma unroll
  for (int n = 0; n < BT / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < HDP; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + kk, lda);
#pragma unroll
    for (int n = 0; n < BT / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, Bt + n * 16 * ldb + kk, ldb);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < BT / 16; ++n)
    wmma::store_matrix_sync(C + n * 16, acc[n], ldc, wmma::mem_row_major);
}

// acc (16 x HDP) += A (16 x 64 bf16, row-major) times B (64 x HDP, row-major)
template <int HDP>
__device__ __forceinline__ void accumulate_rows_times_tile(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[HDP / 16], const bf16* A,
    int lda, const bf16* B, int ldb) {
#pragma unroll
  for (int kk = 0; kk < BT; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + kk, lda);
#pragma unroll
    for (int n = 0; n < HDP / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, B + kk * ldb + n * 16, ldb);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
}

// Write a warp's 16 x HDP accumulator, times `scale`, as bf16 rows r0.. of a
// (L, row_stride) slab, staging through the warp's 16 rows of fp32 scratch.
template <int HDP>
__device__ __forceinline__ void store_rows(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[HDP / 16], float* scratch,
    int lds, bf16* dst, int r0, int L, long row_stride, int head_dim, float scale) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < HDP / 16; ++n)
    wmma::store_matrix_sync(scratch + n * 16, acc[n], lds, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * head_dim; i += 32) {
    const int r = i / head_dim, c = i % head_dim;
    if (r0 + r < L)
      dst[(long)(r0 + r) * row_stride + c] = __float2bfloat16(scratch[r * lds + c] * scale);
  }
}

template <int HDP>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int num_heads,
                         int head_dim, float scale) {
  using Lt = Layout<HDP>;
  constexpr int LDH = Lt::LDH, LDS = Lt::LDS, LDP = Lt::LDP;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + Lt::A_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(smem + Lt::B_OFF);
  bf16* Qs = reinterpret_cast<bf16*>(smem + Lt::C_OFF);
  bf16* dOs = reinterpret_cast<bf16*>(smem + Lt::D_OFF);
  float* Ps = reinterpret_cast<float*>(smem + Lt::S_OFF);
  float* dPs = reinterpret_cast<float*>(smem + Lt::T_OFF);
  bf16* Pb = reinterpret_cast<bf16*>(smem + Lt::P_OFF);
  float* lse_s = reinterpret_cast<float*>(smem + Lt::R_OFF);
  float* di_s = lse_s + BT;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BT;
  const int b = blockIdx.y / num_heads, h = blockIdx.y % num_heads;
  const long row_stride = (long)num_heads * head_dim;
  const long base = (long)b * L * row_stride + (long)h * head_dim;
  const long stat = (long)blockIdx.y * L;
  const float scale_log2 = scale * LOG2E;

  for (int i = tid; i < 4 * BT * LDH; i += NTHREADS) Ks[i] = __float2bfloat16(0.f);
  __syncthreads();
  load_rows<LDH>(Ks, k + base, k0, L, row_stride, head_dim);
  load_rows<LDH>(Vs, v + base, k0, L, row_stride, head_dim);

  const int r_own = warp * 16;  // this warp's first key row in the tile
  float* Pw = Ps + r_own * LDS;
  float* dPw = dPs + r_own * LDS;
  bf16* Pbw = Pb + r_own * LDP;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[HDP / 16], dv_acc[HDP / 16];
#pragma unroll
  for (int n = 0; n < HDP / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  for (int q0 = 0; q0 < L; q0 += BT) {
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_rows<LDH>(Qs, q + base, q0, L, row_stride, head_dim);
    load_rows<LDH>(dOs, dout + base, q0, L, row_stride, head_dim);
    for (int i = tid; i < BT; i += NTHREADS) {
      const bool in = q0 + i < L;
      lse_s[i] = in ? lse[stat + q0 + i] * LOG2E : 0.f;
      di_s[i] = in ? di[stat + q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K_w Q^T (16 keys x 64 queries) -> P^T = exp2(S^T scale_log2 - lse2)
    rows_times_tile_t<HDP>(Ks + r_own * LDH, LDH, Qs, LDH, Pw, LDS);
    __syncwarp();
    for (int i = lane; i < 16 * BT; i += 32) {
      const int r = i / BT, c = i % BT;
      const float p = (q0 + c < L) ? exp2f(Pw[r * LDS + c] * scale_log2 - lse_s[c]) : 0.f;
      Pw[r * LDS + c] = p;
      Pbw[r * LDP + c] = __float2bfloat16(p);
    }
    __syncwarp();
    // dV_w += P^T dO
    accumulate_rows_times_tile<HDP>(dv_acc, Pbw, LDP, dOs, LDH);
    // dP^T = V_w dO^T (16 keys x 64 queries)
    rows_times_tile_t<HDP>(Vs + r_own * LDH, LDH, dOs, LDH, dPw, LDS);
    __syncwarp();
    // dZ^T = P^T * (dP^T - di), bf16 operand in place of P^T
    for (int i = lane; i < 16 * BT; i += 32) {
      const int r = i / BT, c = i % BT;
      Pbw[r * LDP + c] = __float2bfloat16(Pw[r * LDS + c] * (dPw[r * LDS + c] - di_s[c]));
    }
    __syncwarp();
    // dK_w += dZ^T Q
    accumulate_rows_times_tile<HDP>(dk_acc, Pbw, LDP, Qs, LDH);
  }

  store_rows<HDP>(dv_acc, Pw, LDS, dv + base, k0 + r_own, L, row_stride, head_dim, 1.f);
  __syncwarp();
  store_rows<HDP>(dk_acc, Pw, LDS, dk + base, k0 + r_own, L, row_stride, head_dim, scale);
}

template <int HDP>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        bf16* __restrict__ dq, int L, int num_heads, int head_dim,
                        float scale) {
  using Lt = Layout<HDP>;
  constexpr int LDH = Lt::LDH, LDS = Lt::LDS, LDP = Lt::LDP;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + Lt::A_OFF);
  bf16* dOs = reinterpret_cast<bf16*>(smem + Lt::B_OFF);
  bf16* Ks = reinterpret_cast<bf16*>(smem + Lt::C_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(smem + Lt::D_OFF);
  float* Ps = reinterpret_cast<float*>(smem + Lt::S_OFF);
  float* dPs = reinterpret_cast<float*>(smem + Lt::T_OFF);
  bf16* Pb = reinterpret_cast<bf16*>(smem + Lt::P_OFF);
  float* lse_s = reinterpret_cast<float*>(smem + Lt::R_OFF);
  float* di_s = lse_s + BT;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BT;
  const int b = blockIdx.y / num_heads, h = blockIdx.y % num_heads;
  const long row_stride = (long)num_heads * head_dim;
  const long base = (long)b * L * row_stride + (long)h * head_dim;
  const long stat = (long)blockIdx.y * L;
  const float scale_log2 = scale * LOG2E;

  for (int i = tid; i < 4 * BT * LDH; i += NTHREADS) Qs[i] = __float2bfloat16(0.f);
  __syncthreads();
  load_rows<LDH>(Qs, q + base, q0, L, row_stride, head_dim);
  load_rows<LDH>(dOs, dout + base, q0, L, row_stride, head_dim);
  for (int i = tid; i < BT; i += NTHREADS) {
    const bool in = q0 + i < L;
    lse_s[i] = in ? lse[stat + q0 + i] * LOG2E : 0.f;
    di_s[i] = in ? di[stat + q0 + i] : 0.f;
  }

  const int r_own = warp * 16;  // this warp's first query row in the tile
  float* Pw = Ps + r_own * LDS;
  float* dPw = dPs + r_own * LDS;
  bf16* Pbw = Pb + r_own * LDP;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq_acc[HDP / 16];
#pragma unroll
  for (int n = 0; n < HDP / 16; ++n) wmma::fill_fragment(dq_acc[n], 0.f);

  for (int k0 = 0; k0 < L; k0 += BT) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<LDH>(Ks, k + base, k0, L, row_stride, head_dim);
    load_rows<LDH>(Vs, v + base, k0, L, row_stride, head_dim);
    __syncthreads();

    // S = Q_w K^T (16 queries x 64 keys), dP = dO_w V^T
    rows_times_tile_t<HDP>(Qs + r_own * LDH, LDH, Ks, LDH, Pw, LDS);
    rows_times_tile_t<HDP>(dOs + r_own * LDH, LDH, Vs, LDH, dPw, LDS);
    __syncwarp();
    // dZ = P * (dP - di), P = exp2(S scale_log2 - lse2); keys past L give 0
    for (int i = lane; i < 16 * BT; i += 32) {
      const int r = i / BT, c = i % BT;
      const float p =
          (k0 + c < L) ? exp2f(Pw[r * LDS + c] * scale_log2 - lse_s[r_own + r]) : 0.f;
      Pbw[r * LDP + c] = __float2bfloat16(p * (dPw[r * LDS + c] - di_s[r_own + r]));
    }
    __syncwarp();
    // dQ_w += dZ K
    accumulate_rows_times_tile<HDP>(dq_acc, Pbw, LDP, Ks, LDH);
  }

  store_rows<HDP>(dq_acc, Pw, LDS, dq + base, q0 + r_own, L, row_stride, head_dim, scale);
}

template <int HDP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* di, void* dk, void* dv, int batch, int L, int num_heads,
               int head_dim, float scale, cudaStream_t stream) {
  const int bytes = Layout<HDP>::BYTES;
  cudaFuncSetAttribute(flash_bwd_dkv_kernel<HDP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  dim3 grid((L + BT - 1) / BT, batch * num_heads);
  flash_bwd_dkv_kernel<HDP><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(dk), static_cast<bf16*>(dv), L,
      num_heads, head_dim, scale);
  return (int)cudaGetLastError();
}

template <int HDP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* di, void* dq, int batch, int L, int num_heads, int head_dim,
              float scale, cudaStream_t stream) {
  const int bytes = Layout<HDP>::BYTES;
  cudaFuncSetAttribute(flash_bwd_dq_kernel<HDP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  dim3 grid((L + BT - 1) / BT, batch * num_heads);
  flash_bwd_dq_kernel<HDP><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<bf16*>(dq), L, num_heads, head_dim, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dout, dk, dv: (batch, L, num_heads * head_dim) bf16, contiguous;
// lse, di: (batch, num_heads, L) fp32. head_dim must be a multiple of 8 and
// at most 64. Returns cudaGetLastError().
int md_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* di, void* dk, void* dv, int batch,
                               int L, int num_heads, int head_dim, float scale, void* stream) {
  if (head_dim % 8 != 0 || head_dim > 64 || head_dim <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((head_dim + 15) / 16) {
    case 1: return launch_dkv<16>(q, k, v, dout, lse, di, dk, dv, batch, L, num_heads, head_dim, scale, s);
    case 2: return launch_dkv<32>(q, k, v, dout, lse, di, dk, dv, batch, L, num_heads, head_dim, scale, s);
    case 3: return launch_dkv<48>(q, k, v, dout, lse, di, dk, dv, batch, L, num_heads, head_dim, scale, s);
    default: return launch_dkv<64>(q, k, v, dout, lse, di, dk, dv, batch, L, num_heads, head_dim, scale, s);
  }
}

// Same layouts; writes dq only.
int md_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* di, void* dq, int batch, int L,
                              int num_heads, int head_dim, float scale, void* stream) {
  if (head_dim % 8 != 0 || head_dim > 64 || head_dim <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((head_dim + 15) / 16) {
    case 1: return launch_dq<16>(q, k, v, dout, lse, di, dq, batch, L, num_heads, head_dim, scale, s);
    case 2: return launch_dq<32>(q, k, v, dout, lse, di, dq, batch, L, num_heads, head_dim, scale, s);
    case 3: return launch_dq<48>(q, k, v, dout, lse, di, dq, batch, L, num_heads, head_dim, scale, s);
    default: return launch_dq<64>(q, k, v, dout, lse, di, dq, batch, L, num_heads, head_dim, scale, s);
  }
}

const char* md_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
