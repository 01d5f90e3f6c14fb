// Fused depth-context attention of the DepthTransformers at serving.
//
// Replaces: the JAX package's ops/depth_attention.py::_ctx_kernel
// (:236-276, launched by _ctx_pallas :279-313). Per pixel (b, s) and head n:
//   p_d = Wp x_d;  y_d = relu(p_d * A[b] + B2[b]);  k_d = Wk y_d;  v_d = Wv y_d
//   out = sum_d softmax_d(q . k_d * hd^-1/2) v_d      (before to_out)
// over the D frustum depths, without writing any (B, D, H, W, C) tensor.
//
// What bounds it on the H100: per call 10*B*D*S*Cc^2 FLOP (proj Cc^2, k and
// v 2*Cc*Ci each, Ci = 2*Cc) against one read of ctx. At the main-path shapes
// (B=16) that is 4.0-32.6 GFLOP against 5.3-109 MB: bound by tensor-core
// operations at the narrow levels, and by both alike at W=32 (0.033 ms
// each). The weights (up to 1 MB each for Wk/Wv at Cc=512) are far beyond
// shared memory.
//
// Design (simple and right first; no wgmma/TMA/pipelining yet):
//  * the TPU kernel keeps the whole (D, rows, Ci) fp32 softmax in VMEM; here
//    the depth axis is a loop with an ONLINE softmax (running max and sum per
//    pixel, fp32 accumulator of hd per pixel), so shared memory holds one
//    depth slice at a time;
//  * one block of 4 warps per (sample, tile of P = 16 or 64 pixels, head).
//    Heads vary fastest in the grid, so the 4 blocks that read the same ctx
//    tile run together and three of them read it from L2. Splitting heads
//    recomputes the Cc x Cc projection per head (1.6x the minimum FLOPs) but
//    gives 4x the blocks at the narrow levels (W=4: 64 blocks, not 16);
//  * ctx stays in the frustum net's NCDHW layout: for a fixed channel and
//    depth the tile's pixels are contiguous, so the load walks S with 16-byte
//    vectors and lands column-major in shared memory, which is the A operand
//    layout WMMA reads directly (no channels-last copy of ctx is made);
//  * both products (P x Cc by Cc x Cc, then P x Cc by Cc x 2hd) run on the
//    tensor cores through WMMA in bf16 with fp32 accumulation; the weight
//    operand is read as a fragment straight from global memory (L2), since
//    Wp, Wk and Wv do not fit in shared memory at the wide levels; the P rows
//    of a tile reuse each weight fragment MT = P / 16 times;
//  * like the TPU kernel, p is fp32, y is rounded to bf16, and k, v and the
//    softmax stay fp32.
// Layout: q (B, Ci, S) and out (B, Ci, S) channels-first, ctx (B, Cc, D, S),
// Wp (Cc, Cc), Wk and Wv (Ci, Cc) in nn.Linear (out, in) layout, A and B2
// (B, Cc) fp32, with S = H * W.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;

struct Dims {
  int D, S, Cc, Ci, heads, hd;
};

constexpr int align32(int x) { return (x + 31) / 32 * 32; }

// Shared-memory plan for a tile of P pixels (all offsets in bytes), made on
// the host and passed to the kernel by value.
struct Plan {
  int ldx, ldp, ldy, ldq;
  int x_off, p_off, y_off, q_off, o_off, m_off, bytes;
  Plan(int P, int Cc, int hd) {
    ldx = P + 8;   // bf16, X_d stored [c][s]: column-major A operand
    ldp = (Cc > 2 * hd ? Cc : 2 * hd) + 4;  // fp32, p (Cc wide), then [k | v] (2 hd)
    ldy = Cc + 8;  // bf16, Y stored [s][c]: row-major A operand
    ldq = hd + 1;  // fp32, q and the output accumulator [s][j]
    x_off = 0;
    p_off = align32(x_off + Cc * ldx * 2);
    y_off = align32(p_off + P * ldp * 4);
    q_off = align32(y_off + P * ldy * 2);
    o_off = q_off + P * ldq * 4;
    m_off = o_off + P * ldq * 4;
    bytes = m_off + 2 * P * 4;
  }
};

// One 16-column tile of C (P x 16, fp32, row-major in shared memory) =
// A (P x K, bf16 in shared memory) times W^T, where W points at the 16 rows
// of an nn.Linear weight (out, in) in global memory with row length K.
template <int MT, typename ALayout>
__device__ __forceinline__ void warp_gemm_tile(const bf16* As, int lda, const bf16* W, int K,
                                               float* C, int ldc) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) wmma::fill_fragment(acc[mt], 0.f);
  for (int k0 = 0; k0 < K; k0 += 16) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
    wmma::load_matrix_sync(bw, W + k0, K);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a;
      if constexpr (std::is_same<ALayout, wmma::col_major>::value)
        wmma::load_matrix_sync(a, As + k0 * lda + mt * 16, lda);
      else
        wmma::load_matrix_sync(a, As + mt * 16 * lda + k0, lda);
      wmma::mma_sync(acc[mt], a, bw, acc[mt]);
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    wmma::store_matrix_sync(C + mt * 16 * ldc, acc[mt], ldc, wmma::mem_row_major);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int MT>
__global__ void __launch_bounds__(NTHREADS)
    depth_ctx_kernel(const bf16* __restrict__ q, const bf16* __restrict__ ctx,
                     const bf16* __restrict__ wp, const float* __restrict__ A,
                     const float* __restrict__ B2, const bf16* __restrict__ wk,
                     const bf16* __restrict__ wv, bf16* __restrict__ out, Dims dm,
                     Plan pl, float scale_log2) {
  constexpr int P = 16 * MT;
  const int D = dm.D, S = dm.S, Cc = dm.Cc, Ci = dm.Ci, hd = dm.hd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem + pl.x_off);
  float* Ps = reinterpret_cast<float*>(smem + pl.p_off);
  bf16* Ys = reinterpret_cast<bf16*>(smem + pl.y_off);
  float* Qs = reinterpret_cast<float*>(smem + pl.q_off);
  float* Os = reinterpret_cast<float*>(smem + pl.o_off);
  float* row_m = reinterpret_cast<float*>(smem + pl.m_off);
  float* row_l = row_m + P;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles = S / P;
  const int h = blockIdx.x % dm.heads;
  const int tile = (blockIdx.x / dm.heads) % tiles;
  const int b = blockIdx.x / (dm.heads * tiles);
  const int s0 = tile * P;

  // q tile -> Qs[s][j] fp32; zero the accumulator
  const bf16* qb = q + ((long)b * Ci + (long)h * hd) * S + s0;
  for (int i = tid; i < hd * P; i += NTHREADS) {
    const int j = i / P, s = i % P;
    Qs[s * pl.ldq + j] = __bfloat162float(qb[(long)j * S + s]);
    Os[s * pl.ldq + j] = 0.f;
  }
  for (int i = tid; i < P; i += NTHREADS) {
    row_m[i] = -INFINITY;
    row_l[i] = 0.f;
  }
  const float* Ab = A + (long)b * Cc;
  const float* Bb = B2 + (long)b * Cc;
  const int vecs = P / 8;

  for (int d = 0; d < D; ++d) {
    __syncthreads();  // previous depth is done with Xs, Ps and Ys
    // X_d: ctx[b, c, d, s0:s0+P] -> Xs[c][s] (16-byte vectors along S)
    const bf16* xb = ctx + ((long)b * Cc * D + d) * S + s0;
    for (int i = tid; i < Cc * vecs; i += NTHREADS) {
      const int c = i / vecs, s = (i % vecs) * 8;
      *reinterpret_cast<uint4*>(Xs + c * pl.ldx + s) =
          *reinterpret_cast<const uint4*>(xb + (long)c * D * S + s);
    }
    __syncthreads();

    // p = X_d Wp^T -> Ps (P x Cc)
    for (int nt = warp; nt < Cc / 16; nt += NWARPS)
      warp_gemm_tile<MT, wmma::col_major>(Xs, pl.ldx, wp + (long)nt * 16 * Cc, Cc,
                                          Ps + nt * 16, pl.ldp);
    __syncthreads();

    // y = relu(p * A + B2) -> Ys (bf16)
    for (int i = tid; i < P * Cc; i += NTHREADS) {
      const int s = i / Cc, c = i % Cc;
      Ys[s * pl.ldy + c] = __float2bfloat16(fmaxf(Ps[s * pl.ldp + c] * Ab[c] + Bb[c], 0.f));
    }
    __syncthreads();

    // [k | v] for this head = Y [Wk_h | Wv_h]^T -> Ps columns [0, hd) | [hd, 2hd)
    for (int nt = warp; nt < 2 * hd / 16; nt += NWARPS) {
      const int n = nt * 16;
      const bf16* W = n < hd ? wk + ((long)h * hd + n) * Cc : wv + ((long)h * hd + n - hd) * Cc;
      warp_gemm_tile<MT, wmma::row_major>(Ys, pl.ldy, W, Cc, Ps + n, pl.ldp);
    }
    __syncthreads();

    // online softmax over depth: one warp per pixel, lanes split head_dim
    for (int s = warp; s < P; s += NWARPS) {
      const float* kr = Ps + s * pl.ldp;
      const float* vr = kr + hd;
      const float* qr = Qs + s * pl.ldq;
      float part = 0.f;
      for (int j = lane; j < hd; j += 32) part += qr[j] * kr[j];
      const float sl = warp_sum(part) * scale_log2;
      const float m_old = row_m[s];
      const float m_new = fmaxf(m_old, sl);
      const float c = exp2f(m_old - m_new), p = exp2f(sl - m_new);
      float* orow = Os + s * pl.ldq;
      for (int j = lane; j < hd; j += 32) orow[j] = orow[j] * c + p * vr[j];
      __syncwarp();
      if (lane == 0) {
        row_m[s] = m_new;
        row_l[s] = row_l[s] * c + p;
      }
    }
  }
  __syncthreads();

  bf16* ob = out + ((long)b * Ci + (long)h * hd) * S + s0;
  for (int i = tid; i < hd * P; i += NTHREADS) {
    const int j = i / P, s = i % P;
    ob[(long)j * S + s] = __float2bfloat16(Os[s * pl.ldq + j] / row_l[s]);
  }
}

template <int MT>
int launch(const void* q, const void* ctx, const void* wp, const void* A, const void* B2,
           const void* wk, const void* wv, void* out, int batch, Dims dm, float scale,
           cudaStream_t stream) {
  const Plan pl(16 * MT, dm.Cc, dm.hd);
  cudaFuncSetAttribute(depth_ctx_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       pl.bytes);
  const int blocks = batch * (dm.S / (16 * MT)) * dm.heads;
  depth_ctx_kernel<MT><<<blocks, NTHREADS, pl.bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(ctx), static_cast<const bf16*>(wp),
      static_cast<const float*>(A), static_cast<const float*>(B2), static_cast<const bf16*>(wk),
      static_cast<const bf16*>(wv), static_cast<bf16*>(out), dm, pl,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Ci, S), ctx (B, Cc, D, S), wp (Cc, Cc), wk/wv (Ci, Cc), out (B, Ci, S):
// bf16, contiguous; A, B2 (B, Cc) fp32. tile is 16 or 64 pixels and must
// divide S; Cc and Ci / heads must be multiples of 16.
// Returns cudaGetLastError().
int md_depth_attention_ctx_fwd(const void* q, const void* ctx, const void* wp, const void* A,
                               const void* B2, const void* wk, const void* wv, void* out,
                               int batch, int D, int S, int Cc, int Ci, int heads, int tile,
                               float scale, void* stream) {
  if (heads <= 0 || Ci % heads != 0) return (int)cudaErrorInvalidValue;
  const Dims dm{D, S, Cc, Ci, heads, Ci / heads};
  if (Cc % 16 != 0 || dm.hd % 16 != 0 || S % tile != 0) return (int)cudaErrorInvalidValue;
  if (Plan(tile, Cc, dm.hd).bytes > 232448) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 64) return launch<4>(q, ctx, wp, A, B2, wk, wv, out, batch, dm, scale, s);
  if (tile == 16) return launch<1>(q, ctx, wp, A, B2, wk, wv, out, batch, dm, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* md_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
