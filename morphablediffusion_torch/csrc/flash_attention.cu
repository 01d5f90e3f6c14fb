// Flash attention forward for the UNet's 1024-token self-attention, on Hopper.
//
// Replaces: the library Pallas TPU kernel
// jax/experimental/pallas/ops/tpu/flash_attention.py::_flash_attention_kernel
// (:331), which the JAX package's models/layers.py::attention (:277-297)
// calls for self-attention with min(Lq, Lk) >= 1024: the five ds=1
// SpatialTransformers, 8 heads, head_dim 40, L=1024, bf16; B=32 at serving,
// B=8 in training.
//
// What bounds it on the H100: 4*B*H*L^2*hd = 43 GFLOP per call at B=32
// against 84 MB of q/k/v/out, so tensor-core operations: 0.0434 ms at the
// published bf16 peak. At head_dim 40 the L^2 exponentials of the softmax
// (268 M per call at B=32, on 16 special-function lanes per SM) cost more
// than the products, so every per-logit step stays in registers. Measured
// (chip_smoke.py, H100 SXM at 700 W) it takes ~0.165 ms at B=32, as long
// as F.scaled_dot_product_attention: what holds it back is each
// warpgroup's serial chain per key tile (Q K^T, softmax, P V, the next
// tile's barrier) with only four consumer warpgroups per SM (PERF.md).
//
// Design:
//  * one block per (sample*head, 128 queries): two consumer warpgroups of
//    64 query rows each and one producer warp; ~66 KB of shared memory, two
//    blocks per SM;
//  * the producer warp copies Q once and K, V tiles of 64 keys into a
//    3-stage ring with TMA (cp.async.bulk.tensor), completed on full/empty
//    mbarriers. The tensor maps are 4-D {head_dim, heads, L, batch} with a
//    box {64, 1, rows, 1} and 128-byte swizzle: TMA bounds-checks each
//    dimension, so columns past head_dim and rows past L arrive as zeros and
//    no head reads its neighbour's columns;
//  * S = Q K^T with wgmma m64n64k16, both operands K-major from shared
//    memory, ceil(head_dim / 16) k-steps (40 pads to 48, not 64); the fp32
//    S accumulator stays in registers;
//  * online softmax in registers: a row lives on the 4 threads of a quad (2
//    shuffles for its max); scale*log2(e) is folded into one FMA before ex2;
//    the row sum stays per thread until the end; keys >= L are set to -inf
//    explicitly (a zero-filled key row would give logit 0);
//  * O += P V with P converted to bf16 in registers as wgmma's A operand
//    (the m64nNk16 accumulator layout is the A-fragment layout) and V read
//    as an MN-major (transposed) B operand, N = head_dim; O is rescaled in
//    registers. No fp32 S, P or O is ever in shared memory;
//  * epilogue: O / l in bf16, staged in the warpgroup's own Q rows in the
//    swizzled layout and written by a TMA store, which clips rows >= L and
//    columns >= head_dim; and each row's fp32 logsumexp of the scaled logits
//    in natural log, lse (B, heads, L), which flash_attention_bwd.cu reads.
// Host side: the four tensor maps are encoded per call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (the
// library is not linked against libcuda), and passed as __grid_constant__
// kernel parameters; the shared-memory limit is raised once per device.
// The TMA, mbarrier and wgmma helpers are flash_common.cuh, which the
// backward kernels share.
// Layout: q, k, v, out are (B, L, num_heads * head_dim) row-major, the
// layout the to_q/to_k/to_v projections produce, so no transpose is needed.

#include <math.h>

#include "flash_common.cuh"

namespace {

constexpr int BQ = 128;                   // queries per block
constexpr int BK = 64;                    // keys per tile
constexpr int STAGES = 3;                 // depth of the K/V ring
constexpr int NCONSUMER = 256;            // two warpgroups
constexpr int NTHREADS = NCONSUMER + 32;  // and the producer warp
constexpr int Q_BYTES = BQ * ROW_BYTES;
constexpr int KV_BYTES = BK * ROW_BYTES;
constexpr int Q_OFF = 0;
constexpr int K_OFF = Q_OFF + Q_BYTES;
constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;  // q, full[STAGES], empty[STAGES]
constexpr int SMEM_BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;  // + 1024 B alignment
constexpr float LN2 = 0.6931471805599453f;

// HD = head_dim (a multiple of 8, at most 64).
template <int HD>
__global__ void __launch_bounds__(NTHREADS, HD <= 48 ? 2 : 1)
    md_flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap o_map, float* __restrict__ lse, int L,
                        int num_heads, float scale_log2) {
  constexpr int KSTEPS = (HD + 15) / 16;  // k16 steps of Q K^T
  constexpr int NO = HD / 2;              // O accumulator floats per thread
  unsigned char* smem;
  const uint32_t base = aligned_smem(smem);
  const uint32_t bar_q = base + BAR_OFF, bar_full = bar_q + 8, bar_empty = bar_full + 8 * STAGES;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y, b = bh / num_heads, h = bh % num_heads;
  const int ntiles = (L + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NCONSUMER / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCONSUMER) {  // the producer warp: one thread issues every copy
    if (tid == NCONSUMER) {
      mbar_expect_tx(bar_q, Q_BYTES);
      tma_load(base + Q_OFF, &q_map, bar_q, h, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(bar_empty + 8 * s, ((t / STAGES) - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * KV_BYTES);
        tma_load(base + K_OFF + s * KV_BYTES, &k_map, bar_full + 8 * s, h, t * BK, b);
        tma_load(base + V_OFF + s * KV_BYTES, &v_map, bar_full + 8 * s, h, t * BK, b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows wg*64 .. wg*64+63 of the block;
  // this thread holds rows r and r + 8 of them (the wgmma fragment layout),
  // columns 8j + c2, 8j + c2 + 1 of each 8-column chunk j
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r = warp * 16 + lane / 4, c2 = 2 * (lane % 4);
  const uint32_t q_tile = base + Q_OFF + wg * 64 * ROW_BYTES;
  const uint64_t dq = sw128_desc(q_tile, 16);

  float o[NO], sacc[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // log2-scaled max, sum

  mbar_wait(bar_q, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(bar_full + 8 * s, (t / STAGES) & 1);
    const uint64_t dk = sw128_desc(base + K_OFF + s * KV_BYTES, 16);
    const uint64_t dv = sw128_desc(base + V_OFF + s * KV_BYTES, 1024);

    // S = Q K^T: a k16 step is 32 bytes further along the 128-byte rows
    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) wgmma_ss64(sacc, dq + 2 * kk, dk + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);

    if ((t + 1) * BK > L) {  // the ragged last tile: keys >= L to -inf
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (t * BK + 8 * (i / 4) + c2 + (i & 1) >= L) sacc[i] = -INFINITY;
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
    const float corr0 = ex2(m0 - mn0), corr1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P = exp2(S * scale_log2 - m) in bf16: chunk j = 2kk + half of S is
    // half of the A fragment of P's k16 step kk (rows r, r + 8)
    uint32_t pa[4][4];
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = ex2(fmaf(sacc[4 * j], scale_log2, -mn0));
      const float p1 = ex2(fmaf(sacc[4 * j + 1], scale_log2, -mn0));
      const float p2 = ex2(fmaf(sacc[4 * j + 2], scale_log2, -mn1));
      const float p3 = ex2(fmaf(sacc[4 * j + 3], scale_log2, -mn1));
      s0 += p0 + p1;
      s1 += p2 + p3;
      pa[j / 2][2 * (j % 2)] = pack_bf16(p0, p1);
      pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * corr0 + s0;
    l1 = l1 * corr1 + s1;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= corr0;
      o[4 * j + 1] *= corr0;
      o[4 * j + 2] *= corr1;
      o[4 * j + 3] *= corr1;
    }

    // O += P V: a k16 step of V is 16 key rows, 2048 bytes further
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) WgmmaRS<HD>::mma(o, pa[kk], dv + kk * (2048 >> 4));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with the stage
  }

  // epilogue: the quad's partial row sums, O / l in bf16 into this warp's
  // own rows of the Q tile (their last reader, the final Q K^T, has
  // completed) in the 128-byte swizzle the tensor map expects, one TMA
  // store per warpgroup
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  stage_rows<HD>(smem + Q_OFF + wg * 64 * ROW_BYTES, o, r, c2, inv0, inv1);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  warpgroup_sync(wg);
  if (tid % 128 == 0) tma_store(&o_map, q_tile, h, q0 + wg * 64, b);

  if (lane % 4 == 0) {  // natural-log logsumexp of the scaled logits
    const int row = q0 + wg * 64 + r;
    float* out_lse = lse + static_cast<long>(bh) * L;
    if (row < L) out_lse[row] = (m0 + log2f(l0)) * LN2;
    if (row + 8 < L) out_lse[row + 8] = (m1 + log2f(l1)) * LN2;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int batch, int L,
           int num_heads, float scale, cudaStream_t stream) {
  static bool smem_set[MAX_DEVICES] = {};
  EncodeTiled fn;
  CUtensorMap qm, km, vm, om;
  int err = encoder(&fn);
  if (err == 0) err = encode(fn, &qm, q, batch, L, num_heads, HD, BQ);
  if (err == 0) err = encode(fn, &km, k, batch, L, num_heads, HD, BK);
  if (err == 0) err = encode(fn, &vm, v, batch, L, num_heads, HD, BK);
  if (err == 0) err = encode(fn, &om, out, batch, L, num_heads, HD, 64);
  if (err == 0)
    err = allow_smem(reinterpret_cast<const void*>(md_flash_fwd_kernel<HD>), SMEM_BYTES, smem_set);
  if (err != 0) return err;
  const dim3 grid((L + BQ - 1) / BQ, batch * num_heads);
  md_flash_fwd_kernel<HD><<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      qm, km, vm, om, lse, L, num_heads, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, out: (batch, L, num_heads * head_dim) bf16, contiguous, 16-byte
// aligned; lse: (batch, num_heads, L) fp32. head_dim must be a multiple of 8
// and at most 64; L >= 1. Returns cudaGetLastError(), or TENSOR_MAP_ERROR +
// the CUresult if a tensor map is refused.
int md_flash_attention_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                           int batch, int L, int num_heads, int head_dim, float scale,
                           void* stream) {
  if (head_dim % 8 != 0 || head_dim > 64 || head_dim <= 0 || L < 1 || batch < 1 ||
      num_heads < 1 || lse == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (head_dim) {
    case 8: return launch<8>(q, k, v, out, l, batch, L, num_heads, scale, s);
    case 16: return launch<16>(q, k, v, out, l, batch, L, num_heads, scale, s);
    case 24: return launch<24>(q, k, v, out, l, batch, L, num_heads, scale, s);
    case 32: return launch<32>(q, k, v, out, l, batch, L, num_heads, scale, s);
    case 40: return launch<40>(q, k, v, out, l, batch, L, num_heads, scale, s);
    case 48: return launch<48>(q, k, v, out, l, batch, L, num_heads, scale, s);
    case 56: return launch<56>(q, k, v, out, l, batch, L, num_heads, scale, s);
    default: return launch<64>(q, k, v, out, l, batch, L, num_heads, scale, s);
  }
}

// Dynamic shared memory of a block of md_flash_fwd_kernel, in bytes.
int md_flash_attention_fwd_smem_bytes(void) { return SMEM_BYTES; }

// Blocks of md_flash_fwd_kernel<40> that fit on one SM, once a head_dim 40
// launch has raised its shared-memory limit.
int md_flash_attention_fwd_blocks_per_sm(void) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, md_flash_fwd_kernel<40>, NTHREADS,
                                                SMEM_BYTES);
  return n;
}

const char* md_cuda_error_string(int code) {
  if (code >= TENSOR_MAP_ERROR) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
