// Fused depth-context attention of the DepthTransformers, on Hopper.
//
// Replaces: the JAX package's ops/depth_attention.py::_ctx_kernel
// (:236-276, launched by _ctx_pallas :279-313). Per pixel (b, s) and head n:
//   p_d = Wp x_d;  y_d = relu(p_d * A[b] + B2[b]);  k_d = Wk y_d;  v_d = Wv y_d
//   out = sum_d softmax_d(q . k_d * hd^-1/2) v_d      (before to_out)
// over the D frustum depths, without writing any (B, D, H, W, C) tensor.
// Like the TPU kernel, p is fp32 and y is rounded to bf16; k, v and the
// softmax stay fp32.
//
// What bounds it on the H100: per call 10*B*D*S*Cc^2 FLOP (proj Cc^2, k and
// v 2*Cc*Ci each, Ci = 2*Cc) against one read of ctx. At the main-path shapes
// (B=16) that is 4.0-32.6 GFLOP against 5.3-109 MB: bound by tensor-core
// operations at the narrow levels, and by both alike at W=32 (0.033 ms
// each). Measured (chip_smoke.py, H100 SXM at 700 W, device time at B=16)
// the Hopper design below takes ~0.083 ms at W=32 and ~0.041 ms at W=16,
// ~40% of the bound, where the WMMA design takes 1.46 and 0.60 ms (PERF.md).
//
// Two designs, chosen by shape before launch (ops/depth_attention.py::
// ctx_design), with a third in depth_attention_ctx_cluster.cu (the narrow
// levels, W=8 and W=4); a shape that none takes is refused.
//
// 1. The Hopper design, md_ctx_wgmma_kernel<Cc, hd, G> (md_depth_attention_
//    ctx_wgmma), for (Cc, hd) = (64, 32) and (128, 64), H*W a multiple of
//    64: the main path's two wide levels, W=32 and W=16, where every weight
//    fits whole in shared memory.
//  * one block per (sample, 64-pixel tile, group of G heads): one consumer
//    warpgroup, whose 64 rows are the tile's pixels, and one producer warp.
//    The projection is computed once per pixel and depth and serves the G
//    heads (G = 4 recomputes nothing; a smaller G buys blocks at narrow
//    grids for 1.2x or 1.6x the FLOPs);
//  * the producer warp loads Wp and the group's rows of Wk and Wv once per
//    block by TMA (2-D maps, 64-channel column blocks, 128-byte swizzle:
//    the K-major B operand of every product), q's [channel][pixel] tile
//    (3-D map), and then one ctx depth slice per depth into an mbarrier
//    ring (4-D map {S, D, Cc, B}, box {64, 1, Cc, 1}). A slice lands as
//    [channel][pixel], 128 bytes per channel: the 128-byte swizzle atom of
//    an MN-major A operand, so p = X_d Wp^T needs no transposing copy;
//  * per depth the chain stays in registers: p = X_d Wp^T by wgmma
//    (transpose-A, m64n64k16 per 64 output channels, fp32), the ctx stage
//    released as soon as that product completes; y = relu(p A + B2) packed
//    to bf16 A fragments (the accumulator layout is the A-fragment layout);
//    per head k_h = y Wk_h^T and v_h = y Wv_h^T by register-A wgmma
//    (m64n{hd}k16), v_h in flight while the logit q_h . k_h (the thread's
//    columns, then the quad's, by two shuffles) updates the online softmax
//    (running max and sum per pixel and head in registers); then o_h =
//    o_h c + p v_h in the accumulator's layout. q is read once from its
//    tile and kept in shared memory rearranged per thread (bf16 pairs in
//    the accumulator layout, one 8-byte load per chunk), which every head
//    reads at every depth: in registers all along it made ptxas spill. No
//    fp32 p, k, v or softmax state is ever in shared memory;
//  * epilogue: o / l in bf16 staged transposed, [channel][pixel], in q's
//    tile (out is channels-first) and written by one TMA store.
//
// 2. The WMMA design (the port's first), depth_ctx_kernel<MT>
//    (md_depth_attention_ctx_fwd), for every shape the other two do not
//    take (none on the main path since the cluster design took W=8, W=4):
//  * the depth axis is a loop with an ONLINE softmax (running max and sum
//    per pixel, fp32 accumulator of hd per pixel), so shared memory holds
//    one depth slice at a time;
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
//    operand is read as a fragment straight from global memory (L2); the P
//    rows of a tile reuse each weight fragment MT = P / 16 times.
//
// Both launchers raise the shared-memory limit once per device
// (flash_common.cuh::allow_smem) and return every CUDA error.
// Layout: q (B, Ci, S) and out (B, Ci, S) channels-first, ctx (B, Cc, D, S),
// Wp (Cc, Cc), Wk and Wv (Ci, Cc) in nn.Linear (out, in) layout, A and B2
// (B, Cc) fp32, with S = H * W.

#include <math.h>
#include <mma.h>

#include <type_traits>

#include "flash_common.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int MAX_SMEM = 232448;  // a block's shared memory on the H100

// ---------------------------------------------------------------------------
// 1. The Hopper design
// ---------------------------------------------------------------------------

constexpr int PX = 64;                      // pixels per block: wgmma's 64 rows
constexpr int WG_THREADS = 128;             // the consumer warpgroup
constexpr int HTHREADS = WG_THREADS + 32;   // and the producer warp

// Shared memory of a block (byte offsets, each tile 1024-byte aligned):
// Wp, Wk and Wv of the group in 64-channel column blocks, q's tile (later
// the output's), the ring of ctx slices, A and B2 (fp32), the mbarriers
// setup, full[STAGES], empty[STAGES].
template <int CC, int HD, int G>
struct Hop {
  static constexpr int STAGES = CC == 64 ? 4 : (G == 1 ? 2 : 3);
  static constexpr int CB = CC / 64;                   // column blocks of a weight row
  static constexpr int KSTEPS = CC / 16;               // k16 steps over the channels
  static constexpr int ROWS = G * HD;                  // q/out channels, Wk/Wv rows
  static constexpr int WP_BLOCK = CC * ROW_BYTES;
  static constexpr int W_BLOCK = ROWS * ROW_BYTES;
  static constexpr int X_BYTES = CC * ROW_BYTES;       // one depth slice [Cc][64 pixels]
  static constexpr int WP = 0;
  static constexpr int WK = WP + CB * WP_BLOCK;
  static constexpr int WV = WK + CB * W_BLOCK;
  static constexpr int Q = WV + CB * W_BLOCK;
  static constexpr int X = Q + ROWS * ROW_BYTES;       // also the setup copy's bytes
  static constexpr int AB = X + STAGES * X_BYTES;
  static constexpr int BAR = AB + 2 * CC * 4;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;  // + 1024 B alignment
  // blocks per SM that ptxas plans registers for: two fit in the SM's 228 KB
  // of shared memory (1 KB of it reserved per block) at <= 113 KB each
  static constexpr int MIN_BLOCKS = BYTES <= 113 * 1024 ? 2 : 1;
};

// The bf16 pair (row, col), (row + 1, col) of a tile in the 128-byte
// swizzle, packed as an A-fragment register (row in the low half).
__device__ __forceinline__ uint32_t bf16_pair(unsigned char* tile, int row, int col) {
  const bf16 lo = *reinterpret_cast<const bf16*>(tile + sw128_offset(row, col));
  const bf16 hi = *reinterpret_cast<const bf16*>(tile + sw128_offset(row + 1, col));
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// CC = Cc, HD = head_dim, G = heads per block. Block: pixels s0 .. s0 + 63
// of sample b, heads hg * G .. hg * G + G - 1.
template <int CC, int HD, int G>
__global__ void __launch_bounds__(HTHREADS, Hop<CC, HD, G>::MIN_BLOCKS)
    md_ctx_wgmma_kernel(const __grid_constant__ CUtensorMap ctx_map,
                        const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap out_map,
                        const __grid_constant__ CUtensorMap wp_map,
                        const __grid_constant__ CUtensorMap wk_map,
                        const __grid_constant__ CUtensorMap wv_map,
                        const float* __restrict__ A, const float* __restrict__ B2, int D,
                        int tiles, int groups, float scale_log2) {
  using P = Hop<CC, HD, G>;
  constexpr int NP = CC / 64;  // 64-column pieces of the projection
  constexpr int NO = HD / 2;   // accumulator floats per thread of a head
  unsigned char* smem;
  const uint32_t base = aligned_smem(smem);
  const uint32_t bar_setup = base + P::BAR, bar_full = bar_setup + 8;
  const uint32_t bar_empty = bar_full + 8 * P::STAGES;
  const int tid = threadIdx.x;
  const int hg = blockIdx.x % groups;
  const int tile = (blockIdx.x / groups) % tiles;
  const int b = blockIdx.x / (groups * tiles);
  const int s0 = tile * PX, c0 = hg * P::ROWS;

  float* ab = reinterpret_cast<float*>(smem + P::AB);  // A[CC], then B2[CC]
  for (int i = tid; i < 2 * CC; i += HTHREADS)
    ab[i] = i < CC ? A[static_cast<long>(b) * CC + i] : B2[static_cast<long>(b) * CC + i - CC];
  if (tid == 0) {
    mbar_init(bar_setup, 1);
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, WG_THREADS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= WG_THREADS) {  // the producer warp: one thread issues every copy
    if (tid == WG_THREADS) {
      mbar_expect_tx(bar_setup, P::X);
      for (int cb = 0; cb < P::CB; ++cb) {
        tma_load_2d(base + P::WP + cb * P::WP_BLOCK, &wp_map, bar_setup, cb * 64, 0);
        tma_load_2d(base + P::WK + cb * P::W_BLOCK, &wk_map, bar_setup, cb * 64, c0);
        tma_load_2d(base + P::WV + cb * P::W_BLOCK, &wv_map, bar_setup, cb * 64, c0);
      }
      tma_load_3d(base + P::Q, &q_map, bar_setup, s0, c0, b);
      for (int d = 0; d < D; ++d) {
        const int s = d % P::STAGES;
        if (d >= P::STAGES) mbar_wait(bar_empty + 8 * s, ((d / P::STAGES) - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, P::X_BYTES);
        tma_load_4d(base + P::X + s * P::X_BYTES, &ctx_map, bar_full + 8 * s, s0, d, 0, b);
      }
    }
    return;
  }

  // the consumer warpgroup: this thread holds pixels r and r + 8 (the wgmma
  // fragment layout), columns 8j + c2, 8j + c2 + 1 of each 8-column chunk j
  const int warp = tid / 32, lane = tid % 32;
  const int r = warp * 16 + lane / 4, c2 = 2 * (lane % 4);
  mbar_wait(bar_setup, 0);

  // q of the group's heads in the accumulator layout, bf16 pairs of pixels
  // r and r + 8, rearranged in place so that each thread reads its own with
  // one 8-byte load per 8-column chunk: qp[(h * HD / 8 + j) * 128 + tid]
  // (read per head and depth; in registers all along it would spill)
  uint2* qp = reinterpret_cast<uint2*>(smem + P::Q);
  {
    uint2 qf[G][HD / 8];
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int c = h * HD + 8 * j + c2;
        qf[h][j] = make_uint2(bf16_pair(smem + P::Q, c, r), bf16_pair(smem + P::Q, c, r + 8));
      }
    warpgroup_sync(0);
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) qp[(h * HD / 8 + j) * WG_THREADS + tid] = qf[h][j];
    warpgroup_sync(0);
  }

  float o[G][NO], m[G][2], l[G][2];
  float pacc[NP][32], kacc[NO], vacc[NO];
#pragma unroll
  for (int h = 0; h < G; ++h) {
#pragma unroll
    for (int i = 0; i < NO; ++i) o[h][i] = 0.f;
    m[h][0] = m[h][1] = -INFINITY;
    l[h][0] = l[h][1] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) pacc[n][i] = 0.f;
#pragma unroll
  for (int i = 0; i < NO; ++i) kacc[i] = vacc[i] = 0.f;
  const float2* a2 = reinterpret_cast<const float2*>(ab);
  const float2* b2 = a2 + CC / 2;

  for (int d = 0; d < D; ++d) {
    const int s = d % P::STAGES;
    const uint32_t sb = opaque(base);
    mbar_wait(bar_full + 8 * s, (d / P::STAGES) & 1);

    // p = X_d Wp^T: A the slice [channel][pixel] (MN-major), B Wp's rows
    // (K-major); a k16 step is 16 channel rows of X_d and 32 bytes along
    // Wp's rows (the next column block every 4 steps)
    const uint64_t dx = sw128_desc(sb + P::X + s * P::X_BYTES, 1024);
#pragma unroll
    for (int n = 0; n < NP; ++n) fence_regs(pacc[n]);
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int kk = 0; kk < P::KSTEPS; ++kk)
        wgmma_ss64_mn_a(pacc[n], dx + kk * 128,
                        sw128_desc(sb + P::WP + (kk / 4) * P::WP_BLOCK + n * 64 * ROW_BYTES, 16) +
                            2 * (kk % 4),
                        kk);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < NP; ++n) fence_regs(pacc[n]);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with the slice

    // y = relu(p A + B2) in bf16: chunks 2kk and 2kk + 1 of a 64-column
    // piece are the A fragment of k-step kk over the channels
    uint32_t yf[P::KSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < P::KSTEPS; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = kk / 4, j = 2 * (kk % 4) + half;
        const int c = n * 64 + 8 * j + c2;
        const float2 a = a2[c / 2], bb = b2[c / 2];
        const float* pj = pacc[n] + 4 * j;
        yf[kk][2 * half] =
            pack_bf16(fmaxf(fmaf(pj[0], a.x, bb.x), 0.f), fmaxf(fmaf(pj[1], a.y, bb.y), 0.f));
        yf[kk][2 * half + 1] =
            pack_bf16(fmaxf(fmaf(pj[2], a.x, bb.x), 0.f), fmaxf(fmaf(pj[3], a.y, bb.y), 0.f));
      }

#pragma unroll
    for (int h = 0; h < G; ++h) {
      // k_h = y Wk_h^T, then v_h = y Wv_h^T: two groups, v_h still running
      // while the logit and the softmax statistics are formed
      const uint32_t wk_h = sb + P::WK + h * HD * ROW_BYTES;
      const uint32_t wv_h = sb + P::WV + h * HD * ROW_BYTES;
      fence_regs(kacc);
      fence_regs(vacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < P::KSTEPS; ++kk)
        WgmmaRSK<HD>::mma(kacc, yf[kk], sw128_desc(wk_h + (kk / 4) * P::W_BLOCK, 16) + 2 * (kk % 4),
                          kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < P::KSTEPS; ++kk)
        WgmmaRSK<HD>::mma(vacc, yf[kk], sw128_desc(wv_h + (kk / 4) * P::W_BLOCK, 16) + 2 * (kk % 4),
                          kk);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(kacc);

      // logit of pixels r and r + 8: the thread's columns, then the quad's
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const uint2 qv = qp[(h * HD / 8 + j) * WG_THREADS + tid];
        const float2 qa = unpack_bf16(qv.x), qb = unpack_bf16(qv.y);
        s0 = fmaf(qa.x, kacc[4 * j], fmaf(qa.y, kacc[4 * j + 1], s0));
        s1 = fmaf(qb.x, kacc[4 * j + 2], fmaf(qb.y, kacc[4 * j + 3], s1));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, x);
        s1 += __shfl_xor_sync(0xffffffffu, s1, x);
      }
      s0 *= scale_log2;
      s1 *= scale_log2;
      const float mn0 = fmaxf(m[h][0], s0), mn1 = fmaxf(m[h][1], s1);
      const float corr0 = ex2(m[h][0] - mn0), corr1 = ex2(m[h][1] - mn1);
      const float p0 = ex2(s0 - mn0), p1 = ex2(s1 - mn1);
      m[h][0] = mn0;
      m[h][1] = mn1;
      l[h][0] = fmaf(l[h][0], corr0, p0);
      l[h][1] = fmaf(l[h][1], corr1, p1);

      wgmma_wait<0>();
      fence_regs(vacc);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[h][4 * j] = fmaf(p0, vacc[4 * j], o[h][4 * j] * corr0);
        o[h][4 * j + 1] = fmaf(p0, vacc[4 * j + 1], o[h][4 * j + 1] * corr0);
        o[h][4 * j + 2] = fmaf(p1, vacc[4 * j + 2], o[h][4 * j + 2] * corr1);
        o[h][4 * j + 3] = fmaf(p1, vacc[4 * j + 3], o[h][4 * j + 3] * corr1);
      }
    }
  }

  // epilogue: o / l in bf16, transposed into q's tile ([channel][pixel] in
  // the 128-byte swizzle the output map expects; once every thread has read
  // its q), one TMA store
  warpgroup_sync(0);
#pragma unroll
  for (int h = 0; h < G; ++h) {
    const float inv0 = 1.f / l[h][0], inv1 = 1.f / l[h][1];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = h * HD + 8 * j + c2 + (e & 1), px = r + 8 * (e >> 1);
        *reinterpret_cast<bf16*>(smem + P::Q + sw128_offset(c, px)) =
            __float2bfloat16(o[h][4 * j + e] * (e < 2 ? inv0 : inv1));
      }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  warpgroup_sync(0);
  if (tid == 0) tma_store_3d(&out_map, base + P::Q, s0, c0, b);
}

template <int CC, int HD, int G>
const void* wgmma_kernel() {
  return reinterpret_cast<const void*>(md_ctx_wgmma_kernel<CC, HD, G>);
}

template <int CC, int HD, int G>
bool (&wgmma_smem_flags())[MAX_DEVICES] {
  static bool done[MAX_DEVICES] = {};
  return done;
}

template <int CC, int HD, int G>
int launch_wgmma(const void* q, const void* ctx, const void* wp, const float* A, const float* B2,
                 const void* wk, const void* wv, void* out, int batch, int D, int S, int Ci,
                 int heads, float scale, cudaStream_t stream) {
  using P = Hop<CC, HD, G>;
  const cuuint64_t row = 2ull * S;  // bytes of one channel's (or depth's) pixels
  const cuuint64_t ctx_dims[4] = {static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(D), CC,
                                  static_cast<cuuint64_t>(batch)};
  const cuuint64_t ctx_strides[3] = {row, row * D, row * D * CC};
  const cuuint32_t ctx_box[4] = {PX, 1, CC, 1};
  const cuuint64_t q_dims[3] = {static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(Ci),
                                static_cast<cuuint64_t>(batch)};
  const cuuint64_t q_strides[2] = {row, row * Ci};
  const cuuint32_t q_box[3] = {PX, P::ROWS, 1};
  const cuuint64_t wp_dims[2] = {CC, CC}, w_dims[2] = {CC, static_cast<cuuint64_t>(Ci)};
  const cuuint64_t w_strides[1] = {2ull * CC};
  const cuuint32_t wp_box[2] = {64, CC}, w_box[2] = {64, P::ROWS};
  EncodeTiled fn;
  CUtensorMap cm, qm, om, wpm, wkm, wvm;
  int err = encoder(&fn);
  if (err == 0) err = encode_box(fn, &cm, ctx, 4, ctx_dims, ctx_strides, ctx_box);
  if (err == 0) err = encode_box(fn, &qm, q, 3, q_dims, q_strides, q_box);
  if (err == 0) err = encode_box(fn, &om, out, 3, q_dims, q_strides, q_box);
  if (err == 0) err = encode_box(fn, &wpm, wp, 2, wp_dims, w_strides, wp_box);
  if (err == 0) err = encode_box(fn, &wkm, wk, 2, w_dims, w_strides, w_box);
  if (err == 0) err = encode_box(fn, &wvm, wv, 2, w_dims, w_strides, w_box);
  if (err == 0)
    err = allow_smem(wgmma_kernel<CC, HD, G>(), P::BYTES, wgmma_smem_flags<CC, HD, G>());
  if (err != 0) return err;
  const int tiles = S / PX, groups = heads / G;
  md_ctx_wgmma_kernel<CC, HD, G><<<batch * tiles * groups, HTHREADS, P::BYTES, stream>>>(
      cm, qm, om, wpm, wkm, wvm, A, B2, D, tiles, groups, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// The (Cc, head_dim, G) the Hopper design is built for, as X(CC, HD, G).
#define MD_CTX_WGMMA_CONFIGS(X) X(64, 32, 4) X(64, 32, 2) X(128, 64, 2) X(128, 64, 1)

// ---------------------------------------------------------------------------
// 2. The WMMA design
// ---------------------------------------------------------------------------

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
  // the plan's bytes vary with the shape: the limit is raised to the most
  // a block may have, once per device
  static bool smem_set[MAX_DEVICES] = {};
  const Plan pl(16 * MT, dm.Cc, dm.hd);
  const int err =
      allow_smem(reinterpret_cast<const void*>(depth_ctx_kernel<MT>), MAX_SMEM, smem_set);
  if (err != 0) return err;
  const int blocks = batch * (dm.S / (16 * MT)) * dm.heads;
  depth_ctx_kernel<MT><<<blocks, NTHREADS, pl.bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(ctx), static_cast<const bf16*>(wp),
      static_cast<const float*>(A), static_cast<const float*>(B2), static_cast<const bf16*>(wk),
      static_cast<const bf16*>(wv), static_cast<bf16*>(out), dm, pl, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The WMMA design. q (B, Ci, S), ctx (B, Cc, D, S), wp (Cc, Cc), wk/wv
// (Ci, Cc), out (B, Ci, S): bf16, contiguous; A, B2 (B, Cc) fp32. tile is
// 16 or 64 pixels and must divide S; Cc and Ci / heads must be multiples of
// 16; D >= 1. Returns cudaGetLastError() or the error of the shared-memory
// raise.
int md_depth_attention_ctx_fwd(const void* q, const void* ctx, const void* wp, const void* A,
                               const void* B2, const void* wk, const void* wv, void* out,
                               int batch, int D, int S, int Cc, int Ci, int heads, int tile,
                               float scale, void* stream) {
  if (heads <= 0 || Ci % heads != 0 || D < 1) return (int)cudaErrorInvalidValue;
  const Dims dm{D, S, Cc, Ci, heads, Ci / heads};
  if (Cc % 16 != 0 || dm.hd % 16 != 0 || S % tile != 0) return (int)cudaErrorInvalidValue;
  if (Plan(tile, Cc, dm.hd).bytes > MAX_SMEM) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 64) return launch<4>(q, ctx, wp, A, B2, wk, wv, out, batch, dm, scale, s);
  if (tile == 16) return launch<1>(q, ctx, wp, A, B2, wk, wv, out, batch, dm, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The Hopper design. Same tensors, each also 16-byte aligned; (Cc,
// Ci / heads) is (64, 32) with group 4 or 2, or (128, 64) with group 2 or 1;
// group divides heads; S is a multiple of 64; D >= 1. Returns
// cudaGetLastError(), the error of the shared-memory raise, or
// TENSOR_MAP_ERROR + the CUresult if a tensor map is refused.
int md_depth_attention_ctx_wgmma(const void* q, const void* ctx, const void* wp, const void* A,
                                 const void* B2, const void* wk, const void* wv, void* out,
                                 int batch, int D, int S, int Cc, int Ci, int heads, int group,
                                 float scale, void* stream) {
  if (heads <= 0 || Ci % heads != 0 || group <= 0 || heads % group != 0 || batch < 1 || D < 1 ||
      S < PX || S % PX != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(A);
  const float* b2 = static_cast<const float*>(B2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hd = Ci / heads;
#define MD_CASE(CC, HD, G)                                                                  \
  if (Cc == CC && hd == HD && group == G)                                                  \
    return launch_wgmma<CC, HD, G>(q, ctx, wp, a, b2, wk, wv, out, batch, D, S, Ci, heads, \
                                   scale, s);
  MD_CTX_WGMMA_CONFIGS(MD_CASE)
#undef MD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of a block of the Hopper design, in bytes (0 for a
// configuration it is not built for).
int md_depth_attention_ctx_wgmma_smem_bytes(int Cc, int hd, int group) {
#define MD_CASE(CC, HD, G) \
  if (Cc == CC && hd == HD && group == G) return Hop<CC, HD, G>::BYTES;
  MD_CTX_WGMMA_CONFIGS(MD_CASE)
#undef MD_CASE
  return 0;
}

// Blocks of the Hopper design that fit on one SM (raising its shared-memory
// limit first, as a launch does); 0 for a configuration it is not built for
// or a refused raise.
int md_depth_attention_ctx_wgmma_blocks_per_sm(int Cc, int hd, int group) {
  int blocks = 0;
#define MD_CASE(CC, HD, G)                                                                   \
  if (Cc == CC && hd == HD && group == G) {                                                 \
    if (allow_smem(wgmma_kernel<CC, HD, G>(), Hop<CC, HD, G>::BYTES,                        \
                   wgmma_smem_flags<CC, HD, G>()) == 0)                                     \
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, md_ctx_wgmma_kernel<CC, HD, G>, \
                                                    HTHREADS, Hop<CC, HD, G>::BYTES);      \
  }
  MD_CTX_WGMMA_CONFIGS(MD_CASE)
#undef MD_CASE
  return blocks;
}

const char* md_cuda_error_string(int code) {
  if (code >= TENSOR_MAP_ERROR) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
