// Fused depth-context attention of the DepthTransformers at the narrow
// levels (W=8, W=4), on Hopper: kernel K1's cluster design.
//
// Replaces: the JAX package's ops/depth_attention.py::_ctx_kernel (:236,
// launched by _ctx_pallas :298) at the main path's two narrow levels, (W,
// D, Cc, Ci) = (8, 12, 256, 512) and (4, 6, 512, 1024), 4 heads. Per pixel (b, s) and head n, as depth_attention_ctx.cu:
//   p_d = Wp x_d;  y_d = relu(p_d * A[b] + B2[b]);  k_d = Wk y_d;  v_d = Wv y_d
//   out = sum_d softmax_d(q . k_d * hd^-1/2) v_d      (before to_out)
// p is fp32, y is rounded to bf16, k, v and the softmax stay fp32.
//
// What bounds it on the H100: 10*B*D*S*Cc^2 FLOP (the projection Cc^2, k
// and v 2*Cc*Ci each, Ci = 2*Cc) against one read of ctx and the weights:
// 8.08 GFLOP at W=8 and 4.03 at W=4 (B=16), 0.0082 and 0.0041 ms at the
// tensor cores' peak; bound by operations. The weights do not fit one
// block's shared memory (Wp + Wk + Wv are 640 KB at W=8 and 2.5 MB at W=4),
// and a level has only 16 (W=8) or 4 (W=4) tiles of 64 rows at B=16.
// Measured (chip_smoke.py, H100 SXM at 700 W, device time at B=16): ~0.07
// ms at W=8 and ~0.05 ms at W=4, 8 - 12% of the bound, where the port's
// first, WMMA design (depth_attention_ctx.cu) takes 0.44 and 0.70 ms. Per
// depth the chain waits on the y exchange, the cluster barrier and, at W=4,
// a ring of two slots (PERF.md).
//
// Design: one thread-block cluster of R = Cc / 32 blocks (8 at W=8, 16 at
// W=4: the non-portable size) per tile of 64 rows, the rows wgmma takes. A
// row is a (sample, pixel): at W=8 a tile is one sample's 64 pixels, at W=4
// four samples' 16 (a ragged last group of samples is zero-filled by TMA
// and not stored). Each block is one warpgroup of 128 threads per tile; a
// cluster takes one tile, or two (TPC = 2, at Cc = 256 only: two
// warpgroups a block, sharing the held weights and the Wp chunks) where
// more tiles than the card holds clusters at once would otherwise run in a
// second wave (W=8 at B=16: 16 clusters of 8; the H100 holds 15). Block r
// owns
//  * 32 output channels of the projection: it computes p_r = X_d Wp_r^T
//    once per row and depth (no head recomputes it) and y_r = relu(p_r A +
//    B2) in bf16 into its own y buffer, where y is K-major in 32-channel
//    column blocks of the 64-byte swizzle, so y_r is one contiguous 4 KB
//    block; R - 1 threads copy it into the peers' y buffers by DSMEM bulk
//    copies that complete on the peer's mbarrier, on which each block waits
//    for all of y (64 x Cc), the A operand of its k/v product;
//  * 64 channels of k and the same 64 of v (a slice of one head; a head is
//    hd / 64 consecutive blocks), whose Wk and Wv rows it loads once and
//    holds (64 or 128 KB). It writes its partial logit q . k_r over its
//    channels into each of its head's blocks (DSMEM stores); after a cluster
//    barrier each block adds its head's partials in rank order from its own
//    shared memory, so the online softmax is the same, bit for bit, in every
//    block of a head. o accumulates in registers, and each block writes its
//    own 64 channels of out: nothing of o is reduced across blocks.
// ctx and Wp_r stream per depth in 64-channel chunks through a ring of
// STAGES slots filled by TMA (ctx as the MN-major A operand: a 4-D map {S,
// Cc, B, D} whose box {S, 64, 64 / S, 1} lands a chunk as [sample][channel]
// [pixel], rows of 2S bytes in the swizzle of that span, which wgmma reads
// as 64 / S groups of S rows; Wp_r as [row][channel], K-major B), issued by
// one thread of the block itself (no producer warp: every thread takes
// part in the cluster barriers; copies issued by the threads themselves, by
// cp.async, held the chain up ~1000 cycles a chunk). All products run
// on wgmma: the projection m64n32k16 (transposed A), k and v m64n64k16. One
// cluster barrier a depth: it also keeps peers from writing the next y into
// a block before its k/v product has read this one (the y buffer is single;
// at W=4 two would not fit beside the held weights).
//
// The plan (cluster size, tiles a cluster, ring stages, shared memory) is
// ops/depth_attention.py::ctx_cluster_plan; md_depth_attention_ctx_cluster_
// smem_bytes exports this file's size for comparison. The launcher encodes
// the four tensor maps, raises the shared-memory limit (and the cluster-size
// limit at 16) once per device and returns every CUDA error.
// Layout: q and out (B, Ci, S) channels-first, ctx (B, Cc, D, S), Wp (Cc,
// Cc), Wk and Wv (Ci, Cc) in nn.Linear (out, in) layout, A and B2 (B, Cc)
// fp32, S = H * W; bf16, contiguous; ctx, the weights and out 16-byte
// aligned.

#include <math.h>

#include "cluster_common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int ROWS = 64;      // rows of a tile: wgmma's M
constexpr int WG = 128;       // a warpgroup: the threads of a tile
constexpr int NP = 32;        // projection channels a block owns
constexpr int KV = 64;        // k (and v) channels a block owns
constexpr int CHUNK = 64;     // channels of a ring slot: one 128-byte swizzle row
constexpr int MAX_STAGES = 8;
constexpr int Y_SLICE = ROWS * NP * 2;  // a block's slice of y: 4 KB

// Shared memory of a block (byte offsets, the tiles 1024-byte aligned): the
// held Wk and Wv slices (64-channel column blocks, 128-byte swizzle), y per
// tile (32-channel column blocks, 64-byte swizzle), the ring (per tile a
// ctx chunk [64 channels][64 rows], then a Wp_r chunk [32 rows][64
// channels]), per tile the partial logits of the head's blocks (two depths
// x R x 64 fp32), the mbarriers (setup, y per tile, one per slot). The same
// arithmetic is ops/depth_attention.py::_cluster_smem.
template <int CC, int TPC>
struct Clu {
  static constexpr int R = CC / NP;          // blocks of a cluster
  static constexpr int CB = CC / CHUNK;      // 64-channel column blocks of Wk, Wv
  static constexpr int W_BLOCK = KV * ROW_BYTES;
  static constexpr int X_BYTES = CHUNK * ROW_BYTES;
  static constexpr int STAGE_BYTES = TPC * X_BYTES + NP * ROW_BYTES;
  static constexpr int WK = 0;
  static constexpr int WV = WK + CB * W_BLOCK;
  static constexpr int Y = WV + CB * W_BLOCK;    // tile w's y at Y + w * Y_BYTES
  static constexpr int Y_BYTES = R * Y_SLICE;
  static constexpr int RING = Y + TPC * Y_BYTES;
  static constexpr int PART_TILE = 2 * R * ROWS * 4;
  static constexpr int PART_BYTES = TPC * PART_TILE;
  static constexpr int BAR_BYTES = 8 * (1 + TPC + MAX_STAGES);
  static constexpr int FIXED = RING + PART_BYTES + BAR_BYTES + 1024;  // + 1024 B alignment
  static constexpr int FIT = (MAX_BLOCK_SMEM - FIXED) / STAGE_BYTES;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int PART = RING + STAGES * STAGE_BYTES;
  static constexpr int BAR = PART + PART_BYTES;
  static constexpr int BYTES = BAR + BAR_BYTES + 1024;
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(BYTES <= MAX_BLOCK_SMEM, "a block's shared memory");
};

// Chunk t of the stream (depth t / CB, channels (t % CB) * 64 ..) into the
// ring slot at `slot` by TMA, completing on the mbarrier bar: the ctx chunk
// of each of the cluster's tiles (samples b0, b0 + 64 / S, ...; a tile past
// the batch is all zeros), then Wp_r's.
template <int CC, int TPC>
__device__ __forceinline__ void load_chunk(uint32_t slot, uint32_t bar, const CUtensorMap* ctx_map,
                                           const CUtensorMap* wp_map, int t, int b0, int S,
                                           int rank) {
  using P = Clu<CC, TPC>;
  const int d = t / P::CB, c0 = (t % P::CB) * CHUNK;
  mbar_expect_tx(bar, P::STAGE_BYTES);
  for (int w = 0; w < TPC; ++w)
    tma_load_4d(slot + w * P::X_BYTES, ctx_map, bar, 0, c0, b0 + w * (ROWS / S), d);
  tma_load_2d(slot + TPC * P::X_BYTES, wp_map, bar, c0, rank * NP);
}

__device__ __forceinline__ uint32_t load_bf16_pair(const bf16* p, long i, long j, bool ok) {
  if (!ok) return 0u;
  const uint32_t lo = __bfloat16_as_ushort(p[i]), hi = __bfloat16_as_ushort(p[j]);
  return lo | (hi << 16);
}

// CC = Cc, TPC = tiles a cluster. Block: rank r of cluster c; warpgroup w
// takes tile c * TPC + w, rows (sample b0 + m / S, pixel m % S) for m < 64;
// q, k, v, out channels r * 64 .. r * 64 + 63.
template <int CC, int TPC>
__global__ void __launch_bounds__(WG * TPC, 1)
    md_ctx_cluster_kernel(const __grid_constant__ CUtensorMap ctx_map,
                          const __grid_constant__ CUtensorMap wp_map,
                          const __grid_constant__ CUtensorMap wk_map,
                          const __grid_constant__ CUtensorMap wv_map, const bf16* __restrict__ q,
                          const float* __restrict__ A, const float* __restrict__ B2,
                          bf16* __restrict__ out, int batch, int D, int S, int heads,
                          float scale_log2) {
  using P = Clu<CC, TPC>;
  constexpr int Ci = 2 * CC;
  unsigned char* smem;
  const uint32_t base = aligned_smem(smem);
  const uint32_t bar_setup = base + P::BAR, bar_full = bar_setup + 8 * (1 + TPC);
  const int tid = threadIdx.x, wg = tid / WG, wtid = tid % WG, warp = wtid / 32, lane = tid % 32;
  const uint32_t bar_y = bar_setup + 8 * (1 + wg);  // this tile's
  const int rank = blockIdx.x % P::R, cluster_id = blockIdx.x / P::R;
  const int b0 = cluster_id * TPC * (ROWS / S);  // the cluster's first sample
  const int bt = b0 + wg * (ROWS / S);           // this tile's
  const int c0 = rank * KV;                       // this block's q, k, v, out channels
  const int hpb = Ci / heads / KV;                // blocks of a head
  const int head0 = rank / hpb * hpb;             // the head's first rank
  const int total = D * P::CB;                    // chunks of the stream

  if (tid == 0) {
    for (int i = 0; i < 1 + TPC; ++i) mbar_init(bar_setup + 8 * i, 1);  // setup, y per tile
    for (int s = 0; s < P::STAGES; ++s) mbar_init(bar_full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // every block of the cluster is running (and its y mbarrier initialised)
  // before any copies into a peer
  cluster_arrive();
  if (tid == 0) {  // the held k/v weight slices, then the ring's first chunks
    mbar_expect_tx(bar_setup, 2 * P::CB * P::W_BLOCK);
    for (int cb = 0; cb < P::CB; ++cb) {
      tma_load_2d(base + P::WK + cb * P::W_BLOCK, &wk_map, bar_setup, cb * CHUNK, c0);
      tma_load_2d(base + P::WV + cb * P::W_BLOCK, &wv_map, bar_setup, cb * CHUNK, c0);
    }
    for (int t = 0; t < P::STAGES - 1 && t < total; ++t)
      load_chunk<CC, TPC>(base + P::RING + t * P::STAGE_BYTES, bar_full + 8 * t, &ctx_map, &wp_map,
                          t, b0, S, rank);
  }

  // this thread's rows r and r + 8 (the wgmma fragment layout; one sample,
  // as S >= 16) and columns 8j + c2, 8j + c2 + 1 of each 8-column chunk j
  const int r = warp * 16 + lane / 4, c2 = 2 * (lane % 4);
  const int bs = bt + warp * 16 / S;
  const bool live = bs < batch;
  const long px0 = static_cast<long>(bs) * Ci * S + r % S, px1 = px0 + 8;
  float2 av[NP / 8], bv[NP / 8];
#pragma unroll
  for (int j = 0; j < NP / 8; ++j) {
    const long i = static_cast<long>(bs) * CC + rank * NP + 8 * j + c2;
    av[j] = live ? make_float2(A[i], A[i + 1]) : make_float2(0.f, 0.f);
    bv[j] = live ? make_float2(B2[i], B2[i + 1]) : make_float2(0.f, 0.f);
  }
  uint2 qf[KV / 8];  // q of rows r, r + 8 at the thread's k columns, bf16 pairs
#pragma unroll
  for (int j = 0; j < KV / 8; ++j) {
    const long c = static_cast<long>(c0 + 8 * j + c2) * S;
    qf[j] = make_uint2(load_bf16_pair(q, px0 + c, px0 + c + S, live),
                       load_bf16_pair(q, px1 + c, px1 + c + S, live));
  }

  float o[KV / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float pacc[NP / 2], kacc[KV / 2], vacc[KV / 2];
#pragma unroll
  for (int i = 0; i < KV / 2; ++i) o[i] = kacc[i] = vacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) pacc[i] = 0.f;
  // this tile's partial logits: [depth % 2][head block][row]
  float* part = reinterpret_cast<float*>(smem + P::PART + wg * P::PART_TILE);
  const int in_head = rank - head0;

  for (int d = 0; d < D; ++d) {
    // 1. p_r = X_d Wp_r^T over the depth's chunks; chunk t + STAGES - 1 is
    // loaded into the slot of chunk t - 1 once every warp's product of that
    // one is done
#pragma unroll 1
    for (int kc = 0; kc < P::CB; ++kc) {
      const int t = d * P::CB + kc, s = t % P::STAGES;
      mbar_wait(bar_full + 8 * s, (t / P::STAGES) & 1);
      wgmma_wait<0>();
      __syncthreads();
      const int next = t + P::STAGES - 1;
      if (tid == 0 && next < total)
        load_chunk<CC, TPC>(base + P::RING + (next % P::STAGES) * P::STAGE_BYTES,
                            bar_full + 8 * (next % P::STAGES), &ctx_map, &wp_map, next, b0, S,
                            rank);
      const uint32_t slot = base + P::RING + s * P::STAGE_BYTES;
      const uint64_t dx = mn_desc(slot + wg * P::X_BYTES, 2 * S, CHUNK * 2 * S, 16 * S);
      const uint64_t dw = sw128_desc(slot + TPC * P::X_BYTES, 16);
      fence_regs(pacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss32_mn_a(pacc, dx + kk * 2 * S, dw + 2 * kk, kc + kk);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(pacc);

    // 2. y_r = relu(p_r A + B2) in bf16 into this block's slice of y, then
    // into every peer's: R - 1 bulk copies of the contiguous 4 KB slice
    const int yt = P::Y + wg * P::Y_BYTES;  // this tile's y
    unsigned char* ys = smem + yt + rank * Y_SLICE;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      const float* pj = pacc + 4 * j;
      *reinterpret_cast<uint32_t*>(ys + sw64_offset(r, 8 * j + c2)) =
          pack_bf16(fmaxf(fmaf(pj[0], av[j].x, bv[j].x), 0.f),
                    fmaxf(fmaf(pj[1], av[j].y, bv[j].y), 0.f));
      *reinterpret_cast<uint32_t*>(ys + sw64_offset(r + 8, 8 * j + c2)) =
          pack_bf16(fmaxf(fmaf(pj[2], av[j].x, bv[j].x), 0.f),
                    fmaxf(fmaf(pj[3], av[j].y, bv[j].y), 0.f));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the bulk copies
    __syncthreads();
    if (d == 0) cluster_wait();  // every peer is running
    if (wtid == 0) mbar_expect_tx(bar_y, (P::R - 1) * Y_SLICE);
    if (wtid >= 1 && wtid < P::R) {  // lane p copies to the peer p ranks on: issued side by side
      const uint32_t src = base + yt + rank * Y_SLICE;
      const int dst = (rank + wtid) % P::R;
      bulk_copy_to_peer(peer_addr(src, dst), src, Y_SLICE, peer_addr(bar_y, dst));
    }
    mbar_wait(bar_y, d & 1);  // all of y_d is here

    // 3. k_r = y Wk_r^T and v_r = y Wv_r^T, two groups, looped over the
    // 64-channel column blocks of Wk, Wv (two of y's each; unrolled whole,
    // the descriptors computed ahead spilled); the partial logit over this
    // block's channels while v runs
    const uint32_t sb = opaque(base);
    const uint64_t dy = sw64_desc(sb + yt), dk = sw128_desc(sb + P::WK, 16);
    const uint64_t dv = sw128_desc(sb + P::WV, 16);
    if (d == 0) mbar_wait(bar_setup, 0);
    fence_regs(kacc);
    fence_regs(vacc);
    wgmma_fence();
#pragma unroll 1
    for (int cb = 0; cb < P::CB; ++cb) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss64(kacc, dy + (2 * cb + kk / 2) * (Y_SLICE >> 4) + 2 * (kk % 2),
                   dk + cb * (P::W_BLOCK >> 4) + 2 * kk, cb + kk);
    }
    wgmma_commit();
#pragma unroll 1
    for (int cb = 0; cb < P::CB; ++cb) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss64(vacc, dy + (2 * cb + kk / 2) * (Y_SLICE >> 4) + 2 * (kk % 2),
                   dv + cb * (P::W_BLOCK >> 4) + 2 * kk, cb + kk);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(kacc);
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < KV / 8; ++j) {
      const float2 qa = unpack_bf16(qf[j].x), qb = unpack_bf16(qf[j].y);
      s0 = fmaf(qa.x, kacc[4 * j], fmaf(qa.y, kacc[4 * j + 1], s0));
      s1 = fmaf(qb.x, kacc[4 * j + 2], fmaf(qb.y, kacc[4 * j + 3], s1));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, x);
      s1 += __shfl_xor_sync(0xffffffffu, s1, x);
    }
    float* mine = part + ((d & 1) * P::R + in_head) * ROWS;  // this block's row of partials
    if (lane % 4 == 0)
      for (int p = head0; p < head0 + hpb; ++p) {
        float* dst = peer(mine, p);
        dst[r] = s0;
        dst[r + 8] = s1;
      }
    wgmma_wait<0>();  // y is read: peers may overwrite it after the barrier
    fence_regs(vacc);
    cluster_arrive();
    cluster_wait();  // every block's partial logits are in its head's blocks

    // 4. the head's logits, its blocks in rank order; the online softmax
    const float* heads_part = part + (d & 1) * P::R * ROWS;
    float t0 = 0.f, t1 = 0.f;
    for (int p = 0; p < hpb; ++p) {
      t0 += heads_part[p * ROWS + r];
      t1 += heads_part[p * ROWS + r + 8];
    }
    t0 *= scale_log2;
    t1 *= scale_log2;
    const float mn0 = fmaxf(m[0], t0), mn1 = fmaxf(m[1], t1);
    const float corr0 = ex2(m[0] - mn0), corr1 = ex2(m[1] - mn1);
    const float p0 = ex2(t0 - mn0), p1 = ex2(t1 - mn1);
    m[0] = mn0;
    m[1] = mn1;
    l[0] = fmaf(l[0], corr0, p0);
    l[1] = fmaf(l[1], corr1, p1);
#pragma unroll
    for (int j = 0; j < KV / 8; ++j) {
      o[4 * j] = fmaf(p0, vacc[4 * j], o[4 * j] * corr0);
      o[4 * j + 1] = fmaf(p0, vacc[4 * j + 1], o[4 * j + 1] * corr0);
      o[4 * j + 2] = fmaf(p1, vacc[4 * j + 2], o[4 * j + 2] * corr1);
      o[4 * j + 3] = fmaf(p1, vacc[4 * j + 3], o[4 * j + 3] * corr1);
    }
  }

  // epilogue: o / l in bf16 staged [channel][row] in this tile's part of
  // the first ring slot (idle now), then 16-byte stores of 8 pixels of a channel. After the last
  // cluster barrier no block reads or writes a peer's shared memory, so a
  // block may exit while its peers run on.
  bf16* st = reinterpret_cast<bf16*>(smem + P::RING + wg * P::X_BYTES);
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
#pragma unroll
  for (int j = 0; j < KV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[(8 * j + c2 + (e & 1)) * ROWS + r + 8 * (e >> 1)] =
          __float2bfloat16(o[4 * j + e] * (e < 2 ? inv0 : inv1));
  __syncthreads();
  for (int i = wtid; i < KV * ROWS / 8; i += WG) {
    const int c = i / (ROWS / 8), row = 8 * (i % (ROWS / 8)), b = bt + row / S;
    if (b < batch)
      *reinterpret_cast<uint4*>(out + (static_cast<long>(b) * Ci + c0 + c) * S + row % S) =
          *reinterpret_cast<const uint4*>(st + c * ROWS + row);
  }
}

template <int CC, int TPC>
bool (&smem_flags())[MAX_DEVICES] {
  static bool done[MAX_DEVICES] = {};
  return done;
}

template <int CC, int TPC>
bool (&cluster_flags())[MAX_DEVICES] {
  static bool done[MAX_DEVICES] = {};
  return done;
}

// Raise the kernel's limits (shared memory; the cluster size above 8) on
// the current device, once.
template <int CC, int TPC>
int prepare() {
  const void* k = reinterpret_cast<const void*>(md_ctx_cluster_kernel<CC, TPC>);
  int err = allow_smem(k, Clu<CC, TPC>::BYTES, smem_flags<CC, TPC>());
  if (err == 0 && Clu<CC, TPC>::R > MAX_CLUSTER)
    err = allow_cluster16(k, cluster_flags<CC, TPC>());
  return err;
}

// The shapes the kernel takes: Ci = 2 Cc, head_dim a multiple of 64, S
// (pixels a sample) 16, 32 or 64; 0 if taken.
int check_shape(int batch, int D, int S, int Ci, int heads, int CC) {
  if (batch < 1 || D < 1 || heads < 1 || Ci != 2 * CC || Ci % heads != 0 ||
      (Ci / heads) % KV != 0 || (S != 16 && S != 32 && S != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <int CC, int TPC>
int launch(const void* q, const void* ctx, const void* wp, const void* A, const void* B2,
           const void* wk, const void* wv, void* out, int batch, int D, int S, int heads,
           float scale, cudaStream_t stream) {
  // ctx (B, Cc, D, S) as {S, Cc, B, D}: a box {S, 64, 64 / S, 1} holds a
  // chunk's 64 channels of 64 / S samples, rows of 2S bytes in the swizzle
  // of that span (TMA pads a row to the span)
  const cuuint64_t row = 2ull * S;
  const cuuint64_t ctx_dims[4] = {static_cast<cuuint64_t>(S), CC, static_cast<cuuint64_t>(batch),
                                  static_cast<cuuint64_t>(D)};
  const cuuint64_t ctx_strides[3] = {row * D, row * D * CC, row};
  const cuuint32_t ctx_box[4] = {static_cast<cuuint32_t>(S), CHUNK,
                                 static_cast<cuuint32_t>(ROWS / S), 1};
  const CUtensorMapSwizzle ctx_swizzle = S == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : S == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t wp_dims[2] = {CC, CC}, w_dims[2] = {CC, static_cast<cuuint64_t>(2 * CC)};
  const cuuint64_t w_strides[1] = {2ull * CC};
  const cuuint32_t wp_box[2] = {CHUNK, NP}, w_box[2] = {CHUNK, KV};
  EncodeTiled fn;
  CUtensorMap cm, wpm, wkm, wvm;
  int err = encoder(&fn);
  if (err == 0) err = encode_box(fn, &cm, ctx, 4, ctx_dims, ctx_strides, ctx_box, ctx_swizzle);
  if (err == 0) err = encode_box(fn, &wpm, wp, 2, wp_dims, w_strides, wp_box);
  if (err == 0) err = encode_box(fn, &wkm, wk, 2, w_dims, w_strides, w_box);
  if (err == 0) err = encode_box(fn, &wvm, wv, 2, w_dims, w_strides, w_box);
  if (err == 0) err = prepare<CC, TPC>();
  if (err != 0) return err;
  const int tiles = (batch + ROWS / S - 1) / (ROWS / S), clusters = (tiles + TPC - 1) / TPC;
  return launch_cluster(md_ctx_cluster_kernel<CC, TPC>,
                        static_cast<unsigned>(clusters * Clu<CC, TPC>::R), WG * TPC,
                        Clu<CC, TPC>::BYTES, Clu<CC, TPC>::R, stream, cm, wpm, wkm, wvm,
                        static_cast<const bf16*>(q), static_cast<const float*>(A),
                        static_cast<const float*>(B2), static_cast<bf16*>(out), batch, D, S,
                        heads, scale * LOG2E);
}

// The (Cc, tiles a cluster) the design is built for, as X(CC, TPC).
#define MD_CTX_CLUSTER_CONFIGS(X) X(256, 1) X(256, 2) X(512, 1)

}  // namespace

extern "C" {

// q (B, Ci, S), ctx (B, Cc, D, S), wp (Cc, Cc), wk/wv (Ci, Cc), out (B, Ci,
// S): bf16, contiguous, ctx, the weights and out 16-byte aligned; A, B2
// (B, Cc) fp32. Cc 256 or 512, Ci = 2 Cc, head_dim = Ci / heads a multiple
// of 64, S 16, 32 or 64, D >= 1; cluster must be Cc / 32 and tpc (tiles
// a cluster) 1, or 2 at Cc 256: the plan's.
// Returns cudaGetLastError(), the error of a limit's raise, or
// TENSOR_MAP_ERROR + the CUresult if a tensor map is refused.
int md_depth_attention_ctx_cluster(const void* q, const void* ctx, const void* wp, const void* A,
                                   const void* B2, const void* wk, const void* wv, void* out,
                                   int batch, int D, int S, int Cc, int Ci, int heads,
                                   int cluster, int tpc, float scale, void* stream) {
  if (cluster != Cc / NP || check_shape(batch, D, S, Ci, heads, Cc) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* copied[5] = {ctx, wp, wk, wv, out};
  for (const void* p : copied)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MD_CASE(CC, TPC)                                                                \
  if (Cc == CC && tpc == TPC)                                                           \
    return launch<CC, TPC>(q, ctx, wp, A, B2, wk, wv, out, batch, D, S, heads, scale, s);
  MD_CTX_CLUSTER_CONFIGS(MD_CASE)
#undef MD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of a block at (Cc, tiles a cluster), in bytes (0
// for one it is not built for).
int md_depth_attention_ctx_cluster_smem_bytes(int Cc, int tpc) {
#define MD_CASE(CC, TPC) \
  if (Cc == CC && tpc == TPC) return Clu<CC, TPC>::BYTES;
  MD_CTX_CLUSTER_CONFIGS(MD_CASE)
#undef MD_CASE
  return 0;
}

// cudaOccupancyMaxActiveClusters at (Cc, tiles a cluster): the clusters
// the card holds at once; minus the CUDA error if a limit's raise or the
// query is refused.
int md_depth_attention_ctx_cluster_max_clusters(int Cc, int tpc) {
#define MD_CASE(CC, TPC)                                                       \
  if (Cc == CC && tpc == TPC) {                                                \
    const int err = prepare<CC, TPC>();                                        \
    if (err != 0) return -err;                                                 \
    return max_active_clusters(md_ctx_cluster_kernel<CC, TPC>, WG * TPC,       \
                               Clu<CC, TPC>::BYTES, Clu<CC, TPC>::R);          \
  }
  MD_CTX_CLUSTER_CONFIGS(MD_CASE)
#undef MD_CASE
  return -static_cast<int>(cudaErrorInvalidValue);
}

const char* md_cuda_error_string(int code) {
  if (code >= TENSOR_MAP_ERROR) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
