// Flash attention backward for the UNet's 1024-token self-attention, on
// Hopper.
//
// Replaces: the two backward Pallas TPU kernels of the library flash
// attention that the JAX package's models/layers.py::attention (:277-297)
// calls, reached through its custom VJP (_flash_attention_bwd):
//   _flash_attention_dkv_kernel (:796) -> dK, dV (md_flash_attention_bwd_dkv)
//   _flash_attention_dq_kernel (:1146) -> dQ     (md_flash_attention_bwd_dq)
// Training shape: B=8 samples (one target view each), L=1024, 8 heads,
// head_dim 40, bf16.
//
// With Z = scale * Q K^T, P = exp(Z - lse) (lse from the forward kernel),
// di = rowsum(dO * O) (computed in plain torch, as the library computes it
// outside its kernels):
//   dV = P^T dO,  dP = dO V^T,  dZ = P * (dP - di),
//   dQ = scale * dZ K,  dK = scale * dZ^T Q.
//
// What bounds it on the H100: dkv does 4 products of 2*L^2*hd each per
// (sample, head) and dq 3 (P and dP are rebuilt in both), 21.5 + 16.1 GFLOP
// at the training shape against ~6 MB each of q, k, v, dO, the gradients
// and the row statistics: tensor-core operations (0.0217 + 0.0163 ms at the
// published bf16 peak), as in the forward. Like the forward, at head_dim 40
// the per-logit work (an exponential and a few FMAs per element of P)
// rivals the products, so it stays in registers. Measured (chip_smoke.py,
// H100 SXM at 700 W, device time) K2-dkv takes ~0.071 ms and K2-dq ~0.056
// ms at the training shape, ~30% of the bound, and the pair about as long as
// the backward of F.scaled_dot_product_attention: what holds them back is
// the forward's limit, each warpgroup's serial chain per tile (two logit
// products, the exponentials, the gradient products), here with only two
// consumer warpgroups per SM (PERF.md).
//
// Design: FlashAttention-2's split into two kernels, so that no atomics are
// needed and the gradients are deterministic; each is the forward's
// machinery (flash_common.cuh) with more products:
//  * one block per (sample*head, 128 rows): two consumer warpgroups of 64
//    rows each and one producer warp, the forward's shape. K2-dq owns 128
//    queries and streams K, V; K2-dkv owns 128 keys and streams Q, dO with
//    their lse and di. One block per SM: K2-dkv's four fp32 accumulators
//    (S^T, dP^T, dK, dV) take 138 registers at head_dim 40 and K2-dq's three
//    110; at two blocks per SM ptxas spilled both, and one consumer
//    warpgroup per 64-row block at three blocks per SM spilled too (K2-dkv)
//    or ran slower (K2-dq);
//  * the producer warp copies the block's own tiles once and the streamed
//    tiles of 64 rows into a 4-stage ring with TMA, on full/empty mbarriers;
//    the same 4-D tensor maps as the forward zero-fill columns past head_dim
//    and rows past L. K2-dkv's producer lanes also copy the query tile's
//    lse * log2(e) and di into the stage with plain loads (a TMA map over
//    them would need L * 4 bytes to be a multiple of 16) and arrive on the
//    full barrier after their stores;
//  * every product is wgmma: the two logit-shaped ones (S = Q K^T and
//    dP = dO V^T in dq, S^T = K Q^T and dP^T = V dO^T in dkv) m64n64k16 with
//    both operands K-major in shared memory, ceil(head_dim / 16) k-steps;
//    the gradient ones (dQ += dS K; dV += P^T dO, dK += dS^T Q) m64n{hd}k16
//    with P or dS converted to bf16 in registers as the A operand (the
//    accumulator layout is the A-fragment layout) and the streamed or own
//    tile read as an MN-major B operand, the forward's V descriptor;
//  * P = exp2(S * scale * log2(e) - lse * log2(e)) and dS = P * (dP - di) are
//    formed in registers, in fp32, and rounded to bf16 only as operands: no
//    fp32 S, P, dP or dS is ever in shared memory. Keys >= L (dq) and
//    queries >= L (dkv) get P = 0 explicitly: a zero-filled row gives logit
//    0, not -inf;
//  * epilogue: each accumulator times its scale in bf16, staged in the
//    warpgroup's own tile rows (their last reader has completed) in the
//    swizzled layout and written by a TMA store, which clips rows >= L and
//    columns >= head_dim.
// Layout: q, k, v, dO, dq, dk, dv are (B, L, num_heads * head_dim) row-major;
// lse and di are (B, num_heads, L) fp32.

#include "flash_common.cuh"

namespace {

constexpr int TILE = 64;                      // rows of every tile
constexpr int TILE_BYTES = TILE * ROW_BYTES;  // 8 KB
constexpr int STAGES = 4;                     // depth of the ring
constexpr int NWG = 2;                        // consumer warpgroups per block

// Shared memory of a block: its own two tiles of 64 * NWG rows (dq: Q, dO;
// dkv: K, V), the ring's two tiles per stage (dq: K, V; dkv: Q, dO), with
// STATS the ring's lse * log2(e) and di per stage (dkv), and the mbarriers
// own, full[STAGES], empty[STAGES]: 97 – 99 KiB, one block per SM.
template <bool STATS>
struct Smem {
  static constexpr int OWN_A = 0;
  static constexpr int OWN_B = OWN_A + NWG * TILE_BYTES;
  static constexpr int RING_A = OWN_B + NWG * TILE_BYTES;
  static constexpr int RING_B = RING_A + STAGES * TILE_BYTES;
  static constexpr int STAT = RING_B + STAGES * TILE_BYTES;  // float [STAGES][2][TILE]
  static constexpr int BAR = STAT + (STATS ? STAGES * 2 * TILE * 4 : 0);
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;  // + 1024 B alignment
  static constexpr int THREADS = NWG * 128 + 32;
};

// Thread 0 initialises the mbarriers: own and full complete on the
// producer's copies (full also on STATS's 32 producer lanes), empty on one
// arrival per consumer warp.
template <bool STATS>
__device__ __forceinline__ void init_barriers(uint32_t base) {
  using S = Smem<STATS>;
  if (threadIdx.x == 0) {
    mbar_init(base + S::BAR, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(base + S::BAR + 8 + 8 * s, STATS ? 32 : 1);
      mbar_init(base + S::BAR + 8 * (1 + STAGES + s), NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer warp: the block's own tiles (rows row0 .. row0 + 64 * NWG)
// once, then every tile of 64 streamed rows into the ring; with STATS also
// each streamed tile's lse * log2(e) and di (0 past L) from the (sample,
// head)'s rows of lse and di.
template <bool STATS>
__device__ __forceinline__ void produce(uint32_t base, unsigned char* smem,
                                        const CUtensorMap* own_a, const CUtensorMap* own_b,
                                        const CUtensorMap* ring_a, const CUtensorMap* ring_b,
                                        const float* lse, const float* di, int h, int b,
                                        int row0, int L) {
  using S = Smem<STATS>;
  const int lane = threadIdx.x % 32;
  if (!STATS && lane != 0) return;
  const uint32_t bar_own = base + S::BAR, bar_full = bar_own + 8;
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  if (lane == 0) {
    mbar_expect_tx(bar_own, 2 * NWG * TILE_BYTES);
    tma_load(base + S::OWN_A, own_a, bar_own, h, row0, b);
    tma_load(base + S::OWN_B, own_b, bar_own, h, row0, b);
  }
  const int ntiles = (L + TILE - 1) / TILE;
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    if (t >= STAGES) mbar_wait(bar_empty + 8 * s, ((t / STAGES) - 1) & 1);
    if (STATS) {
      float* stat = reinterpret_cast<float*>(smem + S::STAT) + s * 2 * TILE;
      for (int i = lane; i < TILE; i += 32) {
        const int row = t * TILE + i;
        stat[i] = row < L ? lse[row] * LOG2E : 0.f;
        stat[TILE + i] = row < L ? di[row] : 0.f;
      }
    }
    if (lane == 0) {  // its arrival (after its own stores) sets the bytes to wait for
      mbar_expect_tx(bar_full + 8 * s, 2 * TILE_BYTES);
      tma_load(base + S::RING_A + s * TILE_BYTES, ring_a, bar_full + 8 * s, h, t * TILE, b);
      tma_load(base + S::RING_B + s * TILE_BYTES, ring_b, bar_full + 8 * s, h, t * TILE, b);
    } else {
      mbar_arrive(bar_full + 8 * s);
    }
  }
}

// Both logit-shaped products of a tile into fresh accumulators: d0 = A0
// B0^T and d1 = A1 B1^T, every operand K-major in shared memory.
template <int KSTEPS>
__device__ __forceinline__ void two_logit_products(float (&d0)[32], uint64_t a0, uint64_t b0,
                                                   float (&d1)[32], uint64_t a1, uint64_t b1) {
  fence_regs(d0);
  fence_regs(d1);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) wgmma_ss64(d0, a0 + 2 * kk, b0 + 2 * kk, kk);
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) wgmma_ss64(d1, a1 + 2 * kk, b1 + 2 * kk, kk);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d0);
  fence_regs(d1);
}

// HD = head_dim (a multiple of 8, at most 64). Block: queries row0 ..
// row0 + 128 of one (sample, head); warpgroup wg owns 64 of them.
template <int HD>
__global__ void __launch_bounds__(Smem<false>::THREADS, 1)
    md_flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const __grid_constant__ CUtensorMap dq_map,
                           const float* __restrict__ lse, const float* __restrict__ di, int L,
                           int num_heads, float scale) {
  using S = Smem<false>;
  constexpr int KSTEPS = (HD + 15) / 16;
  unsigned char* smem;
  const uint32_t base = aligned_smem(smem);
  const uint32_t bar_own = base + S::BAR, bar_full = bar_own + 8;
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * NWG * TILE;
  const int bh = blockIdx.y, b = bh / num_heads, h = bh % num_heads;
  const long stat = static_cast<long>(bh) * L;
  init_barriers<false>(base);
  if (tid >= NWG * 128) {
    produce<false>(base, smem, &q_map, &do_map, &k_map, &v_map, nullptr, nullptr, h, b, row0,
                   L);
    return;
  }

  // this thread holds rows r and r + 8 of its warpgroup's 64 (the wgmma
  // fragment layout), columns 8j + c2, 8j + c2 + 1 of each 8-column chunk j
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r = warp * 16 + lane / 4, c2 = 2 * (lane % 4);
  const int row = row0 + wg * TILE + r;
  const float lse0 = row < L ? lse[stat + row] * LOG2E : 0.f;
  const float lse1 = row + 8 < L ? lse[stat + row + 8] * LOG2E : 0.f;
  const float di0 = row < L ? di[stat + row] : 0.f;
  const float di1 = row + 8 < L ? di[stat + row + 8] : 0.f;
  const float scale_log2 = scale * LOG2E;
  const uint32_t q_tile = base + S::OWN_A + wg * TILE_BYTES;
  const uint64_t dq_ = sw128_desc(q_tile, 16);
  const uint64_t ddo = sw128_desc(base + S::OWN_B + wg * TILE_BYTES, 16);

  float acc[HD / 2], sacc[32], pacc[32];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.f;

  mbar_wait(bar_own, 0);
  const int ntiles = (L + TILE - 1) / TILE;
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(bar_full + 8 * s, (t / STAGES) & 1);
    const uint32_t k_tile = base + S::RING_A + s * TILE_BYTES;
    const uint32_t v_tile = base + S::RING_B + s * TILE_BYTES;

    // S = Q K^T, dP = dO V^T
    two_logit_products<KSTEPS>(sacc, dq_, sw128_desc(k_tile, 16), pacc, ddo,
                               sw128_desc(v_tile, 16));

    // dS = P * (dP - di), P = exp2(S * scale_log2 - lse2), keys >= L to 0;
    // chunk j = 2kk + half of dS is half of the A fragment of k-step kk
    const bool ragged = (t + 1) * TILE > L;
    uint32_t da[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ex2(fmaf(sacc[4 * j + e], scale_log2, e < 2 ? -lse0 : -lse1));
        if (ragged && t * TILE + 8 * j + c2 + (e & 1) >= L) p[e] = 0.f;
      }
      da[j / 2][2 * (j % 2)] =
          pack_bf16(p[0] * (pacc[4 * j] - di0), p[1] * (pacc[4 * j + 1] - di0));
      da[j / 2][2 * (j % 2) + 1] =
          pack_bf16(p[2] * (pacc[4 * j + 2] - di1), p[3] * (pacc[4 * j + 3] - di1));
    }

    // dQ += dS K: K as an MN-major B, a k-step is 16 key rows further
    const uint64_t dk_mn = sw128_desc(k_tile, 1024);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) WgmmaRS<HD>::mma(acc, da[kk], dk_mn + kk * 128);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with the stage
  }

  // epilogue: dQ * scale in bf16 into the warpgroup's own Q rows, one TMA
  // store per warpgroup
  stage_rows<HD>(smem + S::OWN_A + wg * TILE_BYTES, acc, r, c2, scale, scale);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  warpgroup_sync(wg);
  if (tid % 128 == 0) tma_store(&dq_map, q_tile, h, row0 + wg * TILE, b);
}

// Block: keys row0 .. row0 + 128 of one (sample, head); warpgroup wg owns
// 64 of them.
template <int HD>
__global__ void __launch_bounds__(Smem<true>::THREADS, 1)
    md_flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const __grid_constant__ CUtensorMap dk_map,
                            const __grid_constant__ CUtensorMap dv_map,
                            const float* __restrict__ lse, const float* __restrict__ di, int L,
                            int num_heads, float scale) {
  using S = Smem<true>;
  constexpr int KSTEPS = (HD + 15) / 16;
  unsigned char* smem;
  const uint32_t base = aligned_smem(smem);
  const uint32_t bar_own = base + S::BAR, bar_full = bar_own + 8;
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * NWG * TILE;
  const int bh = blockIdx.y, b = bh / num_heads, h = bh % num_heads;
  const long stat = static_cast<long>(bh) * L;
  init_barriers<true>(base);
  if (tid >= NWG * 128) {
    produce<true>(base, smem, &k_map, &v_map, &q_map, &do_map, lse + stat, di + stat, h, b,
                  row0, L);
    return;
  }

  // this thread holds keys r and r + 8 of its warpgroup's 64, queries
  // 8j + c2, 8j + c2 + 1 of each 8-query chunk j of a streamed tile
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r = warp * 16 + lane / 4, c2 = 2 * (lane % 4);
  const float scale_log2 = scale * LOG2E;
  const uint32_t k_tile = base + S::OWN_A + wg * TILE_BYTES;
  const uint32_t v_tile = base + S::OWN_B + wg * TILE_BYTES;
  const uint64_t dk_ = sw128_desc(k_tile, 16), dv_ = sw128_desc(v_tile, 16);

  float dk[HD / 2], dv[HD / 2], sacc[32], pacc[32];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = 0.f;

  mbar_wait(bar_own, 0);
  const int ntiles = (L + TILE - 1) / TILE;
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(bar_full + 8 * s, (t / STAGES) & 1);
    const uint32_t q_tile = base + S::RING_A + s * TILE_BYTES;
    const uint32_t do_tile = base + S::RING_B + s * TILE_BYTES;
    const float* st = reinterpret_cast<const float*>(smem + S::STAT) + s * 2 * TILE;

    // S^T = K Q^T, dP^T = V dO^T
    two_logit_products<KSTEPS>(sacc, dk_, sw128_desc(q_tile, 16), pacc, dv_,
                               sw128_desc(do_tile, 16));

    // P^T = exp2(S^T * scale_log2 - lse2[query]), queries >= L to 0;
    // dS^T = P^T * (dP^T - di[query])
    const bool ragged = (t + 1) * TILE > L;
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * j + c2);
      const float2 d2 = *reinterpret_cast<const float2*>(st + TILE + 8 * j + c2);
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ex2(fmaf(sacc[4 * j + e], scale_log2, (e & 1) ? -l2.y : -l2.x));
        if (ragged && t * TILE + 8 * j + c2 + (e & 1) >= L) p[e] = 0.f;
      }
      pa[j / 2][2 * (j % 2)] = pack_bf16(p[0], p[1]);
      pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);
      da[j / 2][2 * (j % 2)] =
          pack_bf16(p[0] * (pacc[4 * j] - d2.x), p[1] * (pacc[4 * j + 1] - d2.y));
      da[j / 2][2 * (j % 2) + 1] =
          pack_bf16(p[2] * (pacc[4 * j + 2] - d2.x), p[3] * (pacc[4 * j + 3] - d2.y));
    }

    // dV += P^T dO, dK += dS^T Q: dO and Q as MN-major B operands
    const uint64_t do_mn = sw128_desc(do_tile, 1024), q_mn = sw128_desc(q_tile, 1024);
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) WgmmaRS<HD>::mma(dv, pa[kk], do_mn + kk * 128);
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) WgmmaRS<HD>::mma(dk, da[kk], q_mn + kk * 128);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // this warp is done with the stage
  }

  // epilogue: dK * scale and dV in bf16 into the warpgroup's own K and V
  // rows, two TMA stores per warpgroup
  stage_rows<HD>(smem + S::OWN_A + wg * TILE_BYTES, dk, r, c2, scale, scale);
  stage_rows<HD>(smem + S::OWN_B + wg * TILE_BYTES, dv, r, c2, 1.f, 1.f);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  warpgroup_sync(wg);
  if (tid % 128 == 0) {
    tma_store(&dk_map, k_tile, h, row0 + wg * TILE, b);
    tma_store(&dv_map, v_tile, h, row0 + wg * TILE, b);
  }
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* di, void* dq, int batch, int L, int num_heads, float scale,
              cudaStream_t stream) {
  using S = Smem<false>;
  static bool smem_set[MAX_DEVICES] = {};
  EncodeTiled fn;
  CUtensorMap qm, km, vm, dom, dqm;
  int err = encoder(&fn);
  if (err == 0) err = encode(fn, &qm, q, batch, L, num_heads, HD, NWG * TILE);
  if (err == 0) err = encode(fn, &dom, dout, batch, L, num_heads, HD, NWG * TILE);
  if (err == 0) err = encode(fn, &km, k, batch, L, num_heads, HD, TILE);
  if (err == 0) err = encode(fn, &vm, v, batch, L, num_heads, HD, TILE);
  if (err == 0) err = encode(fn, &dqm, dq, batch, L, num_heads, HD, TILE);
  if (err == 0)
    err = allow_smem(reinterpret_cast<const void*>(md_flash_bwd_dq_kernel<HD>), S::BYTES,
                     smem_set);
  if (err != 0) return err;
  const dim3 grid((L + NWG * TILE - 1) / (NWG * TILE), batch * num_heads);
  md_flash_bwd_dq_kernel<HD><<<grid, S::THREADS, S::BYTES, stream>>>(qm, km, vm, dom, dqm, lse, di,
                                                                    L, num_heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* di, void* dk, void* dv, int batch, int L, int num_heads, float scale,
               cudaStream_t stream) {
  using S = Smem<true>;
  static bool smem_set[MAX_DEVICES] = {};
  EncodeTiled fn;
  CUtensorMap qm, km, vm, dom, dkm, dvm;
  int err = encoder(&fn);
  if (err == 0) err = encode(fn, &km, k, batch, L, num_heads, HD, NWG * TILE);
  if (err == 0) err = encode(fn, &vm, v, batch, L, num_heads, HD, NWG * TILE);
  if (err == 0) err = encode(fn, &qm, q, batch, L, num_heads, HD, TILE);
  if (err == 0) err = encode(fn, &dom, dout, batch, L, num_heads, HD, TILE);
  if (err == 0) err = encode(fn, &dkm, dk, batch, L, num_heads, HD, TILE);
  if (err == 0) err = encode(fn, &dvm, dv, batch, L, num_heads, HD, TILE);
  if (err == 0)
    err = allow_smem(reinterpret_cast<const void*>(md_flash_bwd_dkv_kernel<HD>), S::BYTES,
                     smem_set);
  if (err != 0) return err;
  const dim3 grid((L + NWG * TILE - 1) / (NWG * TILE), batch * num_heads);
  md_flash_bwd_dkv_kernel<HD><<<grid, S::THREADS, S::BYTES, stream>>>(
      qm, km, vm, dom, dkm, dvm, lse, di, L, num_heads, scale);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int batch, int L, int num_heads, int head_dim, const void* lse, const void* di) {
  return head_dim % 8 != 0 || head_dim > 64 || head_dim <= 0 || L < 1 || batch < 1 ||
         num_heads < 1 || lse == nullptr || di == nullptr;
}

}  // namespace

extern "C" {

// q, k, v, dout, dk, dv: (batch, L, num_heads * head_dim) bf16, contiguous,
// 16-byte aligned; lse, di: (batch, num_heads, L) fp32. head_dim must be a
// multiple of 8 and at most 64; L >= 1. Returns cudaGetLastError(), or
// TENSOR_MAP_ERROR + the CUresult if a tensor map is refused.
int md_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* di, void* dk, void* dv, int batch,
                               int L, int num_heads, int head_dim, float scale, void* stream) {
  if (bad_shape(batch, L, num_heads, head_dim, lse, di))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  switch (head_dim) {
    case 8: return launch_dkv<8>(q, k, v, dout, l, d, dk, dv, batch, L, num_heads, scale, s);
    case 16: return launch_dkv<16>(q, k, v, dout, l, d, dk, dv, batch, L, num_heads, scale, s);
    case 24: return launch_dkv<24>(q, k, v, dout, l, d, dk, dv, batch, L, num_heads, scale, s);
    case 32: return launch_dkv<32>(q, k, v, dout, l, d, dk, dv, batch, L, num_heads, scale, s);
    case 40: return launch_dkv<40>(q, k, v, dout, l, d, dk, dv, batch, L, num_heads, scale, s);
    case 48: return launch_dkv<48>(q, k, v, dout, l, d, dk, dv, batch, L, num_heads, scale, s);
    case 56: return launch_dkv<56>(q, k, v, dout, l, d, dk, dv, batch, L, num_heads, scale, s);
    default: return launch_dkv<64>(q, k, v, dout, l, d, dk, dv, batch, L, num_heads, scale, s);
  }
}

// Same layouts; writes dq only.
int md_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* di, void* dq, int batch, int L,
                              int num_heads, int head_dim, float scale, void* stream) {
  if (bad_shape(batch, L, num_heads, head_dim, lse, di))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  switch (head_dim) {
    case 8: return launch_dq<8>(q, k, v, dout, l, d, dq, batch, L, num_heads, scale, s);
    case 16: return launch_dq<16>(q, k, v, dout, l, d, dq, batch, L, num_heads, scale, s);
    case 24: return launch_dq<24>(q, k, v, dout, l, d, dq, batch, L, num_heads, scale, s);
    case 32: return launch_dq<32>(q, k, v, dout, l, d, dq, batch, L, num_heads, scale, s);
    case 40: return launch_dq<40>(q, k, v, dout, l, d, dq, batch, L, num_heads, scale, s);
    case 48: return launch_dq<48>(q, k, v, dout, l, d, dq, batch, L, num_heads, scale, s);
    case 56: return launch_dq<56>(q, k, v, dout, l, d, dq, batch, L, num_heads, scale, s);
    default: return launch_dq<64>(q, k, v, dout, l, d, dq, batch, L, num_heads, scale, s);
  }
}

// Dynamic shared memory of a block of K2-dkv (dkv != 0) or K2-dq, in bytes.
int md_flash_attention_bwd_smem_bytes(int dkv) {
  return dkv ? Smem<true>::BYTES : Smem<false>::BYTES;
}

// Blocks of K2-dkv (dkv != 0) or K2-dq at head_dim 40 that fit on one SM,
// once a head_dim 40 launch has raised its shared-memory limit.
int md_flash_attention_bwd_blocks_per_sm(int dkv) {
  int n = 0;
  if (dkv)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, md_flash_bwd_dkv_kernel<40>,
                                                  Smem<true>::THREADS,
                                                  Smem<true>::BYTES);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, md_flash_bwd_dq_kernel<40>,
                                                  Smem<false>::THREADS,
                                                  Smem<false>::BYTES);
  return n;
}

const char* md_cuda_error_string(int code) {
  if (code >= TENSOR_MAP_ERROR) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
