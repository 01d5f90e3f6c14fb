// GroupNorm with fp32 statistics, an optional per-(sample, channel) shift and
// an optional fused activation (kernel K4).
//
// Replaces: the JAX package's ops/group_norm.py::_kernel (:79-110, launched
// by _pallas_forward :113-136): per sample, fp32 sums of x and x^2, then per
// group; var = max(E[x^2] - E[x]^2, 0); rsqrt(var + eps); the affine; silu /
// relu; the output in x's dtype. It also covers group_norm_shifted
// (:159-199): a (B, C) shift t moves the statistics to those of x + t
// without writing x + t: the sums become sum x + S*sum_c t_c and
// sum x^2 + 2*sum t_c*x + S*sum_c t_c^2 (the per-channel colsum + S*t,
// colsq + 2*t*colsum + S*t^2, added up over the group).
//
// What bounds it on the H100: memory. About 6-9 fp32 operations per element
// against 2 bytes read and 2 written (bf16), far below the card's ratio of
// operations to bytes; the least traffic is one read of x and one write of
// y. The maps reach 268 MB (the VAE decode), far beyond the 50 MB L2, so a
// design that reads x once for the statistics and again for the apply moves
// ~1.5x the bound's bytes; this one reads it once wherever a group's span
// fits its cluster's shared memory.
//
// Design (one launch per call, a cluster reduction over DSMEM, no atomics,
// deterministic):
//  * a (sample, group) pair owns a contiguous span of cg*S elements. A
//    cluster of `cluster` blocks (1 to 8, 256 threads each) takes one pair,
//    block r the elements [r*chunk, (r+1)*chunk) of its span; where spans
//    are small (the UNet's bottom, S = 16) one block takes `pack` pairs
//    instead, each to a team of 8 / pack warps;
//  * the block copies its elements into shared memory once (16-byte
//    cp.async copies, all in flight together) and forms fp32 sums of x, x^2
//    and, with a shift, t_c * x over them (fp64 sums for an fp32 map: with
//    few groups, as at B=1, fp32 sums left K4 further from an fp64
//    GroupNorm than the plain version); warp shuffles, then the team's
//    warps in order, then the cluster's blocks rank by rank through DSMEM
//    give every block of the cluster the same totals;
//  * from them the group's mean and inverse std, then per channel
//    A = inv * gamma and B2 = beta - mean * A + t * A (the shift read as
//    given, bf16 or fp32), and the block writes act(x * A + B2) from its
//    shared copy in x's dtype;
//  * a block holds at most `held` elements (the plan keeps a block's
//    shared memory small enough for several blocks an SM; on the H100 one
//    block of 128 KB an SM ran slower than reading x twice): where its
//    share of a span is larger (the widest maps of the VAE decode), it
//    reads the rest twice in the same launch, once for the sums and once
//    for the apply.
//
// A channels-last map (NHWC: C innermost) takes a second design,
// md_group_norm_kernel_nhwc, in the same launch path:
//  * a sample's H*W pixel rows of C channels go to a cluster of `cluster`
//    blocks (1 to 8), block r the rows [r*chunk, (r+1)*chunk); a thread
//    owns one fixed 16-byte slice of channels (8 bf16 or 4 fp32, `vec`),
//    neighbouring threads neighbouring slices of a row, so every load and
//    store is coalesced along C; a block is `pack` rows of C / vec threads;
//  * each thread forms fp32 per-channel sums of x and x^2 over its rows;
//    the block adds its rows' sums in row order, and the cluster its
//    blocks' in rank order through DSMEM (no atomics: deterministic);
//  * per-channel sums make the shift exact with the plain version's
//    algebra (colsum + S*t, colsq + 2*t*colsum + S*t^2) before channels
//    are folded into groups, so a group may be any number of channels
//    (the UNet's 10 and 40), not only whole slices;
//  * the block holds its first `held` rows in shared memory (cp.async)
//    and reads the rest again for the apply, last rows first (those read
//    last may still be in L2). A sample of the VAE's widest map (16.8 MB)
//    is far beyond a cluster's shared memory, so there it moves about two
//    reads and one write.
// The plan (cluster, pack, chunk, held, vector width) is chosen by shape,
// dtype and layout in ops/group_norm.py::gn_plan; this file checks it.
// Layout: x, y (B, C, S) contiguous (NCHW, NCDHW, ...) or, for a 4-D map,
// (B, S, C) contiguous (channels-last), y in x's layout; bf16 or fp32;
// gamma, beta (C,) fp32; shift (B, C) bf16 or fp32, or null. Offsets into x
// are 64-bit (the VAE decode has 16 * 128 * 256^2 elements).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NTHREADS = 256, NWARPS = NTHREADS / 32;
constexpr int GN_PACK_MAX = 8;                // pairs a block at most (one warp each)
constexpr int ACT_SILU = 1, ACT_RELU = 2;     // 0: no activation
constexpr int SHIFT_BF16 = 2;  // 1: fp32 shift, 0: none
// warp sums, this block's partials, the totals (in Acc: 8 bytes for fp32
// maps), the statistics (fp32)
constexpr int RED_BYTES = 3 * NWARPS * 8 + 2 * 8 + GN_PACK_MAX * 2 * (8 + 4);
constexpr int LAYOUT_NCHW = 0, LAYOUT_NHWC = 1;
constexpr int NHWC_MAX_THREADS = 1024;        // a channels-last block: rows of C / vec threads
// channels-last loads in flight a thread: 4, but 3 for 16-byte slices of
// bf16, whose eight channels' sums stay in registers (four in flight
// spilled under the 64 registers a thread of a 1 024-thread block has;
// three ran as fast on the H100, two 3% slower)
template <typename T, int VEC>
__host__ __device__ constexpr int unroll_of() { return sizeof(T) == 2 && VEC > 1 ? 3 : 4; }

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

// What one thread loads for its VEC elements: one 16-byte vector, or one
// element; `unpack` turns it into fp32 (loads first, conversions after, so
// several are in flight without a register for every element).
template <typename T, int VEC>
struct RawOf {
  using type = T;
};
template <>
struct RawOf<bf16, 8> {
  using type = uint4;
};
template <>
struct RawOf<float, 4> {
  using type = float4;
};

template <typename T, int VEC>
__device__ __forceinline__ typename RawOf<T, VEC>::type load_raw(const T* p) {
  return *reinterpret_cast<const typename RawOf<T, VEC>::type*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const typename RawOf<T, VEC>::type& r, float (&v)[VEC]) {
  load_vec<VEC>(reinterpret_cast<const T*>(&r), v);
}

// Copy VEC elements from device to shared memory: one 16-byte cp.async for
// a full vector, else through registers.
template <typename T, int VEC>
__device__ __forceinline__ void copy_in(T* s, const T* g) {
  if constexpr (VEC * sizeof(T) == 16) {
    cp_async16(s, g);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) s[j] = g[j];
  }
}

// The NCHW design's accumulator: fp32 for bf16 maps, fp64 for fp32 maps (a
// group of few samples at fp32 otherwise reads its statistics' rounding).
template <typename T>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<float> {
  using type = double;
};

__device__ __forceinline__ float inv_std(float var, float eps) { return rsqrtf(var + eps); }
__device__ __forceinline__ float inv_std(double var, float eps) {
  return (float)rsqrt(var + (double)eps);
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_SILU) return v / (1.f + __expf(-v));
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  return v;
}

__device__ __forceinline__ float shift_at(const void* shift, int code, long i) {
  return code == SHIFT_BF16 ? __bfloat162float(static_cast<const bf16*>(shift)[i])
                            : static_cast<const float*>(shift)[i];
}

// A block's plan, and its shared-memory layout: the x elements it holds
// (held for each of its pack pairs), the shift t, A and B2 per channel of
// its pairs (pack * cg fp32 each), and the reduction scratch. The same
// arithmetic is ops/group_norm.py::_gn_smem.
struct Plan {
  int cg, S, span;       // channels per group, elements per channel, cg * S
  int pack, cluster;     // pairs per block (cluster 1), blocks per pair (pack 1)
  int chunk;             // elements of a span a block takes (pack 1), else span
  int held;              // of them, those it holds in shared memory
  int x_bytes, table, bytes;
  __host__ __device__ Plan(int cg_, int S_, int pack_, int cluster_, int chunk_, int held_,
                           int esize)
      : cg(cg_), S(S_), span(cg_ * S_), pack(pack_), cluster(cluster_), chunk(chunk_),
        held(held_),
        x_bytes(up16(pack_ * held_ * esize)),
        table(up16(pack_ * cg_ * 4)),
        bytes(x_bytes + 3 * table + RED_BYTES) {}
};

// y = act((x + t - mean) * inv * gamma + beta) per (sample, group).
template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
    md_group_norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                         const float* __restrict__ beta, const void* __restrict__ shift,
                         int shift_code, T* __restrict__ y, int G, long pairs, Plan pl,
                         float eps, int act) {
  using Acc = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char md_k4_smem[];
  T* xs = reinterpret_cast<T*>(md_k4_smem);
  float* ts = reinterpret_cast<float*>(md_k4_smem + pl.x_bytes);
  float* A = ts + pl.table / 4;
  float* B2 = A + pl.table / 4;
  Acc* wsum = reinterpret_cast<Acc*>(B2 + pl.table / 4);  // [NWARPS][3]
  Acc* part = wsum + 3 * NWARPS;    // [2]: this block's sums, read by its peers
  Acc* tot = part + 2;              // [pack][2]: the pairs' sums
  float* stat = reinterpret_cast<float*>(tot + 2 * GN_PACK_MAX);  // [pack][2]: mean, inv

  const int cg = pl.cg, S = pl.S, span = pl.span;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int team_warps = NWARPS / pl.pack;
  const int team = warp / team_warps;                   // the team's pair in the block
  const int nt = team_warps * 32;                       // threads of a team
  const int tt = threadIdx.x - team * nt;               // thread in its team
  const int rank = pl.cluster > 1 ? (int)(blockIdx.x % pl.cluster) : 0;
  const long pair0 = pl.cluster > 1 ? (long)(blockIdx.x / pl.cluster)
                                    : (long)blockIdx.x * pl.pack;
  const long pair = pair0 + team;
  const bool live = pair < pairs;
  const int lo = rank * pl.chunk;                       // the block's elements of the span
  const int hi = live ? min(span, lo + pl.chunk) : lo;
  const int mid = min(hi, lo + pl.held);                // [lo, mid) held, [mid, hi) read twice
  const long base = pair * (long)span;                  // the pair's first element
  T* xt = xs + team * pl.held - lo;                     // shared copy, by span index
  const T* xg = x + base;

  // 1. the shift of the block's channels, and the block's x into shared memory
  for (int i = threadIdx.x; i < pl.pack * cg; i += NTHREADS) {
    const long row = pair0 * cg + i;
    ts[i] = (shift_code != 0 && row < pairs * cg) ? shift_at(shift, shift_code, row) : 0.f;
  }
  for (int i = lo + tt * VEC; i < mid; i += nt * VEC) copy_in<T, VEC>(xt + i, xg + i);
  __syncthreads();
  cp_async_wait_all();  // each thread reads back only its own copies

  // 2. the thread's sums of x, x^2 and t * x
  const float* tt_row = ts + team * cg;
  Acc s = 0, q = 0, u = 0;
  auto sums = [&](const T* src, int from, int to) {
    for (int i = from + tt * VEC; i < to; i += nt * VEC) {
      float v[VEC];
      load_vec<VEC>(src + i, v);
      Acc vs = 0;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        vs += v[j];
        q = fma((Acc)v[j], (Acc)v[j], q);
      }
      s += vs;
      if (shift_code != 0) u = fma((Acc)tt_row[i / S], vs, u);  // S % VEC == 0: one channel
    }
  };
  sums(xt, lo, mid);
  sums(xg, mid, hi);
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    q += __shfl_xor_sync(0xffffffffu, q, o);
    u += __shfl_xor_sync(0xffffffffu, u, o);
  }
  if (lane == 0) {
    wsum[3 * warp] = s;
    wsum[3 * warp + 1] = q;
    wsum[3 * warp + 2] = u;
  }
  __syncthreads();

  // 3. the team's sums (its warps in order): sum x and sum x^2 + 2 sum t*x;
  // in a cluster, then the cluster's (its blocks in rank order), so every
  // block of a cluster gets the same totals
  if (threadIdx.x < pl.pack) {
    Acc sx = 0, sq = 0, su = 0;
    for (int w = threadIdx.x * team_warps; w < (threadIdx.x + 1) * team_warps; ++w) {
      sx += wsum[3 * w];
      sq += wsum[3 * w + 1];
      su += wsum[3 * w + 2];
    }
    Acc* dst = pl.cluster > 1 ? part : tot + 2 * threadIdx.x;
    dst[0] = sx;
    dst[1] = fma((Acc)2, su, sq);
  }
  if (pl.cluster > 1) {
    cluster_arrive();
    cluster_wait();  // every block's part is written
    if (threadIdx.x == 0) {
      Acc sx = 0, sq = 0;
      for (int r = 0; r < pl.cluster; ++r) {
        const Acc* pr = peer(part, r);
        sx += pr[0];
        sq += pr[1];
      }
      tot[0] = sx;
      tot[1] = sq;
    }
    cluster_arrive();  // this block has read its peers
  }
  __syncthreads();

  // 4. mean and inverse std of each pair, then A and B2 per channel
  if (threadIdx.x < pl.pack) {
    const float* t = ts + threadIdx.x * cg;
    Acc tsum = 0, tsq = 0;
    if (shift_code != 0)
      for (int c = 0; c < cg; ++c) {
        tsum += t[c];
        tsq = fma((Acc)t[c], (Acc)t[c], tsq);
      }
    const Acc n = (Acc)span;
    const Acc mean = (tot[2 * threadIdx.x] + (Acc)S * tsum) / n;
    const Acc ex2 = (tot[2 * threadIdx.x + 1] + (Acc)S * tsq) / n;
    const Acc var = fmax(ex2 - mean * mean, (Acc)0);
    stat[2 * threadIdx.x] = (float)mean;
    stat[2 * threadIdx.x + 1] = inv_std(var, eps);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < pl.pack * cg; i += NTHREADS) {
    const int p = i / cg, c = i - p * cg;
    // pairs < 2^31 (md_group_norm checks): a 32-bit remainder, inline (a
    // 64-bit one is a called subroutine, and its saved registers spilled)
    const int g = (int)(pair0 + p) % G;
    const float mean = stat[2 * p], inv = stat[2 * p + 1];
    const float a = inv * gamma[g * cg + c];
    A[i] = a;
    B2[i] = fmaf(ts[i] - mean, a, beta[g * cg + c]);
  }
  __syncthreads();

  // 5. y = act(x * A + B2) over the block's elements
  const float* At = A + team * cg;
  const float* Bt = B2 + team * cg;
  auto apply = [&](const T* src, int from, int to) {
    for (int i = from + tt * VEC; i < to; i += nt * VEC) {
      const int c = i / S;  // S % VEC == 0: a vector never straddles channels
      const float a = At[c], b2 = Bt[c];
      float v[VEC];
      load_vec<VEC>(src + i, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = activate(fmaf(v[j], a, b2), act);
      store_vec<VEC>(y + base + i, v);
    }
  };
  apply(xt, lo, mid);
  apply(xg, mid, hi);
  if (pl.cluster > 1) cluster_wait();  // no peer reads this block's part any more
}

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// A channels-last block's plan and its shared-memory layout: the rows it
// holds, the shift, A and B2 per channel, its per-channel sums (read by its
// peers), the rows' sums (then the cluster's), the groups' statistics. The
// same arithmetic is ops/group_norm.py::_gn_smem_nhwc.
struct PlanN {
  int C, G, S, cg;
  int cv, ry;            // threads across a row (C / vec), rows a pass
  int cluster, rows;     // blocks per sample, rows a block takes
  int held;              // of them, those it holds in shared memory
  int x_bytes, table, part, red, bytes;
  __host__ __device__ PlanN(int C_, int G_, int S_, int vec, int ry_, int cluster_, int rows_,
                            int held_, int esize)
      : C(C_), G(G_), S(S_), cg(C_ / G_), cv(C_ / vec), ry(ry_), cluster(cluster_), rows(rows_),
        held(held_),
        x_bytes(up16(held_ * C_ * esize)),
        table(up16(C_ * 4)),
        part(up16(2 * C_ * 4)),
        red(up16(imax(ry, 2) * C_ * 4)),
        bytes(x_bytes + 3 * table + part + red + up16(2 * G_ * 4)) {}
};

// y = act((x + t - mean) * inv * gamma + beta) per (sample, group) of a
// channels-last map: a cluster per sample, a thread per 16-byte slice of a
// row's channels.
template <typename T, int VEC>
__global__ void __launch_bounds__(NHWC_MAX_THREADS)
    md_group_norm_kernel_nhwc(const T* __restrict__ x, const float* __restrict__ gamma,
                              const float* __restrict__ beta, const void* __restrict__ shift,
                              int shift_code, T* __restrict__ y, PlanN pl, float eps, int act) {
  using Raw = typename RawOf<T, VEC>::type;
  constexpr int UNROLL = unroll_of<T, VEC>();
  extern __shared__ __align__(16) unsigned char md_k4n_smem[];
  T* xs = reinterpret_cast<T*>(md_k4n_smem);
  float* ts = reinterpret_cast<float*>(md_k4n_smem + pl.x_bytes);
  float* A = ts + pl.table / 4;
  float* B2 = A + pl.table / 4;
  float* part = B2 + pl.table / 4;  // [2][C]: this block's sums, read by its peers
  float* red = part + pl.part / 4;  // [ry][C]: the rows' sums; then [2][C]: the cluster's
  float* stat = red + pl.red / 4;   // [G][2]: mean, inv

  const int C = pl.C, ry = pl.ry, nt = pl.cv * pl.ry;
  const int tx = threadIdx.x % pl.cv, ty = threadIdx.x / pl.cv;
  const int c0 = tx * VEC;                               // the thread's channels
  const int rank = pl.cluster > 1 ? (int)(blockIdx.x % pl.cluster) : 0;
  const long sample = blockIdx.x / pl.cluster;
  const int r0 = rank * pl.rows;                         // the block's rows [r0, r1)
  const int r1 = imin(pl.S, r0 + pl.rows);
  const int rm = imin(r1, r0 + pl.held);                 // [r0, rm) held, [rm, r1) read twice
  const T* xg = x + sample * (long)pl.S * C + c0;        // the thread's slice of row 0
  T* yg = y + sample * (long)pl.S * C + c0;
  T* xh = xs + c0;                                       // ... of held row 0

  // 1. the held rows into shared memory (each thread copies, and reads back,
  // its own slices), and the sample's shift
  for (int r = r0 + ty; r < rm; r += ry) copy_in<T, VEC>(xh + (long)(r - r0) * C, xg + (long)r * C);
  for (int c = threadIdx.x; c < C; c += nt)
    ts[c] = shift_code != 0 ? shift_at(shift, shift_code, sample * C + c) : 0.f;

  // 2. the thread's per-channel sums of x and x^2: the streamed rows while
  // the copies land, then the held rows
  float s[VEC], q[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
  auto add = [&](const float (&v)[VEC]) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      s[j] += v[j];
      q[j] = fmaf(v[j], v[j], q[j]);
    }
  };
  int r = rm + ty;
  for (; r + (UNROLL - 1) * ry < r1; r += UNROLL * ry) {
    Raw raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) raw[u] = load_raw<T, VEC>(xg + (long)(r + u * ry) * C);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float v[VEC];
      unpack<T, VEC>(raw[u], v);
      add(v);
    }
  }
  for (; r < r1; r += ry) {
    float v[VEC];
    load_vec<VEC>(xg + (long)r * C, v);
    add(v);
  }
  cp_async_wait_all();
  for (r = r0 + ty; r < rm; r += ry) {
    float v[VEC];
    load_vec<VEC>(xh + (long)(r - r0) * C, v);
    add(v);
  }

  // 3. the block's per-channel sums, its rows' added in row order
  auto block_sums = [&](const float (&v)[VEC], float* dst) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) red[ty * C + c0 + j] = v[j];
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += nt) {
      float a = 0.f;
      for (int t = 0; t < ry; ++t) a += red[t * C + c];
      dst[c] = a;
    }
    __syncthreads();
  };
  block_sums(s, part);
  block_sums(q, part + C);

  // 4. the sample's: the cluster's blocks in rank order, the same totals in
  // every block
  const float* tot = part;
  if (pl.cluster > 1) {
    cluster_arrive();
    cluster_wait();  // every block's part is written
    for (int c = threadIdx.x; c < 2 * C; c += nt) {
      float a = 0.f;
      for (int k = 0; k < pl.cluster; ++k) a += peer(part, k)[c];
      red[c] = a;
    }
    cluster_arrive();  // this block has read its peers
    __syncthreads();
    tot = red;
  }

  // 5. each group's mean and inverse std from its channels' sums, then A
  // and B2 per channel
  for (int g = threadIdx.x; g < pl.G; g += nt) {
    float sx = 0.f, sq = 0.f, tsum = 0.f, tsq = 0.f;
    for (int c = g * pl.cg; c < (g + 1) * pl.cg; ++c) {
      const float cs = tot[c];
      sx += cs;
      sq += tot[C + c];
      if (shift_code != 0) {
        const float t = ts[c];
        sq = fmaf(2.f * t, cs, sq);
        tsum += t;
        tsq = fmaf(t, t, tsq);
      }
    }
    const float n = (float)(pl.cg * pl.S);
    const float mean = (sx + (float)pl.S * tsum) / n;
    const float ex2 = (sq + (float)pl.S * tsq) / n;
    stat[2 * g] = mean;
    stat[2 * g + 1] = rsqrtf(fmaxf(ex2 - mean * mean, 0.f) + eps);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += nt) {
    const int g = c / pl.cg;
    const float a = stat[2 * g + 1] * gamma[c];
    A[c] = a;
    B2[c] = fmaf(ts[c] - stat[2 * g], a, beta[c]);
  }
  __syncthreads();

  // 6. y = act(x * A + B2): the streamed rows again, last first, then the
  // held rows from shared memory
  float a[VEC], b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    a[j] = A[c0 + j];
    b[j] = B2[c0 + j];
  }
  auto put = [&](float (&v)[VEC], T* dst) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = activate(fmaf(v[j], a[j], b[j]), act);
    store_vec<VEC>(dst, v);
  };
  const int first = rm + ty;
  if (first < r1) {
    r = first + (r1 - 1 - first) / ry * ry;  // the thread's last streamed row
    for (; r - (UNROLL - 1) * ry >= first; r -= UNROLL * ry) {
      Raw raw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) raw[u] = load_raw<T, VEC>(xg + (long)(r - u * ry) * C);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float v[VEC];
        unpack<T, VEC>(raw[u], v);
        put(v, yg + (long)(r - u * ry) * C);
      }
    }
    for (; r >= first; r -= ry) {
      float v[VEC];
      load_vec<VEC>(xg + (long)r * C, v);
      put(v, yg + (long)r * C);
    }
  }
  for (r = r0 + ty; r < rm; r += ry) {
    float v[VEC];
    load_vec<VEC>(xh + (long)(r - r0) * C, v);
    put(v, yg + (long)r * C);
  }
  if (pl.cluster > 1) cluster_wait();  // no peer reads this block's part any more
}

template <typename T, int VEC, int LAYOUT>
bool (&smem_flags())[MAX_DEVICES] {
  static bool done[MAX_DEVICES] = {};
  return done;
}

// f(Tag<T, VEC>{}) for the dtype (0 = fp32, 1 = bf16) and the vector width
// (1 or 16 bytes).
template <typename T, int V>
struct Tag {
  using type = T;
  static constexpr int vec = V;
};

template <typename F>
int by_type(int dtype, int vec, F f) {
  if (dtype == 0) return vec == 1 ? f(Tag<float, 1>{}) : f(Tag<float, 4>{});
  return vec == 1 ? f(Tag<bf16, 1>{}) : f(Tag<bf16, 8>{});
}

template <typename T, int VEC>
int launch(const void* x, const float* gamma, const float* beta, const void* shift,
           int shift_code, void* y, int G, long pairs, const Plan& pl, float eps, int act,
           cudaStream_t st) {
  auto kernel = md_group_norm_kernel<T, VEC>;
  const int err = allow_smem(reinterpret_cast<const void*>(kernel), MAX_BLOCK_SMEM,
                             smem_flags<T, VEC, LAYOUT_NCHW>());
  if (err != 0) return err;
  const long blocks = (pairs + pl.pack - 1) / pl.pack * pl.cluster;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  return launch_cluster(kernel, (unsigned)blocks, NTHREADS, pl.bytes, pl.cluster, st,
                        static_cast<const T*>(x), gamma, beta, shift, shift_code,
                        static_cast<T*>(y), G, pairs, pl, eps, act);
}

template <typename T, int VEC>
int launch_nhwc(const void* x, const float* gamma, const float* beta, const void* shift,
                int shift_code, void* y, long batch, const PlanN& pl, float eps, int act,
                cudaStream_t st) {
  auto kernel = md_group_norm_kernel_nhwc<T, VEC>;
  const int err = allow_smem(reinterpret_cast<const void*>(kernel), MAX_BLOCK_SMEM,
                             smem_flags<T, VEC, LAYOUT_NHWC>());
  if (err != 0) return err;
  const long blocks = batch * pl.cluster;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  return launch_cluster(kernel, (unsigned)blocks, pl.cv * pl.ry, pl.bytes, pl.cluster, st,
                        static_cast<const T*>(x), gamma, beta, shift, shift_code,
                        static_cast<T*>(y), pl, eps, act);
}

template <typename T, int VEC>
int max_clusters(const Plan& pl) {
  auto kernel = md_group_norm_kernel<T, VEC>;
  const int err = allow_smem(reinterpret_cast<const void*>(kernel), MAX_BLOCK_SMEM,
                             smem_flags<T, VEC, LAYOUT_NCHW>());
  if (err != 0) return -err;
  return max_active_clusters(kernel, NTHREADS, pl.bytes, pl.cluster);
}

template <typename T, int VEC>
int max_clusters_nhwc(const PlanN& pl) {
  auto kernel = md_group_norm_kernel_nhwc<T, VEC>;
  const int err = allow_smem(reinterpret_cast<const void*>(kernel), MAX_BLOCK_SMEM,
                             smem_flags<T, VEC, LAYOUT_NHWC>());
  if (err != 0) return -err;
  return max_active_clusters(kernel, pl.cv * pl.ry, pl.bytes, pl.cluster);
}

bool pow2_upto8(int n) { return n == 1 || n == 2 || n == 4 || n == 8; }

// The checks of a plan; 0 if the kernel takes it. dtype 0 = fp32, 1 = bf16.
int check_plan(int C, int G, int S, int pack, int cluster, int chunk, int held, int vec,
               int dtype) {
  if (C <= 0 || G <= 0 || S <= 0 || C % G != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int full = dtype == 0 ? 4 : 8;
  if (vec != 1 && !(vec == full && S % vec == 0)) return (int)cudaErrorInvalidValue;
  if ((long)(C / G) * S > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const int span = C / G * S;
  if (!pow2_upto8(pack) || !pow2_upto8(cluster) || (pack > 1 && cluster > 1))
    return (int)cudaErrorInvalidValue;
  if (chunk <= 0 || chunk % vec != 0 || (long)chunk * cluster < span ||
      (cluster == 1 && chunk != span))
    return (int)cudaErrorInvalidValue;
  if (held < 0 || held > chunk || held % vec != 0 || (pack > 1 && held != span))
    return (int)cudaErrorInvalidValue;
  if ((long)pack * held * (dtype == 0 ? 4 : 2) > MAX_BLOCK_SMEM ||
      (long)pack * (C / G) > MAX_BLOCK_SMEM / 12)
    return (int)cudaErrorInvalidValue;
  const Plan pl(C / G, S, pack, cluster, chunk, held, dtype == 0 ? 4 : 2);
  if (pl.bytes > MAX_BLOCK_SMEM) return (int)cudaErrorInvalidValue;
  return 0;
}

// The checks of a channels-last plan: chunk and held count pixel rows of C
// channels, vec the channels of a thread's slice (C a multiple of it), pack
// the rows a block takes at once (its threads pack * C / vec).
int check_plan_nhwc(int C, int G, int S, int pack, int cluster, int chunk, int held, int vec,
                    int dtype) {
  if (C <= 0 || G <= 0 || S <= 0 || C % G != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int full = dtype == 0 ? 4 : 8, esize = dtype == 0 ? 4 : 2;
  if (vec != 1 && !(vec == full && C % vec == 0)) return (int)cudaErrorInvalidValue;
  if (pack < 1 || (long)pack * (C / vec) > NHWC_MAX_THREADS || (long)C * S > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  if (!pow2_upto8(cluster)) return (int)cudaErrorInvalidValue;
  if (chunk <= 0 || (long)chunk * cluster < S || (cluster == 1 && chunk != S))
    return (int)cudaErrorInvalidValue;
  if (held < 0 || held > chunk || (long)held * C * esize > MAX_BLOCK_SMEM)
    return (int)cudaErrorInvalidValue;
  const PlanN pl(C, G, S, vec, pack, cluster, chunk, held, esize);
  if (pl.bytes > MAX_BLOCK_SMEM) return (int)cudaErrorInvalidValue;
  return 0;
}

int check_layout_plan(int layout, int C, int G, int S, int pack, int cluster, int chunk,
                      int held, int vec, int dtype) {
  if (layout == LAYOUT_NCHW) return check_plan(C, G, S, pack, cluster, chunk, held, vec, dtype);
  if (layout == LAYOUT_NHWC)
    return check_plan_nhwc(C, G, S, pack, cluster, chunk, held, vec, dtype);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One launch: y = act((x + t - mean) * inv * gamma + beta) per group of C / G
// channels of each sample, y in x's layout. layout 0: x, y (B, C, S)
// contiguous; 1: a channels-last map, (B, S, C) contiguous. dtype 0 = fp32,
// 1 = bf16 (16-byte aligned where vec is 16 bytes of it: 4 fp32 or 8 bf16,
// S a multiple of vec in layout 0, C in layout 1; else vec 1); gamma, beta
// (C,) fp32; shift (B, C), shift_dtype 0 = none (null), 1 = fp32, 2 = bf16;
// act 0 none, 1 silu, 2 relu. The plan, layout 0: pack pairs (sample,
// group) per block (1, 2, 4, 8) or a cluster of `cluster` blocks per pair
// (1, 2, 4, 8), each taking `chunk` elements of the pair's C / G * S (a
// multiple of vec; chunk = span for a cluster of 1), the first `held` of
// them (a multiple of vec; all of a packed span) held in shared memory and
// the rest read twice. Layout 1: a cluster of `cluster` blocks per sample,
// each taking `chunk` pixel rows of its S (chunk = S for a cluster of 1),
// `pack` rows at once, the first `held` of them held. Returns the first CUDA error of the
// shared-memory raise or the launch.
int md_group_norm(const void* x, const void* gamma, const void* beta, const void* shift,
                  void* y, int batch, int C, int G, int S, int pack, int cluster, int chunk,
                  int held, int vec, float eps, int act, int dtype, int shift_dtype,
                  int layout, void* stream) {
  int err = check_layout_plan(layout, C, G, S, pack, cluster, chunk, held, vec, dtype);
  if (err == 0 && (batch <= 0 || (long)batch * G > 0x7fffffffL || act < 0 || act > ACT_RELU ||
                   shift_dtype < 0 ||
                   shift_dtype > SHIFT_BF16 ||
                   (shift_dtype != 0) != (shift != nullptr)))
    err = (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  const int esize = dtype == 0 ? 4 : 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  if (layout == LAYOUT_NHWC) {
    const PlanN pl(C, G, S, vec, pack, cluster, chunk, held, esize);
    return by_type(dtype, vec, [&](auto tag) {
      using T = typename decltype(tag)::type;
      return launch_nhwc<T, decltype(tag)::vec>(x, g, b, shift, shift_dtype, y, batch, pl, eps,
                                                 act, st);
    });
  }
  const Plan pl(C / G, S, pack, cluster, chunk, held, esize);
  const long pairs = (long)batch * G;
  return by_type(dtype, vec, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return launch<T, decltype(tag)::vec>(x, g, b, shift, shift_dtype, y, G, pairs, pl, eps, act,
                                         st);
  });
}

// Shared memory of one block of a plan (as gn_plan computes it); -1 if the
// kernel does not take the plan.
int md_group_norm_smem_bytes(int C, int G, int S, int pack, int cluster, int chunk,
                             int held, int vec, int dtype, int layout) {
  if (check_layout_plan(layout, C, G, S, pack, cluster, chunk, held, vec, dtype) != 0) return -1;
  const int esize = dtype == 0 ? 4 : 2;
  if (layout == LAYOUT_NHWC) return PlanN(C, G, S, vec, pack, cluster, chunk, held, esize).bytes;
  return Plan(C / G, S, pack, cluster, chunk, held, esize).bytes;
}

// cudaOccupancyMaxActiveClusters for a plan: the clusters the card holds at
// once; minus the CUDA error if the plan or the query is refused.
int md_group_norm_max_clusters(int C, int G, int S, int pack, int cluster, int chunk,
                               int held, int vec, int dtype, int layout) {
  const int err = check_layout_plan(layout, C, G, S, pack, cluster, chunk, held, vec, dtype);
  if (err != 0) return -err;
  const int esize = dtype == 0 ? 4 : 2;
  if (layout == LAYOUT_NHWC) {
    const PlanN pl(C, G, S, vec, pack, cluster, chunk, held, esize);
    return by_type(dtype, vec, [&](auto tag) {
      return max_clusters_nhwc<typename decltype(tag)::type, decltype(tag)::vec>(pl);
    });
  }
  const Plan pl(C / G, S, pack, cluster, chunk, held, esize);
  return by_type(dtype, vec, [&](auto tag) {
    return max_clusters<typename decltype(tag)::type, decltype(tag)::vec>(pl);
  });
}

const char* md_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
