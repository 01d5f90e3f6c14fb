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
//    and, with a shift, t_c * x over them; warp shuffles, then the team's
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
// The plan (cluster, pack, chunk, held, vector width) is chosen by shape and
// dtype in ops/group_norm.py::gn_plan; this file checks it.
// Layout: x, y (B, C, S) contiguous, bf16 or fp32; gamma, beta (C,) fp32;
// shift (B, C) bf16 or fp32, or null. Offsets into x are 64-bit (the VAE
// decode has 16 * 128 * 256^2 elements).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NTHREADS = 256, NWARPS = NTHREADS / 32;
constexpr int ACT_SILU = 1, ACT_RELU = 2;     // 0: no activation
constexpr int SHIFT_BF16 = 2;  // 1: fp32 shift, 0: none
constexpr int RED_BYTES = 256;                // warp sums, cluster partials, statistics

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
  extern __shared__ __align__(16) unsigned char md_k4_smem[];
  T* xs = reinterpret_cast<T*>(md_k4_smem);
  float* ts = reinterpret_cast<float*>(md_k4_smem + pl.x_bytes);
  float* A = ts + pl.table / 4;
  float* B2 = A + pl.table / 4;
  float* wsum = B2 + pl.table / 4;  // [NWARPS][3]
  float* part = wsum + 3 * NWARPS;  // [3]: this block's sums, read by its peers
  float* stat = part + 4;           // [pack][2]: mean, inv

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
  float s = 0.f, q = 0.f, u = 0.f;
  auto sums = [&](const T* src, int from, int to) {
    for (int i = from + tt * VEC; i < to; i += nt * VEC) {
      float v[VEC];
      load_vec<VEC>(src + i, v);
      float vs = 0.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        vs += v[j];
        q = fmaf(v[j], v[j], q);
      }
      s += vs;
      if (shift_code != 0) u = fmaf(tt_row[i / S], vs, u);  // S % VEC == 0: one channel
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
    float sx = 0.f, sq = 0.f, su = 0.f;
    for (int w = threadIdx.x * team_warps; w < (threadIdx.x + 1) * team_warps; ++w) {
      sx += wsum[3 * w];
      sq += wsum[3 * w + 1];
      su += wsum[3 * w + 2];
    }
    float* dst = pl.cluster > 1 ? part : stat + 2 * threadIdx.x;
    dst[0] = sx;
    dst[1] = fmaf(2.f, su, sq);
  }
  if (pl.cluster > 1) {
    cluster_arrive();
    cluster_wait();  // every block's part is written
    if (threadIdx.x == 0) {
      float sx = 0.f, sq = 0.f;
      for (int r = 0; r < pl.cluster; ++r) {
        const float* pr = peer(part, r);
        sx += pr[0];
        sq += pr[1];
      }
      stat[0] = sx;
      stat[1] = sq;
    }
    cluster_arrive();  // this block has read its peers
  }
  __syncthreads();

  // 4. mean and inverse std of each pair, then A and B2 per channel
  if (threadIdx.x < pl.pack) {
    const float* t = ts + threadIdx.x * cg;
    float tsum = 0.f, tsq = 0.f;
    if (shift_code != 0)
      for (int c = 0; c < cg; ++c) {
        tsum += t[c];
        tsq = fmaf(t[c], t[c], tsq);
      }
    const float n = (float)span;
    const float mean = (stat[2 * threadIdx.x] + (float)S * tsum) / n;
    const float ex2 = (stat[2 * threadIdx.x + 1] + (float)S * tsq) / n;
    const float var = fmaxf(ex2 - mean * mean, 0.f);
    stat[2 * threadIdx.x] = mean;
    stat[2 * threadIdx.x + 1] = rsqrtf(var + eps);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < pl.pack * cg; i += NTHREADS) {
    const int p = i / cg, c = i - p * cg;
    const int g = (int)((pair0 + p) % G);
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

template <typename T, int VEC>
bool (&smem_flags())[MAX_DEVICES] {
  static bool done[MAX_DEVICES] = {};
  return done;
}

template <typename T, int VEC>
int launch(const void* x, const float* gamma, const float* beta, const void* shift,
           int shift_code, void* y, int G, long pairs, const Plan& pl, float eps, int act,
           cudaStream_t st) {
  auto kernel = md_group_norm_kernel<T, VEC>;
  const int err = allow_smem(reinterpret_cast<const void*>(kernel), MAX_BLOCK_SMEM,
                             smem_flags<T, VEC>());
  if (err != 0) return err;
  const long blocks = (pairs + pl.pack - 1) / pl.pack * pl.cluster;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  return launch_cluster(kernel, (unsigned)blocks, NTHREADS, pl.bytes, pl.cluster, st,
                        static_cast<const T*>(x), gamma, beta, shift, shift_code,
                        static_cast<T*>(y), G, pairs, pl, eps, act);
}

template <typename T, int VEC>
int max_clusters(const Plan& pl) {
  auto kernel = md_group_norm_kernel<T, VEC>;
  const int err = allow_smem(reinterpret_cast<const void*>(kernel), MAX_BLOCK_SMEM,
                             smem_flags<T, VEC>());
  if (err != 0) return -err;
  return max_active_clusters(kernel, NTHREADS, pl.bytes, pl.cluster);
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

}  // namespace

extern "C" {

// One launch: y = act((x + t - mean) * inv * gamma + beta) per group of C / G
// channels of each sample. x, y (B, C, S) contiguous, dtype 0 = fp32, 1 =
// bf16 (16-byte aligned where vec is 16 bytes of it: 4 fp32 or 8 bf16, S a
// multiple of vec; else vec 1); gamma, beta (C,) fp32; shift (B, C),
// shift_dtype 0 = none (null), 1 = fp32, 2 = bf16; act 0 none, 1 silu, 2
// relu. The plan: pack pairs (sample, group) per block (1, 2, 4, 8) or a
// cluster of `cluster` blocks per pair (1, 2, 4, 8), each taking `chunk`
// elements of the pair's C / G * S (a multiple of vec; chunk = span for a
// cluster of 1), the first `held` of them (a multiple of vec; all of a
// packed span) held in shared memory and the rest read twice. Returns the
// first CUDA error of the shared-memory raise or the launch.
int md_group_norm(const void* x, const void* gamma, const void* beta, const void* shift,
                  void* y, int batch, int C, int G, int S, int pack, int cluster, int chunk,
                  int held, int vec, float eps, int act, int dtype, int shift_dtype,
                  void* stream) {
  int err = check_plan(C, G, S, pack, cluster, chunk, held, vec, dtype);
  if (err == 0 && (batch <= 0 || act < 0 || act > ACT_RELU || shift_dtype < 0 ||
                   shift_dtype > SHIFT_BF16 ||
                   (shift_dtype != 0) != (shift != nullptr)))
    err = (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  const Plan pl(C / G, S, pack, cluster, chunk, held, dtype == 0 ? 4 : 2);
  const long pairs = (long)batch * G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  if (dtype == 0)
    return vec == 1 ? launch<float, 1>(x, g, b, shift, shift_dtype, y, G, pairs, pl, eps, act, st)
                    : launch<float, 4>(x, g, b, shift, shift_dtype, y, G, pairs, pl, eps, act, st);
  return vec == 1 ? launch<bf16, 1>(x, g, b, shift, shift_dtype, y, G, pairs, pl, eps, act, st)
                  : launch<bf16, 8>(x, g, b, shift, shift_dtype, y, G, pairs, pl, eps, act, st);
}

// Shared memory of one block of a plan (as gn_plan computes it); -1 if the
// kernel does not take the plan.
int md_group_norm_smem_bytes(int C, int G, int S, int pack, int cluster, int chunk,
                             int held, int vec, int dtype) {
  if (check_plan(C, G, S, pack, cluster, chunk, held, vec, dtype) != 0) return -1;
  return Plan(C / G, S, pack, cluster, chunk, held, dtype == 0 ? 4 : 2).bytes;
}

// cudaOccupancyMaxActiveClusters for a plan: the clusters the card holds at
// once; minus the CUDA error if the plan or the query is refused.
int md_group_norm_max_clusters(int C, int G, int S, int pack, int cluster, int chunk,
                               int held, int vec, int dtype) {
  const int err = check_plan(C, G, S, pack, cluster, chunk, held, vec, dtype);
  if (err != 0) return -err;
  const Plan pl(C / G, S, pack, cluster, chunk, held, dtype == 0 ? 4 : 2);
  if (dtype == 0) return vec == 1 ? max_clusters<float, 1>(pl) : max_clusters<float, 4>(pl);
  return vec == 1 ? max_clusters<bf16, 1>(pl) : max_clusters<bf16, 8>(pl);
}

const char* md_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
