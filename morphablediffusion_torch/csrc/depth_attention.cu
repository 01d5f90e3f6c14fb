// Depth-wise attention on projected q, k, v (the DepthTransformers' plain
// path, which training takes at the W=4 middle block), kernel K3.
//
// Replaces: the JAX package's ops/depth_attention.py::_kernel (:56-78,
// launched by _pallas_forward :81-113, W < 8 folded to H*W rows :88-100).
// Per pixel s of sample b and head n:
//   out[:, s] = sum_d softmax_d(q[:, s] . k[:, d, s] * hd^-1/2) v[:, d, s]
// over the D frustum depths, with the logits and softmax in fp32.
//
// What bounds it on the H100: 4*B*C*D*S FLOPs against one read of q, k, v
// and one write of out (2*B*C*S*(2*D + 2) bytes in bf16): ~0.5 FLOP per
// byte, so bound by memory (training shape B=8, C=1024, D=6, S=16: 3.7 MB,
// ~1 us). Nothing of size (B, D, H, W) is written. At that shape the work
// of one (sample, head) is small (hd = 256 channels x 96 depth-pixels), so
// what the design must do is spread it over the card and keep every byte
// in flight at once.
//
// Design (one launch, a cluster reduction over DSMEM):
//  * a cluster of `cluster` blocks (1, 2, 4 or 8; 128 threads each) per
//    (sample, head, tile of P pixels); block r of the cluster owns channels
//    [r*cs, (r+1)*cs) of the head, cs = hd / cluster. At W=4, B=8 that is
//    8 x 4 x 8 = 256 blocks of 32 channels;
//  * the block copies its slice of q (cs x P) and of k and v (cs*D rows of
//    P pixels; at P = H*W one contiguous run per channel) into shared
//    memory with 16-byte cp.async copies, all issued before any is waited
//    for (scalar copies where H*W or P is not a multiple of 8);
//  * it forms the partial logits q.k_d over its channels for every depth
//    and pixel of the tile (D x P fp32), the cluster barrier makes them
//    visible, and every block adds the cluster's partials rank by rank
//    through DSMEM: the same sum, in the same order, in every block, so the
//    result is deterministic and needs no second pass;
//  * with all D logits of a pixel at hand it takes the softmax directly
//    (no online softmax, no barrier per depth) and writes
//    sum_d attn_d * v_d for its own channels.
// Each block arrives at the cluster barrier once it has read its peers and
// waits on it before it exits, so no block frees shared memory that a peer
// still reads. The plan (cluster, P, vector width) is chosen by shape in
// ops/depth_attention.py::depth_plan; this file checks it.
// Layout: q, out (B, C, S); k, v (B, C, D, S); C = heads * hd; S = H * W;
// bf16, contiguous (16-byte aligned for 16-byte copies).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "cluster_common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NTHREADS = 128;

// Shared-memory layout of a block: k and v slices (cs*D rows of P bf16),
// the q slice (cs rows of P), the partial logits and the probabilities
// (D*P fp32 each); each part starts 16-byte aligned. The same arithmetic
// is ops/depth_attention.py::_k3_smem.
struct Layout {
  int kv, q, part, bytes;
  __host__ __device__ Layout(int cs, int D, int P)
      : kv(up16(cs * D * P * 2)),
        q(up16(cs * P * 2)),
        part(up16(D * P * 4)),
        bytes(2 * kv + q + 2 * part) {}
};

template <int VEC>
__global__ void __launch_bounds__(NTHREADS)
    md_depth_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out, int C, int D,
                         int S, int heads, int P, int cluster, float scale_log2) {
  extern __shared__ __align__(16) unsigned char md_k3_smem[];
  const int hd = C / heads, cs = hd / cluster;
  const Layout L(cs, D, P);
  bf16* k_s = reinterpret_cast<bf16*>(md_k3_smem);
  bf16* v_s = reinterpret_cast<bf16*>(md_k3_smem + L.kv);
  bf16* q_s = reinterpret_cast<bf16*>(md_k3_smem + 2 * L.kv);
  float* part = reinterpret_cast<float*>(md_k3_smem + 2 * L.kv + L.q);
  float* prob = reinterpret_cast<float*>(md_k3_smem + 2 * L.kv + L.q + L.part);

  const int tiles = (S + P - 1) / P;
  const int rank = blockIdx.x % cluster;  // the block's rank in its 1-D cluster
  const int unit = blockIdx.x / cluster;  // (b, h, tile)
  const int tile = unit % tiles;
  const int h = (unit / tiles) % heads;
  const long b = unit / (tiles * heads);
  const int p0 = tile * P;
  const long c0 = b * C + (long)h * hd + (long)rank * cs;  // first (b, c) row of the slice

  // 1. the slice of k and v (rows (c, d)) and of q (rows c) into shared memory
  const int vpr = P / VEC;  // vectors per row
  for (int i = threadIdx.x; i < cs * D * vpr; i += NTHREADS) {
    const int r = i / vpr, col = (i - r * vpr) * VEC;
    const long g = (c0 * D + r) * S + p0 + col;
    bf16* ks = k_s + r * P + col;
    bf16* vs = v_s + r * P + col;
    if constexpr (VEC == 8) {
      if (p0 + col < S) {  // S % 8 == 0: a vector is all in or all out
        cp_async16(ks, k + g);
        cp_async16(vs, v + g);
      } else {
        *reinterpret_cast<uint4*>(ks) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vs) = make_uint4(0, 0, 0, 0);
      }
    } else {
      const bool in = p0 + col < S;
      *ks = in ? k[g] : __float2bfloat16(0.f);
      *vs = in ? v[g] : __float2bfloat16(0.f);
    }
  }
  for (int i = threadIdx.x; i < cs * vpr; i += NTHREADS) {
    const int r = i / vpr, col = (i - r * vpr) * VEC;
    const long g = (c0 + r) * S + p0 + col;
    bf16* qs = q_s + r * P + col;
    if constexpr (VEC == 8) {
      if (p0 + col < S)
        cp_async16(qs, q + g);
      else
        *reinterpret_cast<uint4*>(qs) = make_uint4(0, 0, 0, 0);
    } else {
      *qs = p0 + col < S ? q[g] : __float2bfloat16(0.f);
    }
  }
  if constexpr (VEC == 8) cp_async_wait_all();
  __syncthreads();

  // 2. partial logits over the block's channels: part[d * P + p]
  for (int i = threadIdx.x; i < D * P; i += NTHREADS) {
    const int d = i / P, p = i - d * P;
    float acc = 0.f;
    for (int c = 0; c < cs; ++c)
      acc = fmaf(__bfloat162float(q_s[c * P + p]), __bfloat162float(k_s[(c * D + d) * P + p]),
                 acc);
    part[i] = acc;
  }

  // 3. the cluster's sum, rank by rank, in every block
  if (cluster > 1) {
    cluster_arrive();
    cluster_wait();  // every block's partials are written
    for (int i = threadIdx.x; i < D * P; i += NTHREADS) {
      float s = 0.f;
      for (int r = 0; r < cluster; ++r) s += peer(part, r)[i];
      prob[i] = s * scale_log2;
    }
    cluster_arrive();  // this block has read its peers
  } else {
    for (int i = threadIdx.x; i < D * P; i += NTHREADS) prob[i] = part[i] * scale_log2;
  }
  __syncthreads();

  // 4. the softmax over depth, one thread per pixel, in place
  for (int p = threadIdx.x; p < P; p += NTHREADS) {
    float m = -INFINITY;
    for (int d = 0; d < D; ++d) m = fmaxf(m, prob[d * P + p]);
    float l = 0.f;
    for (int d = 0; d < D; ++d) {
      const float e = exp2f(prob[d * P + p] - m);
      prob[d * P + p] = e;
      l += e;
    }
    const float inv = 1.f / l;
    for (int d = 0; d < D; ++d) prob[d * P + p] *= inv;
  }
  __syncthreads();

  // 5. out[c, p] = sum_d attn[d, p] * v[c, d, p] for the block's channels
  for (int i = threadIdx.x; i < cs * P; i += NTHREADS) {
    const int c = i / P, p = i - c * P;
    if (p0 + p >= S) continue;
    float acc = 0.f;
    for (int d = 0; d < D; ++d)
      acc = fmaf(prob[d * P + p], __bfloat162float(v_s[(c * D + d) * P + p]), acc);
    out[(c0 + c) * S + p0 + p] = __float2bfloat16(acc);
  }
  if (cluster > 1) cluster_wait();  // no peer reads this block's partials any more
}

bool (&smem_flags(int vec))[MAX_DEVICES] {
  static bool done[2][MAX_DEVICES] = {};
  return done[vec == 8];
}

int kernel_for(int vec, void (**kernel)(const bf16*, const bf16*, const bf16*, bf16*, int, int,
                                        int, int, int, int, float)) {
  *kernel = vec == 8 ? md_depth_attn_kernel<8> : md_depth_attn_kernel<1>;
  return allow_smem(reinterpret_cast<const void*>(*kernel), MAX_BLOCK_SMEM, smem_flags(vec));
}

// The checks of a plan; 0 if the kernel takes it.
int check_plan(int C, int D, int S, int heads, int P, int cluster, int vec) {
  if (heads <= 0 || C % heads != 0 || D <= 0 || S <= 0 || P <= 0 || P > S)
    return (int)cudaErrorInvalidValue;
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  if ((C / heads) % cluster != 0) return (int)cudaErrorInvalidValue;
  if (vec != 1 && !(vec == 8 && S % 8 == 0 && P % 8 == 0)) return (int)cudaErrorInvalidValue;
  if (Layout((C / heads) / cluster, D, P).bytes > MAX_BLOCK_SMEM)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// q, out (B, C, S); k, v (B, C, D, S); bf16, contiguous, 16-byte aligned
// where vec is 8. One cluster of `cluster` blocks (1, 2, 4 or 8, dividing
// head_dim = C / heads) per (sample, head, tile of P pixels, 1 <= P <= S);
// vec 8 (16-byte copies; S and P multiples of 8) or 1. Returns the first
// CUDA error of the shared-memory raise or the launch.
int md_depth_attention_fwd(const void* q, const void* k, const void* v, void* out, int batch,
                           int C, int D, int S, int heads, int P, int cluster, int vec,
                           float scale, void* stream) {
  int err = check_plan(C, D, S, heads, P, cluster, vec);
  if (err != 0 || batch <= 0) return err != 0 ? err : (int)cudaErrorInvalidValue;
  const long blocks = (long)batch * heads * ((S + P - 1) / P) * cluster;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  void (*kernel)(const bf16*, const bf16*, const bf16*, bf16*, int, int, int, int, int, int,
                 float);
  err = kernel_for(vec, &kernel);
  if (err != 0) return err;
  return launch_cluster(kernel, (unsigned)blocks, NTHREADS,
                        Layout(C / heads / cluster, D, P).bytes, cluster,
                        static_cast<cudaStream_t>(stream), static_cast<const bf16*>(q),
                        static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                        static_cast<bf16*>(out), C, D, S, heads, P, cluster,
                        scale * LOG2E);
}

// Shared memory of one block of a plan (as depth_plan computes it).
int md_depth_attention_smem_bytes(int C, int D, int heads, int P, int cluster) {
  if (heads <= 0 || cluster <= 0 || C % heads != 0 || (C / heads) % cluster != 0) return -1;
  return Layout(C / heads / cluster, D, P).bytes;
}

// cudaOccupancyMaxActiveClusters for a plan: the clusters the card holds at
// once; minus the CUDA error if the plan or the query is refused.
int md_depth_attention_max_clusters(int C, int D, int S, int heads, int P, int cluster,
                                    int vec) {
  int err = check_plan(C, D, S, heads, P, cluster, vec);
  void (*kernel)(const bf16*, const bf16*, const bf16*, bf16*, int, int, int, int, int, int,
                 float);
  if (err == 0) err = kernel_for(vec, &kernel);
  if (err != 0) return -err;
  return max_active_clusters(kernel, NTHREADS, Layout(C / heads / cluster, D, P).bytes,
                             cluster);
}

const char* md_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
