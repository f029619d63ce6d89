// Victim-subset topology scoring for Hopper (sm_90a): the paper's §3.4
// candidate-sourcing hot loop as popcount lane math.
//
// Replaces the three Pallas TPU kernels of repro/kernels/topo_score.py:
//   topo_score_kernel        <- topo_score_pallas         (_kernel)
//   topo_score_argmax_kernel <- topo_score_argmax_pallas  (_argmax_kernel)
//   placement_tier_kernel    <- placement_tier_pallas     (_place_tier_kernel)
// All three share one device function, tier_score(), the counterpart of the
// reference's _tier_score.
//
// One lane is one victim subset (or, for placement_tier, one node): its
// freed-GPU and freed-CoreGroup int32 bitmasks.  Per NUMA node the kernel
// counts popc(mask & numa_mask), forms bundle units, and derives the tier
// (0 = one NUMA, 1 = one socket, 2 = cross-socket, 3 = infeasible) and the
// Eq. 1 score.
//
// Layout: one block of 256 threads per tile of 1024 lanes (the reference's
// (8, 128) tile), 4 consecutive lanes per thread, loaded and stored as one
// 16-byte vector where the tensors are 16-byte aligned and the 4 lanes lie
// inside n; the ragged edge is masked lane by lane here, not padded by the
// caller.
//
// Bound: bytes.  K1 moves 28 B per lane (five int32 in, int32 tier and f32
// score out) for a few dozen integer operations, far below Hopper's
// operations-per-byte balance, so the design keeps every lane to one read
// and one write and does the per-tile argmax in registers and shared memory
// instead of a second pass.  At the main path's n <= 256 lanes (one tile)
// the launch itself dominates.
//
// Exactness traps (each must hold for bit-identical results against the
// reference and against the plain PyTorch versions):
//  * Score arithmetic.  The reference computes
//      alpha * prio_term + (1 - alpha) * topo
//    in f32 with alpha rounded to f32 and (1 - alpha) computed in double on
//    the host and then rounded to f32; the host passes both in TopoParams.
//    prio_term is 1.0f / float(max(prio, 1)) (1.0f where prio <= 0), and the
//    tier values are the f32 constants (1.0, 0.5, 0.1, 0.0).  nvcc contracts
//    a*b + c*d into an FMA by default, which rounds once instead of three
//    times, so every step uses an explicit round-to-nearest intrinsic
//    (__int2float_rn, __fdiv_rn, __fmul_rn, __fadd_rn), which the compiler
//    never contracts.  Tier 3 and masked (!ok) lanes score -inf.
//  * Sentinels on a tile with no feasible lane.  The reference reports
//    kmin = K_INFEASIBLE, btier = 3, bscore = -inf and
//    bidx = tile * 1024 + K_INFEASIBLE; the reduction's identity key is
//    exactly (K_INFEASIBLE, 3, -inf, K_INFEASIBLE), so those values fall out.
//  * Padding.  Lanes past n read as mask 0, prio 0, k = K_INFEASIBLE and
//    ok = 0.  A zero-need request makes a zero-mask lane feasible, so it is
//    the ok = 0 of a pad lane that keeps it out of the argmax.
//  * cnt_cg / cgs_per_bundle is integer division, taken only when
//    cgs_per_bundle > 0 (counts are non-negative, so C's truncation equals
//    Python's floor division).
//  * The reduction selects as the reference does: the smallest k among
//    feasible lanes with k <= K_INFEASIBLE, then the lowest tier, then the
//    highest score, then the lowest flat index.  The flat index makes the
//    order total, so the result does not depend on the reduction's order.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxNuma = 8;
constexpr int kMaxSockets = 8;
constexpr int kThreads = 256;
constexpr int kLanesPerThread = 4;
constexpr int kTile = kThreads * kLanesPerThread;  // 1024 = 8 x 128
constexpr int kWarps = kThreads / 32;
constexpr int kInfeasible = 1 << 30;                // K_INFEASIBLE

}  // namespace

// Mirrored by ctypes.Structure _Params in repro_torch/kernels/topo_score.py.
struct TopoParams {
  int num_numa;
  int num_sockets;
  int need_gpus;
  int need_cgs;
  int cgs_per_bundle;
  int numa_gpu[kMaxNuma];
  int numa_cg[kMaxNuma];
  int socket_of_numa[kMaxNuma];
  float alpha;
  float one_minus_alpha;
};

__device__ __forceinline__ void tier_score(int g, int c, int prio,
                                           const TopoParams& p, int& tier,
                                           float& score) {
  int sock_units[kMaxSockets];
  int sock_cg[kMaxSockets];
#pragma unroll
  for (int s = 0; s < kMaxSockets; ++s) {
    sock_units[s] = 0;
    sock_cg[s] = 0;
  }
  int glob_units = 0;
  int glob_cg = 0;
  bool numa_ok = false;
#pragma unroll
  for (int u = 0; u < kMaxNuma; ++u) {
    if (u < p.num_numa) {
      const int cnt_gpu = __popc(static_cast<unsigned>(g & p.numa_gpu[u]));
      const int cnt_cg = __popc(static_cast<unsigned>(c & p.numa_cg[u]));
      // integer division, and only for a bundled request (trap 4)
      const int units = p.cgs_per_bundle > 0
                            ? min(cnt_gpu, cnt_cg / p.cgs_per_bundle)
                            : cnt_gpu;
      numa_ok |= (units >= p.need_gpus) && (cnt_cg >= p.need_cgs);
      const int sock = p.socket_of_numa[u];
#pragma unroll
      for (int s = 0; s < kMaxSockets; ++s) {  // unrolled: stays in registers
        if (s == sock) {
          sock_units[s] += units;
          sock_cg[s] += cnt_cg;
        }
      }
      glob_units += units;
      glob_cg += cnt_cg;
    }
  }
  bool sock_ok = false;
#pragma unroll
  for (int s = 0; s < kMaxSockets; ++s) {
    if (s < p.num_sockets) {
      sock_ok |= (sock_units[s] >= p.need_gpus) && (sock_cg[s] >= p.need_cgs);
    }
  }
  const bool glob_ok = (glob_units >= p.need_gpus) && (glob_cg >= p.need_cgs);
  tier = numa_ok ? 0 : (sock_ok ? 1 : (glob_ok ? 2 : 3));

  // Eq. 1 with explicit rounding at every step (trap 1)
  const float topo = tier == 0 ? 1.0f : (tier == 1 ? 0.5f : (tier == 2 ? 0.1f : 0.0f));
  const float prio_term =
      prio > 0 ? __fdiv_rn(1.0f, __int2float_rn(max(prio, 1))) : 1.0f;
  const float s = __fadd_rn(__fmul_rn(p.alpha, prio_term),
                            __fmul_rn(p.one_minus_alpha, topo));
  score = tier < 3 ? s : -CUDART_INF_F;
}

// Loads 4 consecutive lanes from `base`; lanes >= n read as `fill` (trap 3).
__device__ __forceinline__ void load4(const int* __restrict__ x, int base,
                                      int n, bool vec, int fill, int out[4]) {
  if (vec && base + 3 < n) {
    const int4 v = *reinterpret_cast<const int4*>(x + base);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = base + j < n ? x[base + j] : fill;
  }
}

template <typename T, typename V>
__device__ __forceinline__ void store4(T* __restrict__ y, int base, int n,
                                       bool vec, const T in[4]) {
  if (vec && base + 3 < n) {
    V v;
    v.x = in[0];
    v.y = in[1];
    v.z = in[2];
    v.w = in[3];
    *reinterpret_cast<V*>(y + base) = v;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (base + j < n) y[base + j] = in[j];
  }
}

__global__ void __launch_bounds__(kThreads)
    topo_score_kernel(const int* __restrict__ gmask,
                      const int* __restrict__ cmask,
                      const int* __restrict__ prio, int* __restrict__ tier_out,
                      float* __restrict__ score_out, int n, TopoParams p,
                      int vec) {
  const int base = blockIdx.x * kTile + threadIdx.x * kLanesPerThread;
  int g[4], c[4], pr[4], tier[4];
  float score[4];
  load4(gmask, base, n, vec, 0, g);
  load4(cmask, base, n, vec, 0, c);
  load4(prio, base, n, vec, 0, pr);
#pragma unroll
  for (int j = 0; j < 4; ++j) tier_score(g[j], c[j], pr[j], p, tier[j], score[j]);
  store4<int, int4>(tier_out, base, n, vec, tier);
  store4<float, float4>(score_out, base, n, vec, score);
}

__global__ void __launch_bounds__(kThreads)
    placement_tier_kernel(const int* __restrict__ free_gpu,
                          const int* __restrict__ free_cg,
                          int* __restrict__ tier_out, int n, TopoParams p,
                          int vec) {
  const int base = blockIdx.x * kTile + threadIdx.x * kLanesPerThread;
  int g[4], c[4], tier[4];
  float unused;
  load4(free_gpu, base, n, vec, 0, g);
  load4(free_cg, base, n, vec, 0, c);
#pragma unroll
  for (int j = 0; j < 4; ++j) tier_score(g[j], c[j], 0, p, tier[j], unused);
  store4<int, int4>(tier_out, base, n, vec, tier);
}

// Argmax key of one lane: lexicographic min over (k, tier, -score, idx).
struct Key {
  int k;
  int tier;
  float score;
  int idx;
};

__device__ __forceinline__ bool better(const Key& a, const Key& b) {
  if (a.k != b.k) return a.k < b.k;
  if (a.tier != b.tier) return a.tier < b.tier;
  if (a.score != b.score) return a.score > b.score;
  return a.idx < b.idx;
}

__device__ __forceinline__ Key shfl_key(const Key& a, int offset) {
  Key b;
  b.k = __shfl_xor_sync(0xffffffffu, a.k, offset);
  b.tier = __shfl_xor_sync(0xffffffffu, a.tier, offset);
  b.score = __shfl_xor_sync(0xffffffffu, a.score, offset);
  b.idx = __shfl_xor_sync(0xffffffffu, a.idx, offset);
  return b;
}

__global__ void __launch_bounds__(kThreads)
    topo_score_argmax_kernel(const int* __restrict__ gmask,
                             const int* __restrict__ cmask,
                             const int* __restrict__ prio,
                             const int* __restrict__ kk,
                             const int* __restrict__ okm,
                             int* __restrict__ tier_out,
                             float* __restrict__ score_out,
                             int* __restrict__ kmin_out,
                             int* __restrict__ btier_out,
                             float* __restrict__ bscore_out,
                             int* __restrict__ bidx_out, int n, TopoParams p,
                             int vec) {
  __shared__ Key warp_best[kWarps];
  const int local0 = threadIdx.x * kLanesPerThread;
  const int base = blockIdx.x * kTile + local0;
  int g[4], c[4], pr[4], k[4], ok[4], tier[4];
  float score[4];
  load4(gmask, base, n, vec, 0, g);
  load4(cmask, base, n, vec, 0, c);
  load4(prio, base, n, vec, 0, pr);
  load4(kk, base, n, vec, kInfeasible, k);
  load4(okm, base, n, vec, 0, ok);

  // identity key == the no-feasible-lane sentinels (trap 2)
  Key best = {kInfeasible, 3, -CUDART_INF_F, kInfeasible};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    tier_score(g[j], c[j], pr[j], p, tier[j], score[j]);
    if (ok[j] == 0) {  // filtering mask: masked lanes never win
      tier[j] = 3;
      score[j] = -CUDART_INF_F;
    }
    if (tier[j] < 3 && k[j] <= kInfeasible) {
      const Key cand = {k[j], tier[j], score[j], local0 + j};
      if (better(cand, best)) best = cand;
    }
  }
  store4<int, int4>(tier_out, base, n, vec, tier);
  store4<float, float4>(score_out, base, n, vec, score);

#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const Key other = shfl_key(best, offset);
    if (better(other, best)) best = other;
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_best[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    Key tile_best = warp_best[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      if (better(warp_best[w], tile_best)) tile_best = warp_best[w];
    kmin_out[blockIdx.x] = tile_best.k;
    btier_out[blockIdx.x] = tile_best.tier;
    bscore_out[blockIdx.x] = tile_best.score;
    bidx_out[blockIdx.x] = blockIdx.x * kTile + tile_best.idx;
  }
}

static inline int grid_for(int n) { return (n + kTile - 1) / kTile; }

// Plain C interface for ctypes.  Pointers are device pointers of contiguous
// int32/float32 tensors, `params` a host pointer, `stream` a cudaStream_t.
// Each returns the launch's cudaGetLastError() (0 on success).
extern "C" {

int topo_score_launch(const void* gmask, const void* cmask, const void* prio,
                      void* tier, void* score, int n, const TopoParams* params,
                      int vec, void* stream) {
  topo_score_kernel<<<grid_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(gmask), static_cast<const int*>(cmask),
      static_cast<const int*>(prio), static_cast<int*>(tier),
      static_cast<float*>(score), n, *params, vec);
  return static_cast<int>(cudaGetLastError());
}

int topo_score_argmax_launch(const void* gmask, const void* cmask,
                             const void* prio, const void* k, const void* ok,
                             void* tier, void* score, void* kmin, void* btier,
                             void* bscore, void* bidx, int n,
                             const TopoParams* params, int vec, void* stream) {
  topo_score_argmax_kernel<<<grid_for(n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(gmask), static_cast<const int*>(cmask),
      static_cast<const int*>(prio), static_cast<const int*>(k),
      static_cast<const int*>(ok), static_cast<int*>(tier),
      static_cast<float*>(score), static_cast<int*>(kmin),
      static_cast<int*>(btier), static_cast<float*>(bscore),
      static_cast<int*>(bidx), n, *params, vec);
  return static_cast<int>(cudaGetLastError());
}

int placement_tier_launch(const void* free_gpu, const void* free_cg,
                          void* tier, int n, const TopoParams* params, int vec,
                          void* stream) {
  placement_tier_kernel<<<grid_for(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(free_gpu), static_cast<const int*>(free_cg),
      static_cast<int*>(tier), n, *params, vec);
  return static_cast<int>(cudaGetLastError());
}

const char* topo_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
