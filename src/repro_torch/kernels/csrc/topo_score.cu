// Victim-subset topology scoring for Hopper (sm_90a): the paper's §3.4
// candidate-sourcing hot loop as popcount lane math, in two forms: the lane
// kernels below (K1-K3, one lane a subset built by the host) and, after
// them, the fused engine's kernels over the device-resident cluster state
// (K1's resident form and its tail, K2's normal-cycle form), described at
// their section.
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

constexpr int kMaxScopes = kMaxNuma + kMaxSockets + 1;
constexpr int kMaxCap = 32;         // one warp loads a row's slots
constexpr int kMaxDenseVictims = 16;
constexpr int kIntMax = 0x7fffffff;
constexpr int kNodeFields = 5;
constexpr int kVictimFields = 5;
constexpr int kWinFields = 9;
constexpr int kNarrowThreads = 256; // K1, m <= 8: 8 rows (warps) a CTA
constexpr int kWideThreads = 512;   // K1, m = 16: one row a CTA
constexpr int kTailThreads = 512;
constexpr int kNormalThreads = 128;  // K2 normal cycle: a node a thread

enum { NS_FREE_GPU, NS_FREE_CG, NS_NODE_ID, NS_OVERFLOW, NS_NEXT_PRIO };
enum { VF_GPU, VF_CG, VF_PRIO, VF_RANK, VF_STORED };

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

// ============================================================================
// The fused imp_batched engine's kernels: one plan of Algorithm 1 over the
// device-resident cluster state in three launches.
//
//   normal_cycle_kernel  K2, normal-cycle form.  Replaces the XLA program of
//                        repro/core/placement_jax.py normal_cycle_core, which
//                        K2 (placement_tier_pallas, repro/kernels/
//                        topo_score.py:285) computes the tiers for: per node
//                        the count screen, the placement tier and the blind
//                        tier, the exact (tier, leftover, node) argmin, and
//                        the winner's masks (place_core / place_blind_core).
//   fused_class_kernel   K1, resident form.  Replaces the XLA program of
//                        repro/core/preemption_jax.py _fused_class_core, the
//                        sweep K1 (topo_score_argmax_pallas,
//                        repro/kernels/topo_score.py:214) scores lane by lane:
//                        Guaranteed Filtering on the drain masks, the narrow
//                        gate, every one of a row's 2^m victim subsets, each
//                        row's smallest feasible k and its count, and each
//                        (row, tier) class winner.  Every row of the plan in
//                        ONE launch.
//   fused_argmax_kernel  K1's tail.  Replaces _fused_argmax_core (the Eq. 2
//                        argmax over the <= 3 x rows class winners with its
//                        exact tie chain) and placement_jax.winner_place.
//
// The state is the three stacked int32 tensors of DeviceClusterState,
// nodestate [5, N], victims [5, N, cap] and drain [2, N], read and never
// written.  Rows a plan sees differently (a view's delta rows and rows not
// yet flushed to the device) arrive as patch rows: pidx (sorted ascending,
// IDX_SENTINEL pads last) names them and pbuf [P, 5 + 5 cap + 2] holds them
// flattened; a kernel finds a row's patch by binary search in pidx.  Gathered
// rows (the mid-width rows of a plan, the wide chunks) are named by gidx;
// an index outside [0, N) reads as a zero row whose node id is the index
// (jnp.take(mode="fill") and .at[NS_NODE_ID].set(gidx) in the reference).
//
// Chain of a plan, in stream order: K2 writes out[0..4]; K1 and its tail
// read out[0] (found) and return at once when the normal cycle placed; the
// tail writes out[5..13].  The host reads the 14 int32 once.
//
// Design for this card, and the bound:
//  * K1: one warp per row for m <= 8 (a row has at most 256 subsets, 8 a
//    lane), 8 rows a CTA, so 1024 rows fill about one wave of the 132 SMs;
//    one CTA of 512 threads per row for m = 16 (65536 subsets).  A row's
//    slots are read once into shared memory; each lane enumerates its
//    subset ids in registers (k = popc(id)); freed masks are free | OR of
//    the set slots (the reference's sum: one node's masks are disjoint).
//    Each lane keeps per tier its best (k, p_eff, -umask, id) key and the
//    count of feasible subsets at its smallest k; shuffles (and shared
//    memory across warps) reduce them.  All keys are integers, so the order
//    of the reduction cannot change the result.
//  * Bound: bytes are rows x (5 + 5 cap + 2) x 4 B in, 15 x 4 B a row out
//    (356 KB at 1024 nodes, cap 16: 0.11 us at 3.35 TB/s); operations are
//    the subsets the data makes eligible times the integer work of one
//    (chip_smoke.py computes both per run).  At 1024 nodes and m = 8 the
//    launch, not the work, sets the time.
//  * Tail: one CTA per segment of rows, two block reductions of integer/
//    float keys, then one thread places the winner.  It reads 48-490 KB
//    (1024-10240 rows) through one SM: launch- and latency-bound.
//  * K2: one thread a node over a grid of 128-thread CTAs (80 CTAs at 10240
//    nodes), the (tier, leftover, node, row) order packed into one 64-bit
//    key, a warp-shuffle and CTA min, one atomicMin a CTA, and the last CTA
//    to take a ticket (after __threadfence) places the winner with
//    place_core.  Its 16 bytes of scratch go back to {no key, 0} at the end
//    of every launch, so launches in one stream share it.
//  * The tier of a subset or a node is the lane kernels' tier_score, on the
//    request carried in FusedParams.t.
//
// Exactness traps (each must hold for bit-identical decisions):
//  * Eq. 1 in the tail: alpha is rounded to f32 and (1 - alpha) computed in
//    double on the host, then rounded to f32 (the reference bakes alpha as a
//    Python float); every step is an explicit _rn intrinsic so nvcc never
//    contracts a*b + c*d into an FMA.
//  * The tie chain: max score; then, only when every survivor shares one
//    tier, the lowest priority sum (when alpha > 0); then the smallest k,
//    the lowest node id, the highest uid-rank mask, and the lowest flat
//    index of [rows, 3] (jnp.argmax takes the first True).  With no
//    survivor the flat index is 0.
//  * Within a class: lowest p_eff, highest uid-rank mask, lowest combo id.
//    p_eff is the priority sum only when alpha > 0.
//  * The rank bit is 1 << (MAX_DENSE_VICTIMS - 1 - rank), over the full cap
//    width, not m.
//  * A row with no feasible subset reports k = m + 1 (its section's m),
//    count 0, and combo id, priority sum and uid mask 0 in every class.
//  * Rows whose node id is IDX_SENTINEL never win.
//  * Priority sums wrap as int32 (unsigned adds), as the reference's int32
//    dot product does.
//
// Output of K1, cls [15, R] int32: anyc[3], combo id[3], priority sum[3],
// uid-rank mask[3] of the (row, tier) class winners, the row's smallest
// feasible k, its count of feasible subsets at that k, and its node id.

// Mirrored by ctypes.Structure _FusedParams in
// repro_torch/kernels/fused_class.py.  The request and the SKU's NUMA
// layout are the lane kernels' TopoParams; the rest is what placement and
// the eligibility filter need.
struct FusedParams {
  TopoParams t;
  int num_gpus;
  int num_cgs;
  int n_scopes;
  int scope_members[kMaxScopes];  // bit u set: NUMA node u is in the scope
  int scope_tier[kMaxScopes];
  int thresh;                     // preemptor priority
  int alpha_pos;                  // alpha > 0
};

// Mirrored by ctypes.Structure _State in repro_torch/kernels/fused_class.py.
struct State {
  const int* ns;    // [5, n]
  const int* v;     // [5, n, cap]
  const int* dr;    // [2, n]
  const int* pidx;  // [p] sorted, sentinel pads last
  const int* pbuf;  // [p, 5 + 5 cap + 2]
  const int* gidx;  // [g]
  int n;
  int cap;
  int p;
  int g;
  int n_res;        // rows 0..n_res-1 are resident rows, then g gathered
};

// One row of the plan as the reference's overlaid (and gathered) tensors
// hold it: a resident row, its patch, or a zero row.
struct Row {
  const int* ns;    // field f at ns[f * ns_stride]
  const int* v;     // field f, slot s at v[f * v_stride + s]
  const int* dr;    // drain d at dr[d * dr_stride]
  int ns_stride;
  int v_stride;
  int dr_stride;
  bool zero;
  bool gathered;
  int gidx_value;

  __device__ __forceinline__ int node(int f) const {
    if (gathered && f == NS_NODE_ID) return gidx_value;
    return zero ? 0 : ns[f * ns_stride];
  }
  __device__ __forceinline__ int slot(int f, int s) const {
    return zero ? 0 : v[f * v_stride + s];
  }
  __device__ __forceinline__ int drain(int d) const {
    return zero ? 0 : dr[d * dr_stride];
  }
};

__device__ __forceinline__ int find_patch(const State& s, int node) {
  int lo = 0, hi = s.p;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s.pidx[mid] < node) lo = mid + 1; else hi = mid;
  }
  return (lo < s.p && s.pidx[lo] == node) ? lo : -1;
}

__device__ __forceinline__ Row fetch_row(const State& s, int r) {
  Row row;
  row.gathered = r >= s.n_res;
  const int node = row.gathered ? s.gidx[r - s.n_res] : r;
  row.gidx_value = node;
  row.zero = node < 0 || node >= s.n;
  if (row.zero) {
    row.ns = row.v = row.dr = nullptr;
    row.ns_stride = row.v_stride = row.dr_stride = 0;
    return row;
  }
  const int j = s.p > 0 ? find_patch(s, node) : -1;
  if (j >= 0) {
    const int width = kNodeFields + kVictimFields * s.cap + 2;
    const int* b = s.pbuf + static_cast<long>(j) * width;
    row.ns = b;
    row.ns_stride = 1;
    row.v = b + kNodeFields;
    row.v_stride = s.cap;
    row.dr = b + kNodeFields + kVictimFields * s.cap;
    row.dr_stride = 1;
  } else {
    row.ns = s.ns + node;
    row.ns_stride = s.n;
    row.v = s.v + static_cast<long>(node) * s.cap;
    row.v_stride = s.n * s.cap;
    row.dr = s.dr + node;
    row.dr_stride = s.n;
  }
  return row;
}

// ---- placement bit math (placement_jax: tier_from_counts_dyn, place_core,
// ---- place_blind_core, achieved_tier_dev) ---------------------------------

// The placement tier of freed masks: the lane kernels' tier_score, whose
// unused score the compiler drops.
__device__ __forceinline__ int tier_of(unsigned g, unsigned c,
                                       const FusedParams& p) {
  int tier;
  float unused;
  tier_score(static_cast<int>(g), static_cast<int>(c), 0, p.t, tier, unused);
  return tier;
}

// Lowest k set bits of mask among bits 0..nbits-1 (all of them when fewer).
__device__ __forceinline__ unsigned lowest_bits(unsigned mask, int k,
                                                int nbits) {
  unsigned m = nbits >= 32 ? mask : mask & ((1u << nbits) - 1u);
  unsigned out = 0;
  for (int i = 0; i < k && m; ++i) {
    const unsigned b = m & (0u - m);
    out |= b;
    m ^= b;
  }
  return out;
}

__device__ __forceinline__ int achieved_tier(unsigned gm, const FusedParams& p) {
  int n_numa = 0;
  unsigned socks = 0;
#pragma unroll
  for (int u = 0; u < kMaxNuma; ++u) {
    if (u < p.t.num_numa && (gm & static_cast<unsigned>(p.t.numa_gpu[u]))) {
      ++n_numa;
      socks |= 1u << p.t.socket_of_numa[u];
    }
  }
  if (gm == 0 || n_numa <= 1) return 0;
  return __popc(socks) <= 1 ? 1 : 2;
}

__device__ void place_core(unsigned fg, unsigned fc, const FusedParams& p,
                           bool& ok, int& tier, unsigned& gm, unsigned& cm) {
  int cnt_c[kMaxNuma], units[kMaxNuma];
#pragma unroll
  for (int u = 0; u < kMaxNuma; ++u) {
    const int cg = u < p.t.num_numa
                       ? __popc(fg & static_cast<unsigned>(p.t.numa_gpu[u])) : 0;
    cnt_c[u] = u < p.t.num_numa
                   ? __popc(fc & static_cast<unsigned>(p.t.numa_cg[u])) : 0;
    units[u] = p.t.cgs_per_bundle > 0 ? min(cg, cnt_c[u] / p.t.cgs_per_bundle)
                                    : cg;
  }
  tier = tier_of(fg, fc, p);
  int best_key = kIntMax, si = 0;
  bool any = false;
  for (int sc = 0; sc < p.n_scopes; ++sc) {
    int s_units = 0, s_cg = 0;
#pragma unroll
    for (int u = 0; u < kMaxNuma; ++u) {
      if ((p.scope_members[sc] >> u) & 1) {
        s_units += units[u];
        s_cg += cnt_c[u];
      }
    }
    if (s_units >= p.t.need_gpus && s_cg >= p.t.need_cgs &&
        p.scope_tier[sc] == tier) {
      any = true;
      const int key = (s_units - p.t.need_gpus) * p.n_scopes + sc;
      if (key < best_key) {
        best_key = key;
        si = sc;
      }
    }
  }
  const int member = p.scope_members[si];
  int rem_g = p.t.need_gpus, rem_c = p.t.need_cgs;
  gm = 0;
  cm = 0;
#pragma unroll
  for (int u = 0; u < kMaxNuma; ++u) {
    if (u < p.t.num_numa) {
      const int take = ((member >> u) & 1) ? min(rem_g, units[u]) : 0;
      gm |= lowest_bits(fg & static_cast<unsigned>(p.t.numa_gpu[u]), take,
                        p.num_gpus);
      rem_g -= take;
      const int c_take = min(take * p.t.cgs_per_bundle, rem_c);
      cm |= lowest_bits(fc & static_cast<unsigned>(p.t.numa_cg[u]), c_take,
                        p.num_cgs);
      rem_c -= c_take;
    }
  }
#pragma unroll
  for (int u = 0; u < kMaxNuma; ++u) {
    if (u < p.t.num_numa) {
      const unsigned avail = fc & static_cast<unsigned>(p.t.numa_cg[u]) & ~cm;
      const int take = ((member >> u) & 1) ? min(__popc(avail), rem_c) : 0;
      cm |= lowest_bits(avail, take, p.num_cgs);
      rem_c -= take;
    }
  }
  ok = tier < 3 && any && rem_g == 0 && rem_c == 0;
}

// ---- K1 resident form: the class sweep ------------------------------------

// (k asc, p_eff asc, umask desc, id asc): the order inside one (row, tier)
// class at the row's smallest k.
struct ClassKey {
  int k;
  int p;
  int u;
  int id;
};

__device__ __forceinline__ bool class_better(const ClassKey& a,
                                             const ClassKey& b) {
  if (a.k != b.k) return a.k < b.k;
  if (a.p != b.p) return a.p < b.p;
  if (a.u != b.u) return a.u > b.u;
  return a.id < b.id;
}

struct RowSmem {
  unsigned fg, fc;
  int node_id;
  int ok;
  unsigned valid;  // slots (< m) that are stored and eligible
  unsigned vg[kMaxDenseVictims];
  unsigned vc[kMaxDenseVictims];
  unsigned vp[kMaxDenseVictims];
  unsigned rb[kMaxDenseVictims];
};

struct Partial {
  ClassKey best[3];
  int kmin;
  int cnt;
};

__device__ __forceinline__ void merge(Partial& a, const Partial& b) {
#pragma unroll
  for (int t = 0; t < 3; ++t)
    if (class_better(b.best[t], a.best[t])) a.best[t] = b.best[t];
  const int k = min(a.kmin, b.kmin);
  a.cnt = (a.kmin == k ? a.cnt : 0) + (b.kmin == k ? b.cnt : 0);
  a.kmin = k;
}

__device__ __forceinline__ Partial shfl_partial(const Partial& a, int off) {
  Partial b;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    b.best[t].k = __shfl_xor_sync(0xffffffffu, a.best[t].k, off);
    b.best[t].p = __shfl_xor_sync(0xffffffffu, a.best[t].p, off);
    b.best[t].u = __shfl_xor_sync(0xffffffffu, a.best[t].u, off);
    b.best[t].id = __shfl_xor_sync(0xffffffffu, a.best[t].id, off);
  }
  b.kmin = __shfl_xor_sync(0xffffffffu, a.kmin, off);
  b.cnt = __shfl_xor_sync(0xffffffffu, a.cnt, off);
  return b;
}

__device__ __forceinline__ Partial warp_reduce(Partial a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) merge(a, shfl_partial(a, off));
  return a;
}

// GROUP threads sweep one row: 32 (one warp, m <= 8) or kWideThreads.
template <int GROUP, int THREADS>
__global__ void __launch_bounds__(THREADS)
    fused_class_kernel(State s, FusedParams p, int m_res, int m_gather,
                       int R, const int* __restrict__ skip,
                       int* __restrict__ cls) {
  if (skip != nullptr && *skip != 0) return;  // the normal cycle placed
  constexpr int kRows = THREADS / GROUP;
  constexpr int kWarpsPerGroup = GROUP / 32;
  __shared__ RowSmem rows[kRows];
  __shared__ Partial warp_part[THREADS / 32];
  const int sub = threadIdx.x / GROUP;
  const int lane = threadIdx.x % GROUP;
  const int r = blockIdx.x * kRows + sub;
  if (r >= R) return;  // whole groups exit together (GROUP | THREADS)
  RowSmem& rs = rows[sub];
  const bool gathered = r >= s.n_res;
  const int m = gathered ? m_gather : m_res;

  // load the row once: the first warp of the group reads its slots
  if (lane < 32) {
    const Row row = fetch_row(s, r);
    int elig = 0;
    if (lane < s.cap) {
      const int prio = row.slot(VF_PRIO, lane);
      elig = row.slot(VF_STORED, lane) != 0 && prio < p.thresh;
      if (lane < m) {
        rs.vg[lane] = static_cast<unsigned>(row.slot(VF_GPU, lane));
        rs.vc[lane] = static_cast<unsigned>(row.slot(VF_CG, lane));
        rs.vp[lane] = static_cast<unsigned>(prio);
        const unsigned sh = static_cast<unsigned>(
            kMaxDenseVictims - 1 - row.slot(VF_RANK, lane));
        rs.rb[lane] = sh < 32u ? (1u << sh) : 0u;
      }
    }
    const unsigned eb = __ballot_sync(0xffffffffu, elig);
    if (lane == 0) {
      rs.fg = static_cast<unsigned>(row.node(NS_FREE_GPU));
      rs.fc = static_cast<unsigned>(row.node(NS_FREE_CG));
      rs.node_id = row.node(NS_NODE_ID);
      // Guaranteed Filtering: the fully drained masks must reach a tier
      bool ok = tier_of(static_cast<unsigned>(row.drain(0)),
                        static_cast<unsigned>(row.drain(1)), p) < 3 &&
                rs.node_id < kIntMax;
      if (!gathered) {  // the narrow gate of the resident section
        ok = ok && __popc(eb) <= m &&
             !(row.node(NS_OVERFLOW) != 0 && row.node(NS_NEXT_PRIO) < p.thresh);
      }
      rs.ok = ok;
      rs.valid = eb & ((1u << m) - 1u);
    }
  }
  if (GROUP == 32) __syncwarp(); else __syncthreads();

  Partial part;
#pragma unroll
  for (int t = 0; t < 3; ++t) part.best[t] = {kIntMax, kIntMax, -1, kIntMax};
  part.kmin = m + 1;
  part.cnt = 0;
  if (rs.ok) {
    const unsigned valid = rs.valid;
    const int n_comb = 1 << m;
    for (int id = lane; id < n_comb; id += GROUP) {
      if (static_cast<unsigned>(id) & ~valid) continue;  // ineligible slot
      unsigned g = rs.fg, c = rs.fc, pr = 0, u = 0;
      for (unsigned b = static_cast<unsigned>(id); b; b &= b - 1) {
        const int sl = __ffs(b) - 1;
        g |= rs.vg[sl];
        c |= rs.vc[sl];
        pr += rs.vp[sl];
        u += rs.rb[sl];
      }
      const int tier = tier_of(g, c, p);
      if (tier >= 3) continue;
      const int k = __popc(id);
      if (k < part.kmin) {
        part.kmin = k;
        part.cnt = 1;
      } else if (k == part.kmin) {
        ++part.cnt;
      }
      const ClassKey cand = {k, p.alpha_pos ? static_cast<int>(pr) : 0,
                             static_cast<int>(u), id};
#pragma unroll
      for (int t = 0; t < 3; ++t)
        if (t == tier && class_better(cand, part.best[t])) part.best[t] = cand;
    }
  }
  part = warp_reduce(part);
  if (kWarpsPerGroup > 1) {
    const int warp = threadIdx.x / 32;
    if ((threadIdx.x & 31) == 0) warp_part[warp] = part;
    __syncthreads();
    if (threadIdx.x < 32) {
      part = warp_part[0];
      for (int w = 1; w < kWarpsPerGroup; ++w) merge(part, warp_part[w]);
    }
  }
  if (lane == 0) {
    const int kn = part.kmin;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const bool any = part.best[t].k == kn;
      const int cb = any ? part.best[t].id : 0;
      unsigned pp = 0;
      for (unsigned b = static_cast<unsigned>(cb); b; b &= b - 1)
        pp += rs.vp[__ffs(b) - 1];
      cls[(0 + t) * R + r] = any;
      cls[(3 + t) * R + r] = cb;
      cls[(6 + t) * R + r] = static_cast<int>(pp);
      cls[(9 + t) * R + r] = any ? part.best[t].u : 0;
    }
    cls[12 * R + r] = kn;
    cls[13 * R + r] = part.cnt;
    cls[14 * R + r] = rs.node_id;
  }
}

// ---- K1's tail: Eq. 2 argmax over class winners, then the placement --------

__device__ __forceinline__ float eq1_score(int pp, int t, const FusedParams& p) {
  const float prio_term =
      pp > 0 ? __fdiv_rn(1.0f, __int2float_rn(max(pp, 1))) : 1.0f;
  const float tv = t == 0 ? 1.0f : (t == 1 ? 0.5f : 0.1f);
  return __fadd_rn(__fmul_rn(p.t.alpha, prio_term),
                   __fmul_rn(p.t.one_minus_alpha, tv));
}

struct ScoreKey {  // max score; the lowest and highest tier at that score
  float score;
  int tmin;
  int tmax;
  int cnt;         // n_candidates, summed alongside
};

__device__ __forceinline__ void merge_score(ScoreKey& a, const ScoreKey& b) {
  if (b.score > a.score) {
    a.score = b.score;
    a.tmin = b.tmin;
    a.tmax = b.tmax;
  } else if (b.score == a.score) {
    a.tmin = min(a.tmin, b.tmin);
    a.tmax = max(a.tmax, b.tmax);
  }
  a.cnt += b.cnt;
}

struct TieKey {  // (ppe_key asc, k asc, node id asc, umask desc, flat asc)
  int ppe;
  int k;
  int nid;
  int um;
  int flat;
};

__device__ __forceinline__ bool tie_better(const TieKey& a, const TieKey& b) {
  if (a.ppe != b.ppe) return a.ppe < b.ppe;
  if (a.k != b.k) return a.k < b.k;
  if (a.nid != b.nid) return a.nid < b.nid;
  if (a.um != b.um) return a.um > b.um;
  return a.flat < b.flat;
}

template <typename T, typename Merge, typename Shfl>
__device__ T block_reduce(T v, T* smem, Merge merge_fn, Shfl shfl) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) merge_fn(v, shfl(v, off));
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) smem[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    v = smem[0];
    for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w)
      merge_fn(v, smem[w]);
    smem[0] = v;
  }
  __syncthreads();
  v = smem[0];
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kTailThreads)
    fused_argmax_kernel(State s, FusedParams p, const int* __restrict__ cls,
                        int R, int seg, const int* __restrict__ skip,
                        int* __restrict__ out) {
  int* o = out + blockIdx.x * kWinFields;
  if (skip != nullptr && *skip != 0) {  // the normal cycle placed
    if (threadIdx.x < kWinFields) o[threadIdx.x] = 0;
    return;
  }
  __shared__ ScoreKey s_score[kTailThreads / 32];
  __shared__ TieKey s_tie[kTailThreads / 32];
  const int r0 = blockIdx.x * seg;
  const int r1 = min(R, r0 + seg);
  const int n_ent = (r1 - r0) * 3;

  ScoreKey sk = {-CUDART_INF_F, 3, -1, 0};
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) sk.cnt += cls[13 * R + r];
  for (int e = threadIdx.x; e < n_ent; e += blockDim.x) {
    const int r = r0 + e / 3, t = e % 3;
    if (cls[t * R + r]) {
      const ScoreKey c = {eq1_score(cls[(6 + t) * R + r], t, p), t, t, 0};
      merge_score(sk, c);
    }
  }
  sk = block_reduce(
      sk, s_score, merge_score, [](const ScoreKey& a, int off) {
        ScoreKey b;
        b.score = __shfl_xor_sync(0xffffffffu, a.score, off);
        b.tmin = __shfl_xor_sync(0xffffffffu, a.tmin, off);
        b.tmax = __shfl_xor_sync(0xffffffffu, a.tmax, off);
        b.cnt = __shfl_xor_sync(0xffffffffu, a.cnt, off);
        return b;
      });
  const bool found = sk.score > -CUDART_INF_F;  // some class is non-empty
  const bool same_tier = sk.tmin == sk.tmax;

  TieKey tk = {kIntMax, kIntMax, kIntMax, -1, kIntMax};
  for (int e = threadIdx.x; e < n_ent; e += blockDim.x) {
    const int r = r0 + e / 3, t = e % 3;
    if (!cls[t * R + r]) continue;
    const int pp = cls[(6 + t) * R + r];
    if (eq1_score(pp, t, p) != sk.score) continue;
    const TieKey c = {same_tier && p.alpha_pos ? pp : 0, cls[12 * R + r],
                      cls[14 * R + r], cls[(9 + t) * R + r], e};
    if (tie_better(c, tk)) tk = c;
  }
  tk = block_reduce(
      tk, s_tie,
      [](TieKey& a, const TieKey& b) {
        if (tie_better(b, a)) a = b;
      },
      [](const TieKey& a, int off) {
        TieKey b;
        b.ppe = __shfl_xor_sync(0xffffffffu, a.ppe, off);
        b.k = __shfl_xor_sync(0xffffffffu, a.k, off);
        b.nid = __shfl_xor_sync(0xffffffffu, a.nid, off);
        b.um = __shfl_xor_sync(0xffffffffu, a.um, off);
        b.flat = __shfl_xor_sync(0xffffffffu, a.flat, off);
        return b;
      });

  if (threadIdx.x == 0) {
    const int flat = found ? tk.flat : 0;  // no survivor: argmax -> 0
    const int row = flat / 3, t = flat % 3, r = r0 + row;
    const int cb = cls[(3 + t) * R + r];
    const Row w = fetch_row(s, r);
    unsigned fg = static_cast<unsigned>(w.node(NS_FREE_GPU));
    unsigned fc = static_cast<unsigned>(w.node(NS_FREE_CG));
    for (unsigned b = static_cast<unsigned>(cb); b; b &= b - 1) {
      const int sl = __ffs(b) - 1;
      fg |= static_cast<unsigned>(w.slot(VF_GPU, sl));
      fc |= static_cast<unsigned>(w.slot(VF_CG, sl));
    }
    bool ok;
    int tier;
    unsigned gm, cm;
    place_core(fg, fc, p, ok, tier, gm, cm);
    o[0] = found;
    o[1] = row;
    o[2] = t;
    o[3] = cb;
    o[4] = cls[(6 + t) * R + r];
    o[5] = cls[12 * R + r];
    o[6] = sk.cnt;
    o[7] = static_cast<int>(gm);
    o[8] = static_cast<int>(cm);
  }
}

// ---- K2 normal-cycle form ---------------------------------------------------

// The (tier, leftover, node id, row) order as one 64-bit key, smallest
// first: tier (0..2) in bits 62-63, leftover (0..32) in 56-61, the node id
// with its sign bit flipped (signed order as unsigned) in 24-55, the row in
// 0-23.  All ones is no candidate: its tier field would be 3.
constexpr unsigned long long kNoKey = ~0ull;
constexpr int kRowBits = 24;

__device__ __forceinline__ unsigned long long normal_key(int tier, int left,
                                                         int nid, int row) {
  return (static_cast<unsigned long long>(tier) << 62) |
         (static_cast<unsigned long long>(left) << 56) |
         (static_cast<unsigned long long>(static_cast<unsigned>(nid) ^
                                          0x80000000u) << kRowBits) |
         static_cast<unsigned long long>(row);
}

// The grid's running minimum and its ticket, in device memory that the
// wrapper sets to {kNoKey, 0} once; the last block sets it back.
struct NormalScratch {
  unsigned long long key;
  unsigned int ticket;
};

// One thread a node over a grid of CTAs: each node's key, a CTA min
// reduction, one atomicMin a CTA; the last CTA to take a ticket places the
// winner.
__global__ void __launch_bounds__(kNormalThreads)
    normal_cycle_kernel(State s, FusedParams p, NormalScratch* scr,
                        int* __restrict__ out) {
  __shared__ unsigned long long s_key[kNormalThreads / 32];
  __shared__ bool s_last;
  unsigned long long key = kNoKey;
  const int r = blockIdx.x * kNormalThreads + threadIdx.x;
  if (r < s.n) {
    const Row row = fetch_row(s, r);
    const unsigned fg = static_cast<unsigned>(row.node(NS_FREE_GPU));
    const unsigned fc = static_cast<unsigned>(row.node(NS_FREE_CG));
    const int nid = row.node(NS_NODE_ID);
    const int cnt_g = __popc(fg);
    // count screen; sentinel rows never win
    if (cnt_g >= p.t.need_gpus && __popc(fc) >= p.t.need_cgs &&
        nid < kIntMax) {
      const int tier = tier_of(fg, fc, p);
      const int eff = tier < 3 ? tier
                               : achieved_tier(lowest_bits(fg, p.t.need_gpus,
                                                           p.num_gpus), p);
      key = normal_key(eff, cnt_g - p.t.need_gpus, nid, r);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    key = min(key, __shfl_xor_sync(0xffffffffu, key, off));
  if ((threadIdx.x & 31) == 0) s_key[threadIdx.x / 32] = key;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kNormalThreads / 32; ++w) key = min(key, s_key[w]);
    if (key != kNoKey) atomicMin(&scr->key, key);
    __threadfence();
    s_last = atomicAdd(&scr->ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last || threadIdx.x != 0) return;

  // the last CTA: every other CTA's atomicMin is visible
  const unsigned long long best = atomicExch(&scr->key, kNoKey);
  scr->ticket = 0;
  if (s.n == 0) {
    for (int i = 0; i < 5; ++i) out[i] = 0;
    return;
  }
  const bool found = best != kNoKey;
  // no candidate: argmin -> row 0
  const int w = found ? static_cast<int>(best & ((1ull << kRowBits) - 1)) : 0;
  const Row row = fetch_row(s, w);
  const unsigned fg = static_cast<unsigned>(row.node(NS_FREE_GPU));
  const unsigned fc = static_cast<unsigned>(row.node(NS_FREE_CG));
  bool p_ok;
  int p_tier;
  unsigned pg, pc;
  place_core(fg, fc, p, p_ok, p_tier, pg, pc);
  const unsigned bg = lowest_bits(fg, p.t.need_gpus, p.num_gpus);
  const unsigned bc = lowest_bits(fc, p.t.need_cgs, p.num_cgs);
  const bool use_place = p_tier < 3 && p_ok;
  out[0] = found;
  out[1] = row.node(NS_NODE_ID);
  out[2] = use_place ? p_tier : achieved_tier(bg, p);
  out[3] = static_cast<int>(use_place ? pg : bg);
  out[4] = static_cast<int>(use_place ? pc : bc);
}

static inline int grid_for(int n) { return (n + kTile - 1) / kTile; }

// Plain C interface for ctypes.  Pointers are device pointers of contiguous
// int32/float32 tensors, `params` and `state` host pointers to the structs
// above, `stream` a cudaStream_t.  Each returns the launch's
// cudaGetLastError() (0 on success).
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


int fused_class_launch(const State* state, const FusedParams* params,
                       int m_res, int m_gather, int R, int wide,
                       const void* skip, void* cls, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sk = static_cast<const int*>(skip);
  int* out = static_cast<int*>(cls);
  if (state->cap > kMaxCap || (wide == 0 && (m_res > 8 || m_gather > 8)) ||
      m_res > min(state->cap, kMaxDenseVictims) ||
      m_gather > min(state->cap, kMaxDenseVictims) || R <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (wide) {
    fused_class_kernel<kWideThreads, kWideThreads>
        <<<R, kWideThreads, 0, st>>>(*state, *params, m_res, m_gather, R, sk,
                                     out);
  } else {
    constexpr int rows = kNarrowThreads / 32;
    fused_class_kernel<32, kNarrowThreads>
        <<<(R + rows - 1) / rows, kNarrowThreads, 0, st>>>(
            *state, *params, m_res, m_gather, R, sk, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int fused_argmax_launch(const State* state, const FusedParams* params,
                        const void* cls, int R, int seg, const void* skip,
                        void* out, void* stream) {
  const int segs = (R + seg - 1) / seg;
  fused_argmax_kernel<<<segs, kTailThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      *state, *params, static_cast<const int*>(cls), R, seg,
      static_cast<const int*>(skip), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// `scratch` is 16 bytes of device memory holding {kNoKey, 0}; launches that
// share it must run in one stream.
int normal_cycle_launch(const State* state, const FusedParams* params,
                        void* scratch, void* out, void* stream) {
  if (state->n < 0 || state->n > (1 << kRowBits))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = max(1, (state->n + kNormalThreads - 1) / kNormalThreads);
  normal_cycle_kernel<<<grid, kNormalThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      *state, *params, static_cast<NormalScratch*>(scratch),
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* topo_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
