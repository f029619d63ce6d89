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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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
constexpr int kTailThreads = 512;     // K1's tail: most threads a CTA
constexpr int kNormalThreads = 1024;  // K2 normal cycle: most threads a CTA
constexpr int kNormalBatch = 4;       // K2: rows a thread loads together
constexpr int kClusterCtas = 8;       // the portable thread-block cluster
constexpr int kMaxClusterCtas = 16;   // the largest (non-portable) one
constexpr int kMaxPatchRows = 16384;  // the patch index in shared memory
constexpr int kMaxSplitClusters = 1024; // K2's split form: partial minima

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
//  * K2 and the tail are latency-bound: their bytes take 0.004-0.15 us at
//    3.35 TB/s, so what sets their time is the chain of dependent steps
//    after the launch.  Both run as ONE thread-block cluster a segment, of
//    up to 8 CTAs (the portable size) or 16 where the card co-schedules
//    them (cluster_ctas_max), launched with cudaLaunchKernelEx and a
//    cluster-dimension attribute; the geometry (CTAs, threads a CTA) comes
//    from fused_class.cluster_geometry.  A thread takes the rows rank x
//    threads + thread + i x (CTAs x threads).  Each warp merges its lanes'
//    values with redux.sync steps (a lexicographic key field by field),
//    then the warps' values in warp 0, then the CTAs' values, which meet
//    in rank 0's shared memory (distributed shared memory and one cluster
//    barrier): no global atomic, no ticket, no fence and no scratch in
//    device memory, so nothing carries from one launch to the next.  The
//    patch index is staged into shared memory with cp.async while the
//    first row loads are in flight (at most kMaxPatchRows, which the
//    launchers check), and binary searches run there.
//  * K2 carries the winner's free masks as the key's payload, so rank 0's
//    warp 0 places it with no second fetch; with no candidate it places row
//    0, whose masks block 0's thread 0 read itself.  One cluster has at
//    most 16 SMs, so where most nodes pass the count screen the per-node
//    tiers set K2's time as N grows.  Above normal_cycle.SPLIT_NODES nodes
//    it runs split (normal_geometry): a grid of clusters (the rows
//    blockIdx x threads + thread + i x (blocks x threads)), each writing
//    its minimum and payload to a 16-byte record of a buffer the wrapper
//    allocates, then one warp (normal_merge_kernel, the next launch on the
//    stream) takes the least record and places it.  The records are all
//    written before they are read, in stream order: still no atomic, and
//    nothing carries from one call to the next.
//  * The tail is one pass: a thread reads its rows' 12 class fields (each
//    column coalesced), scores each (row, tier) entry once and folds it
//    into an exact monoid (TailState, below) that carries the max score,
//    the tiers at it, the count, and two tie keys; the tie chain's
//    same-tier test picks one of the two at the end.  Rank 0's warp 0 then
//    reads the winner's row (a lane a victim slot) and places it.
//  * Placement (place_core) runs on one warp (warp_place): a lane a scope
//    for the best-fit search, a lane a NUMA node for the lowest free bits.
//  * The tier of a subset (K1) is the lane kernels' tier_score, on the
//    request carried in FusedParams.t; that of a node (K2's screen) and of
//    a winner's freed masks (placement) is the same rule from the per-NUMA
//    counts that placement needs anyway (fused_tier), measured faster in
//    both kernels (PERF.md).
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

// The multiplier of the bundle division, ceil(2^32 / d) for d >= 1 (0
// without bundles): (cnt * m) >> 32 == cnt / d for every count a node's
// 32-bit mask holds (0..32) and every d >= 1.  A kernel computes it once a
// thread at its start, so no integer division sits on the per-node screen
// or on the placement's serial chain.
__device__ __forceinline__ unsigned long long bundle_magic(int d) {
  return d > 0 ? static_cast<unsigned long long>(0xffffffffu /
                                                 static_cast<unsigned>(d)) + 1
               : 0ull;
}

// Per NUMA node u: units[u] (GPUs that come with their CoreGroup bundle, the
// integer division of tier_score by `magic` = bundle_magic) and cnt_c[u]
// (free CoreGroups), 0 past num_numa.
__device__ __forceinline__ void numa_counts(unsigned g, unsigned c,
                                            const FusedParams& p,
                                            unsigned long long magic,
                                            int (&units)[kMaxNuma],
                                            int (&cnt_c)[kMaxNuma]) {
#pragma unroll
  for (int u = 0; u < kMaxNuma; ++u) {
    const bool in = u < p.t.num_numa;
    const int cg = in ? __popc(g & static_cast<unsigned>(p.t.numa_gpu[u])) : 0;
    cnt_c[u] = in ? __popc(c & static_cast<unsigned>(p.t.numa_cg[u])) : 0;
    const int q = static_cast<int>(
        (static_cast<unsigned long long>(cnt_c[u]) * magic) >> 32);
    units[u] = p.t.cgs_per_bundle > 0 ? min(cg, q) : cg;
  }
}

// The placement tier of a node's free masks g, c from their per-NUMA counts
// (numa_counts): tier_score's rule with the socket sums packed 8 bits a
// socket into one 64-bit word (a socket holds at most 32 GPUs and 32
// CoreGroups) in place of its per-socket arrays.  K2's per-node screen and
// warp_place (K2's and the tail's placement) take the tier from here.
// Built with -DFUSED_TIER_BY_TIER_SCORE it is tier_of(g, c) instead, the
// yardstick chip_smoke.py times it against on the same inputs.
__device__ __forceinline__ int fused_tier(unsigned g, unsigned c,
                                          const int (&units)[kMaxNuma],
                                          const int (&cnt_c)[kMaxNuma],
                                          const FusedParams& p) {
#ifdef FUSED_TIER_BY_TIER_SCORE
  return tier_of(g, c, p);
#else
  unsigned long long su = 0, sc = 0;
  int gu = 0, gc = 0;
  bool numa_ok = false;
#pragma unroll
  for (int u = 0; u < kMaxNuma; ++u) {
    if (u < p.t.num_numa) {
      numa_ok |= units[u] >= p.t.need_gpus && cnt_c[u] >= p.t.need_cgs;
      const int sh = 8 * p.t.socket_of_numa[u];
      su += static_cast<unsigned long long>(units[u]) << sh;
      sc += static_cast<unsigned long long>(cnt_c[u]) << sh;
      gu += units[u];
      gc += cnt_c[u];
    }
  }
  bool sock_ok = false;
#pragma unroll
  for (int s = 0; s < kMaxSockets; ++s) {
    if (s < p.t.num_sockets) {
      sock_ok |= static_cast<int>((su >> (8 * s)) & 255u) >= p.t.need_gpus &&
                 static_cast<int>((sc >> (8 * s)) & 255u) >= p.t.need_cgs;
    }
  }
  return numa_ok ? 0
                 : (sock_ok ? 1
                            : (gu >= p.t.need_gpus && gc >= p.t.need_cgs ? 2
                                                                         : 3));
#endif
}

// v[lane] for a register array: a select per element, no local memory.
__device__ __forceinline__ int pick(const int (&v)[kMaxNuma], int lane) {
  int out = 0;
#pragma unroll
  for (int u = 0; u < kMaxNuma; ++u)
    if (lane == u) out = v[u];
  return out;
}

// place_core (placement_jax) over one warp.  Every lane holds all the
// counts; lane sc judges scope sc, and one redux finds the best-fit scope
// (the least leftover units, then the lowest index).  The takes walk the
// scope's NUMA nodes in every lane, as the host's loop does; then lane u
// picks NUMA node u's lowest free bits, and an OR across the warp joins
// them.  The CoreGroup masks of the NUMA nodes are disjoint, so the second
// pass over the CoreGroups left free sees only its node's first-pass bits.
// Every lane must call it (full warp), and every collective in it runs in
// every lane (none sits behind a condition); the results are the same in
// all lanes.
__device__ __forceinline__ void warp_place(unsigned fg, unsigned fc,
                                           const FusedParams& p,
                                           unsigned long long magic, bool& ok,
                                           int& tier, unsigned& gm,
                                           unsigned& cm) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int units[kMaxNuma], cnt_c[kMaxNuma];
  numa_counts(fg, fc, p, magic, units, cnt_c);
  tier = fused_tier(fg, fc, units, cnt_c, p);
  int member = 0, stier = 3;
#pragma unroll
  for (int sc = 0; sc < kMaxScopes; ++sc) {
    if (lane == sc && sc < p.n_scopes) {
      member = p.scope_members[sc];
      stier = p.scope_tier[sc];
    }
  }
  int s_units = 0, s_cg = 0;
#pragma unroll
  for (int u = 0; u < kMaxNuma; ++u) {
    if ((member >> u) & 1) {
      s_units += units[u];
      s_cg += cnt_c[u];
    }
  }
  const bool fits = lane < p.n_scopes && s_units >= p.t.need_gpus &&
                    s_cg >= p.t.need_cgs && stier == tier;
  const int key = fits ? (s_units - p.t.need_gpus) * p.n_scopes + lane
                       : kIntMax;
  const int best = __reduce_min_sync(kAll, key);
  const unsigned at_best = __ballot_sync(kAll, fits && key == best);
  const bool any = best != kIntMax;
  const int scope = __shfl_sync(kAll, member, any ? __ffs(at_best) - 1 : 0);
  // GPUs, then CoreGroups with them; then the scope's CoreGroups still free
  int take[kMaxNuma], c_take[kMaxNuma], take2[kMaxNuma];
  int rem_g = p.t.need_gpus, rem_c = p.t.need_cgs;
#pragma unroll
  for (int u = 0; u < kMaxNuma; ++u) {
    const bool in = u < p.t.num_numa && ((scope >> u) & 1);
    take[u] = in ? min(rem_g, units[u]) : 0;
    rem_g -= take[u];
    c_take[u] = min(take[u] * p.t.cgs_per_bundle, rem_c);
    rem_c -= c_take[u];
  }
#pragma unroll
  for (int u = 0; u < kMaxNuma; ++u) {
    const bool in = u < p.t.num_numa && ((scope >> u) & 1);
    take2[u] = in ? min(cnt_c[u] - min(c_take[u], cnt_c[u]), rem_c) : 0;
    rem_c -= take2[u];
  }
  unsigned gmask = 0, cmask = 0;
#pragma unroll
  for (int u = 0; u < kMaxNuma; ++u) {
    if (lane == u && u < p.t.num_numa) {
      gmask = static_cast<unsigned>(p.t.numa_gpu[u]);
      cmask = static_cast<unsigned>(p.t.numa_cg[u]);
    }
  }
  const unsigned gbits = lowest_bits(fg & gmask, pick(take, lane), p.num_gpus);
  const unsigned cbits =
      lowest_bits(fc & cmask, pick(c_take, lane), p.num_cgs);
  const unsigned cbits2 =
      lowest_bits(fc & cmask & ~cbits, pick(take2, lane), p.num_cgs);
  gm = __reduce_or_sync(kAll, gbits);
  cm = __reduce_or_sync(kAll, cbits | cbits2);
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

// ---- thread-block clusters: the cross-CTA reductions of K2 and the tail ------

// A plan's patch index, staged from device memory into shared memory with
// cp.async, one 4-byte copy a thread in turn (coalesced); each thread waits
// for its own copies with stage_wait(), and a __syncthreads() after it makes
// them the CTA's.
__device__ __forceinline__ void stage_async(int* dst, const int* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src + i)
                 : "memory");
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The split cluster barrier (CUTLASS's cluster_arrive_relaxed / cluster_wait):
// every thread arrives at the kernel's start and waits before its CTA's first
// store into another CTA's shared memory, which proves that every CTA of the
// cluster has started (distributed shared memory exists only then).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Merges v over the cluster with warp_merge, which merges the 32 lanes'
// values of a warp and leaves the result in every lane: each warp, then the
// warps' values in warp 0, then (when ctas > 1) the CTAs' values, which
// each CTA's thread 0 stores into slot [rank] of rank 0's s_rank through
// distributed shared memory, one cluster barrier (release / acquire)
// before rank 0's warp 0 reads them.  Every thread of every CTA of the
// cluster calls it, after cluster_arrive_relaxed() at the kernel's start
// when ctas > 1.  Returns true in rank 0's warp 0, every lane of which
// then holds the cluster's value.  No global memory, no atomic, no fence.
template <typename T, typename WarpMerge>
__device__ __forceinline__ bool cluster_reduce(T& v, T* s_warp, T* s_rank,
                                               int ctas, const T& identity,
                                               WarpMerge warp_merge) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_merge(v);
  if (blockDim.x > 32) {
    if (lane == 0) s_warp[warp] = v;
    __syncthreads();
    if (warp == 0)
      v = warp_merge(lane < static_cast<int>(blockDim.x >> 5) ? s_warp[lane]
                                                              : identity);
  }
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  if (ctas > 1) {
    cluster_wait();
    if (threadIdx.x == 0) *cluster.map_shared_rank(s_rank + rank, 0) = v;
    cluster.sync();
  }
  if (rank != 0 || warp != 0) return false;
  if (ctas > 1) v = warp_merge(lane < ctas ? s_rank[lane] : identity);
  return true;
}

struct TieKey {  // (ppe asc, k asc, node id asc, umask desc, flat asc)
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

// ---- K1's tail: Eq. 2 argmax over class winners, then the placement --------

// 1 / x rounded to nearest is __frcp_rn(x): the same bits as
// __fdiv_rn(1.0f, x), the lane kernels' form.
__device__ __forceinline__ float eq1_score(int pp, int t, const FusedParams& p) {
  const float prio_term = pp > 0 ? __frcp_rn(__int2float_rn(max(pp, 1))) : 1.0f;
  const float tv = t == 0 ? 1.0f : (t == 1 ? 0.5f : 0.1f);
  return __fadd_rn(__fmul_rn(p.t.alpha, prio_term),
                   __fmul_rn(p.t.one_minus_alpha, tv));
}

// The tail's one-pass state, an exact monoid: merge_tail is associative, and
// each entry's flat index makes every tie key's order total, so no partition
// of the rows and no order of merging changes the result.
//   score        the max Eq. 1 score over the entries seen
//   tmin, tmax   the lowest and highest tier of the entries at that score
//   cnt          the sum of n_candidates (unsigned: wraps as the int32 sum)
//   a, b         the best entry at that score by (ppe, k, node id, -umask,
//                flat), with ppe = its priority sum (a) and ppe = 0 (b)
// The tie chain's priority-sum step applies only when every entry at the max
// score shares one tier and alpha > 0, which is known only at the end: then
// the winner is a, else b.
struct TailState {
  float score;
  int tmin;
  int tmax;
  unsigned cnt;
  TieKey a;
  TieKey b;
};

__device__ __forceinline__ TailState tail_identity() {
  const TieKey none = {kIntMax, kIntMax, kIntMax, -1, kIntMax};
  return {-CUDART_INF_F, 3, -1, 0u, none, none};
}

__device__ __forceinline__ void merge_tail(TailState& x, const TailState& y) {
  if (y.score > x.score) {
    x.score = y.score;
    x.tmin = y.tmin;
    x.tmax = y.tmax;
    x.a = y.a;
    x.b = y.b;
  } else if (y.score == x.score) {
    x.tmin = min(x.tmin, y.tmin);
    x.tmax = max(x.tmax, y.tmax);
    if (tie_better(y.a, x.a)) x.a = y.a;
    if (tie_better(y.b, x.b)) x.b = y.b;
  }
  x.cnt += y.cnt;
}

// A float's order as a signed int (-0 taken as +0; scores are never NaN).
// The map is its own inverse.
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(__fadd_rn(f, 0.0f));
  return i ^ ((i >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i ^ ((i >> 31) & 0x7fffffff));
}

// The least tie key over the lanes where c holds, field by field (one redux
// each); every lane gets it.
__device__ __forceinline__ TieKey warp_min_tie(const TieKey& k, bool c) {
  constexpr unsigned kAll = 0xffffffffu;
  TieKey m;
  m.ppe = __reduce_min_sync(kAll, c ? k.ppe : kIntMax);
  c = c && k.ppe == m.ppe;
  m.k = __reduce_min_sync(kAll, c ? k.k : kIntMax);
  c = c && k.k == m.k;
  m.nid = __reduce_min_sync(kAll, c ? k.nid : kIntMax);
  c = c && k.nid == m.nid;
  m.um = __reduce_max_sync(kAll, c ? k.um : -kIntMax - 1);
  c = c && k.um == m.um;
  m.flat = __reduce_min_sync(kAll, c ? k.flat : kIntMax);
  return m;
}

// merge_tail over the 32 lanes of a warp, in redux steps: the max score,
// then the tiers and tie keys of the lanes at it, and the count.
__device__ __forceinline__ TailState warp_merge_tail(const TailState& x) {
  constexpr unsigned kAll = 0xffffffffu;
  const int sk = ordered(x.score);
  const int top = __reduce_max_sync(kAll, sk);
  const bool at = sk == top;
  TailState y;
  y.score = unordered(top);
  y.tmin = __reduce_min_sync(kAll, at ? x.tmin : 3);
  y.tmax = __reduce_max_sync(kAll, at ? x.tmax : -1);
  y.cnt = __reduce_add_sync(kAll, x.cnt);
  y.a = warp_min_tie(x.a, at);
  y.b = warp_min_tie(x.b, at);
  return y;
}

// Folds one row's three (row, tier) entries into st: a row's 12 class
// fields are any[3], pp[3], um[3], k, cnt and node id.
__device__ __forceinline__ void fold_row(TailState& st, const int* f, int row,
                                         const FusedParams& p) {
  st.cnt += static_cast<unsigned>(f[10]);
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    if (!f[t]) continue;
    TailState e;
    e.score = eq1_score(f[3 + t], t, p);
    e.tmin = e.tmax = t;
    e.cnt = 0u;
    e.a = {f[3 + t], f[9], f[11], f[6 + t], row * 3 + t};
    e.b = {0, f[9], f[11], f[6 + t], row * 3 + t};
    merge_tail(st, e);
  }
}

__device__ __forceinline__ void load_row(int* f, const int* cls, int R,
                                         int r) {
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    f[t] = cls[(0 + t) * R + r];
    f[3 + t] = cls[(6 + t) * R + r];
    f[6 + t] = cls[(9 + t) * R + r];
  }
  f[9] = cls[12 * R + r];
  f[10] = cls[13 * R + r];
  f[11] = cls[14 * R + r];
}

// One cluster of `ctas` CTAs a segment of `seg` rows (grid = segments x
// ctas).  A thread a row, strided over the cluster, two rows' loads in
// flight at a time: it reads a row's 12 class fields (each column coalesced
// across the warp), scores each of the three (row, tier) entries once and
// folds them into its TailState.  The CTA and then the cluster merge the
// states; rank 0's warp 0 picks a or b, reads the winner's row (lane s its
// victim slot s) and places it (warp_place), with the patch index that rank
// 0 staged in shared memory while the pass ran.
__global__ void __launch_bounds__(kTailThreads)
    fused_argmax_kernel(State s, FusedParams p, const int* __restrict__ cls,
                        int R, int seg, int ctas, const int* __restrict__ skip,
                        int* __restrict__ out) {
  extern __shared__ int s_pidx[];
  __shared__ TailState s_warp[kTailThreads / 32];
  __shared__ TailState s_rank[kMaxClusterCtas];
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  int* o = out + (blockIdx.x / ctas) * kWinFields;
  if (skip != nullptr && *skip != 0) {  // the normal cycle placed
    if (rank == 0 && threadIdx.x < kWinFields) o[threadIdx.x] = 0;
    return;  // every CTA of the cluster, before any cluster barrier
  }
  if (ctas > 1) cluster_arrive_relaxed();
  if (rank == 0 && s.p > 0) stage_async(s_pidx, s.pidx, s.p);
  const unsigned long long magic = bundle_magic(p.t.cgs_per_bundle);
  const int r0 = (blockIdx.x / ctas) * seg;
  const int r1 = min(R, r0 + seg);
  const int stride = ctas * blockDim.x;
  TailState st = tail_identity();
  for (int r = r0 + rank * blockDim.x + threadIdx.x; r < r1; r += 2 * stride) {
    int f[12], g[12];
    const bool two = r + stride < r1;
    load_row(f, cls, R, r);
    if (two) load_row(g, cls, R, r + stride);
    fold_row(st, f, r - r0, p);
    if (two) fold_row(st, g, r + stride - r0, p);
  }
  if (rank == 0 && s.p > 0) {  // the finale's lanes read each other's copies
    stage_wait();
    __syncthreads();
  }
  if (!cluster_reduce(st, s_warp, s_rank, ctas, tail_identity(),
                      [](const TailState& x) { return warp_merge_tail(x); }))
    return;

  // rank 0's warp 0; every lane holds the segment's state
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x;
  const bool found = st.score > -CUDART_INF_F;  // some class is non-empty
  const TieKey tk = (st.tmin == st.tmax && p.alpha_pos) ? st.a : st.b;
  const int flat = found ? tk.flat : 0;  // no survivor: argmax -> 0
  const int row = flat / 3, t = flat % 3, r = r0 + row;
  State ls = s;
  ls.pidx = s_pidx;
  const int cb = cls[(3 + t) * R + r];
  const int pp = cls[(6 + t) * R + r];
  const int k = cls[12 * R + r];
  const Row w = fetch_row(ls, r);
  unsigned sg = 0, sc = 0;
  if (lane < s.cap) {
    sg = static_cast<unsigned>(w.slot(VF_GPU, lane));
    sc = static_cast<unsigned>(w.slot(VF_CG, lane));
  }
  const bool on = (static_cast<unsigned>(cb) >> lane) & 1u;
  const unsigned fg = static_cast<unsigned>(w.node(NS_FREE_GPU)) |
                      __reduce_or_sync(kAll, on ? sg : 0u);
  const unsigned fc = static_cast<unsigned>(w.node(NS_FREE_CG)) |
                      __reduce_or_sync(kAll, on ? sc : 0u);
  bool ok;
  int tier;
  unsigned gm, cm;
  warp_place(fg, fc, p, magic, ok, tier, gm, cm);
  if (lane == 0) {
    o[0] = found;
    o[1] = row;
    o[2] = t;
    o[3] = cb;
    o[4] = pp;
    o[5] = k;
    o[6] = static_cast<int>(st.cnt);
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

// A node's key with its row's free masks as payload (the keys are distinct,
// so the payload follows the minimum exactly).
struct NormalBest {
  unsigned long long key;
  unsigned fg;
  unsigned fc;
};

__device__ __forceinline__ void merge_normal(NormalBest& x,
                                             const NormalBest& y) {
  if (y.key < x.key) x = y;
}

// The least key over the 32 lanes of a warp (the high word, then the low
// word among the lanes at it, one redux each) with its lane's payload;
// every lane gets it.
__device__ __forceinline__ NormalBest warp_min_normal(const NormalBest& x) {
  constexpr unsigned kAll = 0xffffffffu;
  const unsigned hi = static_cast<unsigned>(x.key >> 32);
  const unsigned lo = static_cast<unsigned>(x.key);
  const unsigned m_hi = __reduce_min_sync(kAll, hi);
  const unsigned m_lo = __reduce_min_sync(kAll, hi == m_hi ? lo : ~0u);
  const int src =
      __ffs(__ballot_sync(kAll, hi == m_hi && lo == m_lo)) - 1;
  NormalBest y;
  y.key = (static_cast<unsigned long long>(m_hi) << 32) | m_lo;
  y.fg = __shfl_sync(kAll, x.fg, src);
  y.fc = __shfl_sync(kAll, x.fc, src);
  return y;
}

// The normal cycle's outcome from the least key, which every lane of the
// calling warp holds, and row 0's free masks and node id (the outcome when
// no node is a candidate: the argmin of an all-ones key is row 0), written
// to out[0..4].  Every lane of one warp calls it.
__device__ __forceinline__ void normal_place(const NormalBest& best,
                                             unsigned fg0, unsigned fc0,
                                             int nid0, int n,
                                             const FusedParams& p,
                                             unsigned long long magic,
                                             int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  if (n == 0) {
    if (lane < 5) out[lane] = 0;
    return;
  }
  const unsigned long long key = best.key;
  const bool found = key != kNoKey;
  const unsigned fg = found ? best.fg : fg0;
  const unsigned fc = found ? best.fc : fc0;
  bool p_ok;
  int p_tier;
  unsigned pg, pc;
  warp_place(fg, fc, p, magic, p_ok, p_tier, pg, pc);
  if (lane == 0) {
    const int nid =
        found ? static_cast<int>(static_cast<unsigned>(key >> kRowBits) ^
                                 0x80000000u)
              : nid0;
    const unsigned bg = lowest_bits(fg, p.t.need_gpus, p.num_gpus);
    const unsigned bc = lowest_bits(fc, p.t.need_cgs, p.num_cgs);
    const bool use_place = p_tier < 3 && p_ok;
    out[0] = found;
    out[1] = nid;
    out[2] = use_place ? p_tier : achieved_tier(bg, p);
    out[3] = static_cast<int>(use_place ? pg : bg);
    out[4] = static_cast<int>(use_place ? pc : bc);
  }
}

// Clusters of `ctas` CTAs over every node.  Every CTA stages the patch
// index into shared memory (cp.async, overlapped with its first batch of
// row loads); each thread takes the rows blockIdx * blockDim + thread + i *
// (gridDim * blockDim), kNormalBatch at a time with their loads issued
// together, resolves each row's patch by a binary search in shared memory,
// and folds the row's key and free masks.  The warps, the CTA and then the
// cluster (distributed shared memory) take the minimum.  With one cluster
// (`part` null), rank 0's warp 0 places the winner from its payload, or row
// 0 (whose masks block 0's thread 0 read itself) when no node is a
// candidate.  With more (the split form), rank 0's thread 0 of cluster c
// writes the cluster's minimum to part[c], and cluster 0 also row 0's masks
// and node id to part[clusters]; normal_merge_kernel, launched next on the
// stream, places from them.
__global__ void __launch_bounds__(kNormalThreads)
    normal_cycle_kernel(State s, FusedParams p, int ctas,
                        NormalBest* __restrict__ part, int* __restrict__ out) {
  extern __shared__ int s_pidx[];
  __shared__ NormalBest s_warp[kNormalThreads / 32];
  __shared__ NormalBest s_rank[kMaxClusterCtas];
  if (ctas > 1) cluster_arrive_relaxed();
  if (s.p > 0) stage_async(s_pidx, s.pidx, s.p);
  const unsigned long long magic = bundle_magic(p.t.cgs_per_bundle);
  State ls = s;
  ls.pidx = s_pidx;
  const int width = kNodeFields + kVictimFields * s.cap + 2;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int iters =
      max(1, (s.n + kNormalBatch * stride - 1) / (kNormalBatch * stride));
  NormalBest best = {kNoKey, 0u, 0u};
  unsigned fg0 = 0, fc0 = 0;  // row 0 (block 0, thread 0, the first batch)
  int nid0 = 0;
  for (int it = 0; it < iters; ++it) {  // the same count in every thread
    unsigned fg[kNormalBatch], fc[kNormalBatch];
    int nid[kNormalBatch];
#pragma unroll
    for (int j = 0; j < kNormalBatch; ++j) {
      const int r = first + (it * kNormalBatch + j) * stride;
      if (r < s.n) {
        fg[j] = static_cast<unsigned>(s.ns[NS_FREE_GPU * s.n + r]);
        fc[j] = static_cast<unsigned>(s.ns[NS_FREE_CG * s.n + r]);
        nid[j] = s.ns[NS_NODE_ID * s.n + r];
      }
    }
    if (it == 0 && s.p > 0) {
      stage_wait();
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kNormalBatch; ++j) {
      const int r = first + (it * kNormalBatch + j) * stride;
      if (r >= s.n) continue;
      if (s.p > 0) {
        const int k = find_patch(ls, r);
        if (k >= 0) {
          const int* b = s.pbuf + static_cast<long>(k) * width;
          fg[j] = static_cast<unsigned>(b[NS_FREE_GPU]);
          fc[j] = static_cast<unsigned>(b[NS_FREE_CG]);
          nid[j] = b[NS_NODE_ID];
        }
      }
      if (r == 0) {
        fg0 = fg[j];
        fc0 = fc[j];
        nid0 = nid[j];
      }
      const int cnt_g = __popc(fg[j]);
      // count screen; sentinel rows never win
      if (cnt_g >= p.t.need_gpus && __popc(fc[j]) >= p.t.need_cgs &&
          nid[j] < kIntMax) {
        int units[kMaxNuma], cnt_c[kMaxNuma];
        numa_counts(fg[j], fc[j], p, magic, units, cnt_c);
        const int tier = fused_tier(fg[j], fc[j], units, cnt_c, p);
        const int eff =
            tier < 3 ? tier
                     : achieved_tier(lowest_bits(fg[j], p.t.need_gpus,
                                                 p.num_gpus), p);
        merge_normal(best, {normal_key(eff, cnt_g - p.t.need_gpus, nid[j], r),
                            fg[j], fc[j]});
      }
    }
  }
  if (!cluster_reduce(best, s_warp, s_rank, ctas, NormalBest{kNoKey, 0u, 0u},
                      [](const NormalBest& x) { return warp_min_normal(x); }))
    return;

  // rank 0's warp 0: every lane holds the cluster's minimum; in cluster 0,
  // lane 0 holds row 0's masks
  if (part == nullptr) {
    constexpr unsigned kAll = 0xffffffffu;
    normal_place(best, __shfl_sync(kAll, fg0, 0), __shfl_sync(kAll, fc0, 0),
                 __shfl_sync(kAll, nid0, 0), s.n, p, magic, out);
    return;
  }
  if (threadIdx.x == 0) {
    const int c = blockIdx.x / ctas;
    part[c] = best;
    if (c == 0)
      part[gridDim.x / ctas] = {static_cast<unsigned>(nid0), fg0, fc0};
  }
}

// The split form's second launch, one warp: the least of the `clusters`
// minima in part[0..clusters-1], placed with row 0 from part[clusters].
__global__ void __launch_bounds__(32)
    normal_merge_kernel(const NormalBest* __restrict__ part, int clusters,
                        int n, FusedParams p, int* __restrict__ out) {
  NormalBest best = {kNoKey, 0u, 0u};
  for (int c = threadIdx.x; c < clusters; c += 32) merge_normal(best, part[c]);
  best = warp_min_normal(best);
  const NormalBest row0 = part[clusters];
  normal_place(best, row0.fg, row0.fc, static_cast<int>(row0.key), n, p,
               bundle_magic(p.t.cgs_per_bundle), out);
}

static inline int grid_for(int n) { return (n + kTile - 1) / kTile; }

// Sets the calling thread's device for one launch and puts the previous one
// back, so a launch goes to its tensors' card without the caller switching.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) {
    int cur = 0;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) {
      err = cudaSetDevice(device);
      prev = cur;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// A 1-D grid of `blocks` CTAs in thread-block clusters of `ctas`.
static cudaLaunchConfig_t cluster_config(int blocks, int ctas, int threads,
                                         size_t smem, cudaStream_t st,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The geometry the Python wrappers compute (fused_class.cluster_geometry)
// and the patch index's shared-memory budget, checked before a launch.
static bool bad_cluster(int ctas, int threads, int max_threads, int p) {
  return ctas < 1 || ctas > kMaxClusterCtas || threads < 32 ||
         threads > max_threads || threads % 32 != 0 || p < 0 ||
         p > kMaxPatchRows;
}

// The cluster kernels' opt-ins, set once a device: dynamic shared memory up
// to the patch index's budget (above the default 48 KB), and clusters above
// the portable 8 CTAs.  A card that refuses the second keeps clusters of 8
// (cluster_ctas_max), so its refusal is not an error here.
constexpr int kMaxDevices = 64;

static cudaError_t prepare_cluster_kernels(int device) {
  static bool done[kMaxDevices] = {};
  const bool known = device >= 0 && device < kMaxDevices;
  if (known && done[device]) return cudaSuccess;
  const int smem = kMaxPatchRows * static_cast<int>(sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      normal_cycle_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_argmax_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return err;
  cudaFuncSetAttribute(normal_cycle_kernel,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaFuncSetAttribute(fused_argmax_kernel,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaGetLastError();
  if (known) done[device] = true;
  return cudaSuccess;
}

// Whether the card co-schedules a cluster of kMaxClusterCtas CTAs of the
// kernel at its most threads and shared memory (after
// prepare_cluster_kernels).
template <typename Kernel>
static bool fits_max_cluster(Kernel kernel, int threads) {
  const size_t smem = kMaxPatchRows * sizeof(int);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      kMaxClusterCtas, kMaxClusterCtas, threads, smem, nullptr, &attr);
  int clusters = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err == cudaSuccess && clusters > 0;
}

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
                       const void* skip, void* cls, int device, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sk = static_cast<const int*>(skip);
  int* out = static_cast<int*>(cls);
  if (state->cap > kMaxCap || (wide == 0 && (m_res > 8 || m_gather > 8)) ||
      m_res > min(state->cap, kMaxDenseVictims) ||
      m_gather > min(state->cap, kMaxDenseVictims) || R <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
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

// One cluster of `ctas` CTAs of `threads` each a segment of `seg` rows.
int fused_argmax_launch(const State* state, const FusedParams* params,
                        const void* cls, int R, int seg, int ctas,
                        int threads, const void* skip, void* out, int device,
                        void* stream) {
  if (R <= 0 || seg <= 0 || bad_cluster(ctas, threads, kTailThreads, state->p))
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaError_t err = prepare_cluster_kernels(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(state->p) * sizeof(int);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config((R + seg - 1) / seg * ctas, ctas, threads, smem,
                     static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, fused_argmax_kernel, *state, *params,
                           static_cast<const int*>(cls), R, seg, ctas,
                           static_cast<const int*>(skip),
                           static_cast<int*>(out));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// `clusters` clusters of `ctas` CTAs of `threads` each over every node.
// With more than one cluster (the split form) `part` holds clusters + 1
// 16-byte records, which the first launch writes and normal_merge_kernel,
// the second, reads.
int normal_cycle_launch(const State* state, const FusedParams* params,
                        int clusters, int ctas, int threads, void* part,
                        void* out, int device, void* stream) {
  if (state->n < 0 || state->n > (1 << kRowBits) || clusters < 1 ||
      clusters > kMaxSplitClusters || (clusters > 1 && part == nullptr) ||
      bad_cluster(ctas, threads, kNormalThreads, state->p))
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaError_t err = prepare_cluster_kernels(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(state->p) * sizeof(int);
  NormalBest* pb = clusters > 1 ? static_cast<NormalBest*>(part) : nullptr;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(clusters * ctas, ctas, threads, smem, st, &attr);
  err = cudaLaunchKernelEx(&cfg, normal_cycle_kernel, *state, *params, ctas,
                           pb, static_cast<int*>(out));
  if (err == cudaSuccess && pb != nullptr)
    normal_merge_kernel<<<1, 32, 0, st>>>(pb, clusters, state->n, *params,
                                          static_cast<int*>(out));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// The most CTAs a cluster of K2's normal-cycle form and of K1's tail may
// take on `device`: kMaxClusterCtas (16, non-portable) where
// cudaOccupancyMaxActiveClusters finds room for such a cluster of each at
// its most threads and shared memory, else the portable kClusterCtas (8).
int cluster_ctas_max(int device) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess || prepare_cluster_kernels(device) != cudaSuccess)
    return kClusterCtas;
  const bool big = fits_max_cluster(normal_cycle_kernel, kNormalThreads) &&
                   fits_max_cluster(fused_argmax_kernel, kTailThreads);
  cudaGetLastError();  // a refused query leaves no error behind
  return big ? kMaxClusterCtas : kClusterCtas;
}

const char* topo_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
