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
// The counterpart of the reference's _tier_score is one rule in every
// kernel: the lane's per-NUMA counts packed a byte a NUMA node (numa_words)
// and the tier from those whole words (fused_tier), with no integer
// division.  The reference's rule written out (tier_score) exists only in
// the yardstick build, -DFUSED_TIER_BY_TIER_SCORE.
//
// One lane is one victim subset (or, for placement_tier, one node): its
// freed-GPU and freed-CoreGroup int32 bitmasks.  Per NUMA node the kernel
// counts popc(mask & numa_mask), forms bundle units, and derives the tier
// (0 = one NUMA, 1 = one socket, 2 = cross-socket, 3 = infeasible) and the
// Eq. 1 score.
//
// Layout of K2 and K3: one lane a thread in blocks of kLaneThreads (n
// rounded up to a warp below one block) while one grid of kLaneBlocksPerSm
// blocks an SM covers the lanes (every size a plan or chip_smoke.py's
// tile shapes give them); above it, where every pointer is 16-byte aligned,
// that grid strides over the lanes four a thread a step, as 16-byte
// vectors (lane_geometry).  The ragged edge is masked here, not padded by
// the caller.  K1 takes one lane a thread, a block a tile (n rounded up to
// a warp when n < 1024), and reduces the tile by redux.sync steps (one key
// field a step) in each warp and then in one warp.
//
// Bound: bytes on paper.  K3 moves 20 B a lane (three int32 in, int32 tier
// and f32 score out), K2 12 B (two in, one out), K1 28 B, each for about a
// hundred integer operations, so each lane is read once and written once,
// and K1 does its per-tile argmax in registers and shared memory instead of
// a second pass.  At a few tiles the launch and one thread's chain of
// dependent steps set the time, so a thread takes one lane: no division,
// no serial loop.  At millions of lanes the integer pipes come close to
// the bytes (16 popcounts a lane at 16 a clock an SM, and the tier's word
// arithmetic at 64 a clock), so the tier rule is one pass over 32-bit
// halves with no branch a lane, a thread builds the request's rule
// (tier_rule) once for all its lanes, and four lanes a step give each
// thread independent work and one load an input (PERF.md, section 6).
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
//  * Padding.  In K1 lanes past n read as mask 0, prio 0, k = K_INFEASIBLE
//    and ok = 0.  A zero-need request makes a zero-mask lane feasible, so
//    it is the ok = 0 of a pad lane that keeps it out of the argmax.  In K2
//    and K3 they are neither read nor written.
//  * The reference's cnt_cg // cgs_per_bundle, taken only when
//    cgs_per_bundle > 0, is a multiply by bundle_magic here, exact for
//    every count a 32-bit mask holds (0 above 32, where every count is
//    below the divisor).
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
constexpr int kTile = 8 * 128;       // K1's block: the reference's tile
constexpr int kLaneThreads = 256;    // K2's and K3's block
constexpr int kLaneBlocksPerSm = 8;  // K2's and K3's grid: at most 8 an SM
constexpr int kInfeasible = 1 << 30;                // K_INFEASIBLE

constexpr int kMaxScopes = kMaxNuma + kMaxSockets + 1;
constexpr int kMaxCap = 32;         // one warp loads a row's slots
constexpr int kMaxDenseVictims = 16;
constexpr int kIntMax = 0x7fffffff;
constexpr int kNodeFields = 5;
constexpr int kVictimFields = 5;
constexpr int kWinFields = 9;
constexpr int kNarrowThreads = 256; // K1's sweep, m <= 8: most threads a CTA
constexpr int kWideThreads = 512;   // K1's sweep, m <= 16: one row a CTA
constexpr int kNarrowTable = 8;     // low folds of a row a warp sweeps (2^(8 - 5))
constexpr int kWideTable = 128;     // low folds of the wide row (2^(16 - 9))
constexpr int kSharedSweepCtas = 5; // K1's sweep with rows sharing warps:
                                    // CTAs an SM holds (48 registers)
constexpr int kTailThreads = 512;     // K1's tail: most threads a CTA
constexpr int kNormalThreads = 1024;  // K2 normal cycle: most threads a CTA
constexpr int kNormalBatch = 4;       // K2: rows a thread loads together
constexpr int kClusterCtas = 8;       // the portable thread-block cluster
constexpr int kMaxClusterCtas = 16;   // the largest (non-portable) one
constexpr int kMaxPatchRows = 16384;  // the patch index in shared memory
constexpr int kMaxSplitClusters = 1024; // K2's split form: partial minima
constexpr int kMaxDevices = 64;       // devices whose launch facts are kept

enum { NS_FREE_GPU, NS_FREE_CG, NS_NODE_ID, NS_OVERFLOW, NS_NEXT_PRIO };
enum { VF_GPU, VF_CG, VF_PRIO, VF_RANK, VF_STORED };

}  // namespace

// Mirrored by ctypes.Structure _Params in repro_torch/kernels/topo_score.py,
// which leaves numa_gpu and numa_cg 0 past num_numa (numa_words relies on
// it, as does numa_counts).
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

// The Eq. 1 score of a lane of tier `tier` and priority sum `prio`, with
// explicit rounding at every step (trap 1); -inf at tier 3.
__device__ __forceinline__ float lane_score(int tier, int prio,
                                            const TopoParams& p) {
  const float topo = tier == 0 ? 1.0f : (tier == 1 ? 0.5f : (tier == 2 ? 0.1f : 0.0f));
  const float prio_term =
      prio > 0 ? __fdiv_rn(1.0f, __int2float_rn(max(prio, 1))) : 1.0f;
  const float s = __fadd_rn(__fmul_rn(p.alpha, prio_term),
                            __fmul_rn(p.one_minus_alpha, topo));
  return tier < 3 ? s : -CUDART_INF_F;
}

#ifdef FUSED_TIER_BY_TIER_SCORE
// The reference's _tier_score written out: per NUMA node two popcounts, an
// integer division for the bundle units, and a socket's sums in registers.
// Only the yardstick build has it (through tier_of, in fused_tier).
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
      // integer division, and only for a bundled request
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
  score = lane_score(tier, prio, p);
}

// The placement tier of freed masks by tier_score, whose unused score the
// compiler drops: the rule the yardstick build times fused_tier against.
__device__ __forceinline__ int tier_of(unsigned g, unsigned c,
                                       const TopoParams& p) {
  int tier;
  float unused;
  tier_score(static_cast<int>(g), static_cast<int>(c), 0, p, tier, unused);
  return tier;
}
#endif  // FUSED_TIER_BY_TIER_SCORE

// ceil(2^32 / d) for the bundle sizes d = 1..32, and 0 at d = 0 (index 0,
// no bundle): (cnt * m) >> 32 == cnt / d for every count a node's 32-bit
// mask holds (0..32).  Above 32 every such count is below d, so quotient
// and multiplier are 0.  A table in constant memory keeps every integer
// division out of the kernels (chip_smoke.py reads their SASS); each entry
// is 0xffffffffu / d + 1.
__constant__ unsigned long long kBundleMagic[33] = {
    0x0,       0x100000000, 0x80000000, 0x55555556, 0x40000000,
    0x33333334, 0x2aaaaaab, 0x24924925, 0x20000000, 0x1c71c71d,
    0x1999999a, 0x1745d175, 0x15555556, 0x13b13b14, 0x12492493,
    0x11111112, 0x10000000, 0xf0f0f10,  0xe38e38f,  0xd79435f,
    0xccccccd,  0xc30c30d,  0xba2e8bb,  0xb21642d,  0xaaaaaab,
    0xa3d70a4,  0x9d89d8a,  0x97b425f,  0x924924a,  0x8d3dcb1,
    0x8888889,  0x8421085,  0x8000000};

// The multiplier of the bundle division (0 without bundles).  A kernel
// reads it once a thread at its start.
__device__ __forceinline__ unsigned long long bundle_magic(int d) {
  return d > 0 && d <= 32 ? kBundleMagic[d] : 0ull;
}

// Bundle units of one NUMA node: the GPUs that come with their CoreGroup
// bundle (the reference's integer division, by the multiplier `magic`).
__device__ __forceinline__ int bundle_units(int cnt_g, int cnt_c,
                                            const TopoParams& p,
                                            unsigned long long magic) {
  const int q = static_cast<int>(
      (static_cast<unsigned long long>(cnt_c) * magic) >> 32);
  return p.cgs_per_bundle > 0 ? min(cnt_g, q) : cnt_g;
}

// Per NUMA node u: units[u] and cnt_c[u] (free CoreGroups) of masks g, c,
// 0 past num_numa, and the counts packed as numa_words packs them.
__device__ __forceinline__ void numa_counts(unsigned g, unsigned c,
                                            const TopoParams& p,
                                            unsigned long long magic,
                                            int (&units)[kMaxNuma],
                                            int (&cnt_c)[kMaxNuma],
                                            unsigned long long& wg,
                                            unsigned long long& wc) {
  wg = wc = 0ull;
#pragma unroll
  for (int u = 0; u < kMaxNuma; ++u) {
    const int cg = __popc(g & static_cast<unsigned>(p.numa_gpu[u]));
    cnt_c[u] = __popc(c & static_cast<unsigned>(p.numa_cg[u]));
    units[u] = bundle_units(cg, cnt_c[u], p, magic);
    wg |= static_cast<unsigned long long>(cg) << (8 * u);
    wc |= static_cast<unsigned long long>(cnt_c[u]) << (8 * u);
  }
}

// The per-NUMA GPU and CoreGroup counts of masks g, c packed 8 bits a NUMA
// node into one 64-bit word each (a count is at most 32).  Counts of
// disjoint masks add, so the words of a union are the sums of the words.
// No branch: a NUMA node past num_numa has empty masks (TopoParams), so
// its count is 0.
__device__ __forceinline__ void numa_words(unsigned g, unsigned c,
                                           const TopoParams& p,
                                           unsigned long long& wg,
                                           unsigned long long& wc) {
  unsigned half_g[2] = {0u, 0u}, half_c[2] = {0u, 0u};
#pragma unroll
  for (int u = 0; u < kMaxNuma; ++u) {
    const int shift = 8 * (u & 3);
    half_g[u >> 2] |=
        static_cast<unsigned>(__popc(g & static_cast<unsigned>(p.numa_gpu[u])))
        << shift;
    half_c[u >> 2] |=
        static_cast<unsigned>(__popc(c & static_cast<unsigned>(p.numa_cg[u])))
        << shift;
  }
  wg = static_cast<unsigned long long>(half_g[1]) << 32 | half_g[0];
  wc = static_cast<unsigned long long>(half_c[1]) << 32 | half_c[0];
}

// The constants of the tier rule for one request and SKU (tier_rule), read
// by fused_tier as whole 64-bit words, one byte a NUMA node.  NUMA node u
// lies in socket u / k for k the NUMA nodes of a socket (ServerSpec's
// socket_of_numa, which the host checks).
struct TierRule {
  unsigned long long numa;      // 0x80 in the bytes of NUMA nodes < num_numa
  unsigned long long sock_end;  // 0x80 in the last byte of each socket
  unsigned long long spread;    // sum of 2^(8i), i < k: byte b of x * spread
                                // is the sum of bytes b - k + 1 .. b of x
  unsigned long long need_g;    // max(need_gpus, 0) in every byte
  unsigned long long need_c;    // max(need_cgs, 0) in every byte
  unsigned long long m16;       // ceil(2^10 / cgs_per_bundle), 0 above 32
  unsigned long long magic;     // bundle_magic(cgs_per_bundle)
  int ng, nc;
  bool bundle;                  // cgs_per_bundle > 0
  bool never;                   // a need above 32: no 32-bit mask meets it
};

__device__ __forceinline__ TierRule tier_rule(const TopoParams& p,
                                              unsigned long long magic) {
  constexpr unsigned long long kOnes = 0x0101010101010101ull;
  TierRule r;
  int k = 0;  // the NUMA nodes of socket 0
#pragma unroll
  for (int u = 0; u < kMaxNuma; ++u)
    k += u < p.num_numa && p.socket_of_numa[u] == 0;
  k = max(k, 1);
  r.numa = 0ull;
  r.sock_end = 0ull;
  r.spread = 0ull;
#pragma unroll
  for (int u = 0; u < kMaxNuma; ++u) {
    if (u < p.num_numa) r.numa |= 0x80ull << (8 * u);
    if (u < k) r.spread |= 1ull << (8 * u);
  }
#pragma unroll
  for (int s = 0; s < kMaxSockets; ++s) {
    const int last = (s + 1) * k - 1;
    if (s < p.num_sockets && last < kMaxNuma) r.sock_end |= 0x80ull << (8 * last);
  }
  r.ng = p.need_gpus;
  r.nc = p.need_cgs;
  r.never = p.need_gpus > 32 || p.need_cgs > 32;
  r.need_g = static_cast<unsigned long long>(max(p.need_gpus, 0) & 127) * kOnes;
  r.need_c = static_cast<unsigned long long>(max(p.need_cgs, 0) & 127) * kOnes;
  r.bundle = p.cgs_per_bundle > 0;
  // ceil(ceil(2^32 / d) / 2^22) == ceil(2^10 / d): no division
  r.m16 = (magic + (1ull << 22) - 1ull) >> 22;
  r.magic = magic;
  return r;
}

// The bytes of x that are >= the same byte of n (bytes below 128): 0x80 in
// each such byte.  No byte borrows from the next, so the two 32-bit halves
// of a word are independent.
__device__ __forceinline__ unsigned bytes_ge(unsigned x, unsigned n) {
  constexpr unsigned kHigh = 0x80808080u;
  return ((x | kHigh) - n) & kHigh;
}

__device__ __forceinline__ unsigned long long bytes_ge(unsigned long long x,
                                                       unsigned long long n) {
  return static_cast<unsigned long long>(
             bytes_ge(static_cast<unsigned>(x >> 32),
                      static_cast<unsigned>(n >> 32)))
             << 32 |
         bytes_ge(static_cast<unsigned>(x), static_cast<unsigned>(n));
}

// The sum of the bytes of x (at most 32 for the counts of one node's
// masks), two byte dot products.
__device__ __forceinline__ int byte_sum(unsigned long long x) {
  return static_cast<int>(
      __dp4a(static_cast<unsigned>(x), 0x01010101u,
             __dp4a(static_cast<unsigned>(x >> 32), 0x01010101u, 0u)));
}

// Per byte of four packed counts, the bundle units min(g, c /
// cgs_per_bundle): the division (c * m16) >> 10 in 16-bit lanes (a product
// is at most 32 * 1024, so no lane carries into the next).
__device__ __forceinline__ unsigned bundle_bytes(unsigned g, unsigned c,
                                                 unsigned m16) {
  constexpr unsigned kLow16 = 0x00ff00ffu;
  constexpr unsigned kQuot = 0x003f003fu;
  const unsigned q = ((((c & kLow16) * m16) >> 10) & kQuot) |
                     (((((c >> 8) & kLow16) * m16) >> 10) & kQuot) << 8;
  const unsigned keep_q = (bytes_ge(g, q) >> 7) * 0xffu;  // where g >= q
  return (q & keep_q) | (g & ~keep_q);
}

// The placement tier of masks g, c from their per-NUMA counts packed 8 bits
// a NUMA node (numa_words, or sums of them for disjoint masks): the
// reference's _tier_score rule on whole words.  Per NUMA node the bundle
// units are min(GPUs, CoreGroups / cgs_per_bundle), the division a
// multiply in 16-bit lanes (exact for counts up to 32); one NUMA node, one
// socket (the sums of k adjacent bytes, one multiply) or the node (all
// bytes) must hold need_gpus units and need_cgs CoreGroups.  The three
// tests are all taken and the tier selected, with no branch a lane.  Every
// kernel of this file takes the tier from here (the lane forms through
// lane_tier).  Built with -DFUSED_TIER_BY_TIER_SCORE it is tier_of(g, c)
// instead, the yardstick chip_smoke.py times it against on the same inputs.
__device__ __forceinline__ int fused_tier(unsigned g, unsigned c,
                                          unsigned long long wg,
                                          unsigned long long wc,
                                          const TierRule& r,
                                          const TopoParams& p) {
#ifdef FUSED_TIER_BY_TIER_SCORE
  return tier_of(g, c, p);
#else
  unsigned long long wu = wg;  // bundle units a NUMA node
  if (r.bundle) {
    const unsigned m16 = static_cast<unsigned>(r.m16);
    wu = static_cast<unsigned long long>(
             bundle_bytes(static_cast<unsigned>(wg >> 32),
                          static_cast<unsigned>(wc >> 32), m16))
             << 32 |
         bundle_bytes(static_cast<unsigned>(wg), static_cast<unsigned>(wc),
                      m16);
  }
  const bool numa_ok =
      (bytes_ge(wu, r.need_g) & bytes_ge(wc, r.need_c) & r.numa) != 0ull;
  const bool sock_ok = (bytes_ge(wu * r.spread, r.need_g) &
                        bytes_ge(wc * r.spread, r.need_c) & r.sock_end) != 0;
  const bool node_ok = (byte_sum(wu) >= r.ng) & (byte_sum(wc) >= r.nc);
  const int tier = numa_ok ? 0 : (sock_ok ? 1 : (node_ok ? 2 : 3));
  return r.never ? 3 : tier;
#endif
}

// The tier of one lane's masks on the request of `r`: its per-NUMA counts
// (numa_words) on the word-wise rule (fused_tier).
__device__ __forceinline__ int lane_tier(unsigned g, unsigned c,
                                         const TierRule& r,
                                         const TopoParams& p) {
  unsigned long long wg, wc;
  numa_words(g, c, p, wg, wc);
  return fused_tier(g, c, wg, wc, r, p);
}

// The tiers of four lanes (one 16-byte vector of each input).
__device__ __forceinline__ int4 lane_tier4(int4 g, int4 c, const TierRule& r,
                                           const TopoParams& p) {
  return make_int4(lane_tier(g.x, c.x, r, p), lane_tier(g.y, c.y, r, p),
                   lane_tier(g.z, c.z, r, p), lane_tier(g.w, c.w, r, p));
}

// K3, replacing topo_score_pallas (repro/kernels/topo_score.py:178): per
// lane its tier (lane_tier) and Eq. 1 score (lane_score).  With kVec
// (every pointer 16-byte aligned, n above one grid of lane_geometry) a
// thread takes four consecutive lanes a step as 16-byte vectors and
// strides over the grid, then the last n % 4 lanes one a thread; without,
// one lane a thread (striding only where unaligned inputs exceed the
// grid).  A thread builds the request's rule once for all its lanes.
// Lanes past n are neither read nor written.  The launch sets its time at
// a few tiles; at millions of lanes its bound is the bytes (20 B a lane),
// of which the tier's integer work leaves it about two thirds.
template <bool kVec>
__global__ void __launch_bounds__(kLaneThreads)
    topo_score_kernel(const int* __restrict__ gmask,
                      const int* __restrict__ cmask,
                      const int* __restrict__ prio, int* __restrict__ tier_out,
                      float* __restrict__ score_out, int n, TopoParams p) {
  const TierRule rule = tier_rule(p, bundle_magic(p.cgs_per_bundle));
  const int stride = gridDim.x * blockDim.x;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (kVec) {
#pragma unroll 1
    for (int v = i; v < n >> 2; v += stride) {
      const int4 tier =
          lane_tier4(reinterpret_cast<const int4*>(gmask)[v],
                     reinterpret_cast<const int4*>(cmask)[v], rule, p);
      const int4 pr = reinterpret_cast<const int4*>(prio)[v];
      reinterpret_cast<int4*>(tier_out)[v] = tier;
      reinterpret_cast<float4*>(score_out)[v] = make_float4(
          lane_score(tier.x, pr.x, p), lane_score(tier.y, pr.y, p),
          lane_score(tier.z, pr.z, p), lane_score(tier.w, pr.w, p));
    }
    i += n & ~3;
  }
#pragma unroll 1
  for (; i < n; i += stride) {
    const int tier = lane_tier(static_cast<unsigned>(gmask[i]),
                               static_cast<unsigned>(cmask[i]), rule, p);
    tier_out[i] = tier;
    score_out[i] = lane_score(tier, prio[i], p);
  }
}

// K2's lane form, replacing placement_tier_pallas
// (repro/kernels/topo_score.py:285): per node its placement tier
// (lane_tier), in K3's layouts.  Its bytes bound (12 B a node) is half
// the time the tier's integer work takes at millions of nodes.
template <bool kVec>
__global__ void __launch_bounds__(kLaneThreads)
    placement_tier_kernel(const int* __restrict__ free_gpu,
                          const int* __restrict__ free_cg,
                          int* __restrict__ tier_out, int n, TopoParams p) {
  const TierRule rule = tier_rule(p, bundle_magic(p.cgs_per_bundle));
  const int stride = gridDim.x * blockDim.x;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (kVec) {
#pragma unroll 1
    for (int v = i; v < n >> 2; v += stride)
      reinterpret_cast<int4*>(tier_out)[v] =
          lane_tier4(reinterpret_cast<const int4*>(free_gpu)[v],
                     reinterpret_cast<const int4*>(free_cg)[v], rule, p);
    i += n & ~3;
  }
#pragma unroll 1
  for (; i < n; i += stride)
    tier_out[i] = lane_tier(static_cast<unsigned>(free_gpu[i]),
                            static_cast<unsigned>(free_cg[i]), rule, p);
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

// K1's argmax key of one lane (the score as ordered()).
struct LaneKey {
  int k;
  int tier;
  int score;
  int idx;
};

// The least key over the lanes of the calling warp where `cand` holds:
// the smallest k, then the lowest tier, the highest score and the lowest
// index among the lanes that survive each step, one redux.sync a field.
// Every lane gets it.  With no candidate it is (K_INFEASIBLE, 3, -inf,
// K_INFEASIBLE), the sentinels of a tile with no feasible lane (trap 2).
__device__ __forceinline__ LaneKey warp_min_lane(bool cand, const LaneKey& x) {
  constexpr unsigned kAll = 0xffffffffu;
  LaneKey b;
  b.k = __reduce_min_sync(kAll, cand ? x.k : kInfeasible);
  cand = cand && x.k == b.k;
  b.tier = __reduce_min_sync(kAll, cand ? x.tier : 3);
  cand = cand && x.tier == b.tier;
  b.score = __reduce_max_sync(kAll, cand ? x.score : ordered(-CUDART_INF_F));
  cand = cand && x.score == b.score;
  b.idx = __reduce_min_sync(kAll, cand ? x.idx : kInfeasible);
  return b;
}

// One block a tile of kTile lanes, one lane a thread (blockDim = n rounded
// up to a warp when n < kTile).  A lane's tier comes from lane_tier, its
// score from lane_score.  Feasible lanes (tier < 3, k <= K_INFEASIBLE)
// compete in warp_min_lane; warp 0 merges the warps' keys the same way and
// thread 0 writes the tile's.
__global__ void __launch_bounds__(kTile)
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
                             int* __restrict__ bidx_out, int n,
                             TopoParams p) {
  __shared__ LaneKey warp_best[kTile / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool in = i < n;  // lanes past n: mask 0, k = K_INFEASIBLE, ok 0
  const unsigned g = in ? static_cast<unsigned>(gmask[i]) : 0u;
  const unsigned c = in ? static_cast<unsigned>(cmask[i]) : 0u;
  const int pr = in ? prio[i] : 0;
  const int k = in ? kk[i] : kInfeasible;
  const int ok = in ? okm[i] : 0;
  const TierRule rule = tier_rule(p, bundle_magic(p.cgs_per_bundle));
  int tier = lane_tier(g, c, rule, p);
  float score = lane_score(tier, pr, p);
  if (ok == 0) {  // filtering mask: masked lanes never win
    tier = 3;
    score = -CUDART_INF_F;
  }
  if (in) {
    tier_out[i] = tier;
    score_out[i] = score;
  }
  LaneKey best = warp_min_lane(tier < 3 && k <= kInfeasible,
                               {k, tier, ordered(score),
                                static_cast<int>(threadIdx.x)});
  if (blockDim.x > 32) {
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();
    if (warp != 0) return;
    const LaneKey none = {kInfeasible, 3, ordered(-CUDART_INF_F), kInfeasible};
    const LaneKey w =
        lane < static_cast<int>(blockDim.x >> 5) ? warp_best[lane] : none;
    best = warp_min_lane(w.tier < 3, w);
  }
  if (threadIdx.x == 0) {
    kmin_out[blockIdx.x] = best.k;
    btier_out[blockIdx.x] = best.tier;
    bscore_out[blockIdx.x] = unordered(best.score);
    bidx_out[blockIdx.x] = blockIdx.x * kTile + best.idx;
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
//  * K1's sweep is issue-bound.  A row takes a group of G threads: 32 (a
//    warp a row) in small plans, 16 (two rows a warp) in large ones, where
//    each warp then picks its mode from the rows it loaded; a CTA of 512
//    at m > 8.  The wrapper chooses the geometry from m and the rows
//    (fused_class.sweep_geometry) so that small plans spread over the SMs.
//    Only the 2^e subsets of a row's e eligible slots are enumerated, by a
//    dense index whose high bits are fixed per thread and whose low bits
//    index a table of partial folds built once a row in shared memory; a
//    fold is adds (one node's masks are disjoint), the per-NUMA counts ride
//    in two packed 64-bit words, and the tier is fused_tier's on whole
//    words, so the per-subset path has no loop over set bits and no
//    division.  Where each thread holds one subset (most rows) the merge is
//    ballots and shuffles within the group; else kmin, the count and the
//    three class keys merge field by field with redux.sync.  All keys are
//    integers and the combo ids distinct, so no order of reduction can
//    change the result.
//  * K1's bound: bytes are rows x (5 + 5 cap + 2) x 4 B in, 15 x 4 B a row
//    out (356 KB at 1024 nodes, cap 16: 0.11 us at 3.35 TB/s); operations
//    are the subsets the data makes eligible times the integer work of one
//    (chip_smoke.py computes both per run).  At 1024 nodes and m = 8 the
//    launch and a row's chain of dependent steps, not the work, set the
//    time.
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
//  * One tier rule, fused_tier, from per-NUMA counts, on the request
//    carried in FusedParams.t: of a subset (K1's sweep, from packed
//    counts), of a node (K2's screen) and of a winner's freed masks
//    (placement).  It was measured faster than tier_score in each
//    (PERF.md); chip_smoke.py times every fused kernel against a
//    tier_score build (-DFUSED_TIER_BY_TIER_SCORE).
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
//  * K1 adds the per-NUMA counts of a subset's slots to those of the free
//    masks: exact because one node's free and victim masks are pairwise
//    disjoint, as the reference's sum (and the port's OR) also need.
//  * K1's reported combo id is over all m slots (lowest id breaks ties),
//    not the dense index over the eligible ones.
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

// Row `r` of the plan as node `node` (the resident row r, or gidx's entry
// for a gathered row), read from patch row j when j >= 0.
__device__ __forceinline__ Row row_of(const State& s, int node, int j,
                                      bool gathered) {
  Row row;
  row.gathered = gathered;
  row.gidx_value = node;
  row.zero = node < 0 || node >= s.n;
  if (row.zero) {
    row.ns = row.v = row.dr = nullptr;
    row.ns_stride = row.v_stride = row.dr_stride = 0;
  } else if (j >= 0) {
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

__device__ __forceinline__ Row fetch_row(const State& s, int r) {
  const bool gathered = r >= s.n_res;
  const int node = gathered ? s.gidx[r - s.n_res] : r;
  const bool zero = node < 0 || node >= s.n;
  return row_of(s, node, !zero && s.p > 0 ? find_patch(s, node) : -1,
                gathered);
}

// ---- placement bit math (placement_jax: tier_from_counts_dyn, place_core,
// ---- place_blind_core, achieved_tier_dev) ---------------------------------

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
                                           const TierRule& rule, bool& ok,
                                           int& tier, unsigned& gm,
                                           unsigned& cm) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int units[kMaxNuma], cnt_c[kMaxNuma];
  unsigned long long wg, wc;
  numa_counts(fg, fc, p.t, rule.magic, units, cnt_c, wg, wc);
  tier = fused_tier(fg, fc, wg, wc, rule, p.t);
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

// One victim subset's fold, or a part of one (a slot, a low-fold table
// entry, the free or the drained masks): the OR of its GPU and CoreGroup
// masks, its priority sum and uid-rank sum (unsigned adds: int32 wrap), its
// combo id over the row's m slots, and its per-NUMA GPU and CoreGroup
// counts packed 8 bits a NUMA node (numa_words).  One node's masks are
// pairwise disjoint (the reference's sum relies on it), so the counts of a
// union are the sums of the counts and a fold is adds.  The tier comes from
// the counts; the masks feed only the yardstick build's tier_of.
struct Fold {
  unsigned g, c, pr, u, id, pad;
  unsigned long long wg, wc;
};

__device__ __forceinline__ Fold fold(Fold a, const Fold& b) {
  a.g |= b.g;
  a.c |= b.c;
  a.pr += b.pr;
  a.u += b.u;
  a.id |= b.id;
  a.wg += b.wg;
  a.wc += b.wc;
  return a;
}

__device__ __forceinline__ int fold_tier(const Fold& f, const TierRule& r,
                                         const TopoParams& p) {
  return fused_tier(f.g, f.c, f.wg, f.wc, r, p);
}

// What the sweep keeps of one row in shared memory.
struct SweepRow {
  Fold rec[kMaxDenseVictims];  // the eligible slots among the first m, in
                               // slot order (dense index i: the i-th)
  Fold base;                   // the free masks (priority, rank, id 0)
  Fold drain;                  // the fully drained masks (Filtering)
  unsigned valid;              // the eligible slots among the first m
  int ok;                      // node id and narrow gate passed
  int node_id;
  int pad;
};

// (p_eff asc, umask desc, id asc): the order inside one (row, tier) class
// at the row's smallest k, with the winner's priority sum beside it.
struct ClassKey {
  int p;
  int u;
  int id;
  unsigned pp;
};

__device__ __forceinline__ bool class_better(const ClassKey& a,
                                             const ClassKey& b) {
  if (a.p != b.p) return a.p < b.p;
  if (a.u != b.u) return a.u > b.u;
  return a.id < b.id;
}

// A class with no key (any real key beats it).
__device__ __forceinline__ ClassKey no_class() {
  return {kIntMax, -kIntMax - 1, kIntMax, 0u};
}

// A lane's (or a warp's) share of a row: its smallest feasible k, the
// count of feasible subsets at it, and per tier the best key at it.
struct Partial {
  int kmin;
  unsigned cnt;
  ClassKey best[3];
};

// A row with no feasible subset: k = m + 1, count 0, no class.
__device__ __forceinline__ Partial no_partial(int m) {
  Partial w;
  w.kmin = m + 1;
  w.cnt = 0u;
#pragma unroll
  for (int t = 0; t < 3; ++t) w.best[t] = no_class();
  return w;
}

// Folds one feasible subset (size k, tier `tier`) into a lane's Partial.
__device__ __forceinline__ void take(Partial& s, int k, int tier,
                                     const Fold& f, int alpha_pos) {
  if (k < s.kmin) {
    s.kmin = k;
    s.cnt = 0u;
#pragma unroll
    for (int t = 0; t < 3; ++t) s.best[t] = no_class();
  }
  if (k == s.kmin) {
    ++s.cnt;
    const ClassKey cand = {alpha_pos ? static_cast<int>(f.pr) : 0,
                           static_cast<int>(f.u), static_cast<int>(f.id),
                           f.pr};
#pragma unroll
    for (int t = 0; t < 3; ++t)
      if (t == tier && class_better(cand, s.best[t])) s.best[t] = cand;
  }
}

// The Partials of a warp's lanes merged: kmin first, the count at it, then
// per tier field by field among the lanes at kmin that hold a key (p_eff
// only when alpha > 0, where it is the priority sum; then the uid mask;
// then the id; then, with alpha 0, the winner's priority sum), one
// redux.sync a field.  Combo ids are distinct, so one lane holds the
// winner.  Every lane gets the result; a class with no key has id kIntMax.
// alpha_pos is the same in every lane (a kernel argument).
__device__ __forceinline__ Partial merge_partials(const Partial& x,
                                                  int alpha_pos) {
  constexpr unsigned mask = 0xffffffffu;
  Partial r;
  r.kmin = __reduce_min_sync(mask, x.kmin);
  const bool at = x.kmin == r.kmin;
  r.cnt = __reduce_add_sync(mask, at ? x.cnt : 0u);
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const ClassKey& b = x.best[t];
    bool c = at && b.id != kIntMax;
    ClassKey w;
    w.p = 0;
    if (alpha_pos) {
      w.p = __reduce_min_sync(mask, c ? b.p : kIntMax);
      c = c && b.p == w.p;
    }
    w.u = __reduce_max_sync(mask, c ? b.u : -kIntMax - 1);
    c = c && b.u == w.u;
    w.id = __reduce_min_sync(mask, c ? b.id : kIntMax);
    c = c && b.id == w.id;
    w.pp = alpha_pos ? static_cast<unsigned>(w.p)
                     : __reduce_add_sync(mask, c ? b.pp : 0u);
    r.best[t] = w;
  }
  return r;
}

// Node `node`'s row in the patch index by a search over the G lanes of a
// group (`mask`, first lane `base`): each round every lane compares one
// pivot, so a round narrows the range G-fold; the last compares up to G
// entries for equality.  Returns the patch row, or -1.  Every lane of the
// group calls it with the same node.
__device__ __forceinline__ int group_find_patch(const int* __restrict__ pidx,
                                                int p, int node, int glane,
                                                int G, unsigned mask,
                                                int base) {
  const int lg = 31 - __clz(G);  // G is a power of two: no division
  int lo = 0, hi = p;  // the first entry >= node lies in [lo, hi]
  while (hi - lo > G) {
    const int step = (hi - lo + G - 1) >> lg;
    const int i = lo + (glane + 1) * step - 1;  // the last entry of chunk glane
    const bool below = i < hi && pidx[i] < node;
    lo += __popc(__ballot_sync(mask, below) & mask) * step;
    hi = min(hi, lo + step);
  }
  const int i = lo + glane;
  const unsigned hit = __ballot_sync(mask, i < hi && pidx[i] == node) & mask;
  return hit ? lo + (__ffs(hit) - 1 - base) : -1;
}

// Loads row r into rw with the G lanes of a group (16 or 32, in one
// warp; `mask` its lanes, `base` its first): the row's node and patch row,
// then every word the row needs in one round trip (the loads straight-line
// and predicated, ahead of every use): the node fields and drain masks
// (each lane reads the same words), the slots' priority and stored flag
// (lane l the slots l, l + G, ...) and the first m slots' masks and ranks;
// then one ballot of the eligible slots a round.  Lanes l < m fold slot l
// (when eligible) into rw.rec at its dense index, lane G - 2 the free masks
// into rw.base and lane G - 1 the drained masks into rw.drain, all in one
// pass (m <= G - 2).  Returns the row's head (valid, ok, node id) in every
// lane of the group; the caller syncs before reading rw.
__device__ __forceinline__ void load_sweep_row(const State& s,
                                               const FusedParams& p, int r,
                                               bool present, int m, int glane,
                                               int G, unsigned mask, int base,
                                               SweepRow& rw, unsigned& valid,
                                               bool& ok, int& node_id) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int kRounds = kMaxCap / 16;  // slots a lane at G = 16
  const bool gathered = r >= s.n_res;
  // a row past the section (present false) reads as a zero row, not ok
  const int node = !present ? -1 : (gathered ? s.gidx[r - s.n_res] : r);
  const bool zero = node < 0 || node >= s.n;
  const int j = !zero && s.p > 0
                    ? group_find_patch(s.pidx, s.p, node, glane, G, mask, base)
                    : -1;
  const Row row = row_of(s, node, j, gathered);
  const int lg = 31 - __clz(G);
  const bool own = glane < m;  // lane glane < m holds slot glane
  const unsigned fg = static_cast<unsigned>(row.node(NS_FREE_GPU));
  const unsigned fc = static_cast<unsigned>(row.node(NS_FREE_CG));
  node_id = row.node(NS_NODE_ID);
  const int over = row.node(NS_OVERFLOW);
  const int next = row.node(NS_NEXT_PRIO);
  const unsigned dg = static_cast<unsigned>(row.drain(0));
  const unsigned dc = static_cast<unsigned>(row.drain(1));
  const unsigned sg = own ? static_cast<unsigned>(row.slot(VF_GPU, glane)) : 0u;
  const unsigned sc = own ? static_cast<unsigned>(row.slot(VF_CG, glane)) : 0u;
  const int rank = own ? row.slot(VF_RANK, glane) : 0;
  int prio[kRounds], stored[kRounds];
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    const int sl = (i << lg) + glane;
    const bool in = sl < s.cap;
    prio[i] = in ? row.slot(VF_PRIO, sl) : 0;
    stored[i] = in ? row.slot(VF_STORED, sl) : 0;
  }
  unsigned eb = 0u;
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    const int s0 = i << lg;
    if (s0 < s.cap)  // the same in every lane of the warp
      eb |= ((__ballot_sync(kAll, stored[i] != 0 && prio[i] < p.thresh) &
              mask) >> base) << s0;
  }
  const bool bad = over != 0 && next < p.thresh;
  const unsigned sp = static_cast<unsigned>(prio[0]);  // slot glane's
  const unsigned sh = static_cast<unsigned>(kMaxDenseVictims - 1 - rank);
  const unsigned rb = sh < 32u ? (1u << sh) : 0u;  // over the full cap width
  valid = eb & ((1u << m) - 1u);
  // rows whose node id is IDX_SENTINEL never win; the narrow gate of the
  // resident section
  ok = present && node_id < kIntMax &&
       (gathered || (__popc(eb) <= m && !bad));
  if (ok) {
    const bool slot = glane < m && ((valid >> glane) & 1u);
    Fold f;
    f.g = glane < m ? sg : (glane == G - 2 ? fg : dg);
    f.c = glane < m ? sc : (glane == G - 2 ? fc : dc);
    f.pr = slot ? sp : 0u;
    f.u = slot ? rb : 0u;
    f.id = slot ? 1u << glane : 0u;
    f.pad = 0u;
    numa_words(f.g, f.c, p.t, f.wg, f.wc);
    if (slot)
      rw.rec[__popc(valid & ((1u << glane) - 1u))] = f;
    else if (glane == G - 2)
      rw.base = f;
    else if (glane == G - 1)
      rw.drain = f;
  }
}

// Field f of a row's cls column from the merged Partial, by selects (no
// local memory).  A row with no feasible subset, or filtered, reports
// k = m + 1, count 0, and combo id, priority sum and uid mask 0 in every
// class.
__device__ __forceinline__ int cls_field(int f, const Partial& w, int nid) {
  if (f >= 12) return f == 12 ? w.kmin : (f == 13 ? static_cast<int>(w.cnt)
                                                 : nid);
  const int kind = f / 3, t = f - 3 * kind;
  ClassKey b = w.best[2];
  if (t == 0) b = w.best[0];
  if (t == 1) b = w.best[1];
  const bool any = b.id != kIntMax;
  const int v = kind == 1 ? b.id
                          : (kind == 2 ? static_cast<int>(b.pp) : b.u);
  return kind == 0 ? any : (any ? v : 0);
}

// The two sections of a plan's rows and the threads each row takes
// (fused_class.sweep_geometry): rows [0, n_res) at m[0] behind the narrow
// gate, in blocks [0, blocks_res); then the gathered rows at m[1].
struct SweepGeometry {
  int m[2];
  int group[2];
  int blocks_res;
  int rows;
};

// One row's pass over its 2^e eligible subsets by a warp (G = 32) or, when
// WIDE, by the CTA (G = kWideThreads), G = 2^lg: dense index
// j = (hi << L) | lo with L = max(0, e - lg); thread hi folds the slots
// L..e-1 its bits name once (selects, no branch), and a table of the 2^L
// low folds (base + the slots 0..L-1 lo names), built once in shared
// memory, completes each subset with one fold; the id is j's bits
// deposited at valid's set positions, k = popc(j).  The tier comes from
// the packed per-NUMA counts (fused_tier), with no division.  Guaranteed
// Filtering: where the group has a spare thread (L = 0, 2^e < G) thread 2^e
// judges the drained masks in the same pass, else every thread does after
// it; `drained` returns the verdict in every thread of the group.  Returns
// the thread's Partial.
template <bool WIDE>
__device__ __forceinline__ Partial sweep_pass(const SweepRow& rw, Fold* table,
                                              int e, int m, int lg, int glane,
                                              const TierRule& rule,
                                              const FusedParams& p,
                                              bool& drained) {
  const int G = 1 << lg;
  const int L = max(0, e - lg), H = e - L;
  Partial part;
  part.kmin = m + 1;
  part.cnt = 0u;
#pragma unroll
  for (int t = 0; t < 3; ++t) part.best[t] = no_class();
  if (L > 0) {  // 2^L <= 8 <= G (narrow), 2^L <= 128 < G (wide)
    if (glane < (1 << L)) {
      Fold f = rw.base;
      for (int b = 0; b < L; ++b)
        if ((glane >> b) & 1) f = fold(f, rw.rec[b]);
      table[glane] = f;
    }
    if (WIDE) __syncthreads(); else __syncwarp();
  }
  const bool spare = L == 0 && (1 << e) < G;
  const bool judge = spare && glane == (1 << e);
  bool verdict = false;
  if (glane < (1 << H) || judge) {
    Fold hi = {0u, 0u, 0u, 0u, 0u, 0u, 0ull, 0ull};
#pragma unroll
    for (int b = 0; b < (WIDE ? 9 : 5); ++b) {
      if (b < H) {  // the same in every thread of the group
        const Fold& x = rw.rec[L + b];
        const bool on = (glane >> b) & 1;
        hi.g |= on ? x.g : 0u;
        hi.c |= on ? x.c : 0u;
        hi.pr += on ? x.pr : 0u;
        hi.u += on ? x.u : 0u;
        hi.id |= on ? x.id : 0u;
        hi.wg += on ? x.wg : 0ull;
        hi.wc += on ? x.wc : 0ull;
      }
    }
    const int hk = __popc(glane);
    for (int lo = 0; lo < (1 << L); ++lo) {
      const Fold f = judge ? rw.drain : fold(hi, L > 0 ? table[lo] : rw.base);
      const int tier = fold_tier(f, rule, p.t);
      if (judge)
        verdict = tier < 3;
      else if (tier < 3)
        take(part, hk + __popc(lo), tier, f, p.alpha_pos);
    }
  }
  if (spare)
    drained = WIDE ? __syncthreads_or(verdict) != 0
                   : __ballot_sync(0xffffffffu, verdict) != 0u;
  else
    drained = fold_tier(rw.drain, rule, p.t) < 3;
  return part;
}

// The lanes below 32 whose index has popcount j (a subset's k), j <= 5.
__device__ __forceinline__ unsigned popc_class(int j) {
  return j == 0 ? 0x1u
                : (j == 1 ? 0x10116u
                          : (j == 2 ? 0x1161668u
                                    : (j == 3 ? 0x16686880u
                                              : (j == 4 ? 0x68808000u
                                                        : 0x80000000u))));
}

// The least (max_ = false) or greatest value of x over each group of G
// adjacent lanes (G a power of two up to 32), in every lane of the group:
// xor shuffles that stay inside the group.  Every lane of the warp calls it.
__device__ __forceinline__ int group_extreme(int x, int G, bool max_) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (off < G) {  // the same in every lane of the warp
      const int y = __shfl_xor_sync(0xffffffffu, x, off);
      x = max_ ? max(x, y) : min(x, y);
    }
  }
  return x;
}

// A row whose 2^e subsets are one a thread (e <= log2 G, so L = 0): thread
// j of the group folds subset j (k = popc(j); its combo id, j's bits
// deposited at valid's set positions, grows with j).  The ballot of the
// feasible threads gives kmin (the first popcount class it meets) and the
// count at it; per tier, of the threads at kmin in that tier, the least
// p_eff (alpha > 0) and then the greatest uid mask by shuffles within the
// group, and the lowest remaining thread holds the lowest id; its key
// comes by shuffle.  `live` marks a row with a head that passed (the group
// of a row that did not computes nothing that counts).  Every collective
// is the whole warp's, and every lane of the warp calls this with its own
// group's row, so groups whose rows differ never diverge around one.
// Guaranteed Filtering as in sweep_pass.  Returns the merged result in
// every thread of the group.
__device__ __forceinline__ Partial lane_row(const SweepRow& rw, bool live,
                                            int e, int m, int lg, int glane,
                                            int gbase, const TierRule& rule,
                                            const FusedParams& p,
                                            bool& drained) {
  constexpr unsigned kAll = 0xffffffffu;
  const int G = 1 << lg;
  const unsigned gm = G == 32 ? kAll : (1u << G) - 1u;  // a group's bits
  const bool mine = live && glane < (1 << e);
  const bool spare = (1 << e) < G;
  const bool judge = live && spare && glane == (1 << e);
  Fold f = rw.base;
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    if (b < e) {  // the same in every thread of the group
      const Fold& x = rw.rec[b];
      const bool on = (glane >> b) & 1;
      f.g |= on ? x.g : 0u;
      f.c |= on ? x.c : 0u;
      f.pr += on ? x.pr : 0u;
      f.u += on ? x.u : 0u;
      f.id |= on ? x.id : 0u;
      f.wg += on ? x.wg : 0ull;
      f.wc += on ? x.wc : 0ull;
    }
  }
  if (judge) f = rw.drain;
  const int tier = fold_tier(f, rule, p.t);
  const unsigned judged = (__ballot_sync(kAll, judge && tier < 3) >> gbase) & gm;
  const unsigned F = (__ballot_sync(kAll, mine && tier < 3) >> gbase) & gm;
  drained = judged != 0u;
  if (live && !spare) drained = fold_tier(rw.drain, rule, p.t) < 3;
  unsigned at = 0u;  // the feasible threads at kmin
  int k = 0;
#pragma unroll
  for (int j = 0; j <= 5; ++j) {
    if (at == 0u) {
      at = F & popc_class(j);
      k = j;
    }
  }
  Partial w = no_partial(m);
  if (F != 0u) {
    w.kmin = k;
    w.cnt = static_cast<unsigned>(__popc(at));
  }
  const int pe = p.alpha_pos ? static_cast<int>(f.pr) : 0;
  const int u = static_cast<int>(f.u);
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    unsigned c = at & ((__ballot_sync(kAll, tier == t) >> gbase) & gm);
    bool in = (c >> glane) & 1u;
    if (p.alpha_pos) {  // a kernel argument: the same in every lane
      const int pm = group_extreme(in ? pe : kIntMax, G, false);
      in = in && pe == pm;
    }
    const int um = group_extreme(in ? u : -kIntMax - 1, G, true);
    in = in && u == um;
    c = (__ballot_sync(kAll, in) >> gbase) & gm;
    const int src = gbase + (c ? __ffs(c) - 1 : 0);
    const int id = __shfl_sync(kAll, static_cast<int>(f.id), src);
    const unsigned pp = __shfl_sync(kAll, f.pr, src);
    if (c != 0u) {
      w.best[t].p = p.alpha_pos ? static_cast<int>(pp) : 0;
      w.best[t].u = um;
      w.best[t].id = id;
      w.best[t].pp = pp;
    }
  }
  return w;
}

// The row's cls column, one lane a field (lanes glane and glane + G of the
// group), from the group's merged Partial w.
__device__ __forceinline__ void write_cls(int* __restrict__ cls, int R, int r,
                                          int glane, int G, const Partial& w,
                                          int nid) {
  if (glane < 15) cls[glane * R + r] = cls_field(glane, w, nid);
  if (glane + G < 15) cls[(glane + G) * R + r] = cls_field(glane + G, w, nid);
}

// The class sweep.  Narrow (m <= 8): each warp loads 32 / G rows at once, a
// group of G = group[section] threads a row (16 or 32; blockDim / G rows
// a CTA).  Then, where every row of the warp has at most log2 G eligible
// slots (one subset a thread), each group sweeps its own row; else the
// whole warp sweeps the warp's rows one after another (G = 32, up to 8
// subsets a thread).  The choice is the warp's, from the rows it loaded.
// Wide (m <= 16): one row a CTA of kWideThreads, loaded by warp 0 and
// merged warp by warp.  A row:
//   1. load (load_sweep_row): e = popc(valid) eligible slots, e <= m;
//   2. sweep_pass over the 2^e eligible subsets;
//   3. the merge (lane_row's, or merge_partials: kmin first, then field
//      by field);
//   4. one lane a field writes the row's 15 cls fields.
template <bool WIDE, bool SHARED>
__global__ void __launch_bounds__(WIDE ? kWideThreads : kNarrowThreads,
                                  SHARED ? kSharedSweepCtas : 1)
    fused_class_kernel(State s, FusedParams p, SweepGeometry geo,
                       const int* __restrict__ skip, int* __restrict__ cls) {
  if (skip != nullptr && *skip != 0) return;  // the normal cycle placed
  extern __shared__ unsigned long long sweep_smem[];
  __shared__ Partial s_part[WIDE ? kWideThreads / 32 : 1];
  const int sec = static_cast<int>(blockIdx.x) < geo.blocks_res ? 0 : 1;
  // selects, not geo.group[sec]: a parameter array indexed at run time
  // would be copied to local memory
  const int G = WIDE ? kWideThreads : (sec == 0 ? geo.group[0] : geo.group[1]);
  const int lg = 31 - __clz(G);  // G is a power of two: shifts, no division
  const int m = sec == 0 ? geo.m[0] : geo.m[1];
  const int rows_cta = blockDim.x >> lg;
  const int first = sec == 0 ? blockIdx.x * rows_cta
                             : s.n_res + (blockIdx.x - geo.blocks_res) * rows_cta;
  const int end = sec == 0 ? s.n_res : geo.rows;
  const int R = geo.rows;
  const int sub = threadIdx.x >> lg;
  const int glane = threadIdx.x & (G - 1);
  const int r = first + sub;
  const int lane = threadIdx.x & 31;
  SweepRow* rows = reinterpret_cast<SweepRow*>(sweep_smem);
  Fold* tables = reinterpret_cast<Fold*>(rows + rows_cta);
  const TierRule rule = tier_rule(p.t, bundle_magic(p.t.cgs_per_bundle));
  constexpr unsigned kAll = 0xffffffffu;

  if (WIDE) {
    SweepRow& rw = rows[0];
    unsigned valid;
    bool ok;
    int nid;
    if (threadIdx.x < 32) {
      load_sweep_row(s, p, r, true, m, lane, 32, kAll, 0, rw, valid, ok,
                     nid);
      if (lane == 0) {
        rw.valid = valid;
        rw.ok = ok;
        rw.node_id = nid;
      }
    }
    __syncthreads();
    valid = rw.valid;
    ok = rw.ok != 0;
    nid = rw.node_id;
    Partial w = no_partial(m);
    if (ok) {  // the same in every thread of the CTA
      bool drained;
      const Partial part = sweep_pass<true>(rw, tables, __popc(valid), m, lg,
                                            glane, rule, p, drained);
      if (drained) {
        w = merge_partials(part, p.alpha_pos);
        const int warp = threadIdx.x >> 5;
        if (lane == 0) s_part[warp] = w;
        __syncthreads();
        if (warp == 0)
          w = merge_partials(lane < kWideThreads / 32 ? s_part[lane]
                                                      : no_partial(m),
                             p.alpha_pos);
      }
    }
    if (threadIdx.x < 32) write_cls(cls, R, r, lane, 32, w, nid);
    return;
  }

  // narrow: a warp's rows are first + (warp * 32 >> lg) + i, i < 32 >> lg
  const int warp_row = first + ((threadIdx.x & ~31) >> lg);
  if (warp_row >= end) return;  // whole warps
  const int gbase = lane & ~(G - 1);
  const unsigned mask = G == 32 ? kAll : ((1u << G) - 1u) << gbase;
  SweepRow& rw = rows[sub];
  unsigned valid;
  bool ok;
  int nid;
  load_sweep_row(s, p, r, r < end, m, glane, G, mask, gbase, rw, valid, ok,
                 nid);
  __syncwarp();
  const int e = __popc(valid);
  if (__all_sync(kAll, !ok || e <= lg)) {  // each group its own row
    bool drained;
    const Partial got =
        lane_row(rw, ok, e, m, lg, glane, gbase, rule, p, drained);
    if (r < end) write_cls(cls, R, r, glane, G, ok && drained ? got
                                                              : no_partial(m),
                           nid);
    return;
  }
  // the whole warp, row after row
  const int row0 = sub - (lane >> lg);  // the warp's first row in the CTA
  for (int i = 0; i < (32 >> lg); ++i) {
    const int src = i << lg;  // the first lane of row i's group
    const int ri = warp_row + i;
    const unsigned vi = __shfl_sync(kAll, valid, src);
    const bool oki = __shfl_sync(kAll, static_cast<int>(ok), src) != 0;
    const int nidi = __shfl_sync(kAll, nid, src);
    if (ri >= end) break;
    Partial w = no_partial(m);
    const int ei = __popc(vi);
    if (oki) {
      bool drained;
      Partial got;
      if (ei <= 5) {
        got = lane_row(rows[row0 + i], true, ei, m, 5, lane, 0, rule, p,
                       drained);
      } else {
        got = merge_partials(
            sweep_pass<false>(rows[row0 + i],
                              tables + (row0 + i) * kNarrowTable, ei, m, 5,
                              lane, rule, p, drained),
            p.alpha_pos);
      }
      if (drained) w = got;
    }
    write_cls(cls, R, ri, lane, 32, w, nidi);
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
  const TierRule rule = tier_rule(p.t, bundle_magic(p.t.cgs_per_bundle));
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
  warp_place(fg, fc, p, rule, ok, tier, gm, cm);
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
                                             const TierRule& rule,
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
  warp_place(fg, fc, p, rule, p_ok, p_tier, pg, pc);
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
  const TierRule rule = tier_rule(p.t, bundle_magic(p.t.cgs_per_bundle));
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
        unsigned long long wg, wc;
        numa_words(fg[j], fc[j], p.t, wg, wc);
        const int tier = fused_tier(fg[j], fc[j], wg, wc, rule, p.t);
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
                 __shfl_sync(kAll, nid0, 0), s.n, p, rule, out);
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
               tier_rule(p.t, bundle_magic(p.t.cgs_per_bundle)), out);
}

static inline int grid_for(int n) { return (n + kTile - 1) / kTile; }

// K2's and K3's lane forms: one lane a thread in blocks of kLaneThreads (n
// rounded up to a warp below one block) while one grid of at most
// kLaneBlocksPerSm blocks an SM of the current device covers n; above it,
// where `vec` (every pointer 16-byte aligned), four lanes a thread a step
// over at most that grid, else one lane a thread a step.  A failed SM
// query leaves its error for the launcher's cudaGetLastError().
struct LaneGeometry {
  int blocks, threads;
  bool vectors;
};

static LaneGeometry lane_geometry(int n, bool vec) {
  static int sms[kMaxDevices] = {};
  int device = 0;
  cudaGetDevice(&device);
  const bool known = device >= 0 && device < kMaxDevices;
  int count = known ? sms[device] : 0;
  if (count == 0) {
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (known) sms[device] = count;
  }
  const int most = kLaneBlocksPerSm * (count > 0 ? count : 1);
  const int blocks = (n + kLaneThreads - 1) / kLaneThreads;
  if (blocks <= most)
    return {blocks, n >= kLaneThreads ? kLaneThreads : (n + 31) / 32 * 32,
            false};
  if (!vec) return {most, kLaneThreads, false};
  const int quads = (n / 4 + kLaneThreads - 1) / kLaneThreads;
  return {quads < most ? quads : most, kLaneThreads, true};
}

__global__ void empty_kernel() {}

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
  const LaneGeometry geo = lane_geometry(n, vec != 0);
  auto kernel =
      geo.vectors ? topo_score_kernel<true> : topo_score_kernel<false>;
  kernel<<<geo.blocks, geo.threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(gmask), static_cast<const int*>(cmask),
      static_cast<const int*>(prio), static_cast<int*>(tier),
      static_cast<float*>(score), n, *params);
  return static_cast<int>(cudaGetLastError());
}

// K1's lane form: a block a tile, one lane a thread.
int topo_score_argmax_launch(const void* gmask, const void* cmask,
                             const void* prio, const void* k, const void* ok,
                             void* tier, void* score, void* kmin, void* btier,
                             void* bscore, void* bidx, int n,
                             const TopoParams* params, void* stream) {
  const int threads = n >= kTile ? kTile : (n + 31) / 32 * 32;
  topo_score_argmax_kernel<<<grid_for(n), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(gmask), static_cast<const int*>(cmask),
      static_cast<const int*>(prio), static_cast<const int*>(k),
      static_cast<const int*>(ok), static_cast<int*>(tier),
      static_cast<float*>(score), static_cast<int*>(kmin),
      static_cast<int*>(btier), static_cast<float*>(bscore),
      static_cast<int*>(bidx), n, *params);
  return static_cast<int>(cudaGetLastError());
}

int placement_tier_launch(const void* free_gpu, const void* free_cg,
                          void* tier, int n, const TopoParams* params, int vec,
                          void* stream) {
  const LaneGeometry geo = lane_geometry(n, vec != 0);
  auto kernel =
      geo.vectors ? placement_tier_kernel<true> : placement_tier_kernel<false>;
  kernel<<<geo.blocks, geo.threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(free_gpu), static_cast<const int*>(free_cg),
      static_cast<int*>(tier), n, *params);
  return static_cast<int>(cudaGetLastError());
}


// The most slots a narrow row of G threads takes: lanes G - 2 and G - 1
// fold the free and drained masks (m <= G - 2), and a warp sweeping a row
// alone keeps at most kNarrowTable low folds (m <= 5 + 3).
static int narrow_max_m(int G) {
  return G == 16 || G == 32 ? 8 : -1;
}

// The sweep over R rows in `threads`-thread CTAs: a wide launch
// (threads == group_res == group_gather == kWideThreads, one row a CTA,
// m <= 16) or a narrow one (threads a multiple of 32 up to kNarrowThreads,
// each section's group 16 or 32 with m <= narrow_max_m(group)).
int fused_class_launch(const State* state, const FusedParams* params,
                       int m_res, int m_gather, int R, int threads,
                       int group_res, int group_gather, const void* skip,
                       void* cls, int device, void* stream) {
  const int n_res = state->n_res, n_g = R - state->n_res;
  const int m_top = min(state->cap, kMaxDenseVictims);
  const bool wide = threads == kWideThreads;
  bool bad = state->cap > kMaxCap || R <= 0 || n_g < 0 || m_res < 0 ||
             m_gather < 0 || m_res > m_top || m_gather > m_top;
  if (wide) {
    bad = bad || group_res != kWideThreads || group_gather != kWideThreads;
  } else {
    bad = bad || threads < 32 || threads > kNarrowThreads || threads % 32 ||
          (n_res > 0 && m_res > narrow_max_m(group_res)) ||
          (n_g > 0 && m_gather > narrow_max_m(group_gather)) ||
          narrow_max_m(group_res) < 0 || narrow_max_m(group_gather) < 0;
  }
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  SweepGeometry geo;
  geo.m[0] = m_res;
  geo.m[1] = m_gather;
  geo.group[0] = group_res;
  geo.group[1] = group_gather;
  geo.rows = R;
  const int rows_res = threads / group_res, rows_g = threads / group_gather;
  geo.blocks_res = (n_res + rows_res - 1) / rows_res;
  const int blocks = geo.blocks_res + (n_g + rows_g - 1) / rows_g;
  const int rows_cta = max(n_res > 0 ? rows_res : 1, n_g > 0 ? rows_g : 1);
  const size_t smem = static_cast<size_t>(rows_cta) *
                      (sizeof(SweepRow) +
                       (wide ? kWideTable : kNarrowTable) * sizeof(Fold));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sk = static_cast<const int*>(skip);
  int* out = static_cast<int*>(cls);
  // rows that share warps (a group below 32) are a large plan: the build
  // that keeps more CTAs an SM (fewer registers) hides more latency there,
  // and a warp a row (a small plan) keeps the registers
  if (wide)
    fused_class_kernel<true, false><<<blocks, threads, smem, st>>>(
        *state, *params, geo, sk, out);
  else if (group_res < 32 || group_gather < 32)
    fused_class_kernel<false, true><<<blocks, threads, smem, st>>>(
        *state, *params, geo, sk, out);
  else
    fused_class_kernel<false, false><<<blocks, threads, smem, st>>>(
        *state, *params, geo, sk, out);
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

// The launch floor's yardstick: an empty kernel, one warp, launched through
// the same ctypes path as the kernels above (chip_smoke.py times it).
int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* topo_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
