// The backward of the blocked GQA attention (K4) for Hopper (sm_90a).
// Hand-written CUDA C++ with a plain C interface (ctypes).
//
// The reference has no backward of its Pallas kernel
// (src/repro/kernels/flash_attention.py:77 has no custom_vjp): its
// training differentiates the XLA attention.  This computes the same
// gradients from the forward's output O and each row's log-sum-exp
// (flash_attention.cu, natural units), for every mask the forward takes
// (causal, window, bidirectional, cross Sq != Sk, prefix-LM):
//   D   = rowsum(dO o O)                         (f32, one value a q row)
//   P   = exp(s d^-0.5 - lse), 0 where masked     (recomputed, never stored)
//   dV += P^T dO          dP = dO V^T           dS = P o (dP - D)
//   dK += dS^T Q d^-0.5   dQ += dS K d^-0.5
// Two launches on the caller's stream, in this order:
// * the dQ pass: a CTA per (b*H + h, q block) over the KV tiles [lo, hi)
//   the forward's q block walks (kv_range); it first writes D of its
//   rows, which the second pass reads;
// * the dK/dV pass: a CTA per (b*K + kh, KV tile), looping in a fixed
//   order over the G query heads of KV head kh and over the q blocks
//   [lo, hi) that see the tile (q_range, the transpose of kv_range).  The
//   GQA sum over the G heads is made in the CTA's registers, so no pass
//   uses atomics and a step is deterministic.
// The per-element mask runs only on the blocks the mask's edges cross
// (block_needs_mask, the forward's tile_needs_mask for any rows x cols);
// rows past Sq carry lse = +1e30 and D = 0, so their P is 0 without one.
//
// Bound (llama3.2-1b's training shape: B 4, H 32, K 8, S 1024, d 64,
// bf16, causal): five products of 2 d B H S(S+1)/2 each against the
// forward's two, 2.5 x 17.2 = 43.0 GFLOP, 43.5 us at 989 TFLOP/s; the
// bytes (q, k, v, o, dO read once, the gradients written once) take 20 us.
// The operations bound it, so every product goes to the tensor cores at
// the rate only wgmma reaches, and the loads hide behind them in a ring.
// The two passes recompute S and dP each (7 products against the bound's
// 5): the price of a dQ without atomics.
//
// bf16 at d = 16, 32, 64, 128 (bwd_wgmma_dq_kernel, bwd_wgmma_dkv_kernel),
// the forward's design (flash_attention.cu flash_bf16_kernel):
// * 384 threads in three warpgroups.  Warpgroup 0 is the producer: it
//   gives registers back (setmaxnreg.dec) and one thread issues every TMA
//   load into a 4-stage ring with full and empty mbarriers.  Warpgroups 1
//   and 2 are the consumers (setmaxnreg.inc), 64 rows each.
// * TMA.  4-D tensor maps (d, S, heads, B) over the strided views the
//   model passes, encoded on the host (hopper.cuh) from the rows the
//   Python helper computes: boxes of 64 rows and at most 64 columns, with
//   the swizzle as wide as a box row (128B at d >= 64, 64B at d = 32, 32B
//   at d = 16), the layout the wgmma descriptors read.  TMA zero-fills
//   rows past Sq / Sk.
// * dQ pass: a CTA per 128 q rows (heads along x, q blocks reversed along
//   y: the longest causal rows first).  Q, dO and O arrive once; each
//   consumer sums D = rowsum(dO o O) of its rows from shared memory and
//   writes D and its rows' log-sum-exp in log2 units (+1e30 past Sq) to
//   the scratch the dK/dV pass reads.  K and V tiles of BK rows (128; 64
//   at d = 128, registers) stream through the ring.  A step:
//   S = Q K^T and dP = dO V^T (wgmma m64nBKk16, both operands K-major in
//   shared memory), P and dS on the accumulator fragments, dS rounded to
//   bf16 once, dQ += dS K (m64n(d)k16, A = dS from registers, B = K read
//   MN-major with the transpose bit).
// * dK/dV pass: KV heads along x, KV tiles along y (tile 0, which every q
//   block sees under the causal mask, first).  K and V arrive once; Q and
//   dO tiles of 64 rows, and the matching 64 values of the log-sum-exp and
//   of D (1-D bulk copies from the scratch, whose rows are padded to
//   128), stream through the ring in the fixed (head, q block) order.  A
//   step: S^T = K Q^T and dP^T = V dO^T (m64n64k16, K-major), P^T and dS^T
//   on the fragments, each rounded to bf16 once, dV += P^T dO and
//   dK += dS^T Q (A from registers, B = dO and Q MN-major: neither is
//   gathered).  A CTA takes 128 KV rows, a consumer each; where that grid
//   leaves SMs idle, a cluster of two CTAs takes 64 KV rows, each CTA
//   half the q blocks and its consumers alternate steps; the partial sums
//   meet in a fixed order through shared and distributed shared memory.
// * Each consumer issues a step's S and dP with the products of the step
//   before (the dQ pass, and the dK/dV pass at d <= 64: at d = 128 dK and
//   dV take the registers for it), so the tensor cores run those during
//   the softmax; the first and last steps stand alone, so that no wait
//   depends on a branch inside the loop (ptxas keeps the products
//   asynchronous).  The two consumers take turns to issue (ping-pong on
//   named barriers, the forward's scheme), and the per-element mask is a
//   branch of its own, taken only on the tiles the mask's edges cross.
// * Epilogue: dQ and dK scaled by d^-0.5 once, rounded to bf16 into the
//   consumer's dead Q (dQ) or K and V (dK, dV) rows of shared memory in
//   the map's swizzle, then TMA stores, which clip rows past Sq / Sk.
// f32 at every d, and bf16 at d = 256 (bwd_core_*): the CUDA cores in f32
// (FMA, expf), a q row (dQ pass) or a KV row (dK/dV pass) to TPR threads
// that hold 32 of its elements each (16 at d = 16).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int BQ = 64;          // the CUDA-core forms' q rows a dQ CTA and
                                // KV rows a dK/dV CTA

struct Shape {
  int H, group, Sq, Sk, causal, window;  // window 0 = none
  int prefix;   // P of the prefix-LM mask; 0 = none, and 0 unless causal
  float scale;  // d^-0.5 (natural units)
};

// element strides (b, h, s) of q, k, v, o, do; the last dim is contiguous
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;   // [B * H, Sq]
  float* dsum;        // D, written by the dQ pass: [B * H, Sq] (CUDA-core
                      // forms), [B * H, pad] (wgmma forms)
  float* lse2;        // wgmma forms: each row's lse in log2 units, +1e30
                      // past Sq, [B * H, pad]
  int pad;            // Sq rounded up to the wgmma dQ pass's 128 rows
  void* dq;           // contiguous [B, H, Sq, d]
  void* dk;           // contiguous [B, K, Sk, d]
  void* dv;
  long long st[5][3];
};

enum { Q_, K_, V_, O_, DO_ };

__device__ __forceinline__ bool allowed(const Shape& a, int row, int col) {
  bool ok = true;
  if (a.causal) ok = col <= row;
  if (a.window > 0) ok = ok && (row - col) < a.window;
  ok = ok || (row < a.prefix && col < a.prefix);
  return ok && col < a.Sk;
}

// The forward's KV range of the q block of BQR rows from q0 (tiles of BK
// keys).
template <int BQR, int BK>
__device__ __forceinline__ void kv_range(const Shape& a, int q0, int& lo,
                                         int& hi) {
  const bool in_prefix = q0 < a.prefix;
  hi = a.causal ? min(a.Sk, in_prefix ? max(q0 + BQR, a.prefix) : q0 + BQR)
                : a.Sk;
  lo = 0;
  if (a.window > 0 && !in_prefix)
    lo = (max(0, q0 - (a.window - 1)) / BK) * BK;
}

// The q rows [lo, hi) that see the KV tile [k0, k0 + BK), lo rounded down
// to a q block of BQR rows (kernels/flash_attention.py _q_range).
template <int BK, int BQR>
__device__ __forceinline__ void q_range(const Shape& a, int k0, int& lo,
                                        int& hi) {
  const int kmax = min(k0 + BK, a.Sk) - 1;
  const bool in_prefix = k0 < a.prefix;
  lo = a.causal && !in_prefix ? k0 : 0;
  hi = a.Sq;
  if (a.window > 0)
    hi = min(a.Sq, in_prefix ? max(a.prefix, kmax + a.window)
                             : kmax + a.window);
  lo = (lo / BQR) * BQR;
}

// Whether q rows [r0, r0 + rows) against keys [k0, k0 + cols) need the
// per-element mask (the forward's tile_needs_mask for any rows x cols).
__device__ __forceinline__ bool block_needs_mask(const Shape& a, int r0,
                                                 int rows, int k0, int cols) {
  bool m = k0 + cols > a.Sk;
  if (r0 < a.prefix) m = m || k0 + cols > a.prefix;
  if (r0 + rows - 1 >= a.prefix)
    m = m || (a.causal && k0 + cols - 1 > max(r0, a.prefix)) ||
        (a.window > 0 && r0 + rows - 1 - k0 >= a.window);
  return m;
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 8 elements of a row from global memory to f32 (16 or 32 bytes)
template <typename T>
__device__ __forceinline__ void load8(float (&x)[8], const T* p);
template <>
__device__ __forceinline__ void load8<float>(float (&x)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(
    float (&x)[8], const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    x[2 * i] = __low2float(h);
    x[2 * i + 1] = __high2float(h);
  }
}

// D = rowsum(dO o O) of q rows [q0, q0 + BQ) of head bh into dsum, by
// `threads` threads (two or more a row, a power of two); rows past Sq are
// skipped.  Returns nothing: callers read dsum back after a barrier.
template <typename T, int D>
__device__ __forceinline__ void row_dsum(const Args& p, const Shape& a,
                                         int b, int h, int q0, int threads,
                                         float* sD) {
  const int per = threads / BQ;              // threads a row
  const int row = q0 + threadIdx.x / per, part = threadIdx.x % per;
  const T* op = static_cast<const T*>(p.o) + b * p.st[O_][0] +
                h * p.st[O_][1] + static_cast<long long>(row) * p.st[O_][2];
  const T* dp = static_cast<const T*>(p.dout) + b * p.st[DO_][0] +
                h * p.st[DO_][1] + static_cast<long long>(row) * p.st[DO_][2];
  float acc = 0.f;
  if (row < a.Sq)
    for (int c = 8 * part; c < D; c += 8 * per) {
      float x[8], y[8];
      load8<T>(x, op + c);
      load8<T>(y, dp + c);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(x[i], y[i], acc);
    }
  for (int m = 1; m < per; m *= 2) acc += __shfl_xor_sync(FULL, acc, m);
  if (part == 0) {
    sD[threadIdx.x / per] = row < a.Sq ? acc : 0.f;
    if (row < a.Sq)
      p.dsum[static_cast<long long>(b * a.H + h) * a.Sq + row] = acc;
  }
}

// ---------------------------------------------------------------------------
// bf16 at d = 16, 32, 64, 128: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int WG = 128;                  // threads of a warpgroup
constexpr int WG_THREADS = 3 * WG;       // the producer and two consumers
constexpr int BM = 128;                  // q rows a dQ CTA, KV rows a dK/dV
                                         // CTA: 64 a consumer
constexpr int BQS = 64;                  // q rows a dK/dV step
constexpr int STAGES = 4;                // the rings' depth

// The bf16 tiling for head dimension D: boxes of SPAN columns and 64 rows
// with a SPAN * 2 byte swizzle (the forward's); a tile of R rows keeps box
// x at byte x R ROWB.  BK: KV rows a dQ step (a consumer holds BK floats of
// S and dP a thread beside D / 2 of dQ, so 64 at d = 128).
template <int D>
struct WTile {
  static constexpr int SPAN = D < 64 ? D : 64;
  static constexpr int ROWB = SPAN * 2;        // bytes of a box row
  static constexpr int BOXES = D / SPAN;
  static constexpr uint32_t MODE = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  static constexpr uint32_t SWZ = ROWB / 16 - 1;  // row bits the XOR takes
  static constexpr int BK = D == 128 ? 64 : 128;
  // whether a dK/dV consumer holds two steps at once (the registers of
  // dK and dV leave no room for it at d = 128)
  static constexpr bool PIPE_DKV = D <= 64;
  static constexpr int DQ_SMEM = 1024 + 3 * BM * D * 2 +
                                 2 * STAGES * BK * D * 2 + 8 * (1 + 2 * STAGES);
  static constexpr int DKV_SMEM = 1024 + 2 * BM * D * 2 +
                                  STAGES * (2 * BQS * D * 2 + 2 * BQS * 4) +
                                  8 * (3 + 2 * STAGES);
};

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

// byte offset of (row r, column col) in a tile of R rows, in the maps'
// swizzle (16-byte chunk ^= bits 7.. of the offset; the tiles start on
// 1024-byte boundaries, where the pattern repeats)
template <int D, int R>
__device__ __forceinline__ uint32_t swizzled(int r, int col) {
  using T = WTile<D>;
  const uint32_t off = (col / T::SPAN) * R * T::ROWB + r * T::ROWB +
                       (col % T::SPAN) * 2;
  return off ^ (((off >> 7) & T::SWZ) << 4);
}

// rows [r0, r0 + R) of a tensor into a tile of R rows, 64 rows a TMA load
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          int r0, int head, int b,
                                          uint32_t bar) {
  using T = WTile<D>;
#pragma unroll
  for (int x = 0; x < T::BOXES; ++x)
#pragma unroll
    for (int j = 0; j < R / 64; ++j)
      tma_load(dst + (x * R + 64 * j) * T::ROWB, map, x * T::SPAN,
               r0 + 64 * j, head, b, bar);
}

// C = A B^T over the head dimension, m64nNk16: A = the 64 rows at sA of a
// tile of RA rows, B = a tile of N rows at sB, both K-major (D / 16 k-steps,
// 32 bytes apart inside a box row, the next box RA or N box rows further)
template <int D, int RA, int N>
__device__ __forceinline__ void issue_ss(float (&c)[N / 2], uint32_t sA,
                                         uint32_t sB) {
  using T = WTile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int x = kk / (T::SPAN / 16), in = (kk % (T::SPAN / 16)) * 32;
    wgmma_ss(c,
             smem_desc(sA + x * RA * T::ROWB + in, 16, 8 * T::ROWB, T::MODE),
             smem_desc(sB + x * N * T::ROWB + in, 16, 8 * T::ROWB, T::MODE),
             kk > 0);
  }
}

// C += A B, m64n(D)k16 over the R rows of the tile at sB: A from registers
// (k-step kk the fragment a[kk]), B MN-major (transpose bit): 16 rows a
// k-step, the second box of d = 128 R box rows further
template <int D, int R>
__device__ __forceinline__ void issue_rs(float (&c)[D / 2],
                                         const uint32_t (&a)[R / 16][4],
                                         uint32_t sB) {
  using T = WTile<D>;
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk)
    wgmma_rs(c, a[kk],
             smem_desc(sB + kk * 16 * T::ROWB, R * T::ROWB, 8 * T::ROWB,
                       T::MODE));
}

// An accumulator of N columns as bf16 A fragments, each value rounded
// once: k-step kk holds the n8 tiles 2 kk and 2 kk + 1
template <int N>
__device__ __forceinline__ void to_frags(uint32_t (&f)[N / 16][4],
                                         const float (&c)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      f[kk][r] = pack2f(c[8 * kk + 2 * r], c[8 * kk + 2 * r + 1]);
}

// A consumer's accumulator of D columns times `scale`, in bf16, into its
// 64 rows of a tile of R rows (s: the consumer's first row)
template <int D, int R>
__device__ __forceinline__ void stash(uint32_t s, const float (&c)[D / 2],
                                      float scale, int warp, int g, int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t at =
          s + swizzled<D, R>(16 * warp + g + 8 * half, 8 * j + 2 * t);
      const uint32_t val = pack2f(c[4 * j + 2 * half] * scale,
                                  c[4 * j + 2 * half + 1] * scale);
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at), "r"(val)
                   : "memory");
    }
}

// sum of the 8 products of two 16-byte chunks of bf16 values, into acc
__device__ __forceinline__ float dot8(uint32_t x, uint32_t y, float acc) {
  uint32_t u[4], w[4];
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(u[0]), "=r"(u[1]), "=r"(u[2]), "=r"(u[3])
               : "r"(x));
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
               : "r"(y));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u[i]);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    acc = fmaf(__low2float(a), __low2float(b), acc);
    acc = fmaf(__high2float(a), __high2float(b), acc);
  }
  return acc;
}

// the consumer's epilogue: its 64 rows of a tile (s, boxes R rows apart)
// to the tensor at row r0 by TMA stores, which clip rows past the end
template <int D, int R>
__device__ __forceinline__ void store_rows(const CUtensorMap* map, uint32_t s,
                                           int r0, int head, int b) {
  using T = WTile<D>;
#pragma unroll
  for (int x = 0; x < T::BOXES; ++x)
    tma_store(map, s + x * R * T::ROWB, x * T::SPAN, r0, head, b);
}

// Ping-pong: the two consumers take turns to issue their products (named
// barriers 3 and 4), so that one's softmax runs while the other's products
// hold the tensor cores (the forward's scheme).  Both take `turns` turns,
// a consumer with fewer products passing its last ones idle (finish);
// consumer 1 lets consumer 0 go first and passes no turn after its last,
// so that every arrival meets a wait.
struct PingPong {
  int c, turn, turns;
  __device__ __forceinline__ PingPong(int c_, int turns_)
      : c(c_), turn(0), turns(turns_) {
    if (c == 1 && turns > 0)
      asm volatile("bar.arrive 3, %0;\n" ::"n"(2 * WG) : "memory");
  }
  __device__ __forceinline__ void take() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(3 + c), "n"(2 * WG) : "memory");
  }
  __device__ __forceinline__ void pass() {
    if (++turn < turns || c == 0)
      asm volatile("bar.arrive %0, %1;\n" ::"r"(4 - c), "n"(2 * WG)
                   : "memory");
  }
  __device__ __forceinline__ void finish() {
    while (turn < turns) {
      take();
      pass();
    }
  }
};

__device__ __forceinline__ void consumer_sync(int c) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "n"(WG) : "memory");
}

// dQ pass: a CTA per (b*H + h, 128 q rows, reversed).  Maps: q, k, v, o,
// do, dq.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
bwd_wgmma_dq_kernel(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv,
                    const __grid_constant__ CUtensorMap mo,
                    const __grid_constant__ CUtensorMap mdo,
                    const __grid_constant__ CUtensorMap mdq, const Args p,
                    const Shape a) {
  using T = WTile<D>;
  constexpr int BK = T::BK, ROWB = T::ROWB;
  constexpr int Q_BYTES = BM * D * 2, KV_BYTES = BK * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sdO = sQ + Q_BYTES, sO = sdO + Q_BYTES;
  const uint32_t sK = sO + Q_BYTES;                  // STAGES tiles
  const uint32_t sV = sK + STAGES * KV_BYTES;        // STAGES tiles
  const uint32_t bars = sV + STAGES * KV_BYTES;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, kh = h / a.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  // warp-uniform (a shuffle), so that ptxas sees the consumers' control
  // flow as uniform and keeps their products asynchronous
  const int wg = __shfl_sync(FULL, threadIdx.x / WG, 0);
  int lo, hi;
  kv_range<BM, BK>(a, q0, lo, hi);

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bars, 3 * Q_BYTES);
      load_tile<D, BM>(sQ, &mq, q0, h, b, bars);
      load_tile<D, BM>(sdO, &mdo, q0, h, b, bars);
      load_tile<D, BM>(sO, &mo, q0, h, b, bars);
      int s = 0;
      uint32_t phase = 0;
      for (int k0 = lo; k0 < hi; k0 += BK) {
        mbar_wait(empty(s), phase ^ 1);   // passes at once on the first lap
        mbar_expect_tx(full(s), 2 * KV_BYTES);
        load_tile<D, BK>(sK + s * KV_BYTES, &mk, k0, kh, b, full(s));
        load_tile<D, BK>(sV + s * KV_BYTES, &mv, k0, kh, b, full(s));
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1, tid = threadIdx.x % WG;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;      // fragment coordinates
    const int r0 = q0 + 64 * c;                // this consumer's first row
    const int row_a = r0 + 16 * warp + g, row_b = row_a + 8;
    const uint32_t sQc = sQ + 64 * c * ROWB;
    mbar_wait(bars, 0);

    // D of rows row_a and row_b: the quad's 4 threads take every 4th
    // 16-byte chunk of each row, then add across the quad
    float d_a = 0.f, d_b = 0.f;
#pragma unroll
    for (int i = 0; i < (D / 8 + 3) / 4; ++i) {
      const int ch = t + 4 * i;
      if (ch < D / 8) {
        const uint32_t ra = swizzled<D, BM>(64 * c + 16 * warp + g, 8 * ch);
        const uint32_t rb = swizzled<D, BM>(64 * c + 16 * warp + g + 8, 8 * ch);
        d_a = dot8(sdO + ra, sO + ra, d_a);
        d_b = dot8(sdO + rb, sO + rb, d_b);
      }
    }
    d_a = quad_sum(d_a);
    d_b = quad_sum(d_b);
    const float* lp = p.lse + static_cast<long long>(bh) * a.Sq;
    const float l_a = row_a < a.Sq ? lp[row_a] * LOG2E : -NEG_INF;
    const float l_b = row_b < a.Sq ? lp[row_b] * LOG2E : -NEG_INF;
    if (t == 0) {
      const long long at = static_cast<long long>(bh) * p.pad;
      p.dsum[at + row_a] = d_a;
      p.dsum[at + row_b] = d_b;
      p.lse2[at + row_a] = l_a;
      p.lse2[at + row_b] = l_b;
    }

    const float scale2 = a.scale * LOG2E;
    const uint32_t sdOc = sdO + 64 * c * ROWB;
    // P, then dS = P o (dP - D), of the tile from k0 in place in sc;
    // element (j, e): row e < 2 ? row_a : row_b, key k0 + 8 j + 2 t + e % 2
    auto p_ds = [&](float (&sc)[BK / 2], const float (&dp)[BK / 2], int k0) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        sc[i] = exp2_ftz(sc[i] * scale2 - (i & 2 ? l_b : l_a));
      if (block_needs_mask(a, r0, 64, k0, BK)) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!allowed(a, e < 2 ? row_a : row_b,
                         k0 + 8 * j + 2 * t + (e & 1)))
              sc[4 * j + e] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        sc[i] *= dp[i] - (i & 2 ? d_b : d_a);
    };
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    // Each step issues S and dP of its tile with dQ += dS K of the tile
    // before, so the tensor cores run that product during this softmax;
    // the first tile's S and dP and the last tile's dQ stand alone (no
    // wait depends on a branch inside the loop, so ptxas keeps the
    // products asynchronous).
    uint32_t ds[BK / 16][4];                   // dS of the tile before
    const int tiles = lo < hi ? (hi - lo + BK - 1) / BK : 0;
    PingPong pp(c, tiles > 0 ? tiles + 1 : 0);
    if (tiles > 0) {
      float sc[BK / 2], dp[BK / 2];
      mbar_wait(full(0), 0);
      pp.take();
      wgmma_fence();
      issue_ss<D, BM, BK>(sc, sQc, sK);
      issue_ss<D, BM, BK>(dp, sdOc, sV);
      wgmma_commit();
      pp.pass();
      wgmma_wait<0>();
      hold(sc);
      hold(dp);
      p_ds(sc, dp, lo);
      to_frags<BK>(ds, sc);
    }
    for (int n = 1; n < tiles; ++n) {
      const int s = n % STAGES, sp = (n - 1) % STAGES;
      float sc[BK / 2], dp[BK / 2];
      mbar_wait(full(s), (n / STAGES) & 1);
      pp.take();
      wgmma_fence();
      issue_ss<D, BM, BK>(sc, sQc, sK + s * KV_BYTES);
      issue_ss<D, BM, BK>(dp, sdOc, sV + s * KV_BYTES);
      wgmma_commit();
      issue_rs<D, BK>(dq, ds, sK + sp * KV_BYTES);
      wgmma_commit();
      pp.pass();
      wgmma_wait<1>();                         // S and dP are done
      hold(sc);
      hold(dp);
      p_ds(sc, dp, lo + n * BK);
      wgmma_wait<0>();                         // dQ of the tile before
      hold(dq);
      hold(ds);
      mbar_arrive(empty(sp));
      to_frags<BK>(ds, sc);
    }
    if (tiles > 0) {                           // dQ of the last tile
      const int sp = (tiles - 1) % STAGES;
      pp.take();
      wgmma_fence();
      issue_rs<D, BK>(dq, ds, sK + sp * KV_BYTES);
      wgmma_commit();
      pp.pass();
      wgmma_wait<0>();
      hold(dq);
      hold(ds);
      mbar_arrive(empty(sp));
    }

    // epilogue: dQ d^-0.5 in bf16 into this consumer's Q rows, then TMA
    consumer_sync(c);
    stash<D, BM>(sQc, dq, a.scale, warp, g, t);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_sync(c);
    if (tid == 0 && r0 < a.Sq) {
      store_rows<D, BM>(&mdq, sQc, r0, h, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// Thread-block clusters: this CTA's rank, a barrier over every thread of
// the cluster, another CTA's shared address, and stores and mbarrier
// arrivals there (release at cluster scope, acquired by wait_cluster)
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t map_to(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_remote(uint32_t addr, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(x)
               : "memory");
}

__device__ __forceinline__ void arrive_remote(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          bar)
      : "memory");
}

__device__ __forceinline__ void wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// dK/dV pass: a CTA per (b*K + kh, RK KV rows), in one of two forms the
// launcher picks by the grid's size.
// * RK = 128: each consumer takes 64 KV rows through every step.
// * PAIR (RK = 64, where 128-row CTAs would leave SMs idle): a cluster of
//   two CTAs over the same 64 KV rows, rank r taking every head's q blocks
//   j = r, r + 2, ...; in each, both consumers take the 64 KV rows,
//   consumer c the steps of parity c.  Consumer 0 adds consumer 1's sums
//   to its own, then rank 0 adds rank 1's to its own through distributed
//   shared memory: a fixed order.  Each CTA sums all G query heads of its
//   q blocks.
// Maps: q, k, v, do, dk, dv.
template <int D, bool PAIR>
__global__ void __launch_bounds__(WG_THREADS, 1)
bwd_wgmma_dkv_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     const __grid_constant__ CUtensorMap mdo,
                     const __grid_constant__ CUtensorMap mdk,
                     const __grid_constant__ CUtensorMap mdv, const Args p,
                     const Shape a) {
  using T = WTile<D>;
  constexpr int CL = PAIR ? 2 : 1;             // CTAs of a cluster
  constexpr int ROWB = T::ROWB, RK = PAIR ? 64 : BM;
  constexpr int KV_BYTES = RK * D * 2, TILE = BQS * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base, sV = sK + KV_BYTES;
  const uint32_t sQ = sV + KV_BYTES;                 // STAGES tiles
  const uint32_t sdO = sQ + STAGES * TILE;           // STAGES tiles
  const uint32_t sL = sdO + STAGES * TILE;           // STAGES x BQS floats
  const uint32_t sD = sL + STAGES * BQS * 4;         // STAGES x BQS floats
  const uint32_t bars = sD + STAGES * BQS * 4;
  const float* gL = reinterpret_cast<const float*>(smem_raw + (sL - raw));
  const float* gD = reinterpret_cast<const float*>(smem_raw + (sD - raw));
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  // the pair's epilogue: rank 0's ring is free for rank 1's sums; they
  // have arrived
  const uint32_t free_bar = bars + 8 * (1 + 2 * STAGES), done_bar = free_bar + 8;

  const int KH = a.H / a.group;
  const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
  const int rank = PAIR ? cluster_rank() : 0;
  const int k0 = blockIdx.y / CL * RK;
  // warp-uniform (a shuffle), so that ptxas sees the consumers' control
  // flow as uniform and keeps their products asynchronous
  const int wg = __shfl_sync(FULL, threadIdx.x / WG, 0);
  int lo, hi;
  q_range<RK, BQS>(a, k0, lo, hi);
  // this CTA's q blocks of a head: j = rank + CL i, i < per
  const int blocks = lo < hi ? (hi - lo + BQS - 1) / BQS : 0;
  const int per = (blocks - rank + CL - 1) / CL;
  const int steps = a.group * per;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), PAIR ? WG : 2 * WG);
    }
    mbar_init(free_bar, 1);
    mbar_init(done_bar, WG);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (PAIR) cluster_sync();      // both CTAs' barriers are set

  if (wg == 0) {
    // ---- producer: K and V once, then Q, dO, lse and D in a ring ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bars, 2 * KV_BYTES);
      load_tile<D, RK>(sK, &mk, k0, kh, b, bars);
      load_tile<D, RK>(sV, &mv, k0, kh, b, bars);
      // step n: head kh G + n / per, q rows lo + (rank + CL (n % per)) BQS
      for (int n = 0; n < steps; ++n) {
        const int s = n % STAGES, h = kh * a.group + n / per;
        const int q0 = lo + (rank + CL * (n % per)) * BQS;
        const long long row = static_cast<long long>(b * a.H + h) * p.pad;
        mbar_wait(empty(s), ((n / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * TILE + 2 * BQS * 4);
        load_tile<D, BQS>(sQ + s * TILE, &mq, q0, h, b, full(s));
        load_tile<D, BQS>(sdO + s * TILE, &mdo, q0, h, b, full(s));
        bulk_load(sL + s * BQS * 4, p.lse2 + row + q0, BQS * 4, full(s));
        bulk_load(sD + s * BQS * 4, p.dsum + row + q0, BQS * 4, full(s));
      }
    }
  } else {
    // ---- consumers --------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1, tid = threadIdx.x % WG;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int kc = PAIR ? k0 : k0 + 64 * c;   // this consumer's first key
    const int key_a = kc + 16 * warp + g, key_b = key_a + 8;
    const uint32_t sKc = sK + (kc - k0) * ROWB, sVc = sV + (kc - k0) * ROWB;
    const float scale2 = a.scale * LOG2E;
    // P^T, then dS^T = P^T o (dP^T - D), of step n's q block in place;
    // element (j, e): key e < 2 ? key_a : key_b, q row q0 + 8 j + 2 t + e % 2
    auto p_ds = [&](float (&st)[BQS / 2], float (&dpt)[BQS / 2], int n) {
      const int s = n % STAGES, q0 = lo + (rank + CL * (n % per)) * BQS;
      const float* ls = gL + s * BQS + 2 * t;
      const float* dsm = gD + s * BQS + 2 * t;
#pragma unroll
      for (int j = 0; j < BQS / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(ls + 8 * j);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[4 * j + e] =
              exp2_ftz(st[4 * j + e] * scale2 - (e & 1 ? l.y : l.x));
      }
      if (block_needs_mask(a, q0, BQS, kc, 64)) {
#pragma unroll
        for (int j = 0; j < BQS / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!allowed(a, q0 + 8 * j + 2 * t + (e & 1),
                         e < 2 ? key_a : key_b))
              st[4 * j + e] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < BQS / 8; ++j) {
        const float2 dd = *reinterpret_cast<const float2*>(dsm + 8 * j);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * j + e] =
              st[4 * j + e] * (dpt[4 * j + e] - (e & 1 ? dd.y : dd.x));
      }
    };
    // S^T = K Q^T and dP^T = V dO^T of the q block in stage s
    auto issue_s = [&](float (&st)[BQS / 2], float (&dpt)[BQS / 2], int s) {
      issue_ss<D, RK, BQS>(st, sKc, sQ + s * TILE);
      issue_ss<D, RK, BQS>(dpt, sVc, sdO + s * TILE);
    };
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    // dV += P^T dO and dK += dS^T Q of the q block in stage s
    uint32_t pa[BQS / 16][4], da[BQS / 16][4];
    auto issue_g = [&](int s) {
      issue_rs<D, BQS>(dv, pa, sdO + s * TILE);
      issue_rs<D, BQS>(dk, da, sQ + s * TILE);
    };
    mbar_wait(bars, 0);
    const int first = PAIR ? c : 0;
    constexpr int INC = PAIR ? 2 : 1;
    // consumer 0's steps, the most either takes; a turn a step, one more
    // for the last step's dV and dK (two turns a step unpipelined)
    const int most = PAIR ? (steps + 1) / 2 : steps;
    PingPong pp(c, most == 0 ? 0 : T::PIPE_DKV ? most + 1 : 2 * most);
    if constexpr (T::PIPE_DKV) {
      // Each step issues S^T and dP^T with dV and dK of the step before,
      // so the tensor cores run those during this softmax (the dQ pass's
      // order, the first step's and the last step's products alone)
      if (first < steps) {
        float st[BQS / 2], dpt[BQS / 2];
        mbar_wait(full(first % STAGES), (first / STAGES) & 1);
        pp.take();
        wgmma_fence();
        issue_s(st, dpt, first % STAGES);
        wgmma_commit();
        pp.pass();
        wgmma_wait<0>();
        hold(st);
        hold(dpt);
        p_ds(st, dpt, first);
        to_frags<BQS>(pa, st);
        to_frags<BQS>(da, dpt);
      }
      for (int n = first + INC; n < steps; n += INC) {
        const int s = n % STAGES, sp = (n - INC) % STAGES;
        float st[BQS / 2], dpt[BQS / 2];
        mbar_wait(full(s), (n / STAGES) & 1);
        pp.take();
        wgmma_fence();
        issue_s(st, dpt, s);
        wgmma_commit();
        issue_g(sp);
        wgmma_commit();
        pp.pass();
        wgmma_wait<1>();
        hold(st);
        hold(dpt);
        p_ds(st, dpt, n);
        wgmma_wait<0>();
        hold(dv);
        hold(dk);
        hold(pa);
        hold(da);
        mbar_arrive(empty(sp));
        to_frags<BQS>(pa, st);
        to_frags<BQS>(da, dpt);
      }
      if (first < steps) {
        const int sp = (first + (steps - 1 - first) / INC * INC) % STAGES;
        pp.take();
        wgmma_fence();
        issue_g(sp);
        wgmma_commit();
        pp.pass();
        wgmma_wait<0>();
        hold(dv);
        hold(dk);
        hold(pa);
        hold(da);
        mbar_arrive(empty(sp));
      }
    } else {
      // at d = 128 the registers hold one step at a time
      for (int n = first; n < steps; n += INC) {
        const int s = n % STAGES;
        float st[BQS / 2], dpt[BQS / 2];
        mbar_wait(full(s), (n / STAGES) & 1);
        pp.take();
        wgmma_fence();
        issue_s(st, dpt, s);
        wgmma_commit();
        pp.pass();
        wgmma_wait<0>();
        hold(st);
        hold(dpt);
        p_ds(st, dpt, n);
        to_frags<BQS>(pa, st);
        to_frags<BQS>(da, dpt);
        pp.take();
        wgmma_fence();
        issue_g(s);
        wgmma_commit();
        pp.pass();
        wgmma_wait<0>();
        hold(dv);
        hold(dk);
        hold(pa);
        hold(da);
        mbar_arrive(empty(s));
      }
    }

    pp.finish();

    if constexpr (PAIR) {
      // consumer 1's sums through the (spent) ring, thread by thread in
      // the fragment layout, into consumer 0's: dK = dK_0 + dK_1
      float* buf = reinterpret_cast<float*>(smem_raw + (sQ - raw));
      asm volatile("bar.sync 5, %0;\n" ::"n"(2 * WG) : "memory");
      if (c == 1) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
          buf[i * WG + tid] = dk[i];
          buf[(D / 2 + i) * WG + tid] = dv[i];
        }
      }
      asm volatile("bar.sync 5, %0;\n" ::"n"(2 * WG) : "memory");
      if (c == 1) return;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        dk[i] += buf[i * WG + tid];
        dv[i] += buf[(D / 2 + i) * WG + tid];
      }
      // rank 1's sums into rank 0's spent ring, beside buf, then
      // dK = dK_0 + dK_1
      if (rank == 0) {
        if (tid == 0) arrive_remote(map_to(free_bar, 1));
        wait_cluster(done_bar, 0);
        const float* got = buf + D * WG;
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
          dk[i] += got[i * WG + tid];
          dv[i] += got[(D / 2 + i) * WG + tid];
        }
      } else {
        wait_cluster(free_bar, 0);
        const uint32_t to = map_to(sQ + D * WG * 4, 0);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) {
          st_remote(to + (i * WG + tid) * 4, dk[i]);
          st_remote(to + ((D / 2 + i) * WG + tid) * 4, dv[i]);
        }
        arrive_remote(map_to(done_bar, 0));
        return;
      }
    }
    // epilogue: dK d^-0.5 and dV in bf16 into this consumer's K and V
    // rows, then TMA
    consumer_sync(c);
    stash<D, RK>(sKc, dk, a.scale, warp, g, t);
    stash<D, RK>(sVc, dv, 1.f, warp, g, t);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_sync(c);
    if (tid == 0 && kc < a.Sk) {
      store_rows<D, RK>(&mdk, sKc, kc, kh, b);
      store_rows<D, RK>(&mdv, sVc, kc, kh, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// ---------------------------------------------------------------------------
// f32 math on the CUDA cores: f32 at every d, bf16 at d = 256
// ---------------------------------------------------------------------------

template <int D>
struct CoreTile {
  static constexpr int TPR = D >= 32 ? D / 32 : 1;  // threads a row
  static constexpr int DH = D / TPR;                // elements a thread
  static constexpr int THREADS = BQ * TPR;
  static constexpr int SUB = D == 256 ? 16 : 32;    // rows a shared tile
};

// rows [r0, r0 + SUB) of a [*, D] matrix of T into f32 shared memory; rows
// at or past nrows are zero
template <typename T, int D>
__device__ __forceinline__ void load_f32(float* dst, const T* src,
                                         long long stride, int r0,
                                         int nrows) {
  using C = CoreTile<D>;
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < C::SUB * CH; i += C::THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r0 + r < nrows)
      load8<T>(x, src + static_cast<long long>(r0 + r) * stride + c);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[r * D + c + e] = x[e];
  }
}

// this thread's DH elements (TPR i + part) of row `row`, 0 past nrows
template <typename T, int D>
__device__ __forceinline__ void load_mine(float (&x)[CoreTile<D>::DH],
                                          const T* base, long long stride,
                                          int row, int nrows, int part) {
  constexpr int TPR = CoreTile<D>::TPR;
#pragma unroll
  for (int i = 0; i < CoreTile<D>::DH; ++i)
    x[i] = row < nrows ? to_f32<T>(base[static_cast<long long>(row) * stride +
                                        TPR * i + part])
                       : 0.f;
}

template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int m = 1; m < TPR; m *= 2) x += __shfl_xor_sync(FULL, x, m);
  return x;
}

// dQ pass on the CUDA cores.  Grid (q blocks, B * H).
template <typename T, int D>
__global__ void __launch_bounds__(CoreTile<D>::THREADS)
bwd_core_dq_kernel(const Args p, const Shape a) {
  using C = CoreTile<D>;
  constexpr int TPR = C::TPR, DH = C::DH, SUB = C::SUB;
  __shared__ __align__(16) float sK[SUB * D];
  __shared__ __align__(16) float sV[SUB * D];
  __shared__ float sD[BQ];
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, kh = h / a.group;
  const int part = threadIdx.x % TPR, row = q0 + threadIdx.x / TPR;
  const T* qp = static_cast<const T*>(p.q) + b * p.st[Q_][0] + h * p.st[Q_][1];
  const T* dop = static_cast<const T*>(p.dout) + b * p.st[DO_][0] +
                 h * p.st[DO_][1];
  const T* kp = static_cast<const T*>(p.k) + b * p.st[K_][0] +
                kh * p.st[K_][1];
  const T* vp = static_cast<const T*>(p.v) + b * p.st[V_][0] +
                kh * p.st[V_][1];
  row_dsum<T, D>(p, a, b, h, q0, C::THREADS, sD);
  float q[DH], dO[DH], dq[DH];
  load_mine<T, D>(q, qp, p.st[Q_][2], row, a.Sq, part);
  load_mine<T, D>(dO, dop, p.st[DO_][2], row, a.Sq, part);
#pragma unroll
  for (int i = 0; i < DH; ++i) dq[i] = 0.f;
  __syncthreads();
  const float lse = row < a.Sq
      ? p.lse[static_cast<long long>(bh) * a.Sq + row] : -NEG_INF;
  const float dd = sD[threadIdx.x / TPR];

  int lo, hi;
  kv_range<BQ, 64>(a, q0, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += SUB) {
    load_f32<T, D>(sK, kp, p.st[K_][2], k0, a.Sk);
    load_f32<T, D>(sV, vp, p.st[V_][2], k0, a.Sk);
    __syncthreads();
    for (int j = 0; j < SUB; ++j) {
      const float* kr = &sK[j * D + part];
      const float* vr = &sV[j * D + part];
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        s = fmaf(q[i], kr[TPR * i], s);
        dp = fmaf(dO[i], vr[TPR * i], dp);
      }
      s = row_sum<TPR>(s);
      dp = row_sum<TPR>(dp);
      const float pe = allowed(a, row, k0 + j) ? expf(s * a.scale - lse)
                                               : 0.f;
      const float ds = pe * (dp - dd);
#pragma unroll
      for (int i = 0; i < DH; ++i) dq[i] = fmaf(ds, kr[TPR * i], dq[i]);
    }
    __syncthreads();
  }
  if (row < a.Sq) {
    T* out = static_cast<T*>(p.dq) +
             (static_cast<long long>(bh) * a.Sq + row) * D + part;
#pragma unroll
    for (int i = 0; i < DH; ++i) out[TPR * i] = from_f32<T>(dq[i] * a.scale);
  }
}

// dK/dV pass on the CUDA cores.  Grid (KV tiles, B * K).
template <typename T, int D>
__global__ void __launch_bounds__(CoreTile<D>::THREADS)
bwd_core_dkv_kernel(const Args p, const Shape a) {
  using C = CoreTile<D>;
  constexpr int TPR = C::TPR, DH = C::DH, SUB = C::SUB;
  __shared__ __align__(16) float sQ[SUB * D];
  __shared__ __align__(16) float sO[SUB * D];    // dO rows
  __shared__ float sL[SUB], sD[SUB];
  const int k0 = blockIdx.x * BQ;
  const int bk = blockIdx.y, KH = a.H / a.group, b = bk / KH, kh = bk % KH;
  const int part = threadIdx.x % TPR, key = k0 + threadIdx.x / TPR;
  float k[DH], v[DH], dk[DH], dv[DH];
  load_mine<T, D>(k, static_cast<const T*>(p.k) + b * p.st[K_][0] +
                         kh * p.st[K_][1], p.st[K_][2], key, a.Sk, part);
  load_mine<T, D>(v, static_cast<const T*>(p.v) + b * p.st[V_][0] +
                         kh * p.st[V_][1], p.st[V_][2], key, a.Sk, part);
#pragma unroll
  for (int i = 0; i < DH; ++i) dk[i] = dv[i] = 0.f;

  int lo, hi;
  q_range<BQ, BQ>(a, k0, lo, hi);
  for (int gi = 0; gi < a.group; ++gi) {
    const int h = kh * a.group + gi, bh = b * a.H + h;
    const T* qp = static_cast<const T*>(p.q) + b * p.st[Q_][0] +
                  h * p.st[Q_][1];
    const T* dop = static_cast<const T*>(p.dout) + b * p.st[DO_][0] +
                   h * p.st[DO_][1];
    for (int q0 = lo; q0 < hi; q0 += SUB) {
      load_f32<T, D>(sQ, qp, p.st[Q_][2], q0, a.Sq);
      load_f32<T, D>(sO, dop, p.st[DO_][2], q0, a.Sq);
      for (int i = threadIdx.x; i < SUB; i += C::THREADS) {
        const bool in = q0 + i < a.Sq;
        const long long at = static_cast<long long>(bh) * a.Sq + q0 + i;
        sL[i] = in ? p.lse[at] : -NEG_INF;
        sD[i] = in ? p.dsum[at] : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < SUB; ++j) {
        const float* qr = &sQ[j * D + part];
        const float* dr = &sO[j * D + part];
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int i = 0; i < DH; ++i) {
          s = fmaf(k[i], qr[TPR * i], s);
          dp = fmaf(v[i], dr[TPR * i], dp);
        }
        s = row_sum<TPR>(s);
        dp = row_sum<TPR>(dp);
        const float pe = allowed(a, q0 + j, key) ? expf(s * a.scale - sL[j])
                                                 : 0.f;
        const float ds = pe * (dp - sD[j]);
#pragma unroll
        for (int i = 0; i < DH; ++i) {
          dv[i] = fmaf(pe, dr[TPR * i], dv[i]);
          dk[i] = fmaf(ds, qr[TPR * i], dk[i]);
        }
      }
      __syncthreads();
    }
  }
  if (key < a.Sk) {
    const long long o = (static_cast<long long>(bk) * a.Sk + key) * D + part;
    T* dkp = static_cast<T*>(p.dk) + o;
    T* dvp = static_cast<T*>(p.dv) + o;
#pragma unroll
    for (int i = 0; i < DH; ++i) {
      dkp[TPR * i] = from_f32<T>(dk[i] * a.scale);
      dvp[TPR * i] = from_f32<T>(dv[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// returned for map i (MAP_REFUSED - i) where the kernels or the driver
// refuse a tensor-map row
constexpr int MAP_REFUSED = -100;

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int D, bool PAIR>
int launch_dkv(const CUtensorMap (&m)[8], const Args& p, const Shape& a,
               int B, cudaStream_t s) {
  constexpr int RK = PAIR ? 64 : BM, CL = PAIR ? 2 : 1;
  const int err =
      set_smem(bwd_wgmma_dkv_kernel<D, PAIR>, WTile<D>::DKV_SMEM);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * (a.H / a.group), CL * ((a.Sk + RK - 1) / RK));
  cfg.blockDim = dim3(WG_THREADS);
  cfg.dynamicSmemBytes = WTile<D>::DKV_SMEM;
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = CL;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = PAIR ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, bwd_wgmma_dkv_kernel<D, PAIR>, m[0], m[1], m[2], m[4], m[6], m[7],
      p, a));
}

// maps: 8 rows (q, k, v, o, do, dq, dk, dv) of the wrapper's tensor-map
// table, each with boxes of 64 rows.  The dK/dV pass takes its PAIR form
// where 128-row CTAs would leave SMs idle.
template <int D>
int launch_wgmma(const Args& p, const Shape& a, int B, const long long* maps,
                 cudaStream_t s) {
  using T = WTile<D>;
  int err = static_cast<int>(bind_context());
  if (err) return err;
  const void* ptrs[8] = {p.q, p.k, p.v, p.o, p.dout, p.dq, p.dk, p.dv};
  CUtensorMap m[8];
  for (int i = 0; i < 8; ++i)
    if (!encode(&m[i], ptrs[i], maps + i * MAP_FIELDS, 64, T::SPAN))
      return MAP_REFUSED - i;
  int dev = 0, sms = 0;
  err = static_cast<int>(cudaGetDevice(&dev));
  if (err) return err;
  err = static_cast<int>(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err) return err;
  err = set_smem(bwd_wgmma_dq_kernel<D>, T::DQ_SMEM);
  if (err) return err;
  bwd_wgmma_dq_kernel<D><<<dim3(B * a.H, (a.Sq + BM - 1) / BM), WG_THREADS,
                           T::DQ_SMEM, s>>>(m[0], m[1], m[2], m[3], m[4],
                                            m[5], p, a);
  const long long ctas =
      static_cast<long long>(B) * (a.H / a.group) * ((a.Sk + BM - 1) / BM);
  err = ctas < sms ? launch_dkv<D, true>(m, p, a, B, s)
                   : launch_dkv<D, false>(m, p, a, B, s);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_core(const Args& p, const Shape& a, int B, cudaStream_t s) {
  const int KH = a.H / a.group;
  constexpr int THREADS = CoreTile<D>::THREADS;
  bwd_core_dq_kernel<T, D><<<dim3((a.Sq + BQ - 1) / BQ, B * a.H), THREADS, 0,
                             s>>>(p, a);
  bwd_core_dkv_kernel<T, D><<<dim3((a.Sk + BQ - 1) / BQ, B * KH), THREADS,
                              0, s>>>(p, a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const Args& p, const Shape& a, int B,
           const long long* maps, cudaStream_t s) {
  if (dtype == 0) return launch_core<float, D>(p, a, B, s);
  if constexpr (D == 256) return launch_core<__nv_bfloat16, D>(p, a, B, s);
  else return launch_wgmma<D>(p, a, B, maps, s);
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (q, k, v, o, do and the gradients alike).
// strides: 5 rows (q, k, v, o, do) of the element strides of dims b, h, s;
// the last dim is contiguous and every row starts 16-byte aligned.  maps:
// 8 rows (q, k, v, o, do, dq, dk, dv) of MAP_FIELDS int64 each, from the
// wrapper's tensor-map helper with boxes of 64 rows (read by the bf16
// kernels at d <= 128).  lse: f32 [B, H, Sq] from the forward (natural
// units); dsum: f32 scratch of 2 B H pad values, pad = Sq rounded up to a
// multiple of 128.  dq [B, H, Sq, D], dk and dv [B, KH, Sk, D],
// contiguous.  prefix: P of the prefix-LM mask (0 = none; ignored unless
// causal).  scale: d^-0.5.  Returns cudaGetLastError() after the two
// launches, cudaErrorInvalidValue for a head dimension without an
// instantiation, or MAP_REFUSED - i where the kernels or the driver refuse
// map row i.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* dsum, void* dq,
                               void* dk, void* dv, int dtype, int B, int H,
                               int KH, int Sq, int Sk, int D,
                               const long long* strides,
                               const long long* maps, int causal,
                               int window, int prefix, float scale,
                               void* stream) {
  Shape a;
  a.H = H;
  a.group = H / KH;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.window = window;
  a.prefix = causal ? prefix : 0;
  a.scale = scale;
  Args p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.pad = (Sq + BM - 1) / BM * BM;
  p.dsum = static_cast<float*>(dsum);
  p.lse2 = p.dsum + static_cast<long long>(B) * H * p.pad;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  const auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(dtype, p, a, B, maps, s);
    case 32: return launch<32>(dtype, p, a, B, maps, s);
    case 64: return launch<64>(dtype, p, a, B, maps, s);
    case 128: return launch<128>(dtype, p, a, B, maps, s);
    case 256: return launch<256>(dtype, p, a, B, maps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
