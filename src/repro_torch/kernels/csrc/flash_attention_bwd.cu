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
// * the dQ pass: a CTA per (b*H + h, 64-row q block) over the KV tiles
//   [lo, hi) the forward's q block walks (kv_range); it first writes D of
//   its rows, which the second pass reads;
// * the dK/dV pass: a CTA per (b*K + kh, 64-row KV tile), looping in a
//   fixed order over the G query heads of KV head kh and over the q
//   blocks [lo, hi) that see the tile (q_range, the transpose of
//   kv_range).  The GQA sum over the G heads is made in the CTA's
//   registers, so no pass uses atomics and a step is deterministic.
// The per-element mask runs only on the blocks the mask's edges cross
// (block_needs_mask, the forward's tile_needs_mask for any rows x cols);
// rows past Sq carry lse = +1e30 and D = 0, so their P is 0 without one.
//
// bf16 at d = 16, 32, 64, 128 (bwd_mma_*): mma.sync m16n8k16 with f32
// accumulators, four warps of 16 rows a CTA.  The operands stream through
// padded shared-memory tiles (rows of d + 8 elements, conflict-free 32-bit
// fragment loads); the B operands that are stored k-major (dO and Q in
// the dK/dV pass, K in the dQ pass) are read with ldmatrix.trans.  P^T and
// dS are rounded to bf16 once to feed the next products: the S and dP
// accumulators of two n8 tiles are the A fragment of one k16 step.  The
// softmax recompute is in log2 units, P = 2^(s d^-0.5 log2(e) - lse
// log2(e)) on the SFU, as the forward's bf16 softmax.
// f32 at every d, and bf16 at d = 256 (bwd_core_*): the CUDA cores in f32
// (FMA, expf), a q row (dQ pass) or a KV row (dK/dV pass) to TPR threads
// that hold 32 of its elements each (16 at d = 16).
//
// Bound (llama3.2-1b's training shape: B 4, H 32, K 8, S 1024, d 64,
// bf16, causal): five products of 2 d B H S(S+1)/2 each against the
// forward's two, 2.5 x 17.2 = 43.0 GFLOP, 43.5 us at 989 TFLOP/s.  This
// first kernel is a simple one: no TMA, no wgmma, synchronous tile loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int BQ = 64;          // q rows a dQ CTA; KV rows a dK/dV CTA
constexpr int WARPS = 4;

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
  float* dsum;        // [B * H, Sq]: D, written by the dQ pass
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

// The forward's KV range of the q block from q0 (tiles of BK keys).
template <int BK>
__device__ __forceinline__ void kv_range(const Shape& a, int q0, int& lo,
                                         int& hi) {
  const bool in_prefix = q0 < a.prefix;
  hi = a.causal ? min(a.Sk, in_prefix ? max(q0 + BQ, a.prefix) : q0 + BQ)
                : a.Sk;
  lo = 0;
  if (a.window > 0 && !in_prefix)
    lo = (max(0, q0 - (a.window - 1)) / BK) * BK;
}

// The q rows [lo, hi) that see the KV tile [k0, k0 + BK), lo rounded down
// to a q block (kernels/flash_attention.py _q_range).
template <int BK>
__device__ __forceinline__ void q_range(const Shape& a, int k0, int& lo,
                                        int& hi) {
  const int kmax = min(k0 + BK, a.Sk) - 1;
  const bool in_prefix = k0 < a.prefix;
  lo = a.causal && !in_prefix ? k0 : 0;
  hi = a.Sq;
  if (a.window > 0)
    hi = min(a.Sq, in_prefix ? max(a.prefix, kmax + a.window)
                             : kmax + a.window);
  lo = (lo / BQ) * BQ;
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
// bf16 on the tensor cores: mma.sync m16n8k16
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// B fragments of two n8 tiles (columns n0 and n0 + 8) of a k16 step from a
// k-major tile (row k, column n): r[0], r[1] for n0, r[2], r[3] for n0 + 8
__device__ __forceinline__ void ldsm_t4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <int D>
struct MmaTile {
  static constexpr int LD = D + 8;              // padded row (elements)
  static constexpr int BK = D == 128 ? 32 : 64; // keys a dQ tile
  static constexpr int BQK = D == 128 ? 32 : 64;  // q rows a dK/dV step
  static constexpr int NT = D / 8;              // n8 tiles across d
};

using bf16 = __nv_bfloat16;

// rows [r0, r0 + R) of a [*, D] bf16 matrix (row stride `stride` elements)
// into a padded shared tile, 16 bytes a thread; rows at or past `nrows`
// are zero
template <int D, int R>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long stride, int r0,
                                          int nrows) {
  constexpr int CH = D / 8, LD = MmaTile<D>::LD;
  for (int i = threadIdx.x; i < R * CH; i += WARPS * 32) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// A fragment (16 rows from r0, k16 step kk) of a padded row-major tile
template <int D>
__device__ __forceinline__ void frag_a(uint32_t (&f)[4], const bf16* s,
                                       int r0, int kk, int g, int t) {
  constexpr int LD = MmaTile<D>::LD;
  const bf16* p = s + (r0 + g) * LD + 16 * kk + 2 * t;
  f[0] = *reinterpret_cast<const uint32_t*>(p);
  f[1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
  f[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  f[3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
}

// B fragment (n8 tile from n0, k16 step kk) where B[k][n] = tile[n][k]
template <int D>
__device__ __forceinline__ void frag_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* s, int n0, int kk, int g,
                                       int t) {
  constexpr int LD = MmaTile<D>::LD;
  const bf16* p = s + (n0 + g) * LD + 16 * kk + 2 * t;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// acc[16 x D] += A[16 x 16 KS] B where A is given as bf16 fragments
// (a[kk]) and B[k][n] = tile[k0 + k][n] is k-major in shared memory
template <int D, int KS>
__device__ __forceinline__ void mma_ak(float (&acc)[D / 8][4],
                                       const uint32_t (&a)[KS][4],
                                       const bf16* tile, int lane) {
  constexpr int LD = MmaTile<D>::LD;
  const int row = (lane & 7) + ((lane >> 3) & 1) * 8, col = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t b[4];
      ldsm_t4(b, smem_addr(tile + (16 * kk + row) * LD + 8 * n + col));
      mma(acc[n], a[kk], b[0], b[1]);
      mma(acc[n + 1], a[kk], b[2], b[3]);
    }
}

// c[16 x 8 NN] = A[16 x D] B where A rows r0.. of tile `sa` and
// B[k][n] = sb[n][k] (both row-major over d)
template <int D, int NN>
__device__ __forceinline__ void mma_rows(float (&c)[NN][4], const bf16* sa,
                                         int r0, const bf16* sb, int g,
                                         int t) {
#pragma unroll
  for (int j = 0; j < NN; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    frag_a<D>(a, sa, r0, kk, g, t);
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      uint32_t b0, b1;
      frag_b<D>(b0, b1, sb, 8 * j, kk, g, t);
      mma(c[j], a, b0, b1);
    }
  }
}

// The S / dP accumulators of n8 tiles 2 kk and 2 kk + 1 as the bf16 A
// fragment of k16 step kk
template <int NN>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[NN / 2][4],
                                       const float (&c)[NN][4]) {
#pragma unroll
  for (int kk = 0; kk < NN / 2; ++kk) {
    a[kk][0] = pack2(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack2(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

template <int D>
struct MmaDqSmem {
  static constexpr int LD = MmaTile<D>::LD, BK = MmaTile<D>::BK;
  bf16 q[BQ * LD], dO[BQ * LD], k[BK * LD], v[BK * LD];
  float dsum[BQ];
};

// dQ pass, bf16 on the tensor cores.  Grid (q blocks, B * H).
template <int D>
__global__ void __launch_bounds__(WARPS * 32)
bwd_mma_dq_kernel(const Args p, const Shape a) {
  using T = MmaTile<D>;
  constexpr int BK = T::BK, NN = BK / 8, NT = T::NT;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  MmaDqSmem<D>& sm = *reinterpret_cast<MmaDqSmem<D>*>(smem_raw);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, kh = h / a.group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp;                  // this warp's rows in the block
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.st[Q_][0] +
                   h * p.st[Q_][1];
  const bf16* dop = static_cast<const bf16*>(p.dout) + b * p.st[DO_][0] +
                    h * p.st[DO_][1];
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.st[K_][0] +
                   kh * p.st[K_][1];
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.st[V_][0] +
                   kh * p.st[V_][1];

  load_rows<D, BQ>(sm.q, qp, p.st[Q_][2], q0, a.Sq);
  load_rows<D, BQ>(sm.dO, dop, p.st[DO_][2], q0, a.Sq);
  row_dsum<bf16, D>(p, a, b, h, q0, WARPS * 32, sm.dsum);
  __syncthreads();
  const int row_a = q0 + r0 + g, row_b = row_a + 8;
  const float* lp = p.lse + static_cast<long long>(bh) * a.Sq;
  const float lse_a = row_a < a.Sq ? lp[row_a] * LOG2E : -NEG_INF;
  const float lse_b = row_b < a.Sq ? lp[row_b] * LOG2E : -NEG_INF;
  const float dd_a = sm.dsum[r0 + g], dd_b = sm.dsum[r0 + g + 8];
  const float scale2 = a.scale * LOG2E;

  float dq[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  int lo, hi;
  kv_range<BK>(a, q0, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += BK) {
    load_rows<D, BK>(sm.k, kp, p.st[K_][2], k0, a.Sk);
    load_rows<D, BK>(sm.v, vp, p.st[V_][2], k0, a.Sk);
    __syncthreads();
    float s[NN][4], dp[NN][4];
    mma_rows<D, NN>(s, sm.q, r0, sm.k, g, t);
    mma_rows<D, NN>(dp, sm.dO, r0, sm.v, g, t);
    const bool masked = block_needs_mask(a, q0 + r0, 16, k0, BK);
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row_a : row_b;
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const float pe = (!masked || allowed(a, row, col))
                             ? exp2_ftz(s[j][e] * scale2 -
                                        (e < 2 ? lse_a : lse_b))
                             : 0.f;
        s[j][e] = pe * (dp[j][e] - (e < 2 ? dd_a : dd_b));   // dS
      }
    uint32_t ds[NN / 2][4];
    c_to_a<NN>(ds, s);
    mma_ak<D, NN / 2>(dq, ds, sm.k, lane);
    __syncthreads();
  }
  bf16* out = static_cast<bf16*>(p.dq) + static_cast<long long>(bh) * a.Sq * D;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = 8 * j + 2 * t;
    if (row_a < a.Sq)
      *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row_a) * D +
                                   col) =
          pack2(dq[j][0] * a.scale, dq[j][1] * a.scale);
    if (row_b < a.Sq)
      *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row_b) * D +
                                   col) =
          pack2(dq[j][2] * a.scale, dq[j][3] * a.scale);
  }
}

template <int D>
struct MmaDkvSmem {
  static constexpr int LD = MmaTile<D>::LD, BQK = MmaTile<D>::BQK;
  bf16 k[BQ * LD], v[BQ * LD], q[BQK * LD], dO[BQK * LD];
  float lse[BQK], dsum[BQK];
};

// dK/dV pass, bf16 on the tensor cores.  Grid (KV tiles, B * K).
template <int D>
__global__ void __launch_bounds__(WARPS * 32)
bwd_mma_dkv_kernel(const Args p, const Shape a) {
  using T = MmaTile<D>;
  constexpr int BQK = T::BQK, NN = BQK / 8, NT = T::NT;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  MmaDkvSmem<D>& sm = *reinterpret_cast<MmaDkvSmem<D>*>(smem_raw);
  const int k0 = blockIdx.x * BQ;
  const int bk = blockIdx.y, b = bk / (a.H / a.group), kh = bk % (a.H / a.group);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp;                  // this warp's KV rows
  const int key_a = k0 + r0 + g, key_b = key_a + 8;
  load_rows<D, BQ>(sm.k, static_cast<const bf16*>(p.k) + b * p.st[K_][0] +
                             kh * p.st[K_][1], p.st[K_][2], k0, a.Sk);
  load_rows<D, BQ>(sm.v, static_cast<const bf16*>(p.v) + b * p.st[V_][0] +
                             kh * p.st[V_][1], p.st[V_][2], k0, a.Sk);
  const float scale2 = a.scale * LOG2E;

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  int lo, hi;
  q_range<BQ>(a, k0, lo, hi);
  for (int gi = 0; gi < a.group; ++gi) {
    const int h = kh * a.group + gi, bh = b * a.H + h;
    const bf16* qp = static_cast<const bf16*>(p.q) + b * p.st[Q_][0] +
                     h * p.st[Q_][1];
    const bf16* dop = static_cast<const bf16*>(p.dout) + b * p.st[DO_][0] +
                      h * p.st[DO_][1];
    const float* lp = p.lse + static_cast<long long>(bh) * a.Sq;
    const float* dsp = p.dsum + static_cast<long long>(bh) * a.Sq;
    for (int q0 = lo; q0 < hi; q0 += BQK) {
      __syncthreads();                       // the last step's reads are done
      load_rows<D, BQK>(sm.q, qp, p.st[Q_][2], q0, a.Sq);
      load_rows<D, BQK>(sm.dO, dop, p.st[DO_][2], q0, a.Sq);
      for (int i = threadIdx.x; i < BQK; i += WARPS * 32) {
        const bool in = q0 + i < a.Sq;
        sm.lse[i] = in ? lp[q0 + i] * LOG2E : -NEG_INF;
        sm.dsum[i] = in ? dsp[q0 + i] : 0.f;
      }
      __syncthreads();
      // S^T and dP^T: this warp's 16 KV rows against the BQK q rows
      float s[NN][4], dp[NN][4];
      mma_rows<D, NN>(s, sm.k, r0, sm.q, g, t);
      mma_rows<D, NN>(dp, sm.v, r0, sm.dO, g, t);
      const bool masked = block_needs_mask(a, q0, BQK, k0 + r0, 16);
#pragma unroll
      for (int j = 0; j < NN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * t + (e & 1);
          const int key = e < 2 ? key_a : key_b;
          const float pe = (!masked || allowed(a, q0 + qi, key))
                               ? exp2_ftz(s[j][e] * scale2 - sm.lse[qi])
                               : 0.f;
          s[j][e] = pe;                                        // P^T
          dp[j][e] = pe * (dp[j][e] - sm.dsum[qi]);            // dS^T
        }
      uint32_t pa[NN / 2][4], da[NN / 2][4];
      c_to_a<NN>(pa, s);
      c_to_a<NN>(da, dp);
      mma_ak<D, NN / 2>(dv, pa, sm.dO, lane);
      mma_ak<D, NN / 2>(dk, da, sm.q, lane);
    }
  }
  const long long base = static_cast<long long>(bk) * a.Sk * D;
  bf16* dkp = static_cast<bf16*>(p.dk) + base;
  bf16* dvp = static_cast<bf16*>(p.dv) + base;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = 8 * j + 2 * t;
    if (key_a < a.Sk) {
      const long long o = static_cast<long long>(key_a) * D + col;
      *reinterpret_cast<uint32_t*>(dkp + o) =
          pack2(dk[j][0] * a.scale, dk[j][1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvp + o) = pack2(dv[j][0], dv[j][1]);
    }
    if (key_b < a.Sk) {
      const long long o = static_cast<long long>(key_b) * D + col;
      *reinterpret_cast<uint32_t*>(dkp + o) =
          pack2(dk[j][2] * a.scale, dk[j][3] * a.scale);
      *reinterpret_cast<uint32_t*>(dvp + o) = pack2(dv[j][2], dv[j][3]);
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
  kv_range<64>(a, q0, lo, hi);
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
  q_range<BQ>(a, k0, lo, hi);
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

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int D>
int launch_mma(const Args& p, const Shape& a, int B, cudaStream_t s) {
  const int KH = a.H / a.group;
  const int dq_smem = sizeof(MmaDqSmem<D>), dkv_smem = sizeof(MmaDkvSmem<D>);
  int err = set_smem(bwd_mma_dq_kernel<D>, dq_smem);
  if (err) return err;
  err = set_smem(bwd_mma_dkv_kernel<D>, dkv_smem);
  if (err) return err;
  bwd_mma_dq_kernel<D><<<dim3((a.Sq + BQ - 1) / BQ, B * a.H), WARPS * 32,
                         dq_smem, s>>>(p, a);
  bwd_mma_dkv_kernel<D><<<dim3((a.Sk + BQ - 1) / BQ, B * KH), WARPS * 32,
                          dkv_smem, s>>>(p, a);
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
int launch(int dtype, const Args& p, const Shape& a, int B, cudaStream_t s) {
  if (dtype == 0) return launch_core<float, D>(p, a, B, s);
  if constexpr (D == 256) return launch_core<bf16, D>(p, a, B, s);
  else return launch_mma<D>(p, a, B, s);
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (q, k, v, o, do and the gradients alike).
// strides: 5 rows (q, k, v, o, do) of the element strides of dims b, h, s;
// the last dim is contiguous and every row starts 16-byte aligned.  lse:
// f32 [B, H, Sq] from the forward (natural units); dsum: f32 [B, H, Sq]
// scratch.  dq [B, H, Sq, D], dk and dv [B, KH, Sk, D], contiguous.
// prefix: P of the prefix-LM mask (0 = none; ignored unless causal).
// scale: d^-0.5.  Returns cudaGetLastError() after the two launches, or
// cudaErrorInvalidValue for a head dimension without an instantiation.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* dsum, void* dq,
                               void* dk, void* dv, int dtype, int B, int H,
                               int KH, int Sq, int Sk, int D,
                               const long long* strides, int causal,
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
  p.dsum = static_cast<float*>(dsum);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  const auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(dtype, p, a, B, s);
    case 32: return launch<32>(dtype, p, a, B, s);
    case 64: return launch<64>(dtype, p, a, B, s);
    case 128: return launch<128>(dtype, p, a, B, s);
    case 256: return launch<256>(dtype, p, a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
