// Blocked causal / sliding-window GQA attention with an online softmax, for
// Hopper (sm_90a).  Hand-written CUDA C++ with a plain C interface (ctypes).
//
// Replaces: src/repro/kernels/flash_attention.py:77 flash_attention (the
// Pallas TPU kernel, body _flash_kernel).  Same function:
//   out = softmax(mask(q . k^T * d^-0.5)) . v,  head h reads KV head h / (H/K)
//   masked scores = -1e30 (finite, as the reference), kept where
//   cols < Sk, cols <= rows (causal) and rows - cols < window (if given);
//   f32 running max m, denominator l and accumulator; out = acc / max(l, 1e-30)
//   in q's dtype.  Each q block walks only the KV tiles [lo, hi) it needs:
//   hi = min(Sk, q0 + BQ) when causal, lo = floor(max(0, q0 - (window - 1))
//   / BK) * BK with a window.  With the finite sentinel a fully masked first
//   tile adds exp(0) garbage that the next real tile erases exactly
//   (alpha = exp(-1e30 - m) = 0); -INFINITY would give exp(-inf + inf) = NaN.
//
// Bound (llama3.2-1b prefill, the serving path's shape: B 4, H 32, K 8,
// S 1024, d 64, bf16, causal): 4 d B H S(S+1)/2 = 17.2 GFLOP, 17.4 us at
// 989 TFLOP/s, against 41.9 MB moved once, 12.5 us at 3.35 TB/s: the
// operations bound it, so the products go to the tensor cores.
//
// Design (a first kernel that is right, not yet fast):
// * bf16: one CTA of 4 warps per (64-row q block, b*H + h); each warp owns
//   16 q rows.  Q fragments stay in registers for the whole loop.  K and V
//   tiles of 64 rows are staged in shared memory (rows padded by 16 bytes so
//   the fragment reads are free of bank conflicts).  S = Q K^T and O += P V
//   run on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
//   accumulate); the S accumulator fragments become the A fragments of P V
//   in registers.  P is carried as two bf16 parts, hi = bf16(p) and lo =
//   bf16(p - hi), each multiplied by V: a 16-bit mantissa for P, so P V is
//   as accurate as the reference's f32 p @ v.  A single bf16 rounding of P
//   is one rounding the serving path's decode attention does not make, and
//   at llama3.2-1b's width the random-weight model amplifies that one
//   difference into decode logits far from the prefill's by layer 4.
//   Ragged edges are guarded loads (zero-filled rows) and guarded stores;
//   no padding copies.
// * f32: the same tiles and bounds on the CUDA cores (FMA), so that f32
//   stays within 2e-5 of the plain version: two threads per q row, each
//   holding every other element of q and of the accumulator.
// * q blocks are launched in reverse order so the longest causal rows start
//   first.
// wgmma, TMA, cp.async pipelining and warp specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per CTA
constexpr int BK = 64;        // KV rows per tile (the loop bounds' unit)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int SUB32 = 32;     // KV rows per f32 sub-tile (registers)
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;                    // contiguous [B, H, Sq, D]
  long long q_sb, q_sh, q_ss; // element strides; the last dim is contiguous
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int H, group, Sq, Sk, causal, window;  // window 0 = none
  float scale;
};

__device__ __forceinline__ void kv_range(const Args& a, int q0, int& lo,
                                         int& hi) {
  hi = a.causal ? min(a.Sk, q0 + BQ) : a.Sk;
  lo = 0;
  if (a.window > 0) lo = (max(0, q0 - (a.window - 1)) / BK) * BK;
}

__device__ __forceinline__ bool allowed(const Args& a, int row, int col) {
  bool ok = col < a.Sk;
  if (a.causal) ok = ok && col <= row;
  if (a.window > 0) ok = ok && (row - col) < a.window;
  return ok;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 values in one register, the lower column in the low half
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  return pack2(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// x = hi + lo to a 16-bit mantissa: both parts of two values, packed
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  hi = pack2(h0, h1);
  lo = pack2f(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
}

// rows [r0, r0 + 64) of a [*, D] bf16 matrix into shared memory (row stride
// LD), 16 bytes a thread; rows at or past nrows are zero
template <int D, int LD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long stride, int r0,
                                               int nrows) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < BK * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bf16_kernel(const Args a) {
  constexpr int LD = D + 8;   // padded row: conflict-free fragment reads
  constexpr int KC = D / 16;  // k-chunks of S = Q K^T
  constexpr int NT = BK / 8;  // n-tiles of S
  constexpr int DT = D / 8;   // n-tiles of O
  __shared__ __align__(16) __nv_bfloat16 sK[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 sV[BK * LD];

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H, kh = h / a.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // mma fragment coordinates
  const auto* qp = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb +
                   h * a.q_sh;
  const auto* kp = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb +
                   kh * a.k_sh;
  const auto* vp = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb +
                   kh * a.v_sh;

  // Q tile through the K buffer into registers (A fragments, 16 rows a warp)
  load_tile_bf16<D, LD>(sK, qp, a.q_ss, q0, a.Sq);
  __syncthreads();
  const int r = warp * 16 + g;
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int c = kc * 16 + 2 * t;
    qf[kc][0] = ld32(&sK[r * LD + c]);
    qf[kc][1] = ld32(&sK[(r + 8) * LD + c]);
    qf[kc][2] = ld32(&sK[r * LD + c + 8]);
    qf[kc][3] = ld32(&sK[(r + 8) * LD + c + 8]);
  }
  __syncthreads();

  const int row0 = q0 + r, row1 = row0 + 8;   // this thread's two rows
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  int lo, hi;
  kv_range(a, q0, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += BK) {
    load_tile_bf16<D, LD>(sK, kp, a.k_ss, k0, a.Sk);
    load_tile_bf16<D, LD>(sV, vp, a.v_ss, k0, a.Sk);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = &sK[(nt * 8 + g) * LD + 2 * t];
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        mma_bf16(s[nt], qf[kc], ld32(kr + kc * 16), ld32(kr + kc * 16 + 8));
    }

    // scale, mask, and the running max of each of the two rows
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const float x = s[nt][e] * a.scale;
        s[nt][e] = allowed(a, row, col) ? x : NEG_INF;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    l0 = alpha0 * l0 + quad_sum(rs0);
    l1 = alpha1 * l1 + quad_sum(rs1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= alpha0;
      o[dt][1] *= alpha0;
      o[dt][2] *= alpha1;
      o[dt][3] *= alpha1;
    }

    // O += P V: the S fragments of keys [16 kc2, 16 kc2 + 16) are the A
    // fragments (hi and lo parts); V's B fragment is two keys by one
    // column, gathered
#pragma unroll
    for (int kc2 = 0; kc2 < BK / 16; ++kc2) {
      uint32_t ph[4], pl[4];
      split2(s[2 * kc2][0], s[2 * kc2][1], ph[0], pl[0]);
      split2(s[2 * kc2][2], s[2 * kc2][3], ph[1], pl[1]);
      split2(s[2 * kc2 + 1][0], s[2 * kc2 + 1][1], ph[2], pl[2]);
      split2(s[2 * kc2 + 1][2], s[2 * kc2 + 1][3], ph[3], pl[3]);
      const __nv_bfloat16* vr = &sV[(kc2 * 16 + 2 * t) * LD + g];
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const __nv_bfloat16* vc = vr + dt * 8;
        const uint32_t b0 = pack2(vc[0], vc[LD]);
        const uint32_t b1 = pack2(vc[8 * LD], vc[9 * LD]);
        mma_bf16(o[dt], ph, b0, b1);
        mma_bf16(o[dt], pl, b0, b1);
      }
    }
    __syncthreads();
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  auto* op = static_cast<__nv_bfloat16*>(a.o) +
             (static_cast<long long>(blockIdx.y) * a.Sq) * D + 2 * t;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    if (row0 < a.Sq)
      *reinterpret_cast<uint32_t*>(op + static_cast<long long>(row0) * D +
                                   dt * 8) =
          pack2f(o[dt][0] / d0, o[dt][1] / d0);
    if (row1 < a.Sq)
      *reinterpret_cast<uint32_t*>(op + static_cast<long long>(row1) * D +
                                   dt * 8) =
          pack2f(o[dt][2] / d1, o[dt][3] / d1);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

// rows [r0, r0 + 32) of a [*, D] f32 matrix into shared memory, 16 bytes a
// thread; rows at or past nrows are zero
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long stride, int r0,
                                              int nrows) {
  constexpr int CHUNKS = D / 4;
  for (int i = threadIdx.x; i < SUB32 * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < nrows)
      val = *reinterpret_cast<const float4*>(src + (r0 + r) * stride + c);
    *reinterpret_cast<float4*>(dst + r * D + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const Args a) {
  constexpr int DH = D / 2;   // elements of q / acc per thread
  __shared__ __align__(16) float sK[SUB32 * D];
  __shared__ __align__(16) float sV[SUB32 * D];

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H, kh = h / a.group;
  const int half = threadIdx.x & 1;      // this thread's elements: 2i + half
  const int row = q0 + (threadIdx.x >> 1);
  const auto* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const auto* kp = static_cast<const float*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const auto* vp = static_cast<const float*>(a.v) + b * a.v_sb + kh * a.v_sh;

  float q[DH], acc[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    q[i] = row < a.Sq ? qp[row * a.q_ss + 2 * i + half] : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  int lo, hi;
  kv_range(a, q0, lo, hi);
  // the 64-row tiles of the bounds, each taken as two 32-row sub-tiles
  for (int k0 = lo; k0 < hi; k0 += SUB32) {
    load_tile_f32<D>(sK, kp, a.k_ss, k0, a.Sk);
    load_tile_f32<D>(sV, vp, a.v_ss, k0, a.Sk);
    __syncthreads();
    float s[SUB32];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < SUB32; ++j) {
      const float* kr = &sK[j * D + half];
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) dot = fmaf(q[i], kr[2 * i], dot);
      dot += __shfl_xor_sync(FULL, dot, 1);
      s[j] = allowed(a, row, k0 + j) ? dot * a.scale : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DH; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < SUB32; ++j) {
      const float p = expf(s[j] - mn);
      l += p;
      const float* vr = &sV[j * D + half];
#pragma unroll
      for (int i = 0; i < DH; ++i) acc[i] = fmaf(p, vr[2 * i], acc[i]);
    }
    m = mn;
    __syncthreads();
  }
  if (row < a.Sq) {
    const float den = fmaxf(l, 1e-30f);
    float* op = static_cast<float*>(a.o) +
                (static_cast<long long>(blockIdx.y) * a.Sq + row) * D + half;
#pragma unroll
    for (int i = 0; i < DH; ++i) op[2 * i] = acc[i] / den;
  }
}

template <int D>
void launch(const Args& a, int dtype, dim3 grid, cudaStream_t stream) {
  if (dtype == 1)
    flash_bf16_kernel<D><<<grid, THREADS, 0, stream>>>(a);
  else
    flash_f32_kernel<D><<<grid, THREADS, 0, stream>>>(a);
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (q, k, v and o alike).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a head
// dimension that has no instantiation).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int H, int KH, int Sq,
                           int Sk, int D, long long q_sb, long long q_sh,
                           long long q_ss, long long k_sb, long long k_sh,
                           long long k_ss, long long v_sb, long long v_sh,
                           long long v_ss, int causal, int window, float scale,
                           void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_ss = q_ss;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_ss = v_ss;
  a.H = H;
  a.group = H / KH;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: launch<16>(a, dtype, grid, s); break;
    case 32: launch<32>(a, dtype, grid, s); break;
    case 64: launch<64>(a, dtype, grid, s); break;
    case 128: launch<128>(a, dtype, grid, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
