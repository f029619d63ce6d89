// The two time-step recurrences of the recurrent model families, for Hopper
// (sm_90a).  Hand-written CUDA C++ with a plain C interface (ctypes).
//
// Neither replaces a Pallas kernel: the reference leaves both to XLA, as a
// sequential lax.scan and a lax.associative_scan.  Eager PyTorch has no
// counterpart of either, and a Python loop over the sequence would launch
// some six operations a token and a layer (about 200,000 launches for one
// 1024-token prefill of rwkv6-7b), so each is one launch here.  f32
// arithmetic, built without --use_fast_math: expf, sqrtf and the divisions
// round as IEEE f32 does.
//
// wkv6_scan replaces src/repro/models/recurrent.py:114-125, the step of
// rwkv_timemix_forward: per (b, h), with an hd x hd f32 state S (hd = 64;
// rows i = key channel, columns j = value channel),
//   y_t = r_t^T (S + u . k_t v_t^T),   S = w_t . S + k_t v_t^T
// (u and w_t scale the rows of their matrix).  The recurrence is regrouped
// by chunks of WKV_L steps.  For a chunk from t0 with incoming state S, with
// the decay products D_t = prod_{t0..t} w, P_{s,t} = prod_{s+1..t-1} w and
// E_s = prod_{s+1..t0+L-1} w (every factor <= 1, each product built by
// multiplying forward in f32 and never by dividing, so nothing overflows and
// a w of 0 zeroes what the recurrence zeroes):
//   y_t   = (r_t . D_{t-1})^T S + sum_{s<=t} A[t,s] v_s        (Q S + A V)
//   A[t,s] = sum_i r_t[i] P_{s,t}[i] k_s[i]  (s < t),  A[t,t] = sum r u k_t
//   S_out = D_{t0+L-1} . S + sum_s (k_s . E_s) v_s^T            (D S + K^T V)
// One CTA a (b, h), two warpgroups meeting at one barrier a chunk; chunk
// c + 1's decay pass runs beside chunk c's products.
// * The row warps (CUDA cores, f32): warp J takes rows 4J .. 4J + 3 of A
//   and Q, two channels a lane, and walks s down from its rows' last
//   active step, so that P_{s,t} grows by one factor a step (J is a
//   template argument: which rows are active at s is fixed when the kernel
//   is compiled); the lanes' parts of A[t, s] meet by shuffles, over the
//   rows as the walk goes and over the steps after it; the walk ends at
//   Q = r_t . D_{t-1}.  Warps 0 and 1 build K = k_s . E_s and D, a channel
//   a lane.  Q and A are stored in the order the mma fragments read them.
// * The product warps (tensor cores, mma.sync m16n8k8 TF32) stage the
//   inputs by cp.async NST - 1 chunks ahead and run Q S, A V and K^T V at
//   f32 accuracy: each inexact operand is cut to TF32 hi (its 13 low
//   mantissa bits masked) and lo (the remainder), and hi.hi + lo.hi +
//   hi.lo summed in f32 (v of the bf16 build is exact in TF32 and is not
//   split).  Warp a keeps columns [16a, 16a + 16) of S^T in its mma
//   accumulators, which are, with the k index of each 8-wide step
//   permuted, exactly the B fragments of Q S: the state never leaves the
//   registers.  K^T V is summed apart and added to D . S by an f32 fma, so
//   the tensor cores' accumulation never touches the state that runs
//   through the whole sequence.
// The steps after the last whole chunk (all of a decode step's one) run the
// recurrent step itself on the state in the accumulator layout.
// Bound (rwkv6-7b's prefill: B 4, S 1024, H 64): r, k, v in bf16 and w, y
// in f32, ~243 MB moved once, 72.6 us at 3.35 TB/s; the recurrence's 5.5
// GFLOP would take 81.4 us on the f32 pipe, but this form does 11.8 GFLOP
// of split TF32 products (23.8 us at 495 TFLOP/s) and ~0.43 G f32
// operations (6.5 us at 67 TFLOP/s): the bytes bound it.  What holds it
// back is each CTA's latency a chunk, not a unit of the SM: one CTA alone
// on an SM takes nearly as long as two (chip_smoke's kernel_ms_b1).
//
// rglru_scan replaces src/repro/models/recurrent.py:205-212 and :215-236,
// the elementwise part of _rglru_gates with the diagonal recurrence of
// rglru_block_forward: per (b, channel c), over t,
//   r = sigmoid(gr), i = sigmoid(gi), log_a = -8 r softplus(lam),
//   a = exp(log_a), b = sqrt(clip(1 - exp(2 log_a), 0, 1)) (i x),
//   h = a h + b
// where gr, gi are the f32 gate pre-activations (x @ W + bias, left to a
// matrix product) and x the convolution's output.  A step is the affine map
// h -> a h + b, and such maps compose (the reference's comb), so time is
// split as well as channels: a CTA of RG_SLICES warps takes 32 neighbouring
// channels (a lane each, so every load is coalesced) through chunks of
// RG_SLICES x RG_STEPS steps, a warp a slice of RG_STEPS steps.  Each
// thread computes its slice's gates off the chain, loaded one chunk ahead,
// keeps them in registers, and composes them into the slice's map
// (prod a, its scan from 0); the slices' maps meet in shared memory, where
// every thread composes the chunk's incoming h through the slices before
// its own (its carry-in) and through all of them (the next chunk's h, the
// same in every warp); then it runs its steps from the carry-in, writing
// each h once.  Each input is read once and h written once.  Decode (S = 1)
// takes a one-step kernel, a thread a (b, channel).  Bound (recurrentgemma-
// 9b's prefill: B 4, S 1024, R 4096): gr, gi, h in f32 and x in bf16,
// ~235 MB, ~70 us.  The reference associates the products in another order
// (a log-depth scan), so the two agree to f32 rounding, not bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32.cuh"

namespace {

using namespace scan;

constexpr int HD = 64;          // the rwkv head size
constexpr float RG_C = 8.0f;    // the rg-lru temperature constant

// two consecutive elements from global memory
__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ---------------------------------------------------------------------------
// WKV6
// ---------------------------------------------------------------------------

constexpr int WKV_L = 16;         // steps a chunk
constexpr int WKV_APPLY = 4;      // warps of the products: a owns columns
                                  // [16a, 16a + 16) of S
constexpr int WKV_ROWS = 4;       // warps of the rows of A and Q: j owns
                                  // rows [4j, 4j + 4) of a chunk
constexpr int WKV_THREADS = 32 * (WKV_APPLY + WKV_ROWS);
constexpr int WKV_KS = WKV_L / 8;   // 8-step k slices of a chunk
// row strides (in elements) that keep every fragment load free of bank
// conflicts
constexpr int KS = WKV_L + 8;
constexpr int VS = HD + 8;
// Q's and A's fragments as mma reads them: a 16-byte run a (k step, lane),
// 16 padding words after each k step's 128
constexpr int QF = 32 * 4 + 16;
constexpr int AF = 32 * 4;
static_assert(WKV_L == 16 && WKV_APPLY == 4 && WKV_ROWS == 4,
              "the WKV layout: 16 rows over 4 warps, 64 columns over 4");

// chunks of input staged: the two in use and those in flight (f32's larger
// stages: three keep two CTAs an SM)
template <typename T>
__host__ __device__ constexpr int wkv_stages() {
  return sizeof(T) == 2 ? 4 : 3;
}

// The position of step s of a chunk in row i of K^T: slots q and q + 4 of
// each 8-step k slice side by side, so that one 8-byte load gives both,
// the pairs of a row permuted by i / 4 so that the decay pass's stores (a
// channel a lane) meet two to a bank and not eight.
__device__ __forceinline__ int kswz(int i, int s) {
  return ((s & ~7) | ((s & 3) << 1) | ((s >> 2) & 1)) ^ (2 * ((i >> 2) & 7));
}

// one chunk's inputs, as cp.async brings them
template <typename T>
struct __align__(16) WkvStage {
  T r[WKV_L][HD];
  T k[WKV_L][HD];
  float w[WKV_L][HD];
  T v[WKV_L][VS];
};

// what the decay pass gives the products: Q = r . D_{t-1} and A as
// fragments (qf_index, af_index), K^T (K = k . E) with its steps placed by
// kswz, each as TF32 hi and lo parts (bit patterns kept in float), and D
// of the chunk
struct __align__(16) WkvMix {
  float qh[8 * QF], ql[8 * QF];
  float ah[WKV_KS * AF], al[WKV_KS * AF];
  float kth[HD][KS], ktl[HD][KS];
  float d[HD];
};

// where Q[t][i] lies in qh / ql: k step i / 8, lane 4 (t % 8) + (i % 8) / 2
// (slot q holds i = 8kk + 2q, slot q + 4 holds i = 8kk + 2q + 1), then the
// fragment's register: 2 (i % 2) + t / 8
__device__ __forceinline__ int qf_index(int t, int i) {
  return (i / 8) * QF + ((t % 8) * 4 + (i % 8) / 2) * 4 + (i % 2) * 2 + t / 8;
}

// where A[t][s] lies in ah / al: k step s / 8, lane 4 (t % 8) + s % 4,
// register 2 ((s % 8) / 4) + t / 8
__device__ __forceinline__ int af_index(int t, int s) {
  return (s / 8) * AF + ((t % 8) * 4 + s % 4) * 4 + ((s % 8) / 4) * 2 + t / 8;
}

template <typename T>
constexpr size_t wkv_smem_bytes() {
  return 2 * sizeof(WkvMix) + wkv_stages<T>() * sizeof(WkvStage<T>);
}

// cp.async of one chunk's rows (b, t0 .. t0 + L - 1, h, :) into a stage;
// `base` is the element offset of (b, t0, h, 0), `row` that of a step
template <typename T>
__device__ __forceinline__ void wkv_stage(WkvStage<T>& st, const T* r,
                                          const T* k, const T* v,
                                          const float* w, long long base,
                                          long long row, int tid) {
  constexpr int N = 32 * WKV_APPLY;  // the product warps' threads copy
  constexpr int PT = 16 / static_cast<int>(sizeof(T));  // elements a copy
  constexpr int PR = HD / PT;
  for (int p = tid; p < WKV_L * PR; p += N) {
    const int s = p / PR, c = (p % PR) * PT;
    const long long o = base + s * row + c;
    cp_async16(&st.r[s][c], r + o);
    cp_async16(&st.k[s][c], k + o);
    cp_async16(&st.v[s][c], v + o);
  }
  for (int p = tid; p < WKV_L * (HD / 4); p += N) {
    const int s = p / (HD / 4), c = (p % (HD / 4)) * 4;
    cp_async16(&st.w[s][c], w + base + s * row + c);
  }
}

// The rows of A and Q of one chunk (CUDA cores, f32), by row warp J: rows
// 4J .. 4J + 3, channels 2l and 2l + 1 a lane.  The warp walks s down from
// its last row's last active step: q = r_t . P_{s,t} gains one factor a
// step, and the lane's part of A[t, s] is q . k_s over its channels (J is
// a template argument, so which rows are active at s is known when the
// kernel is compiled).  The parts meet by a reduce-scatter of shuffles:
// over the rows at each step, as the walk goes (lane bits 4 and 3 pick
// the row a lane keeps), then over the steps.  The walk ends at
// Q = r_t . D_{t-1}.
template <int J, typename T>
__device__ __forceinline__ void wkv_rows(const WkvStage<T>& st, WkvMix& mx,
                                         float2 uu, int lane) {
  constexpr int t0 = 4 * J;
  const int c0 = 2 * lane;
  const bool b4 = (lane & 16) != 0, b3 = (lane & 8) != 0;
  float q[4][2], dg[4], m[WKV_L];
#pragma unroll
  for (int rho = 0; rho < 4; ++rho) {
    const float2 rr = lds2(&st.r[t0 + rho][c0]);
    const float2 kk = lds2(&st.k[t0 + rho][c0]);
    q[rho][0] = rr.x;
    q[rho][1] = rr.y;
    dg[rho] = fmaf(rr.x * uu.x, kk.x, rr.y * uu.y * kk.y);
  }
#pragma unroll
  for (int s = WKV_L - 1; s >= 0; --s) {
    if (s > t0 + 3) {  // past every row of the block: A is 0
      m[s] = 0.0f;
      continue;
    }
    float pv[4];
    if (s < t0 + 3) {
      const float2 kk = lds2(&st.k[s][c0]), ww = lds2(&st.w[s][c0]);
#pragma unroll
      for (int rho = 0; rho < 4; ++rho) {
        if (s < t0 + rho) {
          pv[rho] = fmaf(q[rho][0], kk.x, q[rho][1] * kk.y);
          q[rho][0] *= ww.x;
          q[rho][1] *= ww.y;
        } else {
          pv[rho] = s == t0 + rho ? dg[rho] : 0.0f;
        }
      }
    } else {
#pragma unroll
      for (int rho = 0; rho < 4; ++rho)
        pv[rho] = s == t0 + rho ? dg[rho] : 0.0f;
    }
    // rows rho and rho + 2, then the kept pair: lane keeps row 2 b4 + b3
    const float x0 = (b4 ? pv[2] : pv[0]) +
                     __shfl_xor_sync(0xffffffffu, b4 ? pv[0] : pv[2], 16);
    const float x1 = (b4 ? pv[3] : pv[1]) +
                     __shfl_xor_sync(0xffffffffu, b4 ? pv[1] : pv[3], 16);
    m[s] = (b3 ? x1 : x0) + __shfl_xor_sync(0xffffffffu, b3 ? x0 : x1, 8);
  }
  // lane l ends with A[t][s] for t = t0 + 2 b4 + b3, s = 2 (l % 8) + e
  reduce_half<4>(m, lane);
  reduce_half<2>(m, lane);
  reduce_half<1>(m, lane);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int o = af_index(t0 + 2 * b4 + b3, 2 * (lane % 8) + e);
    const Split a = split(m[e]);
    mx.ah[o] = __uint_as_float(a.hi);
    mx.al[o] = __uint_as_float(a.lo);
  }
#pragma unroll
  for (int rho = 0; rho < 4; ++rho)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = qf_index(t0 + rho, c0 + e);
      const Split x = split(q[rho][e]);
      mx.qh[o] = __uint_as_float(x.hi);
      mx.ql[o] = __uint_as_float(x.lo);
    }
}

// K = k_s . E_s and D of one chunk at channel i, E built from the chunk's
// end by forward multiplication.  Every load comes before the first store
// (the compiler cannot tell the stage from mix).
template <typename T>
__device__ __forceinline__ void wkv_decay(const WkvStage<T>& st, WkvMix& mx,
                                          int i) {
  float kk[WKV_L], ww[WKV_L];
#pragma unroll
  for (int s = 0; s < WKV_L; ++s) {
    kk[s] = to_f(st.k[s][i]);
    ww[s] = st.w[s][i];
  }
  float e = 1.0f;
#pragma unroll
  for (int s = WKV_L - 1; s >= 0; --s) {
    const Split k = split(kk[s] * e);
    mx.kth[i][kswz(i, s)] = __uint_as_float(k.hi);
    mx.ktl[i][kswz(i, s)] = __uint_as_float(k.lo);
    e *= ww[s];
  }
  mx.d[i] = e;
}

// Row warp j's share of the decay pass of one chunk: its rows of A and Q
// and, for j < 2, K and D at channels 32j + lane
template <typename T>
__device__ __forceinline__ void wkv_prep(const WkvStage<T>& st, WkvMix& mx,
                                         float2 uu, int j, int lane) {
  switch (j) {
    case 0: wkv_rows<0>(st, mx, uu, lane); break;
    case 1: wkv_rows<1>(st, mx, uu, lane); break;
    case 2: wkv_rows<2>(st, mx, uu, lane); break;
    default: wkv_rows<3>(st, mx, uu, lane); break;
  }
  if (j < 2) wkv_decay(st, mx, 32 * j + lane);
}

// The products of one chunk for product warp a: y of its 16 columns over
// the chunk's 16 rows, and its columns of the state.  sacc[n][.] holds
// S^T[j][i] for j = 16a + gq (+ 8 in [2], [3]) and i = 8n + 2tq (+ 1 in
// [1], [3]).  The split terms sum in accumulators of their own, A V's
// with Q S's, and the state's update in four 8-column tiles side by side,
// so that few tensor-core operations wait on the one before.
template <typename T>
__device__ __forceinline__ void wkv_apply(const WkvStage<T>& st,
                                          const WkvMix& mx,
                                          float (&sacc)[8][4], float* y,
                                          long long ybase, long long row,
                                          int a, int gq, int tq) {
  constexpr bool kSplitV = sizeof(T) == 4;  // f32 v is not exact in TF32
  const int lane = 4 * gq + tq;
  float yhh[2][4] = {}, ylh[2][4] = {}, yhl[2][4] = {};
  // Q S: k step kk covers rows i = 8kk .. 8kk + 7 of S, slot q holding
  // i = 8kk + 2q and slot q + 4 holding i = 8kk + 2q + 1, so that the
  // state's accumulators are the B fragments as they stand
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    Split b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) b[e] = split(sacc[kk][e]);
    const float4 h = *reinterpret_cast<const float4*>(&mx.qh[kk * QF + 4 * lane]);
    const float4 l = *reinterpret_cast<const float4*>(&mx.ql[kk * QF + 4 * lane]);
    const uint32_t ah[4] = {bits(h.x), bits(h.y), bits(h.z), bits(h.w)};
    const uint32_t al[4] = {bits(l.x), bits(l.y), bits(l.z), bits(l.w)};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      mma(ylh[nb], al, b[2 * nb].hi, b[2 * nb + 1].hi);
      mma(yhl[nb], ah, b[2 * nb].lo, b[2 * nb + 1].lo);
      mma(yhh[nb], ah, b[2 * nb].hi, b[2 * nb + 1].hi);
    }
  }
  // A V (A is zero above the diagonal)
#pragma unroll
  for (int kk = 0; kk < WKV_KS; ++kk) {
    const float4 h = *reinterpret_cast<const float4*>(&mx.ah[kk * AF + 4 * lane]);
    const float4 l = *reinterpret_cast<const float4*>(&mx.al[kk * AF + 4 * lane]);
    const uint32_t ah[4] = {bits(h.x), bits(h.y), bits(h.z), bits(h.w)};
    const uint32_t al[4] = {bits(l.x), bits(l.y), bits(l.z), bits(l.w)};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const int j = 16 * a + 8 * nb + gq;
      const float v0 = to_f(st.v[8 * kk + tq][j]);
      const float v1 = to_f(st.v[8 * kk + tq + 4][j]);
      const Split b0 = kSplitV ? split(v0) : Split{bits(v0), 0u};
      const Split b1 = kSplitV ? split(v1) : Split{bits(v1), 0u};
      mma(ylh[nb], al, b0.hi, b1.hi);
      if (kSplitV) mma(yhl[nb], ah, b0.lo, b1.lo);
      mma(yhh[nb], ah, b0.hi, b1.hi);
    }
  }
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int e = 2 * hf;
      const float2 out =
          make_float2(yhh[nb][e] + (ylh[nb][e] + yhl[nb][e]),
                      yhh[nb][e + 1] + (ylh[nb][e + 1] + yhl[nb][e + 1]));
      const long long o = ybase + (gq + 8 * hf) * row + 16 * a + 8 * nb + 2 * tq;
      *reinterpret_cast<float2*>(y + o) = out;
    }
  // the state: S^T = D . S^T + V^T K, the update summed apart, in two
  // halves of four 8-column tiles side by side
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float du[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < WKV_KS; ++kk) {
      const int s0 = 8 * kk + tq, j0 = 16 * a + gq, c0 = 8 * kk + 2 * tq;
      const float va[4] = {to_f(st.v[s0][j0]), to_f(st.v[s0][j0 + 8]),
                           to_f(st.v[s0 + 4][j0]),
                           to_f(st.v[s0 + 4][j0 + 8])};
      uint32_t vh[4], vl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const Split x = kSplitV ? split(va[e]) : Split{bits(va[e]), 0u};
        vh[e] = x.hi;
        vl[e] = x.lo;
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int i = 8 * (4 * half + m) + gq, ci = c0 ^ (2 * ((i >> 2) & 7));
        const float2 kh = *reinterpret_cast<const float2*>(&mx.kth[i][ci]);
        const float2 kl = *reinterpret_cast<const float2*>(&mx.ktl[i][ci]);
        mma(du[m], vh, bits(kl.x), bits(kl.y));
        if (kSplitV) mma(du[m], vl, bits(kh.x), bits(kh.y));
        mma(du[m], vh, bits(kh.x), bits(kh.y));
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int n = 4 * half + m;
      const float2 dd = *reinterpret_cast<const float2*>(&mx.d[8 * n + 2 * tq]);
      sacc[n][0] = fmaf(dd.x, sacc[n][0], du[m][0]);
      sacc[n][1] = fmaf(dd.y, sacc[n][1], du[m][1]);
      sacc[n][2] = fmaf(dd.x, sacc[n][2], du[m][2]);
      sacc[n][3] = fmaf(dd.y, sacc[n][3], du[m][3]);
    }
  }
}

// One recurrent step at time t on the state in the accumulator layout:
// the thread's 16 rows i for its two columns j, y summed over the four
// lanes that share the columns.
template <typename T>
__device__ __forceinline__ void wkv_step(const T* __restrict__ r,
                                         const T* __restrict__ k,
                                         const T* __restrict__ v,
                                         const float* __restrict__ w,
                                         const float* __restrict__ u,
                                         float* __restrict__ y,
                                         float (&sacc)[8][4], long long o,
                                         int h, int a, int gq, int tq) {
  const int j0 = 16 * a + gq;
  const float v0 = to_f(v[o + j0]), v1 = to_f(v[o + j0 + 8]);
  float y0 = 0.f, y1 = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int i = 8 * n + 2 * tq;
    const float2 rr = load2(r + o + i), kk = load2(k + o + i);
    const float2 ww = load2(w + o + i), uv = load2(u + h * HD + i);
    const float ri[2] = {rr.x, rr.y}, ki[2] = {kk.x, kk.y};
    const float wi[2] = {ww.x, ww.y}, ui[2] = {uv.x, uv.y};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float kv0 = ki[e] * v0, kv1 = ki[e] * v1;
      y0 = fmaf(ri[e], fmaf(ui[e], kv0, sacc[n][e]), y0);
      y1 = fmaf(ri[e], fmaf(ui[e], kv1, sacc[n][2 + e]), y1);
      sacc[n][e] = fmaf(wi[e], sacc[n][e], kv0);
      sacc[n][2 + e] = fmaf(wi[e], sacc[n][2 + e], kv1);
    }
  }
  y0 += __shfl_xor_sync(0xffffffffu, y0, 1);
  y1 += __shfl_xor_sync(0xffffffffu, y1, 1);
  y0 += __shfl_xor_sync(0xffffffffu, y0, 2);
  y1 += __shfl_xor_sync(0xffffffffu, y1, 2);
  if (tq == 0) {
    y[o + j0] = y0;
    y[o + j0 + 8] = y1;
  }
}

template <typename T>
__global__ void __launch_bounds__(WKV_THREADS, 2)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_fin, int H, int S) {
  constexpr int NST = wkv_stages<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  WkvMix* mix = reinterpret_cast<WkvMix*>(smem);
  WkvStage<T>* stg =
      reinterpret_cast<WkvStage<T>*>(smem + 2 * sizeof(WkvMix));
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool product = warp < WKV_APPLY;  // else a row warp
  const int gq = lane / 4, tq = lane % 4;
  const long long row = static_cast<long long>(H) * HD;  // one time step
  const long long base = static_cast<long long>(b) * S * row + h * HD;
  float sacc[8][4];
  const float* sp = s0 + static_cast<long long>(bh) * HD * HD;
  if (product) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sacc[n][e] = sp[(8 * n + 2 * tq + e % 2) * HD + 16 * warp + gq +
                        8 * (e / 2)];
  }
  const int nfull = S / WKV_L;
  // The two warpgroups run loops of their own (so that the state's
  // registers are not held across the row warps' code), meeting at one
  // barrier a chunk: chunk c + 1's inputs have landed and every warp is
  // done with chunk c - 1 (its stage and its half of mix).
  if (nfull > 0 && product) {
    // the product warps stage the inputs, NST - 1 chunks ahead
    const long long chunk = WKV_L * row;
#pragma unroll
    for (int c = 0; c < NST - 1; ++c) {
      if (c < nfull)
        wkv_stage(stg[c], r, k, v, w, base + c * chunk, row, threadIdx.x);
      cp_async_commit();
    }
    cp_async_wait<NST - 2>();
    bar_sync<1, WKV_THREADS>();
    for (int c = 0; c < nfull; ++c) {
      cp_async_wait<NST - 3>();
      bar_sync<1, WKV_THREADS>();
      const int nc = c + NST - 1;
      if (nc < nfull)
        wkv_stage(stg[nc % NST], r, k, v, w, base + nc * chunk, row,
                  threadIdx.x);
      cp_async_commit();
      wkv_apply(stg[c % NST], mix[c % 2], sacc, y, base + c * chunk, row,
                warp, gq, tq);
    }
  } else if (nfull > 0) {
    // the row warps (j the warp's row block) build A, Q, K and D of chunk
    // c + 1 beside the products of chunk c
    const int j = warp - WKV_APPLY;
    const float2 uu = load2(u + h * HD + 2 * lane);
    bar_sync<1, WKV_THREADS>();
    wkv_prep(stg[0], mix[0], uu, j, lane);
    for (int c = 0; c < nfull; ++c) {
      bar_sync<1, WKV_THREADS>();
      if (c + 1 < nfull)
        wkv_prep(stg[(c + 1) % NST], mix[(c + 1) % 2], uu, j, lane);
    }
  }
  if (!product) return;
  // the steps after the last whole chunk: every step of a decode
  for (int t = nfull * WKV_L; t < S; ++t)
    wkv_step(r, k, v, w, u, y, sacc, base + t * row, h, warp, gq, tq);

  float* fp = s_fin + static_cast<long long>(bh) * HD * HD;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      fp[(8 * n + 2 * tq + e % 2) * HD + 16 * warp + gq + 8 * (e / 2)] =
          sacc[n][e];
}

// ---------------------------------------------------------------------------
// RG-LRU
// ---------------------------------------------------------------------------

constexpr int RG_LANES = 32;    // channels a CTA, a lane each
constexpr int RG_SLICES = 8;    // warps a CTA: a chunk's time slices
constexpr int RG_STEPS = 4;     // steps a slice (8 spill at 64 registers,
                                // and 72 leave room for 3 CTAs an SM)
constexpr int RG_CHUNK = RG_SLICES * RG_STEPS;
constexpr int RG_STEP_THREADS = 128;

// the gates of one step: h -> a h + b
__device__ __forceinline__ void rglru_gates(float g_r, float g_i, float x,
                                            float soft, float& a, float& b) {
  const float rg = 1.0f / (1.0f + expf(-g_r));
  const float ig = 1.0f / (1.0f + expf(-g_i));
  const float log_a = -RG_C * rg * soft;
  a = expf(log_a);
  b = sqrtf(fminf(fmaxf(1.0f - expf(2.0f * log_a), 0.0f), 1.0f)) * (ig * x);
}

// the inputs of RG_STEPS steps from ts (a step past S reads step 0)
template <typename T>
__device__ __forceinline__ void rglru_load(
    const float* __restrict__ gr, const float* __restrict__ gi,
    const T* __restrict__ xc, long long base, int ts, int S, int R,
    float (&g_r)[RG_STEPS], float (&g_i)[RG_STEPS], float (&x)[RG_STEPS]) {
#pragma unroll
  for (int e = 0; e < RG_STEPS; ++e) {
    const int t = ts + e;
    const long long o = base + static_cast<long long>(t < S ? t : 0) * R;
    g_r[e] = gr[o];
    g_i[e] = gi[o];
    x[e] = to_f(xc[o]);
  }
}

template <typename T>
__global__ void __launch_bounds__(RG_LANES * RG_SLICES, 4)
rglru_kernel(const float* __restrict__ gr, const float* __restrict__ gi,
             const T* __restrict__ xc, const float* __restrict__ sp,
             const float* __restrict__ h0, float* __restrict__ hs,
             float* __restrict__ h_last, int S, int R) {
  // each slice's map (prod a, its scan from 0), two chunks apart
  __shared__ float2 agg[2][RG_SLICES][RG_LANES];
  const int lane = threadIdx.x % 32, k = threadIdx.x / 32;
  const int b = blockIdx.y, c = blockIdx.x * RG_LANES + lane;
  const bool on = c < R;
  const int cc = on ? c : R - 1;  // a lane past R computes on column R - 1
  const float soft = sp[cc];
  float h = h0[static_cast<long long>(b) * R + cc];  // h entering the chunk
  const long long base = static_cast<long long>(b) * S * R + cc;
  float g_r[RG_STEPS], g_i[RG_STEPS], x[RG_STEPS];
  rglru_load(gr, gi, xc, base, k * RG_STEPS, S, R, g_r, g_i, x);
  for (int t0 = 0, par = 0; t0 < S; t0 += RG_CHUNK, par ^= 1) {
    const int ts = t0 + k * RG_STEPS;  // this slice's first step
    float a[RG_STEPS], bb[RG_STEPS];
#pragma unroll
    for (int e = 0; e < RG_STEPS; ++e) {
      rglru_gates(g_r[e], g_i[e], x[e], soft, a[e], bb[e]);
      if (ts + e >= S) {  // past the end: the identity map
        a[e] = 1.0f;
        bb[e] = 0.0f;
      }
    }
    if (t0 + RG_CHUNK < S)
      rglru_load(gr, gi, xc, base, t0 + RG_CHUNK + k * RG_STEPS, S, R, g_r,
                 g_i, x);
    float pa = a[0], pb = bb[0];
#pragma unroll
    for (int e = 1; e < RG_STEPS; ++e) {
      pb = fmaf(a[e], pb, bb[e]);
      pa *= a[e];
    }
    agg[par][k][lane] = make_float2(pa, pb);
    __syncthreads();
    // h through the slices before this one (the carry-in) and through all
    float hk = h;
#pragma unroll
    for (int m = 0; m < RG_SLICES; ++m) {
      if (m == k) hk = h;
      const float2 f = agg[par][m][lane];
      h = fmaf(f.x, h, f.y);
    }
#pragma unroll
    for (int e = 0; e < RG_STEPS; ++e) {
      hk = fmaf(a[e], hk, bb[e]);
      if (on && ts + e < S) hs[base + static_cast<long long>(ts + e) * R] = hk;
    }
  }
  if (on && k == 0) h_last[static_cast<long long>(b) * R + c] = h;
}

// decode: one step, a thread a (b, channel)
template <typename T>
__global__ void __launch_bounds__(RG_STEP_THREADS)
rglru_step_kernel(const float* __restrict__ gr, const float* __restrict__ gi,
                  const T* __restrict__ xc, const float* __restrict__ sp,
                  const float* __restrict__ h0, float* __restrict__ hs,
                  float* __restrict__ h_last, int B, int R) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * RG_STEP_THREADS + threadIdx.x;
  if (idx >= static_cast<long long>(B) * R) return;
  float a, bb;
  rglru_gates(gr[idx], gi[idx], to_f(xc[idx]), sp[idx % R], a, bb);
  const float h = fmaf(a, h0[idx], bb);
  hs[idx] = h;
  h_last[idx] = h;
}

template <typename T>
int wkv6_launch(const void* r, const void* k, const void* v, const float* w,
                const float* u, const float* s0, float* y, float* s_fin,
                int B, int H, int S, cudaStream_t stream) {
  // the chunks' shared memory only where there is a whole chunk, opted
  // into once a device
  const size_t smem = S >= WKV_L ? wkv_smem_bytes<T>() : 0;
  constexpr int kDevices = 64;
  static bool opted_in[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem && (dev >= kDevices || !opted_in[dev])) {
    err = cudaFuncSetAttribute(wkv6_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kDevices) opted_in[dev] = true;
  }
  wkv6_kernel<T><<<B * H, WKV_THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, y, s_fin, H, S);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int rglru_launch(const float* gr, const float* gi, const void* xc,
                 const float* sp, const float* h0, float* hs, float* h_last,
                 int B, int S, int R, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xc);
  if (S == 1) {
    const long long n = static_cast<long long>(B) * R;
    const unsigned blocks =
        static_cast<unsigned>((n + RG_STEP_THREADS - 1) / RG_STEP_THREADS);
    rglru_step_kernel<T><<<blocks, RG_STEP_THREADS, 0, stream>>>(
        gr, gi, x, sp, h0, hs, h_last, B, R);
  } else {
    const dim3 grid((R + RG_LANES - 1) / RG_LANES, B);
    rglru_kernel<T><<<grid, RG_LANES * RG_SLICES, 0, stream>>>(
        gr, gi, x, sp, h0, hs, h_last, S, R);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (of r, k, v).  Every tensor contiguous, r, k, v
// and w 16-byte aligned: r, k, v, w and y [B, S, H, 64], u [H, 64], s0 and
// s_fin [B, H, 64, 64].  Returns cudaGetLastError() after the launch.
int wkv6_scan_launch(const void* r, const void* k, const void* v,
                     const float* w, const float* u, const float* s0,
                     float* y, float* s_fin, int dtype, int B, int H, int S,
                     void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? wkv6_launch<__nv_bfloat16>(r, k, v, w, u, s0, y, s_fin, B, H,
                                          S, s)
             : wkv6_launch<float>(r, k, v, w, u, s0, y, s_fin, B, H, S, s);
}

// dtype: 0 = f32, 1 = bf16 (of xc).  gr, gi, xc and hs [B, S, R], sp [R],
// h0 and h_last [B, R], all contiguous, S >= 1.  Returns
// cudaGetLastError().
int rglru_scan_launch(const float* gr, const float* gi, const void* xc,
                      const float* sp, const float* h0, float* hs,
                      float* h_last, int dtype, int B, int S, int R,
                      void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? rglru_launch<__nv_bfloat16>(gr, gi, xc, sp, h0, hs,
                                                  h_last, B, S, R, s)
                    : rglru_launch<float>(gr, gi, xc, sp, h0, hs, h_last, B,
                                          S, R, s);
}

const char* recurrent_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
