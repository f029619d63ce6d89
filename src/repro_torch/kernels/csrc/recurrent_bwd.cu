// The backward of the two time-step recurrences of the recurrent model
// families, for Hopper (sm_90a).  Hand-written CUDA C++ with a plain C
// interface (ctypes), beside the forward kernels of recurrent.cu.
//
// Neither replaces a Pallas kernel: the reference trains both scans through
// XLA's autodiff of a sequential lax.scan and a lax.associative_scan.  f32
// arithmetic, built without --use_fast_math, so that expf, sqrtf and the
// divisions round as IEEE f32 does and an infinite slope stays infinite.
// No floating-point atomics: every sum over CTAs is taken by a second pass
// over per-CTA partials in a fixed order, so a launch is bit-identical to
// the next one on the same inputs.
//
// wkv6_bwd replaces the autodiff of src/repro/models/recurrent.py:125, the
// lax.scan of rwkv_timemix_forward: per (b, h), with the 64 x 64 f32 state
// S_t = w_t . S_{t-1} + k_t v_t^T (w_t scales rows; S_{-1} = s0) and
// y_t = r_t^T (S_{t-1} + u . k_t v_t^T), its reverse sweep carries the
// state's adjoint G_t = dL/dS_t from G_{S-1} = ds_fin:
//   dr_t = S_{t-1} dy_t + u . k_t (v_t . dy_t)
//   dk_t = G_t v_t + r_t . u (v_t . dy_t)
//   dv_t = G_t^T k_t + (sum_i r_t u k_t) dy_t
//   dw_t[i] = sum_j G_t[i, j] S_{t-1}[i, j]
//   du += r_t . k_t (v_t . dy_t)
//   G_{t-1} = w_t . G_t + r_t dy_t^T,   ds0 = G_{-1}.
// It is regrouped by chunks of WB_L = 16 steps, as the forward's kernel is.
// For a chunk with incoming state S_in and outgoing adjoint G_out, local
// steps t = 0 .. L - 1, the decay products D_{t-1} = prod_{0..t-1} w,
// E_t = prod_{t+1..L-1} w, P_{s,t} = prod_{s+1..t-1} w and D_L, each built
// by multiplying forward and never by dividing (exp(-e^6) is 0 in f32: a
// decay at the clip's top erases the state, and w_t cannot be divided out),
// and with C = dY V^T, A[t,s] = sum_i r_t P_{s,t} k_s (s < t), A[t,t] =
// sum_i r_t u k_t, Q = r . D_{t-1}, K = k . E:
//   dQraw = dY S_in^T,  dKraw = V G_out^T,  rd = rowdot(G_out, S_in)
//   dV    = A^T dY + K G_out
//   G_in  = D_L . G_out + Q^T dY,   S_out = D_L . S_in + K^T V
// on the tensor cores, and a thread a channel i on the CUDA cores walks
//   Z^{(t+1)}_tau = w_t Z^{(t)}_tau + C[tau,t] k_t       (Z^{(0)} = 0)
//   dr_t = D_{t-1} dQraw_t + Z^{(t)}_t + u k_t C[t,t]
//   dk_s = E_s dKraw_s + sum_{t>s} C[t,s] P_{s,t} r_t + r_s u C[s,s]
//   dw_t = E_t D_{t-1} rd + E_t sum_{s<t} P_{s,t} k_s dKraw_s
//          + D_{t-1} sum_{tau>t} P_{t,tau} r_tau dQraw_tau
//          + sum_{tau>t} P_{t,tau} r_tau Z^{(t)}_tau
// (E_t D_{t-1}, the product without w_t, as suffix times prefix: the usual
// chunked form divides there, and gives inf or NaN where the true dw_t is
// finite).  The sums over pairs of steps walk within each half chunk of
// 8 steps; across the halves P_{s,t} = El_s Dh_{t-1} (prod_{s+1..7} w and
// prod_{8..t-1} w), so those pairs go through two small products, U =
// C[hi, lo] K_lo and V = C[hi, lo]^T Q_hi (K_lo = k . El, Q_hi = r . Dh),
// and a walk of one factor a step; so does A: the row walk runs within
// each half and A[hi, lo] = Q_hi K_lo^T is a product.  Each product runs
// as split TF32 at f32 accuracy (tf32.cuh: hi.hi + lo.hi + hi.lo; bf16 v
// is exact in TF32 and is not split).
// One CTA a (b, h), so that dr, dk, dv and dw are whole in it; du sums over
// the batch in a second pass (sum_parts_kernel).  It needs S_in of every
// chunk in reverse order: a first pass runs the chunks forward, keeping
// the state at each WB_M-chunk segment's start in a workspace (segment 0's
// is s0, and the last segment's states stay in shared memory); then each
// segment from the last is rebuilt forward from its checkpoint into WB_M
// state slots in shared memory and walked back.  A CTA's chunk items (first
// pass, rebuild, backward) run in one sequence, a barrier an item: warps
// 4-7 (the product warps) stage inputs by cp.async two or three items
// ahead (f32, bf16) and run the item's products; warps 0-3 (the row
// warps) build A, Q, K and D of the next item, then walk this one (warps
// 0-1 the Z walk with dr, warps 2-3 dk, du and dw), meeting the products
// at a named barrier.
// Bound (rwkv6-7b's training shape: B 4, S 1024, H 64): r, k, v, dr, dk, dv
// in bf16 and w, dy, dw in f32, ~415 MB moved once, 124 us at 3.35 TB/s.
// Beyond it, the first pass and the rebuilds read k, v and w again (the
// rebuilds' mostly from L2), and the checkpoints take 37.7 MB written and
// read (segments 1 .. 9 of 11 at WB_M = 6); no partial of dv.  It takes
// ~1.05 ms there (PERF.md): every phase runs several times slower than
// its instruction count, at 8 warps a SM and two CTAs a SM in turn.
//
// rglru_bwd replaces the autodiff of src/repro/models/recurrent.py:234, the
// lax.associative_scan of rglru_block_forward, with _rglru_gates (:205):
// per (b, channel), h_t = a_t h_{t-1} + b_t with a = exp(-8 sigmoid(gr) sp),
// b = sqrt(clip(1 - exp(2 log a), 0, 1)) sigmoid(gi) x.  The adjoint of h
// runs backward, g_t = dhs_t + a_{t+1} g_{t+1} (g_{S-1} also takes dh_last),
// dh0 = a_0 g_0, and each step's gates are recomputed from gr, gi, x and
// differentiated as jax.vjp of the reference's lines does, operation for
// operation: the sqrt's slope 0.5 / sqrt(z) is infinite where 1 - a^2 is
// exactly 0 (a = 1 in f32), and clip's slope is 1/2 where its argument
// meets a bound (JAX's balanced max and min).  h_{t-1} is read from the
// forward's output, not recomputed.  The reverse recurrence is an affine
// map a step (x -> a_t (dhs_t + x), carried into step t - 1), and such maps
// compose, so time is split as the forward splits it: a CTA of RB_SLICES
// warps takes 32 channels (a lane each) through chunks of RB_SLICES x
// RB_STEPS steps from the end, a warp a slice; the slices' maps meet in
// shared memory, each thread carries the later chunk's adjoint through the
// slices after its own, then runs its steps.  dsp sums over a thread's
// steps, the CTA's slices in order, then the batch in a second pass.
// Bound (recurrentgemma-9b's training shape: B 4, S 1024, R 4096): gr, gi,
// hs, dhs, dgr, dgi in f32 and x, dx in bf16, ~470 MB, 140 us; ~50
// operations an element (0.84 GFLOP, 13 us on the f32 pipe): the bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32.cuh"

namespace {

using namespace scan;

constexpr int HD = 64;          // the rwkv head size
constexpr float RG_C = 8.0f;    // the rg-lru temperature constant

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// two consecutive elements to global memory
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// out[n] = part[0][n] + part[1][n] + ... + part[P - 1][n], summed in that
// order (the fixed order that keeps the backward deterministic)
template <typename T>
__global__ void __launch_bounds__(256)
sum_parts_kernel(const float* __restrict__ part, T* __restrict__ out,
                 long long n, int parts) {
  for (long long idx = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
       idx < n; idx += static_cast<long long>(gridDim.x) * 256) {
    float acc = part[idx];
    for (int p = 1; p < parts; ++p) acc += part[p * n + idx];
    out[idx] = from_f<T>(acc);
  }
}

template <typename T>
int sum_parts(const float* part, T* out, long long n, int parts,
              cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long want = (n + 255) / 256;
  const unsigned blocks = static_cast<unsigned>(want < 4096 ? want : 4096);
  sum_parts_kernel<T><<<blocks, 256, 0, stream>>>(part, out, n, parts);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// WKV6 backward
// ---------------------------------------------------------------------------

constexpr int WB_L = 16;              // steps a chunk
constexpr int WB_H = WB_L / 2;        // steps a half chunk
constexpr int WB_M = 6;               // chunks a segment (a checkpoint)
constexpr int WB_THREADS = 256;       // row warps 0-3, product warps 4-7
constexpr int WB_HALF = WB_THREADS / 2;
constexpr int WB_STATE = HD * HD;     // floats of a state (or its adjoint)
// row strides (in elements) that keep the fragment loads of the products
// free of bank conflicts, or nearly
constexpr int WB_VS = HD + 8;
constexpr int WB_DYS = HD + 4;
constexpr int WB_AS = WB_L + 8;
constexpr int WB_QS = HD + 4;
constexpr int WB_ES = HD + 8;
static_assert(WB_L == 16 && WB_M >= 2 && WB_THREADS == 256,
              "the WKV backward's layout: 16-step chunks, 4 + 4 warps");

// input stages: an item's, the next one's, those in flight (f32's larger
// stages: three fit beside the state slots)
template <typename T>
__host__ __device__ constexpr int wb_stages() {
  return sizeof(T) == 2 ? 4 : 3;
}

// one chunk's inputs, as cp.async brings them (a step past S: r = k = v =
// dy = 0 and w = 1, which leave S and G as they are); an item of the
// forward passes brings k, v and w only
template <typename T>
struct __align__(16) WbStage {
  T r[WB_L][HD];
  T k[WB_L][HD];
  T v[WB_L][WB_VS];
  float w[WB_L][HD];
  float dy[WB_L][WB_DYS];
};

// what the row warps build of a chunk for the products: A transposed
// (at[s][tau] = A[tau][s]), Q[t][i] = r_t . D_{t-1}, K[s][i] = k_s . E_s and
// D of the chunk, and within its halves K_lo[s] = k_s . prod_{s+1..7} w
// (s < 8) and Q_hi[t - 8] = r_t . prod_{8..t-1} w (t >= 8)
struct __align__(16) WbMix {
  float at[WB_L][WB_AS];
  float q[WB_L][WB_QS];
  float ke[WB_L][WB_ES];
  float kl[WB_H][WB_ES];
  float qh[WB_H][WB_ES];
  float dl[HD];
};

// what the products give the walk: C transposed (ct[s][tau] = C[tau][s] =
// dy_tau . v_s, a step's column of C one row), dQraw[t][i], dKraw[s][i],
// rd[i] = rowdot(G_out, S_in), and the two products that carry the walk
// across the chunk's halves: U[tau - 8] = sum_{s<8} C[tau,s] K_lo[s]
// (tau >= 8) and V[s] = sum_{tau>=8} C[tau,s] Q_hi[tau - 8] (s < 8)
struct __align__(16) WbGrads {
  float ct[WB_L][WB_L];
  float dq[WB_L][WB_ES];
  float dk[WB_L][WB_ES];
  float u[WB_H][WB_ES];
  float v[WB_H][WB_ES];
  float rd[HD];
};

// WB_M state slots and the adjoint G (swizzled, wb_sw), two WbMix (this
// item's and the next one's), WbGrads, the walk's exchange and the stages
template <typename T>
constexpr size_t wb_smem_bytes() {
  return sizeof(float) * ((WB_M + 1) * WB_STATE + WB_L * HD) +
         2 * sizeof(WbMix) + sizeof(WbGrads) +
         wb_stages<T>() * sizeof(WbStage<T>);
}

// Where element (i, j) of a state or of G lies: row i, its 8-float groups
// permuted by i (pi(i) = (i + i / 4) % 4 of i % 8, distinct over rows 0-3,
// 4-7, the even and the odd), so that the products' pair loads (a lane
// (g, q) at row g, columns 2q and 2q + 1, or rows 2q and 2q + 1, column
// g) and the accumulators' float2 at (g, 2q) meet distinct banks
__device__ __forceinline__ int wb_sw(int i, int j) {
  return i * HD + (j ^ (((i + (i >> 2)) & 3) << 3));
}

// one item of a CTA's sequence: chunk c run forward (the first pass, or a
// segment's rebuild, whose first item restores the checkpoint first) or
// walked back
struct WbItem {
  int c;
  bool bwd, pass1, restore;
};

// The CTA's item q: the first pass over every chunk; then the segments
// from the last, each but the last rebuilt forward (its first WB_M - 1
// chunks) and every one walked back from its last chunk.
__device__ __forceinline__ WbItem wb_item(int q, int nch, int nseg) {
  if (q < nch) return {q, false, true, false};
  q -= nch;
  const int last = nch - (nseg - 1) * WB_M;
  if (q < last) return {nch - 1 - q, true, false, false};
  q -= last;
  const int per = 2 * WB_M - 1, c0 = (nseg - 2 - q / per) * WB_M;
  const int m = q % per;
  if (m < WB_M - 1) return {c0 + m, false, false, m == 0};
  return {c0 + 2 * WB_M - 2 - m, true, false, false};
}

__device__ __forceinline__ int wb_items(int nch, int nseg) {
  return nch ? 2 * nch + (nseg - 1) * (WB_M - 1) : 0;
}

// cp.async of an item's chunk (rows from `base`, n of them inside S) into a
// stage, by the product warps' thread t; padding stored directly
template <typename T>
__device__ __forceinline__ void wb_load(WbStage<T>& st, const T* r,
                                        const T* k, const T* v,
                                        const float* w, const float* dy,
                                        long long base, long long row, int n,
                                        bool bwd, int t) {
  constexpr int PT = 16 / static_cast<int>(sizeof(T));  // elements a copy
  constexpr int PR = HD / PT;
  for (int p = t; p < WB_L * PR; p += WB_HALF) {
    const int s = p / PR, c = (p % PR) * PT;
    const long long o = base + s * row + c;
    if (s < n) {
      cp_async16(&st.k[s][c], k + o);
      cp_async16(&st.v[s][c], v + o);
      if (bwd) cp_async16(&st.r[s][c], r + o);
    } else {
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(&st.k[s][c]) = z;
      *reinterpret_cast<uint4*>(&st.v[s][c]) = z;
      *reinterpret_cast<uint4*>(&st.r[s][c]) = z;
    }
  }
  for (int p = t; p < WB_L * (HD / 4); p += WB_HALF) {
    const int s = p / (HD / 4), c = (p % (HD / 4)) * 4;
    const long long o = base + s * row + c;
    if (s < n) {
      cp_async16(&st.w[s][c], w + o);
      if (bwd) cp_async16(&st.dy[s][c], dy + o);
    } else {
      *reinterpret_cast<float4*>(&st.w[s][c]) = make_float4(1.f, 1.f, 1.f, 1.f);
      *reinterpret_cast<float4*>(&st.dy[s][c]) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// An operand element as the tensor cores take it: split into TF32 hi and
// lo where it is not exact in TF32 (kSplit), else whole
template <bool kSplit>
__device__ __forceinline__ Split wb_split(float x) {
  return kSplit ? split(x) : Split{bits(x), 0u};
}

// d[n] += A B for one warp: NT 8-column tiles of a 16-row tile, KS k steps
// of 8, the k index of each step permuted (slot q takes k = 2q, slot
// q + 4 takes k = 2q + 1, in both operands), so that fa(m, k) gives
// A(m, k) and A(m, k + 1) and fb(k, n) gives B(k, n) and B(k + 1, n), for
// even k: one 8-byte load where k is the contiguous index.  Each term
// hi.hi + lo.hi + hi.lo (the lo terms of an exact operand left out), hi.hi
// in d and the lo terms in lo (d itself where the chains are short and
// many, else an accumulator of its own, so that fewer tensor-core
// operations wait on the one before).
template <int NT, int KS, bool kSplitA, bool kSplitB, class FA, class FB>
__device__ __forceinline__ void wb_mma(float (&d)[NT][4], float (&lo)[NT][4],
                                       FA fa, FB fb, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int k0 = 8 * kk + 2 * q;
    const float2 x0 = fa(g, k0), x1 = fa(g + 8, k0);
    const Split a0 = wb_split<kSplitA>(x0.x), a1 = wb_split<kSplitA>(x1.x);
    const Split a2 = wb_split<kSplitA>(x0.y), a3 = wb_split<kSplitA>(x1.y);
    const uint32_t ah[4] = {a0.hi, a1.hi, a2.hi, a3.hi};
    const uint32_t al[4] = {a0.lo, a1.lo, a2.lo, a3.lo};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 y = fb(k0, 8 * n + g);
      const Split b0 = wb_split<kSplitB>(y.x), b1 = wb_split<kSplitB>(y.y);
      if (kSplitA) mma(lo[n], al, b0.hi, b1.hi);
      if (kSplitB) mma(lo[n], ah, b0.lo, b1.lo);
      mma(d[n], ah, b0.hi, b1.hi);
    }
  }
}

// two elements (x, y) of shared memory at p and p + stride
template <typename T>
__device__ __forceinline__ float2 lds_pair(const T* p, int stride) {
  return make_float2(to_f(p[0]), to_f(p[stride]));
}

// The rows of A and Q of one chunk (CUDA cores, f32), by row warp J: rows
// 4J .. 4J + 3, channels 2l and 2l + 1 a lane.  As the forward kernel's
// row walk (recurrent.cu wkv_rows): the warp walks s down from its last
// row's last active step, q = r_t . P_{s,t} gaining one factor a step, the
// lanes' parts of A[t, s] met by a reduce-scatter of shuffles; the walk
// ends at Q = r_t . D_{t-1}.  A is stored transposed, Q plain.
template <int J, typename T>
__device__ __forceinline__ void wb_rows(const WbStage<T>& st, WbMix& mx,
                                        float2 uu, int lane) {
  constexpr int t0 = 4 * J;
  const int c0 = 2 * lane;
  const bool b4 = (lane & 16) != 0, b3 = (lane & 8) != 0;
  float q[4][2], dg[4], m[WB_L];
#pragma unroll
  for (int rho = 0; rho < 4; ++rho) {
    const float2 rr = lds2(&st.r[t0 + rho][c0]);
    const float2 kk = lds2(&st.k[t0 + rho][c0]);
    q[rho][0] = rr.x;
    q[rho][1] = rr.y;
    dg[rho] = fmaf(rr.x * uu.x, kk.x, rr.y * uu.y * kk.y);
  }
#pragma unroll
  for (int s = WB_L - 1; s >= 0; --s) {
    // past every row of the block A is 0; the upper half's rows take s in
    // their own half (the rest is Q_hi K_lo^T, a product)
    if (s > t0 + 3 || (t0 >= WB_H && s < WB_H)) {
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
  const int t = t0 + 2 * b4 + b3;
  if (t0 < WB_H || lane % 8 >= WB_H / 2) {
    mx.at[2 * (lane % 8)][t] = m[0];
    mx.at[2 * (lane % 8) + 1][t] = m[1];
  }
  if (t0 >= WB_H) {
    // q = r_t . prod_{8..t-1} w = Q_hi; Q = Q_hi . prod_{0..7} w
    float2 wl = make_float2(1.0f, 1.0f);
#pragma unroll
    for (int s = 0; s < WB_H; ++s) {
      const float2 ww = lds2(&st.w[s][c0]);
      wl.x *= ww.x;
      wl.y *= ww.y;
    }
#pragma unroll
    for (int rho = 0; rho < 4; ++rho) {
      *reinterpret_cast<float2*>(&mx.qh[t0 + rho - WB_H][c0]) =
          make_float2(q[rho][0], q[rho][1]);
      q[rho][0] *= wl.x;
      q[rho][1] *= wl.y;
    }
  }
#pragma unroll
  for (int rho = 0; rho < 4; ++rho)
    *reinterpret_cast<float2*>(&mx.q[t0 + rho][c0]) =
        make_float2(q[rho][0], q[rho][1]);
}

// K = k_s . E_s and D of one chunk at channel i, E built from the chunk's
// end by forward multiplication
template <typename T>
__device__ __forceinline__ void wb_decay(const WbStage<T>& st, WbMix& mx,
                                         int i) {
  float kk[WB_L], ww[WB_L];
#pragma unroll
  for (int s = 0; s < WB_L; ++s) {
    kk[s] = to_f(st.k[s][i]);
    ww[s] = st.w[s][i];
  }
  float e = 1.0f;
#pragma unroll
  for (int s = WB_L - 1; s >= 0; --s) {
    mx.ke[s][i] = kk[s] * e;
    e *= ww[s];
  }
  mx.dl[i] = e;
}

// K_lo of one chunk at channel i, by forward multiplication within its
// half (Q_hi is the upper half's row walk's)
template <typename T>
__device__ __forceinline__ void wb_halves(const WbStage<T>& st, WbMix& mx,
                                          int i) {
  float e = 1.0f;
#pragma unroll
  for (int s = WB_H - 1; s >= 0; --s) {
    mx.kl[s][i] = to_f(st.k[s][i]) * e;
    e *= st.w[s][i];
  }
}

// Row warp `warp`'s share of building an item's mix: A and Q for a chunk
// walked back, and K_lo and Q_hi (warps 2 and 3, a channel a lane); K and
// D (warps 0 and 1) for every item
template <typename T>
__device__ __forceinline__ void wb_prep(const WbStage<T>& st, WbMix& mx,
                                        bool bwd, float2 uu, int warp,
                                        int lane) {
  if (bwd) {
    switch (warp) {
      case 0: wb_rows<0>(st, mx, uu, lane); break;
      case 1: wb_rows<1>(st, mx, uu, lane); break;
      case 2: wb_rows<2>(st, mx, uu, lane); break;
      default: wb_rows<3>(st, mx, uu, lane); break;
    }
    if (warp >= 2) wb_halves(st, mx, 32 * (warp - 2) + lane);
  }
  if (warp < 2) wb_decay(st, mx, 32 * warp + lane);
}

// One chunk forward, S_out = D . S_in + K^T V, for product warp a: rows
// [16a, 16a + 16) of the state, the update summed apart and added to D . S
// by an f32 fma, as the forward kernel does
template <typename T>
__device__ __forceinline__ void wb_forward(const WbStage<T>& st,
                                           const WbMix& mx, const float* sin,
                                           float* sout, int a, int lane) {
  constexpr bool kSplitV = sizeof(T) == 4;  // f32 v is not exact in TF32
  const int g = lane >> 2, q = lane & 3, i0 = 16 * a;
  float acc[8][4] = {};
  wb_mma<8, 2, true, kSplitV>(
      acc, acc, [&](int m, int s) { return lds_pair(&mx.ke[s][i0 + m], WB_ES); },
      [&](int s, int j) { return lds_pair(&st.v[s][j], WB_VS); }, lane);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = i0 + g + 8 * hf, o = wb_sw(i, 8 * n + 2 * q);
      const float dl = mx.dl[i];
      const float2 s = *reinterpret_cast<const float2*>(&sin[o]);
      *reinterpret_cast<float2*>(&sout[o]) =
          make_float2(fmaf(dl, s.x, acc[n][2 * hf]),
                      fmaf(dl, s.y, acc[n][2 * hf + 1]));
    }
}

// The products of a chunk walked back that the walk reads, for product
// warp a (thread t of the four warps): C's columns [8a, 8a + 8) for a < 2,
// dQraw's and dKraw's columns [16a, 16a + 16), and rd, two threads a row
template <typename T>
__device__ __forceinline__ void wb_grads(const WbStage<T>& st,
                                         WbMix& mx, const float* sin,
                                         const float* gs, WbGrads& gd, int a,
                                         int lane, int t) {
  constexpr bool kSplitV = sizeof(T) == 4;
  const int g = lane >> 2, q = lane & 3, i0 = 16 * a;
  auto dya = [&](int m, int j) { return lds2(&st.dy[m][j]); };
  if (a < 2) {
    float c[1][4] = {}, cl[1][4] = {};
    wb_mma<1, 8, true, kSplitV>(
        c, cl, dya, [&](int j, int s) { return lds2(&st.v[8 * a + s][j]); },
        lane);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      gd.ct[8 * a + 2 * q + e % 2][g + 8 * (e / 2)] = c[0][e] + cl[0][e];
  }
  float dq[2][4] = {}, dql[2][4] = {}, dk[2][4] = {}, dkl[2][4] = {};
  wb_mma<2, 8, true, true>(
      dq, dql, dya, [&](int j, int i) { return lds2(&sin[wb_sw(i0 + i, j)]); },
      lane);
  wb_mma<2, 8, kSplitV, true>(
      dk, dkl, [&](int s, int j) { return lds2(&st.v[s][j]); },
      [&](int j, int i) { return lds2(&gs[wb_sw(i0 + i, j)]); }, lane);
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = g + 8 * hf, i = i0 + 8 * n + 2 * q, e = 2 * hf;
      *reinterpret_cast<float2*>(&gd.dq[r][i]) =
          make_float2(dq[n][e] + dql[n][e], dq[n][e + 1] + dql[n][e + 1]);
      *reinterpret_cast<float2*>(&gd.dk[r][i]) =
          make_float2(dk[n][e] + dkl[n][e], dk[n][e + 1] + dkl[n][e + 1]);
    }
  const int i = t >> 1, j0 = 32 * (t & 1);
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < 32; c += 4) {
    const int o = wb_sw(i, j0 + c);
    const float4 gg = *reinterpret_cast<const float4*>(&gs[o]);
    const float4 ss = *reinterpret_cast<const float4*>(&sin[o]);
    acc = fmaf(gg.x, ss.x, acc);
    acc = fmaf(gg.y, ss.y, acc);
    acc = fmaf(gg.z, ss.z, acc);
    acc = fmaf(gg.w, ss.w, acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if ((t & 1) == 0) gd.rd[i] = acc;
  const float2 zero = make_float2(0.0f, 0.0f);
  if (a == 2) {  // A's block across the halves: A[8 + t][s] = Q_hi K_lo^T
    float x[1][4] = {}, xl[1][4] = {};
    wb_mma<1, 8, true, true>(
        x, xl,
        [&](int m, int j) { return m < WB_H ? lds2(&mx.qh[m][j]) : zero; },
        [&](int j, int s) { return lds2(&mx.kl[s][j]); }, lane);
    mx.at[2 * q][WB_H + g] = x[0][0] + xl[0][0];
    mx.at[2 * q + 1][WB_H + g] = x[0][1] + xl[0][1];
  }
  // U and V from the whole of C: columns [16a, 16a + 16) of each, rows
  // 8 .. 15 of the 16-row tile empty
  bar_sync<2, WB_HALF>();
  float u[2][4] = {}, ul[2][4] = {}, v[2][4] = {}, vl[2][4] = {};
  wb_mma<2, 1, true, true>(
      u, ul,
      [&](int m, int s) {
        return m < WB_H ? make_float2(gd.ct[s][WB_H + m], gd.ct[s + 1][WB_H + m])
                        : zero;
      },
      [&](int s, int i) { return lds_pair(&mx.kl[s][i0 + i], WB_ES); }, lane);
  wb_mma<2, 1, true, true>(
      v, vl,
      [&](int m, int tau) {
        return m < WB_H ? lds2(&gd.ct[m][WB_H + tau]) : zero;
      },
      [&](int tau, int i) { return lds_pair(&mx.qh[tau][i0 + i], WB_ES); },
      lane);
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int i = i0 + 8 * n + 2 * q;
    *reinterpret_cast<float2*>(&gd.u[g][i]) =
        make_float2(u[n][0] + ul[n][0], u[n][1] + ul[n][1]);
    *reinterpret_cast<float2*>(&gd.v[g][i]) =
        make_float2(v[n][0] + vl[n][0], v[n][1] + vl[n][1]);
  }
}

// The products of a chunk walked back that go on, for product warp a: dv's
// columns [16a, 16a + 16) (A^T dY + K G_out) to global memory, then, once
// every product warp is done reading G_out, rows [16a, 16a + 16) of
// G_in = D . G_out + Q^T dY in its place
template <typename T>
__device__ __forceinline__ void wb_adjoint(const WbStage<T>& st,
                                           const WbMix& mx, float* gs,
                                           T* __restrict__ dv, long long base,
                                           long long row, int n, int a,
                                           int lane) {
  const int g = lane >> 2, q = lane & 3, i0 = 16 * a;
  float d[2][4] = {}, dl[2][4] = {};
  wb_mma<2, 2, true, true>(
      d, dl, [&](int s, int tau) { return lds2(&mx.at[s][tau]); },
      [&](int tau, int j) { return lds_pair(&st.dy[tau][i0 + j], WB_DYS); },
      lane);
  wb_mma<2, 8, true, true>(
      d, dl, [&](int s, int i) { return lds2(&mx.ke[s][i]); },
      [&](int i, int j) {
        return make_float2(gs[wb_sw(i, i0 + j)], gs[wb_sw(i + 1, i0 + j)]);
      }, lane);
  float ga[8][4] = {};
  wb_mma<8, 2, true, true>(
      ga, ga, [&](int i, int t) { return lds_pair(&mx.q[t][i0 + i], WB_QS); },
      [&](int t, int j) { return lds_pair(&st.dy[t][j], WB_DYS); }, lane);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int s = g + 8 * hf;
      if (s < n)
        store2(dv + base + s * row + i0 + 8 * nt + 2 * q,
               d[nt][2 * hf] + dl[nt][2 * hf],
               d[nt][2 * hf + 1] + dl[nt][2 * hf + 1]);
    }
  bar_sync<2, WB_HALF>();
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = i0 + g + 8 * hf, o = wb_sw(i, 8 * nt + 2 * q);
      const float dl = mx.dl[i];
      const float2 x = *reinterpret_cast<const float2*>(&gs[o]);
      *reinterpret_cast<float2*>(&gs[o]) =
          make_float2(fmaf(dl, x.x, ga[nt][2 * hf]),
                      fmaf(dl, x.y, ga[nt][2 * hf + 1]));
    }
}

// rows [h, h + 8) of step t's column of C (a row of ct), as two 16-byte
// loads, into c[h .. h + 7]
__device__ __forceinline__ void wb_column(const WbGrads& gd, int t, int h,
                                          float (&c)[WB_L]) {
#pragma unroll
  for (int e = h; e < h + WB_H; e += 4) {
    const float4 x = *reinterpret_cast<const float4*>(&gd.ct[t][e]);
    c[e] = x.x;
    c[e + 1] = x.y;
    c[e + 2] = x.z;
    c[e + 3] = x.w;
  }
}

// The walk of a chunk at channel i (CUDA cores, f32, a thread a channel):
// warps 0-1 (kZ) carry Z through each half of the chunk, giving dr and the
// last term of dw (through t4); warps 2-3 give dk, du's part and the rest
// of dw.  Every decay product is a forward product (prefix, suffix or a
// Horner walk over the later steps).  The O(L^2) walks run within each
// half chunk; what crosses the halves comes from U and V, carried by one
// factor a step: (s < 8 <= t) P_{s,t} = El_s Dh_{t-1} with El_s =
// prod_{s+1..7} w and Dh_{t-1} = prod_{8..t-1} w.  Each step's column of
// C (its half) is loaded a step ahead.
template <typename T>
__device__ __forceinline__ void wb_walk(const WbStage<T>& st,
                                        const WbGrads& gd, float* t4,
                                        float ui, bool kZ, int i,
                                        T* __restrict__ dr,
                                        T* __restrict__ dk,
                                        float* __restrict__ dw,
                                        long long base, long long row, int n,
                                        float& du) {
  float r[WB_L], k[WB_L], w[WB_L], dq[WB_L], c[WB_L];
  float el[WB_H], dh[WB_H], cross[WB_H];
#pragma unroll
  for (int t = 0; t < WB_L; ++t) {
    r[t] = to_f(st.r[t][i]);
    k[t] = to_f(st.k[t][i]);
    w[t] = st.w[t][i];
    dq[t] = gd.dq[t][i];
  }
  {
    float e = 1.0f, d = 1.0f;
#pragma unroll
    for (int s = WB_H - 1; s >= 0; --s) {
      el[s] = e;
      e *= w[s];
    }
#pragma unroll
    for (int t = WB_H; t < WB_L; ++t) {
      dh[t - WB_H] = d;
      d *= w[t];
    }
  }
  wb_column(gd, 0, 0, c);
  if (kZ) {
    float u[WB_H], z[WB_L], t4v[WB_L];
#pragma unroll
    for (int m = 0; m < WB_H; ++m) {
      u[m] = gd.u[m][i];
      cross[m] = gd.v[m][i];
    }
    float pre = 1.0f;  // D_{t-1}
#pragma unroll
    for (int t = 0; t < WB_L; ++t) {
      const int end = t < WB_H ? WB_H : WB_L;  // the end of t's half
      if (t == 0 || t == WB_H)
#pragma unroll
        for (int tau = t; tau < end; ++tau) z[tau] = 0.0f;
      float cn[WB_L];
      if (t + 1 < WB_L) wb_column(gd, t + 1, t + 1 < WB_H ? 0 : WB_H, cn);
      // sum_{t<tau<end} P_{t,tau} r_tau Z_tau, by Horner from the half's end
      float acc = 0.0f;
#pragma unroll
      for (int tau = end - 1; tau > t; --tau)
        acc = fmaf(w[tau], acc, r[tau] * z[tau]);
      t4v[t] = acc;
      const float zt = t < WB_H ? z[t] : fmaf(dh[t - WB_H], u[t - WB_H], z[t]);
      const float d = fmaf(ui * k[t], c[t], fmaf(pre, dq[t], zt));
      if (t < n) dr[base + t * row + i] = from_f<T>(d);
#pragma unroll
      for (int tau = t + 1; tau < end; ++tau)
        z[tau] = fmaf(w[t], z[tau], c[tau] * k[t]);
      pre *= w[t];
#pragma unroll
      for (int tau = t + 1; tau < WB_L; ++tau)
        if (tau >= (t + 1 < WB_H ? 0 : WB_H) && tau < (t + 1 < WB_H ? WB_H : WB_L))
          c[tau] = cn[tau];
    }
    // the terms across the halves: El_t sum_{s<t} P_{s,t} k_s V_s (t < 8),
    // Dh_{t-1} sum_{tau>t} P_{t,tau} r_tau U_tau (t >= 8)
    float x = 0.0f, y = 0.0f;
#pragma unroll
    for (int t = 0; t < WB_H; ++t) {
      t4v[t] = fmaf(el[t], x, t4v[t]);
      x = fmaf(w[t], x, k[t] * cross[t]);
    }
#pragma unroll
    for (int t = WB_L - 1; t >= WB_H; --t) {
      t4v[t] = fmaf(dh[t - WB_H], y, t4v[t]);
      y = fmaf(w[t], y, r[t] * u[t - WB_H]);
    }
#pragma unroll
    for (int t = 0; t < WB_L; ++t) t4[t * HD + i] = t4v[t];
    bar_arrive<3, WB_HALF>();
    return;
  }
  // E_t, and Y_t = sum_{tau>t} P_{t,tau} r_tau dQraw_tau; Y's registers
  // then hold dw without its last term
  float kr[WB_L], suf[WB_L], y[WB_L];
#pragma unroll
  for (int t = 0; t < WB_L; ++t) kr[t] = gd.dk[t][i];
#pragma unroll
  for (int m = 0; m < WB_H; ++m) cross[m] = gd.v[m][i];
  suf[WB_L - 1] = 1.0f;
#pragma unroll
  for (int t = WB_L - 2; t >= 0; --t) suf[t] = suf[t + 1] * w[t + 1];
  y[WB_L - 1] = 0.0f;
#pragma unroll
  for (int t = WB_L - 1; t > 0; --t) y[t - 1] = fmaf(w[t], y[t], r[t] * dq[t]);
  const float rd = gd.rd[i];
  float x = 0.0f, pre = 1.0f;  // sum_{s<t} P_{s,t} k_s dKraw_s; D_{t-1}
#pragma unroll
  for (int t = 0; t < WB_L; ++t) {
    const int end = t < WB_H ? WB_H : WB_L;
    float cn[WB_L];
    if (t + 1 < WB_L) wb_column(gd, t + 1, t + 1 < WB_H ? 0 : WB_H, cn);
    // sum_{tau>t} C[tau,t] P_{t,tau} r_tau: within t's half by Horner, the
    // other half through V
    float acc = 0.0f;
#pragma unroll
    for (int tau = end - 1; tau > t; --tau)
      acc = fmaf(w[tau], acc, c[tau] * r[tau]);
    if (t < WB_H) acc = fmaf(el[t], cross[t], acc);
    const float d = fmaf(r[t] * ui, c[t], fmaf(suf[t], kr[t], acc));
    if (t < n) dk[base + t * row + i] = from_f<T>(d);
    du = fmaf(r[t] * k[t], c[t], du);
    y[t] = fmaf(suf[t] * pre, rd, fmaf(suf[t], x, pre * y[t]));
    x = fmaf(w[t], x, k[t] * kr[t]);
    pre *= w[t];
#pragma unroll
    for (int tau = t + 1; tau < WB_L; ++tau)
      if (tau >= (t + 1 < WB_H ? 0 : WB_H) && tau < (t + 1 < WB_H ? WB_H : WB_L))
        c[tau] = cn[tau];
  }
  bar_sync<3, WB_HALF>();
#pragma unroll
  for (int t = 0; t < WB_L; ++t)
    if (t < n) dw[base + t * row + i] = y[t] + t4[t * HD + i];
}

// Grid B H: CTA bh = (b, h).  ws holds the checkpoints of segments 1 ..
// nseg - 2 of each (b, h), 64 x 64 floats each as the slots lay them out;
// du_part [B, H, 64].
template <typename T>
__global__ void __launch_bounds__(WB_THREADS, 1)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                const float* __restrict__ dy,
                const float* __restrict__ ds_fin, T* __restrict__ dr,
                T* __restrict__ dk, T* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du_part,
                float* __restrict__ ds0, float* __restrict__ ws, int H,
                int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* slots = reinterpret_cast<float*>(smem);  // S_in of a segment's chunks
  float* gs = slots + WB_M * WB_STATE;            // G
  float* t4 = gs + WB_STATE;                      // the walk's exchange
  WbMix* mix = reinterpret_cast<WbMix*>(t4 + WB_L * HD);
  WbGrads* gd = reinterpret_cast<WbGrads*>(mix + 2);
  WbStage<T>* stg = reinterpret_cast<WbStage<T>*>(gd + 1);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bool rows = warp < 4;
  const long long row = static_cast<long long>(H) * HD;  // one time step
  const long long base = static_cast<long long>(b) * S * row + h * HD;
  const int nch = (S + WB_L - 1) / WB_L;
  const int nseg = (nch + WB_M - 1) / WB_M;
  const int nq = wb_items(nch, nseg);
  constexpr int NST = wb_stages<T>();
  const long long sb = static_cast<long long>(bh) * WB_STATE;
  float* wsp = ws + static_cast<long long>(bh) * max(nseg - 2, 0) * WB_STATE;

  for (int p = tid; p < WB_STATE / 4; p += WB_THREADS) {
    const int i = p / (HD / 4), j = (p % (HD / 4)) * 4;
    *reinterpret_cast<float4*>(&slots[wb_sw(i, j)]) =
        *reinterpret_cast<const float4*>(&s0[sb + i * HD + j]);
    *reinterpret_cast<float4*>(&gs[wb_sw(i, j)]) =
        *reinterpret_cast<const float4*>(&ds_fin[sb + i * HD + j]);
  }
  auto load = [&](int q) {  // by the product warps: a group an item
    if (q < nq) {
      const WbItem it = wb_item(q, nch, nseg);
      const int t0 = it.c * WB_L;
      wb_load(stg[q % NST], r, k, v, w, dy, base + t0 * row, row,
              min(WB_L, S - t0), it.bwd, tid - WB_HALF);
    }
    cp_async_commit();
  };
  if (!rows) {
#pragma unroll
    for (int q = 0; q < NST - 1; ++q) load(q);
    cp_async_wait<NST - 3>();  // items 0 and 1 are in
  }
  __syncthreads();
  const int ci = tid % HD;  // a walking thread's channel
  const float2 uu = *reinterpret_cast<const float2*>(&u[h * HD + 2 * lane]);
  const float ui = u[h * HD + ci];
  if (rows && nq > 0)
    wb_prep(stg[0], mix[0], wb_item(0, nch, nseg).bwd, uu, warp, lane);
  __syncthreads();
  float du = 0.0f;
  for (int q = 0; q < nq; ++q) {
    const WbItem it = wb_item(q, nch, nseg);
    const WbStage<T>& st = stg[q % NST];
    const int t0 = it.c * WB_L, n = min(WB_L, S - t0);
    const long long cb = base + static_cast<long long>(t0) * row;
    float* sin = slots + (it.c % WB_M) * WB_STATE;
    if (rows) {
      if (q + 1 < nq)
        wb_prep(stg[(q + 1) % NST], mix[(q + 1) & 1],
                wb_item(q + 1, nch, nseg).bwd, uu, warp, lane);
      if (it.bwd) {
        bar_sync<1, WB_THREADS>();  // the products' WbGrads are in
        wb_walk(st, *gd, t4, ui, warp < 2, ci, dr, dk, dw, cb, row, n, du);
      }
    } else {
      const int a = warp - 4, t = tid - WB_HALF;
      load(q + NST - 1);
      WbMix& mx = mix[q & 1];
      if (it.bwd) {
        wb_grads(st, mx, sin, gs, *gd, a, lane, t);
        bar_arrive<1, WB_THREADS>();
        wb_adjoint(st, mx, gs, dv, cb, row, n, a, lane);
      } else {
        const int seg = it.c / WB_M;
        if (it.restore) {  // the segment's checkpoint into slot 0
          for (int p = t; p < WB_STATE / 4; p += WB_HALF) {
            const int i = p / (HD / 4), j = (p % (HD / 4)) * 4;
            const float4 x =
                seg == 0
                    ? *reinterpret_cast<const float4*>(&s0[sb + i * HD + j])
                    : *reinterpret_cast<const float4*>(
                          &wsp[(seg - 1) * WB_STATE + 4 * p]);
            *reinterpret_cast<float4*>(
                &slots[seg == 0 ? wb_sw(i, j) : 4 * p]) = x;
          }
          bar_sync<2, WB_HALF>();
        }
        if (it.pass1 && it.c % WB_M == 0 && seg >= 1 && seg <= nseg - 2)
          for (int p = t; p < WB_STATE / 4; p += WB_HALF)
            *reinterpret_cast<float4*>(&wsp[(seg - 1) * WB_STATE + 4 * p]) =
                *reinterpret_cast<const float4*>(&slots[4 * p]);
        if (!(it.pass1 && it.c == nch - 1))
          wb_forward(st, mx, sin, slots + ((it.c + 1) % WB_M) * WB_STATE, a,
                     lane);
      }
      cp_async_wait<NST - 3>();  // item q + 2 is in
    }
    __syncthreads();
  }
  for (int p = tid; p < WB_STATE / 4; p += WB_THREADS) {
    const int i = p / (HD / 4), j = (p % (HD / 4)) * 4;
    *reinterpret_cast<float4*>(&ds0[sb + i * HD + j]) =
        *reinterpret_cast<const float4*>(&gs[wb_sw(i, j)]);
  }
  if (rows && warp >= 2) du_part[static_cast<long long>(bh) * HD + ci] = du;
}

// ---------------------------------------------------------------------------
// RG-LRU backward
// ---------------------------------------------------------------------------

constexpr int RB_LANES = 32;    // channels a CTA, a lane each
constexpr int RB_SLICES = 8;    // warps a CTA: a chunk's time slices
constexpr int RB_STEPS = 4;     // steps a slice
constexpr int RB_CHUNK = RB_SLICES * RB_STEPS;

// One step's gates as the reference computes them, with the intermediates
// its vjp reads
struct RgGates {
  float r, i, c, a, e, omz, h1, z, sq, ix;
};

__device__ __forceinline__ RgGates rglru_fwd_gates(float g_r, float g_i,
                                                   float x, float soft) {
  RgGates q;
  q.r = 1.0f / (1.0f + expf(-g_r));
  q.i = 1.0f / (1.0f + expf(-g_i));
  q.c = -RG_C * q.r;
  const float log_a = q.c * soft;
  q.a = expf(log_a);
  q.e = expf(2.0f * log_a);
  q.omz = 1.0f - q.e;
  q.h1 = fmaxf(q.omz, 0.0f);
  q.z = fminf(q.h1, 1.0f);
  q.sq = sqrtf(q.z);
  q.ix = q.i * x;
  return q;
}

// The step's cotangents from g = dL/dh_t and h_{t-1}: dgr, dgi, dx, and
// the step's part of dsp, as jax.vjp of the reference's lines computes
// them (clip = min(1, max(0, .)), each with a slope of 1/2 at a tie)
__device__ __forceinline__ void rglru_step_grads(const RgGates& q, float g,
                                                 float h_prev, float x,
                                                 float soft, float& dgr,
                                                 float& dgi, float& dx,
                                                 float& dsp) {
  const float ct_a = g * h_prev;
  const float ct_sq = g * q.ix;
  const float ct_ix = g * q.sq;
  const float ct_z = ct_sq * (0.5f / q.sq);
  const float dmin = q.h1 == q.z ? (q.z == 1.0f ? 0.5f : 1.0f) : 0.0f;
  const float dmax = q.omz == q.h1 ? (q.h1 == 0.0f ? 0.5f : 1.0f) : 0.0f;
  const float ct_omz = (ct_z * dmin) * dmax;
  const float ct_log_a = ct_a * q.a + (-ct_omz * q.e) * 2.0f;
  dgr = (ct_log_a * soft * -RG_C) * (q.r * (1.0f - q.r));
  dsp = ct_log_a * q.c;
  dgi = (ct_ix * x) * (q.i * (1.0f - q.i));
  dx = ct_ix * q.i;
}

// Grid (ceil(R / 32), B); thread (lane, warp k): channel 32 bx + lane,
// steps t0 + 4k .. t0 + 4k + 3 of each chunk from t0.
template <typename T>
__global__ void __launch_bounds__(RB_LANES * RB_SLICES, 3)
rglru_bwd_kernel(const float* __restrict__ gr, const float* __restrict__ gi,
                 const T* __restrict__ xc, const float* __restrict__ sp,
                 const float* __restrict__ h0, const float* __restrict__ hs,
                 const float* __restrict__ dhs,
                 const float* __restrict__ dh_last, float* __restrict__ dgr,
                 float* __restrict__ dgi, T* __restrict__ dxc,
                 float* __restrict__ dsp_part, float* __restrict__ dh0, int S,
                 int R) {
  // each slice's map x -> P x + Q (into its first step's predecessor),
  // two chunks apart; then the slices' dsp
  __shared__ float2 agg[2][RB_SLICES][RB_LANES];
  __shared__ float dsp_s[RB_SLICES][RB_LANES];
  const int lane = threadIdx.x % 32, k = threadIdx.x / 32;
  const int b = blockIdx.y, c = blockIdx.x * RB_LANES + lane;
  const bool on = c < R;
  const int cc = on ? c : R - 1;  // a lane past R computes on column R - 1
  const float soft = sp[cc];
  const long long hb = static_cast<long long>(b) * R + cc;
  const long long base = static_cast<long long>(b) * S * R + cc;
  // the adjoint carried into the last step of the chunk: a_{t1} g_{t1}
  float carry = dh_last[hb];
  float dsp_acc = 0.0f;
  const int nch = (S + RB_CHUNK - 1) / RB_CHUNK;
  for (int ch = nch - 1, par = 0; ch >= 0; --ch, par ^= 1) {
    const int ts = ch * RB_CHUNK + k * RB_STEPS;  // this slice's first step
    float g_r[RB_STEPS], g_i[RB_STEPS], x[RB_STEPS], d[RB_STEPS],
        hp[RB_STEPS], a[RB_STEPS];
#pragma unroll
    for (int e = 0; e < RB_STEPS; ++e) {
      const int t = ts + e;
      const bool in = t < S;
      const long long o = base + static_cast<long long>(in ? t : 0) * R;
      g_r[e] = gr[o];
      g_i[e] = gi[o];
      x[e] = to_f(xc[o]);
      d[e] = in ? dhs[o] : 0.0f;
      hp[e] = t > 0 && in ? hs[o - R] : h0[hb];
      // a step past the end: the identity map
      a[e] = in ? rglru_fwd_gates(g_r[e], g_i[e], x[e], soft).a : 1.0f;
    }
    // the slice's map: a_ts (d_ts + a_ts+1 (d_ts+1 + ... (d_last + x)))
    float pp = a[RB_STEPS - 1], pq = a[RB_STEPS - 1] * d[RB_STEPS - 1];
#pragma unroll
    for (int e = RB_STEPS - 2; e >= 0; --e) {
      pq = a[e] * (d[e] + pq);
      pp *= a[e];
    }
    agg[par][k][lane] = make_float2(pp, pq);
    __syncthreads();
    // the carry through the slices after this one (into this slice's last
    // step) and through all of them (into the chunk before)
    float ck = carry;
#pragma unroll
    for (int m = RB_SLICES - 1; m >= 0; --m) {
      if (m == k) ck = carry;
      const float2 f = agg[par][m][lane];
      carry = fmaf(f.x, carry, f.y);
    }
#pragma unroll
    for (int e = RB_STEPS - 1; e >= 0; --e) {
      const int t = ts + e;
      const float g = d[e] + ck;
      if (t < S) {
        const RgGates q = rglru_fwd_gates(g_r[e], g_i[e], x[e], soft);
        float d_gr, d_gi, d_x, d_sp;
        rglru_step_grads(q, g, hp[e], x[e], soft, d_gr, d_gi, d_x, d_sp);
        dsp_acc += d_sp;
        if (on) {
          const long long o = base + static_cast<long long>(t) * R;
          dgr[o] = d_gr;
          dgi[o] = d_gi;
          dxc[o] = from_f<T>(d_x);
        }
      }
      ck = a[e] * g;
    }
  }
  dsp_s[k][lane] = dsp_acc;
  __syncthreads();
  if (k == 0 && on) {
    float acc = dsp_s[0][lane];
#pragma unroll
    for (int m = 1; m < RB_SLICES; ++m) acc += dsp_s[m][lane];
    dsp_part[static_cast<long long>(b) * R + c] = acc;
    dh0[hb] = carry;
  }
}

template <typename T>
int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                    const float* w, const float* u, const float* s0,
                    const float* dy, const float* ds_fin, void* dr, void* dk,
                    void* dv, float* dw, float* du, float* ds0,
                    float* du_part, float* ws, int B, int H, int S,
                    cudaStream_t stream) {
  // the shared memory opted into once a device
  constexpr size_t smem = wb_smem_bytes<T>();
  static_assert(smem <= 232448, "the WKV backward's shared memory");
  constexpr int kDevices = 64;
  static bool opted_in[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kDevices || !opted_in[dev]) {
    err = cudaFuncSetAttribute(wkv6_bwd_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kDevices) opted_in[dev] = true;
  }
  wkv6_bwd_kernel<T><<<B * H, WB_THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, dy, ds_fin, static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), dw, du_part, ds0, ws, H, S);
  const int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  return sum_parts<float>(du_part, du, static_cast<long long>(H) * HD, B,
                          stream);
}

template <typename T>
int rglru_bwd_launch(const float* gr, const float* gi, const void* xc,
                     const float* sp, const float* h0, const float* hs,
                     const float* dhs, const float* dh_last, float* dgr,
                     float* dgi, void* dxc, float* dsp, float* dh0,
                     float* dsp_part, int B, int S, int R,
                     cudaStream_t stream) {
  const dim3 grid((R + RB_LANES - 1) / RB_LANES, B);
  rglru_bwd_kernel<T><<<grid, RB_LANES * RB_SLICES, 0, stream>>>(
      gr, gi, static_cast<const T*>(xc), sp, h0, hs, dhs, dh_last, dgr, dgi,
      static_cast<T*>(dxc), dsp_part, dh0, S, R);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return sum_parts<float>(dsp_part, dsp, R, B, stream);
}

}  // namespace

extern "C" {

// The WKV backward's checkpoint workspace, in floats: a 64 x 64 state a
// (b, h) and segment of WB_M chunks of WB_L steps, but the first and the
// last segment.
long long wkv6_scan_bwd_workspace(int B, int H, int S) {
  const long long chunks = (S + WB_L - 1) / WB_L;
  const long long segments = (chunks + WB_M - 1) / WB_M;
  return static_cast<long long>(B) * H * (segments > 2 ? segments - 2 : 0) *
         WB_STATE;
}

// dtype: 0 = f32, 1 = bf16 (of r, k, v, dr, dk, dv).  Every tensor
// contiguous and 16-byte aligned: r, k, v, w, dy, dr, dk, dv, dw
// [B, S, H, 64]; u, du [H, 64]; s0, ds_fin, ds0 [B, H, 64, 64];
// du_part [B, H, 64] f32 scratch; ws wkv6_scan_bwd_workspace(B, H, S)
// floats.  S >= 0, B H >= 1.  Returns cudaGetLastError() after the
// launches.
int wkv6_scan_bwd_launch(const void* r, const void* k, const void* v,
                      const float* w, const float* u, const float* s0,
                      const float* dy, const float* ds_fin, void* dr,
                      void* dk, void* dv, float* dw, float* du, float* ds0,
                      float* du_part, float* ws, int dtype, int B, int H,
                      int S, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? wkv6_bwd_launch<__nv_bfloat16>(r, k, v, w, u, s0, dy, ds_fin,
                                              dr, dk, dv, dw, du, ds0,
                                              du_part, ws, B, H, S, s)
             : wkv6_bwd_launch<float>(r, k, v, w, u, s0, dy, ds_fin, dr, dk,
                                      dv, dw, du, ds0, du_part, ws, B, H, S,
                                      s);
}

// dtype: 0 = f32, 1 = bf16 (of xc and dxc).  gr, gi, xc, hs, dhs, dgr, dgi,
// dxc [B, S, R]; sp, dsp [R]; h0, dh_last, dh0 [B, R]; dsp_part [B, R] f32
// scratch; all contiguous, S >= 1.  Returns cudaGetLastError().
int rglru_scan_bwd_launch(const float* gr, const float* gi, const void* xc,
                       const float* sp, const float* h0, const float* hs,
                       const float* dhs, const float* dh_last, float* dgr,
                       float* dgi, void* dxc, float* dsp, float* dh0,
                       float* dsp_part, int dtype, int B, int S, int R,
                       void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? rglru_bwd_launch<__nv_bfloat16>(gr, gi, xc, sp, h0, hs, dhs,
                                               dh_last, dgr, dgi, dxc, dsp,
                                               dh0, dsp_part, B, S, R, s)
             : rglru_bwd_launch<float>(gr, gi, xc, sp, h0, hs, dhs, dh_last,
                                       dgr, dgi, dxc, dsp, dh0, dsp_part, B,
                                       S, R, s);
}

const char* recurrent_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
