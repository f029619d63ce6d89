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
// It needs S_{t-1} at every step in reverse order.  Dividing by w_t would
// not give it back: exp(-e^6) is 0 in f32, so a decay at the clip's top
// erases the state.  The launch instead runs the recurrence forward once,
// writing the state at each chunk's start (a checkpoint every WB_L steps,
// into a workspace the wrapper allocates), then walks the chunks backward,
// rebuilding a chunk's WB_L states from its checkpoint into registers.
// Every row i of S and G evolves alone, so a CTA takes WB_ROWS rows of one
// (b, h), a thread 4 columns of a row and 16 threads a row: dr, dk and dw
// sum over a row's 16 threads by shuffles; dv sums over rows, within a
// warp by a shuffle, over the CTA's warps in shared memory after each
// chunk, and over the WB_BLOCKS CTAs of a (b, h) in a second pass
// (sum_parts_kernel), as du does over the batch.  The forward kernel is not
// changed and writes no states: under remat the forward runs twice a step.
// Bound (rwkv6-7b's training shape: B 4, S 1024, H 64): r, k, v, dr, dk, dv
// in bf16 and w, dy, dw in f32, ~415 MB moved once, 124 us at 3.35 TB/s.
// This form does its ~19 GFLOP on the f32 pipe (~288 us at 67 TFLOP/s),
// plus the workspace (the checkpoints, ~268 MB written and read) and dv's
// partials (~268 MB written and read): the CUDA cores and those bytes
// bound it, not the inputs.  A chunked form on the tensor cores, as the
// forward's, is what would reach the bytes' bound.
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

namespace {

constexpr int HD = 64;          // the rwkv head size
constexpr float RG_C = 8.0f;    // the rg-lru temperature constant

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

constexpr int WB_L = 16;                       // steps a chunk (a checkpoint)
constexpr int WB_ROWS = 16;                    // rows of S a CTA
constexpr int WB_BLOCKS = HD / WB_ROWS;        // CTAs a (b, h)
constexpr int WB_COLS = 4;                     // columns of a row a thread
constexpr int WB_LANES = HD / WB_COLS;         // threads a row
constexpr int WB_THREADS = WB_ROWS * WB_LANES;
constexpr int WB_WARPS = WB_THREADS / 32;
static_assert(WB_LANES == 16 && WB_THREADS == 256 && WB_L == 16,
              "the WKV backward's layout: two rows a warp, 16 steps a chunk");

// one chunk's inputs (a step past S: r = k = v = dy = 0 and w = 1, so that
// it leaves S and G as they are) and what its reverse sweep leaves for the
// writes after it
struct WkvBwdSmem {
  float r[WB_L][WB_ROWS], k[WB_L][WB_ROWS], w[WB_L][WB_ROWS];
  float v[WB_L][HD], dy[WB_L][HD];
  float vdy[WB_L];                              // v_t . dy_t
  float dr[WB_L][WB_ROWS], dk[WB_L][WB_ROWS], dw[WB_L][WB_ROWS];
  float dv[WB_L][WB_WARPS][HD];                 // a warp's two rows' part
};

// Stage chunk c's inputs: r, k, w at the CTA's rows, a (step, row) a
// thread; v and dy at every column, steps 2 warp and 2 warp + 1, two columns
// a lane, with v . dy of the step (a lane's two products, then a butterfly
// over the warp).  With kBackward false only k, w and v are needed.
template <typename T, bool kBackward>
__device__ __forceinline__ void wkv_bwd_stage(
    WkvBwdSmem& sm, const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ dy, long long base, long long row, int t0,
    int S, int i0, int tid) {
  {
    const int s = tid / WB_ROWS, ri = tid % WB_ROWS;
    const bool in = t0 + s < S;
    const long long o = base + (t0 + s) * row + i0 + ri;
    sm.k[s][ri] = in ? to_f(k[o]) : 0.0f;
    sm.w[s][ri] = in ? w[o] : 1.0f;
    if (kBackward) sm.r[s][ri] = in ? to_f(r[o]) : 0.0f;
  }
  const int lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int e = 0; e < WB_L / WB_WARPS; ++e) {
    const int s = (WB_L / WB_WARPS) * warp + e;
    const bool in = t0 + s < S;
    const long long o = base + (t0 + s) * row;
    const float v0 = in ? to_f(v[o + lane]) : 0.0f;
    const float v1 = in ? to_f(v[o + lane + 32]) : 0.0f;
    sm.v[s][lane] = v0;
    sm.v[s][lane + 32] = v1;
    if (kBackward) {
      const float y0 = in ? dy[o + lane] : 0.0f;
      const float y1 = in ? dy[o + lane + 32] : 0.0f;
      sm.dy[s][lane] = y0;
      sm.dy[s][lane + 32] = y1;
      float d = fmaf(v1, y1, v0 * y0);
#pragma unroll
      for (int m = 16; m >= 1; m /= 2) d += __shfl_xor_sync(0xffffffffu, d, m);
      if (lane == 0) sm.vdy[s] = d;
    }
  }
}

// Grid (B H, WB_BLOCKS): CTA (bh, rb) takes rows [16 rb, 16 rb + 16) of
// (b, h)'s state; thread tid row 16 rb + tid / 16, columns 4 (tid % 16) ..
// + 3.  ws holds the checkpoints, a float4 a thread and chunk.
template <typename T>
__global__ void __launch_bounds__(WB_THREADS, 2)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                const float* __restrict__ dy,
                const float* __restrict__ ds_fin, T* __restrict__ dr,
                T* __restrict__ dk, float* __restrict__ dw,
                float* __restrict__ dv_part, float* __restrict__ du_part,
                float* __restrict__ ds0, float4* __restrict__ ws, int B,
                int H, int S) {
  __shared__ WkvBwdSmem sm;
  const int bh = blockIdx.x, rb = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ri = tid / WB_LANES, q = tid % WB_LANES, j0 = WB_COLS * q;
  const int i0 = WB_ROWS * rb, i = i0 + ri;
  const long long row = static_cast<long long>(H) * HD;  // one time step
  const long long base = static_cast<long long>(b) * S * row + h * HD;
  const int nch = (S + WB_L - 1) / WB_L;
  float4* wsp = ws + (static_cast<long long>(bh) * WB_BLOCKS + rb) * nch *
                         WB_THREADS + tid;
  const long long so = static_cast<long long>(bh) * HD * HD + i * HD + j0;
  const float ui = u[h * HD + i];

  // the recurrence forward, a checkpoint at each chunk's start
  {
    const float4 x = *reinterpret_cast<const float4*>(s0 + so);
    float s[WB_COLS] = {x.x, x.y, x.z, x.w};
    for (int c = 0; c < nch; ++c) {
      wsp[static_cast<long long>(c) * WB_THREADS] =
          make_float4(s[0], s[1], s[2], s[3]);
      wkv_bwd_stage<T, false>(sm, r, k, v, w, dy, base, row, c * WB_L, S, i0,
                              tid);
      __syncthreads();
#pragma unroll
      for (int t = 0; t < WB_L; ++t) {
        const float kk = sm.k[t][ri], ww = sm.w[t][ri];
        const float4 vv = *reinterpret_cast<const float4*>(&sm.v[t][j0]);
        s[0] = fmaf(ww, s[0], kk * vv.x);
        s[1] = fmaf(ww, s[1], kk * vv.y);
        s[2] = fmaf(ww, s[2], kk * vv.z);
        s[3] = fmaf(ww, s[3], kk * vv.w);
      }
      __syncthreads();
    }
  }

  // the reverse sweep, a chunk at a time from the last
  const float4 gx = *reinterpret_cast<const float4*>(ds_fin + so);
  float g[WB_COLS] = {gx.x, gx.y, gx.z, gx.w};
  float du_acc = 0.0f;
  for (int c = nch - 1; c >= 0; --c) {
    const int t0 = c * WB_L, n = min(WB_L, S - t0);
    wkv_bwd_stage<T, true>(sm, r, k, v, w, dy, base, row, t0, S, i0, tid);
    const float4 ck = wsp[static_cast<long long>(c) * WB_THREADS];
    __syncthreads();
    // S_{t0 - 1 + s} for s = 0 .. WB_L - 1, rebuilt from the checkpoint
    float hist[WB_L][WB_COLS];
    hist[0][0] = ck.x;
    hist[0][1] = ck.y;
    hist[0][2] = ck.z;
    hist[0][3] = ck.w;
#pragma unroll
    for (int t = 0; t + 1 < WB_L; ++t) {
      const float kk = sm.k[t][ri], ww = sm.w[t][ri];
      const float4 vv = *reinterpret_cast<const float4*>(&sm.v[t][j0]);
      const float ve[WB_COLS] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int e = 0; e < WB_COLS; ++e)
        hist[t + 1][e] = fmaf(ww, hist[t][e], kk * ve[e]);
    }
#pragma unroll
    for (int t = WB_L - 1; t >= 0; --t) {
      const float rr = sm.r[t][ri], kk = sm.k[t][ri], ww = sm.w[t][ri];
      const float4 vv = *reinterpret_cast<const float4*>(&sm.v[t][j0]);
      const float4 yy = *reinterpret_cast<const float4*>(&sm.dy[t][j0]);
      const float ve[WB_COLS] = {vv.x, vv.y, vv.z, vv.w};
      const float ye[WB_COLS] = {yy.x, yy.y, yy.z, yy.w};
      const float ruk = rr * ui * kk;
      float pr = 0.0f, pk = 0.0f, pw = 0.0f, pv[WB_COLS];
#pragma unroll
      for (int e = 0; e < WB_COLS; ++e) {
        pr = fmaf(hist[t][e], ye[e], pr);
        pk = fmaf(g[e], ve[e], pk);
        pw = fmaf(g[e], hist[t][e], pw);
        pv[e] = fmaf(g[e], kk, ruk * ye[e]);
        g[e] = fmaf(ww, g[e], rr * ye[e]);
      }
#pragma unroll
      for (int m = 1; m < WB_LANES; m *= 2) {
        pr += __shfl_xor_sync(0xffffffffu, pr, m);
        pk += __shfl_xor_sync(0xffffffffu, pk, m);
        pw += __shfl_xor_sync(0xffffffffu, pw, m);
      }
#pragma unroll
      for (int e = 0; e < WB_COLS; ++e)
        pv[e] += __shfl_xor_sync(0xffffffffu, pv[e], 16);
      if (q == 0) {
        const float vd = sm.vdy[t];
        sm.dr[t][ri] = fmaf(ui * kk, vd, pr);
        sm.dk[t][ri] = fmaf(rr * ui, vd, pk);
        sm.dw[t][ri] = pw;
        du_acc = fmaf(rr * kk, vd, du_acc);
      }
      if (lane < 16)
        *reinterpret_cast<float4*>(&sm.dv[t][warp][j0]) =
            make_float4(pv[0], pv[1], pv[2], pv[3]);
    }
    __syncthreads();
    // the chunk's outputs: dr, dk, dw at the CTA's rows, dv's part
    {
      const int t = tid / WB_ROWS, rr = tid % WB_ROWS;
      if (t < n) {
        const long long o = base + (t0 + t) * row + i0 + rr;
        dr[o] = from_f<T>(sm.dr[t][rr]);
        dk[o] = from_f<T>(sm.dk[t][rr]);
        dw[o] = sm.dw[t][rr];
      }
    }
    const long long plane = static_cast<long long>(B) * S * row;
    for (int idx = tid; idx < n * HD; idx += WB_THREADS) {
      const int t = idx / HD, j = idx % HD;
      float acc = sm.dv[t][0][j];
#pragma unroll
      for (int m = 1; m < WB_WARPS; ++m) acc += sm.dv[t][m][j];
      dv_part[rb * plane + base + (t0 + t) * row + j] = acc;
    }
  }
  *reinterpret_cast<float4*>(ds0 + so) = make_float4(g[0], g[1], g[2], g[3]);
  if (q == 0) du_part[static_cast<long long>(bh) * HD + i] = du_acc;
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
                    float* dv_part, float* du_part, float* ws, int B, int H,
                    int S, cudaStream_t stream) {
  const dim3 grid(B * H, WB_BLOCKS);
  wkv6_bwd_kernel<T><<<grid, WB_THREADS, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, dy, ds_fin, static_cast<T*>(dr),
      static_cast<T*>(dk), dw, dv_part, du_part, ds0,
      reinterpret_cast<float4*>(ws), B, H, S);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  err = sum_parts<T>(dv_part, static_cast<T*>(dv),
                     static_cast<long long>(B) * S * H * HD, WB_BLOCKS,
                     stream);
  if (err != 0) return err;
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
// (b, h) and chunk of WB_L steps.
long long wkv6_scan_bwd_workspace(int B, int H, int S) {
  const long long chunks = (S + WB_L - 1) / WB_L;
  return static_cast<long long>(B) * H * chunks * HD * HD;
}

// CTAs of a (b, h) in the WKV backward (dv's partials a CTA row block)
int wkv6_scan_bwd_blocks() { return WB_BLOCKS; }

// dtype: 0 = f32, 1 = bf16 (of r, k, v, dr, dk, dv).  Every tensor
// contiguous and 16-byte aligned: r, k, v, w, dy, dr, dk, dv, dw
// [B, S, H, 64]; u, du [H, 64]; s0, ds_fin, ds0 [B, H, 64, 64];
// dv_part [wkv6_scan_bwd_blocks(), B, S, H, 64] and du_part [B, H, 64] f32
// scratch; ws wkv6_scan_bwd_workspace(B, H, S) floats.  S >= 0, B H >= 1.
// Returns cudaGetLastError() after the launches.
int wkv6_scan_bwd_launch(const void* r, const void* k, const void* v,
                      const float* w, const float* u, const float* s0,
                      const float* dy, const float* ds_fin, void* dr,
                      void* dk, void* dv, float* dw, float* du, float* ds0,
                      float* dv_part, float* du_part, float* ws, int dtype,
                      int B, int H, int S, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? wkv6_bwd_launch<__nv_bfloat16>(r, k, v, w, u, s0, dy, ds_fin,
                                              dr, dk, dv, dw, du, ds0,
                                              dv_part, du_part, ws, B, H, S,
                                              s)
             : wkv6_bwd_launch<float>(r, k, v, w, u, s0, dy, ds_fin, dr, dk,
                                      dv, dw, du, ds0, dv_part, du_part, ws,
                                      B, H, S, s);
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
