// The two time-step recurrences of the recurrent model families, for Hopper
// (sm_90a).  Hand-written CUDA C++ with a plain C interface (ctypes).
//
// Neither replaces a Pallas kernel: the reference leaves both to XLA, as a
// sequential lax.scan and a lax.associative_scan.  Eager PyTorch has no
// counterpart of either, and a Python loop over the sequence would launch
// some six operations a token and a layer (about 200,000 launches for one
// 1024-token prefill of rwkv6-7b), so each is one launch here.  Plain f32
// arithmetic, built without --use_fast_math: expf, sqrtf and the divisions
// round as IEEE f32 does.
//
// wkv6_scan replaces src/repro/models/recurrent.py:114-125, the step of
// rwkv_timemix_forward: per (b, h), with an hd x hd f32 state S (hd = 64),
//   y_t = r_t^T (S + u . k_t v_t^T),   S = w_t . S + k_t v_t^T
// (u and w_t scale the rows of their matrix).  One CTA per (b, h), 256
// threads: a column j of S and a group of 16 of its rows a thread, in
// registers; the four groups' parts of y_t[j] are summed through shared
// memory once a chunk.  WKV_CHUNK steps of r, k, v and w are staged in
// shared memory at once (three barriers a chunk) while the next chunk's
// inputs load into registers, so a step does not wait for a load's
// latency; a thread reads them four rows at a time (16-byte loads) into
// four partial sums.  One (b, h) has only 64 columns, so the rows are
// split to give each SM's schedulers several warps (a column a thread
// left one).  Bound (rwkv6-7b's prefill: B 4, S 1024, H 64): r, k, v in
// bf16 and w, y in f32, ~243 MB moved once, ~73 us at 3.35 TB/s, against
// 5.5 GFLOP, ~81 us at the f32 rate: the operations bound it.
//
// rglru_scan replaces src/repro/models/recurrent.py:205-212 and :215-236,
// the elementwise part of _rglru_gates with the diagonal recurrence of
// rglru_block_forward: per (b, channel c), over t,
//   r = sigmoid(gr), i = sigmoid(gi), log_a = -8 r softplus(lam),
//   a = exp(log_a), b = sqrt(clip(1 - exp(2 log_a), 0, 1)) (i x),
//   h = a h + b
// where gr, gi are the f32 gate pre-activations (x @ W + bias, left to a
// matrix product) and x the convolution's output.  One thread per (b, c),
// looping over t, with the inputs of RG_CHUNK steps loaded ahead (the
// steps after the last whole chunk, and so decode's one, one at a time);
// neighbouring threads read neighbouring channels, so every load is
// coalesced.  Bound (recurrentgemma-9b's prefill: B 4, S 1024,
// R 4096): gr, gi, h in f32 and x in bf16, ~235 MB, ~70 us.  The reference
// associates the products in another order (a log-depth scan), so the two
// agree to f32 rounding, not bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int HD = 64;          // the rwkv head size
constexpr float RG_C = 8.0f;    // the rg-lru temperature constant

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

constexpr int WKV_CHUNK = 8;    // time steps staged in shared memory at once
constexpr int WKV_GROUPS = 4;   // row groups of S: threads a column
constexpr int WKV_ROWS = HD / WKV_GROUPS;
constexpr int WKV_THREADS = HD * WKV_GROUPS;

template <typename T>
__global__ void __launch_bounds__(WKV_THREADS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_fin, int H, int S) {
  __shared__ __align__(16) float sr[WKV_CHUNK][HD], sk[WKV_CHUNK][HD],
      sw[WKV_CHUNK][HD], sv[WKV_CHUNK][HD], su[HD];
  // each row group's part of y, for every step of the chunk
  __shared__ float part[WKV_CHUNK][WKV_GROUPS][HD];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j = threadIdx.x % HD, g = threadIdx.x / HD, i0 = g * WKV_ROWS;
  const long long row = static_cast<long long>(H) * HD;  // one time step
  const long long base = static_cast<long long>(b) * S * row + h * HD + j;
  float st[WKV_ROWS];     // rows [i0, i0 + WKV_ROWS) of column j of S
  const float* sp = s0 + (static_cast<long long>(bh) * HD + i0) * HD + j;
#pragma unroll
  for (int i = 0; i < WKV_ROWS; ++i) st[i] = sp[i * HD];
  if (g == 0) su[j] = u[h * HD + j];
  // the inputs of the next chunk (row group 0 loads them), loading while
  // this chunk is computed
  float nr[WKV_CHUNK], nk[WKV_CHUNK], nv[WKV_CHUNK], nw[WKV_CHUNK];
  auto load = [&](int t0) {
#pragma unroll
    for (int c = 0; c < WKV_CHUNK; ++c) {
      const bool in = t0 + c < S;
      const long long o = base + (t0 + c) * row;
      nr[c] = in ? to_f(r[o]) : 0.f;
      nk[c] = in ? to_f(k[o]) : 0.f;
      nv[c] = in ? to_f(v[o]) : 0.f;
      nw[c] = in ? w[o] : 0.f;
    }
  };
  if (g == 0) load(0);
  for (int t0 = 0; t0 < S; t0 += WKV_CHUNK) {
    __syncthreads();  // every thread is done with the chunk before
    if (g == 0) {
#pragma unroll
      for (int c = 0; c < WKV_CHUNK; ++c) {
        sr[c][j] = nr[c];
        sk[c][j] = nk[c];
        sw[c][j] = nw[c];
        sv[c][j] = nv[c];
      }
    }
    __syncthreads();
    if (g == 0 && t0 + WKV_CHUNK < S) load(t0 + WKV_CHUNK);
#pragma unroll
    for (int c = 0; c < WKV_CHUNK; ++c) {
      if (t0 + c >= S) break;
      const float vj = sv[c][j];
      // four rows at a time: one 16-byte shared load of each of r, k, w
      // and u, and four partial sums
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < WKV_ROWS; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&sr[c][i0 + i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&sk[c][i0 + i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&sw[c][i0 + i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&su[i0 + i]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float kv = kk[e] * vj;
          acc[e] += rr[e] * (st[i + e] + uu[e] * kv);
          st[i + e] = ww[e] * st[i + e] + kv;
        }
      }
      part[c][g][j] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
    __syncthreads();
    // y of the chunk's steps: the row groups' parts summed, two outputs a
    // thread
    for (int q = threadIdx.x; q < WKV_CHUNK * HD; q += WKV_THREADS) {
      const int c = q / HD, jj = q % HD;
      if (t0 + c < S)
        y[base - j + jj + (t0 + c) * row] =
            (part[c][0][jj] + part[c][1][jj]) +
            (part[c][2][jj] + part[c][3][jj]);
    }
  }
  float* fp = s_fin + (static_cast<long long>(bh) * HD + i0) * HD + j;
#pragma unroll
  for (int i = 0; i < WKV_ROWS; ++i) fp[i * HD] = st[i];
}

constexpr int RG_THREADS = 128;
constexpr int RG_CHUNK = 8;     // time steps loaded ahead a thread

// one step of the rg-lru: the gates of (g_r, g_i) and h = a h + b
__device__ __forceinline__ float rglru_step(float h, float g_r, float g_i,
                                            float x, float soft) {
  const float rg = 1.0f / (1.0f + expf(-g_r));
  const float ig = 1.0f / (1.0f + expf(-g_i));
  const float log_a = -RG_C * rg * soft;
  const float a = expf(log_a);
  const float mult =
      sqrtf(fminf(fmaxf(1.0f - expf(2.0f * log_a), 0.0f), 1.0f));
  return a * h + mult * (ig * x);
}

template <typename T>
__global__ void __launch_bounds__(RG_THREADS)
rglru_kernel(const float* __restrict__ gr, const float* __restrict__ gi,
             const T* __restrict__ xc, const float* __restrict__ sp,
             const float* __restrict__ h0, float* __restrict__ hs,
             float* __restrict__ h_last, int B, int S, int R) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * RG_THREADS + threadIdx.x;
  if (idx >= static_cast<long long>(B) * R) return;
  const int b = static_cast<int>(idx / R), c = static_cast<int>(idx % R);
  const float soft = sp[c];
  float h = h0[idx];
  const long long base = static_cast<long long>(b) * S * R + c;
  // whole chunks: RG_CHUNK steps' inputs are loaded before any of them is
  // used, so that 3 RG_CHUNK loads a thread are in flight at once; only
  // the last multiply-add of a step waits for the step before
  int t0 = 0;
  for (; t0 + RG_CHUNK <= S; t0 += RG_CHUNK) {
    float g_r[RG_CHUNK], g_i[RG_CHUNK], x[RG_CHUNK];
#pragma unroll
    for (int j = 0; j < RG_CHUNK; ++j) {
      const long long o = base + static_cast<long long>(t0 + j) * R;
      g_r[j] = gr[o];
      g_i[j] = gi[o];
      x[j] = to_f(xc[o]);
    }
#pragma unroll
    for (int j = 0; j < RG_CHUNK; ++j) {
      h = rglru_step(h, g_r[j], g_i[j], x[j], soft);
      hs[base + static_cast<long long>(t0 + j) * R] = h;
    }
  }
  // the steps after the last whole chunk (every step of a decode), one at
  // a time
  for (; t0 < S; ++t0) {
    const long long o = base + static_cast<long long>(t0) * R;
    h = rglru_step(h, gr[o], gi[o], to_f(xc[o]), soft);
    hs[o] = h;
  }
  h_last[idx] = h;
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (of r, k, v).  Every tensor contiguous: r, k, v,
// w and y [B, S, H, 64], u [H, 64], s0 and s_fin [B, H, 64, 64].  Returns
// cudaGetLastError() after the launch.
int wkv6_scan_launch(const void* r, const void* k, const void* v,
                     const float* w, const float* u, const float* s0,
                     float* y, float* s_fin, int dtype, int B, int H, int S,
                     void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    wkv6_kernel<__nv_bfloat16><<<B * H, WKV_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(r),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), w, u, s0, y, s_fin, H, S);
  else
    wkv6_kernel<float><<<B * H, WKV_THREADS, 0, s>>>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), w, u, s0, y, s_fin, H, S);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = f32, 1 = bf16 (of xc).  gr, gi, xc and hs [B, S, R], sp [R],
// h0 and h_last [B, R], all contiguous.  Returns cudaGetLastError().
int rglru_scan_launch(const float* gr, const float* gi, const void* xc,
                      const float* sp, const float* h0, float* hs,
                      float* h_last, int dtype, int B, int S, int R,
                      void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(B) * R;
  const unsigned blocks = static_cast<unsigned>((n + RG_THREADS - 1) /
                                                RG_THREADS);
  if (dtype == 1)
    rglru_kernel<__nv_bfloat16><<<blocks, RG_THREADS, 0, s>>>(
        gr, gi, static_cast<const __nv_bfloat16*>(xc), sp, h0, hs, h_last, B,
        S, R);
  else
    rglru_kernel<float><<<blocks, RG_THREADS, 0, s>>>(
        gr, gi, static_cast<const float*>(xc), sp, h0, hs, h_last, B, S, R);
  return static_cast<int>(cudaGetLastError());
}

const char* recurrent_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
