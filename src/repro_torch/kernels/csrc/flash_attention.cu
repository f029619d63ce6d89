// Blocked causal / sliding-window / prefix-LM / bidirectional GQA attention
// with an online softmax, for Hopper (sm_90a).  Hand-written CUDA C++ with a
// plain C interface (ctypes).
//
// Replaces: src/repro/kernels/flash_attention.py:77 flash_attention (the
// Pallas TPU kernel, body _flash_kernel), and for the prefix-LM mask the
// query-chunked XLA attention src/repro/models/attention.py:135
// _gqa_attend_chunked.  Same function:
//   out = softmax(mask(q . k^T * d^-0.5)) . v,  head h reads KV head h / (H/K)
//   masked scores = -1e30 (finite, as the reference), kept where
//   cols < Sk and either cols <= rows (causal) and rows - cols < window (if
//   given), or rows < P and cols < P (a prefix of P positions that attend
//   to each other both ways; causal only, the reference's make_mask);
//   f32 running max m, denominator l and accumulator; out = acc / max(l, 1e-30)
//   in q's dtype.  Every row's allowed keys are one range [lo, hi): a row
//   below P takes [0, min(P, Sk)), any other row [row - window + 1,
//   min(Sk, row + 1)) when causal.  Each q block walks only the KV tiles
//   [lo, hi) it needs: hi = min(Sk, q0 + BQ) when causal, or min(Sk,
//   max(q0 + BQ, P)) for a block that starts below P; lo = floor(max(0,
//   q0 - (window - 1)) / BK) * BK with a window, 0 for a block that starts
//   below P.  With the finite sentinel a fully masked first
//   tile adds exp(0) garbage that the next real tile erases exactly
//   (alpha = exp(-1e30 - m) = 0); -INFINITY would give exp(-inf + inf) = NaN.
//
// Bound (llama3.2-1b prefill, the serving path's shape: B 4, H 32, K 8,
// S 1024, d 64, bf16, causal): 4 d B H S(S+1)/2 = 17.2 GFLOP, 17.4 us at
// 989 TFLOP/s, against 41.9 MB moved once, 12.5 us at 3.35 TB/s: the
// operations bound it, so the products go to the tensor cores at the rate
// only wgmma reaches, and the loads hide behind them.  What holds the
// kernel back in practice is the softmax (one 2^x and one bf16 conversion
// a score on the SFU-rate pipes, ~16 a clock an SM) and each CTA's start
// and end, which a grid of one CTA an SM cannot overlap.
//
// bf16 design (flash_bf16_kernel, one kernel for d = 16, 32, 64, 128, 256):
// * A CTA per (b*H + h, 128-row q block), 384 threads in three
//   warpgroups.  Warpgroup 0 is the producer: it gives registers back
//   (setmaxnreg.dec) and one thread issues every TMA load.  Warpgroups 1
//   and 2 are the consumers (setmaxnreg.inc), 64 q rows each.  Heads run
//   along x and q blocks, reversed, along y: the longest causal rows of
//   every head are launched first.  A prefix keeps that order: hi does
//   not decrease with q0 (max(q0 + BQ, P) for the blocks below P), so the
//   last blocks still walk the most tiles.
// * TMA.  4-D tensor maps (d, S, heads, B) over the strided views the model
//   passes, encoded on the host (cuTensorMapEncodeTiled through
//   cudaGetDriverEntryPoint, so no -lcuda) from the rows the Python helper
//   computes.  Q is loaded once; K and V tiles of BK rows (128; for
//   registers 64 at d = 128 and 32 at d = 256) go through a 3-stage ring,
//   each stage with a full barrier for K, one for V and an empty barrier
//   the 256 consumer threads arrive on.  TMA zero-fills rows past Sq / Sk.
//   A box is at most 64 columns (128 bytes) with the matching swizzle
//   (128B at d >= 64, two boxes at d = 128, four at d = 256; 64B at
//   d = 32; 32B at d = 16), the layout the wgmma descriptors below read.
// * S = Q K^T: wgmma m64nBKk16, Q and K both K-major from shared memory.
//   It is issued together with O += P V of the tile before, and the two
//   consumers take turns to issue (ping-pong on named barriers), so one's
//   softmax runs while the other's products hold the tensor cores.
// * Softmax on the accumulator fragments in f32, in log2 units: scores
//   scaled by d^-0.5 log2(e) and p = 2^(s - m) on the SFU (ex2.approx),
//   row max and sum in 4 chains and across the quad with shuffles.  The
//   per-element mask runs only on tiles the causal diagonal, the window's
//   edge, the prefix's edge or Sk's edge crosses (tile_needs_mask), as two
//   compares against each row's allowed key range.
// * O += P V: wgmma m64n(d)k16 with A = P from registers (the S accumulator
//   of two n8 tiles is the A fragment of one k16 step) and B = V read
//   MN-major from shared memory (transpose bit), so V is not gathered.  P
//   is carried as two bf16 parts, hi = bf16(p) and lo = bf16(p - hi), each
//   multiplied by V: a 16-bit mantissa for P, so P V is as accurate as the
//   reference's f32 p @ v.  A single bf16 rounding of P is one rounding
//   the serving path's decode attention does not make, and at
//   llama3.2-1b's width the random-weight model amplifies it into decode
//   logits far from the prefill's by layer 4.
// * Epilogue: acc / max(l, 1e-30) in bf16 into the consumer's (dead) Q
//   rows of shared memory, in the map's swizzle, then a TMA store that
//   clips the ragged Sq edge.
// f32 (flash_f32_kernel, not on the serving path): the same function and
// bounds on the CUDA cores (FMA) in 64-row blocks with expf, so that f32
// stays within 2e-5 of the plain version: two threads per q row (four at
// d = 256), each holding every other (fourth) element of q and of the
// accumulator.
// LSE: with a non-null lse pointer each row's log-sum-exp (natural units)
// is written in the epilogue, for the backward (flash_attention_bwd.cu);
// the serving path passes null and runs the same code as before.
// Later work: the q heads that share a KV head in one CTA, a persistent
// grid, fp8.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// One row of the wrapper's tensor-map table per tensor (q, k, v, o):
// dims (d, S, heads, B), byte strides of S, heads and B, the box
// (columns, rows) and the swizzle in bytes (0 for f32).
enum MapField {
  M_D, M_S, M_HEADS, M_B, M_ROW, M_HEAD, M_BATCH, M_BOX_COLS, M_BOX_ROWS,
  M_SWIZZLE, MAP_FIELDS
};

struct Shape {
  int H, group, Sq, Sk, causal, window;  // window 0 = none
  int prefix;   // P of the prefix-LM mask; 0 = none, and 0 unless causal
  float scale;  // d^-0.5; for bf16 d^-0.5 * log2(e) (scores in log2 units)
  float* lse;   // [B * H, Sq] each row's log-sum-exp (natural units), or
                // null: the serving path asks for none
};

constexpr float LN2 = 0.6931471805599453f;

template <int BQ, int BK>
__device__ __forceinline__ void kv_range(const Shape& a, int q0, int& lo,
                                         int& hi) {
  const bool in_prefix = q0 < a.prefix;
  hi = a.causal ? min(a.Sk, in_prefix ? max(q0 + BQ, a.prefix) : q0 + BQ)
                : a.Sk;
  lo = 0;
  if (a.window > 0 && !in_prefix)
    lo = (max(0, q0 - (a.window - 1)) / BK) * BK;
}

__device__ __forceinline__ bool allowed(const Shape& a, int row, int col) {
  bool ok = true;
  if (a.causal) ok = col <= row;
  if (a.window > 0) ok = ok && (row - col) < a.window;
  ok = ok || (row < a.prefix && col < a.prefix);
  return ok && col < a.Sk;
}

// Whether rows [r0, r0 + 64) against keys [k0, k0 + BK) need the
// per-element mask: some key past Sk, past P for a row below P, above the
// diagonal or out of the window for a row at or past P.  Elsewhere every
// element is allowed.
template <int BK>
__device__ __forceinline__ bool tile_needs_mask(const Shape& a, int r0,
                                                int k0) {
  bool m = k0 + BK > a.Sk;
  if (r0 < a.prefix) m = m || k0 + BK > a.prefix;
  if (r0 + 63 >= a.prefix)
    m = m || (a.causal && k0 + BK - 1 > max(r0, a.prefix)) ||
        (a.window > 0 && r0 + 63 - k0 >= a.window);
  return m;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

// ---------------------------------------------------------------------------
// bf16: TMA, mbarriers, wgmma
// ---------------------------------------------------------------------------

// two bf16 values in one register, the lower column in the low half
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}

// x = hi + lo to a 16-bit mantissa: both parts of two values, packed
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

// 2^x on the SFU (one MUFU.EX2; results below 2^-126 flush to 0, and the
// -1e30 sentinel gives exactly 0 as exp does)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait for the completion of the barrier's phase of the given parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode (1 = 128B, 2 = 64B, 3 = 32B)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(mode) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups are pending (they retire in order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads of an accumulator above the wait, or
// reusing an A register before it
__device__ __forceinline__ void hold(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

__device__ __forceinline__ void hold(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

template <int N>
__device__ __forceinline__ void hold(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) hold(x[i]);
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) hold(x[i][r]);
}

// S (+)= A B^T, m64n32k16: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// S (+)= A B^T, m64n64k16: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// S (+)= A B^T, m64n128k16: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O += A B, m64n16k16: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += A B, m64n32k16: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += A B, m64n64k16: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += A B, m64n128k16: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += A B, m64n256k16: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The bf16 tiling for head dimension D: 128 q rows (two consumers of 64),
// BK KV rows a tile, boxes of SPAN columns with a SPAN * 2 byte swizzle.
// The accumulator of a consumer's 64 rows holds D / 2 floats a thread, so
// the KV tile shrinks as D grows: 128 rows to d = 64, 64 at d = 128, 32 at
// d = 256 (128 accumulators, 16 scores and 16 words of P a thread).
template <int D>
struct Tile {
  static constexpr int BQ = 128;
  static constexpr int BK = D == 256 ? 32 : D == 128 ? 64 : 128;
  static constexpr int STAGES = 3;
  static constexpr int SPAN = D < 64 ? D : 64;
  static constexpr int ROWB = SPAN * 2;        // bytes of a box row
  static constexpr int BOXES = D / SPAN;
  static constexpr uint32_t MODE = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  static constexpr uint32_t SWZ = ROWB / 16 - 1;  // row bits the XOR takes
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int BARS = 1 + 3 * STAGES;
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARS;
};

constexpr int WG_THREADS = 128;
constexpr int BF16_THREADS = 3 * WG_THREADS;

// S = Q K^T for one consumer's 64 rows: D / 16 k-steps, 32 bytes apart
// inside a box row, the next box BQ (Q) or BK (K) box rows further
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[Tile<D>::BK / 2],
                                         uint32_t sQc, uint32_t sKs) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int x = kk / (T::SPAN / 16), in = (kk % (T::SPAN / 16)) * 32;
    wgmma_ss(sc,
             smem_desc(sQc + x * T::BQ * T::ROWB + in, 16, 8 * T::ROWB,
                       T::MODE),
             smem_desc(sKs + x * T::BK * T::ROWB + in, 16, 8 * T::ROWB,
                       T::MODE),
             kk > 0);
  }
}

// O += P V, the hi and then the lo part of P: V MN-major, 16 keys (16 box
// rows) a k-step; the second box of d = 128 is BK box rows further (the
// leading byte offset)
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&o)[D / 2], const uint32_t (&ph)[Tile<D>::BK / 16][4],
    const uint32_t (&pl)[Tile<D>::BK / 16][4], uint32_t sVs) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < T::BK / 16; ++kk) {
    const uint64_t dv = smem_desc(sVs + kk * 16 * T::ROWB, T::BK * T::ROWB,
                                  8 * T::ROWB, T::MODE);
    wgmma_rs(o, ph[kk], dv);
    wgmma_rs(o, pl[kk], dv);
  }
}

// One consumer's online-softmax state: its two rows per thread
struct RowState {
  int lo0, hi0, lo1, hi1;       // the allowed keys [lo, hi) of the 2 rows
  float m0, m1, l0, l1;         // running max and denominator
};

// RowState of q row `row` and row + 8: keys below Sk, at or below the row
// (causal) and within the window (if any); below P for a row below P
__device__ __forceinline__ RowState row_state(const Shape& a, int row) {
  auto lo = [&](int r) {
    return a.window > 0 && r >= a.prefix ? r - a.window + 1 : -(1 << 30);
  };
  auto hi = [&](int r) {
    return a.causal ? min(a.Sk, r < a.prefix ? a.prefix : r + 1) : a.Sk;
  };
  return {lo(row), hi(row), lo(row + 8), hi(row + 8), NEG_INF, NEG_INF, 0.f,
          0.f};
}

// The online softmax of an S tile (keys from k0) in place, in log2 units:
// scale by d^-0.5 log2(e), mask (edge tiles only), update the running max
// and denominator, and leave p = 2^(s - m) = e^(s' - m') in sc (s', m' the
// natural-unit score and max).  Returns the factors alpha by which the
// accumulator rows must be rescaled.  The row max and sum run as 4
// independent chains each, so the latency of one chain does not stall the
// warp.
template <int D>
__device__ __forceinline__ void softmax_tile(float (&sc)[Tile<D>::BK / 2],
                                             const Shape& a, int k0, int t,
                                             bool mask, RowState& st,
                                             float& alpha0, float& alpha1) {
  constexpr int BK = Tile<D>::BK, C = 4;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] *= a.scale;
  if (mask) {
    // element (j, e) is key k0 + 2 t + 8 j + (e & 1): against the rows'
    // ranges shifted by k0 + 2 t, two compares with an immediate
    const int base = k0 + 2 * t;
    const int lo0 = st.lo0 - base, hi0 = st.hi0 - base;
    const int lo1 = st.lo1 - base, hi1 = st.hi1 - base;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int off = 8 * j + (e & 1);
        const bool ok = e < 2 ? off >= lo0 && off < hi0
                              : off >= lo1 && off < hi1;
        sc[4 * j + e] = ok ? sc[4 * j + e] : NEG_INF;
      }
  }
  float mx0[C], mx1[C], rs0[C], rs1[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    mx0[i] = mx1[i] = NEG_INF;
    rs0[i] = rs1[i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx0[j % C] = fmaxf(mx0[j % C], fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1[j % C] = fmaxf(mx1[j % C], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  const float mn0 = fmaxf(
      st.m0, quad_max(fmaxf(fmaxf(mx0[0], mx0[1]), fmaxf(mx0[2], mx0[3]))));
  const float mn1 = fmaxf(
      st.m1, quad_max(fmaxf(fmaxf(mx1[0], mx1[1]), fmaxf(mx1[2], mx1[3]))));
  alpha0 = exp2_ftz(st.m0 - mn0);
  alpha1 = exp2_ftz(st.m1 - mn1);
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    sc[4 * j] = exp2_ftz(sc[4 * j] - mn0);
    sc[4 * j + 1] = exp2_ftz(sc[4 * j + 1] - mn0);
    sc[4 * j + 2] = exp2_ftz(sc[4 * j + 2] - mn1);
    sc[4 * j + 3] = exp2_ftz(sc[4 * j + 3] - mn1);
    rs0[j % C] += sc[4 * j] + sc[4 * j + 1];
    rs1[j % C] += sc[4 * j + 2] + sc[4 * j + 3];
  }
  st.l0 = alpha0 * st.l0 + quad_sum((rs0[0] + rs0[1]) + (rs0[2] + rs0[3]));
  st.l1 = alpha1 * st.l1 + quad_sum((rs1[0] + rs1[1]) + (rs1[2] + rs1[3]));
  st.m0 = mn0;
  st.m1 = mn1;
}

// P as A fragments, hi and lo parts: keys [16 kk, 16 kk + 16) are the n8
// tiles 2 kk and 2 kk + 1 of S
template <int D>
__device__ __forceinline__ void split_p(const float (&sc)[Tile<D>::BK / 2],
                                        uint32_t (&ph)[Tile<D>::BK / 16][4],
                                        uint32_t (&pl)[Tile<D>::BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < Tile<D>::BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], ph[kk][r],
             pl[kk][r]);
}

template <int D>
__global__ void __launch_bounds__(BF16_THREADS, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv,
                  const __grid_constant__ CUtensorMap mo, const Shape a) {
  using T = Tile<D>;
  constexpr int BQ = T::BQ, BK = T::BK, STAGES = T::STAGES;
  constexpr int ROWB = T::ROWB, SPAN = T::SPAN, BOXES = T::BOXES;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the swizzle patterns repeat every 1024 bytes
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + T::Q_BYTES;                 // STAGES tiles
  const uint32_t sV = sK + STAGES * T::KV_BYTES;       // STAGES tiles
  const uint32_t bars = sV + STAGES * T::KV_BYTES;
  const uint32_t barQ = bars;
  auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  auto full_v = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * STAGES + s); };

  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H, kh = h / a.group;
  const int wg = threadIdx.x / WG_THREADS;
  int lo, hi;
  kv_range<BQ, BK>(a, q0, lo, hi);

  if (threadIdx.x == 0) {
    mbar_init(barQ, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 2 * WG_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(barQ, T::Q_BYTES);
      for (int x = 0; x < BOXES; ++x)
        tma_load(sQ + x * BQ * ROWB, &mq, x * SPAN, q0, h, b, barQ);
      int s = 0;
      uint32_t phase = 0;
      for (int k0 = lo; k0 < hi; k0 += BK) {
        mbar_wait(empty(s), phase ^ 1);   // passes at once on the first lap
        mbar_expect_tx(full_k(s), T::KV_BYTES);
        for (int x = 0; x < BOXES; ++x)
          tma_load(sK + s * T::KV_BYTES + x * BK * ROWB, &mk, x * SPAN, k0,
                   kh, b, full_k(s));
        mbar_expect_tx(full_v(s), T::KV_BYTES);
        for (int x = 0; x < BOXES; ++x)
          tma_load(sV + s * T::KV_BYTES + x * BK * ROWB, &mv, x * SPAN, k0,
                   kh, b, full_v(s));
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;      // fragment coordinates
    const int r0 = q0 + 64 * c;                // this consumer's first row
    const int row0 = r0 + 16 * warp + g;       // and row0 + 8
    // this consumer's Q rows: box x at sQ + x * BQ * ROWB, row 64 c
    const uint32_t sQc = sQ + 64 * c * ROWB;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    RowState st = row_state(a, row0);
    float alpha0, alpha1;
    uint32_t ph[BK / 16][4], pl[BK / 16][4];  // P of the tile before

    // Ping-pong: the consumers take turns to issue their products (named
    // barriers 3 and 4), so that one's softmax runs while the other's
    // products occupy the tensor cores (issuing a warpgroup's products
    // takes about as long as they run; left alone, the two consumers fall
    // into step and their softmaxes collide).  Consumer 1 lets consumer 0
    // go first and passes no turn after its last issue, so every arrival
    // meets a wait.
    const int turns = lo < hi ? (hi - lo + BK - 1) / BK + 1 : 0;
    int turn = 0;
    auto take_turn = [&] {
      asm volatile("bar.sync %0, %1;\n" ::"r"(3 + c), "n"(2 * WG_THREADS)
                   : "memory");
    };
    auto pass_turn = [&] {
      if (++turn < turns || c == 0)
        asm volatile("bar.arrive %0, %1;\n" ::"r"(4 - c),
                     "n"(2 * WG_THREADS)
                     : "memory");
    };
    if (c == 1 && turns > 0)
      asm volatile("bar.arrive 3, %0;\n" ::"n"(2 * WG_THREADS) : "memory");

    mbar_wait(barQ, 0);
    int s = 0;
    uint32_t phase = 0;
    if (lo < hi) {
      float sc[BK / 2];
      mbar_wait(full_k(0), 0);
      take_turn();
      wgmma_fence();
      issue_qk<D>(sc, sQc, sK);
      wgmma_commit();
      pass_turn();
      wgmma_wait<0>();
      hold(sc);
      softmax_tile<D>(sc, a, lo, t, tile_needs_mask<BK>(a, r0, lo), st, alpha0,
                      alpha1);
      split_p<D>(sc, ph, pl);
    }                                          // (o is 0: no rescale)
    // Every tile after the first: S of this tile and P V of the tile before
    // are issued in one turn; the softmax of this tile follows.
    for (int k0 = lo + BK; k0 < hi; k0 += BK) {
      const int sp = s;                        // the tile before
      const uint32_t pp = phase;
      if (++s == STAGES) {
        s = 0;
        phase ^= 1;
      }
      float sc[BK / 2];
      mbar_wait(full_k(s), phase);
      mbar_wait(full_v(sp), pp);
      take_turn();
      wgmma_fence();
      issue_qk<D>(sc, sQc, sK + s * T::KV_BYTES);
      wgmma_commit();
      issue_pv<D>(o, ph, pl, sV + sp * T::KV_BYTES);
      wgmma_commit();
      pass_turn();
      wgmma_wait<1>();                         // S of this tile is done
      hold(sc);
      softmax_tile<D>(sc, a, k0, t, tile_needs_mask<BK>(a, r0, k0), st,
                      alpha0, alpha1);
      wgmma_wait<0>();                         // P V of the tile before
      hold(o);
      hold(ph);
      hold(pl);
      mbar_arrive(empty(sp));
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= alpha0;
        o[4 * j + 1] *= alpha0;
        o[4 * j + 2] *= alpha1;
        o[4 * j + 3] *= alpha1;
      }
      split_p<D>(sc, ph, pl);
    }
    if (lo < hi) {                             // P V of the last tile
      mbar_wait(full_v(s), phase);
      take_turn();
      wgmma_fence();
      issue_pv<D>(o, ph, pl, sV + s * T::KV_BYTES);
      wgmma_commit();
      pass_turn();
      wgmma_wait<0>();
      hold(o);
      hold(ph);
      hold(pl);
      mbar_arrive(empty(s));
    }

    // epilogue: bf16 rows into this consumer's Q rows (the map's swizzle:
    // 16-byte chunk ^= bits 7.. of the offset), then one TMA store a box
    const uint32_t bar_id = 1 + c;
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar_id), "r"(WG_THREADS)
                 : "memory");
    const float d0 = fmaxf(st.l0, 1e-30f), d1 = fmaxf(st.l1, 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const int x = col / SPAN, cc = col % SPAN;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * warp + g + 8 * half;
        const uint32_t off = x * BQ * ROWB + r * ROWB + cc * 2;
        const uint32_t swz = off ^ (((off >> 7) & T::SWZ) << 4);
        const float den = half ? d1 : d0;
        const uint32_t val = pack2f(o[4 * j + 2 * half] / den,
                                    o[4 * j + 2 * half + 1] / den);
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(sQc + swz), "r"(val)
                     : "memory");
      }
    }
    // the rows' log-sum-exp, m + log2(l) in log2 units, stored natural
    if (a.lse != nullptr && t == 0) {
      float* lp = a.lse + static_cast<long long>(blockIdx.x) * a.Sq;
      if (row0 < a.Sq) lp[row0] = (st.m0 + log2f(d0)) * LN2;
      if (row0 + 8 < a.Sq) lp[row0 + 8] = (st.m1 + log2f(d1)) * LN2;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar_id), "r"(WG_THREADS)
                 : "memory");
    if (tid == 0) {
      for (int x = 0; x < BOXES; ++x)
        tma_store(&mo, sQc + x * BQ * ROWB, x * SPAN, r0, h, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F32_BQ = 64;      // q rows per CTA (the loop bounds' unit)
constexpr int F32_BK = 64;      // KV rows per tile of the bounds

// The f32 tiling for head dimension D: TPR threads a q row, each holding
// D / TPR elements of q and of the accumulator (64 at most), and SUB KV rows
// a sub-tile in static shared memory (K and V: 2 SUB D floats, 32 KB at
// most).
template <int D>
struct F32Tile {
  static constexpr int TPR = D == 256 ? 4 : 2;
  static constexpr int THREADS = F32_BQ * TPR;
  static constexpr int SUB = D == 256 ? 16 : 32;
};

struct F32Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;                     // contiguous [B, H, Sq, D]
  long long q_sb, q_sh, q_ss;   // element strides; the last dim is contiguous
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
};

// rows [r0, r0 + SUB) of a [*, D] f32 matrix into shared memory, 16 bytes
// a thread; rows at or past nrows are zero
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long stride, int r0,
                                              int nrows) {
  using T = F32Tile<D>;
  constexpr int CHUNKS = D / 4;
  for (int i = threadIdx.x; i < T::SUB * CHUNKS; i += T::THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < nrows)
      val = *reinterpret_cast<const float4*>(src + (r0 + r) * stride + c);
    *reinterpret_cast<float4*>(dst + r * D + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(F32Tile<D>::THREADS)
flash_f32_kernel(const F32Args p, const Shape a) {
  using T = F32Tile<D>;
  constexpr int TPR = T::TPR, SUB = T::SUB;
  constexpr int DH = D / TPR;   // elements of q / acc per thread
  __shared__ __align__(16) float sK[SUB * D];
  __shared__ __align__(16) float sV[SUB * D];

  const int q0 = (gridDim.x - 1 - blockIdx.x) * F32_BQ;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H, kh = h / a.group;
  // this thread's elements: TPR i + half
  const int half = threadIdx.x % TPR;
  const int row = q0 + threadIdx.x / TPR;
  const float* qp = p.q + b * p.q_sb + h * p.q_sh;
  const float* kp = p.k + b * p.k_sb + kh * p.k_sh;
  const float* vp = p.v + b * p.v_sb + kh * p.v_sh;

  float q[DH], acc[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    q[i] = row < a.Sq ? qp[row * p.q_ss + TPR * i + half] : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  int lo, hi;
  kv_range<F32_BQ, F32_BK>(a, q0, lo, hi);
  // the 64-row tiles of the bounds, each taken as SUB-row sub-tiles
  for (int k0 = lo; k0 < hi; k0 += SUB) {
    load_tile_f32<D>(sK, kp, p.k_ss, k0, a.Sk);
    load_tile_f32<D>(sV, vp, p.v_ss, k0, a.Sk);
    __syncthreads();
    float s[SUB];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      const float* kr = &sK[j * D + half];
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) dot = fmaf(q[i], kr[TPR * i], dot);
#pragma unroll
      for (int m = 1; m < TPR; m *= 2) dot += __shfl_xor_sync(FULL, dot, m);
      s[j] = allowed(a, row, k0 + j) ? dot * a.scale : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DH; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      const float pj = expf(s[j] - mn);
      l += pj;
      const float* vr = &sV[j * D + half];
#pragma unroll
      for (int i = 0; i < DH; ++i) acc[i] = fmaf(pj, vr[TPR * i], acc[i]);
    }
    m = mn;
    __syncthreads();
  }
  if (row < a.Sq) {
    const float den = fmaxf(l, 1e-30f);
    float* op = p.o + (static_cast<long long>(blockIdx.y) * a.Sq + row) * D +
                half;
#pragma unroll
    for (int i = 0; i < DH; ++i) op[TPR * i] = acc[i] / den;
    if (a.lse != nullptr && half == 0)
      a.lse[static_cast<long long>(blockIdx.y) * a.Sq + row] = m + logf(den);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map from one row of the wrapper's table, which must carry
// the box and swizzle the kernel was compiled for.
bool encode(CUtensorMap* map, const void* ptr, const long long* row,
            int box_rows, int span) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || row[M_BOX_COLS] != span ||
      row[M_BOX_ROWS] != box_rows || row[M_SWIZZLE] != 2 * span)
    return false;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(row[M_D]), static_cast<cuuint64_t>(row[M_S]),
      static_cast<cuuint64_t>(row[M_HEADS]),
      static_cast<cuuint64_t>(row[M_B])};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(row[M_ROW]),
                                 static_cast<cuuint64_t>(row[M_HEAD]),
                                 static_cast<cuuint64_t>(row[M_BATCH])};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(span),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      span == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : span == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* const* ptrs, const long long* maps,
                const Shape& a, int B, cudaStream_t stream) {
  using T = Tile<D>;
  CUtensorMap m[4];
  const int rows[4] = {T::BQ, T::BK, T::BK, 64};
  for (int i = 0; i < 4; ++i)
    if (!encode(&m[i], ptrs[i], maps + i * MAP_FIELDS, rows[i], T::SPAN))
      return static_cast<int>(cudaErrorInvalidValue);
  // dynamic shared memory above 48 KB (set per call: per current device)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * a.H, (a.Sq + T::BQ - 1) / T::BQ);
  flash_bf16_kernel<D><<<grid, BF16_THREADS, T::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* const* ptrs, const long long* maps, const Shape& a,
               int B, cudaStream_t stream) {
  F32Args p;
  p.q = static_cast<const float*>(ptrs[0]);
  p.k = static_cast<const float*>(ptrs[1]);
  p.v = static_cast<const float*>(ptrs[2]);
  p.o = static_cast<float*>(const_cast<void*>(ptrs[3]));
  long long* st[3][3] = {{&p.q_ss, &p.q_sh, &p.q_sb},
                         {&p.k_ss, &p.k_sh, &p.k_sb},
                         {&p.v_ss, &p.v_sh, &p.v_sb}};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      *st[i][j] = maps[i * MAP_FIELDS + M_ROW + j] / 4;
  const dim3 grid((a.Sq + F32_BQ - 1) / F32_BQ, B * a.H);
  flash_f32_kernel<D><<<grid, F32Tile<D>::THREADS, 0, stream>>>(p, a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const void* const* ptrs, const long long* maps,
           const Shape& a, int B, cudaStream_t stream) {
  return dtype == 1 ? launch_bf16<D>(ptrs, maps, a, B, stream)
                    : launch_f32<D>(ptrs, maps, a, B, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (q, k, v and o alike).  maps: 4 rows (q, k, v,
// o) of MAP_FIELDS int64 each, from the wrapper's tensor-map helper.
// prefix: P of the prefix-LM mask (0 = none; ignored unless causal).
// lse: f32 [B, H, Sq], each row's log-sum-exp of its scaled scores in
// natural units (m + log(max(l, 1e-30))), or null for none (last, so that
// a caller of the interface without it passes the stream where it was).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a head dimension that has no instantiation or a map row that does
// not fit the kernel's tiling or that the driver refuses.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int H, int KH, int Sq,
                           int Sk, int D, const long long* maps, int causal,
                           int window, int prefix, float scale,
                           void* stream, float* lse) {
  Shape a;
  a.H = H;
  a.group = H / KH;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.window = window;
  a.prefix = causal ? prefix : 0;
  a.scale = scale;
  a.lse = lse;
  const void* ptrs[4] = {q, k, v, o};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(dtype, ptrs, maps, a, B, s);
    case 32: return launch<32>(dtype, ptrs, maps, a, B, s);
    case 64: return launch<64>(dtype, ptrs, maps, a, B, s);
    case 128: return launch<128>(dtype, ptrs, maps, a, B, s);
    case 256: return launch<256>(dtype, ptrs, maps, a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
