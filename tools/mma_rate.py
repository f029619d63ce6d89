#!/usr/bin/env python3
"""The rate of the tensor-core instruction the WKV kernel uses
(``mma.sync.aligned.m16n8k8`` with TF32 operands and f32 accumulators),
beside bf16 ``m16n8k16``, on one GPU.

Builds a small CUDA source with nvcc (the package's flags), launches each
kernel on every SM with 4 warps a CTA, each warp running 8 independent
accumulator chains, and prints one JSON line: the card's name and power
limit, then per instruction its TFLOP/s and the cycles one SM sub-partition
(a warp scheduler) takes per instruction.  Run from the repository root:

    python3 tools/mma_rate.py
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ITERS = 4096

SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>
template <int KIND>
__global__ void __launch_bounds__(128) rate_kernel(float* out, int iters) {
  float d[8][4] = {};
  uint32_t a[4], b[2];
  for (int e = 0; e < 4; ++e) a[e] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + e);
  for (int e = 0; e < 2; ++e) b[e] = __float_as_uint(0.5f + e);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (KIND == 0)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int c = 0; c < 8; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int rate_launch(int kind, float* out, int blocks, int iters,
                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (kind == 0) rate_kernel<0><<<blocks, 128, 0, s>>>(out, iters);
  else rate_kernel<1><<<blocks, 128, 0, s>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    tmp = Path(tempfile.mkdtemp(prefix="mma_rate_"))
    (tmp / "rate.cu").write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                    str(tmp / "rate.so"), str(tmp / "rate.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(tmp / "rate.so"))
    lib.rate_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_int, ctypes.c_void_p]
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    blocks = sms * 4                     # 16 warps an SM, 4 a scheduler
    out = torch.empty(blocks * 128, device="cuda")
    clock_hz = 1e3 * int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True).stdout.split()[0]) * 1e3
    res = {"card": cs.nvidia_smi(), "sms": sms, "max_sm_clock_hz": clock_hz}
    for kind, name, flops in ((0, "mma.m16n8k8.tf32", 2 * 16 * 8 * 8),
                              (1, "mma.m16n8k16.bf16", 2 * 16 * 8 * 16)):
        def fn():
            code = lib.rate_launch(kind, out.data_ptr(), blocks, ITERS,
                                   torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"launch failed: {code}")
        ms = cs.event_ms(torch, fn, reps=5, inner=3)
        n = blocks * 4 * ITERS * 8       # warp-level instructions
        res[name] = {
            "ms": ms, "tflops": n * flops / (ms * 1e-3) / 1e12,
            "cycles_per_instr_per_scheduler":
                (ms * 1e-3) * clock_hz / (n / (sms * 4))}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
