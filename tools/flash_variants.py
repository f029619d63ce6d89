#!/usr/bin/env python3
"""Time variants of the flash-attention kernel K4 against each other on one
GPU, in one process.

Each argument is a CUDA source with the C interface of
``src/repro_torch/kernels/csrc/flash_attention.cu`` (the committed kernel,
or an experimental copy of it), optionally followed by ``@BQ`` or
``@BQxBK`` when its bf16 tiling differs from the committed one (BK is then
taken as given, else as the committed kernel's).  Run from the repository
root:

    python3 tools/flash_variants.py src/repro_torch/kernels/csrc/flash_attention.cu other.cu@64

Every source is built with the package's nvcc flags (all at once), held
against ``flash_attention_plain`` in bf16 at the two timing shapes (max
|difference|, tolerance 2.5e-2), and timed there: CUDA events over 20
back-to-back calls, and the device time a launch of ``flash_bf16_kernel``
from torch.profiler, beside ``scaled_dot_product_attention`` on the same
inputs.  The sources run in the order given and then in reverse, so that
drift of the card shows.  The first line is the card's name and power
limit; one JSON line per source and pass follows.
"""
from __future__ import annotations

import concurrent.futures
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: B, H, K, S, d: the serving path's prefill (llama3.2-1b, batch 4 x 1024)
#: and the head_dim-128 shape of qwen2-7b / qwen3-8b
SHAPES = ((4, 32, 8, 1024, 64), (1, 28, 4, 1500, 128))


def event_us(torch, fn, reps=15, inner=20) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) * 1e3 / inner)
    return statistics.median(samples)


def device_us(torch, fn, key: str, calls: int = 40):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for ev in prof.key_averages():
        if key in ev.key:
            total += ev.device_time_total
            count += ev.count
    return total / count if count else None


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available() or not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    # each source under a name of its own, so that _build caches them apart
    csrc = Path(tempfile.mkdtemp(prefix="flash_variants_"))
    variants = []
    for i, arg in enumerate(argv):
        path, _, tiling = arg.partition("@")
        name = f"v{i}_{Path(path).stem}"
        shutil.copy(path, csrc / f"{name}.cu")
        bq, _, bk = tiling.partition("x")
        variants.append((arg, name, int(bq) if bq else None,
                         int(bk) if bk else None))
    _build.CSRC = csrc
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        list(pool.map(_build.build, [v[1] for v in variants]))

    committed = fa.block_shape
    inputs = []
    for B, H, K, S, d in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(99)
        qkv = [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
               for s in ((B, H, S, d), (B, K, S, d), (B, K, S, d))]
        q, k, v = qkv
        library = event_us(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        inputs.append((qkv, fa.flash_attention_plain(*qkv, causal=True),
                       library))
    for arg, name, bq, bk in variants + variants[::-1]:
        lib = fa.bind(_build.load(name))
        fa._lib = lambda lib=lib: lib
        fa.block_shape = (lambda d, dtype, bq=bq, bk=bk: (
            bq or committed(d, dtype)[0], bk or committed(d, dtype)[1]))
        rows = []
        for (B, H, K, S, d), (qkv, want, library) in zip(SHAPES, inputs):
            def fn(): return fa.flash_attention(*qkv, causal=True)
            err = float((fn().float() - want.float()).abs().max())
            rows.append({"shape": [B, H, K, S, S, d], "max_abs_err": err,
                         "ok": err <= 2.5e-2, "events_us": event_us(torch, fn),
                         "device_us": device_us(torch, fn,
                                                "flash_bf16_kernel"),
                         "library_events_us": library})
        print(json.dumps({"source": arg, "card": smi, "shapes": rows}),
              flush=True)
    fa.block_shape = committed
    shutil.rmtree(csrc, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
