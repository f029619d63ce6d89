#!/usr/bin/env python3
"""Hold variants of the scan kernels ``wkv6_scan`` and ``rglru_scan`` to
their plain versions and time them against each other on one GPU, in one
process.

Each argument is a CUDA source with the C interface of
``src/repro_torch/kernels/csrc/recurrent.cu`` (the committed file, an
experimental copy of it, or a parent's copy unpacked with ``git
archive``).  Run from the repository root:

    python3 tools/scan_variants.py src/repro_torch/kernels/csrc/recurrent.cu other.cu

Every source is built with the package's nvcc flags (all at once); each
kernel's registers come from the ptxas log.  Each source's kernels are
held to the plain versions at ``chip_smoke.scan_checks``' cases (every S
of ``chip_smoke.chunk_check_s``, bf16 and f32, drawn and extreme inputs;
SCAN_TOL), then timed at the rows' prefill shapes (rwkv6-7b's B 4, S 1024,
H 64 and recurrentgemma-9b's B 4, S 1024, R 4096) and at a decode step
(S = 1): the device time a launch from torch.profiler and the CUDA-event
time of a wrapper call.  The sources run in the order given and then in
reverse, so that drift of the card shows: give a parent's copy first and
the change second for parent, change, change, parent.  The first line is
the card's name and power limit; one JSON line per source and pass
follows, with each shape's bound (``chip_smoke.scan_bound``).

With ``--time-only`` first, the checks are skipped: for copies of the
source with a phase taken out (a call deleted by hand), whose outputs are
wrong by design, to see what each phase costs.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_scan_launch.argtypes = [vp] * 8 + [ci] * 4 + [vp]
    lib.wkv6_scan_launch.restype = ci
    lib.rglru_scan_launch.argtypes = [vp] * 7 + [ci] * 4 + [vp]
    lib.rglru_scan_launch.restype = ci
    lib.recurrent_error_string.argtypes = [ci]
    lib.recurrent_error_string.restype = ctypes.c_char_p
    return lib


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import recurrent as rk

    time_only = bool(argv) and argv[0] == "--time-only"
    argv = argv[1:] if time_only else argv
    if not torch.cuda.is_available() or not argv:
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    # each source under a name of its own, so that _build caches them apart
    csrc = Path(tempfile.mkdtemp(prefix="scan_variants_"))
    names = []
    for i, path in enumerate(argv):
        names.append(f"v{i}_{Path(path).stem}")
        shutil.copy(path, csrc / f"{names[-1]}.cu")
    _build.CSRC = csrc
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        logs = dict(zip(names, pool.map(_build.build, names)))
    B, S, H = cs.WKV_SHAPE
    B_, S_, R = cs.RGLRU_SHAPE
    scans = (("wkv6_scan", "wkv6_kernel", rk.wkv6_scan, rk.wkv6_scan_plain,
              B, S, H),
             ("rglru_scan", "rglru", rk.rglru_scan, rk.rglru_scan_plain,
              B_, S_, R))
    order = list(zip(argv, names))
    for arg, name in order + order[::-1]:
        lib = bind(_build.load(name))
        rk._lib = lambda lib=lib: lib
        out = {"source": arg, "card": smi,
               "registers": cs.ptxas_registers(logs[name], cs.SCAN_KERNELS)}
        for scan, kernel, wrap, plain, b, s, width in scans:
            if not time_only:
                checked = cs.scan_checks(torch, scan, wrap, plain)
                out[f"{scan}_worst_err_over_tol"] = max(
                    c["max_abs_err"] / c["tolerance"]
                    for c in checked.values())
            for steps, suffix in ((s, ""), (1, "_decode")):
                x = cs.scan_inputs(torch, scan, steps, 7 + steps)

                def fn(): return wrap(*x)
                b_ms, b_by = cs.scan_bound(cs.scan_work(scan, b, steps,
                                                        width))
                kernel_ms = cs.profiled_kernel_ms(torch, fn, kernel,
                                                  calls=10)
                out[scan + suffix] = {
                    "S": steps,
                    "ms": cs.event_ms(torch, fn, reps=10,
                                      inner=5 if steps > 1 else 40),
                    "kernel_ms": kernel_ms, "bound_ms": b_ms,
                    "bound_by": b_by,
                    "bound_share": b_ms / kernel_ms if kernel_ms else None}
        print(json.dumps(out), flush=True)
    shutil.rmtree(csrc, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
