#!/usr/bin/env python3
"""Build, check and time the WKV backward (``wkv6_scan_bwd``, from
``csrc/recurrent_bwd.cu``) of this checkout on one GPU, beside another
checkout's and beside copies of the source, in one process.

Run from the repository root:

    python3 tools/wkv_bwd_timing.py [--parent DIR] [--check]
                                    [--batch B] [--source FILE ...]
                                    [--checked-source FILE ...]

``--parent`` names the root of another checkout (a parent commit unpacked
with ``git archive``): its ``kernels/recurrent.py`` is loaded under a
package name of its own, so that its wrapper and its source (another C
interface) run beside this checkout's.  Each ``--source`` is a copy of the
source with its C interface (an experiment such as another segment length
``WB_M``, or a phase taken out by hand to see what it costs): built beside
the package's headers under a name of its own and timed, never checked;
each ``--checked-source`` the same, checked as well (a candidate design).
The first line is the card's name and power limit; then one JSON line with
this checkout's WKV kernel's registers and spills (``ptxas -v``) and its
``HMMA``, ``LDL``, ``STL`` and atomics counts (``cuobjdump -sass``).
``--check`` holds each build to ``wkv6_scan_bwd_plain`` by
``chip_smoke.scan_bwd_check``, ``[scan-bwd]``'s own check, and lists each
failure.  Last, at rwkv6-7b's training shape (``WKV_SHAPE``, bf16; with
``--batch``, its first B sequences), each build is timed in the order parent, this checkout, the
sources, then the same in reverse, so that drift of the card shows: each
kernel's device time a call (torch.profiler), the wrapper call's (CUDA
events), the device memory a call allocates beyond its inputs and outputs,
and the bound (``chip_smoke.scan_bwd_work``).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import importlib
import json
import re
import shutil
import sys
import tempfile
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: the WKV backward's kernels in the ptxas log, the SASS and the profile
KERNELS = r"((?:wkv6_bwd|sum_parts)_kernel(?:I(?:f|13__nv_bfloat16)E)?)"


def spills(log: str) -> dict[str, list[int]]:
    """(registers, spill store bytes, spill load bytes) of each kernel
    instance in ``nvcc -Xptxas -v`` output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            f = re.search(KERNELS, m.group(1))
            cur = f.group(1) if f else None
            if cur:
                out[cur] = [0, 0, 0]
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur][0] = int(m.group(1))
            cur = None
    return out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The WKV backward's C interface of this checkout's source."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_scan_bwd_launch.argtypes = [vp] * 16 + [ci] * 4 + [vp]
    lib.wkv6_scan_bwd_launch.restype = ci
    lib.wkv6_scan_bwd_workspace.argtypes = [ci] * 3
    lib.wkv6_scan_bwd_workspace.restype = ctypes.c_longlong
    lib.recurrent_bwd_error_string.argtypes = [ci]
    lib.recurrent_bwd_error_string.restype = ctypes.c_char_p
    return lib


def parent_module(root: Path):
    """``kernels/recurrent.py`` of the checkout at ``root`` as module
    ``wkv_parent.recurrent`` (its ``_build`` beside it, its own sources and
    build directory)."""
    pkg = types.ModuleType("wkv_parent")
    pkg.__path__ = [str(root / "src" / "repro_torch" / "kernels")]
    sys.modules["wkv_parent"] = pkg
    return importlib.import_module("wkv_parent.recurrent")


def timing(cs, torch, rk, label: str, B: int) -> dict:
    _, S, H = cs.WKV_SHAPE
    x = [t[:B].contiguous() if t.dim() == 4 else t
         for t in cs.scan_bwd_inputs(torch, "wkv6_scan_bwd", S, 7)]

    def fn():
        return rk.wkv6_scan_bwd(*x)

    split = cs.profiled_kernels_ms(torch, fn, KERNELS, calls=10)
    ms = cs.event_ms(torch, fn, reps=10, inner=5)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    outputs = sum(t.numel() * t.element_size() for t in out)
    transient = torch.cuda.max_memory_allocated() - before - outputs
    del out
    work = cs.scan_bwd_work("wkv6_scan_bwd", B, S, H)
    b_ms, b_by = cs.scan_bound(work)
    kernel_ms = sum(split.values()) if split else None
    return {"source": label, "shape": {"B": B, "S": S, "H": H,
                                       "dtype": "bfloat16"},
            "kernel_us": kernel_ms * 1e3 if kernel_ms else None,
            "kernel_us_by_kernel": {k: v * 1e3 for k, v in split.items()},
            "call_us": ms * 1e3, "bound_us": b_ms * 1e3, "bound_by": b_by,
            "bound_share": b_ms / kernel_ms if kernel_ms else None,
            "transient_bytes": transient}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--batch", type=int)
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--checked-source", action="append", default=[])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import recurrent as rk

    if not torch.cuda.is_available():
        print("wkv_bwd_timing: no GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    batch = args.batch or cs.WKV_SHAPE[0]
    if not 1 <= batch <= cs.WKV_SHAPE[0]:
        ap.error(f"--batch takes 1 .. {cs.WKV_SHAPE[0]}")
    log = _build.build("recurrent_bwd")
    print(json.dumps({
        "source": "this checkout", "segment_chunks": rk.WKV_BWD_SEGMENT,
        "ptxas_registers_spill_store_load": spills(log),
        "sass": cs.sass_counts(_build._target("recurrent_bwd")[1], KERNELS,
                               ("HMMA", "LDL", "STL", "ATOMG", "RED"))}),
          flush=True)
    # each source under a name of its own, so that _build caches them
    # apart, beside the package's headers
    variants = []
    sources = args.checked_source + args.source
    if sources:
        csrc = Path(tempfile.mkdtemp(prefix="wkv_bwd_"))
        for path in _build.CSRC.glob("*.cuh"):
            shutil.copy(path, csrc)
        names = [f"v{i}_{Path(f).stem}" for i, f in enumerate(sources)]
        for name, path in zip(names, sources):
            shutil.copy(path, csrc / f"{name}.cu")
        package_csrc, _build.CSRC = _build.CSRC, csrc
        with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
            logs = list(pool.map(_build.build, names))
        for name, path, log in zip(names, sources, logs):
            print(json.dumps({"source": path, "ptxas_registers_spill_store_load":
                              spills(log)}), flush=True)
            variants.append((path, bind(_build.load(name))))
        _build.CSRC = package_csrc
    # (label, wrapper module, the library its wrapper is to launch; None:
    # the module's own)
    runs = []
    if args.parent:
        runs.append((f"parent {args.parent}",
                     parent_module(Path(args.parent).resolve()), None))
    runs.append(("this checkout", rk, rk._bwd_lib()))

    timed = runs + [(label, rk, lib) for label, lib in variants]

    def use(mod, lib):
        if lib is not None:
            mod._bwd_lib = lambda: lib

    if args.check or args.checked_source:
        checked = (runs if args.check else []) + [
            (label, rk, lib) for label, lib in variants
            if label in args.checked_source]
        for label, mod, lib in checked:
            use(mod, lib)
            failures = []
            out = cs.scan_bwd_check(torch, mod, "wkv6_scan_bwd", failures)
            print(json.dumps({"source": label, "check": {
                **out, "failures": failures}}), flush=True)
    for label, mod, lib in timed + timed[::-1]:
        use(mod, lib)
        print(json.dumps(timing(cs, torch, mod, label, batch)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
