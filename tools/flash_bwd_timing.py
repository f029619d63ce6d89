#!/usr/bin/env python3
"""Build and time K4's backward (``csrc/flash_attention_bwd.cu``) of one
checkout on one GPU, or variants of its source side by side.

Run from the repository root:

    python3 tools/flash_bwd_timing.py [--src DIR] [--check] [SOURCE ...]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's; an unpacked archive of another commit's to time
that one beside it, in a process of its own).  The forward and backward
sources are built with the package's nvcc flags, both at once; then each
backward kernel's registers and spills (from ``ptxas -v``) and its
``HGMMA``, ``UTMALDG``, ``LDL`` and ``STL`` counts (``cuobjdump -sass``)
are printed.  ``--check`` then runs ``chip_smoke.py``'s ``[flash-bwd]``
phase: every ``FLASH_SHAPES`` row in f32 and bf16 against
``flash_attention_bwd_plain``, autograd and the back-to-back repeats, with
its gates.  Last, ``chip_smoke.py``'s ``flash_bwd_timing`` at each of
``BWD_TIMED``: each kernel's device time (torch.profiler), their sum, the
wrapper call's time, the plain version's, the bound and ``autograd.grad``
of ``scaled_dot_product_attention``.

Each SOURCE is a variant of the backward source with its C interface (an
experimental copy beside the committed one): each is built under a name
of its own beside the package's headers, put in the wrapper's place, and
checked and timed as above (``BWD_TIMED`` less the CUDA-core shape), in
the order given and then in reverse, so that drift of the card shows.
The first line is the card's name and power limit; one JSON line follows
per step.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import re
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: the backward kernels' instances in the ptxas log and the SASS
KERNELS = r"(bwd_(?:wgmma|mma|core)_d(?:q|kv)_kernelI\w+?E(?:L\w\d+E)?)"


def spills(log: str) -> dict[str, list[int]]:
    """(registers, spill store bytes, spill load bytes) of each backward
    kernel instance in ``nvcc -Xptxas -v`` output."""
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


def notes(log: str) -> dict[str, list[str]]:
    """The ptxas notes (C75xx: wgmma serialized, waits injected) of each
    backward kernel instance."""
    out: dict[str, list[str]] = {}
    for line in log.splitlines():
        code = re.search(r"\((C75\d\d)\)", line)
        name = re.search(KERNELS, line)
        if code and name:
            out.setdefault(name.group(1), []).append(code.group(1))
    return out


def report(cs, lib, log: str, label: str) -> None:
    print(json.dumps({
        "source": label,
        "ptxas_registers_spill_store_load": spills(log),
        "ptxas_notes": notes(log),
        "sass": cs.sass_counts(lib, KERNELS,
                               ("HGMMA", "UTMALDG", "UTMASTG", "LDL", "STL"))}),
          flush=True)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("sources", nargs="*")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_bwd_timing: no GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(cs.nvidia_smi(), flush=True)
    names = ["flash_attention"]
    if not args.sources:
        names.append("flash_attention_bwd")
    else:
        # each variant under a name of its own, so that _build caches them
        # apart, beside the package's headers
        csrc = Path(tempfile.mkdtemp(prefix="flash_bwd_"))
        for path in [*_build.CSRC.glob("*.cuh"),
                     _build.CSRC / "flash_attention.cu"]:
            shutil.copy(path, csrc)
        for i, path in enumerate(args.sources):
            names.append(f"v{i}_{Path(path).stem}")
            shutil.copy(path, csrc / f"{names[-1]}.cu")
        _build.CSRC = csrc
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        logs = dict(zip(names, pool.map(_build.build, names)))
    if not args.sources:
        report(cs, _build._target(names[1])[1], logs[names[1]], args.src)
        if args.check:
            cs.flash_bwd_phase(torch)
        for shape in cs.BWD_TIMED:
            cs.flash_bwd_timing(torch, shape, forward=shape == cs.MAIN_FLASH)
        return 0
    variants = list(zip(args.sources, names[1:]))
    for label, name in variants:
        report(cs, _build._target(name)[1], logs[name], label)
    for label, name in variants + variants[::-1]:
        lib = fa.bind_bwd(_build.load(name))
        fa._bwd_lib = lambda lib=lib: lib
        print(json.dumps({"source": label}), flush=True)
        if args.check:
            cs.flash_bwd_phase(torch)
        for shape in cs.BWD_TIMED[:2]:
            cs.flash_bwd_timing(torch, shape, forward=False)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
