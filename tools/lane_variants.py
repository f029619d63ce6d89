#!/usr/bin/env python3
"""Time variants of the lane kernels K2 (``placement_tier_kernel``) and K3
(``topo_score_kernel``), and of the class sweep that shares their tier
rule (``fused_class_kernel``), against each other on one GPU, in one
process.

Each argument is a CUDA source with the C interface of
``src/repro_torch/kernels/csrc/topo_score.cu`` (the committed file, or an
experimental copy of it).  Run from the repository root:

    python3 tools/lane_variants.py src/repro_torch/kernels/csrc/topo_score.cu other.cu

Every source is built with the package's nvcc flags (all at once).  On the
RTX 4090 server spec, request (2, 2, 1, alpha 0.5), at n = 256, 1024,
65536 and 2,621,440 lanes (``chip_smoke.BIG_LANES``), each kernel is held
bit for bit against its plain version and timed: the device time a launch
from torch.profiler and the CUDA-event time of a call, each launch at the
largest n after a write of 256 MB that evicts the L2 (not counted).  Then
the class sweep on ``chip_smoke.sweep_timing``'s states (10240 RTX 4090
rows with exactly e eligible victims, e = 1..8, and the wide form), each
held against its plain version.  The sources run in the order given and
then in reverse, so that drift of the card shows: give a parent's copy
first and the change second for parent, change, change, parent.  The
first line is the card's name and power limit; one JSON line per source
and pass follows, with the bytes bound of each lane shape.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SIZES = (256, 1024, 65536)


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core.topology import RTX4090_SERVER as spec
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_class as fc
    from repro_torch.kernels import topo_score as ts

    if not torch.cuda.is_available() or not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    # each source under a name of its own, so that _build caches them apart
    csrc = Path(tempfile.mkdtemp(prefix="lane_variants_"))
    names = []
    for i, path in enumerate(argv):
        names.append(f"v{i}_{Path(path).stem}")
        shutil.copy(path, csrc / f"{names[-1]}.cu")
    _build.CSRC = csrc
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))

    req = ts.TopoRequest(2, 2, 1, alpha=0.5)
    flush = cs.l2_flush(torch)
    cases = []
    for n in (*SIZES, cs.BIG_LANES):
        g, c, p = cs.lanes(torch, np, spec, n, seed=n, dev="cuda")[:3]
        cases.append((n, g, c, p, ts.topo_score_plain(g, c, p, spec, req),
                      ts.placement_tier_plain(g, c, spec, req)))
    order = list(zip(argv, names))
    for arg, name in order + order[::-1]:
        lib = fc.bind(ts.bind(_build.load(name)))
        with cs.launching_from(lib):
            rows = []
            for n, g, c, p, want3, want2 in cases:
                cold = n == cs.BIG_LANES
                for kernel, fn, want, bpl in (
                        ("topo_score_kernel",
                         lambda: ts.topo_score(g, c, p, spec, req), want3, 20),
                        ("placement_tier_kernel",
                         lambda: ts.placement_tier(g, c, spec, req), (want2,),
                         12)):
                    out = fn()
                    cs.compare(torch, out if isinstance(out, tuple)
                               else (out,), want, f"{arg} {kernel} n={n}")
                    ms = (cs.flushed_event_ms(torch, fn, flush) if cold
                          else cs.event_ms(torch, fn))
                    kernel_ms = cs.profiled_kernel_ms(
                        torch, fn, kernel, before=flush if cold else None)
                    b_ms = cs.bound_ms(bpl * n, 0)[0]
                    rows.append({"kernel": kernel, "n": n, "l2_flushed": cold,
                                 "ms": ms, "kernel_ms": kernel_ms,
                                 "bound_ms": b_ms,
                                 "bound_share": b_ms / (kernel_ms or ms)})
            with contextlib.redirect_stdout(io.StringIO()):
                sweep = cs.sweep_timing(torch, np, "cuda")
        print(json.dumps({"source": arg, "card": smi, "shapes": rows,
                          "sweep": sweep}), flush=True)
    shutil.rmtree(csrc, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
