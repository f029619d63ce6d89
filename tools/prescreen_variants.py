#!/usr/bin/env python3
"""Time variants of the shortlist's prescreen, its union select and the
view-delta encoder against each other on one GPU, in one process.

Each argument is a CUDA source with the C interface of
``src/repro_torch/kernels/csrc/topo_score.cu``; a source whose prescreen
still takes two launches (the form before the one-launch kernel: no
``ctas`` and ``clusters`` arguments, the keys through global memory) is
marked with a trailing ``@2``, and a copy with a phase taken out, timed
but not held to the plain versions, with ``@t``.  Run from the repository
root:

    python3 tools/prescreen_variants.py _archive/parent.cu@2 \\
        src/repro_torch/kernels/csrc/topo_score.cu

Every source is built with the package's nvcc flags (all at once).  On
``chip_smoke.resident_state`` rows of the RTX 4090 server (10 victims at
most a row, 60% class representatives, 37 forced rows, no patch rows),
preemptor (priority 1000, 2 GPUs, 2 CoreGroups, bundle 1, alpha 0.5), at
n = 1024, 10240 and 40960 rows and k = 128, the prescreen is held bit for
bit against its plain version (rows, the bits of excl_ub and the selected
keys) and timed: the device time a call from torch.profiler (the sum of
its kernels) and the CUDA-event time of a call; a one-launch source at
clusters of 8 CTAs and of the card's most (``ctas``), and in 1, 2, 4 and 8
clusters and as many as the card keeps resident (the split form; the
wrapper's choice is ``prescreen.prescreen_geometry``).  The
union select is held and timed over 4 shards' top 128 keys of the 10240
rows, the encoder at ``chip_smoke.delta_phase``'s timing shape (random
views of a 1024-server cluster).  ``torch.topk`` of the same keys, the
library call that computes the select's function, is timed beside them.
The sources run in the order given and then in reverse (parent, change,
change, parent).  The first line is the card's name and power limit; one
JSON line per source and pass follows.
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
ROWS = (1024, 10240, 40960)
K = 128
SHARDS = 4


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core.topology import RTX4090_SERVER as spec
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_class as fc
    from repro_torch.kernels import prescreen as psk
    from repro_torch.kernels import topo_score as ts
    from repro_torch.kernels import view_delta as vdk

    if not torch.cuda.is_available() or not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), flush=True)
    csrc = Path(tempfile.mkdtemp(prefix="prescreen_variants_"))
    names, two, timed = [], [], []
    for i, arg in enumerate(argv):
        path, _, mark = arg.partition("@")
        names.append(f"v{i}_{Path(path).stem}")
        two.append("2" in mark)
        timed.append("t" in mark)
        shutil.copy(path, csrc / f"{names[-1]}.cu")
    _build.CSRC = csrc
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for name, log in zip(names, pool.map(_build.build, names)):
            keep = [ln for ln in log.splitlines()
                    if "prescreen" in ln or "encode_delta" in ln
                    or "spill" in ln]
            print(f"[build] {name}: " + " | ".join(keep[:40]), flush=True)

    dev = torch.device("cuda", torch.cuda.current_device())
    req = fc.FusedRequest(1000, 2, 2, 1, 0.5)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    states = {}
    for n in ROWS:
        ns, v, _ = cs.resident_state(np, spec, n, 10, seed=n)
        rng = np.random.default_rng(n)
        rep = t((rng.random(n) < 0.6).astype(np.int32))
        forced = t(np.sort(rng.choice(n, 37, replace=False)).astype(np.int32))
        e = torch.zeros(0, dtype=torch.int32, device=dev)
        pbuf = torch.zeros((0, 5 + 5 * v.shape[2] + 2), dtype=torch.int32,
                           device=dev)
        args = (t(ns), t(v), e, pbuf, rep, forced)
        want = psk.prescreen_plain(*args, k=K, req=req, spec=spec)
        sel = psk.prescreen_sel_plain(*args, k=K, req=req, spec=spec)
        states[n] = (args, want, sel)
    # the union select's keys: 4 shards' top 128 of the 10240 rows
    args10 = states[10240][0]
    rows = 10240 // SHARDS
    keys = torch.zeros((SHARDS, K), dtype=torch.int64, device=dev)
    excl = torch.zeros(SHARDS, dtype=torch.int32, device=dev)
    for d in range(SHARDS):
        lo, hi = d * rows, (d + 1) * rows
        a = list(args10)
        a[0], a[1] = (x[:, lo:hi].contiguous() for x in args10[:2])
        a[4] = args10[4][lo:hi].contiguous()
        out = psk.prescreen_plain(*a, k=K, req=req, spec=spec, base=d * rows)
        keys[d] = psk.prescreen_sel_plain(*a, k=K, req=req, spec=spec,
                                          base=d * rows)
        excl[d] = out[K]
    union_want = psk.prescreen_select_plain(keys, K, excl)

    # the encoder's shape of chip_smoke.delta_phase
    enc = delta_shape(torch, np, cs, vdk, dev)

    def topk_ms(keys_u):
        flipped = keys_u ^ torch.tensor(-2**63, dtype=torch.int64,
                                        device=dev)
        return cs.event_ms(torch, lambda: torch.topk(flipped, K + 1))

    library = {n: topk_ms(prescreen_keys(torch, np, psk, states[n][0], spec,
                                         req, dev))
               for n in ROWS}
    library["union"] = topk_ms(keys.reshape(-1))

    order = list(zip(argv, names, two, timed))
    for arg, name, old, time_only in order + order[::-1]:
        lib = (bind_two_launch(ts.bind(_build.load(name))) if old
               else fc.bind(ts.bind(_build.load(name))))
        max_ctas = lib.cluster_ctas_max(dev.index)
        resident = {} if old else {
            c: lib.prescreen_max_clusters(dev.index, c) for c in (8, max_ctas)}
        row = {"source": arg, "two_launches": old, "resident_clusters": {
            str(c): v for c, v in resident.items()}, "prescreen": {}}
        for n in ROWS:
            args, want, sel_want = states[n]
            forms = [None] if old else [
                (ctas, clusters) for ctas in sorted({8, max_ctas})
                for clusters in sorted({1, 2, 4, 8, resident[ctas]})
                if clusters * ctas <= n]
            for form in forms:
                fn, kernels = prescreen_call(torch, fc, lib, args, spec,
                                             req, form, dev)
                got, sel = fn()
                cs.check(time_only or (torch.equal(got, want) and torch.equal(
                    sel_sorted(torch, sel) if old else sel, sel_want)),
                    f"{arg}: prescreen n={n} form={form} differs from the "
                    "plain version")
                row["prescreen"][f"{n}" + ("" if form is None
                                           else "/%dx%d" % form[::-1])] = {
                    "kernel_us": 1e3 * (cs.profiled_kernel_ms(
                        torch, fn, kernels) or float("nan")),
                    "us_per_call": 1e3 * cs.event_ms(torch, fn)}
        fn = union_call(torch, lib, keys, excl, dev, old)
        cs.check(time_only or torch.equal(fn(), union_want),
                 f"{arg}: union select differs from the plain version")
        row["union_kernel_us"] = 1e3 * (cs.profiled_kernel_ms(
            torch, fn, ("prescreen_select_kernel", "prescreen_union_kernel"))
            or float("nan"))
        fn = encoder_call(torch, vdk, lib, enc, dev)
        cs.check(time_only or torch.equal(fn(), enc["want"]),
                 f"{arg}: encoder differs from the plain version")
        row["encoder_kernel_us"] = 1e3 * (cs.profiled_kernel_ms(
            torch, fn, "encode_delta_kernel") or float("nan"))
        row["library_topk_us"] = {k: 1e3 * v for k, v in library.items()}
        print(json.dumps(row), flush=True)
    return 0


def bind_two_launch(lib):
    """The argument types of a two-launch source's launchers this tool
    calls (the interface before the one-launch prescreen)."""
    import ctypes

    from repro_torch.kernels import fused_class as fc

    sp, pp = ctypes.POINTER(fc._State), ctypes.POINTER(fc._FusedParams)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.prescreen_launch.argtypes = [sp, pp, vp, vp, ci, ci, vp, vp, vp, vp,
                                     ci, vp]
    lib.prescreen_select_launch.argtypes = [vp, ci, ci, vp, ci, ci, vp, vp,
                                            vp, ci, vp]
    lib.encode_delta_launch.argtypes = [vp, vp, ci, ci, vp, ci, vp, ci, vp,
                                        vp, ci, ci, vp, ci, ci, vp]
    lib.cluster_ctas_max.argtypes = [ci]
    for fn in (lib.prescreen_launch, lib.prescreen_select_launch,
               lib.encode_delta_launch, lib.cluster_ctas_max):
        fn.restype = ci
    return lib


def prescreen_keys(torch, np, psk, args, spec, req, dev):
    """Every row's key (`prescreen.keys_of`, 0 for a row that does not
    enter) as int64, the select's input."""
    ns, v, pidx, pbuf, rep, forced = args
    nsr, vr, repr_ = psk._rows(ns, v, pidx, pbuf, rep, forced, 0)
    ub, ok = psk._bounds(nsr, vr, repr_, req=req, spec=spec)
    keys = psk.keys_of(ub, np.arange(ns.shape[1]))
    keys[~ok.cpu().numpy()] = 0
    return torch.from_numpy(keys.view(np.int64).copy()).to(dev)


def sel_sorted(torch, sel):
    """A two-launch source's sel (the selected keys in any order) in
    descending order, then 0."""
    import numpy as np

    u = sel.cpu().numpy().view(np.uint64)
    live = np.sort(u[u != 0])[::-1]
    out = np.zeros_like(u)
    out[:len(live)] = live
    return torch.from_numpy(out.view(np.int64).copy()).to(sel.device)


def prescreen_call(torch, fc, lib, args, spec, req, form, dev):
    """A call of the prescreen from `lib` (`form` None: the two-launch
    form; else (ctas, clusters)) returning (out, sel), and its kernels'
    names."""
    import ctypes

    ns, v, pidx, pbuf, rep, forced = args
    n = ns.shape[1]
    st = fc.launch_state(ns, v, None, pidx, pbuf, None, resident=True)
    prm = fc.params(spec, req)
    out = torch.empty(K + 1, dtype=torch.int32, device=dev)
    sel = torch.empty(K, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if form is None:
        keys = torch.empty(n, dtype=torch.int64, device=dev)

        def fn():
            code = lib.prescreen_launch(
                ctypes.byref(st), ctypes.byref(prm), rep.data_ptr(),
                forced.data_ptr(), forced.shape[0], K, None, keys.data_ptr(),
                sel.data_ptr(), out.data_ptr(), dev.index, stream)
            assert code == 0, code
            return out, sel
        return fn, ("prescreen_kernel", "prescreen_select_kernel")
    ctas, clusters = form
    words = lib.prescreen_scratch_words(n, K, ctas, clusters, None)
    scratch = torch.empty(max(words, 1), dtype=torch.int64, device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)

    def fn():
        code = lib.prescreen_launch(
            ctypes.byref(st), ctypes.byref(prm), rep.data_ptr(),
            forced.data_ptr(), forced.shape[0], K, ctas, clusters, None,
            scratch.data_ptr() if words else None, ticket.data_ptr(),
            sel.data_ptr(), out.data_ptr(), dev.index, stream)
        assert code == 0, code
        return out, sel
    return fn, "prescreen_cluster_kernel"


def union_call(torch, lib, keys, excl, dev, old: bool):
    """A call of the union select from `lib` (`old`: a two-launch source,
    whose launcher takes no list count)."""
    out = torch.empty(K + 1, dtype=torch.int32, device=dev)
    scratch = torch.empty(K, dtype=torch.int64, device=dev)
    flat = keys.reshape(-1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lists = () if old else (keys.shape[0],)

    def fn():
        code = lib.prescreen_select_launch(
            flat.data_ptr(), flat.numel(), K, *lists, excl.data_ptr(),
            excl.shape[0], 1, None, scratch.data_ptr(), out.data_ptr(),
            dev.index, stream)
        assert code == 0, code
        return out
    return fn


def delta_shape(torch, np, cs, vdk, dev):
    """The first of `chip_smoke.DELTA_VIEWS`' random views with at least
    four dense rows and a host row (the shape `delta_phase` times)."""
    import random

    from repro_torch.core.cluster import ViewDelta
    from repro_torch.core.preemption_device import _patch_plan

    cluster, wls = cs.delta_cluster("cuda", cs.DELTA_NODES, seed=5)
    dcs = cluster.device_state().sync()
    rng = random.Random(9)
    for case in range(cs.DELTA_VIEWS):
        if case % 4 == 3:
            for uid in rng.sample(sorted(cluster.instances), 5):
                cluster.evict(uid)
            dcs.sync(flush=False)
        view = cs.random_view(rng, cluster, wls, rng.randrange(2, 60))
        vd = ViewDelta(view, dcs.mirror, dcs.pending)
        hidx, desc, adds, hpos, hbuf = _patch_plan(dcs, vd)
        if desc is not None and desc.shape[1] >= 4 and len(hpos):
            up = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                  for x in (desc, adds, hpos, hbuf)]
            return {"dcs": dcs, "up": up, "p": len(hidx),
                    "want": vdk.encode_delta_plain(dcs.nodestate,
                                                   dcs.victims, *up,
                                                   p=len(hidx))}
    raise RuntimeError("no view of the encoder's timing shape")


def encoder_call(torch, vdk, lib, enc, dev):
    dcs, up, p = enc["dcs"], enc["up"], enc["p"]
    dense, adds, hpos, hrows = up
    cap = dcs.victims.shape[2]
    out = torch.empty((p, 5 + 5 * cap + 2), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def fn():
        code = lib.encode_delta_launch(
            dcs.nodestate.data_ptr(), dcs.victims.data_ptr(),
            dcs.nodestate.shape[1], cap, dense.data_ptr(), dense.shape[1],
            adds.data_ptr(), adds.shape[2], hpos.data_ptr(),
            hrows.data_ptr(), hrows.shape[0], p, out.data_ptr(), 0,
            dev.index, stream)
        assert code == 0, code
        return out
    return fn


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
