"""K2 in its normal-cycle form: the whole normal cycle of a plan in one launch.

``normal_cycle`` runs the host's ``TopoScheduler._plan_normal`` over every
row of the device-resident node state, with the plan's patch rows read in
place of their resident rows: the count screen, the placement tier (the
math of K2, ``repro/kernels/topo_score.py:285 placement_tier_pallas``),
the blind tier of the degraded admission, the exact ``(tier, leftover,
node)`` argmin, and the winner's masks.  Its kernel is
``normal_cycle_kernel`` in ``csrc/topo_score.cu`` and its plain version
``normal_cycle_plain``, the port of ``placement_jax.normal_cycle_core``.
It replaces that XLA program of the reference.  The kernel packs the
argmin's order into one 64-bit key with the row's free masks as payload and
reduces it per CTA by warp shuffles and across a thread-block cluster's CTAs
through distributed shared memory.  Up to `SPLIT_NODES` nodes it runs as
one cluster (up to 8 CTAs, or 16 where the card allows, of up to 1024
threads, a thread a node and a loop beyond), whose rank 0 places the
winner.  Above, it runs split over the whole card (`normal_geometry`): a
grid of clusters each writes its minimum to a buffer the wrapper
allocates, and a one-warp kernel launched after it
(``normal_merge_kernel``) places the least.  It keeps nothing in device
memory from one call to the next.

The wrapper runs the plain version for tensors on the CPU and launches the
kernel for tensors on a CUDA device; anything else raises.  It counts its
launches in ``normal_cycle.launches``.

A shard of a sharded state runs ``normal_cycle_part``: the same kernel
over the shard's rows, writing each cluster's minimum and its row 0 as
records and placing nothing; ``normal_merge`` launches the split form's
merge (``normal_merge_kernel``) over every shard's records and places the
winner, in place of the cross-shard collectives of the reference's sharded
normal cycle.  It counts its launches in ``normal_merge.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.cluster import (IDX_SENTINEL, NODE_FIELDS, NS_FREE_CG,
                                      NS_FREE_GPU, NS_NODE_ID, apply_rows)
from repro_torch.core.placement_device import (best_tier_counts,
                                               normal_cycle_core,
                                               place_blind_core, popcount32,
                                               spec_slices)
from repro_torch.core.topology import ServerSpec

from . import topo_score as ts
from .fused_class import (CLUSTER_CTAS, CTA_ROWS, NORMAL_THREADS,
                          FusedRequest, cluster_geometry, launch_state, lib,
                          max_cluster_ctas, on_cuda, params, stream_of)

#: width of the normal cycle's winner: (found, node, tier, gpu_mask, cg_mask)
NORMAL_FIELDS = 5
#: the most nodes K2 takes as one thread-block cluster; above, it runs split
#: (on an H100 the split form's second launch costs more than it saves up
#: to 16384 random nodes, and less from 24576: PERF.md)
SPLIT_NODES = 16384
#: the most clusters of the split form (kMaxSplitClusters in
#: csrc/topo_score.cu); the rows loop beyond
MAX_SPLIT_CLUSTERS = 1024


@functools.lru_cache(maxsize=1024)
def normal_geometry(n: int, max_ctas: int = CLUSTER_CTAS,
                    split_nodes: int = SPLIT_NODES) -> tuple[int, int, int]:
    """``(clusters, ctas, threads)`` of K2 over ``n`` nodes: one cluster of
    `cluster_geometry` up to ``split_nodes`` nodes; above, the split form,
    in at least two clusters of up to `CLUSTER_CTAS` CTAs, a CTA for every
    `CTA_ROWS` nodes, at most `MAX_SPLIT_CLUSTERS` clusters.  A thread
    takes the rows ``block * threads + thread + i * blocks * threads``
    (blocks = clusters * ctas), so every row is taken once."""
    if n <= split_nodes:
        return (1,) + cluster_geometry(n, NORMAL_THREADS, max_ctas)
    clusters = min(MAX_SPLIT_CLUSTERS,
                   max(2, -(-n // (CLUSTER_CTAS * CTA_ROWS))))
    return (clusters,) + cluster_geometry(-(-n // clusters), NORMAL_THREADS,
                                          CLUSTER_CTAS)


def normal_cycle_plain(nodestate, victims, drain, pidx, pbuf,
                       req: FusedRequest, spec: ServerSpec) -> torch.Tensor:
    """Plain version of `normal_cycle`: int32[5]."""
    if pbuf.shape[0]:
        nodestate, _, _ = apply_rows(nodestate, victims, drain, pidx, pbuf)
    return normal_cycle_core(nodestate, req.need_gpus, req.need_cgs,
                             req.cgs_per_bundle, spec=spec)


def normal_cycle(nodestate, victims, drain, pidx, pbuf, *, req: FusedRequest,
                 spec: ServerSpec, out: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """The normal cycle's winner, int32[5] (found, node, tier, gpu_mask,
    cg_mask), written into ``out`` when given.  Only the request's sizes
    matter (``thresh`` and ``alpha`` are not read).  Counterpart of
    ``placement_jax.normal_cycle_core`` behind the patch overlay."""
    if not on_cuda(nodestate, victims, drain, pidx, pbuf):
        got = normal_cycle_plain(nodestate, victims, drain, pidx, pbuf,
                                 req, spec)
        if out is None:
            return got
        out.copy_(got)
        return out
    st = launch_state(nodestate, victims, drain, pidx, pbuf, None,
                      resident=True)
    return launch(st, req, spec, out)


def launch(st, req: FusedRequest, spec: ServerSpec,
           out: torch.Tensor | None = None,
           geometry: tuple[int, int, int] | None = None) -> torch.Tensor:
    """K2 on a `launch_state`, in `normal_geometry` unless ``geometry``
    ``(clusters, ctas, threads)`` is given (every geometry gives the same
    bits; a forced one serves the measurements of both forms)."""
    if out is None:
        out = torch.empty(NORMAL_FIELDS, dtype=torch.int32,
                          device=st.tensors[0].device)
    if (out.numel() != NORMAL_FIELDS or out.dtype != torch.int32
            or not out.is_contiguous()):
        raise ValueError(f"out must hold {NORMAL_FIELDS} int32")
    clusters, ctas, threads = geometry or normal_geometry(
        st.n, max_cluster_ctas(st.device))
    # the split form's records: 16 bytes a cluster and one for row 0
    part = (torch.empty(4 * (clusters + 1), dtype=torch.int32,
                        device=out.device) if clusters > 1 else None)
    lb = lib()
    code = lb.normal_cycle_launch(
        ctypes.byref(st), ctypes.byref(params(spec, req)), clusters, ctas,
        threads, None if part is None else part.data_ptr(), out.data_ptr(),
        st.device, stream_of(st))
    ts._raise_on(lb, code, "normal_cycle")
    normal_cycle.launches += 1
    return out


normal_cycle.launches = 0


#: the key of a record that holds no candidate (kNoKey)
NO_KEY = 2**64 - 1


def _words(key: int, fg: int, fc: int) -> list[int]:
    """A 16-byte NormalBest record as four int32: the key's low and high
    words, the free GPU and CG masks."""
    return [int(np.int64(w).astype(np.uint32).view(np.int32))
            for w in (key & 0xFFFFFFFF, key >> 32, fg, fc)]


def normal_part_plain(nodestate, victims, drain, pidx, pbuf,
                      req: FusedRequest, spec: ServerSpec,
                      base: int = 0) -> torch.Tensor:
    """Plain version of `normal_cycle_part` as one cluster: int32[2, 4],
    the shard's least ``(tier, leftover, node id, row)`` key with its free
    masks, and its row 0 (key = node id)."""
    if pbuf.shape[0]:
        nodestate, _, _ = apply_rows(nodestate, victims, drain,
                                     pidx.to(torch.int64) - base, pbuf)
    ns = nodestate.cpu()
    sl = spec_slices(spec, "cpu")
    ng, nc, cpb = req.need_gpus, req.need_cgs, req.cgs_per_bundle
    free_g, free_c = ns[NS_FREE_GPU], ns[NS_FREE_CG]
    nid = ns[NS_NODE_ID]
    cnt_g = popcount32(free_g)
    cnt_ok = ((cnt_g >= ng) & (popcount32(free_c) >= nc)
              & (nid < IDX_SENTINEL))
    tier, _, _ = best_tier_counts(free_g, free_c, ng, nc, cpb, sl)
    _, b_tier, _, _ = place_blind_core(free_g, free_c, ng, nc, spec=spec)
    eff = torch.where(tier < 3, tier, b_tier).numpy()
    left = cnt_g.numpy() - ng
    ids = nid.numpy()
    rows = np.nonzero(cnt_ok.numpy())[0]
    key, fg, fc = NO_KEY, 0, 0
    if len(rows):
        r = int(rows[np.lexsort((rows, ids[rows], left[rows], eff[rows]))[0]])
        key = ((int(eff[r]) << 62) | (int(left[r]) << 56)
               | (((int(ids[r]) & 0xFFFFFFFF) ^ 0x80000000) << 24) | r)
        fg, fc = int(free_g[r]), int(free_c[r])
    row0 = _words(int(nid[0]) & 0xFFFFFFFF, int(free_g[0]), int(free_c[0]))
    return torch.tensor([_words(key, fg, fc), row0],
                        dtype=torch.int32).to(nodestate.device)


def part_records(n: int, device: torch.device) -> int:
    """The records `normal_cycle_part` writes for a shard of ``n`` rows on
    ``device``: its clusters and its row 0 (one cluster on the CPU)."""
    if device.type != "cuda":
        return 2
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return normal_geometry(n, max_cluster_ctas(index))[0] + 1


def normal_cycle_part(nodestate, victims, drain, pidx, pbuf, *,
                      req: FusedRequest, spec: ServerSpec, base: int = 0,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """One shard's normal cycle (its first row global row ``base``; the
    patch index holds global row ids): int32[clusters + 1, 4], the least
    key of each of its clusters and its row 0, as 16-byte records that
    `normal_merge` merges across the shards; written into
    ``out`` when given.  The plain version gives one cluster."""
    if not on_cuda(nodestate, victims, drain, pidx, pbuf):
        got = normal_part_plain(nodestate, victims, drain, pidx, pbuf, req,
                                spec, base)
        if out is None:
            return got
        out.copy_(got)
        return out
    st = launch_state(nodestate, victims, drain, pidx, pbuf, None,
                      resident=True, base=base)
    clusters, ctas, threads = normal_geometry(st.n, max_cluster_ctas(
        st.device))
    if out is None:
        out = torch.empty((clusters + 1, 4), dtype=torch.int32,
                          device=nodestate.device)
    if (out.numel() != 4 * (clusters + 1) or out.dtype != torch.int32
            or not out.is_contiguous() or out.device != nodestate.device):
        raise ValueError(f"out must hold {clusters + 1} x 4 int32 beside "
                         "the state")
    lb = lib()
    code = lb.normal_cycle_part_launch(
        ctypes.byref(st), ctypes.byref(params(spec, req)), clusters, ctas,
        threads, out.data_ptr(), st.device, stream_of(st))
    ts._raise_on(lb, code, "normal_cycle")
    normal_cycle.launches += 1
    return out


def _u32(x) -> int:
    return int(x) & 0xFFFFFFFF


def normal_merge_plain(part: torch.Tensor, req: FusedRequest,
                       spec: ServerSpec) -> torch.Tensor:
    """Plain version of `normal_merge`: the least key of the shards'
    records (int32[D, clusters + 1, 4]) placed as ``normal_cycle_core``
    places a node, or shard 0's row 0 where no record holds a candidate."""
    recs = part.cpu().tolist()
    best = (NO_KEY, 0, 0)
    for shard in recs:
        for lo, hi, fg, fc in shard[:-1]:
            key = _u32(lo) | (_u32(hi) << 32)
            if key < best[0]:
                best = (key, fg, fc)
    key, fg, fc = best
    if key == NO_KEY:
        nid, fg, fc = recs[0][-1][0], recs[0][-1][2], recs[0][-1][3]
    else:
        nid = int(np.uint32(_u32(key >> 24) ^ 0x80000000).view(np.int32))
    col = torch.zeros((NODE_FIELDS, 1), dtype=torch.int32)
    col[NS_FREE_GPU, 0], col[NS_FREE_CG, 0], col[NS_NODE_ID, 0] = fg, fc, nid
    got = normal_cycle_core(col, req.need_gpus, req.need_cgs,
                            req.cgs_per_bundle, spec=spec)
    return got.to(part.device)


def normal_merge(part: torch.Tensor, *, n: int, req: FusedRequest,
                 spec: ServerSpec,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """The shards' normal-cycle records (int32[D, clusters + 1, 4], each
    shard's cluster minima then its row 0, `normal_cycle_part`) merged and
    placed: int32[5] (found, node, tier, gpu_mask, cg_mask), what
    ``normal_cycle`` gives over the ``n`` unsharded rows.  Written into
    ``out`` when given."""
    if part.dim() != 3 or part.shape[2] != 4 or part.shape[1] < 2:
        raise ValueError("part must be [D, clusters + 1, 4]")
    if not on_cuda(part):
        got = normal_merge_plain(part, req, spec)
        if out is None:
            return got
        out.copy_(got)
        return out
    if out is None:
        out = torch.empty(NORMAL_FIELDS, dtype=torch.int32,
                          device=part.device)
    if (part.dtype != torch.int32 or not part.is_contiguous()
            or out.numel() != NORMAL_FIELDS or out.device != part.device
            or out.dtype != torch.int32 or not out.is_contiguous()):
        raise ValueError(f"part and out ({NORMAL_FIELDS} int32) must be "
                         "contiguous int32 tensors on one device")
    lb = lib()
    device = part.device.index if part.device.index is not None else \
        torch.cuda.current_device()
    code = lb.normal_merge_launch(
        part.data_ptr(), part.shape[0], part.shape[1] - 1, n,
        ctypes.byref(params(spec, req)), out.data_ptr(), device,
        torch.cuda.current_stream(part.device).cuda_stream)
    ts._raise_on(lb, code, "normal_merge")
    normal_merge.launches += 1
    return out


normal_merge.launches = 0

#: this module's kernel wrappers (their ``launches`` counters)
WRAPPERS = (normal_cycle, normal_merge)
