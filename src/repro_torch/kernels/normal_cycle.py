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
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.cluster import apply_rows
from repro_torch.core.placement_device import normal_cycle_core
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

#: this module's kernel wrappers (their ``launches`` counters)
WRAPPERS = (normal_cycle,)
