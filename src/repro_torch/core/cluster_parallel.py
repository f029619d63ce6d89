"""Cluster-scale sourcing over a mesh of devices: the ``imp_sharded`` engine.

Counterpart of the reference's ``repro.core.cluster_parallel``.  At 10^4
nodes and above the node axis of the device-resident cluster state is split
into one block of rows a device (`ShardedDeviceClusterState`, installed by
``cluster.device_state(sharded=True)``).  The fused engine's pipelines
(`preemption_device`) run over a state's ``shards``, so the same bodies
serve both, as the reference's ``_evals(dcs)`` does: over D > 1 shards each
kernel is launched once a shard on that shard's rows, and the shards'
records are merged on the mesh's first device:

* the normal cycle: each shard's K2 writes its least ``(tier, leftover,
  node, row)`` key and row 0 (``normal_cycle_part``); ``normal_merge``
  takes the least over the shards and places it;
* the sweep's tail: each shard's tail writes its exact monoid state, with
  flat indices of global rows, and both tie keys' entries placed
  (``fused_argmax(shard=...)``); ``tail_merge`` merges the states, so the
  tie chain's same-tier test is taken over every shard's survivors;
* the shortlist: each shard's prescreen keeps its top K by ``(bound,
  -global row)`` (``prescreen(sel=...)``); ``prescreen_select`` takes the
  top K of the union, and the K-row sweep runs on each shard over its
  share of those rows.

Over one shard nothing is merged: ``imp_sharded`` on a one-device mesh runs
what ``imp_batched`` runs.  The skip chain holds: every shard's sweep and
tail read the MERGED normal cycle's ``found``.  Patch rows, gathered rows
and wide chunks carry global row ids; a shard reads its own rows
(``State.base`` in the kernels) and a gathered row it does not hold as a
zero row, which never wins.  Decisions equal ``imp_batched``'s.

**The mesh** is a tuple of ``torch.device`` in one process, the
counterpart of the reference's single-controller mesh over
``jax.devices()``: every shard's tensors live on their own device, and
devices may repeat (``("cpu",) * D`` in the tests, ``("cuda:0",) * D`` on
one card), so D shards run on one device.  It is not built on
``torch.distributed``: a world of processes would copy the host cluster,
the scheduler and the day loop into every rank, which the reference's
program model does not have.  ``cluster_mesh()`` is every visible CUDA
device for a CUDA cluster and the CPU for a CPU cluster.

The ``make_distributed_*`` functions run the reference's sharded entry
points over a mesh: the per-size sourcing (``_source_best`` through K3 on
each shard, then a first-index argmax merge), the fused sourcing and the
normal cycle.  The reference's ``lower_*`` functions return XLA lowerings
for its dry run and have no counterpart here.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.fused_class import FusedRequest

from . import preemption_device as _pd
from .cluster import (DRAIN_FIELDS, IDX_SENTINEL, NODE_FIELDS, NS_NODE_ID,
                      VICTIM_FIELDS, DeviceClusterState, _scatter_rows,
                      row_width)
from .engines import register_engine
from .preemption_device import (NARROW_M, Request, _normal, _sweep_tail,
                                combo_table, evaluate_subsets)
from .scoring import DEFAULT_ALPHA
from .topology import ServerSpec


# ---------------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------------

class Mesh(NamedTuple):
    """A 1-D mesh (axis ``nodes``): one shard a device entry, in order.
    Entries may repeat."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def _norm(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def as_mesh(mesh, device) -> Mesh:
    """``mesh`` (a `Mesh` or a sequence of devices) as a `Mesh` for a
    cluster on ``device``: its devices must be of the cluster's kind (a
    mesh of CUDA devices never becomes the CPU, nor the reverse)."""
    devs = tuple(_norm(d) for d in (mesh.devices if isinstance(mesh, Mesh)
                                    else mesh))
    kind = torch.device(device).type
    if not devs:
        raise ValueError("a mesh needs at least one device")
    for d in devs:
        if d.type != kind:
            raise ValueError(f"mesh device {d} for a cluster on {kind}")
        if d.type == "cuda" and d.index >= torch.cuda.device_count():
            raise ValueError(f"mesh device {d}: only "
                             f"{torch.cuda.device_count()} CUDA devices")
    return Mesh(devs)


def cluster_mesh(devices=None, *, device="cuda") -> Mesh:
    """The mesh of ``devices``; by default every visible CUDA device for
    ``device`` "cuda" (a one-device mesh on a one-card machine) and the
    CPU for "cpu"."""
    if devices is None:
        kind = torch.device(device).type
        if kind == "cuda":
            count = torch.cuda.device_count()
            if not count:
                raise RuntimeError("cluster_mesh: no CUDA device is visible")
            devices = [torch.device("cuda", i) for i in range(count)]
        else:
            devices = [torch.device(kind)]
    devices = list(devices)
    return as_mesh(devices, torch.device(devices[0]).type if devices
                   else device)


# ---------------------------------------------------------------------------------
# The sharded resident state
# ---------------------------------------------------------------------------------

class Shard:
    """One device's block of a sharded state: global rows ``base`` ..
    ``base + rows - 1`` as the three stacked tensors on ``device``."""

    def __init__(self, device: torch.device, base: int, rows: int) -> None:
        self.device, self.base, self.rows = device, base, rows
        self.nodestate: torch.Tensor | None = None
        self.victims: torch.Tensor | None = None
        self.drain: torch.Tensor | None = None

    def owns(self, rows: np.ndarray) -> np.ndarray:
        return (rows >= self.base) & (rows < self.base + self.rows)


def _shards_of(mesh: Mesh, ns, v, dr) -> list[Shard]:
    """The rows of a state (numpy or tensors) split over ``mesh`` as
    `Shard`s: the node axis padded up to a multiple of the mesh's size
    with rows of `IDX_SENTINEL` node ids and zero masks, which every kernel
    excludes, then one block of rows a device."""
    ns, v, dr = (np.asarray(x, np.int32) for x in (ns, v, dr))
    n = ns.shape[1]
    rows = -(-max(n, 1) // mesh.size)
    pad = rows * mesh.size - n
    if pad:
        pns = np.zeros((NODE_FIELDS, pad), np.int32)
        pns[NS_NODE_ID] = IDX_SENTINEL
        ns = np.concatenate([ns, pns], axis=1)
        v = np.concatenate([v, np.zeros((VICTIM_FIELDS, pad, v.shape[2]),
                                        np.int32)], axis=1)
        dr = np.concatenate([dr, np.zeros((DRAIN_FIELDS, pad), np.int32)],
                            axis=1)
    out = []
    for d, dev in enumerate(mesh.devices):
        s = Shard(dev, d * rows, rows)
        cols = slice(s.base, s.base + rows)
        s.nodestate, s.victims, s.drain = (
            torch.from_numpy(np.ascontiguousarray(x[:, cols])).to(dev)
            for x in (ns, v, dr))
        out.append(s)
    return out


class ShardedDeviceClusterState(DeviceClusterState):
    """`DeviceClusterState` with the node axis split over a mesh (install
    with ``cluster.device_state(sharded=True)``).

    The node axis is padded up to a multiple of the mesh's size
    (``n_rows``, `_shards_of`), so decisions equal the unsharded state's.
    Shard ``d`` holds rows ``d * rows`` onwards on ``mesh.devices[d]``.  A
    full rebuild uploads each shard's block, a sync scatters each dirty
    row into its owner, and a plan's delta rows are rebuilt on their owner
    (`preemption_device._stage`).  The merges and the readback live on the
    mesh's first device (``device``).  ``nodestate``/``victims``/``drain``
    read back the whole state on that device (for inspection; the
    pipelines use ``shards``)."""

    def __init__(self, cluster, mesh=None) -> None:
        self.mesh = (cluster_mesh(device=cluster.device) if mesh is None
                     else as_mesh(mesh, cluster.device))
        rows = -(-max(cluster.num_nodes, 1) // self.mesh.size)
        self._shards = [Shard(d, i * rows, rows)
                        for i, d in enumerate(self.mesh.devices)]
        super().__init__(cluster)
        self.device = self.mesh.devices[0]

    @property
    def shards(self) -> list[Shard]:
        return self._shards

    @property
    def n_rows(self) -> int:
        return self.mesh.size * self._shards[0].rows

    def _whole(self, field: str):
        if not self._resident:
            return None
        return torch.cat([getattr(s, field).to(self.device)
                          for s in self._shards], dim=1)

    nodestate = property(lambda self: self._whole("nodestate"),
                         lambda self, value: None)
    victims = property(lambda self: self._whole("victims"),
                       lambda self, value: None)
    drain = property(lambda self: self._whole("drain"),
                     lambda self, value: None)

    def _upload_full(self, ns, v, dr) -> None:
        self._shards = _shards_of(self.mesh, ns, v, dr)

    def _scatter(self, rows: list[int], buf: np.ndarray) -> None:
        rows = np.asarray(rows, np.int64)
        for s in self._shards:
            mine = s.owns(rows)
            if not mine.any():
                continue
            both = torch.from_numpy(np.concatenate(
                [(rows[mine] - s.base).astype(np.int32)[:, None], buf[mine]],
                axis=1)).to(s.device)
            _scatter_rows(s.nodestate, s.victims, s.drain,
                          both[:, 0].to(torch.int64), both[:, 1:])

    def _upload_rep(self, rep: np.ndarray) -> list[torch.Tensor]:
        return [torch.from_numpy(rep[s.base:s.base + s.rows].astype(
            np.int32)).to(s.device) for s in self._shards]


# ---------------------------------------------------------------------------------
# The imp_sharded engine: the fused engine's paths over the sharded state
# ---------------------------------------------------------------------------------

def _sharded_state(cluster) -> None:
    """Install the sharded device state on the base cluster (kept when one
    is installed): every fused path then runs over its shards."""
    base = getattr(cluster, "base", cluster)
    base.device_state(sharded=True)


def plan_sharded(cluster, workload, alpha: float = DEFAULT_ALPHA,
                 allow_preempt: bool = True, shortlist=None):
    """`preemption_device.plan_fused` over the sharded state."""
    _sharded_state(cluster)
    return _pd.plan_fused(cluster, workload, alpha, allow_preempt,
                          shortlist=shortlist)


def plan_normal_sharded(cluster, workload):
    """`preemption_device.plan_normal_fused` over the sharded state."""
    _sharded_state(cluster)
    return _pd.plan_normal_fused(cluster, workload)


def batch_session_sharded(cluster, workloads, alpha: float):
    """`preemption_device.persistent_batch_session` over the sharded
    state."""
    _sharded_state(cluster)
    return _pd.persistent_batch_session(cluster, workloads, alpha)


def warmup_sharded(cluster, alpha: float = DEFAULT_ALPHA, batch: int = 8,
                   workloads=None, shortlist=None) -> None:
    """`preemption_device.warmup_fused` over the sharded state."""
    _sharded_state(cluster)
    _pd.warmup_fused(cluster, alpha, batch, workloads, shortlist=shortlist)


def source_candidates_sharded(cluster, workload, nodes=None,
                              alpha: float = DEFAULT_ALPHA, shortlist=None):
    """``imp_batched`` semantics over the sharded state: the same fused
    paths, the node axis split over the mesh."""
    _sharded_state(cluster)
    return _pd.source_candidates_fused(cluster, workload, nodes,
                                       alpha=alpha, shortlist=shortlist)


register_engine("imp_sharded", batched=True, needs_alpha=True,
                fused_filter=True, fused_place=True, plan_fn=plan_sharded,
                normal_fn=plan_normal_sharded,
                batch_factory=batch_session_sharded, warmup_fn=warmup_sharded,
                supports_shortlist=True)(source_candidates_sharded)

# the full-sweep oracle (see ``imp_batched_full``)
register_engine("imp_sharded_full", batched=True, needs_alpha=True,
                fused_filter=True, fused_place=True, plan_fn=plan_sharded,
                normal_fn=plan_normal_sharded,
                batch_factory=batch_session_sharded,
                warmup_fn=warmup_sharded)(source_candidates_sharded)


# ---------------------------------------------------------------------------------
# The reference's distributed entry points over a mesh
# ---------------------------------------------------------------------------------

def _source_best(free_gpu, free_cg, vg, vc, vp, valid, table, *,
                 spec: ServerSpec, request: Request, alpha: float):
    """Every (node x subset) candidate of one subset size and the best:
    ``(score f32[], node i32[], combo i32[])``, the first index of the
    largest Eq. 1 score (infeasible: -inf) over ``[N, n_comb]``.  The
    tiers and scores come from K3 (`evaluate_subsets`); its score is the
    reference's expression, alpha and 1 - alpha rounded to f32."""
    _, _, _, score = evaluate_subsets(free_gpu, free_cg, vg, vc, vp, valid,
                                      table, spec=spec, request=request,
                                      alpha=alpha)
    flat = score.reshape(-1)
    best = torch.argmax(flat)
    n_comb = score.shape[1]
    return (flat[best], (best // n_comb).to(torch.int32),
            (best % n_comb).to(torch.int32))


def _mesh(mesh) -> Mesh:
    return mesh if isinstance(mesh, Mesh) else cluster_mesh(mesh)


def _blocks(mesh: Mesh, n: int):
    """``(device, lo, hi)`` of each shard's rows of ``n`` (the last ones
    may hold fewer, or none)."""
    rows = -(-max(n, 1) // mesh.size)
    return [(dev, min(n, d * rows), min(n, (d + 1) * rows))
            for d, dev in enumerate(mesh.devices)]


def make_distributed_source(mesh, spec: ServerSpec, request: Request,
                            alpha: float = 0.5):
    """The per-size sourcing with the node axis split over ``mesh``:
    ``fn(free_gpu, free_cg, vg, vc, vp, valid, table) -> (score, node,
    combo)``, `_source_best` on each shard's rows, then the first-index
    argmax over the shards' bests (shards in row order), as the
    reference's global argmax gives it."""
    mesh = _mesh(mesh)

    def fn(free_gpu, free_cg, vg, vc, vp, valid, table):
        n = len(free_gpu)
        dev0 = mesh.devices[0]
        best = []
        for dev, lo, hi in _blocks(mesh, n):
            if lo == hi:
                continue
            args = [torch.as_tensor(np.asarray(x)[lo:hi]).to(dev)
                    for x in (free_gpu, free_cg, vg, vc, vp, valid)]
            s, node, combo = _source_best(
                *args, torch.as_tensor(np.asarray(table)).to(dev), spec=spec,
                request=request, alpha=alpha)
            best.append((s.to(dev0), node.to(dev0) + lo, combo.to(dev0)))
        i = int(torch.argmax(torch.stack([b[0] for b in best])))
        return best[i]

    return fn


def distributed_source_inputs(spec: ServerSpec, num_nodes: int,
                              max_victims: int, k: int, request: Request,
                              rng: np.random.Generator | None = None):
    """Synthetic inputs of the distributed sourcing: ``(free_gpu,
    free_cg, vg, vc, vp, valid, table)`` as numpy (the reference's
    without its SKU constants: the kernels take ``spec``)."""
    rng = rng or np.random.default_rng(0)
    free_gpu = np.zeros(num_nodes, np.int32)
    free_cg = np.zeros(num_nodes, np.int32)
    vg = rng.integers(0, spec.all_gpu_mask + 1, (num_nodes, max_victims),
                      dtype=np.int32)
    vc = rng.integers(0, spec.all_cg_mask + 1, (num_nodes, max_victims),
                      dtype=np.int32)
    vp = rng.integers(100, 600, (num_nodes, max_victims), dtype=np.int32)
    valid = np.ones((num_nodes, max_victims), bool)
    return (free_gpu, free_cg, vg, vc, vp, valid,
            np.asarray(combo_table(max_victims, k)))


def _no_patches(shards, cap: int):
    empty = {}
    for s in shards:
        if s.device not in empty:
            empty[s.device] = (
                torch.zeros(0, dtype=torch.int32, device=s.device),
                torch.zeros((0, row_width(cap)), dtype=torch.int32,
                            device=s.device))
    return ([empty[s.device][0] for s in shards],
            [empty[s.device][1] for s in shards])


def make_distributed_fused_source(mesh, spec: ServerSpec, request: Request,
                                  alpha: float = 0.5, m: int = 8):
    """The fused Filtering + Sorting (``imp_batched`` semantics: drain-mask
    Filtering, every subset of every row, the Eq. 2 argmax and the
    winner's placement) over state tensors with the node axis split over
    ``mesh``: ``fn(nodestate, victims, drain, thresh) -> int32[9]``, each
    shard's sweep and tail, then ``tail_merge``."""
    mesh = _mesh(mesh)

    def fn(nodestate, victims, drain, thresh):
        shards = _shards_of(mesh, nodestate, victims, drain)
        pidx, pbuf = _no_patches(shards, shards[0].victims.shape[2])
        req = FusedRequest(int(thresh), request.need_gpus, request.need_cgs,
                           request.cgs_per_bundle, float(alpha))
        return _sweep_tail(shards, pidx, pbuf, pidx, req, spec, m_res=m,
                           resident=True, m_gather=NARROW_M)[0]

    return fn


def make_distributed_normal_cycle(mesh, spec: ServerSpec, request: Request):
    """The normal scheduling cycle over node-state tensors with the node
    axis split over ``mesh``: ``fn(nodestate) -> int32[5]``, each shard's
    K2, then ``normal_merge``."""
    mesh = _mesh(mesh)

    def fn(nodestate):
        ns = np.asarray(nodestate, np.int32)
        n = ns.shape[1]
        shards = _shards_of(mesh, ns, np.zeros((VICTIM_FIELDS, n, 1),
                                               np.int32),
                            np.zeros((DRAIN_FIELDS, n), np.int32))
        pidx, pbuf = _no_patches(shards, 1)
        req = FusedRequest(0, request.need_gpus, request.need_cgs,
                           request.cgs_per_bundle, 0.5)
        return _normal(shards, pidx, pbuf, req, spec)

    return fn


def distributed_fused_inputs(spec: ServerSpec, num_nodes: int, m: int,
                             rng: np.random.Generator | None = None):
    """Synthetic state tensors for the sharded fused sourcing (numpy): one
    GPU and CoreGroup a victim slot keeps one node's masks disjoint."""
    rng = rng or np.random.default_rng(0)
    nodestate = np.zeros((NODE_FIELDS, num_nodes), np.int32)
    nodestate[NS_NODE_ID] = np.arange(num_nodes, dtype=np.int32)
    victims = np.zeros((VICTIM_FIELDS, num_nodes, m), np.int32)
    victims[0] = 1 << (np.arange(m, dtype=np.int32) % spec.num_gpus)
    victims[1] = 1 << (np.arange(m, dtype=np.int32) % spec.num_coregroups)
    victims[2] = rng.integers(100, 600, (num_nodes, m), dtype=np.int32)
    victims[3] = np.arange(m, dtype=np.int32)
    victims[4] = 1
    drain = np.zeros((DRAIN_FIELDS, num_nodes), np.int32)
    drain[0] = nodestate[0] | np.bitwise_or.reduce(victims[0], axis=1)
    drain[1] = nodestate[1] | np.bitwise_or.reduce(victims[1], axis=1)
    return nodestate, victims, drain, np.int32(1000)


__all__ = ["Mesh", "Shard", "ShardedDeviceClusterState", "as_mesh",
           "cluster_mesh", "distributed_fused_inputs",
           "distributed_source_inputs", "make_distributed_fused_source",
           "make_distributed_normal_cycle", "make_distributed_source",
           "plan_normal_sharded", "plan_sharded",
           "source_candidates_sharded", "warmup_sharded"]
