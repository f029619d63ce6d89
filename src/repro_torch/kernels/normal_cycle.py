"""K2 in its normal-cycle form: the whole normal cycle of a plan in one launch.

``normal_cycle`` runs the host's ``TopoScheduler._plan_normal`` over every
row of the device-resident node state, with the plan's patch rows read in
place of their resident rows: the count screen, the placement tier (the
math of K2, ``repro/kernels/topo_score.py:285 placement_tier_pallas``),
the blind tier of the degraded admission, the exact ``(tier, leftover,
node)`` argmin, and the winner's masks.  Its kernel is
``normal_cycle_kernel`` in ``csrc/topo_score.cu`` and its plain version
``normal_cycle_plain``, the port of ``placement_jax.normal_cycle_core``.
It replaces that XLA program of the reference.  The kernel takes one
thread a node over a grid of CTAs, packs the argmin's order into one
64-bit key, reduces it per CTA and across CTAs with ``atomicMin``, and the
last CTA to finish places the winner.

The wrapper runs the plain version for tensors on the CPU and launches the
kernel for tensors on a CUDA device; anything else raises.  It counts its
launches in ``normal_cycle.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.cluster import apply_rows
from repro_torch.core.placement_device import normal_cycle_core
from repro_torch.core.topology import ServerSpec

from . import topo_score as ts
from .fused_class import (FusedRequest, lib, on_cuda, params, state,
                          stream_of)

#: width of the normal cycle's winner: (found, node, tier, gpu_mask, cg_mask)
NORMAL_FIELDS = 5
#: per device, the kernel's 16 bytes of scratch: the grid's running minimum
#: key (all ones: none) and the ticket that finds the last CTA; every launch
#: leaves it as it found it
_SCRATCH: dict = {}


def _scratch(device: torch.device) -> torch.Tensor:
    got = _SCRATCH.get(device)
    if got is None:
        got = _SCRATCH[device] = torch.tensor([-1, 0], dtype=torch.int64,
                                              device=device)
    return got


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
        got = normal_cycle_plain(nodestate, victims, drain, pidx, pbuf, req,
                                 spec)
        if out is None:
            return got
        out.copy_(got)
        return out
    if out is None:
        out = torch.empty(NORMAL_FIELDS, dtype=torch.int32,
                          device=nodestate.device)
    if out.numel() != NORMAL_FIELDS or not out.is_contiguous():
        raise ValueError(f"out must hold {NORMAL_FIELDS} int32")
    gidx = pidx[:0]
    st = state(nodestate, victims, drain, pidx, pbuf, gidx, resident=True)
    lb = lib()
    with torch.cuda.device(nodestate.device):
        code = lb.normal_cycle_launch(
            ctypes.byref(st), ctypes.byref(params(spec, req)),
            _scratch(nodestate.device).data_ptr(), out.data_ptr(),
            stream_of(nodestate))
    ts._raise_on(lb, code, "normal_cycle")
    normal_cycle.launches += 1
    return out


normal_cycle.launches = 0

#: this module's kernel wrappers (their ``launches`` counters)
WRAPPERS = (normal_cycle,)
