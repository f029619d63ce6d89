"""The view-delta encoder: a plan's patch rows rebuilt on the device.

A fused plan against a copy-on-write `ClusterView` reads the view's delta
rows in place of their resident rows.  Instead of encoding each delta row
on the host (``encode_row``: a victim sort and a free-mask overlay per
node, then a pack), the host describes each row by what the view changed
(`repro_torch.core.cluster.ViewDelta`: the removed base slots, the freed
and newly occupied masks, and up to ``a`` net-new victims in uid order) and
one launch rebuilds the rows from the resident state, straight into the
plan's patch buffer, beside the rows the host still encodes (fallback and
pending rows), each at its row of the ascending patch index.

=================  =======================  ================================
wrapper            plain version            replaces (repro)
=================  =======================  ================================
``encode_delta``   ``encode_delta_plain``   ``core/cluster.py:810
                   (``encode_delta_core``   encode_delta_core`` (an XLA
                   + the staging)           program) and the host's
                                            flatten of its rows
=================  =======================  ================================

The kernel is ``encode_delta_kernel`` in ``csrc/topo_score.cu``: one warp a
row, one lane a candidate slot (a base victim or an add).  A slot's place
is the count of kept slots with a smaller ``(priority, key)`` and its
uid-rank the count with a smaller key, where the key is ``a + uid-rank``
for a base victim and ``j`` for add ``j`` (planned binds carry negative
uids, so every add orders before every base victim).  The keys of a row
are unique, so the counts equal the reference's two stable argsorts.

The wrapper runs the plain version for tensors on the CPU and launches the
kernel for tensors on a CUDA device; anything else raises.  It counts its
launches in ``encode_delta.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.core.cluster import (ADD_FIELDS, DD_FOC, DD_FOG, DD_NODE,
                                      DD_OC, DD_OG, DD_POS, DD_REM,
                                      DENSE_FIELDS, NS_FREE_CG, NS_FREE_GPU,
                                      VF_CG, VF_GPU, VF_PRIO, VF_RANK,
                                      VF_STORED, row_width)

from . import topo_score as ts
from .fused_class import lib, on_cuda

_INT32_MAX = 2**31 - 1
#: the most candidate slots of a row (``cap + a``): one warp's lanes
MAX_SLOTS = 32


def encode_delta_core(nodestate, victims, didx, rem, fog, foc, og, oc, addg,
                      addc, addp, addv, *, cap: int, a: int,
                      base: int = 0) -> torch.Tensor:
    """The reference's ``encode_delta_core`` in PyTorch: the flattened
    patch rows ``int32[D, row_width(cap)]`` of the nodes ``didx`` rebuilt
    from their resident rows (an index outside ``[0, N)`` reads a zero
    row), with the removed-slot bitmask ``rem``, the freed masks
    ``fog``/``foc``, the occupied masks ``og``/``oc`` and the adds
    ``add*`` (``[D, a]``, uid order) merged by two stable argsorts on
    ``(priority, uid-order)``.  For a shard of a sharded state whose first
    row is global row ``base``, ``didx`` holds global rows."""
    big = _INT32_MAX
    dev = nodestate.device
    n = nodestate.shape[1]
    d = didx.shape[0]
    idx = didx.to(torch.int64) - base
    inr = (idx >= 0) & (idx < n)
    safe = torch.where(inr, idx, 0)
    ns = torch.where(inr[None], nodestate[:, safe], 0)
    vv = torch.where(inr[None, :, None], victims[:, safe], 0)
    fg = (ns[NS_FREE_GPU] | fog) & ~og
    fc = (ns[NS_FREE_CG] | foc) & ~oc
    slot = torch.arange(cap, dtype=torch.int32, device=dev)
    keep = (vv[VF_STORED] != 0) & (((rem[:, None] >> slot[None, :]) & 1) == 0)
    mg = torch.cat([vv[VF_GPU], addg], dim=1)
    mc = torch.cat([vv[VF_CG], addc], dim=1)
    mp = torch.cat([vv[VF_PRIO], addp], dim=1)
    akey = torch.arange(a, dtype=torch.int32, device=dev)[None, :].expand(d, a)
    mkey = torch.cat([a + vv[VF_RANK], akey], dim=1)
    mvalid = torch.cat([keep, addv != 0], dim=1)
    big_t = torch.tensor(big, dtype=torch.int32, device=dev)
    o1 = torch.argsort(torch.where(mvalid, mkey, big_t), dim=1, stable=True)
    p1 = torch.where(mvalid.gather(1, o1), mp.gather(1, o1), big_t)
    order = o1.gather(1, torch.argsort(p1, dim=1, stable=True))

    def srt(x):
        return x.gather(1, order)[:, :cap]

    st = srt(mvalid)
    vg = torch.where(st, srt(mg), 0)
    vc = torch.where(st, srt(mc), 0)
    vp = torch.where(st, srt(mp), 0)
    skey = torch.where(st, srt(mkey), big_t)
    rnk = ((skey[:, None, :] < skey[:, :, None]) & st[:, None, :]).sum(
        dim=2, dtype=torch.int32)
    rank = torch.where(st, rnk, 0)
    drg, drc = fg.clone(), fc.clone()
    for j in range(cap):
        drg |= vg[:, j]
        drc |= vc[:, j]
    new_ns = torch.stack([fg, fc, didx.to(torch.int32), torch.zeros_like(fg),
                          torch.full_like(fg, big)])
    new_v = torch.stack([vg, vc, vp, rank, st.to(torch.int32)])
    new_dr = torch.stack([drg, drc])
    return torch.cat([new_ns.T, new_v.permute(1, 0, 2).reshape(d, -1),
                      new_dr.T], dim=1).to(torch.int32)


def encode_delta_plain(nodestate, victims, dense, adds, hpos, hrows, *,
                       p: int, base: int = 0) -> torch.Tensor:
    """Plain version of `encode_delta`: `encode_delta_core` over the dense
    rows, written with the host rows into a zero patch buffer of ``p``
    rows."""
    cap = victims.shape[2]
    out = torch.zeros((p, row_width(cap)), dtype=torch.int32,
                      device=nodestate.device)
    if dense.shape[1]:
        rows = encode_delta_core(
            nodestate, victims, dense[DD_NODE], dense[DD_REM], dense[DD_FOG],
            dense[DD_FOC], dense[DD_OG], dense[DD_OC], *adds, cap=cap,
            a=adds.shape[2], base=base)
        out[dense[DD_POS].to(torch.int64)] = rows
    if hrows.shape[0]:
        out[hpos.to(torch.int64)] = hrows
    return out


def encode_delta(nodestate, victims, dense, adds, hpos=None, hrows=None, *,
                 p: int, base: int = 0) -> torch.Tensor:
    """The plan's patch buffer, int32[p, row_width(cap)]: dense row ``i``
    (``dense`` int32[`DENSE_FIELDS`, D], ``adds`` int32[`ADD_FIELDS`, D,
    a], `ViewDelta.descriptors`) rebuilt from the resident ``nodestate`` /
    ``victims`` and written to row ``dense[DD_POS, i]``, host row ``h``
    (``hrows`` int32[H, row_width]) copied to row ``hpos[h]``, and every
    other row zero.  The positions are a permutation of ``0 .. D + H - 1``
    and a dense row keeps at most ``cap`` victims (the `ViewDelta` gate).
    For a shard of a sharded state, ``dense``'s nodes are global rows and
    ``base`` is the shard's first.  Counterpart of ``encode_delta_core``
    and the patch flatten."""
    cap = victims.shape[2]
    width = row_width(cap)
    if hrows is None:
        hpos = dense.new_zeros(0)
        hrows = dense.new_zeros((0, width))
    d, h, a = dense.shape[1], hrows.shape[0], adds.shape[2]
    if (dense.shape[0] != DENSE_FIELDS or adds.shape[:2] != (ADD_FIELDS, d)
            or hpos.shape != (h,) or hrows.shape[1] != width
            or p < d + h or a < 1 or cap + a > MAX_SLOTS):
        raise ValueError(
            f"encode_delta: dense {tuple(dense.shape)}, adds "
            f"{tuple(adds.shape)}, hpos {tuple(hpos.shape)}, hrows "
            f"{tuple(hrows.shape)} for p={p}, cap={cap}")
    if not on_cuda(nodestate, victims, dense, adds, hpos, hrows):
        return encode_delta_plain(nodestate, victims, dense, adds, hpos,
                                  hrows, p=p, base=base)
    dev = nodestate.device
    for name, x in (("nodestate", nodestate), ("victims", victims),
                    ("dense", dense), ("adds", adds), ("hpos", hpos),
                    ("hrows", hrows)):
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the state on {dev}")
    out = torch.empty((p, width), dtype=torch.int32, device=dev)
    if p == 0:
        return out
    device = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    lb = lib()

    def ptr(x):
        return x.data_ptr() if x.numel() else None

    code = lb.encode_delta_launch(
        nodestate.data_ptr(), victims.data_ptr(), nodestate.shape[1], cap,
        ptr(dense), d, ptr(adds), a, ptr(hpos), ptr(hrows), h, p,
        out.data_ptr(), base, device,
        torch.cuda.current_stream(device).cuda_stream)
    ts._raise_on(lb, code, "encode_delta")
    encode_delta.launches += 1
    return out


encode_delta.launches = 0

#: this module's kernel wrappers (their ``launches`` counters)
WRAPPERS = (encode_delta,)

__all__ = ["MAX_SLOTS", "WRAPPERS", "encode_delta", "encode_delta_core",
           "encode_delta_plain"]
