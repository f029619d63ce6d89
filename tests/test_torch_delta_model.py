"""A numpy model of the view-delta encoder's kernel (``encode_delta_kernel``
in ``csrc/topo_score.cu``), written in the kernel's own order, held on the
CPU bit for bit to the plain version (``encode_delta_plain``), to the
reference's ``encode_delta_core`` and to host ``encode_row``.

One warp a job.  A dense job issues its loads in two round trips: (1) its
seven descriptor words, one a lane, broadcast by shuffles, with its adds
(lane cap + j add j's four fields); (2) the resident row's slots (lane s <
cap slot s) with the row's two free-mask words (lanes 0 and 1).  Nothing
loads after the rank: a kept slot's place is the count of kept slots (in
ballot order) with a smaller (priority, key), its uid-rank the count with a
smaller key; lanes 0..6 store the node fields and drain masks, kept lanes
their slot at its place, lanes count .. cap-1 zeros.  Host rows are copied
and the rows past them zeroed, a word a lane.

Cases: the view deltas ``test_torch_view_delta.py`` draws (random views of
random clusters, with pending rows), and drawn descriptors over random
resident rows with rows of exactly cap kept slots, rows of adds only,
priority ties between adds and base victims, and out-of-range nodes.  The
kernel's constants are read from the source.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core.cluster import encode_delta_core as ref_encode  # noqa: E402
from repro_torch.core.cluster import (ADD_FIELDS, DD_POS,  # noqa: E402
                                      DENSE_FIELDS, ViewDelta, encode_row,
                                      row_width)
from repro_torch.core.preemption_device import (_patch_plan,  # noqa: E402
                                                _patch_rows)
from repro_torch.kernels import view_delta as vdk  # noqa: E402
from test_torch_view_delta import CASES, _case  # noqa: E402

SOURCE = (Path(vdk.__file__).parent / "csrc" / "topo_score.cu").read_text()
INT32_MAX = 2**31 - 1
U32 = 0xFFFFFFFF


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def _enum(first: str) -> list[str]:
    body = re.search(rf"enum \{{ ({first}[^}}]*)\}};", SOURCE).group(1)
    return [x.strip() for x in body.split(",")]


DELTA_THREADS = _constant("kDeltaThreads")
DENSE = _enum("DD_NODE")      # the descriptor rows, then kDenseFields
ADDS = _enum("DA_GPU")


def test_constants_match_the_source():
    assert DENSE[-1] == "kDenseFields" and len(DENSE) - 1 == DENSE_FIELDS
    assert DENSE.index("DD_POS") == DD_POS
    assert len(ADDS) == ADD_FIELDS
    assert DELTA_THREADS % 32 == 0
    assert vdk.MAX_SLOTS == 32        # cap + a lanes of one warp


def _i32(x: int) -> int:
    x &= U32
    return x - (1 << 32) if x >> 31 else x


def model_encode(ns, v, dense, adds, hpos, hrows, p: int,
                 base: int = 0) -> np.ndarray:
    """The kernel's output over its P jobs, one warp each, lane by lane.
    Rows the kernel leaves unwritten keep a marker, so a missed word
    shows."""
    n, cap = ns.shape[1], v.shape[2]
    d, a, h = dense.shape[1], adds.shape[2], len(hpos)
    width = 5 + 5 * cap + 2
    out = np.full((p, width), -12345, np.int64)
    lanes = range(32)
    for job in range(p):
        if job >= d + h:
            out[job] = 0
            continue
        if job >= d:
            to = int(hpos[job - d])
            if 0 <= to < p:
                out[to] = hrows[job - d]
            continue
        # round trip 1: descriptor word f on lane f; add j on lane cap + j
        word = [int(dense[f, job]) if f < DENSE_FIELDS else 0 for f in lanes]
        g, c, prio, key = [0] * 32, [0] * 32, [0] * 32, [INT32_MAX] * 32
        kept = [False] * 32
        for lane in lanes:
            j = lane - cap
            if 0 <= j < a:
                g[lane], c[lane], prio[lane] = (int(adds[f, job, j])
                                                for f in range(3))
                kept[lane] = adds[3, job, j] != 0
                key[lane] = j
        node, rem, fog, foc, og, oc, to = word[:DENSE_FIELDS]
        local = node - base
        inr = 0 <= local < n
        # round trip 2: the slots and the two free-mask words
        rank, stored, fm = [0] * 32, [0] * 32, [0] * 32
        for lane in lanes:
            if inr and lane < cap:
                g[lane], c[lane], prio[lane], rank[lane], stored[lane] = (
                    int(v[f, local, lane]) for f in range(5))
            if inr and lane < 2:
                fm[lane] = int(ns[lane, local])
            if lane < cap:
                kept[lane] = stored[lane] != 0 and not (rem >> lane) & 1
                key[lane] = a + rank[lane]
        keptm = [lane for lane in lanes if kept[lane]]    # ballot order
        pos = [sum(prio[s] < prio[x] or (prio[s] == prio[x]
                                         and key[s] < key[x])
                   for s in keptm) for x in lanes]
        rk = [sum(key[s] < key[x] for s in keptm) for x in lanes]
        count = len(keptm)
        ogr = ocr = 0
        for s in keptm:
            ogr |= g[s] & U32
            ocr |= c[s] & U32
        fg = ((fm[0] & U32) | (fog & U32)) & ~og & U32
        fc = ((fm[1] & U32) | (foc & U32)) & ~oc & U32
        if not 0 <= to < p:
            continue
        o = out[to]
        fields = [fg, fc, node, 0, INT32_MAX, fg | ogr, fc | ocr]
        for lane in range(7):
            o[lane if lane < 5 else width - 7 + lane] = _i32(fields[lane])
        for lane in lanes:
            if kept[lane] and pos[lane] < cap:
                for f, x in enumerate((g[lane], c[lane], prio[lane],
                                       rk[lane], 1)):
                    o[5 + f * cap + pos[lane]] = x
            if count <= lane < cap:
                for f in range(5):
                    o[5 + f * cap + lane] = 0
    return out.astype(np.int32)


def _held(ns, v, dense, adds, hpos, hrows, p, base=0, host=None):
    """The model against the plain version, the reference's
    encode_delta_core (dense rows) and, where given, the host packing."""
    got = model_encode(ns, v, dense, adds, hpos, hrows, p, base)
    t = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (ns, v, dense, adds, hpos, hrows)]
    plain = vdk.encode_delta(*t, p=p, base=base).numpy()
    assert np.array_equal(got, plain)
    if dense.shape[1]:
        ref = _reference(ns, v, dense, adds, base)
        assert np.array_equal(got[dense[DD_POS]], ref)
    if host is not None:
        assert np.array_equal(got, host)
    return got


def _reference(ns, v, dense, adds, base: int) -> np.ndarray:
    """The reference's ``encode_delta_core`` over the dense rows (node ids
    made global), called on descriptors padded to 16 rows and 32 - cap
    adds (rows of a node outside the state, adds not valid), which leave
    the rows unchanged, so that one shape a cap is traced."""
    cap, (d, a) = v.shape[2], adds.shape[1:]
    rows = -(-d // 16) * 16
    pd = np.zeros((DENSE_FIELDS - 1, rows), np.int32)
    pd[0] = INT32_MAX
    pd[:, :d] = dense[:DD_POS]
    pd[0, :d] -= base                     # the reference's rows are local
    pa = np.zeros((ADD_FIELDS, rows, 32 - cap), np.int32)
    pa[:, :d, :a] = adds
    ref = np.array(ref_encode(jnp.asarray(ns), jnp.asarray(v),
                              *[jnp.asarray(x) for x in (*pd, *pa)],
                              cap=cap, a=32 - cap))[:d]
    ref[:, 2] += base
    return ref


@pytest.mark.parametrize("seed,big,pending", CASES)
def test_model_matches_plain_reference_and_host_on_views(seed, big,
                                                         pending):
    """The views of ``test_torch_view_delta.py``: a plan's dense rows (the
    encoder), host rows (fallback and pending) and zero rows, each at its
    row of the patch index, against the host packing of every row."""
    _, _, _, dcs, _, view = _case(seed, big, pending)
    vd = ViewDelta(view, dcs.mirror, dcs.pending)
    hidx, desc, adds, hpos, hbuf = _patch_plan(dcs, vd)
    rows = {n: encode_row(view, n, dcs.cap) for n in vd}
    left = sorted(set(dcs.pending) - set(rows))
    _, pidx, pbuf = _patch_rows(rows, dcs.mirror, left, dcs.cap)
    assert hidx.tolist() == pidx.tolist()
    if desc is None:                      # no dense row: the host packs all
        assert not len(vd.dense)
        return
    _held(dcs.nodestate.numpy(), dcs.victims.numpy(), desc, adds, hpos,
          hbuf, len(hidx), host=pbuf)


def _drawn(seed: int, cap: int, a: int, d: int, h: int, zeros: int):
    """Random resident rows and descriptors the encoder's gate admits: per
    dense row some base slots removed, up to ``a`` adds (negative uids:
    keys 0 .. a-1), the kept slots at most cap; row 0 keeps exactly cap
    slots (no removal, no add), row 1 holds adds only (no resident
    victim), row 2 names a node outside the rows; priorities tie across
    adds and base victims."""
    rng = np.random.default_rng(seed)
    n = 40
    ns = np.zeros((5, n), np.int32)
    v = np.zeros((5, n, cap), np.int32)
    for r in range(n):
        s = cap if r == 0 else (0 if r == 1 else int(rng.integers(0, cap + 1)))
        bits = rng.permutation(24)
        prio = np.sort(rng.choice([1, 5, 5, 200, 900], s))
        for j in range(s):
            v[0, r, j] = 1 << int(bits[j] % 8) if j < 8 else 0
            v[1, r, j] = 1 << int(bits[j])
            v[2, r, j], v[4, r, j] = prio[j], 1
        v[3, r, :s] = rng.permutation(s)
        used_g = int(np.bitwise_or.reduce(v[0, r])) if s else 0
        used_c = int(np.bitwise_or.reduce(v[1, r])) if s else 0
        ns[0, r] = 0xFF & ~used_g & int(rng.integers(0, 256))
        ns[1, r] = 0xFFFFFF & ~used_c & int(rng.integers(0, 1 << 24))
        ns[2, r], ns[4, r] = r, INT32_MAX
    nodes = rng.choice(n, d, replace=False).astype(np.int32)
    nodes[:3] = (0, 1, n + 5)
    dense = np.zeros((DENSE_FIELDS, d), np.int32)
    addv = np.zeros((4, d, a), np.int32)
    for i, node in enumerate(nodes):
        stored = int(v[4, node].sum()) if node < n else 0
        rem = 0 if i < 2 else int(rng.integers(0, 1 << max(stored, 1)))
        rem &= (1 << stored) - 1
        kept = stored - bin(rem).count("1")
        na = 0 if i == 0 else min(a, cap - kept, int(rng.integers(1, a + 1)))
        dense[:DD_POS, i] = (node, rem, int(rng.integers(0, 256)),
                             int(rng.integers(0, 1 << 24)),
                             int(rng.integers(0, 256)),
                             int(rng.integers(0, 1 << 24)))
        for j in range(na):
            addv[:, i, j] = (1 << int(rng.integers(0, 8)),
                             1 << int(rng.integers(0, 24)),
                             int(rng.choice([1, 5, 200])), 1)
    pos = rng.permutation(d + h).astype(np.int32)
    dense[DD_POS] = pos[:d]
    hrows = rng.integers(-2**31, 2**31, (h, row_width(cap))).astype(np.int32)
    return ns, v, dense, addv, pos[d:].copy(), hrows, d + h + zeros


@pytest.mark.parametrize("seed,cap,a,d,h,zeros", [
    (0, 16, 1, 5, 2, 3), (1, 16, 4, 9, 0, 0), (2, 9, 8, 6, 3, 1),
    (3, 16, 16, 7, 1, 4), (4, 9, 7, 4, 2, 2)])
def test_model_matches_plain_and_reference_on_drawn_rows(seed, cap, a, d,
                                                        h, zeros):
    ns, v, dense, adds, hpos, hrows, p = _drawn(seed, cap, a, d, h, zeros)
    got = _held(ns, v, dense, adds, hpos, hrows, p)
    assert got[dense[DD_POS, 0], 5 + 4 * cap:5 + 5 * cap].tolist() == \
        [1] * cap                         # row 0 keeps exactly cap slots
    # the same rows as a shard whose first row is global row 1000
    shard = dense.copy()
    shard[0] += 1000
    moved = _held(ns, v, shard, adds, hpos, hrows, p, base=1000)
    got[dense[DD_POS], 2] += 1000         # the global node ids
    assert np.array_equal(moved, got)
