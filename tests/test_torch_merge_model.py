"""A numpy model of the two shard merges that run inside the last shard's
launches, held to their plain versions on the CPU.

Over a sharded state the last shard's tail (``fused_argmax_kernel<true>``
with the earlier shards' records) and its normal cycle
(``normal_cycle_kernel`` with them) merge every shard's records in their
own launch (``csrc/topo_score.cu``).  The model follows the kernels' own
steps:

* The tail (``tail_merge_shards``): lane d takes shard d's ``TailState``
  (here in any assignment of shards to lanes), the lanes merge with
  ``warp_merge_tail``'s redux steps (the max score, the tiers and tie keys
  of the lanes at it field by field, the wrapping count), and also in a
  random tree of ``merge_tail``; the global same-tier test picks a or b;
  the least lane whose record holds the winner's flat index gives its
  entry (the last shard's own from its own state); with no survivor the
  least earlier shard that holds the segment's first row gives it, else
  the last shard where it holds it, else shard 0.  Records come from the
  tail's plain shard form on random class tables with forced exact ties,
  over 1 resident segment and over 3 segments of gathered rows (a
  permutation of every shard's rows, sentinels and segments with no
  survivor among them), and the model is held to ``tail_merge_plain`` on
  the same records and to the unsharded tail.
* K2 (``normal_cycle_kernel``): the split form's clusters take the ticket
  in every arrival order; the cluster that takes the last reads every
  record (its launch's and the earlier shards') and takes the least over
  its CTA (threads strided over the records, each warp's least with its
  lane's payload, then warp 0 over the warps); the one-cluster form folds
  the staged earlier records into its own minimum in one warp.  Row 0
  comes from shard 0's record.  Held to ``normal_merge_plain`` on random
  records with forced exact ties (equal tier and leftover, ids deciding)
  and clusters that hold no candidate.

D in {2, 3, 4, 8} shards throughout.
"""
import itertools
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.cluster import IDX_SENTINEL  # noqa: E402
from repro_torch.core.placement_device import \
    normal_cycle_core  # noqa: E402
from repro_torch.core.topology import RTX4090_SERVER as SPEC  # noqa: E402
from repro_torch.kernels.fused_class import (C_ANY, C_CNT,  # noqa: E402
                                             C_NID, CLS_FIELDS, PART_FIELDS,
                                             FusedRequest, fused_argmax_plain,
                                             tail_merge_plain)
from repro_torch.kernels.normal_cycle import (NO_KEY,  # noqa: E402
                                              normal_merge_plain)

INT_MAX = 2**31 - 1
IDENTITY_TIE = (INT_MAX, INT_MAX, INT_MAX, -1, INT_MAX)
SHARDS = (2, 3, 4, 8)
EMPTY = (torch.zeros(0, dtype=torch.int32),
         torch.zeros((0, 5 + 5 * 8 + 2), dtype=torch.int32))


# ---------------------------------------------------------------------------------
# The tail's merge
# ---------------------------------------------------------------------------------

def _tie_order(k):
    """TieKey's order (ppe asc, k asc, node id asc, uid mask desc, flat
    asc) as a sortable tuple."""
    return (k[0], k[1], k[2], -k[3], k[4])


def tail_identity():
    return (np.float32(-np.inf), 3, -1, 0, IDENTITY_TIE, IDENTITY_TIE)


def tail_state(rec) -> tuple:
    """A shard record's TailState: score bits, tmin, tmax, count, a, b."""
    return (np.array([rec[0]], np.int32).view(np.float32)[0], int(rec[1]),
            int(rec[2]), int(rec[3]) & 0xFFFFFFFF,
            tuple(int(x) for x in rec[4:9]),
            tuple(int(x) for x in rec[9:14]))


def merge_tail(x, y):
    """merge_tail: the max score, its tiers and tie keys, the count."""
    cnt = (x[3] + y[3]) & 0xFFFFFFFF
    if y[0] > x[0]:
        return y[:3] + (cnt,) + y[4:]
    if y[0] < x[0]:
        return x[:3] + (cnt,) + x[4:]
    return (x[0], min(x[1], y[1]), max(x[2], y[2]), cnt,
            min(x[4], y[4], key=_tie_order), min(x[5], y[5], key=_tie_order))


def warp_min_tie(keys, at):
    """warp_min_tie: the least key over the lanes where ``at`` holds, one
    redux a field, each later field among the lanes that tie so far."""
    c = list(at)
    out = []
    for f, pick, none in ((0, min, INT_MAX), (1, min, INT_MAX),
                          (2, min, INT_MAX), (3, max, -INT_MAX - 1),
                          (4, min, INT_MAX)):
        m = pick(k[f] if ci else none for k, ci in zip(keys, c))
        out.append(m)
        c = [ci and k[f] == m for k, ci in zip(keys, c)]
    return tuple(out)


def warp_merge_tail(lanes):
    """warp_merge_tail over 32 lanes (identities past the shards)."""
    lanes = list(lanes) + [tail_identity()] * (32 - len(lanes))
    top = max(x[0] for x in lanes)
    at = [x[0] == top for x in lanes]
    return (top, min(x[1] if a else 3 for x, a in zip(lanes, at)),
            max(x[2] if a else -1 for x, a in zip(lanes, at)),
            sum(x[3] for x in lanes) & 0xFFFFFFFF,
            warp_min_tie([x[4] for x in lanes], at),
            warp_min_tie([x[5] for x in lanes], at))


def model_tail_merge(recs: np.ndarray, alpha_pos: bool, lanes: list[int],
                     rng: random.Random) -> list[int]:
    """The last shard's merge of one segment's records ``recs`` [D, 28]
    (the last shard's own state and entries from its own record), shard
    ``lanes[l]`` in lane l."""
    d_n = len(recs)
    states = [tail_state(r) for r in recs]
    m = warp_merge_tail([states[d] for d in lanes])
    tree = list(states)                   # the same by any merge order
    while len(tree) > 1:
        i = rng.randrange(len(tree) - 1)
        tree[i:i + 2] = [merge_tail(tree[i], tree[i + 1])]
    assert tree[0] == m
    cnt = m[3] - (1 << 32) if m[3] >= 1 << 31 else m[3]
    if m[0] > -np.inf:
        use_a = m[1] == m[2] and alpha_pos
        tk = m[4] if use_a else m[5]
        holders = [d for d in lanes if states[d][4 if use_a else 5][4]
                   == tk[4]]
        assert len(holders) == 1          # flat indices are unique
        e = recs[min(holders)][14 if use_a else 18:][:4]
        flat = tk[4]
        return [1, flat // 3, flat % 3, int(e[0]), int(e[1]), tk[1], cnt,
                int(e[2]), int(e[3])]
    flagged = [d for d in lanes if d < d_n - 1 and recs[d][22]]
    first = (min(flagged) if flagged
             else d_n - 1 if recs[d_n - 1][22] else 0)
    w = recs[first]
    return [0, 0, 0, int(w[23]), int(w[24]), int(w[25]), cnt, int(w[26]),
            int(w[27])]


def tie_table(rows: int, rng: np.random.Generator) -> np.ndarray:
    """Class winners that tie exactly: priority sums from {0, 1, 2, 4}
    (tier 0 with 2 and tier 1 with 1 both score 0.75 at alpha 0.5), small
    sets of k, node ids and uid masks, counts that overflow int32."""
    cls = np.zeros((CLS_FIELDS, rows), np.int32)
    cls[0:3] = rng.random((3, rows)) < 0.4
    cls[3:6] = rng.integers(0, 256, (3, rows))
    cls[6:9] = rng.choice(np.array([0, 1, 2, 4]), (3, rows))
    cls[9:12] = rng.choice(np.array([1, 2, 1 << 15]), (3, rows))
    cls[12] = rng.integers(1, 3, rows)
    cls[13] = rng.integers(0, INT_MAX, rows)
    cls[14] = rng.integers(0, 4, rows)
    return cls


def random_rows(n: int, rng: np.random.Generator):
    """Node state and victims of n rows with free masks and one victim a
    row, so that every placement differs."""
    ns = np.zeros((5, n), np.int32)
    ns[0] = rng.integers(0, 256, n)
    ns[1] = rng.integers(0, 256, n)
    ns[2] = np.arange(n)
    ns[4] = INT_MAX
    v = np.zeros((5, n, 8), np.int32)
    v[0, :, 0] = rng.integers(0, 256, n) & ~ns[0]
    v[1, :, 0] = rng.integers(0, 256, n) & ~ns[1]
    v[2, :, 0], v[4, :, 0] = 10, 1
    return ns, v


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.int32))


def resident_records(d: int, rng, req):
    """One resident segment over d shards of the rows: each shard's record
    and the unsharded tail's winner."""
    rows = 5
    n = rows * d
    ns, v = random_rows(n, rng)
    cls = tie_table(n, rng)
    cls[C_NID] = ns[2]
    if rng.random() < 0.25:               # no survivor anywhere
        cls[C_ANY:C_ANY + 3] = 0
    recs = np.stack([fused_argmax_plain(
        _t(cls[:, k * rows:(k + 1) * rows]), _t(ns[:, k * rows:(k + 1) * rows]),
        _t(v[:, k * rows:(k + 1) * rows]), *EMPTY, EMPTY[0], resident=True,
        seg=rows, req=req, spec=SPEC, base=k * rows,
        shard=(rows, k * rows, n - rows)).numpy() for k in range(d)])
    want = fused_argmax_plain(_t(cls), _t(ns), _t(v), *EMPTY, EMPTY[0],
                              resident=True, seg=n, req=req, spec=SPEC)
    return recs, want.numpy()


def gathered_records(d: int, rng, req, seg: int = 4, segs: int = 3):
    """``segs`` segments of ``seg`` gathered rows (every shard's rows in a
    random order, sentinels among them), each shard sweeping the rows it
    holds: each shard's records and the unsharded tail's winners."""
    rows = 3
    n = rows * d
    ns, v = random_rows(n, rng)
    g = seg * segs
    gidx = np.full(g, IDX_SENTINEL, np.int32)
    take = rng.permutation(n)[:g - 2]
    at = np.sort(rng.choice(g, len(take), replace=False))
    gidx[at] = take
    if rng.random() < 0.5:                # a segment that opens on a pad
        gidx[seg:] = np.roll(gidx[seg:], 1)
    real = gidx != IDX_SENTINEL
    cls = tie_table(g, rng)
    cls[C_NID] = np.where(real, ns[2, np.where(real, gidx, 0)], 0)
    cls[:, ~real] = 0
    cls[C_ANY:C_ANY + 3, seg:2 * seg] = 0      # segment 1: no survivor
    recs = []
    for k in range(d):
        mine = real & (gidx >= k * rows) & (gidx < (k + 1) * rows)
        ck = np.where(mine[None, :], cls, 0)
        cols = slice(k * rows, (k + 1) * rows)
        recs.append(fused_argmax_plain(
            _t(ck), _t(ns[:, cols]), _t(v[:, cols]), *EMPTY, _t(gidx),
            resident=False, seg=seg, req=req, spec=SPEC, base=k * rows,
            shard=(0, 0, 0)).numpy())
    want = fused_argmax_plain(_t(cls), _t(ns), _t(v), *EMPTY, _t(gidx),
                              resident=False, seg=seg, req=req, spec=SPEC)
    return np.stack(recs), want.numpy()


@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("segments", [1, 3])
@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_tail_merge_model_equals_the_plain_merge(d, segments, alpha):
    """Every lane order gives the plain merge of the same records and the
    unsharded tail's winner, segment by segment."""
    rng = np.random.default_rng(100 * d + 10 * segments + int(alpha * 2))
    prng = random.Random(d * segments)
    req = FusedRequest(1000, 1, 1, 1, alpha)
    for _ in range(6):
        recs, want = (resident_records(d, rng, req) if segments == 1
                      else gathered_records(d, rng, req, segs=segments))
        assert recs.shape == (d, segments, PART_FIELDS)
        plain = tail_merge_plain(torch.from_numpy(recs), alpha > 0).numpy()
        assert np.array_equal(plain, want)
        for sg in range(segments):
            for lanes in (list(range(d)), list(range(d))[::-1],
                          prng.sample(range(d), d)):
                got = model_tail_merge(recs[:, sg], alpha > 0, lanes, prng)
                assert got == plain[sg].tolist(), (sg, lanes, got)


def test_tail_merge_model_no_survivor_takes_the_first_holder():
    """With no survivor the least earlier shard holding the segment's
    first row gives it, else the last shard where it holds it, else shard
    0."""
    rec = np.zeros((4, PART_FIELDS), np.int32)
    rec[:, 0] = np.float32(-np.inf).view(np.int32)
    rec[:, 1], rec[:, 2] = 3, -1
    rec[:, 4:9], rec[:, 9:14] = IDENTITY_TIE, IDENTITY_TIE
    rec[:, 23] = np.arange(4) + 10
    prng = random.Random(0)
    for flags, first in (((0, 1, 1, 1), 1), ((0, 0, 0, 1), 3),
                         ((0, 0, 0, 0), 0), ((1, 0, 1, 0), 0)):
        rec[:, 22] = flags
        got = model_tail_merge(rec, True, [3, 1, 0, 2], prng)
        assert got[3] == 10 + first
        assert got == tail_merge_plain(torch.from_numpy(rec[:, None]),
                                       True)[0].tolist()


# ---------------------------------------------------------------------------------
# K2's merge
# ---------------------------------------------------------------------------------

def _i32(w: int) -> int:
    return int(np.uint32(w & 0xFFFFFFFF).view(np.int32))


def record(key: int, fg: int, fc: int) -> list[int]:
    """A 16-byte NormalBest record as four int32."""
    return [_i32(key), _i32(key >> 32), _i32(fg), _i32(fc)]


def key_of(rec) -> int:
    return (int(rec[0]) & 0xFFFFFFFF) | ((int(rec[1]) & 0xFFFFFFFF) << 32)


def normal_key(tier: int, left: int, nid: int, row: int) -> int:
    return ((tier << 62) | (left << 56)
            | (((nid & 0xFFFFFFFF) ^ 0x80000000) << 24) | row)


def random_normal_records(d: int, clusters: int, rng):
    """d shards' records, ``clusters`` minima each and row 0: equal tiers
    and leftovers (the node ids decide), clusters and whole shards with no
    candidate, unique node ids."""
    ids = rng.permutation(1000)[:d * clusters] + 5
    out = []
    for s in range(d):
        empty = rng.random() < 0.2
        recs = []
        for c in range(clusters):
            if empty or rng.random() < 0.3:
                recs.append(record(NO_KEY, 0, 0))
            else:
                recs.append(record(normal_key(
                    int(rng.integers(0, 2)), int(rng.integers(0, 2)),
                    int(ids[s * clusters + c]), int(rng.integers(0, 1 << 24))),
                    int(rng.integers(1, 256)), int(rng.integers(1, 256))))
        recs.append(record(int(rng.integers(0, 50)), int(rng.integers(0, 256)),
                           int(rng.integers(0, 256))))
        out.append(np.array(recs, np.int32))
    return out


def warp_min_normal(vals):
    """warp_min_normal over 32 lanes: the least key and its lane's
    payload."""
    vals = list(vals) + [(NO_KEY, 0, 0)] * (32 - len(vals))
    hi = min(k >> 32 for k, _, _ in vals)
    lo = min(k & 0xFFFFFFFF for k, _, _ in vals if k >> 32 == hi)
    src = next(i for i, (k, _, _) in enumerate(vals)
               if k == (hi << 32) | lo)
    return vals[src]


def cta_min(items, threads: int):
    """The last cluster's CTA: thread t folds items t, t + threads, ...;
    each warp's least, then warp 0 over the warps'."""
    per = []
    for t in range(threads):
        best = (NO_KEY, 0, 0)
        for it in items[t::threads]:
            if it[0] < best[0]:
                best = it
        per.append(best)
    warps = [warp_min_normal(per[w:w + 32]) for w in range(0, threads, 32)]
    return warp_min_normal(warps)


def place(best, row0):
    """normal_place: the winner's masks, or row 0's where no record holds
    a candidate, placed as normal_cycle_core places a node."""
    key, fg, fc = best
    if key == NO_KEY:
        nid, fg, fc = row0
    else:
        nid = _i32(((key >> 24) & 0xFFFFFFFF) ^ 0x80000000)
    col = torch.zeros((5, 1), dtype=torch.int32)
    col[0, 0], col[1, 0], col[2, 0] = _i32(fg), _i32(fc), nid
    return normal_cycle_core(col, 2, 2, 1, spec=SPEC).tolist()


def entries(recs: np.ndarray, count: int):
    return [(key_of(r), int(r[2]) & 0xFFFFFFFF, int(r[3]) & 0xFFFFFFFF)
            for r in recs[:count]]


def model_split(own: np.ndarray, prior: list, order, threads: int):
    """The split form: clusters write their records and take the ticket in
    ``order``; the one that takes the last ticket reads every record (its
    launch's and the earlier shards') and places the least; the ticket
    ends at 0."""
    clusters = len(own) - 1
    ticket, seen, last = 0, [], None
    for c in order:
        seen.append(c)                    # the record, then the fence
        if ticket == clusters - 1:
            last = (c, sorted(seen))
        ticket += 1
    ticket = 0                            # the last cluster resets it
    assert last is not None and last[1] == list(range(clusters))
    items = entries(own, clusters)
    for p in prior:
        items += entries(p, len(p) - 1)
    row0_rec = prior[0][-1] if prior else own[-1]
    row0 = (int(row0_rec[0]), int(row0_rec[2]), int(row0_rec[3]))
    return place(cta_min(items, threads), row0), ticket


def model_one_cluster(own_min, prior: list):
    """The one-cluster form: its own minimum, then warp 0's lanes over the
    staged earlier minima (lane-strided), warp_min_normal, row 0 from
    shard 0's record."""
    items = [e for p in prior for e in entries(p, len(p) - 1)]
    lanes = [own_min] + [(NO_KEY, 0, 0)] * 31
    for i, e in enumerate(items):
        if e[0] < lanes[i % 32][0]:
            lanes[i % 32] = e
    row0_rec = prior[0][-1]
    return place(warp_min_normal(lanes), (int(row0_rec[0]),
                                          int(row0_rec[2]),
                                          int(row0_rec[3])))


@pytest.mark.parametrize("d", SHARDS)
@pytest.mark.parametrize("clusters", [1, 3])
def test_normal_merge_model_equals_the_plain_merge(d, clusters):
    """The last shard's split form gives the plain merge of every shard's
    records for every arrival order of its clusters (CTAs of 32 and 96
    threads); its one-cluster form (one minimum of its own, the earlier
    shards' records staged) gives it too."""
    rng = np.random.default_rng(7 * d + clusters)
    for _ in range(8):
        recs = random_normal_records(d, clusters, rng)
        want = normal_merge_plain([torch.from_numpy(r) for r in recs],
                                  FusedRequest(0, 2, 2, 1, 0.5),
                                  SPEC).tolist()
        *prior, own = recs
        for order in itertools.permutations(range(clusters)):
            for threads in (32, 96):
                got, ticket = model_split(own, prior, order, threads)
                assert got == want and ticket == 0, (order, threads)
        own_min = min(entries(own, clusters), key=lambda e: e[0])
        assert model_one_cluster(own_min, prior) == want
