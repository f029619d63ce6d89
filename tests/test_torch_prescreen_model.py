"""A numpy model of the prescreen's kernels (``prescreen_cluster_kernel`` and
``prescreen_union_kernel`` in ``csrc/topo_score.cu``), written in the
kernels' own order, held on the CPU bit for bit to the plain versions
(``prescreen_plain``, ``prescreen_sel_plain``, ``prescreen_select_plain``)
and to the reference's ``_prescreen_core``.

* Geometry: clusters of ``ctas`` CTAs (one, or the split form's several),
  each CTA a segment of rows taken in windows of ``kSegRows``; a window's
  patch and forced rows staged into a row map (patch row + 1 | kForcedBit);
  16 lanes a row (32 above 16 slots), ``kPrescreenBatch`` row groups a
  warp's loads, the lanes of each row group taking the batch's tiers and
  keys.
* The bound pass: a row's eligible slots' masks summed as unsigned words
  that wrap, their count and least priority (the group's reductions), the
  tier of the free masks and of every eligible victim freed, the Eq. 1
  bounds in f32, the key ``(ordered bound) << 32 | ~row``.
* Each CTA's top k + 1: its live keys where they are no more, else those an
  exact radix select keeps: the live keys' count, OR and AND; passes of
  ``kDigitBits`` over the bits the live keys do not share, each a
  histogram of the candidates by digit and its ``kBinGroups`` group sums
  (a warp whose candidates share a bin adds once), the group and then the
  bin that holds the left-th largest, stopping once that bin is all
  selected; the gather.
* Every CTA ranks its own keys among all the CTAs': in one cluster the
  count of keys above each; in the split form each CTA sorts its list
  first and a key's rank is the count of keys above it in every list (a
  binary search a list), and the last cluster merges the clusters' sorted
  lists pairwise (a key's place: its own plus a binary search in the
  other list, each merge cut to k + 1 keys); excl_ub the bound of the key
  of rank k.  The union select over D shards (the kernel merges the
  shards' sorted lists, or counts where one is not sorted; both give the
  ranks modeled here by counting).

Cases: random and tie-heavy states, every row the same bound (the select
resolves on rows alone), patch rows, 37 forced rows, fewer entering rows
than k, k 1 / 128 / every row, n not a multiple of a segment, a shard base
above 0, 20 slots a row, D = 1, 2 and 4 shards; and every geometry (CTAs,
clusters, windows, the gathered keys in global scratch) giving the same
words.  The kernels' constants are read from the source.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core.cluster import apply_rows as ref_apply_rows  # noqa: E402
from repro.core.preemption_jax import _prescreen_core  # noqa: E402
from repro.core.topology import SPECS as REF_SPECS  # noqa: E402
from repro_torch.core.placement_device import (best_tier_counts,  # noqa: E402
                                               spec_slices)
from repro_torch.core.topology import SPECS  # noqa: E402
from repro_torch.kernels import prescreen as psk  # noqa: E402
from repro_torch.kernels.fused_class import FusedRequest  # noqa: E402

SOURCE = (Path(psk.__file__).parent / "csrc" / "topo_score.cu").read_text()
INT32_MAX = 2**31 - 1
U32 = 0xFFFFFFFF
M64 = (1 << 64) - 1


def _constant(name: str) -> int:
    expr = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE).group(1)
    m = re.fullmatch(r"(\d+)|1 << (\w+)", expr.strip())
    return int(m.group(1)) if m.group(1) else 1 << _value(m.group(2))


def _value(token: str) -> int:
    return int(token) if token.isdigit() else _constant(token)


THREADS = _constant("kPrescreenThreads")
BATCH = _constant("kPrescreenBatch")
SEG_ROWS = _constant("kSegRows")
CLUSTER_UNION = _constant("kClusterUnionKeys")
DIGIT = _constant("kDigitBits")
BINS = _constant("kBins")
GROUPS = _constant("kBinGroups")
FORCED = _constant("kForcedBit")
SHORTLIST_M = _constant("kShortlistM")


def test_constants_match_the_source():
    """The wrapper's eligible-victim cap is the kernel's; a digit's bins
    are 8 a lane; 16 CTAs' lists at k 128 (the main path's) stay in
    shared memory."""
    assert psk.NARROW_M == SHORTLIST_M
    assert BINS == 1 << DIGIT and THREADS % 32 == 0
    assert BINS % GROUPS == 0 and BINS // GROUPS == 8 * 32  # 8 bins a lane
    assert 2 * 16 * 129 <= CLUSTER_UNION


# ---------------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------------

def segments(n: int, ctas: int, clusters: int):
    """(cluster, rank, first row, rows) of every CTA, and seg."""
    cseg = -(-n // clusters)
    seg = -(-cseg // ctas)
    out = []
    for c in range(clusters):
        c_lo = min(n, c * cseg)
        c_hi = min(n, c_lo + cseg)
        for rank in range(ctas):
            lo = min(c_hi, c_lo + rank * seg)
            out.append((c, rank, lo, min(c_hi, lo + seg) - lo))
    return out, seg


def batch_rows(wn: int, threads: int, cap: int) -> np.ndarray:
    """The window row each (iteration, batch, warp, group) takes: row i =
    (it * B + b) * step + warp * rows_warp + sub, i < wn."""
    g = 16 if cap <= 16 else 32
    rows_warp = 32 // g
    step = threads // 32 * rows_warp
    taken = []
    it = 0
    while it * step * BATCH < wn:
        for b in range(BATCH):
            for warp in range(threads // 32):
                for sub in range(rows_warp):
                    i = (it * BATCH + b) * step + warp * rows_warp + sub
                    if i < wn:
                        taken.append(i)
        it += 1
    return np.array(taken, np.int64)


def ordered_u(ub: np.ndarray) -> np.ndarray:
    i = (ub.astype(np.float32) + np.float32(0.0)).view(np.int32)
    o = i ^ ((i >> 31) & 0x7FFFFFFF)
    return o.view(np.uint32) ^ np.uint32(0x80000000)


def bound_of(key: int) -> np.float32:
    if key == 0:
        return np.float32(-np.inf)
    u = np.array([(key >> 32) ^ 0x80000000], np.uint32).view(np.int32)
    return (u ^ ((u >> 31) & 0x7FFFFFFF)).view(np.float32)[0]


def eq1(pp: np.ndarray, tier: np.ndarray, alpha: float) -> np.ndarray:
    """Eq. 1 in f32, one rounding an operation (eq1_score)."""
    one = np.float32(1.0)
    pt = np.where(pp > 0, one / np.maximum(pp, 1).astype(np.float32), one)
    tv = np.array([1.0, 0.5, 0.1, 0.1], np.float32)[np.minimum(tier, 3)]
    return (np.float32(alpha) * pt.astype(np.float32)
            + np.float32(1.0 - alpha) * tv)


def tiers(g: np.ndarray, c: np.ndarray, req, spec) -> np.ndarray:
    t, _, _ = best_tier_counts(
        torch.from_numpy(g.astype(np.uint32).view(np.int32)),
        torch.from_numpy(c.astype(np.uint32).view(np.int32)),
        req.need_gpus, req.need_cgs, req.cgs_per_bundle,
        spec_slices(spec, torch.device("cpu")))
    return t.numpy()


def bound_pass(ns, v, pidx, pbuf, rep, forced, lo: int, nk: int, seg: int,
               req, spec, base: int, seg_rows: int) -> np.ndarray:
    """One CTA's keys of rows [lo, lo + nk), window by window."""
    cap = v.shape[2]
    g_lanes = 16 if cap <= 16 else 32
    keys = np.zeros(nk, np.uint64)
    threads = THREADS
    for w0 in range(0, nk, seg_rows):
        wn = min(nk - w0, seg_rows)
        r0 = lo + w0
        m = np.zeros(wn, np.int64)
        for j, x in enumerate(pidx):          # the staged row map
            g = int(x) - base - r0
            if 0 <= g < wn:
                m[g] |= j + 1
        for x in forced:
            g = int(x) - base - r0
            if 0 <= g < wn:
                m[g] |= FORCED
        order = batch_rows(wn, threads, cap)
        assert sorted(order.tolist()) == list(range(wn))
        rows = r0 + order
        mo = m[order]
        pj = (mo & (FORCED - 1)) - 1
        node = ns[:, rows].astype(np.int64)
        slots = np.zeros((5, len(rows), g_lanes), np.int64)
        slots[:, :, :cap] = v[:, rows, :]
        for x, p in enumerate(pj):            # a patch row in its place
            if p >= 0:
                node[:, x] = pbuf[p, :5]
                slots[:, x, :cap] = pbuf[p, 5:5 + 5 * cap].reshape(5, cap)
        lane = np.arange(g_lanes)
        el = (lane < cap) & (slots[4] != 0) & (slots[2] < req.thresh)
        elig = el.sum(1)                      # popc of the group's ballot
        sg = (np.where(el, slots[0], 0) & U32).sum(1) & U32   # wraps
        sc = (np.where(el, slots[1], 0) & U32).sum(1) & U32
        min_p = np.where(el, slots[2], INT32_MAX).min(1)
        fg, fc = node[0] & U32, node[1] & U32
        ft = tiers(fg, fc, req, spec)         # lanes 2b of the groups
        et = tiers((fg + sg) & U32, (fc + sc) & U32, req, spec)  # 2b + 1
        ub0 = np.where(ft < 3, eq1(np.zeros_like(min_p), ft, req.alpha),
                       np.float32(-np.inf))
        ubk = np.where((elig > 0) & (et < 3), eq1(min_p, et, req.alpha),
                       np.float32(-np.inf))
        ub = np.maximum(ub0, ubk).astype(np.float32)
        ok = ((node[2] < INT32_MAX) & ((rep[rows] != 0) | (mo & FORCED != 0))
              & (elig <= SHORTLIST_M) & ~((node[3] != 0)
                                          & (node[4] < req.thresh))
              & (ub > -np.inf))
        key = ((ordered_u(ub).astype(np.uint64) << np.uint64(32))
               | (np.uint64(U32) - (base + rows).astype(np.uint64)))
        keys[w0 + order] = np.where(ok, key, np.uint64(0))
    return keys


def radix_select(keys: np.ndarray, k: int):
    """The cut (prefix, mask) of one CTA's select of the k-th largest live
    key, and its passes: the histograms built a warp's 32 keys at a time
    (once where they share a bin)."""
    live = keys[keys != 0]
    if len(live) <= k:
        return 0, 0, 0
    orv = int(np.bitwise_or.reduce(live))
    andv = int(np.bitwise_and.reduce(live))
    var = orv ^ andv
    top = var.bit_length() - 1
    mask = 0 if top == 63 else (M64 << (top + 1)) & M64
    prefix = andv & mask
    left, passes = k, 0
    while True:
        passes += 1
        shift = max(0, top - (DIGIT - 1))
        nb = 1 << (top - shift + 1)
        hist = np.zeros(nb, np.int64)
        for b0 in range(0, len(keys), 32):
            chunk = keys[b0:b0 + 32]
            take = (chunk != 0) & ((chunk & np.uint64(mask))
                                   == np.uint64(prefix))
            bins = ((chunk[take] >> np.uint64(shift))
                    & np.uint64(nb - 1)).astype(np.int64)
            if len(bins) and (bins == bins[0]).all():
                hist[bins[0]] += len(bins)    # one add for the warp
            else:
                np.add.at(hist, bins, 1)
        assert nb <= BINS
        # one warp picks the group (kBinGroups sums), then the bin in it
        hist = np.pad(hist, (0, BINS - nb))
        groups = hist.reshape(GROUPS, -1).sum(1)
        above = 0
        for g in range(GROUPS - 1, -1, -1):
            if above < left <= above + groups[g]:
                break
            above += groups[g]
        for b in range(g * (BINS // GROUPS) + BINS // GROUPS - 1,
                       g * (BINS // GROUPS) - 1, -1):
            if above < left <= above + hist[b]:
                pick, left, whole = b, left - above, hist[b] == left - above
                break
            above += hist[b]
        prefix |= pick << shift
        mask |= (nb - 1) << shift
        if whole or shift == 0:
            break
        rest = var & ((1 << shift) - 1)
        if rest == 0:
            break
        top = rest.bit_length() - 1
    return prefix, mask, passes


def local_top(keys: np.ndarray, k: int) -> np.ndarray:
    """A CTA's top k + 1, unordered: its live keys where they are no more,
    else those the radix select's cut (of k + 1) keeps."""
    live = keys[keys != 0]
    prefix, mask, _ = radix_select(keys, k + 1)
    take = (live & np.uint64(mask)) >= np.uint64(prefix)
    assert take.sum() == min(k + 1, len(live))
    return live[take]


def rank_by_count(all_keys: np.ndarray, mine: np.ndarray, k: int,
                  limit: int):
    """The ranks of ``mine`` among ``all_keys`` (the count of keys above
    each): {rank: key} below ``limit`` and the key of rank k (0 if none)."""
    rank = (all_keys[None, :] > mine[:, None]).sum(1)
    placed = {int(r): key for r, key in zip(rank, mine) if r < limit}
    kth = [int(key) for r, key in zip(rank, mine) if r == k]
    return placed, kth[0] if kth else 0


def in_order(placed: dict) -> np.ndarray:
    assert sorted(placed) == list(range(len(placed)))   # ranks 0 .. m-1
    return np.array([placed[r] for r in sorted(placed)], np.uint64)


def words(ordered: np.ndarray, below: int, k: int, raise_bits=()):
    """out (rows, IDX_SENTINEL, the bits of excl_ub) and sel."""
    out = np.full(k + 1, INT32_MAX, np.int64)
    out[:len(ordered)] = (np.uint64(U32) - (ordered & np.uint64(U32))
                          ).astype(np.int64)
    ub = bound_of(below)
    for e in raise_bits:
        ub = max(ub, np.array([e], np.int32).view(np.float32)[0])
    out[k] = int(np.array([ub], np.float32).view(np.int32)[0])
    sel = np.zeros(k, np.uint64)
    sel[:len(ordered)] = ordered
    return out.astype(np.int32), sel


def rank_in_lists(lists, own: int, k: int, limit: int):
    """The ranks of list ``own``'s keys among descending lists (the count
    of keys above each in every list, a binary search a list:
    np.searchsorted on the ascending copies)."""
    asc = [np.sort(x) for x in lists]
    for x in lists:
        assert (x[:-1] > x[1:]).all()          # descending
    placed = {}
    for key in lists[own]:
        r = sum(len(a) - np.searchsorted(a, key, "right") for a in asc)
        if r < limit:
            placed[int(r)] = key
    return placed


def merge_lists(lists, stride: int) -> np.ndarray:
    """Descending lists merged pairwise, level by level, each merge cut to
    ``stride`` keys: a key's place is its place in its own list plus the
    count of keys above it in the other (a binary search)."""
    lists = [np.asarray(x, np.uint64) for x in lists]
    while len(lists) > 1:
        merged = []
        for a, b in zip(lists[::2], lists[1::2] + [np.zeros(0, np.uint64)]):
            out = np.zeros(min(len(a) + len(b), stride), np.uint64)
            for mine, other in ((a, b), (b, a)):
                asc = np.sort(other)
                for p, key in enumerate(mine):
                    at = p + len(asc) - np.searchsorted(asc, key, "right")
                    if at < stride:
                        out[at] = key
            merged.append(out)
        lists = merged
    return lists[0]


def model_prescreen(ns, v, pidx, pbuf, rep, forced, *, k, req, spec,
                    base=0, ctas=16, clusters=1, seg_rows=SEG_ROWS):
    """The cluster kernel's out and sel: every CTA's top k + 1; in one
    cluster each CTA's keys ranked among the cluster's by counting; in the
    split form each CTA's sorted list ranked among the cluster's lists,
    then the clusters' lists merged in the last cluster."""
    n = ns.shape[1]
    ctas_all, seg = segments(n, ctas, clusters)
    lists = [[] for _ in range(clusters)]
    for c, _, lo, nk in ctas_all:
        keys = bound_pass(ns, v, pidx, pbuf, rep, forced, lo, nk, seg, req,
                          spec, base, seg_rows)
        lists[c].append(local_top(keys, k))
    if clusters == 1:
        everyone = np.concatenate(lists[0])
        assert len(everyone) <= ctas * (k + 1)
        placed, kth = {}, 0
        for mine in lists[0]:               # each CTA its own keys
            p, kk = rank_by_count(everyone, mine, k, k)
            placed.update(p)
            kth = kth or kk
        return words(in_order(placed), kth, k)
    tops = []
    for c in range(clusters):
        sorted_lists = [np.sort(x)[::-1] for x in lists[c]]   # each CTA's
        placed = {}
        for own in range(len(sorted_lists)):
            placed.update(rank_in_lists(sorted_lists, own, k, k + 1))
        tops.append(in_order(placed))
    merged = merge_lists(tops, k + 1)
    return words(merged[:k], int(merged[k]) if len(merged) > k else 0, k)


def model_union(keys: np.ndarray, k: int, excl: np.ndarray) -> np.ndarray:
    """The union kernel's out: the live keys ranked among themselves."""
    live = keys.reshape(-1)[keys.reshape(-1) != 0]
    placed, kth = rank_by_count(live, live, k, k)
    return words(in_order(placed), kth, k, excl.tolist())[0]


# ---------------------------------------------------------------------------------
# states
# ---------------------------------------------------------------------------------

def random_rows(spec, rows: int, seed: int, kind: str, cap: int = 16):
    """Resident rows as the allocator leaves them (one node's masks
    disjoint), some truncated, some sentinels; "tie" has runs of identical
    rows and a few priorities only, "tied" every row free and empty (one
    bound for all)."""
    rng = np.random.default_rng(seed)
    ns = np.zeros((5, rows), np.int32)
    v = np.zeros((5, rows, cap), np.int32)
    for r in range(rows):
        if kind == "tie" and r and rng.random() < 0.4:
            ns[:, r], v[:, r] = ns[:, r - 1], v[:, r - 1]
            ns[2, r] = r
            continue
        s = 0 if kind == "tied" else int(rng.integers(0, min(cap, 12) + 1))
        own_g = rng.integers(-1, s + 1, spec.num_gpus)
        own_c = rng.integers(-1, s + 1, spec.num_coregroups)
        if kind == "tied":
            own_g[:], own_c[:] = 0, 0
        prio = np.sort(rng.choice([1, 2, 200, 200, 900], s) if kind == "tie"
                       else rng.integers(0, 1600, s))
        ranks = rng.permutation(s)
        for j in range(s):
            v[0, r, j] = sum(1 << i for i in np.nonzero(own_g == j + 1)[0])
            v[1, r, j] = sum(1 << i for i in np.nonzero(own_c == j + 1)[0])
            v[2, r, j], v[3, r, j], v[4, r, j] = prio[j], ranks[j], 1
        ns[0, r] = sum(1 << i for i in np.nonzero(own_g == 0)[0])
        ns[1, r] = sum(1 << i for i in np.nonzero(own_c == 0)[0])
        ns[2, r] = INT32_MAX if rng.random() < 0.05 else r
        if kind != "tied" and rng.random() < 0.1:
            ns[3, r], ns[4, r] = 1, int(rng.integers(0, 1600))
        else:
            ns[4, r] = INT32_MAX
    return ns, v


def _flat(ns, v):
    p = ns.shape[1]
    return np.concatenate([ns.T, v.transpose(1, 0, 2).reshape(p, -1),
                           np.zeros((p, 2), np.int32)], axis=1).astype(
                               np.int32)


def state(kind: str, rows: int, seed: int, *, patched: bool, rep_share=0.6,
          cap: int = 16, sku: str = "rtx4090"):
    spec = SPECS[sku]
    ns, v = random_rows(spec, rows, seed, kind, cap)
    rng = np.random.default_rng(seed + 50)
    rep = (rng.random(rows) < rep_share).astype(np.int32)
    forced = np.sort(rng.choice(rows, 37, replace=False)).astype(np.int32)
    if patched:
        nodes = np.sort(rng.choice(rows, 9, replace=False)).astype(np.int32)
        pns, pv = random_rows(spec, 9, seed + 7, kind, cap)
        pns[2] = nodes
        pidx = np.concatenate([nodes, [INT32_MAX] * 7]).astype(np.int32)
        pbuf = np.concatenate([_flat(pns, pv),
                               np.zeros((7, 5 + 5 * cap + 2), np.int32)])
    else:
        pidx = np.zeros(0, np.int32)
        pbuf = np.zeros((0, 5 + 5 * cap + 2), np.int32)
    return spec, (ns, v, pidx, pbuf, rep, forced)


REQS = (FusedRequest(1000, 2, 2, 1, 0.5), FusedRequest(300, 4, 4, 0, 1.0),
        FusedRequest(1500, 1, 1, 1, 0.0))


def plain(args, k, req, spec, base=0):
    t = [torch.from_numpy(x) for x in args]
    out = psk.prescreen_plain(*t, k=k, req=req, spec=spec, base=base)
    sel = psk.prescreen_sel_plain(*t, k=k, req=req, spec=spec, base=base)
    return out.numpy(), sel.numpy().view(np.uint64)


def reference(args, k, req, spec):
    """The reference's _prescreen_core on the rows with the patch rows
    applied and the forced rows set in rep: gidx and excl_ub's bits."""
    ns, v, pidx, pbuf, rep, forced = args
    dr = np.zeros((2, ns.shape[1]), np.int32)
    ons, ov, odr = ref_apply_rows(jnp.asarray(ns), jnp.asarray(v),
                                  jnp.asarray(dr), jnp.asarray(pidx),
                                  jnp.asarray(pbuf))
    rrep = rep != 0
    rrep[forced] = True
    gidx, excl = _prescreen_core(ons, ov, odr, jnp.asarray(rrep), req.thresh,
                                 req.need_gpus, req.need_cgs,
                                 req.cgs_per_bundle, req.alpha,
                                 spec=REF_SPECS[spec.name], k=k)
    return np.concatenate([np.asarray(gidx, np.int32), np.asarray(
        excl, np.float32).reshape(1).view(np.int32)])


# ---------------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------------

CASES = [  # kind, rows, k, patched, rep share, cap
    ("random", 300, 128, True, 0.6, 16),
    ("random", 300, 1, False, 0.6, 16),
    ("random", 300, 300, True, 0.6, 16),
    ("tie", 300, 128, True, 0.6, 16),
    ("tied", 300, 128, False, 0.6, 16),
    ("tied", 300, 300, True, 0.6, 16),
    ("random", 300, 128, False, 0.1, 16),     # fewer entering rows than k
    ("random", 300, 128, False, 0.6, 20),     # 32 lanes a row
]


@pytest.mark.parametrize("kind,rows,k,patched,share,cap", CASES)
def test_model_matches_plain_and_reference(kind, rows, k, patched, share,
                                           cap):
    """The model (one cluster of 16 CTAs: 300 rows are 19 a segment and 15
    in the last) against the plain versions and the reference, bit for
    bit: gidx in order, excl_ub's bits and the selected keys."""
    spec, args = state(kind, rows, rows + k + cap, patched=patched,
                       rep_share=share, cap=cap)
    for req in REQS[:2]:
        out, sel = model_prescreen(*args, k=k, req=req, spec=spec)
        want, want_sel = plain(args, k, req, spec)
        assert np.array_equal(out, want), (req, out, want)
        assert np.array_equal(sel, want_sel)
        assert np.array_equal(out, reference(args, k, req, spec))


GEOMETRIES = [  # ctas, clusters, window rows
    (16, 1, SEG_ROWS), (8, 1, SEG_ROWS), (1, 1, SEG_ROWS), (16, 2, SEG_ROWS),
    (8, 4, SEG_ROWS), (4, 8, 16), (16, 1, 3), (2, 3, SEG_ROWS)]


@pytest.mark.parametrize("ctas,clusters,seg_rows", GEOMETRIES)
def test_every_geometry_gives_the_same_words(ctas, clusters, seg_rows):
    """One cluster or several (the split form), CTAs from 1 to 16, windows
    of a few rows (the keys through global scratch), a CTA's radix select
    where its live keys are more than k + 1 (every case at k 1, most at
    37): the same rows, bits and selected keys; 257 rows leave ragged
    segments."""
    for kind, k in (("random", 37), ("tie", 128), ("tied", 1)):
        spec, args = state(kind, 257, 11 + k, patched=True)
        want = plain(args, k, REQS[0], spec)
        if clusters > 1 and 2 * max(ctas, clusters) * (k + 1) > CLUSTER_UNION:
            continue
        got = model_prescreen(*args, k=k, req=REQS[0], spec=spec, ctas=ctas,
                              clusters=clusters, seg_rows=seg_rows)
        assert np.array_equal(got[0], want[0]) and np.array_equal(
            got[1], want[1]), (kind, k)


def test_select_skips_shared_bits_and_stops_early():
    """Tied bounds resolve on the row bits alone: the pass count is the
    row word's varying bits over kDigitBits, never the bound's; random
    bounds stop at the first bin that is all selected."""
    spec, args = state("tied", 300, 5, patched=False, rep_share=1.0)
    keys = bound_pass(*args, lo=0, nk=300, seg=300, req=REQS[0], spec=spec,
                      base=0, seg_rows=SEG_ROWS)
    live = keys[keys != 0]
    assert len(np.unique(live >> np.uint64(32))) == 1
    _, _, passes = radix_select(keys, 100)
    assert passes == -(-(299).bit_length() // DIGIT)      # 9 row bits: 1
    spec, args = state("random", 300, 6, patched=False, rep_share=1.0)
    keys = bound_pass(*args, lo=0, nk=300, seg=300, req=REQS[0], spec=spec,
                      base=0, seg_rows=SEG_ROWS)
    prefix, mask, passes = radix_select(keys, 100)
    live = keys[keys != 0]
    assert ((live & np.uint64(mask)) >= np.uint64(prefix)).sum() == 100
    assert passes <= -(-64 // DIGIT)


def test_shard_base_gives_global_rows():
    """A shard whose first row is global row 1000: the model's rows are
    global and its words the plain version's."""
    spec, args = state("random", 200, 21, patched=False)
    ns, v, _, pbuf, rep, forced = args
    pidx = np.array([1003, 1050, INT32_MAX, INT32_MAX], np.int32)
    pbuf = np.zeros((4, pbuf.shape[1]), np.int32)
    pbuf[:2] = _flat(ns[:, [7, 9]], v[:, [7, 9]])
    pbuf[:2, 2] = (1003, 1050)
    forced = (forced + 1000).astype(np.int32)
    a = (ns, v, pidx, pbuf, rep, forced)
    for k in (1, 128, 200):
        got = model_prescreen(*a, k=k, req=REQS[0], spec=spec, base=1000)
        want = plain(a, k, REQS[0], spec, base=1000)
        assert np.array_equal(got[0], want[0]) and np.array_equal(
            got[1], want[1])
        assert (got[0][:k][got[0][:k] < INT32_MAX] >= 1000).all()


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_union_of_shards_matches_select_plain_and_all_rows(shards):
    """Each shard's model (its sel and excl_ub), the union model over their
    keys against ``prescreen_select_plain`` and against the prescreen over
    every row."""
    rows = 256
    spec, args = state("tie", rows, 30 + shards, patched=True)
    ns, v, pidx, pbuf, rep, forced = args
    per = rows // shards
    for k in (1, 37, 128):
        kd = min(k, per)
        keys = np.zeros((shards, kd), np.uint64)
        excl = np.zeros(shards, np.int32)
        for d in range(shards):
            lo = d * per
            mine = (pidx >= lo) & (pidx < lo + per)
            a = (np.ascontiguousarray(ns[:, lo:lo + per]),
                 np.ascontiguousarray(v[:, lo:lo + per]), pidx[mine],
                 pbuf[:len(pidx)][mine], rep[lo:lo + per], forced)
            out, sel = model_prescreen(*a, k=kd, req=REQS[0], spec=spec,
                                       base=lo)
            keys[d], excl[d] = sel, out[kd]
            want = plain(a, kd, REQS[0], spec, base=lo)
            assert np.array_equal(out, want[0]) and np.array_equal(
                sel, want[1])
        got = model_union(keys, k, excl)
        kt = torch.from_numpy(keys.view(np.int64))
        assert np.array_equal(got, psk.prescreen_select_plain(
            kt, k, torch.from_numpy(excl)).numpy())
        assert np.array_equal(got, plain(args, k, REQS[0], spec)[0])

