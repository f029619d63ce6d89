"""A numpy model of K1's class sweep and of K1's lane-form argmax, as the
CUDA kernels in ``csrc/topo_score.cu`` compute them, checked on the CPU.

The sweep (``fused_class_kernel``), row by row:

* only the 2^e subsets of a row's e eligible slots (among its first m): a
  dense index j whose bits are deposited at the eligible slots' positions
  gives the combo id over all m slots (`deposit`);
* j = (hi << L) | lo with L = max(0, e - log2 G) for a group of G threads:
  thread hi folds the slots its bits name once, and a table of the 2^L low
  folds (the free masks plus the low slots lo names) completes each subset
  with one fold (`sweep_row`);
* a fold adds the slots' per-NUMA GPU and CoreGroup counts packed 8 bits a
  NUMA node (`numa_words`) to the free masks', and the tier is a copy of
  the kernels' rule on those whole words (`fused_tier`: bundle units by a
  multiply in 16-bit lanes, byte-wise compares, socket sums by one
  multiply);
* Guaranteed Filtering on the drained masks (where the kernel's row has a
  spare thread, that thread judges them in the same pass: the same tier);
* where each thread holds one subset (L = 0), the feasible threads'
  ballot gives kmin and the count, per tier the least p_eff and the
  greatest uid mask come by shuffles within the group, and the lowest
  thread left holds the lowest id (`lane_merge`); else each thread's
  smallest feasible k, its count and its
  class keys, merged over the group kmin first and then field by field
  (`group_merge`), for
  sub-warp groups (16: a warp's rows each swept by its own group where
  every row of the warp has at most log2 G eligible slots, else by the
  whole warp one after another, `model_sweep`), one warp (32) and 16 warps
  merged by a second pass (the wide form's CTA of 512).

It is held to ``class_sweep_plain`` and to the reference's
``_fused_class_core`` on random states of the three SKUs whose free and
victim masks are pairwise disjoint (checked for every state), m 1-8 and 16,
alpha 0 and 0.5, with and without bundles, with rows that have no eligible
slot, no feasible subset, a sentinel node id, gathered pad indices, and
priorities and uid ranks that tie.

The lane form (``topo_score_argmax_kernel``): one lane a thread, the tier
from per-NUMA counts, the Eq. 1 score with one rounding an operation, and a
per-tile argmax by field-by-field reductions in each warp and then over the
warps, held to ``topo_score_argmax_plain`` for n in {1, 31, 256, 1500} with
duplicate keys, masked lanes and an all-infeasible tile.

The launch geometry of the sweep (``sweep_geometry``) and the launcher's
limits are checked last.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core.preemption_jax import _fused_class_core  # noqa: E402
from repro.core.topology import SPECS as REF_SPECS  # noqa: E402
from repro_torch.core.cluster import IDX_SENTINEL  # noqa: E402
from repro_torch.core.topology import SPECS  # noqa: E402
from repro_torch.kernels import topo_score as ts  # noqa: E402
from repro_torch.kernels.fused_class import (CLS_FIELDS,  # noqa: E402
                                             NARROW_KERNEL_M, SWEEP_THREADS,
                                             SWEEP_WARP_ROWS,
                                             WIDE_THREADS, FusedRequest,
                                             class_sweep_plain, plan_rows,
                                             SHARED_GROUP, sweep_geometry)

INT_MAX = 2**31 - 1
INT_MIN = -2**31
U32 = 0xFFFFFFFF
#: the most slots a narrow group of G threads takes (narrow_max_m in the
#: kernel source): at most 8 (a warp sweeping one row keeps at most 8 low
#: folds)
NARROW_MAX_M = {16: 8, 32: 8}


def i32(x):
    """int32 value of a 32-bit pattern (numpy int64 arrays or ints)."""
    x = np.asarray(x, np.int64) & U32
    return np.where(x >= 2**31, x - 2**32, x)


def popc(x):
    """Set bits of each 32-bit pattern (SWAR on int64)."""
    x = np.asarray(x, np.int64) & U32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & U32) >> 24


def deposit(j, valid: int):
    """j's bits at the positions of valid's set bits (pdep)."""
    j = np.asarray(j, np.int64)
    out = np.zeros(j.shape, np.int64)
    pos = [p for p in range(32) if (valid >> p) & 1]
    for b, p in enumerate(pos):
        out |= ((j >> b) & 1) << p
    return out


# ---------------------------------------------------------------------------------
# The tier from packed per-NUMA counts
# ---------------------------------------------------------------------------------

def numa_words(g, c, spec):
    """Per-NUMA GPU and CoreGroup counts of masks g, c, 8 bits a node."""
    wg = np.zeros(np.shape(g), np.int64)
    wc = np.zeros(np.shape(c), np.int64)
    for u in range(spec.num_numa):
        wg |= popc(np.asarray(g) & int(spec.numa_gpu_masks[u])) << (8 * u)
        wc |= popc(np.asarray(c) & int(spec.numa_cg_masks[u])) << (8 * u)
    return wg, wc


def bundle_magic(d: int) -> int:
    """The kernels' multiplier table: ceil(2^32 / d) for d = 1..32, else 0."""
    return U32 // d + 1 if 0 < d <= 32 else 0


def fused_tier(wg, wc, spec, ng: int, nc: int, cpb: int):
    """fused_tier of the kernels on whole 64-bit words (wrapping as the
    card's integers do): per NUMA byte the bundle units min(GPUs,
    CoreGroups // cpb), the division (x * ceil(1024 / cpb)) >> 10 in 16-bit
    lanes; then one NUMA byte, one socket's k adjacent bytes (summed by one
    multiply), or all bytes must meet the request."""
    u64 = np.uint64
    wg = np.asarray(wg, np.int64).astype(u64)
    wc = np.asarray(wc, np.int64).astype(u64)
    high = u64(0x8080808080808080)
    ones = u64(0x0101010101010101)

    def ge(x, n):
        return ((x | high) - u64(max(n, 0) & 127) * ones) & high

    def byte_sum(x):
        return ((x * ones) >> u64(56)).astype(np.int64)

    if ng > 32 or nc > 32:
        return np.full(wg.shape, 3)
    with np.errstate(over="ignore"):       # 64-bit products wrap
        return _word_tier(wg, wc, spec, ng, nc, cpb, ge, byte_sum)


def _word_tier(wg, wc, spec, ng, nc, cpb, ge, byte_sum):
    u64 = np.uint64
    high = u64(0x8080808080808080)
    k = max(1, sum(spec.socket_of_numa(u) == 0 for u in range(spec.num_numa)))
    numa = sum(0x80 << (8 * u) for u in range(spec.num_numa))
    spread = sum(1 << (8 * u) for u in range(k))
    sock_end = sum(0x80 << (8 * ((s + 1) * k - 1))
                   for s in range(spec.num_sockets) if (s + 1) * k <= 8)
    wu = wg
    if cpb > 0:
        m16 = u64((bundle_magic(cpb) + (1 << 22) - 1) >> 22)
        low16, quot = u64(0x00FF00FF00FF00FF), u64(0x003F003F003F003F)
        q = ((((wc & low16) * m16) >> u64(10)) & quot) | (
            ((((wc >> u64(8)) & low16) * m16) >> u64(10)) & quot) << u64(8)
        keep_q = ((((wg | high) - q) & high) >> u64(7)) * u64(0xFF)
        wu = (q & keep_q) | (wg & ~keep_q)
    numa_ok = (ge(wu, ng) & ge(wc, nc) & u64(numa)) != 0
    sock_ok = (ge(wu * u64(spread), ng) & ge(wc * u64(spread), nc)
               & u64(sock_end)) != 0
    glob_ok = (byte_sum(wu) >= ng) & (byte_sum(wc) >= nc)
    return np.where(numa_ok, 0, np.where(sock_ok, 1, np.where(glob_ok, 2, 3)))


# ---------------------------------------------------------------------------------
# The sweep model
# ---------------------------------------------------------------------------------

FIELDS = ("g", "c", "pr", "u", "id", "wg", "wc")


def folds(recs: dict, idx: np.ndarray, offset: int, count: int) -> dict:
    """For each index value, the fold of recs[offset + b] over its set bits
    b < count: masks and id OR'd, the rest added (32-bit wrap for the
    priority and rank sums)."""
    out = {f: np.zeros(idx.shape, np.int64) for f in FIELDS}
    for b in range(count):
        on = ((idx >> b) & 1) != 0
        for f in FIELDS:
            x = np.where(on, recs[f][offset + b], 0)
            out[f] = out[f] | x if f in ("g", "c", "id") else out[f] + x
    out["pr"] &= U32
    out["u"] &= U32
    return out


def lane_partials(k, tier, f, m: int, alpha_pos: bool):
    """Each thread's Partial over its subsets (axis 1): its smallest
    feasible k, the count at it, and per tier the lexicographic best
    (p_eff asc, uid mask desc, id asc) at it."""
    p = i32(f["pr"]) if alpha_pos else np.zeros_like(f["pr"])
    u, cid, pp = i32(f["u"]), f["id"], f["pr"]
    feas = tier < 3
    kmin = np.where(feas, k, m + 1).min(axis=1)
    at = feas & (k == kmin[:, None])
    best = []
    for t in range(3):
        sel = at & (tier == t)
        bp = np.where(sel, p, INT_MAX).min(axis=1)
        sel &= p == bp[:, None]
        bu = np.where(sel, u, INT_MIN).max(axis=1)
        sel &= u == bu[:, None]
        bid = np.where(sel, cid, INT_MAX).min(axis=1)
        sel &= cid == bid[:, None]
        bpp = np.where(sel, pp, 0).sum(axis=1)
        best.append(dict(p=bp, u=bu, id=bid, pp=bpp))
    return dict(kmin=kmin, cnt=at.sum(axis=1), best=best)


def group_merge(x: dict, alpha_pos: bool) -> dict:
    """group_merge of the kernel over the lanes (axis 0) of Partials x: the
    least kmin, the count summed over the lanes at it, then per tier one
    reduction a field among the lanes at kmin that hold a key."""
    kmin = x["kmin"].min()
    at = x["kmin"] == kmin
    out = dict(kmin=kmin, cnt=int(np.where(at, x["cnt"], 0).sum()) & U32,
               best=[])
    for b in x["best"]:
        c = at & (b["id"] != INT_MAX)
        w = dict(p=0)
        if alpha_pos:
            w["p"] = np.where(c, b["p"], INT_MAX).min()
            c &= b["p"] == w["p"]
        w["u"] = np.where(c, b["u"], INT_MIN).max()
        c &= b["u"] == w["u"]
        w["id"] = np.where(c, b["id"], INT_MAX).min()
        c &= b["id"] == w["id"]
        w["pp"] = (int(w["p"]) & U32 if alpha_pos
                   else int(np.where(c, b["pp"], 0).sum()) & U32)
        out["best"].append(w)
    return out


def lane_merge(k, tier, f, e: int, m: int, alpha_pos: bool, G: int) -> dict:
    """lane_row's merge where thread j holds subset j (L = 0): kmin is the
    first popcount class of the feasible threads' indices, the count its
    size; per tier, of the threads at kmin, the least p_eff (alpha > 0),
    then the greatest uid mask, then the lowest thread (the lowest combo
    id)."""
    feas = np.zeros(G, bool)
    feas[:1 << e] = tier < 3
    lanes = np.arange(G)
    none = dict(p=INT_MAX, u=INT_MIN, id=INT_MAX, pp=0)
    if not feas.any():
        return dict(kmin=m + 1, cnt=0, best=[none] * 3)
    kmin = int(popc(lanes[feas]).min())
    at = feas & (popc(lanes) == kmin)
    pe = i32(f["pr"][:, 0]) if alpha_pos else np.zeros(1 << e, np.int64)
    u = i32(f["u"][:, 0])
    best = []
    for t in range(3):
        c = at.copy()
        c[:1 << e] &= tier == t
        c[1 << e:] = False
        if not c.any():
            best.append(none)
            continue
        if alpha_pos:
            c[:1 << e] &= pe == pe[c[:1 << e]].min()
        c[:1 << e] &= u == u[c[:1 << e]].max()
        j = int(np.nonzero(c)[0][0])
        best.append(dict(p=int(pe[j]), u=int(u[j]), id=int(f["id"][j, 0]),
                         pp=int(f["pr"][j, 0])))
    return dict(kmin=kmin, cnt=int(at.sum()), best=best)


def stack(parts: list) -> dict:
    return dict(kmin=np.array([p["kmin"] for p in parts]),
                cnt=np.array([p["cnt"] for p in parts]),
                best=[{f: np.array([p["best"][t][f] for p in parts])
                       for f in ("p", "u", "id", "pp")} for t in range(3)])


def sweep_row(ns, v, dr, r: int, m: int, gate: bool, req: FusedRequest,
              spec, G: int, head_only: bool = False) -> list:
    """One row's 15 cls fields as a group of G threads computes them (G =
    `WIDE_THREADS`: the wide form, 16 warps merged in a second pass); with
    ``head_only`` its eligible slots among the first m and whether it
    passes the node id and the gate."""
    ng, nc, cpb = req.need_gpus, req.need_cgs, req.cgs_per_bundle
    alpha_pos = req.alpha > 0
    cap = v.shape[2]
    stored, prio = v[4, r] != 0, v[2, r].astype(np.int64)
    eb = sum(1 << s for s in range(cap) if stored[s] and prio[s] < req.thresh)
    valid = eb & ((1 << m) - 1)
    nid = int(ns[2, r])
    ok = nid < INT_MAX and (not gate or (
        bin(eb).count("1") <= m
        and not (ns[3, r] != 0 and ns[4, r] < req.thresh)))
    if head_only:
        return bin(valid).count("1"), ok
    none = dict(p=INT_MAX, u=INT_MIN, id=INT_MAX, pp=0)
    merged = dict(kmin=m + 1, cnt=0, best=[none] * 3)
    if ok:
        slots = [s for s in range(m) if (valid >> s) & 1]
        e = len(slots)
        rank_sh = 15 - v[3, r, slots].astype(np.int64)
        recs = dict(g=v[0, r, slots].astype(np.int64) & U32,
                    c=v[1, r, slots].astype(np.int64) & U32,
                    pr=prio[slots] & U32,
                    u=np.where((rank_sh >= 0) & (rank_sh < 32),
                               np.left_shift(1, np.clip(rank_sh, 0, 31)), 0),
                    id=np.left_shift(1, np.array(slots, np.int64)))
        recs["wg"], recs["wc"] = numa_words(recs["g"], recs["c"], spec)
        base = dict(g=int(ns[0, r]) & U32, c=int(ns[1, r]) & U32, pr=0, u=0,
                    id=0)
        base["wg"], base["wc"] = (int(x) for x in numa_words(
            base["g"], base["c"], spec))
        dg, dc = int(dr[0, r]) & U32, int(dr[1, r]) & U32
        lg = G.bit_length() - 1
        L = max(0, e - lg)
        H = e - L
        lo = np.arange(1 << L)
        table = folds(recs, lo, 0, L)
        for f in FIELDS:
            table[f] = table[f] | base[f] if f in ("g", "c", "id") \
                else table[f] + base[f]
        hi = folds(recs, np.arange(1 << H), L, H)
        # subsets [lanes 2^H, table 2^L]
        f = {x: (hi[x][:, None] | table[x][None, :]) if x in ("g", "c", "id")
             else hi[x][:, None] + table[x][None, :] for x in FIELDS}
        f["pr"] &= U32
        f["u"] &= U32
        # the words of a union are the sums of the words: the masks are
        # disjoint, so they equal the words of the OR'd masks
        wg, wc = numa_words(f["g"], f["c"], spec)
        assert np.array_equal(wg, f["wg"]) and np.array_equal(wc, f["wc"])
        # subset (lane, lo) is dense index (lane << L) | lo
        assert np.array_equal(f["id"].ravel(),
                              deposit(np.arange(1 << e), valid))
        tier = fused_tier(f["wg"], f["wc"], spec, ng, nc, cpb)
        k = popc(np.arange(1 << H))[:, None] + popc(lo)[None, :]
        part = lane_partials(k, tier, f, m, alpha_pos)
        # idle lanes hold the identity; a spare lane judges the drain
        idle = G - (1 << H)
        for key in ("kmin", "cnt"):
            part[key] = np.concatenate(
                [part[key], np.full(idle, m + 1 if key == "kmin" else 0)])
        for b in part["best"]:
            for key, fill in none.items():
                b[key] = np.concatenate([b[key], np.full(idle, fill)])
        dwg, dwc = numa_words(dg, dc, spec)
        drained = fused_tier(dwg, dwc, spec, ng, nc, cpb) < 3
        if drained:
            if G <= 32 and L == 0:
                merged = lane_merge(k[:, 0], tier[:, 0], f, e, m, alpha_pos, G)
            elif G <= 32:
                merged = group_merge(part, alpha_pos)
            else:       # the wide form: each warp, then the warps' values
                warps = [group_merge(
                    {"kmin": part["kmin"][w:w + 32],
                     "cnt": part["cnt"][w:w + 32],
                     "best": [{x: b[x][w:w + 32] for x in b}
                              for b in part["best"]]}, alpha_pos)
                    for w in range(0, G, 32)]
                pad = [dict(kmin=m + 1, cnt=0, best=[none] * 3)] * (
                    32 - len(warps))
                merged = group_merge(stack(warps + pad), alpha_pos)
    out = []
    for t in range(3):
        out.append(int(merged["best"][t]["id"] != INT_MAX))
    for field in ("id", "pp", "u"):
        for t in range(3):
            b = merged["best"][t]
            out.append(int(i32(b[field])) if b["id"] != INT_MAX else 0)
    out.append(int(merged["kmin"]))
    out.append(int(i32(merged["cnt"])))
    out.append(nid)
    return out


def model_sweep(ns, v, dr, m, gate, req, spec, G) -> np.ndarray:
    """The section's rows as the kernel sweeps them with groups of G: the
    wide form's CTA (G = `WIDE_THREADS`) a row; narrow, a warp of 32 / G
    consecutive rows whose groups each sweep their own row where every row
    of the warp has at most log2 G eligible slots (or is filtered by its
    node id or the gate), else the whole warp (32 threads) each row."""
    rows = ns.shape[1]
    groups = [G] * rows
    if G < 32:
        for w in range(0, rows, 32 // G):
            e_ok = []
            for r in range(w, min(rows, w + 32 // G)):
                head = sweep_row(ns, v, dr, r, m, gate, req, spec, 32,
                                 head_only=True)
                e_ok.append(not head[1] or head[0] <= G.bit_length() - 1)
            if not all(e_ok):
                groups[w:w + 32 // G] = [32] * (32 // G)
    return np.array([sweep_row(ns, v, dr, r, m, gate, req, spec, groups[r])
                     for r in range(rows)], np.int64).T.reshape(
                         CLS_FIELDS, rows)


# ---------------------------------------------------------------------------------
# States
# ---------------------------------------------------------------------------------

def random_state(spec, rows: int, max_victims: int, seed: int, cap: int = 16):
    """Resident rows as the allocator leaves them (each GPU and CoreGroup
    free, held by one stored victim or by a non-preemptible instance), with
    special rows: no eligible slot (priorities of 2000), a sentinel node id,
    a truncated row, all-equal priorities and uid ranks (ties), and one row
    holding max_victims victims."""
    rng = np.random.default_rng(seed)
    ns = np.zeros((5, rows), np.int64)
    v = np.zeros((5, rows, cap), np.int64)
    for r in range(rows):
        s = max_victims if r == 0 else int(rng.integers(0, max_victims + 1))
        own_g = rng.integers(-1, s + 1, spec.num_gpus)
        own_c = rng.integers(-1, s + 1, spec.num_coregroups)
        prio = np.sort(rng.choice([1, 2, 3, 200, 450, 900], s))
        ranks = rng.permutation(s)
        if r == 1:
            prio[:] = 2000                       # nothing eligible
        if r == 2 or r == 5:
            prio[:] = 3                          # ties on p_eff ...
            ranks[:] = 0                         # ... and on the uid mask
        for j in range(s):
            v[0, r, j] = sum(1 << i for i in np.nonzero(own_g == j + 1)[0])
            v[1, r, j] = sum(1 << i for i in np.nonzero(own_c == j + 1)[0])
            v[2, r, j] = prio[j]
            v[3, r, j] = ranks[j]
            v[4, r, j] = 1
        ns[0, r] = sum(1 << i for i in np.nonzero(own_g == 0)[0])
        ns[1, r] = sum(1 << i for i in np.nonzero(own_c == 0)[0])
        ns[2, r] = IDX_SENTINEL if r == 3 or rng.random() < 0.05 else r
        truncated = r == 4 or rng.random() < 0.1
        ns[3, r] = int(truncated)
        ns[4, r] = int(rng.integers(0, 1600)) if truncated else INT_MAX
    dr = np.stack([ns[0] | np.bitwise_or.reduce(v[0], axis=1),
                   ns[1] | np.bitwise_or.reduce(v[1], axis=1)])
    check_disjoint(ns, v)
    return [x.astype(np.int32) for x in (ns, v, dr)]


def check_disjoint(ns, v) -> None:
    """One node's free mask and stored victims' masks are pairwise
    disjoint: the counts of a union add only then (and the reference's sum
    equals the port's OR only then)."""
    for field in (0, 1):
        masks = np.concatenate([ns[field][:, None],
                                v[field] * (v[4] != 0)], axis=1) & U32
        total = masks.sum(axis=1)
        orred = np.bitwise_or.reduce(masks, axis=1)
        assert np.array_equal(total, orred), field


@functools.lru_cache(maxsize=None)
def ref_class_core(spec_name: str, m: int, gate: bool):
    return jax.jit(functools.partial(_fused_class_core,
                                     spec=REF_SPECS[spec_name], m=m,
                                     narrow_gate=gate))


def requests(spec):
    """(thresh, ng, nc, cpb): a bundled ask, an unbundled one, one no row
    can meet, and a zero-need one."""
    cg_per_gpu = spec.num_coregroups // spec.num_gpus
    return [(1000, 2, 2 * cg_per_gpu, cg_per_gpu), (500, 1, 3, 0),
            (1000, spec.num_gpus + 1, 1, 0), (300, 0, 0, 0)]


def geometries(m: int) -> list:
    """Every group the launcher takes at width m: 8, 16 and 32 where m
    fits, and the wide form's CTA of 512."""
    return [g for g, top in NARROW_MAX_M.items() if m <= top] + [WIDE_THREADS]


@pytest.mark.parametrize("alpha", [0.0, 0.5])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8, 16])
@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_sweep_model_matches_plain_and_reference(spec_name, m, alpha):
    spec = SPECS[spec_name]
    rows = 6 if m == 16 else 10
    ns, v, dr = random_state(spec, rows, min(m + 1, 16),
                             seed=1000 * m + 10 * len(spec_name)
                             + int(alpha * 2))
    t = torch.from_numpy
    # the gathered section: resident rows by index, an out-of-range index
    # (a zero row with that node id) and sentinel pads
    gidx = np.array([rows - 1, 0, 2, -1, rows + 3, IDX_SENTINEL], np.int32)
    empty = torch.zeros(0, dtype=torch.int32)
    sections = [(ns, v, dr, True)]
    gns, gv, gdr = plan_rows(t(ns), t(v), t(dr), empty,
                             torch.zeros((0, 87), dtype=torch.int32),
                             t(gidx), resident=False)
    sections.append((gns.numpy(), gv.numpy(), gdr.numpy(), False))
    for thresh, ng, nc, cpb in requests(spec):
        req = FusedRequest(thresh, ng, nc, cpb, alpha)
        for s_ns, s_v, s_dr, gate in sections:
            want = class_sweep_plain(t(s_ns), t(s_v), t(s_dr), m=m,
                                     gate=gate, req=req, spec=spec).numpy()
            ref = ref_class_core(spec_name, m, gate)(
                jnp.asarray(s_ns), jnp.asarray(s_v), jnp.asarray(s_dr),
                jnp.int32(thresh), jnp.int32(ng), jnp.int32(nc),
                jnp.int32(cpb), jnp.float32(alpha))
            ref_cls = np.concatenate([
                np.asarray(ref.anyc).T.astype(np.int32), np.asarray(ref.cb).T,
                np.asarray(ref.pp).T, np.asarray(ref.um).T,
                np.asarray(ref.k_node)[None], np.asarray(ref.cnt)[None],
                s_ns[2][None]])
            assert np.array_equal(want, ref_cls), (thresh, gate)
            for G in geometries(m):
                got = model_sweep(s_ns, s_v, s_dr, m, gate, req, spec, G)
                assert np.array_equal(got, want), (G, thresh, ng, nc, cpb,
                                                   gate)


def test_deposit_walks_the_eligible_subsets_in_id_order():
    """The dense index's deposit is a bijection onto the subsets of valid
    and keeps their order, so the lowest dense index is the lowest id."""
    rng = np.random.default_rng(3)
    for _ in range(40):
        valid = int(rng.integers(0, 1 << 16))
        e = bin(valid).count("1")
        ids = deposit(np.arange(1 << e), valid)
        assert (np.diff(ids) > 0).all() and len(ids) == 1 << e
        assert not (ids & ~valid).any()


@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_packed_counts_give_the_reference_tier(spec_name):
    """numa_words + fused_tier (bundle division by multiply) against the
    lane kernels' tier_score rule (``_tier_score_plain``) on random masks,
    every request size and bundle 0..3."""
    spec = SPECS[spec_name]
    rng = np.random.default_rng(len(spec_name))
    g = rng.integers(0, spec.all_gpu_mask + 1, 400).astype(np.int32)
    c = rng.integers(0, spec.all_cg_mask + 1, 400).astype(np.int32)
    wg, wc = numa_words(g, c, spec)
    for ng in range(spec.num_gpus + 2):
        for nc in (0, 1, 3, spec.num_coregroups):
            for cpb in range(4):
                req = ts.TopoRequest(ng, nc, cpb)
                want, _ = ts._tier_score_plain(
                    torch.from_numpy(g), torch.from_numpy(c),
                    torch.zeros(400, dtype=torch.int32), spec, req)
                got = fused_tier(wg, wc, spec, ng, nc, cpb)
                assert np.array_equal(got, want.numpy()), (ng, nc, cpb)


# ---------------------------------------------------------------------------------
# The lane form's argmax
# ---------------------------------------------------------------------------------

def ordered(x: np.ndarray) -> np.ndarray:
    """The kernels' ordered(): a float32's order as a signed int32."""
    i = (np.asarray(x, np.float32) + np.float32(0)).view(np.int32).astype(
        np.int64)
    return i ^ ((i >> 31) & 0x7FFFFFFF)


def lane_score(tier, prio, alpha: float) -> np.ndarray:
    a, b = np.float32(alpha), np.float32(1.0 - alpha)
    tv = np.array([1.0, 0.5, 0.1, 0.0], np.float32)[tier]
    with np.errstate(divide="ignore"):
        pt = np.where(prio > 0, np.float32(1) / np.maximum(prio, 1).astype(
            np.float32), np.float32(1)).astype(np.float32)
    s = (a * pt).astype(np.float32) + (b * tv).astype(np.float32)
    return np.where(tier < 3, s, np.float32(-np.inf)).astype(np.float32)


NEG_INF = int(ordered(np.float32(-np.inf)))


def warp_min_lane(cand, k, tier, score, idx):
    """warp_min_lane: one reduction a field over the candidates."""
    big = int(ts.K_INFEASIBLE)
    bk = np.where(cand, k, big).min()
    cand = cand & (k == bk)
    bt = np.where(cand, tier, 3).min()
    cand = cand & (tier == bt)
    bs = np.where(cand, score, NEG_INF).max()
    cand = cand & (score == bs)
    return bk, bt, bs, np.where(cand, idx, big).min()


def model_argmax(g, c, pr, k, ok, spec, req):
    """topo_score_argmax_kernel: per lane tier and score, per tile the
    winner of each warp and then of the warps."""
    n = g.shape[0]
    big = int(ts.K_INFEASIBLE)
    wg, wc = numa_words(g, c, spec)
    tier = fused_tier(wg, wc, spec, req.need_gpus, req.need_cgs,
                      req.cgs_per_bundle)
    score = lane_score(tier, pr, req.alpha)
    tier = np.where(ok != 0, tier, 3)
    score = np.where(ok != 0, score, np.float32(-np.inf)).astype(np.float32)
    threads = ts.TILE if n >= ts.TILE else -(-n // 32) * 32
    out = []
    for tile in range(-(-n // ts.TILE)):
        lo = tile * ts.TILE
        idx = np.arange(threads)
        inn = lo + idx < n
        sl = np.minimum(lo + idx, n - 1)
        lk = np.where(inn, k[sl], big)
        lt = np.where(inn, tier[sl], 3)
        ls = ordered(np.where(inn, score[sl], np.float32(-np.inf)))
        cand = (lt < 3) & (lk <= big)
        warps = [warp_min_lane(cand[w:w + 32], lk[w:w + 32], lt[w:w + 32],
                               ls[w:w + 32], idx[w:w + 32])
                 for w in range(0, threads, 32)]
        if len(warps) > 1:
            wk, wt, ws, wi = (np.array(x) for x in zip(*warps))
            pad = 32 - len(warps)
            wt_c = np.concatenate([wt, np.full(pad, 3)])
            best = warp_min_lane(
                wt_c < 3, np.concatenate([wk, np.full(pad, big)]), wt_c,
                np.concatenate([ws, np.full(pad, NEG_INF)]),
                np.concatenate([wi, np.full(pad, big)]))
        else:
            best = warps[0]
        out.append(best)
    bk, bt, bs, bi = (np.array(x, np.int64) for x in zip(*out))
    bscore = (bs ^ ((bs >> 31) & 0x7FFFFFFF)).astype(np.int32).view(
        np.float32)
    return (tier, score, bk, bt, bscore,
            np.arange(len(out)) * ts.TILE + bi)


@pytest.mark.parametrize("n", [1, 31, 256, 1500])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_lane_argmax_model_matches_plain(n, alpha):
    spec = SPECS["rtx4090"]
    rng = np.random.default_rng(n + int(10 * alpha))
    for case in range(4):
        g = rng.integers(0, spec.all_gpu_mask + 1, n).astype(np.int32)
        c = rng.integers(0, spec.all_cg_mask + 1, n).astype(np.int32)
        pr = rng.choice([0, 1, 2, 4, 300], n).astype(np.int32)
        k = rng.integers(0, 4, n).astype(np.int32)
        k[::13] = ts.K_INFEASIBLE
        ok = (rng.random(n) < 0.8).astype(np.int32)
        if case == 1:                  # duplicate keys: ties to the index
            g[:] = g[0]
            c[:] = c[0]
            pr[:] = pr[0]
            k[:] = 1
        if case == 2:                  # an all-infeasible tile
            ok[:min(n, ts.TILE)] = 0
        req = ts.TopoRequest(2, 2, case % 3, alpha)
        want = ts.topo_score_argmax_plain(*(torch.from_numpy(x) for x in (
            g, c, pr, k)), spec, req, ok=torch.from_numpy(ok))
        got = model_argmax(g, c, pr, k, ok, spec, req)
        for i, (a, b) in enumerate(zip(got, want)):
            b = b.numpy()
            if b.dtype == np.float32:
                assert np.array_equal(np.asarray(a, np.float32).view(np.int32),
                                      b.view(np.int32)), (case, i)
            else:
                assert np.array_equal(np.asarray(a, np.int64), b), (case, i)


# ---------------------------------------------------------------------------------
# The launch geometry
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("sms", [1, 114, 132])
def test_sweep_geometry_is_one_the_launcher_takes(sms):
    """Every geometry the wrapper chooses: whole warps up to SWEEP_THREADS
    with a narrow group of 16 or 32 that fits the section's width (a
    warp a row up to SWEEP_WARP_ROWS rows a SM), or
    the wide CTA above NARROW_KERNEL_M; a plan takes at least as many CTAs
    as it has warps of work, up to the SMs."""
    for m_res in range(0, 17):
        for m_gather in (8, 16):
            for rows in (1, 13, 100, 1024, 10240, 40960):
                for res, gat in ((rows, 0), (rows, 13), (0, rows)):
                    threads, g_res, g_gat = sweep_geometry(
                        m_res, res, m_gather, gat, sms)
                    top = max(m_res if res else 0, m_gather if gat else 0)
                    if top > NARROW_KERNEL_M:
                        assert threads == g_res == g_gat == WIDE_THREADS
                        continue
                    assert 32 <= threads <= SWEEP_THREADS
                    assert threads % 32 == 0
                    one = res + gat <= SWEEP_WARP_ROWS * sms
                    assert g_res == g_gat == (32 if one else SHARED_GROUP)
                    for g, m, n in ((g_res, m_res, res), (g_gat, m_gather,
                                                          gat)):
                        assert n == 0 or m <= NARROW_MAX_M[g]
                    if gat == 0:
                        ctas = -(-res // (threads // g_res))
                        assert ctas >= min(-(-res * g_res // 32), sms)
