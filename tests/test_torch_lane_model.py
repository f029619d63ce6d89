"""A numpy model of K2's and K3's lane forms, as the CUDA kernels
``placement_tier_kernel`` and ``topo_score_kernel`` in ``csrc/topo_score.cu``
compute them, checked on the CPU.

* The launch (``lane_geometry``) and each thread's loops: one lane a thread
  while one grid of ``kLaneBlocksPerSm`` blocks an SM covers n, else that
  grid striding over the lanes, four a step as 16-byte vectors where the
  tensors are aligned and the last n % 4 one a thread.  Every lane of ragged
  n is read and written exactly once and no lane past n is touched.
* A lane's tier: its per-NUMA counts packed a byte a NUMA node in two 32-bit
  halves (``numa_words``), the request's constants (``tier_rule``, with the
  bundle multiplier read from the source's ``kBundleMagic`` table) and the
  word-wise rule (``fused_tier``: bundle units by a multiply in 16-bit
  lanes, byte-wise compares, socket sums by one 64-bit multiply, node sums
  by byte dot products), every test taken and the tier selected.
* K3's score: the Eq. 1 score with one rounding an operation (``lane_score``).

The model is held bit for bit (tiers equal, scores equal as f32 bits) to
``topo_score_plain``/``placement_tier_plain`` and to the reference's
``topo_score_pallas``/``placement_tier_pallas`` in interpret mode on the
three SKUs, with ``cgs_per_bundle`` 0, 1, 3, one above every count a NUMA
node holds, and 33 (above every count of a 32-bit mask), and a need above
32.  The source test checks that the reference's rule written out
(``tier_score``) is built only as the yardstick, ``FUSED_TIER_BY_TIER_SCORE``.
"""
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core.topology import SPECS as REF_SPECS  # noqa: E402
from repro.kernels import topo_score as ref_ts  # noqa: E402
from repro_torch.core.topology import SPECS  # noqa: E402
from repro_torch.kernels import topo_score as ts  # noqa: E402

_CU = (pathlib.Path(ts.__file__).parent / "csrc" / "topo_score.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _CU).group(1))


LANE_THREADS = _const("kLaneThreads")
LANE_BLOCKS_PER_SM = _const("kLaneBlocksPerSm")
MAGIC = [int(x, 16) for x in re.findall(r"0x[0-9a-f]+", re.search(
    r"kBundleMagic\[33\] = \{(.*?)\};", _CU, re.S).group(1))]
U32 = 0xFFFFFFFF
HIGH = 0x80808080
ONES = 0x0101010101010101
#: a tier or score slot no lane has written
UNWRITTEN = -7


# ---------------------------------------------------------------------------------
# The launch and each thread's lanes
# ---------------------------------------------------------------------------------

def lane_geometry(n: int, vec: bool, sms: int):
    """(blocks, threads, vectors) as the launcher chooses them."""
    most = LANE_BLOCKS_PER_SM * max(sms, 1)
    blocks = -(-n // LANE_THREADS)
    if blocks <= most:
        threads = LANE_THREADS if n >= LANE_THREADS else -(-n // 32) * 32
        return blocks, threads, False
    if not vec:
        return most, LANE_THREADS, False
    return min(-(-(n // 4) // LANE_THREADS), most), LANE_THREADS, True


def thread_lanes(n: int, vec: bool, sms: int):
    """The lanes the launch's threads take, step by step: (vector steps, as
    the first lane of each 4, and single lanes)."""
    blocks, threads, vectors = lane_geometry(n, vec, sms)
    t = np.arange(blocks * threads, dtype=np.int64)
    stride = blocks * threads
    quads, singles = [], []
    i = t
    if vectors:
        v = t
        while (v < n >> 2).any():
            quads.append(4 * v[v < n >> 2])
            v = v + stride
        i = t + (n & ~3)
    while (i < n).any():
        singles.append(i[i < n])
        i = i + stride
    cat = (lambda xs: np.concatenate(xs) if xs else np.zeros(0, np.int64))
    return cat(quads), cat(singles)


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("n", [1, 31, 255, 1023, 1025, 1500, 2051,
                               LANE_BLOCKS_PER_SM * 132 * LANE_THREADS + 1,
                               10240 * 2**8])
def test_lane_geometry_takes_every_lane_once(n, sms, vec):
    """Every lane in [0, n) exactly once and none past n; whole warps, at
    most one warp idle below one block, at most kLaneBlocksPerSm blocks an
    SM, one lane a thread wherever one grid covers n, and vectors only
    where the tensors are aligned."""
    blocks, threads, vectors = lane_geometry(n, vec, sms)
    assert threads % 32 == 0 and 32 <= threads <= LANE_THREADS
    assert threads - n < 32 or threads == LANE_THREADS
    assert blocks <= LANE_BLOCKS_PER_SM * sms
    one_grid = -(-n // LANE_THREADS) <= LANE_BLOCKS_PER_SM * sms
    assert vectors == (vec and not one_grid)
    quads, singles = thread_lanes(n, vec, sms)
    if one_grid:
        assert len(quads) == 0 and np.array_equal(np.sort(singles),
                                                   np.arange(n))
    lanes = np.concatenate([quads[:, None] + np.arange(4),
                            singles[:, None]], axis=None) if len(quads) \
        else singles
    assert np.array_equal(np.bincount(lanes, minlength=n), np.ones(n))


# ---------------------------------------------------------------------------------
# A lane's tier and score
# ---------------------------------------------------------------------------------

def popc(x):
    """Set bits of each 32-bit pattern."""
    x = np.asarray(x, np.int64) & U32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & U32) >> 24


def numa_words(g, c, p):
    """numa_words: per-NUMA counts, a byte a NUMA node, as (low, high) 32-bit
    halves (NUMA nodes 0-3 and 4-7); the masks past num_numa are 0."""
    hg, hc = [np.zeros(len(g), np.int64) for _ in range(2)], \
        [np.zeros(len(g), np.int64) for _ in range(2)]
    for u in range(8):
        shift = 8 * (u & 3)
        hg[u >> 2] |= popc(g & (p.numa_gpu[u] & U32)) << shift
        hc[u >> 2] |= popc(c & (p.numa_cg[u] & U32)) << shift
    return hg, hc


def tier_rule(p):
    """tier_rule(p, bundle_magic(p.cgs_per_bundle)) as Python integers."""
    d = p.cgs_per_bundle
    magic = MAGIC[d] if 0 < d <= 32 else 0
    k = max(1, sum(u < p.num_numa and p.socket_of_numa[u] == 0
                   for u in range(8)))
    return dict(
        numa=sum(0x80 << 8 * u for u in range(8) if u < p.num_numa),
        spread=sum(1 << 8 * u for u in range(k)),
        sock_end=sum(0x80 << 8 * ((s + 1) * k - 1) for s in range(8)
                     if s < p.num_sockets and (s + 1) * k - 1 < 8),
        need_g=(max(p.need_gpus, 0) & 127) * ONES,
        need_c=(max(p.need_cgs, 0) & 127) * ONES,
        m16=(magic + (1 << 22) - 1) >> 22, ng=p.need_gpus, nc=p.need_cgs,
        bundle=d > 0, never=p.need_gpus > 32 or p.need_cgs > 32)


def bytes_ge(x, n):
    """0x80 in each byte of the 32-bit x that is >= that byte of n."""
    return ((x | HIGH) - n) & HIGH


def bundle_bytes(g, c, m16: int):
    """Per byte min(g, c // cgs_per_bundle), the division (c * m16) >> 10
    in 16-bit lanes."""
    q = (((((c & 0x00FF00FF) * m16) & U32) >> 10) & 0x003F003F) | \
        ((((((c >> 8) & 0x00FF00FF) * m16) & U32) >> 10) & 0x003F003F) << 8
    keep = (bytes_ge(g, q) >> 7) * 0xFF
    return (q & keep) | (g & ~keep & U32)


def byte_sum(h):
    """Two byte dot products: the sum of the eight bytes of (low, high)."""
    return sum((x >> (8 * b)) & 0xFF for x in h for b in range(4))


def fused_tier(hg, hc, r):
    """fused_tier on the halves: bundle units, then one NUMA node, one
    socket or the node, every test taken and the tier selected."""
    hu = hg
    if r["bundle"]:
        hu = [bundle_bytes(hg[j], hc[j], r["m16"]) for j in range(2)]

    def half(x, j):
        return (x >> (32 * j)) & U32

    numa_ok = np.zeros(len(hg[0]), bool)
    for j in range(2):
        numa_ok |= (bytes_ge(hu[j], half(r["need_g"], j))
                    & bytes_ge(hc[j], half(r["need_c"], j))
                    & half(r["numa"], j)) != 0
    with np.errstate(over="ignore"):           # the 64-bit products wrap
        su, sc = (((h[1].astype(np.uint64) << np.uint64(32))
                   | h[0].astype(np.uint64)) * np.uint64(r["spread"])
                  for h in (hu, hc))
    sock_ok = np.zeros(len(hg[0]), bool)
    for j in range(2):
        su_j, sc_j = ((x >> np.uint64(32 * j)).astype(np.int64) & U32
                      for x in (su, sc))
        sock_ok |= (bytes_ge(su_j, half(r["need_g"], j))
                    & bytes_ge(sc_j, half(r["need_c"], j))
                    & half(r["sock_end"], j)) != 0
    node_ok = (byte_sum(hu) >= r["ng"]) & (byte_sum(hc) >= r["nc"])
    tier = np.where(numa_ok, 0, np.where(sock_ok, 1, np.where(node_ok, 2, 3)))
    return np.full_like(tier, 3) if r["never"] else tier


def lane_score(tier, prio, alpha: float):
    """Eq. 1 in f32, one rounding an operation; -inf at tier 3."""
    a, b = np.float32(alpha), np.float32(1.0 - alpha)
    tv = np.array([1.0, 0.5, 0.1, 0.0], np.float32)[tier]
    with np.errstate(divide="ignore"):
        pt = np.where(prio > 0, np.float32(1) / np.maximum(prio, 1).astype(
            np.float32), np.float32(1)).astype(np.float32)
    s = (a * pt).astype(np.float32) + (b * tv).astype(np.float32)
    return np.where(tier < 3, s, np.float32(-np.inf)).astype(np.float32)


def model_kernel(g, c, prio, spec, req, vec: bool, sms: int):
    """The kernels' outputs lane by lane as the launch's threads write
    them: (tier int32[n], K3's score f32[n]); every lane written once."""
    n = len(g)
    p = ts._params(spec, req)
    r = tier_rule(p)
    tier = np.full(n, UNWRITTEN, np.int64)
    score = np.full(n, np.float32(UNWRITTEN), np.float32)
    quads, singles = thread_lanes(n, vec, sms)
    lanes = np.concatenate([quads[:, None] + np.arange(4), singles[:, None]],
                           axis=None) if len(quads) else singles
    assert lanes.max(initial=-1) < n            # nothing read past n
    hg, hc = numa_words(g[lanes].astype(np.int64) & U32,
                        c[lanes].astype(np.int64) & U32, p)
    got = fused_tier(hg, hc, r)
    assert (tier[lanes] == UNWRITTEN).all()     # each lane once
    tier[lanes] = got
    score[lanes] = lane_score(got, prio[lanes], req.alpha)
    assert (tier != UNWRITTEN).all()
    return tier.astype(np.int32), score


# ---------------------------------------------------------------------------------
# Against the plain versions and the reference
# ---------------------------------------------------------------------------------

SIZES = [1, 31, 255, 1023, 1025, 1500, 2051]
#: (need_gpus, need_cgs) for each bundle size; (33, 1) needs more than a
#: 32-bit mask holds
NEEDS = [(1, 1), (2, 4), (0, 0)]


def _bundles(spec):
    """cgs_per_bundle 0, 1, 3, one above every count a NUMA node holds, and
    33 (above every count of a 32-bit mask)."""
    return [0, 1, 3, spec.coregroups_per_numa + 1, 33]


def _cases():
    out = []
    for name in sorted(SPECS):
        for cpb in _bundles(SPECS[name]):
            for ng, nc in NEEDS:
                out.append((name, ng, nc, cpb))
        out.append((name, 33, 1, 1))
    return out


def _lanes(spec, n: int, seed: int):
    """Seeded lanes: masks of the SKU with zero masks and priorities, large
    priority sums, and a quarter of the lanes any 32-bit pattern."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, spec.all_gpu_mask + 1, n).astype(np.int32)
    c = rng.integers(0, spec.all_cg_mask + 1, n).astype(np.int32)
    wide = rng.random(n) < 0.25
    g[wide] = rng.integers(-2**31, 2**31, wide.sum()).astype(np.int32)
    c[wide] = rng.integers(-2**31, 2**31, wide.sum()).astype(np.int32)
    g[::17] = 0
    c[::19] = 0
    p = rng.integers(0, 3000 * 16, n).astype(np.int32)
    p[::7] = 0
    p[::29] = 2**31 - 1
    return g, c, p


@pytest.mark.parametrize("spec_name, ng, nc, cpb", _cases(), ids=str)
def test_lane_model_matches_plain_and_reference(spec_name, ng, nc, cpb):
    """The model at ragged n, one lane a thread and (on a one-SM grid) four
    lanes a step with the aligned flag on and off, against the plain
    versions and the reference's interpreted Pallas kernels, bit for bit."""
    spec, ref_spec = SPECS[spec_name], REF_SPECS[spec_name]
    i = _cases().index((spec_name, ng, nc, cpb))
    alpha = (0.0, 0.3, 0.5, 1.0)[i % 4]
    g, c, p = _lanes(spec, max(SIZES), seed=i)
    req = ts.TopoRequest(ng, nc, cpb, alpha=alpha)
    ref_req = ref_ts.TopoRequest(ng, nc, cpb, alpha=alpha)
    ref_tier, ref_score = (np.asarray(x) for x in ref_ts.topo_score_pallas(
        jnp.asarray(g), jnp.asarray(c), jnp.asarray(p), ref_spec, ref_req,
        interpret=True))
    ref_place = np.asarray(ref_ts.placement_tier_pallas(
        jnp.asarray(g), jnp.asarray(c), ref_spec, ref_req, interpret=True))
    tg, tc, tp = (torch.from_numpy(x) for x in (g, c, p))
    plain_tier, plain_score = (x.numpy() for x in ts.topo_score_plain(
        tg, tc, tp, spec, req))
    plain_place = ts.placement_tier_plain(tg, tc, spec, req).numpy()
    assert np.array_equal(ref_tier, plain_tier)
    assert np.array_equal(ref_place, plain_place)
    assert np.array_equal(ref_score.view(np.int32), plain_score.view(np.int32))
    for n in SIZES:
        for vec, sms in ((True, 132), (True, 1), (False, 1)):
            tier, score = model_kernel(g[:n], c[:n], p[:n], spec, req, vec,
                                       sms)
            what = (n, vec, sms)
            assert np.array_equal(tier, plain_tier[:n]), what
            assert np.array_equal(tier, plain_place[:n]), what
            assert np.array_equal(score.view(np.int32),
                                  plain_score[:n].view(np.int32)), what


def test_bundle_bytes_divide_by_the_table():
    """bundle_bytes with the source's kBundleMagic table: min(g, c // d) in
    every byte position, for every pair of counts 0..32 and every d in
    0..33 (0: no bundle, taken by the caller; above 32 the multiplier 0)."""
    g, c = np.meshgrid(np.arange(33), np.arange(33))
    g, c = g.ravel().astype(np.int64), c.ravel().astype(np.int64)
    rng = np.random.default_rng(5)
    for d in range(1, 34):
        m16 = ((MAGIC[d] if d <= 32 else 0) + (1 << 22) - 1) >> 22
        for b in range(4):
            # the pair in byte b, random counts in the other bytes
            fill_g = rng.integers(0, 33, (len(g), 4))
            fill_c = rng.integers(0, 33, (len(g), 4))
            fill_g[:, b], fill_c[:, b] = g, c
            wg = sum(fill_g[:, j] << (8 * j) for j in range(4))
            wc = sum(fill_c[:, j] << (8 * j) for j in range(4))
            got = bundle_bytes(wg, wc, m16)
            want = sum(np.minimum(fill_g[:, j], fill_c[:, j] // d) << (8 * j)
                       for j in range(4))
            assert np.array_equal(got, want), (d, b)


# ---------------------------------------------------------------------------------
# The source
# ---------------------------------------------------------------------------------

def _yardstick_lines():
    """Per line of the source, whether it is compiled only where
    FUSED_TIER_BY_TIER_SCORE is defined."""
    stack, out = [], []
    for line in _CU.splitlines():
        word = line.strip().split()
        head = word[0] if word else ""
        if head in ("#if", "#ifdef", "#ifndef"):
            stack.append(head == "#ifdef" and word[1] ==
                         "FUSED_TIER_BY_TIER_SCORE")
        elif head == "#else":
            stack[-1] = False
        elif head == "#endif":
            stack.pop()
        out.append(any(stack))
    assert not stack
    return out


def test_tier_score_is_built_only_as_the_yardstick():
    """The reference's rule written out (tier_score, and tier_of around it)
    appears in code only where FUSED_TIER_BY_TIER_SCORE is defined, so the
    default build holds no copy; the lane kernels take lane_tier."""
    only = _yardstick_lines()
    code = [line.split("//")[0] for line in _CU.splitlines()]
    uses = [k for k, line in enumerate(code)
            if re.search(r"\b(tier_score|tier_of)\s*\(", line)]
    assert uses, "tier_score is gone from the source"
    assert any(re.search(r"void tier_score\(", code[k]) for k in uses)
    assert all(only[k] for k in uses), [code[k] for k in uses if not only[k]]
    for kernel in ("topo_score_kernel", "placement_tier_kernel"):
        body = re.search(rf"{kernel}\(.*?\n}}\n", _CU, re.S).group(0)
        assert "lane_tier" in body and "tier_score" not in body, kernel
