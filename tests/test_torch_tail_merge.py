"""What surrounds K1's tail and K2's normal-cycle form, checked on the CPU.

* A Python model of the tail kernel's one-pass state (``TailState`` in
  ``csrc/topo_score.cu``): each (row, tier) entry folded once into the max
  score, the lowest and highest tier at it, the count (an int32 sum that
  wraps), and two tie keys (priority sum / zero in the key's first field),
  the same-tier test picking one at the end.  Held against
  ``fused_argmax_plain`` on random class tables with forced exact ties, for
  the rows cut into 1, 2, 3, 8 and 16 blocks (R not a multiple of the
  block count), each block folded alone and the blocks merged in a shuffled
  tree: no partition and no merge order may change the winner.
* The launch geometries that the wrappers hand the two kernels (K2's
  ``normal_geometry``, one cluster or split, and the tail's
  ``cluster_geometry``), with the row loops of the kernels written out:
  every row of 0..70000 (sampled) taken exactly once, in clusters of at
  most 8 and 16 CTAs.
* The wrappers' mirrors of the kernel source's constants agree with it,
  and the kernels' bundle division by multiply (``bundle_magic``, a
  constant table) is exact.
"""
import pathlib
import random
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.topology import RTX4090_SERVER  # noqa: E402
from repro_torch.kernels import fused_class as fc  # noqa: E402
from repro_torch.kernels import normal_cycle as nck  # noqa: E402
from repro_torch.kernels.fused_class import (CLS_FIELDS,  # noqa: E402
                                             CLUSTER_CTAS, NORMAL_THREADS,
                                             TAIL_THREADS, FusedRequest,
                                             cluster_geometry,
                                             fused_argmax_plain)

INT_MAX = 2**31 - 1
IDENTITY_TIE = (INT_MAX, INT_MAX, INT_MAX, -1, INT_MAX)


def _tie_key(k):
    """(ppe asc, k asc, node id asc, uid mask desc, flat asc) as a sortable
    tuple."""
    ppe, kk, nid, um, flat = k
    return (ppe, kk, nid, -um, flat)


def _score(pp: int, t: int, alpha: float) -> np.float32:
    """Eq. 1 in f32 with one rounding an operation (eq1_score)."""
    a, b = np.float32(alpha), np.float32(1.0 - alpha)
    prio = (np.float32(1.0) / np.float32(max(pp, 1)) if pp > 0
            else np.float32(1.0))
    tv = (np.float32(1.0), np.float32(0.5), np.float32(0.1))[t]
    return np.float32(np.float32(a * prio) + np.float32(b * tv))


def identity():
    return [np.float32(-np.inf), 3, -1, 0, IDENTITY_TIE, IDENTITY_TIE]


def merge(x, y):
    """merge_tail: the max score, its tiers, the count, the two tie keys."""
    if y[0] > x[0]:
        out = list(y)
    elif y[0] == x[0]:
        out = [x[0], min(x[1], y[1]), max(x[2], y[2]), 0,
               min(x[4], y[4], key=_tie_key), min(x[5], y[5], key=_tie_key)]
    else:
        out = list(x)
    out[3] = (x[3] + y[3]) & 0xFFFFFFFF
    return out


def fold_block(cls: np.ndarray, lo: int, hi: int, alpha: float):
    st = identity()
    for r in range(lo, hi):
        st = merge(st, [np.float32(-np.inf), 3, -1, int(cls[13, r]) &
                        0xFFFFFFFF, IDENTITY_TIE, IDENTITY_TIE])
        for t in range(3):
            if not cls[t, r]:
                continue
            pp, k, nid, um = (int(cls[6 + t, r]), int(cls[12, r]),
                              int(cls[14, r]), int(cls[9 + t, r]))
            st = merge(st, [_score(pp, t, alpha), t, t, 0,
                            (pp, k, nid, um, 3 * r + t),
                            (0, k, nid, um, 3 * r + t)])
    return st


def finish(st, cls: np.ndarray, alpha: float):
    """The tail's first seven outputs from the merged state."""
    found = st[0] > -np.inf
    tk = st[4] if (st[1] == st[2] and alpha > 0) else st[5]
    flat = tk[4] if found else 0
    row, t = divmod(flat, 3)
    cnt = st[3] - (1 << 32) if st[3] >= 1 << 31 else st[3]
    return [int(found), row, t, int(cls[3 + t, row]), int(cls[6 + t, row]),
            int(cls[12, row]), cnt]


def tie_table(rows: int, seed: int) -> np.ndarray:
    """Class winners that tie exactly: priority sums from {0, 1, 2, 4}
    (tier 0 with 2 and tier 1 with 1 both score 0.75 at alpha 0.5), small
    sets of k, node ids and uid masks, counts that overflow int32."""
    rng = np.random.default_rng(seed)
    cls = np.zeros((CLS_FIELDS, rows), np.int32)
    cls[0:3] = rng.random((3, rows)) < 0.5
    cls[3:6] = rng.integers(0, 256, (3, rows))
    cls[6:9] = rng.choice(np.array([0, 1, 2, 4]), (3, rows))
    cls[9:12] = rng.choice(np.array([1, 2, 1 << 15]), (3, rows))
    cls[12] = rng.integers(1, 3, rows)
    cls[13] = rng.integers(0, INT_MAX, rows)
    cls[14] = rng.integers(0, 4, rows)
    return cls


@pytest.mark.parametrize("alpha", [0.0, 0.3, 0.5, 1.0])
@pytest.mark.parametrize("rows", [1, 7, 37, 101])
def test_one_pass_monoid_matches_the_plain_tail(alpha, rows):
    req = FusedRequest(1000, 1, 1, 1, alpha)
    empty = torch.zeros(0, dtype=torch.int32)
    ns = torch.zeros((5, rows), dtype=torch.int32)
    v = torch.zeros((5, rows, 16), dtype=torch.int32)
    rng = random.Random(rows * 10 + int(alpha * 10))
    for seed in range(3):
        cls = tie_table(rows, 1000 * seed + rows)
        want = fused_argmax_plain(
            torch.from_numpy(cls), ns, v, empty,
            torch.zeros((0, 87), dtype=torch.int32), empty, resident=True,
            seg=rows, req=req, spec=RTX4090_SERVER)[0, :7].tolist()
        for blocks in (1, 2, 3, 8, 16):
            cuts = np.linspace(0, rows, blocks + 1).astype(int)
            parts = [fold_block(cls, lo, hi, alpha)
                     for lo, hi in zip(cuts[:-1], cuts[1:])]
            while len(parts) > 1:            # a random merge tree
                i = rng.randrange(len(parts) - 1)
                parts[i:i + 2] = [merge(parts[i], parts[i + 1])]
            assert finish(parts[0], cls, alpha) == want, (seed, blocks)


def _rows_k2(n: int, clusters: int, ctas: int, threads: int) -> np.ndarray:
    """The rows normal_cycle_kernel's threads take: block, thread, iters
    batches of kNormalBatch (4) rows, stride blocks * threads."""
    stride = clusters * ctas * threads
    iters = max(1, -(-n // (4 * stride)))
    first = np.arange(stride)                       # block * threads + thread
    m = np.arange(4 * iters)                        # (it * 4 + j)
    r = (first[:, None] + m[None, :] * stride).ravel()
    return r[r < n]


def _rows_tail(lo: int, hi: int, ctas: int, threads: int) -> np.ndarray:
    """The rows fused_argmax_kernel's threads take in one segment: two
    rows (r, r + stride) a step of 2 * stride."""
    stride = ctas * threads
    first = lo + np.arange(stride)
    steps = max(1, -(-(hi - lo) // (2 * stride)))
    s = np.arange(steps) * 2 * stride
    r = np.concatenate([(first[:, None] + s[None, :]).ravel(),
                        (first[:, None] + s[None, :] + stride).ravel()])
    return r[r < hi]


@pytest.mark.parametrize("max_ctas", [CLUSTER_CTAS, 16])
def test_cluster_geometry_takes_every_row_once(max_ctas):
    sizes = sorted({0, 1, 2, 31, 32, 33, 127, 128, 129, 255, 256, 257, 1023,
                    1024, 1025, 4095, 4096, 4097, 8191, 8192, 8193, 16383,
                    16384, 16385, 40960, 70000,
                    *random.Random(max_ctas).sample(range(70001), 30)})
    for n in sizes:
        for cut in (nck.SPLIT_NODES, 0):        # as the wrapper picks; split
            clusters, ctas, threads = nck.normal_geometry(n, max_ctas, cut)
            assert 1 <= clusters <= nck.MAX_SPLIT_CLUSTERS
            assert (clusters > 1) == (n > cut)
            assert 1 <= ctas <= (max_ctas if clusters == 1 else CLUSTER_CTAS)
            assert 32 <= threads <= NORMAL_THREADS and threads % 32 == 0
            got = np.bincount(_rows_k2(n, clusters, ctas, threads),
                              minlength=n)
            assert n == 0 or (got == 1).all(), (n, clusters, ctas, threads)
        for seg in sorted({n, 16, max(1, n // 3)}):
            if n == 0:
                continue
            ctas, threads = cluster_geometry(min(seg, n), TAIL_THREADS,
                                             max_ctas)
            assert 1 <= ctas <= max_ctas and threads <= TAIL_THREADS
            covered = np.concatenate([
                _rows_tail(lo, min(n, lo + seg), ctas, threads)
                for lo in range(0, n, seg)])
            got = np.bincount(covered, minlength=n)
            assert (got == 1).all(), (n, seg, ctas, threads)


_CU = (pathlib.Path(fc.__file__).parent / "csrc" / "topo_score.cu").read_text()


@pytest.mark.parametrize("name, const", [
    ("CLUSTER_CTAS", "kClusterCtas"), ("NORMAL_THREADS", "kNormalThreads"),
    ("TAIL_THREADS", "kTailThreads"), ("MAX_PATCH_ROWS", "kMaxPatchRows"),
    ("MAX_SPLIT_CLUSTERS", "kMaxSplitClusters"),
    ("SWEEP_THREADS", "kNarrowThreads"), ("WIDE_THREADS", "kWideThreads")])
def test_wrapper_constants_mirror_the_kernel_source(name, const):
    got = re.search(rf"constexpr int {const} = (\d+);", _CU)
    assert got, const
    assert {**vars(fc), **vars(nck)}[name] == int(got.group(1))


def test_fused_params_mirror_the_kernel_struct():
    """The ctypes FusedParams lists the struct's fields in its order."""
    body = re.search(r"struct FusedParams \{(.*?)\};", _CU, re.S).group(1)
    fields = re.findall(r"^\s*\w+\s+(\w+)(?:\[\w+\])?;", body, re.M)
    assert fields == [f for f, _ in fc._FusedParams._fields_]


def test_bundle_division_is_exact():
    """bundle_magic's (cnt * m) >> 32 == cnt // d for every count a node's
    32-bit masks hold and every bundle size d >= 1: the kernels' constant
    table holds m = 0xffffffff // d + 1 at d = 1..32 (0 at index 0, no
    bundle), and above 32, where every count is below d, m = 0."""
    body = re.search(r"kBundleMagic\[33\] = \{(.*?)\};", _CU, re.S).group(1)
    table = [int(x, 16) for x in re.findall(r"0x[0-9a-f]+", body)]
    assert table == [0] + [0xFFFFFFFF // d + 1 for d in range(1, 33)]
    cnt = np.arange(33, dtype=object)
    for d in [*range(1, 4097), 1 << 16, (1 << 27) + 1, 1 << 31, 2**32 - 1]:
        m = table[d] if d <= 32 else 0
        assert all((c * m) >> 32 == c // d for c in cnt), d
