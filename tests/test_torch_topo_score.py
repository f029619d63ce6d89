"""The port's topo-score kernels (plain PyTorch versions) against the JAX
reference: K1 ``topo_score_argmax``, K3 ``topo_score`` and K2
``placement_tier``.

The same numpy-seeded lanes go through the reference's Pallas kernels in
interpret mode, through ``repro.kernels.ref.topo_score_ref``, and through
the port on CPU tensors (where each wrapper runs its plain version).
Tiers and the per-tile argmax outputs (kmin, btier, bidx) must match
exactly; scores and bscore within 1 ulp, the allowance for a reference
that may contract ``alpha*p + (1-alpha)*t`` into a fused multiply-add.
On this CPU every score matched at 0 ulp (``test_scores_bitwise_equal_to_ref``
pins that against ``topo_score_ref``).

The CUDA kernels themselves run only on a GPU; ``chip_smoke.py`` holds each
of them bit-exact against these plain versions there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core.placement import best_tier as ref_best_tier  # noqa: E402
from repro.core.topology import SPECS as REF_SPECS  # noqa: E402
from repro.kernels import ref as ref_kernels  # noqa: E402
from repro.kernels import topo_score as ref_ts  # noqa: E402
from repro_torch.core.placement import best_tier  # noqa: E402
from repro_torch.core.topology import SPECS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import topo_score as ts  # noqa: E402

SPEC_NAMES = sorted(SPECS)
#: (need_gpus, need_cgs, cgs_per_bundle); (0, 0, 0) is the zero-need
#: request that makes an all-zero lane feasible, (2, 4, 2) exercises the
#: integer division cnt_cg // cgs_per_bundle
REQS = [(1, 1, 1), (2, 2, 1), (4, 4, 0), (8, 8, 1), (0, 0, 0), (2, 4, 2)]
ALPHAS = [0.0, 0.5, 1.0]
SIZES = [700, 1500]          # one ragged tile; a full tile plus a ragged one


def _lanes(spec, n, seed):
    """Seeded lanes with the exactness traps in them: zero masks and zero
    priorities, k up to K_INFEASIBLE, a random ok mask, and (for n > one
    tile) a second tile whose lanes are all masked out."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, spec.all_gpu_mask + 1, n).astype(np.int32)
    c = rng.integers(0, spec.all_cg_mask + 1, n).astype(np.int32)
    g[::17] = 0
    c[::19] = 0
    p = rng.integers(0, 3000 * 16, n).astype(np.int32)
    p[::7] = 0
    k = rng.integers(0, 9, n).astype(np.int32)
    k[::23] = ts.K_INFEASIBLE
    ok = (rng.random(n) < 0.7).astype(np.int32)
    if n > ts.TILE:
        ok[ts.TILE:] = 0
    return g, c, p, k, ok


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_scores(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    inf = np.isinf(want)
    assert np.array_equal(np.isinf(got), inf)
    assert np.array_equal(got[inf], want[inf])
    np.testing.assert_array_max_ulp(got[~inf], want[~inf], maxulp=1)


def _argmax_by_host(tier, score, k, n):
    """Per-tile reduction written out in numpy, as the reference orders it."""
    big = int(ts.K_INFEASIBLE)
    out = []
    for t in range(-(-n // ts.TILE)):
        lo, hi = t * ts.TILE, min((t + 1) * ts.TILE, n)
        feas = tier[lo:hi] < 3
        kmin = int(np.where(feas, k[lo:hi], big).min())
        sel = feas & (k[lo:hi] == kmin)
        if not sel.any():
            out.append((kmin, 3, -np.inf, t * ts.TILE + big))
            continue
        bt = int(tier[lo:hi][sel].min())
        sel &= tier[lo:hi] == bt
        bs = score[lo:hi][sel].max()
        sel &= score[lo:hi] == bs
        out.append((kmin, bt, bs, lo + int(np.nonzero(sel)[0][0])))
    return out


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("need", REQS, ids=str)
@pytest.mark.parametrize("spec_name", SPEC_NAMES)
def test_plain_matches_topo_score_ref(spec_name, need, alpha, n):
    """K3 and K1 (plain) against the reference's jnp oracle over the whole
    grid, and K1's per-tile argmax against a numpy reduction."""
    spec, ref_spec = SPECS[spec_name], REF_SPECS[spec_name]
    ng, nc, cpb = need
    seed = (SPEC_NAMES.index(spec_name) * 100 + REQS.index(need) * 10
            + SIZES.index(n))
    g, c, p, k, ok = _lanes(spec, n, seed=seed)
    req = ts.TopoRequest(ng, nc, cpb, alpha=alpha)
    want_tier, want_score = ref_kernels.topo_score_ref(
        jnp.asarray(g), jnp.asarray(c), jnp.asarray(p), ref_spec, ng, nc,
        cpb, alpha)
    want_tier, want_score = np.asarray(want_tier), np.asarray(want_score)

    tier, score = ops.topo_score(_t(g), _t(c), _t(p), spec, req)
    assert tier.dtype == torch.int32 and score.dtype == torch.float32
    np.testing.assert_array_equal(tier.numpy(), want_tier)
    _assert_scores(score.numpy(), want_score)

    out = ts.topo_score_argmax(_t(g), _t(c), _t(p), _t(k), spec, req,
                               ok=_t(ok))
    tier1, score1 = out[0].numpy(), out[1].numpy()
    masked = ok == 0
    np.testing.assert_array_equal(tier1, np.where(masked, 3, want_tier))
    _assert_scores(score1, np.where(masked, -np.inf, want_score))
    want_red = _argmax_by_host(tier1, score1, k, n)
    got_red = list(zip(*(x.numpy().tolist() for x in out[2:])))
    assert [(a, b, d) for a, b, _, d in got_red] == \
        [(a, b, d) for a, b, _, d in want_red]
    _assert_scores([r[2] for r in got_red], [r[2] for r in want_red])


@pytest.mark.parametrize("need", REQS[:5], ids=str)
@pytest.mark.parametrize("spec_name", SPEC_NAMES)
def test_plain_matches_pallas_interpret(spec_name, need):
    """K1, K3 and K2 (plain) against the reference's Pallas kernels run in
    interpret mode.  Alpha and n rotate over the cases so every value of
    each appears."""
    spec, ref_spec = SPECS[spec_name], REF_SPECS[spec_name]
    i = SPEC_NAMES.index(spec_name) * len(REQS) + REQS.index(need)
    alpha, n = ALPHAS[i % 3], SIZES[i % 2]
    ng, nc, cpb = need
    g, c, p, k, ok = _lanes(spec, n, seed=i)
    req = ts.TopoRequest(ng, nc, cpb, alpha=alpha)
    ref_req = ref_ts.TopoRequest(ng, nc, cpb, alpha=alpha)

    want = ref_ts.topo_score_argmax_pallas(
        jnp.asarray(g), jnp.asarray(c), jnp.asarray(p), jnp.asarray(k),
        ref_spec, ref_req, interpret=True, ok=jnp.asarray(ok))
    got = ts.topo_score_argmax(_t(g), _t(c), _t(p), _t(k), spec, req,
                               ok=_t(ok))
    for j in (0, 2, 3, 5):     # tier, kmin, btier, bidx
        np.testing.assert_array_equal(got[j].numpy(), np.asarray(want[j]))
    for j in (1, 4):           # score, bscore
        _assert_scores(got[j].numpy(), np.asarray(want[j]))

    want_t, want_s = ref_ts.topo_score_pallas(
        jnp.asarray(g), jnp.asarray(c), jnp.asarray(p), ref_spec, ref_req,
        interpret=True)
    got_t, got_s = ts.topo_score(_t(g), _t(c), _t(p), spec, req)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    _assert_scores(got_s.numpy(), np.asarray(want_s))

    want_pt = ref_ts.placement_tier_pallas(
        jnp.asarray(g), jnp.asarray(c), ref_spec, ref_req, interpret=True)
    got_pt = ts.placement_tier(_t(g), _t(c), spec, req)
    np.testing.assert_array_equal(got_pt.numpy(), np.asarray(want_pt))


@pytest.mark.parametrize("spec_name", SPEC_NAMES)
def test_scores_bitwise_equal_to_ref(spec_name):
    """On the CPU the plain Eq. 1 score is bit-identical (0 ulp) to the
    reference's oracle: alpha rounded to f32, (1 - alpha) rounded from
    double, one rounding per f32 operation."""
    spec, ref_spec = SPECS[spec_name], REF_SPECS[spec_name]
    g, c, p, _, _ = _lanes(spec, 1500, seed=5)
    for alpha in (0.0, 0.3, 0.5, 0.7, 1.0):
        req = ts.TopoRequest(2, 2, 1, alpha=alpha)
        _, want = ref_kernels.topo_score_ref(
            jnp.asarray(g), jnp.asarray(c), jnp.asarray(p), ref_spec, 2, 2,
            1, alpha)
        _, got = ts.topo_score(_t(g), _t(c), _t(p), spec, req)
        assert np.array_equal(got.numpy().view(np.int32),
                              np.asarray(want).view(np.int32))


@pytest.mark.parametrize("spec_name", SPEC_NAMES)
def test_placement_tier_matches_host_best_tier(spec_name):
    """K2 (plain) against host ``best_tier`` of both packages, as the
    reference's ``test_placement_tier_pallas_matches_host_best_tier``."""
    spec, ref_spec = SPECS[spec_name], REF_SPECS[spec_name]
    rng = np.random.default_rng(3)
    n = 1200
    fg = rng.integers(0, spec.all_gpu_mask + 1, n).astype(np.int32)
    fc = rng.integers(0, spec.all_cg_mask + 1, n).astype(np.int32)
    for ng, nc, cpb, bundle in ((2, 2, 1, True), (4, 4, 1, True),
                                (0, 3, 0, True), (2, 4, 0, False),
                                (1, 2, 2, True)):
        tier = ts.placement_tier(_t(fg), _t(fc), spec,
                                 ts.TopoRequest(ng, nc, cpb)).numpy()
        for i in range(0, n, 7):
            want = best_tier(spec, int(fg[i]), int(fc[i]), ng, nc, bundle)
            assert want == ref_best_tier(ref_spec, int(fg[i]), int(fc[i]),
                                         ng, nc, bundle)
            assert tier[i] == want, (i, ng, nc, cpb)


def test_wrappers_validate_inputs():
    spec = SPECS["rtx4090"]
    req = ts.TopoRequest(1, 1, 1)
    x = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        ts.topo_score(x.to(torch.int64), x, x, spec, req)
    with pytest.raises(ValueError):
        ts.topo_score(x, x[:4], x, spec, req)
    with pytest.raises(ValueError):
        ts.placement_tier(x[::2], x[::2], spec, req)
    meta = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ts.topo_score_argmax(meta, meta, meta, meta, spec, req, ok=meta)


def test_cpu_path_never_counts_a_launch():
    """Launch counters move only where a kernel is launched: CPU tensors
    take the plain version and leave every count as it was."""
    spec = SPECS["a100"]
    req = ts.TopoRequest(2, 2, 1)
    before = [w.launches for w in ts.WRAPPERS]
    g, c, p, k, ok = (_t(a) for a in _lanes(spec, 300, seed=1))
    ts.topo_score(g, c, p, spec, req)
    ts.topo_score_argmax(g, c, p, k, spec, req, ok=ok)
    ts.placement_tier(g, c, spec, req)
    assert [w.launches for w in ts.WRAPPERS] == before


def test_empty_input():
    spec = SPECS["rtx4090"]
    req = ts.TopoRequest(1, 1, 1)
    e = torch.zeros(0, dtype=torch.int32)
    tier, score, kmin, btier, bscore, bidx = ts.topo_score_argmax(
        e, e, e, e, spec, req)
    assert tier.shape == (0,) and kmin.shape == (0,)
