"""A numpy model of the two scan kernels of ``csrc/recurrent.cu``, written in
the kernels' own order, held on the CPU to the plain versions
(``wkv6_scan_plain``, ``rglru_scan_plain``) and to the reference's
``lax.scan`` and ``lax.associative_scan`` at 1e-5 x max |plain|.

The WKV kernel (``wkv6_kernel``) regroups the recurrence by chunks of
``WKV_CHUNK`` steps.  Within a chunk every decay product is built by
multiplying forward, never by dividing:

* Q = r_t . D_{t-1} and A[t, s] = sum_i r_t P_{s,t} k_s (s < t) by a walk
  of s down from t - 1, one factor w_s a step; A[t, t] = sum_i r_t u k_t;
* K = k_s . E_s and D of the chunk by a walk from the chunk's end;
* y = Q S + A V and the state's update K^T V as TF32 products: each
  operand cut to TF32 hi (13 low mantissa bits masked) and its remainder
  lo, which the tensor cores cut in turn, summed as hi.hi + lo.hi + hi.lo
  (v of the bf16 build is exact and is not split); the state is
  D . S + K^T V by one f32 fma, the update summed apart;
* the steps after the last whole chunk run the recurrent step.

The rg-lru kernel (``rglru_kernel``) takes chunks of RG_SLICES x RG_STEPS
steps: each slice's gates, its map (prod a, its scan from 0), the chunk's
h carried through the slices before a slice (its carry-in) and through all
of them (the next chunk's h), then the slice's steps from its carry-in; a
step past S is the identity.  S = 1 is the one-step kernel.

Cases: S = 1, L - 1, L, L + 1 and a ragged 2L + 3 of each kernel's chunk L,
from a non-zero carried state, on drawn inputs and on extreme ones: WKV
log-decays at the model's clip top 6 (w exactly 0), at its floor -10, at
w = 1 exactly, and mixed within one chunk; rg-lru decays a = 0 and a = 1 in
f32.  The kernels' constants are read from the source.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import recurrent as ref_rec  # noqa: E402
from repro_torch.kernels import recurrent as rk  # noqa: E402

SOURCE = (Path(rk.__file__).parent / "csrc" / "recurrent.cu").read_text()
TOL = 1e-5  # x max |plain|, as chip_smoke.SCAN_TOL


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


WKV_L = _constant("WKV_L")
RG_SLICES, RG_STEPS = _constant("RG_SLICES"), _constant("RG_STEPS")
RG_L = RG_SLICES * RG_STEPS
F32 = np.float32


def test_constants_match_the_source():
    assert (WKV_L, RG_L) == (rk.WKV_CHUNK, rk.RG_CHUNK)
    assert rk.HEAD == _constant("HD") == 64


def fma(a, b, c):
    """a b + c rounded once to f32 (the product is exact in f64)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F32)


def tf32(x):
    """x cut to TF32: its 13 low mantissa bits cleared."""
    return (np.asarray(x, F32).view(np.uint32) & np.uint32(0xFFFFE000)) \
        .view(F32)


def split(x):
    hi = tf32(x)
    return hi, tf32(np.asarray(x, F32) - hi)


def tc_product(a, b, exact_b=False):
    """a @ b on the tensor cores at f32 accuracy: hi.hi + lo.hi + hi.lo
    (a split only where b is exact), each term summed in f32."""
    ah, al = split(a)
    if exact_b:
        return (ah @ b).astype(F32) + (al @ b).astype(F32)
    bh, bl = split(b)
    return (ah @ bh).astype(F32) + ((al @ bh).astype(F32)
                                    + (ah @ bl).astype(F32))


# ---------------------------------------------------------------------------------
# WKV6
# ---------------------------------------------------------------------------------

def wkv_chunk(S0, r, k, v, w, u, exact_v):
    """One chunk of L steps of one (b, h): r, k, v, w [L, 64] f32, S0 the
    incoming state [64 (i), 64 (j)].  Returns (y [L, 64], the state)."""
    L = r.shape[0]
    A = np.zeros((L, L), F32)
    Q = np.zeros_like(r)
    for t in range(L):
        q = r[t].copy()
        A[t, t] = np.sum((r[t] * u) * k[t], dtype=F32)
        for s in range(t - 1, -1, -1):          # q = r_t . P_{s,t}
            A[t, s] = np.sum(q * k[s], dtype=F32)
            q = q * w[s]
        Q[t] = q                                # r_t . D_{t-1}
    K = np.zeros_like(k)
    e = np.ones(r.shape[1], F32)
    for s in range(L - 1, -1, -1):              # e = E_s
        K[s] = k[s] * e
        e = e * w[s]
    y = tc_product(Q, S0) + tc_product(A, v, exact_b=exact_v)
    dS = tc_product(K.T.copy(), v, exact_b=exact_v)
    return y.astype(F32), fma(e[:, None], S0, dS)


def wkv_step(S0, r, k, v, w, u):
    kv = (k[:, None] * v[None, :]).astype(F32)
    y = np.sum(r[:, None] * fma(u[:, None], kv, S0), axis=0, dtype=F32)
    return y, fma(w[:, None], S0, kv)


def wkv_model(r, k, v, w, u, s0, exact_v):
    """The kernel's order over every (b, h): whole chunks, then steps."""
    B, S, H, hd = r.shape
    y = np.zeros((B, S, H, hd), F32)
    s_fin = np.zeros_like(s0)
    whole = S // WKV_L * WKV_L
    for b in range(B):
        for h in range(H):
            St = s0[b, h].copy()
            for t0 in range(0, whole, WKV_L):
                sl = slice(t0, t0 + WKV_L)
                y[b, sl, h], St = wkv_chunk(St, r[b, sl, h], k[b, sl, h],
                                            v[b, sl, h], w[b, sl, h], u[h],
                                            exact_v)
            for t in range(whole, S):
                y[b, t, h], St = wkv_step(St, r[b, t, h], k[b, t, h],
                                          v[b, t, h], w[b, t, h], u[h])
            s_fin[b, h] = St
    return y, s_fin


def ref_wkv(r, k, v, w, u, s0):
    """The reference's step (``recurrent.py:114-125``) under
    ``lax.scan``."""
    def step(S, inp):
        rt, kt, vt, wt = inp
        kv = kt[..., :, None] * vt[..., None, :]
        yt = jnp.einsum("BHi,BHij->BHj", rt, S + u[..., :, None] * kv)
        return wt[..., :, None] * S + kv, yt

    def tm(t): return jnp.moveaxis(jnp.asarray(t), 1, 0)
    s_fin, y = jax.lax.scan(step, jnp.asarray(s0),
                            (tm(r), tm(k), tm(v), tm(w)))
    return np.asarray(jnp.moveaxis(y, 0, 1)), np.asarray(s_fin)


def wkv_inputs(S, seed, decays):
    """Inputs at B 2, H 2: r, k, v drawn (as bf16 values, which the kernel's
    v needs exact in TF32), w = exp(-exp(log-decay)) with the log-decays
    drawn, at 6 (w = 0), -10, -inf (w = 1) or a mix of all four within
    every chunk; a non-zero carried state."""
    rng = np.random.default_rng(seed)
    B, H, hd = 2, 2, rk.HEAD

    def bf16(x):
        return torch.from_numpy(x.astype(F32)).bfloat16().float().numpy()

    r, k, v = (bf16(0.5 * rng.standard_normal((B, S, H, hd)))
               for _ in range(3))
    logw = np.clip(rng.standard_normal((B, S, H, hd)), -10, 6) - 2
    if decays == "mixed":
        logw = rng.choice(np.array([6.0, -10.0, -np.inf, 0.0]),
                          (B, S, H, hd)) + np.where(
            rng.random((B, S, H, hd)) < 0.25, logw, 0.0)
        logw = np.where(np.isnan(logw), -np.inf, logw)
    elif decays != "drawn":
        logw = np.full_like(logw, decays)
    w = np.exp(-np.exp(logw)).astype(F32)
    u = (0.5 * rng.standard_normal((H, hd))).astype(F32)
    s0 = (0.1 * rng.standard_normal((B, H, hd, hd))).astype(F32)
    return r, k, v, w, u, s0


WKV_S = (1, WKV_L - 1, WKV_L, WKV_L + 1, 2 * WKV_L + 3)


@pytest.mark.parametrize("decays", ["drawn", 6.0, -10.0, "mixed"])
@pytest.mark.parametrize("S", WKV_S)
def test_wkv_model_matches_plain_and_reference(S, decays):
    x = wkv_inputs(S, seed=S, decays=decays)
    if decays == 6.0:
        assert np.all(x[3] == 0.0)
    if decays == "mixed":
        assert np.any(x[3] == 0.0) and np.any(x[3] == 1.0)
    want = rk.wkv6_scan_plain(*(torch.from_numpy(a) for a in x))
    want = tuple(t.numpy() for t in want)
    scale = max(float(np.abs(p).max()) for p in want)
    for got in (wkv_model(*x, exact_v=True), ref_wkv(*x)):
        for g, p in zip(got, want):
            assert np.all(np.isfinite(g))
            np.testing.assert_allclose(g, p, rtol=0, atol=TOL * scale)


def test_wkv_model_splits_f32_v():
    """The f32 build splits v as well; the model with v split agrees."""
    x = list(wkv_inputs(2 * WKV_L + 3, seed=5, decays="drawn"))
    x[2] = (x[2] + 1e-3 * np.random.default_rng(6).standard_normal(
        x[2].shape)).astype(F32)
    want = tuple(t.numpy() for t in rk.wkv6_scan_plain(
        *(torch.from_numpy(a) for a in x)))
    scale = max(float(np.abs(p).max()) for p in want)
    for g, p in zip(wkv_model(*x, exact_v=False), want):
        np.testing.assert_allclose(g, p, rtol=0, atol=TOL * scale)


def test_wkv_chunk_is_the_recurrence_without_rounding():
    """In f64 arithmetic with no TF32 cut, one chunk's regrouping is the
    recurrence itself (to f64 rounding): the algebra of the chunked form."""
    r, k, v, w, u, s0 = (a.astype(np.float64) for a in
                         wkv_inputs(WKV_L, seed=2, decays="mixed"))
    S = s0[0, 0]
    ys = []
    for t in range(WKV_L):
        kv = np.outer(k[0, t, 0], v[0, t, 0])
        ys.append(r[0, t, 0] @ (S + u[0][:, None] * kv))
        S = w[0, t, 0][:, None] * S + kv
    L = WKV_L
    rr, kk, vv, ww = (a[0, :, 0] for a in (r, k, v, w))
    D = np.cumprod(np.vstack([np.ones(64), ww]), axis=0)   # D[t] = D_{t-1}
    P = np.ones((L, L, 64))
    for t in range(L):
        for s in range(t - 1, -1, -1):
            P[t, s] = np.prod(ww[s + 1:t], axis=0)
    A = np.einsum("ti,tsi,si->ts", rr, P, kk) * np.tri(L, k=-1)
    A[np.arange(L), np.arange(L)] = np.einsum("ti,i,ti->t", rr, u[0], kk)
    E = np.array([np.prod(ww[s + 1:], axis=0) for s in range(L)])
    y = (rr * D[:L]) @ s0[0, 0] + A @ vv
    S_out = D[L][:, None] * s0[0, 0] + (kk * E).T @ vv
    np.testing.assert_allclose(y, np.array(ys), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(S_out, S, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------------

def rglru_gates(gr, gi, x, soft):
    rg = F32(1) / (F32(1) + np.exp(-gr))
    ig = F32(1) / (F32(1) + np.exp(-gi))
    log_a = F32(-rk.RG_C) * rg * soft
    a = np.exp(log_a)
    b = np.sqrt(np.clip(F32(1) - np.exp(F32(2) * log_a), 0, 1)) * (ig * x)
    return a.astype(F32), b.astype(F32)


def rglru_model(gr, gi, xc, sp, h0):
    """The kernel's order: the one-step kernel at S = 1, else chunks of
    RG_SLICES slices of RG_STEPS steps, all channels at once."""
    B, S, R = gr.shape
    a, b = rglru_gates(gr, gi, xc, sp[None, None, :])
    if S == 1:
        h = fma(a[:, 0], h0, b[:, 0])
        return h[:, None], h
    hs = np.zeros((B, S, R), F32)
    h = h0.copy()
    for t0 in range(0, S, RG_L):
        maps, aa, bb = [], [], []
        for m in range(RG_SLICES):
            ts = t0 + m * RG_STEPS
            sa = np.ones((RG_STEPS, B, R), F32)    # past S: the identity
            sb = np.zeros((RG_STEPS, B, R), F32)
            n = max(0, min(RG_STEPS, S - ts))
            sa[:n] = np.moveaxis(a[:, ts:ts + n], 1, 0)
            sb[:n] = np.moveaxis(b[:, ts:ts + n], 1, 0)
            pa, pb = sa[0].copy(), sb[0].copy()
            for e in range(1, RG_STEPS):
                pb = fma(sa[e], pb, sb[e])
                pa = (pa * sa[e]).astype(F32)
            maps.append((pa, pb))
            aa.append(sa)
            bb.append(sb)
        for m in range(RG_SLICES):
            hk = h.copy()                           # the slice's carry-in
            ts = t0 + m * RG_STEPS
            for e in range(RG_STEPS):
                hk = fma(aa[m][e], hk, bb[m][e])
                if ts + e < S:
                    hs[:, ts + e] = hk
            h = fma(maps[m][0], h, maps[m][1])
    return hs, h


def ref_rglru(gr, gi, xc, sp, h0):
    """The reference's gates and its associative scan with the carry folded
    in (``recurrent.py:205-236``)."""
    r, i = jax.nn.sigmoid(gr), jax.nn.sigmoid(gi)
    log_a = -ref_rec.RG_C * r * sp
    a = jnp.exp(log_a)
    b = jnp.sqrt(jnp.clip(1.0 - jnp.exp(2.0 * log_a), 0.0, 1.0)) * (i * xc)
    b = b.at[:, 0].add(a[:, 0] * h0)

    def comb(lhs, rhs):
        return (rhs[0] * lhs[0], rhs[0] * lhs[1] + rhs[1])
    _, h = jax.lax.associative_scan(comb, (a, b), axis=1)
    return np.asarray(h), np.asarray(h[:, -1])


def rglru_inputs(S, seed, decays):
    """B 2, R 40 (a ragged 32-channel block).  ``decays``: "drawn"; "zero"
    (softplus(lam) 30 under gates 4x wider: a = 0 in f32 where the gate
    opens); "one" (softplus(lam) 1e-13: a = 1); "mixed" (a channel each)."""
    rng = np.random.default_rng(seed)
    B, R = 2, 40
    wide = 4.0 if decays != "drawn" else 1.0
    gr, gi = ((wide * rng.standard_normal((B, S, R))).astype(F32)
              for _ in range(2))
    xc = rng.standard_normal((B, S, R)).astype(F32)
    sp = np.log1p(np.exp(rng.standard_normal(R) + 3)).astype(F32)
    if decays == "zero":
        sp[:] = 30.0
    elif decays == "one":
        sp[:] = 1e-13
    elif decays == "mixed":
        sp = rng.choice(np.array([30.0, 1e-13], F32), R)
        sp[::3] = 2.0
    h0 = rng.standard_normal((B, R)).astype(F32)
    return gr, gi, xc, sp.astype(F32), h0


RG_S = (1, RG_L - 1, RG_L, RG_L + 1, 2 * RG_L + 3)


@pytest.mark.parametrize("decays", ["drawn", "zero", "one", "mixed"])
@pytest.mark.parametrize("S", RG_S)
def test_rglru_model_matches_plain_and_reference(S, decays):
    x = rglru_inputs(S, seed=100 + S, decays=decays)
    a, _ = rglru_gates(x[0], x[1], x[2], x[3][None, None, :])
    if decays == "zero":
        assert np.any(a == 0.0)
    if decays == "one":
        assert np.all(a == 1.0)
    want = tuple(t.numpy() for t in rk.rglru_scan_plain(
        *(torch.from_numpy(v) for v in x)))
    scale = max(float(np.abs(p).max()) for p in want)
    for got in (rglru_model(*x), ref_rglru(*(jnp.asarray(v) for v in x))):
        for g, p in zip(got, want):
            assert np.all(np.isfinite(g))
            np.testing.assert_allclose(g, p, rtol=0, atol=TOL * scale)
