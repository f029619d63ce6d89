"""The port's recurrent mixers (`repro_torch.models.recurrent`) and the plain
versions of their scan kernels (`repro_torch.kernels.recurrent`) against
the JAX reference, on the CPU.

* ``wkv6_scan_plain`` against the reference's WKV step under ``lax.scan``
  and ``rglru_scan_plain`` against the reference's ``_rglru_gates`` and
  its ``lax.associative_scan`` (the reference's own lines, run on the same
  inputs): 1e-5, f32.  The associative scan multiplies the decays in
  another order than a sequential loop, so the two agree to f32 rounding,
  not bit for bit.
* The time mix, channel mix and rg-lru block, forward (with a carried
  state) and decode, against the reference's functions on the same
  weights: 1e-5, f32.

The CUDA kernels run only on a GPU; ``chip_smoke.py`` holds them against
these plain versions there.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import recurrent as ref_rec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import recurrent as rk  # noqa: E402
from repro_torch.models import recurrent as rec  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _configs(arch):
    return (dataclasses.replace(get_config(arch, smoke=True),
                                compute_dtype=torch.float32),
            dataclasses.replace(ref_get_config(arch, smoke=True),
                                compute_dtype=jnp.float32))


def _t(tree):
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in tree.items()}


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _ref_wkv(r, k, v, w, u, s0):
    """The reference's WKV step (``recurrent.py:114-125``) under
    ``lax.scan``."""
    def step(S, inp):
        rt, kt, vt, wt = inp
        kv = kt[..., :, None] * vt[..., None, :]
        yt = jnp.einsum("BHi,BHij->BHj", rt, S + u[..., :, None] * kv)
        return wt[..., :, None] * S + kv, yt

    def tm(t): return jnp.moveaxis(jnp.asarray(t), 1, 0)
    s_fin, y = jax.lax.scan(step, jnp.asarray(s0),
                            (tm(r), tm(k), tm(v), tm(w)))
    return jnp.moveaxis(y, 0, 1), s_fin


@pytest.mark.parametrize("S", [1, 7, 40])
def test_wkv6_plain_matches_reference_scan(S):
    rng = np.random.default_rng(S)
    B, H = 2, 3
    r, k, v = (_rand(rng, B, S, H, 64, scale=0.5) for _ in range(3))
    w = np.exp(-np.exp(_rand(rng, B, S, H, 64) - 1)).astype(np.float32)
    u, s0 = _rand(rng, H, 64, scale=0.5), _rand(rng, B, H, 64, 64, scale=0.1)
    want_y, want_s = _ref_wkv(r, k, v, w, u, s0)
    y, s_fin = rk.wkv6_scan(*(torch.from_numpy(a)
                              for a in (r, k, v, w, u, s0)))
    assert y.dtype == s_fin.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(s_fin.numpy(), np.asarray(want_s), **TOL)


def _ref_rglru(gr, gi, xc, sp, h0):
    """The reference's gates (``recurrent.py:205-212`` after the two
    products) and its associative scan with the carry folded in."""
    r, i = jax.nn.sigmoid(gr), jax.nn.sigmoid(gi)
    log_a = -ref_rec.RG_C * r * sp
    a = jnp.exp(log_a)
    b = jnp.sqrt(jnp.clip(1.0 - jnp.exp(2.0 * log_a), 0.0, 1.0)) * (i * xc)
    b = b.at[:, 0].add(a[:, 0] * h0)

    def comb(lhs, rhs):
        return (rhs[0] * lhs[0], rhs[0] * lhs[1] + rhs[1])
    _, h = jax.lax.associative_scan(comb, (a, b), axis=1)
    return h


@pytest.mark.parametrize("S", [1, 9, 64])
def test_rglru_plain_matches_reference_scan(S):
    rng = np.random.default_rng(10 + S)
    B, R = 3, 48
    gr, gi, xc = (_rand(rng, B, S, R) for _ in range(3))
    sp = np.log1p(np.exp(_rand(rng, R) + 3)).astype(np.float32)
    h0 = _rand(rng, B, R)
    want = _ref_rglru(*(jnp.asarray(a) for a in (gr, gi, xc, sp, h0)))
    h, h_last = rk.rglru_scan(*(torch.from_numpy(a)
                                for a in (gr, gi, xc, sp, h0)))
    np.testing.assert_allclose(h.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(h_last.numpy(), h.numpy()[:, -1])


def test_scan_wrappers_check_their_inputs():
    r = torch.zeros(1, 2, 1, 64)
    with pytest.raises(ValueError, match="64"):
        rk.wkv6_scan(torch.zeros(1, 2, 1, 32), *([torch.zeros(1, 2, 1, 32)]
                                                 * 3), torch.zeros(1, 32),
                     torch.zeros(1, 1, 32, 32))
    with pytest.raises(ValueError, match="dtype"):
        rk.wkv6_scan(r.half(), r.half(), r.half(), r, torch.zeros(1, 64),
                     torch.zeros(1, 1, 64, 64))
    with pytest.raises(ValueError, match="device"):
        rk.wkv6_scan(r, r, r, r.to("meta"), torch.zeros(1, 64),
                     torch.zeros(1, 1, 64, 64))
    x = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError, match="fit"):
        rk.rglru_scan(x, x, x, torch.zeros(7), torch.zeros(2, 8))
    with pytest.raises(ValueError, match="device"):
        rk.rglru_scan(x.to("meta"), x.to("meta"), x.to("meta"),
                      torch.zeros(8, device="meta"),
                      torch.zeros(2, 8, device="meta"))


def test_cpu_tensors_run_the_plain_versions():
    before = (rk.wkv6_scan.launches, rk.rglru_scan.launches)
    r = torch.randn(1, 3, 2, 64)
    rk.wkv6_scan(r, r, r, torch.rand(1, 3, 2, 64), torch.zeros(2, 64),
                 torch.zeros(1, 2, 64, 64))
    x = torch.randn(2, 3, 8)
    rk.rglru_scan(x, x, x, torch.ones(8), torch.zeros(2, 8))
    assert (rk.wkv6_scan.launches, rk.rglru_scan.launches) == before
    from repro_torch.kernels import WRAPPERS
    assert rk.wkv6_scan in WRAPPERS and rk.rglru_scan in WRAPPERS


# ---------------------------------------------------------------------------------
# the mixers against the reference's, f32
# ---------------------------------------------------------------------------------

def _timemix(seed=0):
    cfg, rcfg = _configs("rwkv6-7b")
    p = jax.tree.map(np.asarray,
                     ref_rec.rwkv_timemix_init(jax.random.PRNGKey(seed), rcfg))
    rng = np.random.default_rng(seed)
    # the reference's init leaves mu, mu_x at 0 and w0 constant: move them
    p = dict(p, mu_x=_rand(rng, cfg.d_model, scale=0.3),
             mu=_rand(rng, 5, cfg.d_model, scale=0.3),
             w0=_rand(rng, cfg.d_model) - 2,
             gn_scale=1 + _rand(rng, cfg.d_model, scale=0.1))
    return cfg, rcfg, p, _t(p)


def test_rwkv_timemix_forward_and_decode_match_reference():
    cfg, rcfg, p, tp = _timemix()
    H, hd = rec.rwkv_heads(cfg)
    rng = np.random.default_rng(1)
    B, S = 2, 19
    x = _rand(rng, B, S, cfg.d_model)
    state = {"S": _rand(rng, B, H, hd, hd, scale=0.1),
             "x_prev": _rand(rng, B, cfg.d_model)}
    for st in (None, state):
        want, wst = ref_rec.rwkv_timemix_forward(
            p, rcfg, jnp.asarray(x),
            None if st is None else jax.tree.map(jnp.asarray, st))
        got, gst = rec.rwkv_timemix_forward(
            tp, cfg, torch.from_numpy(x), None if st is None else _t(st))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for key in ("S", "x_prev"):
            np.testing.assert_allclose(gst[key].numpy(), np.asarray(wst[key]),
                                       **TOL, err_msg=key)
    x1 = _rand(rng, B, cfg.d_model)
    want, wst = ref_rec.rwkv_timemix_decode(p, rcfg, jnp.asarray(x1),
                                            jax.tree.map(jnp.asarray, state))
    got, gst = rec.rwkv_timemix_decode(tp, cfg, torch.from_numpy(x1),
                                       _t(state))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("S", "x_prev"):
        np.testing.assert_allclose(gst[key].numpy(), np.asarray(wst[key]),
                                   **TOL, err_msg=key)


def test_rwkv_decode_continues_the_forward():
    """A forward over S tokens, then one decode step, equals the forward
    over S + 1 tokens at the last token (the state carries it all)."""
    cfg, _, _, tp = _timemix(3)
    x = torch.from_numpy(_rand(np.random.default_rng(2), 2, 12, cfg.d_model))
    full, fst = rec.rwkv_timemix_forward(tp, cfg, x)
    _, st = rec.rwkv_timemix_forward(tp, cfg, x[:, :-1])
    out, dst = rec.rwkv_timemix_decode(tp, cfg, x[:, -1], st)
    torch.testing.assert_close(out, full[:, -1], **TOL)
    torch.testing.assert_close(dst["S"], fst["S"], **TOL)


def test_rwkv_channelmix_matches_reference():
    cfg, rcfg = _configs("rwkv6-7b")
    p = jax.tree.map(np.asarray, ref_rec.rwkv_channelmix_init(
        jax.random.PRNGKey(4), rcfg))
    rng = np.random.default_rng(4)
    p = dict(p, mu_k=_rand(rng, cfg.d_model, scale=0.3),
             mu_r=_rand(rng, cfg.d_model, scale=0.3))
    x, xp = _rand(rng, 2, 9, cfg.d_model), _rand(rng, 2, 9, cfg.d_model)
    want = ref_rec.rwkv_channelmix(p, rcfg, jnp.asarray(x), jnp.asarray(xp))
    got = rec.rwkv_channelmix(_t(p), cfg, torch.from_numpy(x),
                              torch.from_numpy(xp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _rglru(seed=0):
    cfg, rcfg = _configs("recurrentgemma-9b")
    p = jax.tree.map(np.asarray,
                     ref_rec.rglru_block_init(jax.random.PRNGKey(seed), rcfg))
    rng = np.random.default_rng(seed)
    R = cfg.rnn_width
    p = dict(p, conv_b=_rand(rng, R, scale=0.1), b_r=_rand(rng, R),
             b_i=_rand(rng, R), lam=_rand(rng, R) + 2,
             w_r=_rand(rng, R, R, scale=0.3), w_i=_rand(rng, R, R, scale=0.3))
    return cfg, rcfg, p, _t(p)


def test_rglru_block_forward_and_decode_match_reference():
    """Forward from zeros and from a carried state (h and the conv
    window), then a decode step: outputs and both states."""
    cfg, rcfg, p, tp = _rglru()
    R, K = cfg.rnn_width, cfg.conv_kernel
    rng = np.random.default_rng(5)
    B, S = 2, 21
    x = _rand(rng, B, S, cfg.d_model)
    state = {"h": _rand(rng, B, R), "conv": _rand(rng, B, K - 1, R)}
    for st in (None, state):
        want, wst = ref_rec.rglru_block_forward(
            p, rcfg, jnp.asarray(x),
            None if st is None else jax.tree.map(jnp.asarray, st))
        got, gst = rec.rglru_block_forward(
            tp, cfg, torch.from_numpy(x), None if st is None else _t(st))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for key in ("h", "conv"):
            np.testing.assert_allclose(gst[key].numpy(), np.asarray(wst[key]),
                                       **TOL, err_msg=key)
    x1 = _rand(rng, B, cfg.d_model)
    want, wst = ref_rec.rglru_block_decode(p, rcfg, jnp.asarray(x1),
                                           jax.tree.map(jnp.asarray, state))
    got, gst = rec.rglru_block_decode(tp, cfg, torch.from_numpy(x1),
                                      _t(state))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("h", "conv"):
        np.testing.assert_allclose(gst[key].numpy(), np.asarray(wst[key]),
                                   **TOL, err_msg=key)


def test_rglru_decode_continues_the_forward():
    cfg, _, _, tp = _rglru(6)
    x = torch.from_numpy(_rand(np.random.default_rng(7), 2, 10, cfg.d_model))
    full, fst = rec.rglru_block_forward(tp, cfg, x)
    _, st = rec.rglru_block_forward(tp, cfg, x[:, :-1])
    out, dst = rec.rglru_block_decode(tp, cfg, x[:, -1], st)
    torch.testing.assert_close(out, full[:, -1], **TOL)
    for key in ("h", "conv"):
        torch.testing.assert_close(dst[key], fst[key], **TOL)


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu's default (the reference's rg-lru gate) is the tanh
    form; F.gelu's default is the erf form."""
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    np.testing.assert_allclose(rec._gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)
