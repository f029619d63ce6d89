"""The backward of the port's recurrent scans against the JAX reference, on
the CPU.

* ``wkv6_scan_bwd_plain`` and ``rglru_scan_bwd_plain`` (what the autograd
  functions ``WKV6Scan`` and ``RGLRUScan`` run for CPU tensors) against
  ``jax.vjp`` of the reference's own lines: the WKV step under
  ``lax.scan`` (``recurrent.py:114-125``) and ``_rglru_gates``' lines with
  the associative scan (``:205-236``), as ``test_torch_recurrent.py``
  copies them; f32, non-zero cotangents on both outputs, at S = 0, 1,
  L - 1, L, L + 1 and 2L + 3 of each backward kernel's chunk L (the WKV's
  also either side of a checkpoint segment, and four segments), on drawn
  and extreme decays (WKV log-decays at both ends of the clip; rg-lru gates
  at +-12, see `rglru_inputs`): every gradient within 1e-5 of its largest
  element.
* Where 1 - a^2 is exactly 0 (a = 1 in f32) the sqrt's slope 0.5 / sqrt(0)
  is infinite: both give the same infinities and NaNs.
* ``torch.autograd.gradcheck`` of both autograd functions in f64 (its
  fast mode: the Jacobians along random directions).
* ``rwkv_timemix_forward`` and ``rglru_block_forward`` gradients (weights,
  input and a carried state that requires grad) against ``jax.grad`` of
  the reference's functions, f32.
* rwkv6-7b's and recurrentgemma-9b's bf16 loss and gradients by
  ``test_torch_loss.py``'s rule (``BF16_ARCHS``).
* A numpy model of each backward kernel as it computes
  (``csrc/recurrent_bwd.cu``: the WKV's chunked form, its first pass and
  segments rebuilt from checkpoints, the products as split TF32, the row
  walk, the walk a channel with the division-free dw, dv within the
  (b, h) and du over the batch; the rg-lru's slices composed backward, dsp
  over a thread's steps, the slices and the batch) held to the plain
  versions and the reference at 1e-5, the WKV also either side of a
  checkpoint segment; the kernels' constants read from the source.

The CUDA kernels run only on a GPU; ``chip_smoke.py``'s ``[scan-bwd]`` holds
them to these plain versions there.
"""
import dataclasses
import functools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import recurrent as ref_rec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import recurrent as rk  # noqa: E402
from repro_torch.models import build_model, load_reference_master  # noqa
from repro_torch.models import recurrent as rec  # noqa: E402
from repro_torch.models.convert import layer_stacks  # noqa: E402
from repro_torch.train.optim import tree_leaves  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402

TOL = 1e-5       # x each gradient's largest |element|
F32 = np.float32
SOURCE = (Path(rk.__file__).parent / "csrc" / "recurrent_bwd.cu").read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\w+);", SOURCE).group(1))


HEADER = (Path(rk.__file__).parent / "csrc" / "tf32.cuh").read_text()
#: steps a chunk, and chunks a checkpoint segment, of the WKV backward
WB_L, WB_M, RB_SLICES, RB_STEPS = (_constant(n) for n in
                                   ("WB_L", "WB_M", "RB_SLICES", "RB_STEPS"))
WB_H = WB_L // 2
RB_CHUNK = RB_SLICES * RB_STEPS


def test_constants_match_the_source():
    assert (WB_L, RB_CHUNK) == (rk.WKV_CHUNK, rk.RG_CHUNK) == (16, 32)
    assert WB_M == rk.WKV_BWD_SEGMENT == 6
    assert re.search(r"constexpr int WB_THREADS = 256;", SOURCE)
    assert "constexpr int WB_H = WB_L / 2;" in SOURCE
    assert '#include "tf32.cuh"' in SOURCE
    assert "atomic" not in SOURCE.split("#include")[-1]
    assert "atomic" not in HEADER


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(F32)


def _close(got, want, what, tol=TOL):
    """Where ``want`` is finite, |got - want| <= tol x max |want|; its
    non-finite elements (an infinite slope) the same in ``got``: NaN for
    NaN, inf for inf of the same sign."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=what)
    inf = np.isinf(want)
    np.testing.assert_array_equal(got[inf], want[inf], err_msg=what)
    fin = np.isfinite(want)
    got, want = got[fin], want[fin]
    assert np.isfinite(got).all(), what
    top = np.abs(want).max() if want.size else 0.0
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * top, f"{what}: {err} > {tol} x {top}"


# ---------------------------------------------------------------------------------
# the reference's lines and their vjp
# ---------------------------------------------------------------------------------

def _ref_wkv(r, k, v, w, u, s0):
    """The reference's WKV step (``recurrent.py:114-125``) under
    ``lax.scan``."""
    def step(S, inp):
        rt, kt, vt, wt = inp
        kv = kt[..., :, None] * vt[..., None, :]
        yt = jnp.einsum("BHi,BHij->BHj", rt, S + u[..., :, None] * kv)
        return wt[..., :, None] * S + kv, yt

    def tm(t): return jnp.moveaxis(t, 1, 0)
    s_fin, y = jax.lax.scan(step, s0, (tm(r), tm(k), tm(v), tm(w)))
    return jnp.moveaxis(y, 0, 1), s_fin


def _ref_rglru(gr, gi, xc, sp, h0):
    """The reference's gates (``recurrent.py:205-212`` after the two
    products) and its associative scan with the carry folded in; h and its
    last step."""
    r, i = jax.nn.sigmoid(gr), jax.nn.sigmoid(gi)
    log_a = -ref_rec.RG_C * r * sp
    a = jnp.exp(log_a)
    b = jnp.sqrt(jnp.clip(1.0 - jnp.exp(2.0 * log_a), 0.0, 1.0)) * (i * xc)
    b = b.at[:, 0].add(a[:, 0] * h0)

    def comb(lhs, rhs):
        return (rhs[0] * lhs[0], rhs[0] * lhs[1] + rhs[1])
    _, h = jax.lax.associative_scan(comb, (a, b), axis=1)
    return h, h[:, -1]


def _vjp(fn, inputs, cotangents):
    """jax.vjp of ``fn`` at ``inputs`` applied to ``cotangents``, jitted."""
    def pull(xs, cts):
        return jax.vjp(fn, *xs)[1](cts)

    out = jax.jit(pull)(tuple(jnp.asarray(x) for x in inputs),
                        tuple(jnp.asarray(c) for c in cotangents))
    return [np.asarray(g) for g in out]


def wkv_inputs(S, seed, decays, B=2, H=2):
    """r, k, v, w, u, s0 and cotangents dy, ds_fin; ``extreme``: each
    log-decay at the clip's top 6 (w = 0 in f32), at its floor -10 (w =
    1 - 4.5e-5) or drawn, mixed within every chunk."""
    rng = np.random.default_rng(seed)
    r, k, v = (_rand(rng, B, S, H, 64, scale=0.5) for _ in range(3))
    logw = np.clip(_rand(rng, B, S, H, 64), -10, 6) - 2
    if decays == "extreme":
        z = rng.standard_normal(logw.shape)
        logw = np.where(z < -0.43, 6.0, np.where(z > 0.43, -10.0, logw))
    w = np.exp(-np.exp(logw.astype(F32))).astype(F32)
    return (r, k, v, w, _rand(rng, H, 64, scale=0.5),
            _rand(rng, B, H, 64, 64, scale=0.1), _rand(rng, B, S, H, 64),
            _rand(rng, B, H, 64, 64, scale=0.1))


def rglru_inputs(S, seed, decays, B=3, R=40):
    """gr, gi, xc, sp, h0 and cotangents dhs, dh_last; ``extreme``: gr at
    -12 or +12 in a third of the elements each and softplus(lam) at least 2
    (at -12 a = 1 - 5e-5 sp and the sqrt's slope ~70 / sqrt(sp); at +12
    a = exp(-8 sp), 0 in f32 for sp above 11).  Nearer a = 1 the gradient
    is ill-conditioned: at gr = -20, or at -12 with a smaller sp,
    exp(2 log a) lies within a few ulps of 1, so one ulp between XLA's exp
    and PyTorch's moves 1 - a^2, and the slope, by up to a half, in the
    reference as much as in the port; there ``chip_smoke.py`` holds the
    kernel to the plain version (one exp on the card), and a = 1 exactly is
    `test_rglru_bwd_where_one_minus_a2_is_zero`'s."""
    rng = np.random.default_rng(seed)
    gr, gi, xc = (_rand(rng, B, S, R) for _ in range(3))
    sp = np.log1p(np.exp(_rand(rng, R) + 3)).astype(F32)
    if decays == "extreme":
        z = rng.standard_normal(gr.shape)
        gr = np.where(z < -0.43, -12.0, np.where(z > 0.43, 12.0, gr)) \
            .astype(F32)
        sp = np.maximum(sp, F32(2))
    return (gr, gi, xc, sp, _rand(rng, B, R), _rand(rng, B, S, R),
            _rand(rng, B, R))


def _torch(xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _s_cases(L):
    return [0, 1, L - 1, L, L + 1, 2 * L + 3]


#: the WKV cases: either side of a chunk, and of a checkpoint segment of
#: WB_M chunks; four segments (two of them checkpoints in the workspace)
WKV_S = _s_cases(WB_L) + [WB_M * WB_L - 1, WB_M * WB_L, WB_M * WB_L + 1,
                          3 * WB_M * WB_L + 5]


@functools.lru_cache(maxsize=None)
def _wkv_case(S, decays):
    """The inputs of one WKV case and the reference's gradients there,
    kept for the plain version's test and the model's."""
    x = wkv_inputs(S, 100 + S, decays)
    return x, _vjp(_ref_wkv, x[:6], x[6:])


@pytest.mark.parametrize("decays", ["drawn", "extreme"])
@pytest.mark.parametrize("S", WKV_S)
def test_wkv6_bwd_plain_matches_jax_vjp(S, decays):
    x, want = _wkv_case(S, decays)
    got = rk.wkv6_scan_bwd_plain(*_torch(x))
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), w, name)


def _rglru_ref_grads(x):
    """jax.vjp of the reference's lines; at S = 0 (where they index a step
    that is not there) what S = 0 means: no step, dh0 = dh_last."""
    gr, gi, xc, sp, h0, dhs, dh_last = x
    if gr.shape[1] == 0:
        return [np.zeros_like(gr), np.zeros_like(gi), np.zeros_like(xc),
                np.zeros_like(sp), dh_last]
    return _vjp(_ref_rglru, x[:5], x[5:])


@functools.lru_cache(maxsize=None)
def _rglru_case(S, decays):
    """The inputs of one rg-lru case and the reference's gradients there."""
    x = rglru_inputs(S, 200 + S, decays)
    return x, _rglru_ref_grads(x)


@pytest.mark.parametrize("decays", ["drawn", "extreme"])
@pytest.mark.parametrize("S", _s_cases(32))
def test_rglru_bwd_plain_matches_jax_vjp(S, decays):
    x, want = _rglru_case(S, decays)
    hs, _ = rk.rglru_scan_plain(*_torch(x[:5]))
    ins = _torch(x)
    got = rk.rglru_scan_bwd_plain(*ins[:5], hs, *ins[5:])
    for name, g, w in zip(("dgr", "dgi", "dxc", "dsp", "dh0"), got, want):
        _close(g.numpy(), w, name)


def test_rglru_bwd_where_one_minus_a2_is_zero():
    """softplus(lam) = 1e-13 makes log a ~ -1e-12: a = 1 and exp(2 log a) =
    1 in f32, so 1 - a^2 = 0 and the sqrt's slope 0.5 / sqrt(0) is
    infinite.  jax.vjp of the reference's lines gives dgr = -inf or +inf
    (the sign of g i x) where the cotangent reaching the sqrt is non-zero,
    NaN where it is 0 (x = 0: 0 x inf), and dsp NaN where a channel's
    infinities meet with both signs; dgi and dxc are 0 there (the sqrt's
    value is 0) and dh0 finite.  The port's plain backward gives the same,
    element for element; elsewhere the usual 1e-5."""
    S, R = 6, 8
    x = list(rglru_inputs(S, 7, "drawn", B=2, R=R))
    x[3] = np.where(np.arange(R) % 2 == 0, 1e-13, x[3]).astype(F32)
    x[2][0, 2, 0] = 0.0
    hs, _ = rk.rglru_scan_plain(*_torch(x[:5]))
    ins = _torch(x)
    got = [g.numpy() for g in rk.rglru_scan_bwd_plain(*ins[:5], hs,
                                                      *ins[5:])]
    want = _rglru_ref_grads(x)
    singular = np.arange(R) % 2 == 0
    dgr = want[0]
    assert np.isinf(dgr[..., singular]).sum() == dgr[..., singular].size - 1
    assert np.isnan(dgr[0, 2, 0])
    assert np.isfinite(dgr[..., ~singular]).all()
    assert np.isnan(want[3][0])
    assert (want[1][..., singular] == 0).all()
    assert (want[2][..., singular] == 0).all()
    assert np.isfinite(want[4]).all()
    for name, g, w in zip(("dgr", "dgi", "dxc", "dsp", "dh0"), got, want):
        _close(g, w, name)


# ---------------------------------------------------------------------------------
# the autograd functions
# ---------------------------------------------------------------------------------

def test_wkv6_autograd_function_gradcheck_f64():
    rng = np.random.default_rng(3)
    B, S, H = 1, 5, 1
    x = [torch.from_numpy(a.astype(np.float64)).requires_grad_()
         for a in wkv_inputs(S, 3, "drawn", B=B, H=H)[:6]]
    x[3] = torch.from_numpy(rng.uniform(0.2, 1.0, (B, S, H, 64))) \
        .requires_grad_()
    assert torch.autograd.gradcheck(lambda *a: rk.WKV6Scan.apply(*a), x,
                                    eps=1e-6, atol=1e-6, fast_mode=True)


def test_rglru_autograd_function_gradcheck_f64():
    x = [torch.from_numpy(a.astype(np.float64)).requires_grad_()
         for a in rglru_inputs(7, 4, "drawn", B=2, R=5)[:5]]
    assert torch.autograd.gradcheck(lambda *a: rk.RGLRUScan.apply(*a), x,
                                    eps=1e-6, atol=1e-6, fast_mode=True)


def test_wrappers_differentiate_through_the_autograd_functions():
    """Under grad the wrappers run as WKV6Scan / RGLRUScan (their backward
    the plain backward for CPU tensors); without grad they return plain
    outputs; and the rg-lru's CPU gradients are finite."""
    x = _torch(wkv_inputs(4, 5, "drawn")[:6])
    y, _ = rk.wkv6_scan(*x)
    assert y.grad_fn is None
    x[0].requires_grad_()
    y, s_fin = rk.wkv6_scan(*x)
    assert "WKV6Scan" in type(y.grad_fn).__name__
    with torch.no_grad():
        assert rk.wkv6_scan(*x)[0].grad_fn is None
    rng = np.random.default_rng(5)
    gr, gi, xc = (torch.from_numpy(_rand(rng, 2, 6, 8)).requires_grad_()
                  for _ in range(3))
    hs, _ = rk.rglru_scan(gr, gi, xc, torch.rand(8), torch.zeros(2, 8))
    assert "RGLRUScan" in type(hs.grad_fn).__name__
    grads = torch.autograd.grad(hs.sum(), (gr, gi, xc))
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in grads)
    before = (rk.wkv6_scan_bwd.launches, rk.rglru_scan_bwd.launches)
    torch.autograd.grad(y.sum() + s_fin.sum(), x[0])
    assert (rk.wkv6_scan_bwd.launches, rk.rglru_scan_bwd.launches) == before
    from repro_torch.kernels import WRAPPERS
    assert rk.wkv6_scan_bwd in WRAPPERS and rk.rglru_scan_bwd in WRAPPERS


def test_bwd_wrappers_check_their_inputs():
    x = _torch(wkv_inputs(3, 6, "drawn"))
    with pytest.raises(ValueError, match="fit"):
        rk.wkv6_scan_bwd(*x[:6], x[6][:, :2], x[7])
    with pytest.raises(ValueError, match="fit"):
        rk.wkv6_scan_bwd(*x[:6], x[6], x[7][:1])
    y = _torch(rglru_inputs(3, 6, "drawn"))
    hs = torch.zeros_like(y[0])
    with pytest.raises(ValueError, match="fit"):
        rk.rglru_scan_bwd(*y[:5], hs[:, :2], *y[5:])
    with pytest.raises(ValueError, match="fit"):
        rk.rglru_scan_bwd(*y[:5], hs, y[5], y[6][:1])


# ---------------------------------------------------------------------------------
# the mixers' gradients against the reference's
# ---------------------------------------------------------------------------------

def _configs(arch):
    return (dataclasses.replace(get_config(arch, smoke=True),
                                compute_dtype=torch.float32),
            dataclasses.replace(ref_get_config(arch, smoke=True),
                                compute_dtype=jnp.float32))


def _grads_both(ref_fn, port_fn, p, x, state, cots):
    """Gradients of sum(out * cot) + sum(state' * cot') with respect to the
    weights, the input and the carried state, by jax.grad of the
    reference's function and by torch autograd of the port's."""
    def ref_loss(p, x, state):
        out, new = ref_fn(p, x, state)
        return jnp.sum(out * cots[0]) + sum(
            jnp.sum(new[k] * cots[1][k]) for k in sorted(new))

    want = jax.jit(jax.grad(ref_loss, argnums=(0, 1, 2)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        jax.tree.map(jnp.asarray, state))
    def leaf(a):
        return torch.from_numpy(np.array(a, F32)).requires_grad_()

    tp = {k: leaf(v) for k, v in p.items()}
    tx = leaf(x)
    ts = {k: leaf(v) for k, v in state.items()}
    out, new = port_fn(tp, tx, ts)
    loss = (out * torch.from_numpy(cots[0])).sum() + sum(
        (new[k] * torch.from_numpy(cots[1][k])).sum() for k in sorted(new))
    loss.backward()
    return want, ({k: v.grad for k, v in tp.items()}, tx.grad,
                  {k: v.grad for k, v in ts.items()})


def _compare_grads(want, got, tol=1e-4):
    """Every leaf within ``tol`` of its largest element (f32: the
    products around the scans sum in other orders than XLA's)."""
    wp, wx, ws = want
    gp, gx, gs = got
    for k in wp:
        _close(gp[k].numpy(), wp[k], f"d{k}", tol)
    _close(gx.numpy(), wx, "dx", tol)
    for k in ws:
        assert gs[k] is not None, f"no gradient for the state's {k}"
        _close(gs[k].numpy(), ws[k], f"dstate[{k}]", tol)


def test_rwkv_timemix_gradients_match_reference():
    """Weights, input and the carried state (S and x_prev, which require
    grad) through ``wkv6_scan``'s autograd function."""
    cfg, rcfg = _configs("rwkv6-7b")
    p = jax.tree.map(np.asarray,
                     ref_rec.rwkv_timemix_init(jax.random.PRNGKey(1), rcfg))
    rng = np.random.default_rng(1)
    p = dict(p, mu_x=_rand(rng, cfg.d_model, scale=0.3),
             mu=_rand(rng, 5, cfg.d_model, scale=0.3),
             w0=_rand(rng, cfg.d_model) - 2,
             gn_scale=1 + _rand(rng, cfg.d_model, scale=0.1))
    H, hd = rec.rwkv_heads(cfg)
    B, S = 2, 21
    x = _rand(rng, B, S, cfg.d_model)
    state = {"S": _rand(rng, B, H, hd, hd, scale=0.1),
             "x_prev": _rand(rng, B, cfg.d_model)}
    cots = (_rand(rng, B, S, cfg.d_model),
            {"S": _rand(rng, B, H, hd, hd), "x_prev": _rand(rng, B,
                                                            cfg.d_model)})
    want, got = _grads_both(
        lambda p, x, s: ref_rec.rwkv_timemix_forward(p, rcfg, x, s),
        lambda p, x, s: rec.rwkv_timemix_forward(p, cfg, x, s),
        p, x, state, cots)
    _compare_grads(want, got)


def test_rglru_block_gradients_match_reference():
    """Weights, input and the carried state (h and the conv window, which
    require grad) through ``rglru_scan``'s autograd function."""
    cfg, rcfg = _configs("recurrentgemma-9b")
    p = jax.tree.map(np.asarray,
                     ref_rec.rglru_block_init(jax.random.PRNGKey(2), rcfg))
    rng = np.random.default_rng(2)
    R, K = cfg.rnn_width, cfg.conv_kernel
    p = dict(p, conv_b=_rand(rng, R, scale=0.1), b_r=_rand(rng, R),
             b_i=_rand(rng, R), lam=_rand(rng, R) + 2,
             w_r=_rand(rng, R, R, scale=0.3), w_i=_rand(rng, R, R, scale=0.3))
    B, S = 2, 37
    x = _rand(rng, B, S, cfg.d_model)
    state = {"h": _rand(rng, B, R), "conv": _rand(rng, B, K - 1, R)}
    cots = (_rand(rng, B, S, cfg.d_model),
            {"h": _rand(rng, B, R), "conv": _rand(rng, B, K - 1, R)})
    want, got = _grads_both(
        lambda p, x, s: ref_rec.rglru_block_forward(p, rcfg, x, s),
        lambda p, x, s: rec.rglru_block_forward(p, cfg, x, s),
        p, x, state, cots)
    _compare_grads(want, got)


# ---------------------------------------------------------------------------------
# bf16 loss and gradients of the two recurrent archs
# ---------------------------------------------------------------------------------

LB, LS = 2, 24


def _loss_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (LB, LS), dtype=np.int32)}


def _ref_loss_grads(arch, batch, dtype):
    rcfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                               compute_dtype=dtype)
    rapi = ref_build_model(rcfg)
    tree = jax.jit(rapi.init)(jax.random.PRNGKey(0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(rapi.loss, has_aux=True))(
        tree, jb)
    return tree, float(loss), grads


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


def _port_flat(cfg, grads) -> np.ndarray:
    """The port's gradient tree in the reference's leaf order (its
    per-layer lists stacked on a leading axis)."""
    def np_tree(t):
        if isinstance(t, torch.Tensor):
            return t.detach().float().numpy()
        return {k: np_tree(v) for k, v in t.items()}

    out = {}
    for key, val in grads.items():
        if key in layer_stacks(cfg):
            out[key] = jax.tree.map(lambda *xs: np.stack(xs),
                                    *[np_tree(layer) for layer in val])
        else:
            out[key] = np_tree(val)
    return _flat(out)


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-9b"])
def test_recurrent_loss_and_grads_bf16_by_the_reference_rule(arch):
    """``test_torch_loss.py``'s bf16 rule for the recurrent archs, whose
    scans now differentiate through their autograd functions: bf16 compute
    over the reference's f32 master, the loss no further from the
    reference's f32 loss than the reference's own bf16 loss is, plus 8e-2;
    the gradient tree within twice the reference's own bf16 error, plus
    8e-2 (relative)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=torch.bfloat16)
    batch = _loss_batch(cfg)
    tree, want, g32 = _ref_loss_grads(arch, batch, jnp.float32)
    _, own_loss, g16 = _ref_loss_grads(arch, batch, jnp.bfloat16)
    master = load_reference_master(cfg, jax.tree.map(np.asarray, tree),
                                   device="cpu")
    api = build_model(cfg, device="cpu")
    (loss, _), grads = value_and_grad(
        api, master, {k: torch.from_numpy(v) for k, v in batch.items()})
    own = abs(own_loss - want) / abs(want)
    assert abs(float(loss) - want) / abs(want) <= own + 8e-2
    assert all(g.dtype == torch.float32 for g in tree_leaves(grads))
    got, ref32, ref16 = _port_flat(cfg, grads), _flat(g32), _flat(g16)
    rel, ref_rel = _rel(got, ref32), _rel(ref16, ref32)
    assert rel <= 2 * ref_rel + 8e-2, (f"{arch}: relative error {rel} from "
                                       f"the f32 gradients; the reference's "
                                       f"bf16 {ref_rel}")


# ---------------------------------------------------------------------------------
# numpy models of the backward kernels' order of sums
# ---------------------------------------------------------------------------------

def fma(a, b, c):
    """a b + c rounded once to f32 (the product is exact in f64)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F32)


def tf32(x):
    """x cut to TF32: its 13 low mantissa bits cleared (the split's hi
    part, and what the tensor cores read of any operand)."""
    return (np.asarray(x, F32).view(np.uint32)
            & np.uint32(0xffffe000)).view(F32)


def split_mm(a, b, split_a=True, split_b=True):
    """a @ b as the kernel's tensor-core products: each operand cut into
    TF32 hi and lo (lo = tf32(x - hi), as the tensor cores read it), the
    terms lo.hi + hi.lo and hi.hi each a product in f32 (a lo term left out
    where its operand is exact in TF32), summed in f32."""
    a, b = np.asarray(a, F32), np.asarray(b, F32)
    ah, bh = tf32(a), tf32(b)
    out = np.matmul(ah, bh)
    lo = np.zeros_like(out)
    if split_a:
        lo = (lo + np.matmul(tf32(a - ah), bh)).astype(F32)
    if split_b:
        lo = (lo + np.matmul(ah, tf32(b - bh))).astype(F32)
    return (lo + out).astype(F32)


def _chunk(x, c, S, fill):
    """Steps c L .. c L + L - 1 of x [B, S, H, 64] as [B, H, L, 64], the
    steps past S ``fill``."""
    t0 = c * WB_L
    part = np.full(x.shape[:1] + (WB_L,) + x.shape[2:], fill, F32)
    part[:, :min(WB_L, S - t0)] = x[:, t0:t0 + WB_L]
    return np.moveaxis(part, 1, 2)


def wkv_decay_model(k, w):
    """K = k_s E_s and D of a chunk ([B, H, L, 64] each), E by multiplying
    from the chunk's end (``wb_decay``)."""
    e = np.ones(k.shape[:2] + k.shape[3:], F32)
    ke = np.empty_like(k)
    for s in reversed(range(WB_L)):
        ke[:, :, s] = (k[:, :, s] * e).astype(F32)
        e = (e * w[:, :, s]).astype(F32)
    return ke, e


def wkv_forward_model(state, k, v, w):
    """One chunk forward (``wb_forward``): D . S + split-TF32 K^T V."""
    ke, dl = wkv_decay_model(k, w)
    upd = split_mm(np.swapaxes(ke, -1, -2), v)
    return fma(dl[..., None], state, upd)


def wkv_rows_model(r, k, w, u):
    """A (with u on the diagonal) and Q = r . D_{t-1} of a chunk as the
    row walk (``wb_rows``) and the cross-half product give them: within
    each half chunk q = r_t gains a factor w_s a step as s walks down, each
    A[t, s] a sum over the 64 channels in f32; an upper row's walk ends at
    Q_hi = r_t prod_{8..t-1} w, and Q = Q_hi prod_{0..7} w; A[hi, lo] =
    Q_hi K_lo^T as split TF32 (K_lo = k_s prod_{s+1..7} w)."""
    B, H = r.shape[:2]
    a = np.zeros((B, H, WB_L, WB_L), F32)
    q = np.empty_like(r)
    qh = np.empty_like(r[:, :, :WB_H])
    for t in range(WB_L):
        a[:, :, t, t] = ((r[:, :, t] * u).astype(F32)
                         * k[:, :, t]).astype(F32).sum(-1, dtype=F32)
        qt = r[:, :, t].copy()
        for s in reversed(range(0 if t < WB_H else WB_H, t)):
            a[:, :, t, s] = (qt * k[:, :, s]).astype(F32).sum(-1, dtype=F32)
            qt = (qt * w[:, :, s]).astype(F32)
        if t >= WB_H:
            qh[:, :, t - WB_H] = qt
            wl = np.ones_like(qt)
            for s in range(WB_H):
                wl = (wl * w[:, :, s]).astype(F32)
            qt = (qt * wl).astype(F32)
        q[:, :, t] = qt
    el = np.empty_like(r[:, :, :WB_H])
    e = np.ones(r.shape[:2] + r.shape[3:], F32)
    for s in reversed(range(WB_H)):
        el[:, :, s] = e
        e = (e * w[:, :, s]).astype(F32)
    kl = (k[:, :, :WB_H] * el).astype(F32)
    a[:, :, WB_H:, :WB_H] = split_mm(qh, np.swapaxes(kl, -1, -2))
    return a, q


def wkv_walk_model(r, k, w, u, c, dq, dk_raw, rd):
    """The walk of a chunk at every channel (``wb_walk``), every decay
    product by forward multiplication (prefix D_{t-1}, suffix E_t, Horner
    over the later steps).  The sums over pairs of steps walk within each
    half chunk (the Z walk with dr and dw's last term; dk's sum); the pairs
    across the halves, where P_{s,t} = El_s Dh_{t-1}, go through the
    split-TF32 products U = C[hi, lo] K_lo and V = C[hi, lo]^T Q_hi and a
    walk of one factor a step.  Then du's part and dw's other three terms.
    r, k, w, dq, dk_raw [B, H, L, 64], c [B, H, L, L] (C[tau, s] = dy_tau .
    v_s), rd [B, H, 64]."""
    B, H = r.shape[:2]
    sh = (B, H, 64)
    lo, hi = range(WB_H), range(WB_H, WB_L)
    el, dh = np.empty_like(r[:, :, :WB_H]), np.empty_like(r[:, :, :WB_H])
    e = np.ones(sh, F32)
    for s in reversed(lo):                              # El_s, s < 8
        el[:, :, s] = e
        e = (e * w[:, :, s]).astype(F32)
    d = np.ones(sh, F32)
    for t in hi:                                        # Dh_{t-1}, t >= 8
        dh[:, :, t - WB_H] = d
        d = (d * w[:, :, t]).astype(F32)
    c_hl = c[:, :, WB_H:, :WB_H]
    uu = split_mm(c_hl, (k[:, :, :WB_H] * el).astype(F32))
    vv = split_mm(np.swapaxes(c_hl, -1, -2),
                  (r[:, :, WB_H:] * dh).astype(F32))
    cc = c[..., None]                                   # [B, H, tau, s, 1]
    dr, dk, dw = (np.empty_like(r) for _ in range(3))
    t4 = np.empty_like(r)
    pre = np.ones(sh, F32)
    for half in (lo, hi):
        z = np.zeros_like(r)                            # Z_tau in the half
        for t in half:
            acc = np.zeros(sh, F32)
            for tau in reversed(range(t + 1, half.stop)):
                acc = fma(w[:, :, tau], acc, (r[:, :, tau] * z[:, :, tau])
                          .astype(F32))
            t4[:, :, t] = acc
            zt = z[:, :, t] if t < WB_H else fma(dh[:, :, t - WB_H],
                                                 uu[:, :, t - WB_H],
                                                 z[:, :, t])
            dr[:, :, t] = fma((u * k[:, :, t]).astype(F32), cc[:, :, t, t],
                              fma(pre, dq[:, :, t], zt))
            for tau in range(t + 1, half.stop):
                z[:, :, tau] = fma(w[:, :, t], z[:, :, tau],
                                   (cc[:, :, tau, t] * k[:, :, t])
                                   .astype(F32))
            pre = (pre * w[:, :, t]).astype(F32)
    x = np.zeros(sh, F32)
    for t in lo:
        t4[:, :, t] = fma(el[:, :, t], x, t4[:, :, t])
        x = fma(w[:, :, t], x, (k[:, :, t] * vv[:, :, t]).astype(F32))
    y = np.zeros(sh, F32)
    for t in reversed(hi):
        t4[:, :, t] = fma(dh[:, :, t - WB_H], y, t4[:, :, t])
        y = fma(w[:, :, t], y, (r[:, :, t] * uu[:, :, t - WB_H]).astype(F32))
    suf = np.empty_like(r)
    y = np.empty_like(r)
    suf[:, :, -1] = 1.0
    for t in reversed(range(WB_L - 1)):
        suf[:, :, t] = (suf[:, :, t + 1] * w[:, :, t + 1]).astype(F32)
    y[:, :, -1] = 0.0
    for t in reversed(range(1, WB_L)):
        y[:, :, t - 1] = fma(w[:, :, t], y[:, :, t],
                             (r[:, :, t] * dq[:, :, t]).astype(F32))
    du = np.zeros(sh, F32)
    x = np.zeros(sh, F32)
    pre = np.ones(sh, F32)
    for t in range(WB_L):
        acc = np.zeros(sh, F32)
        for tau in reversed(range(t + 1, WB_H if t < WB_H else WB_L)):
            acc = fma(w[:, :, tau], acc, (cc[:, :, tau, t] * r[:, :, tau])
                      .astype(F32))
        if t < WB_H:
            acc = fma(el[:, :, t], vv[:, :, t], acc)
        ct = cc[:, :, t, t]
        dk[:, :, t] = fma((r[:, :, t] * u).astype(F32), ct,
                          fma(suf[:, :, t], dk_raw[:, :, t], acc))
        du = fma((r[:, :, t] * k[:, :, t]).astype(F32), ct, du)
        part = fma((suf[:, :, t] * pre).astype(F32), rd,
                   fma(suf[:, :, t], x, (pre * y[:, :, t]).astype(F32)))
        dw[:, :, t] = (part + t4[:, :, t]).astype(F32)
        x = fma(w[:, :, t], x, (k[:, :, t] * dk_raw[:, :, t]).astype(F32))
        pre = (pre * w[:, :, t]).astype(F32)
    return dr, dk, dw, du


def wkv_bwd_model(r, k, v, w, u, s0, dy, ds_fin, seg=None):
    """``wkv6_bwd_kernel`` and du's sum over the batch, in their order.  A
    first pass forward keeps the state at each segment's start (every
    ``seg`` chunks of WB_L steps); each segment from the last is rebuilt
    forward from its checkpoint and walked back a chunk at a time: C,
    dQraw, dKraw, dV and the adjoint's step as split TF32 products
    (`split_mm`), rd a row's sum, A and Q by the row walk, then the walk at
    each channel (`wkv_walk_model`); dv whole within the (b, h); du over a
    (b, h)'s chunks from the last, then the batch in order.  Steps past S:
    r = k = v = dy = 0, w = 1."""
    seg = seg or WB_M
    B, S, H, hd = r.shape
    r, k, v = (x.astype(F32) for x in (r, k, v))
    uu = u.astype(F32)[None]                            # [1, H, 64]
    nch = -(-S // WB_L)
    nseg = -(-nch // seg)

    def chunk(c):
        return (_chunk(r, c, S, 0.0), _chunk(k, c, S, 0.0),
                _chunk(v, c, S, 0.0), _chunk(w, c, S, 1.0),
                _chunk(dy, c, S, 0.0))

    checkpoints, kept = {0: s0.astype(F32)}, {}
    state = s0.astype(F32)
    for c in range(nch):
        if c % seg == 0:
            checkpoints[c // seg] = state
        if c >= (nseg - 1) * seg:
            kept[c] = state
        if c + 1 < nch:
            _, kc, vc, wc, _ = chunk(c)
            state = wkv_forward_model(state, kc, vc, wc)
    g = ds_fin.astype(F32)                              # [B, H, i, j]
    dr, dk, dv, dw = (np.zeros((B, S, H, hd), F32) for _ in range(4))
    du_acc = np.zeros((B, H, hd), F32)
    for sg in reversed(range(nseg)):
        chunks = range(sg * seg, min(nch, (sg + 1) * seg))
        if sg == nseg - 1:
            states = kept
        else:
            states, state = {}, checkpoints[sg]
            for c in chunks:
                states[c] = state
                if c + 1 < chunks.stop:
                    _, kc, vc, wc, _ = chunk(c)
                    state = wkv_forward_model(state, kc, vc, wc)
        for c in reversed(chunks):
            rc, kc, vc, wc, yc = chunk(c)
            s_in = states[c]
            ke, dl = wkv_decay_model(kc, wc)
            a, q = wkv_rows_model(rc, kc, wc, uu)
            cm = split_mm(yc, np.swapaxes(vc, -1, -2))
            dq = split_mm(yc, np.swapaxes(s_in, -1, -2))
            dkr = split_mm(vc, np.swapaxes(g, -1, -2))
            rd = (g * s_in).astype(F32).sum(-1, dtype=F32)
            dvc = (split_mm(np.swapaxes(a, -1, -2), yc)
                   + split_mm(ke, g)).astype(F32)
            g = fma(dl[..., None], g, split_mm(np.swapaxes(q, -1, -2), yc))
            drc, dkc, dwc, du_c = wkv_walk_model(rc, kc, wc, uu, cm, dq,
                                                 dkr, rd)
            du_acc = (du_acc + du_c).astype(F32)
            n = min(WB_L, S - c * WB_L)
            sl = slice(c * WB_L, c * WB_L + n)
            for out, part in ((dr, drc), (dk, dkc), (dv, dvc), (dw, dwc)):
                out[:, sl] = np.moveaxis(part, 2, 1)[:, :n]
    du = du_acc[0] if B else np.zeros((H, hd), F32)
    for b in range(1, B):
        du = (du + du_acc[b]).astype(F32)
    return dr, dk, dv, dw, du, g


def _exp(x):
    """expf rounded from f64 (numpy's own f32 exp strays further from
    the correctly rounded value than the card's expf and PyTorch's do,
    and 1 - exp(2 log a) magnifies that near a = 1)."""
    return np.exp(np.asarray(x, np.float64)).astype(F32)


def _sigmoid(x):
    return (F32(1) / (F32(1) + _exp(-x.astype(F32)))).astype(F32)


def rglru_step_model(gr, gi, x, soft, g, hp):
    """One step's gates and cotangents as ``rglru_step_grads``."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        r, i = _sigmoid(gr), _sigmoid(gi)
        c = (F32(-8) * r).astype(F32)
        log_a = (c * soft).astype(F32)
        a = _exp(log_a)
        e = _exp((F32(2) * log_a).astype(F32))
        omz = (F32(1) - e).astype(F32)
        h1 = np.maximum(omz, F32(0))
        z = np.minimum(h1, F32(1))
        sq = np.sqrt(z).astype(F32)
        ix = (i * x).astype(F32)
        ct_sq, ct_ix = (g * ix).astype(F32), (g * sq).astype(F32)
        ct_z = (ct_sq * (F32(0.5) / sq).astype(F32)).astype(F32)
        dmin = np.where(h1 == z, np.where(z == 1, F32(0.5), F32(1)), F32(0))
        dmax = np.where(omz == h1, np.where(h1 == 0, F32(0.5), F32(1)),
                        F32(0))
        ct_omz = ((ct_z * dmin).astype(F32) * dmax).astype(F32)
        ct_log_a = ((g * hp).astype(F32) * a
                    + ((-ct_omz * e).astype(F32) * F32(2))).astype(F32)
        dgr = ((ct_log_a * soft * F32(-8)).astype(F32)
               * (r * (F32(1) - r)).astype(F32)).astype(F32)
        dsp = (ct_log_a * c).astype(F32)
        dgi = ((ct_ix * x).astype(F32) * (i * (F32(1) - i))).astype(F32)
        dx = (ct_ix * i).astype(F32)
    return a, dgr, dgi, dx, dsp


def rglru_bwd_model(gr, gi, xc, sp, h0, hs, dhs, dh_last):
    """``rglru_bwd_kernel`` and dsp's sum over the batch, in their order:
    chunks of RB_SLICES x RB_STEPS steps from the last; each slice's map
    x -> P x + Q (P = ((a3 a2) a1) a0, Q = a0 (d0 + a1 (d1 + ...)), a step
    past S the identity); the later chunks' adjoint carried through the
    slices after a slice by fma (its carry-in) and through all of them
    (into the chunk before); then the slice's steps, g = dhs + carry, the
    carry a g; dsp over a thread's steps in that order, then the CTA's
    slices in order, then the batch in order; dh0 the carry out of the
    first chunk."""
    B, S, R = xc.shape
    x = xc.astype(F32)
    h_prev = np.concatenate([h0[:, None], hs[:, :-1]], 1) if S else hs
    dgr, dgi, dx = (np.zeros((B, S, R), F32) for _ in range(3))
    dsp_acc = np.zeros((RB_SLICES, B, R), F32)
    carry = dh_last.astype(F32).copy()
    for ch in reversed(range(-(-S // RB_CHUNK))):
        steps = np.arange(ch * RB_CHUNK, (ch + 1) * RB_CHUNK).reshape(
            RB_SLICES, RB_STEPS)
        inside = steps < S
        ts = np.minimum(steps, S - 1)
        a, d = np.ones((RB_SLICES, RB_STEPS, B, R), F32), \
            np.zeros((RB_SLICES, RB_STEPS, B, R), F32)
        for kk in range(RB_SLICES):
            for e in range(RB_STEPS):
                if inside[kk, e]:
                    t = ts[kk, e]
                    a[kk, e] = rglru_step_model(gr[:, t], gi[:, t], x[:, t],
                                                sp, np.zeros_like(sp),
                                                np.zeros_like(sp))[0]
                    d[kk, e] = dhs[:, t]
        pp, pq = a[:, -1].copy(), (a[:, -1] * d[:, -1]).astype(F32)
        for e in range(RB_STEPS - 2, -1, -1):
            pq = (a[:, e] * (d[:, e] + pq).astype(F32)).astype(F32)
            pp = (pp * a[:, e]).astype(F32)
        ck = np.zeros((RB_SLICES, B, R), F32)
        for m in range(RB_SLICES - 1, -1, -1):
            ck[m] = carry
            carry = fma(pp[m], carry, pq[m])
        for kk in range(RB_SLICES):
            c_in = ck[kk]
            for e in range(RB_STEPS - 1, -1, -1):
                g = (d[kk, e] + c_in).astype(F32)
                if inside[kk, e]:
                    t = ts[kk, e]
                    _, g_r, g_i, g_x, g_sp = rglru_step_model(
                        gr[:, t], gi[:, t], x[:, t], sp, g, h_prev[:, t])
                    dgr[:, t], dgi[:, t], dx[:, t] = g_r, g_i, g_x
                    dsp_acc[kk] = (dsp_acc[kk] + g_sp).astype(F32)
                c_in = (a[kk, e] * g).astype(F32)
    per_b = dsp_acc[0]
    for m in range(1, RB_SLICES):
        per_b = (per_b + dsp_acc[m]).astype(F32)
    dsp = per_b[0] if B else np.zeros(R, F32)
    for b in range(1, B):
        dsp = (dsp + per_b[b]).astype(F32)
    return dgr, dgi, dx, dsp, carry


@pytest.mark.parametrize("decays", ["drawn", "extreme"])
@pytest.mark.parametrize("S", WKV_S)
def test_wkv_bwd_model_matches_plain_and_reference(S, decays):
    x, ref = _wkv_case(S, decays)
    model = wkv_bwd_model(*x)
    plain = rk.wkv6_scan_bwd_plain(*_torch(x))
    for name, m, p, w in zip(("dr", "dk", "dv", "dw", "du", "ds0"), model,
                             plain, ref):
        _close(m, p.numpy(), f"{name} model against plain")
        _close(m, w, f"{name} model against the reference")


@pytest.mark.parametrize("decays", ["drawn", "extreme"])
@pytest.mark.parametrize("S", _s_cases(32))
def test_rglru_bwd_model_matches_plain_and_reference(S, decays):
    x, ref = _rglru_case(S, decays)
    hs, _ = rk.rglru_scan_plain(*_torch(x[:5]))
    model = rglru_bwd_model(*x[:5], hs.numpy(), *x[5:])
    ins = _torch(x)
    plain = rk.rglru_scan_bwd_plain(*ins[:5], hs, *ins[5:])
    for name, m, p, w in zip(("dgr", "dgi", "dxc", "dsp", "dh0"), model,
                             plain, ref):
        _close(m, p.numpy(), f"{name} model against plain")
        _close(m, w, f"{name} model against the reference")
