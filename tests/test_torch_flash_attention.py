"""The port's flash-attention kernel K4 (its plain PyTorch version) against
the JAX reference: the causal, windowed and bidirectional forms, and the
prefix-LM form against the reference's masked ``_gqa_attend`` and its
query-chunked ``_gqa_attend_chunked``, whose place K4 takes.

The reference's Pallas kernel does not trace on every jax version, so the
oracles are the reference's own: ``repro.kernels.ref.mha_ref`` (the
unblocked oracle of ``test_kernels.py``) and the model's XLA attention
``repro.models.attention._gqa_attend``.  Inputs come from numpy seeds and go
to both packages.  Tolerances are the reference tests': 2e-5 in f32 and
2.5e-2 in bf16 (the oracle rounds the scores to bf16, the kernel keeps them
in f32), 3e-2 against the model's attention.

The CUDA kernel runs only on a GPU; ``chip_smoke.py`` holds it against this
plain version there.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.kernels.ref import mha_ref as jax_mha_ref  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ref import mha_ref  # noqa: E402

#: the five shapes of the reference's test_kernels.py
SHAPES = [
    # B, H, K, Sq, Sk, d, causal, window
    (2, 4, 2, 128, 128, 32, True, None),
    (1, 4, 1, 200, 200, 16, True, None),      # MQA + ragged edge
    (2, 2, 2, 96, 96, 64, True, 32),          # sliding window
    (1, 8, 4, 64, 256, 32, False, None),      # bidirectional, Sq != Sk
    (1, 2, 2, 257, 257, 16, True, 100),       # odd lengths + window
]
DTYPES = {"f32": (torch.float32, jnp.float32, 2e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, 2.5e-2)}


def _inputs(shape, seed=0):
    B, H, K, Sq, Sk, d = shape[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, d)),
            rng.standard_normal((B, K, Sk, d)),
            rng.standard_normal((B, K, Sk, d)))


def _both(arrays, dtype):
    tdt, jdt, _ = DTYPES[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in arrays],
            [jnp.asarray(a, jdt) for a in arrays])


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s[:6]) for s in SHAPES])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_reference_mha_ref(shape, dtype):
    causal, window = shape[6], shape[7]
    window = window if causal else None      # mha_ref's window needs causal
    (q, k, v), (jq, jk, jv) = _both(_inputs(shape), dtype)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = jax_mha_ref(jq, jk, jv, causal=causal, window=window)
    tol = DTYPES[dtype][2]
    assert out.dtype == q.dtype and out.shape == q.shape
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s[:6]) for s in SHAPES])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_mha_ref_matches_reference(shape, dtype):
    """The port's unblocked oracle rounds where the reference's does."""
    causal, window = shape[6], shape[7]
    window = window if causal else None
    (q, k, v), (jq, jk, jv) = _both(_inputs(shape, seed=1), dtype)
    got = mha_ref(q, k, v, causal=causal, window=window)
    want = jax_mha_ref(jq, jk, jv, causal=causal, window=window)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_plain_matches_model_attention():
    """K4 in place of the model's XLA attention path (einsum + softmax), in
    f32 as the reference's test_flash_attention_matches_model_attention."""
    cfg = ref_get_config("llama3.2-1b", smoke=True)
    rng = np.random.default_rng(2)
    B, S = 2, 64
    x = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)),
                    cfg.compute_dtype)
    p = ref_attn.attn_init(jax.random.PRNGKey(0), cfg)
    q, k, v = ref_attn._project_qkv(p, cfg, x)
    q, k, v = (t.astype(jnp.float32) for t in (q, k, v))
    xla = ref_attn._gqa_attend(p, cfg, q, k, v,
                               ref_attn.make_mask(S, S, causal=True))
    tq, tk, tv = (torch.from_numpy(np.array(t)).transpose(1, 2)
                  for t in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=True)
    wo = torch.from_numpy(np.asarray(p["wo"].astype(cfg.compute_dtype),
                                     np.float32))
    flash_out = torch.einsum("bhsd,hde->bse", out, wo)
    np.testing.assert_allclose(flash_out.numpy(), np.asarray(xla, np.float32),
                               atol=3e-2, rtol=3e-2)


def test_port_attention_forward_matches_reference():
    """The port's attn_forward (causal: through K4) against the reference's
    attn_forward on the same weights, f32 compute."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn

    rcfg = dataclasses.replace(ref_get_config("llama3.2-1b", smoke=True),
                               compute_dtype=jnp.float32)
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              compute_dtype=torch.float32)
    rng = np.random.default_rng(3)
    B, S = 2, 100
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    p = ref_attn.attn_init(jax.random.PRNGKey(1), rcfg)
    pos = np.arange(S, dtype=np.int32)[None]
    want, (wk, _) = ref_attn.attn_forward(
        p, rcfg, jnp.asarray(x), positions=jnp.asarray(pos),
        mask=ref_attn.make_mask(S, S, causal=True))
    tp = {n: torch.from_numpy(np.array(t)) for n, t in p.items()}
    got, (gk, _) = attn.attn_forward(tp, cfg, torch.from_numpy(x),
                                     positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=1e-5,
                               rtol=1e-5)


def test_block_shape_invariance():
    """The result does not depend on the tiling (f32)."""
    q, k, v = (torch.from_numpy(a).float()
               for a in _inputs((1, 2, 2, 160, 160, 32), seed=5))
    outs = [fa.flash_attention_plain(q, k, v, block_q=bq, block_k=bk)
            for bq, bk in [(32, 32), (64, 32), (32, 64), (128, 128),
                           (128, 64)]]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fully_masked_first_tile(dtype):
    """A window whose first KV tile is fully masked for some rows: the
    finite sentinel keeps the garbage of that tile finite, and the next
    real tile erases it (alpha = exp(-1e30 - m) = 0)."""
    shape = (1, 4, 2, 300, 300, 16)
    window = 30
    # q block 128..191 starts its loop at tile 64, which rows >= 158 see
    # fully masked
    assert fa._kv_range(128, 300, True, window, 64, 64) == (64, 192)
    (q, k, v), (jq, jk, jv) = _both(_inputs(shape, seed=7), dtype)
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    assert bool(torch.isfinite(out).all())
    want = jax_mha_ref(jq, jk, jv, causal=True, window=window)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_strided_views_equal_contiguous():
    """The model hands K4 [B, H, S, d] views of [B, S, H, d] projections."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 70, 4, 16))).float()
    kv = torch.from_numpy(rng.standard_normal((2, 70, 2, 16))).float()
    got = ops.flash_attention(x.transpose(1, 2), kv.transpose(1, 2),
                              kv.transpose(1, 2))
    want = ops.flash_attention(x.transpose(1, 2).contiguous(),
                               kv.transpose(1, 2).contiguous(),
                               kv.transpose(1, 2).contiguous())
    assert torch.equal(got, want)
    assert got.is_contiguous()


def _qkv(B=1, H=4, K=2, S=8, d=16, dtype=torch.float32):
    return (torch.zeros(B, H, S, d, dtype=dtype),
            torch.zeros(B, K, S, d, dtype=dtype),
            torch.zeros(B, K, S, d, dtype=dtype))


@pytest.mark.parametrize("case", [
    "rank", "dtype", "mixed_dtype", "kv_shape", "heads", "head_dim",
    "window", "device", "prefix"])
def test_wrapper_validation_errors(case):
    q, k, v = _qkv()
    kw = {}
    if case == "rank":
        q = q[0]
    elif case == "dtype":
        q, k, v = _qkv(dtype=torch.float16)
    elif case == "mixed_dtype":
        k = k.to(torch.bfloat16)
    elif case == "kv_shape":
        v = v[:, :, :4]
    elif case == "heads":
        q, k, v = _qkv(H=3, K=2)
    elif case == "head_dim":
        k = torch.zeros(1, 2, 8, 32)
        v = k.clone()
    elif case == "window":
        kw = {"window": 0}
    elif case == "prefix":
        kw = {"prefix_len": -1}
    elif case == "device":
        q = q.to("meta")
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("case", ["head_dim", "alignment", "grid"])
def test_kernel_input_checks(case):
    """What the CUDA launch refuses (checked before any launch)."""
    if case == "head_dim":
        q, k, v = _qkv(d=8)
    elif case == "alignment":
        q, k, v = _qkv(d=16)
        q = torch.zeros(1, 4, 8, 17)[..., 1:]      # rows 68 bytes apart
    else:
        q, k, v = _qkv(B=16384, H=4, K=1, S=1)
    with pytest.raises(ValueError):
        fa.check_kernel_inputs(q, k, v)
    fa.check_kernel_inputs(*_qkv(d=64))             # the main path's inputs


def test_cpu_tensors_never_launch():
    before = fa.flash_attention.launches
    ops.flash_attention(*_qkv())
    assert fa.flash_attention.launches == before


# ---------------------------------------------------------------------------------
# the prefix-LM form (paligemma's mask), against the reference's attention
# ---------------------------------------------------------------------------------

#: B, H, K, S: a GQA shape whose length is a multiple of the reference's
#: query chunk (16) and not of any block of the kernel
PREFIX_SHAPE = (2, 4, 2, 112)
PREFIXES = (1, 5, 100, 200)             # 200 > S: every position a prefix
HEAD_DIMS = (16, 64, 256)


def _identity_wo(H, d, jdt):
    """wo [H, d, H d] that leaves the heads' outputs as they are, so that
    the reference's ``_gqa_attend`` returns the attention itself."""
    return jnp.eye(H * d, dtype=jdt).reshape(H, d, H * d)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("prefix", PREFIXES)
def test_plain_prefix_matches_reference_attention(prefix, window, d, dtype):
    """``flash_attention_plain(prefix_len=)`` against the reference's model
    attention under ``make_mask(prefix_len=)`` and its query-chunked
    ``_gqa_attend_chunked`` (chunk 16), which K4 takes the place of; the
    port's ``mha_ref`` too.  Reference tests' tolerances."""
    B, H, K, S = PREFIX_SHAPE
    tdt, jdt, tol = DTYPES[dtype]
    rcfg = dataclasses.replace(ref_get_config("llama3.2-1b", smoke=True),
                               compute_dtype=jdt)
    (q, k, v), (jq, jk, jv) = _both(_inputs((B, H, K, S, S, d), seed=prefix),
                                    dtype)
    p = {"wo": _identity_wo(H, d, jdt)}
    # the model's layout: [B, S, heads, d]
    mq, mk, mv = (jnp.swapaxes(t, 1, 2) for t in (jq, jk, jv))
    mask = ref_attn.make_mask(S, S, causal=True, window=window,
                              prefix_len=prefix)
    want = np.asarray(ref_attn._gqa_attend(p, rcfg, mq, mk, mv, mask),
                      np.float32).reshape(B, S, H, d).transpose(0, 2, 1, 3)
    chunked = np.asarray(ref_attn._gqa_attend_chunked(
        p, rcfg, mq, mk, mv, chunk=16, causal=True, window=window,
        prefix_len=prefix), np.float32).reshape(B, S, H, d).transpose(
            0, 2, 1, 3)
    out = fa.flash_attention_plain(q, k, v, causal=True, window=window,
                                   prefix_len=prefix)
    assert out.dtype == tdt and out.shape == (B, H, S, d)
    got = out.float().numpy()
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, chunked, atol=tol, rtol=tol)
    oracle = mha_ref(q, k, v, causal=True, window=window, prefix_len=prefix)
    np.testing.assert_allclose(oracle.float().numpy(), want, atol=tol,
                               rtol=tol)


def test_prefix_is_ignored_without_the_causal_mask():
    """As in ``make_mask``: a bidirectional mask allows every key already."""
    q, k, v = (torch.from_numpy(a).float()
               for a in _inputs((1, 2, 1, 40, 50, 16), seed=8))
    assert torch.equal(
        fa.flash_attention_plain(q, k, v, causal=False, prefix_len=7),
        fa.flash_attention_plain(q, k, v, causal=False))
    assert fa._prefix(False, 7) == 0 and fa._prefix(True, None) == 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("block", [(64, 64), (128, 32), (128, 128)])
def test_prefix_at_the_kernel_tiling(block, dtype):
    """Ragged P against the kernel's blocks (f32 64 x 64; bf16 128 rows
    and KV tiles of 32 at d 256 or 128), P = 1 and P beyond S: the plain
    version at that tiling equals the reference's unblocked masked
    attention."""
    bq, bk = block
    tdt, jdt, tol = DTYPES[dtype]
    B, H, K, S, d = 1, 2, 1, 300, 16
    rcfg = dataclasses.replace(ref_get_config("llama3.2-1b", smoke=True),
                               compute_dtype=jdt)
    (q, k, v), (jq, jk, jv) = _both(_inputs((B, H, K, S, S, d), seed=9),
                                    dtype)
    p = {"wo": _identity_wo(H, d, jdt)}
    mq, mk, mv = (jnp.swapaxes(t, 1, 2) for t in (jq, jk, jv))
    for prefix, window in ((1, None), (100, None), (100, 40), (129, 50),
                           (310, None)):
        mask = ref_attn.make_mask(S, S, causal=True, window=window,
                                  prefix_len=prefix)
        want = np.asarray(ref_attn._gqa_attend(p, rcfg, mq, mk, mv, mask),
                          np.float32).reshape(B, S, H, d).transpose(0, 2, 1,
                                                                    3)
        got = fa.flash_attention_plain(q, k, v, causal=True, window=window,
                                       prefix_len=prefix, block_q=bq,
                                       block_k=bk)
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=tol, err_msg=f"P {prefix} w {window}")


def _allowed(rows, cols, sk, causal, window, prefix):
    """The reference's make_mask, elementwise, with keys past Sk masked."""
    r = np.arange(rows)[:, None]
    c = np.arange(cols)[None, :]
    m = np.ones((rows, cols), bool)
    if causal:
        m = c <= r
        if window:
            m &= (r - c) < window
        if prefix:
            m |= (r < prefix) & (c < prefix)
    elif window:
        m = (r - c) < window
    return m & (c < sk)


@pytest.mark.parametrize("causal,window,prefix", [
    (True, None, 256), (True, None, 100), (True, None, 1), (True, 70, 100),
    (True, 30, 129), (True, None, 2000), (True, 100, None),
    (False, None, 100), (False, 70, None)])
@pytest.mark.parametrize("bk", [32, 64, 128])
def test_tile_needs_mask_with_a_prefix(causal, window, prefix, bk):
    """``tile_needs_mask`` against the elementwise mask over every tile of
    64 rows (a bf16 consumer's) and ``bk`` keys: False exactly where every
    element is allowed.  And ``_kv_range`` visits every allowed key of
    every row of its q block (128 rows), in tiles from a multiple of bk."""
    sq, sk = 1000, 777
    dense = _allowed(sq + 128, sk + bk, sk, causal, window, prefix)
    for r0 in range(0, sq, 64):
        for k0 in range(0, sk, bk):
            need = fa.tile_needs_mask(r0, k0, bk, sk, causal, window,
                                      prefix_len=prefix)
            assert need == (not dense[r0:r0 + 64, k0:k0 + bk].all()), \
                (r0, k0)
    for q0 in range(0, sq, 128):
        lo, hi = fa._kv_range(q0, sk, causal, window, 128, bk, prefix)
        assert lo % bk == 0
        rows = dense[q0:min(q0 + 128, sq)]
        assert not rows[:, :lo].any() and not rows[:, hi:].any(), q0
