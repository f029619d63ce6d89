"""The host-side arithmetic of the Hopper flash-attention kernel K4, on the
CPU: the TMA tensor-map rows the C launcher encodes, the tiles the kernel
leaves unmasked, and the plain version at the kernel's new tiling against
the JAX reference.

The CUDA kernel itself runs only on a GPU; ``chip_smoke.py`` holds it
against ``flash_attention_plain`` there.  Tolerances are the reference
tests': 2e-5 in f32, 2.5e-2 in bf16.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.ref import mha_ref as jax_mha_ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

BF16 = torch.bfloat16


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("layout", ["contiguous", "transposed"])
def test_tensor_map_rows(d, layout):
    """Dims innermost first, byte strides of S, heads and B, a box of at
    most 64 columns with a swizzle as wide as its row (128B at d >= 64,
    64B at d = 32, 32B at d = 16)."""
    B, H, S = 2, 4, 70
    if layout == "contiguous":
        x = torch.zeros(B, H, S, d, dtype=BF16)
        strides = (2 * d, 2 * S * d, 2 * H * S * d)
    else:                                   # [B, S, H, d] viewed as [B, H, S, d]
        x = torch.zeros(B, S, H, d, dtype=BF16).transpose(1, 2)
        strides = (2 * H * d, 2 * d, 2 * S * H * d)
    span = min(d, 64)
    row = fa.tensor_map(x, 128)
    assert len(row) == len(fa.MAP_FIELDS)
    assert row == (d, S, H, B, *strides, span, 128, 2 * span)
    assert {16: 32, 32: 64, 64: 128, 128: 128}[d] == row[-1]


def test_tensor_map_size_one_dims_and_f32():
    """A dimension of size 1 is never stepped (its stride is given as 16);
    f32 tensors get no box."""
    x = torch.zeros(1, 1, 5, 32, dtype=BF16)
    assert fa.tensor_map(x, 64) == (32, 5, 1, 1, 64, 16, 16, 32, 64, 64)
    y = torch.zeros(2, 3, 5, 32)
    assert fa.tensor_map(y, 64) == (32, 5, 3, 2, 128, 640, 1920, 0, 0, 0)


@pytest.mark.parametrize("case", [
    "base", "last_dim", "row_stride", "zero_stride", "huge_stride",
    "huge_dim"])
def test_tensor_map_refuses_what_tma_cannot_take(case):
    if case == "base":           # 2 bytes off 16-byte alignment
        x = torch.zeros(1, 2, 4, 17, dtype=BF16)[..., 1:]
    elif case == "last_dim":
        x = torch.zeros(1, 2, 16, 4, dtype=BF16).transpose(2, 3)
    elif case == "row_stride":   # rows 40 bytes apart
        x = torch.zeros(1, 2, 4, 20, dtype=BF16)[..., :16]
    elif case == "zero_stride":  # an expanded KV head
        x = torch.zeros(1, 1, 4, 16, dtype=BF16).expand(1, 3, 4, 16)
    elif case == "huge_stride":
        x = torch.empty_strided((2, 1, 4, 16), (2 ** 40, 64, 16, 1),
                                dtype=BF16, device="meta")
    else:
        x = torch.empty((1, 1, 2 ** 32, 16), dtype=BF16, device="meta")
    with pytest.raises(ValueError):
        fa.tensor_map(x, 64)


def test_check_kernel_inputs_returns_the_rows():
    q = torch.zeros(2, 8, 100, 128, dtype=BF16)
    k = torch.zeros(2, 2, 100, 128, dtype=BF16)
    rows = fa.check_kernel_inputs(q, k, k)
    bq, bk = fa.block_shape(128, BF16)
    assert [r[fa.MAP_FIELDS.index("box_rows")] for r in rows] == [bq, bk, bk]
    shared = torch.zeros(2, 1, 100, 128, dtype=BF16).expand(2, 2, 100, 128)
    with pytest.raises(ValueError, match="k:"):
        fa.check_kernel_inputs(q, shared, k)


def test_block_shape():
    assert fa.block_shape(64, BF16) == (128, 128)
    assert fa.block_shape(16, BF16) == (128, 128)
    assert fa.block_shape(128, BF16) == (128, 64)
    assert fa.block_shape(64, torch.float32) == (64, 64)


def _dense_mask(sq, sk, causal, window):
    rows = np.arange(sq)[:, None]
    cols = np.arange(sk)[None, :]
    m = np.ones((sq, sk), bool)
    if causal:
        m &= cols <= rows
    if window:
        m &= (rows - cols) < window
    return m


@pytest.mark.parametrize("causal,window", [(True, None), (True, 100),
                                           (True, 30), (False, None),
                                           (False, 70)])
@pytest.mark.parametrize("bk", [64, 128])
def test_unmasked_tiles_are_all_allowed(causal, window, bk):
    """Every (64-row consumer slice, KV tile) that ``tile_needs_mask``
    leaves unmasked is all-true in the dense mask, over the tiles the
    kernel's loop bounds visit; and, unless the window is narrower than a
    slice and a tile together, some tiles do skip the mask."""
    sq, sk = 1000, 777
    dense = _dense_mask(sq + 128, sk + bk, causal, window)
    dense[:, sk:] = False                      # keys past Sk
    skipped = 0
    for q0 in range(0, sq, 128):
        lo, hi = fa._kv_range(q0, sk, causal, window, 128, bk)
        for r0, k0 in itertools.product((q0, q0 + 64), range(lo, hi, bk)):
            if not fa.tile_needs_mask(r0, k0, bk, sk, causal, window):
                assert dense[r0:r0 + 64, k0:k0 + bk].all(), (r0, k0)
                skipped += 1
    assert skipped > 0 or window < 64 + bk


def test_diagonal_and_edge_tiles_need_the_mask():
    assert fa.tile_needs_mask(256, 256, 128, 1024, True, None)
    assert not fa.tile_needs_mask(256, 128, 128, 1024, True, None)
    assert fa.tile_needs_mask(256, 128, 128, 200, False, None)   # Sk edge
    assert fa.tile_needs_mask(320, 128, 128, 1024, True, 150)    # window
    assert not fa.tile_needs_mask(320, 128, 128, 1024, True, 300)


@pytest.mark.parametrize("shape", [
    (2, 16, 4, 200, 200, 64, True, None),     # ragged Sq at BLOCK_Q = 128
    (1, 4, 2, 150, 150, 128, True, 40),       # d 128: KV tiles of 64
    (1, 4, 1, 130, 130, 16, True, None),
    (1, 4, 2, 96, 160, 32, False, None),
], ids=lambda s: str(s[:6]))
def test_plain_at_kernel_tiling_matches_reference(shape):
    """bf16 at the kernel's tiling (block_shape) and its log2-unit softmax
    against the reference's unblocked oracle."""
    B, H, K, Sq, Sk, d, causal, window = shape
    rng = np.random.default_rng(21)
    arrays = (rng.standard_normal((B, H, Sq, d)),
              rng.standard_normal((B, K, Sk, d)),
              rng.standard_normal((B, K, Sk, d)))
    q, k, v = (torch.from_numpy(a).to(BF16) for a in arrays)
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = jax_mha_ref(*(jnp.asarray(a, jnp.bfloat16) for a in arrays),
                       causal=causal, window=window)
    assert out.dtype == BF16 and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=2.5e-2, rtol=2.5e-2)


def test_log2_softmax_scale():
    """bf16 scores are scaled by d^-0.5 log2(e) rounded to f32, f32 scores
    by d^-0.5: 2^(s log2 e) = e^s."""
    assert fa._scale(64) == float(np.float32(0.125))
    assert fa._scale(64, BF16) == float(np.float32(0.125)
                                        * np.float32(np.log2(np.e)))


@pytest.mark.parametrize("d", [64, 128])
def test_plain_at_kernel_tiling_matches_model_attention(d):
    """The plain version's blocked loop at the bf16 kernel's tiling
    (block_shape), on f32 inputs, in place of the reference model's XLA
    attention (einsum + softmax), as test_torch_flash_attention's
    test_plain_matches_model_attention does at the f32 tiling."""
    import dataclasses

    import jax
    from repro.configs import get_config as ref_get_config
    from repro.models import attention as ref_attn

    cfg = dataclasses.replace(ref_get_config("llama3.2-1b", smoke=True),
                              head_dim=d)
    rng = np.random.default_rng(4)
    B, S = 2, 300
    x = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)),
                    cfg.compute_dtype)
    p = ref_attn.attn_init(jax.random.PRNGKey(0), cfg)
    q, k, v = ref_attn._project_qkv(p, cfg, x)
    q, k, v = (t.astype(jnp.float32) for t in (q, k, v))
    xla = ref_attn._gqa_attend(p, cfg, q, k, v,
                               ref_attn.make_mask(S, S, causal=True))
    tq, tk, tv = (torch.from_numpy(np.array(t)).transpose(1, 2)
                  for t in (q, k, v))
    bq, bk = fa.block_shape(d, BF16)
    out = fa.flash_attention_plain(tq, tk, tv, causal=True, block_q=bq,
                                   block_k=bk)
    wo = torch.from_numpy(np.asarray(p["wo"].astype(cfg.compute_dtype),
                                     np.float32))
    np.testing.assert_allclose(torch.einsum("bhsd,hde->bse", out, wo).numpy(),
                               np.asarray(xla, np.float32), atol=3e-2,
                               rtol=3e-2)
