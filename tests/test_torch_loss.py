"""The port's losses and their gradients against the JAX reference.

* K4's backward: ``flash_attention_bwd_plain`` (what the autograd function
  ``FlashAttention`` runs for CPU tensors) against ``jax.vjp`` of the
  reference's unblocked oracle ``repro.kernels.ref.mha_ref`` (causal,
  windowed, bidirectional) and of the model's ``_gqa_attend`` under
  ``make_mask(prefix_len=)`` (prefix-LM) and a bidirectional mask with
  Sq != Sk (cross-attention), f32, head dims 16/64/256, a seeded
  cotangent: within 2e-5 of each gradient's largest element; also at each
  block shape of the kernels' loops (128 x 128, 128 x 64, 128 x 32,
  64 x 64).  The
  forward's log-sum-exp against ``logsumexp`` of the masked scores.
* ``_q_range`` (the q rows that see a KV tile) and the tile test over
  q blocks against the elementwise mask over every tile.
* ``api.loss`` and its gradients against ``jax.value_and_grad`` of the
  reference's ``api.loss`` for all ten arch ids, the reference's f32
  ``api.init`` carried into the port's f32 master tree by
  ``load_reference_master``.  f32: the loss within 1e-5 relative, each
  leaf's gradient within 3e-4 of its largest element (the reference's own
  gradients move by up to 5e-5 of it when its inputs or weights move by
  1e-7, and the port sums in other orders: the blocked online softmax, the
  per-layer loop).  bf16 (the dense, MoE, encoder-decoder and VLM
  blocks): the loss by
  ``test_torch_model.py``'s rule, no further from the reference's f32 loss
  than the reference's own bf16 loss is, plus 8e-2 (relative); the
  gradients, all leaves together, within twice the reference's own bf16
  relative (Frobenius) error from its f32 gradients, plus 8e-2.  At these
  smoke widths bf16 gradients are mostly rounding noise, the reference's
  own far from its f32 ones, and which package lands nearer changes with
  the seed and the config.
* With zero patch embeddings paligemma-3b's gradients turn non-finite
  past the same depth as the reference's (the prefix positions' residual
  is 0, where rmsnorm's gradient is eps^-0.5 at every layer).
* ``maybe_remat``'s three policies give the same loss and gradients.
"""
import dataclasses
import functools
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.kernels.ref import mha_ref as jax_mha_ref  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import build_model, load_reference_master  # noqa
from repro_torch.models.convert import layer_stacks  # noqa: E402
from repro_torch.train.optim import tree_leaves  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402

BWD_TOL = 2e-5
HEAD_DIMS = (16, 64, 256)
#: B, H, K, Sq, Sk, causal, window (mha_ref's forms)
MHA_FORMS = {"causal": (2, 4, 2, 150, 150, True, None),
             "window": (1, 4, 1, 200, 200, True, 37),
             "bidirectional": (1, 4, 2, 90, 90, False, None)}
#: B, H, K, Sq, Sk, causal, window, prefix (the model attention's forms)
MODEL_FORMS = {"prefix": (1, 4, 2, 130, 130, True, None, 70),
               "prefix_window": (1, 2, 1, 150, 150, True, 20, 90),
               "cross": (2, 4, 4, 70, 110, False, None, None)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small operations, which a
    pool of threads in each of a whole run's worker processes slows by up
    to two orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(B, H, K, Sq, Sk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Sq, d), (B, K, Sk, d), (B, K, Sk, d),
                      (B, H, Sq, d))]


def _port_grads(q, k, v, do, **mask):
    """Gradients through the autograd function (the plain backward on the
    CPU), and the plain backward called directly."""
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, **mask)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    o, lse = fa.flash_attention_plain(*leaves, **mask, return_lse=True)
    direct = fa.flash_attention_bwd_plain(*[x.detach() for x in leaves],
                                          o, lse, torch.from_numpy(do),
                                          **mask)
    for a, b in zip(got, direct):
        assert torch.equal(a, b)
    return got


def _close_by_max(got, want, tol, what):
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().float().numpy() - want).max()
    top = np.abs(want).max()
    assert err <= tol * top, f"{what}: |diff| {err} > {tol} x {top}"


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("form", list(MHA_FORMS))
def test_bwd_plain_matches_jax_grad_of_mha_ref(form, d):
    B, H, K, Sq, Sk, causal, window = MHA_FORMS[form]
    q, k, v, do = _inputs(B, H, K, Sq, Sk, d, seed=d)
    _, vjp = jax.vjp(lambda *a: jax_mha_ref(*a, causal=causal,
                                            window=window), q, k, v)
    want = vjp(jnp.asarray(do))
    got = _port_grads(q, k, v, do, causal=causal, window=window)
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _close_by_max(g, w, BWD_TOL, f"{form} d{d} d{name}")


def _identity_wo(H, d):
    return jnp.eye(H * d, dtype=jnp.float32).reshape(H, d, H * d)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("form", list(MODEL_FORMS))
def test_bwd_plain_matches_jax_grad_of_model_attention(form, d):
    """Against ``_gqa_attend`` (an identity ``wo``) in the model's
    [B, S, heads, d] layout, under ``make_mask(prefix_len=)`` or, for the
    cross-attention, every key allowed with Sq != Sk."""
    B, H, K, Sq, Sk, causal, window, prefix = MODEL_FORMS[form]
    rcfg = dataclasses.replace(ref_get_config("llama3.2-1b", smoke=True),
                               compute_dtype=jnp.float32)
    q, k, v, do = _inputs(B, H, K, Sq, Sk, d, seed=d + 1)
    mask = ref_attn.make_mask(Sq, Sk, causal=causal, window=window,
                              prefix_len=prefix)
    p = {"wo": _identity_wo(H, d)}

    def attend(q, k, v):
        mq, mk, mv = (jnp.swapaxes(t, 1, 2) for t in (q, k, v))
        out = ref_attn._gqa_attend(p, rcfg, mq, mk, mv, mask)
        return jnp.swapaxes(out.reshape(B, Sq, H, d), 1, 2)

    _, vjp = jax.vjp(attend, q, k, v)
    want = vjp(jnp.asarray(do))
    got = _port_grads(q, k, v, do, causal=causal, window=window,
                      prefix_len=prefix)
    for g, w, name in zip(got, want, "qkv"):
        _close_by_max(g, w, BWD_TOL, f"{form} d{d} d{name}")


#: (q rows, KV rows) of the plain backward's blocks: the wgmma kernels'
#: dQ pass (128 x 128; 128 x 64 at d 128, 128 x 32 at d 256) and the
#: CUDA-core forms' 64 x 64
BWD_BLOCKS = [(128, 128), (128, 64), (128, 32), (64, 64)]


@pytest.mark.parametrize("block", BWD_BLOCKS,
                         ids=[f"{bq}x{bk}" for bq, bk in BWD_BLOCKS])
@pytest.mark.parametrize("form", list(MHA_FORMS))
def test_bwd_plain_at_each_kernel_block_matches_jax_grad(form, block):
    """At each block shape the kernels use, f32, d 32: the block shape
    moves only the order of the f32 sums, within ``BWD_TOL``."""
    B, H, K, Sq, Sk, causal, window = MHA_FORMS[form]
    q, k, v, do = _inputs(B, H, K, Sq, Sk, 32, seed=11)
    _, vjp = jax.vjp(lambda *a: jax_mha_ref(*a, causal=causal,
                                            window=window), q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                      window=window, return_lse=True)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse,
                                       torch.from_numpy(do), causal=causal,
                                       window=window, block_q=block[0],
                                       block_k=block[1])
    for g, w, name in zip(got, want, "qkv"):
        _close_by_max(g, w, BWD_TOL, f"{form} {block} d{name}")


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_bwd_block_shapes(d):
    """The dQ pass's blocks: the wgmma kernels' in bf16 at every d (KV
    tiles of 64 rows at d 128 and 32 at d 256, as the forward's), 64 x 64
    in the CUDA-core forms (f32)."""
    assert fa.bwd_block_shape(d, torch.bfloat16) == (
        128, {128: 64, 256: 32}.get(d, 128))
    assert fa.bwd_block_shape(d, torch.float32) == (64, 64)


@pytest.mark.parametrize("form", ["causal", "window", "bidirectional",
                                  "prefix_window"])
def test_plain_lse_is_logsumexp_of_masked_scores(form):
    """The forward's log-sum-exp, f32 and bf16, natural units."""
    shape = {**MHA_FORMS, **MODEL_FORMS}[form]
    B, H, K, Sq, Sk, causal, window = shape[:7]
    prefix = shape[7] if len(shape) > 7 else None
    q, k, v, _ = _inputs(B, H, K, Sq, Sk, 32, seed=3)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-5)):
        tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
        _, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                          window=window, prefix_len=prefix,
                                          return_lse=True)
        kk = tk.float().repeat_interleave(H // K, dim=1)
        s = tq.float() @ kk.transpose(-1, -2) * 32 ** -0.5
        m = ref_attn.make_mask(Sq, Sk, causal=causal, window=window,
                               prefix_len=prefix)
        allowed = torch.from_numpy(np.array(m)[0, 0])
        want = torch.logsumexp(torch.where(allowed, s, -1e30), dim=-1)
        assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
        assert float((lse - want).abs().max()) <= tol * float(
            want.abs().max())


#: causal with a window and a prefix (None or a value each), and the
#: bidirectional form
RANGE_MASKS = [(True, w, p) for w in (None, 1, 7, 64, 100)
               for p in (None, 5, 64, 130)] + [(False, None, None)]


@pytest.mark.parametrize("causal,window,prefix", RANGE_MASKS)
def test_q_range_and_tile_test_against_the_mask(causal, window, prefix):
    """For every KV tile, ``_q_range`` holds exactly the q rows that see
    it (lo rounded down to a q block); and a q block x KV tile the
    transposed tile test leaves unmasked has every element allowed; at Sq
    1, 63, 64, 65, 130 and 300, Sk = Sq (and Sq + 37 without the causal
    mask), tiles of 64 x 64 and 64 x 32, and the wgmma kernels' 64 x 128
    (the dK/dV pass's q steps against its KV tile), 128 x 128, 128 x 64
    and 128 x 32 (the dQ pass's q block against its KV tiles) and 32 x 64
    (a consumer's half of a q step against the KV tile at d 256)."""
    for sq, (extra, bq, bk) in itertools.product(
            (1, 63, 64, 65, 130, 300), ((0, 64, 64), (0, 64, 32),
                                        (37, 64, 64), (0, 64, 128),
                                        (37, 64, 128), (0, 128, 128),
                                        (0, 128, 64), (0, 128, 32),
                                        (0, 32, 64), (37, 32, 64))):
        if causal and extra:
            continue
        sk = sq + extra
        rows = torch.arange(sq)[:, None]
        cols = torch.arange(sk)[None, :]
        pre = fa._prefix(causal, prefix)
        allowed = fa._allowed(rows, cols, sk, causal, window,
                              pre).expand(sq, sk)
        for k0 in range(0, sk, bk):
            lo, hi = fa._q_range(k0, sq, sk, causal, window, bq, bk, prefix)
            seen = allowed[:, k0:k0 + bk].any(dim=1).nonzero().flatten()
            if len(seen):
                assert lo == int(seen.min()) // bq * bq
                assert hi == int(seen.max()) + 1
            else:
                assert hi <= lo
            for q0 in range(0, sq, bq):
                if not fa.tile_needs_mask(q0, k0, bk, sk, causal, window,
                                          rows=bq, prefix_len=prefix):
                    assert bool(allowed[q0:q0 + bq, k0:k0 + bk].all())


# ---------------------------------------------------------------------------------
# api.loss against the reference's
# ---------------------------------------------------------------------------------

B, S, S_ENC = 2, 24, 16
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16,
                                                      jnp.bfloat16)}
#: the bf16 check's archs: dense, moe, encdec and patch blocks (the
#: recurrent ones are held in f32 here, and in bf16 by the same rule in
#: ``test_torch_scan_bwd.py``, beside their scans' backward)
BF16_ARCHS = ["llama3.2-1b", "olmoe-1b-7b", "seamless-m4t-medium",
              "paligemma-3b"]


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (B, S_ENC, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "patch":
        batch["prefix_embeds"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return batch


def _stack(cfg, tree):
    """The port's tree as numpy, its per-layer lists stacked on a leading
    axis as the reference's."""
    def np_tree(t):
        if isinstance(t, torch.Tensor):
            return t.detach().float().numpy()
        return {k: np_tree(v) for k, v in t.items()}

    out = {}
    for key, val in tree.items():
        if key in layer_stacks(cfg):
            out[key] = jax.tree.map(lambda *xs: np.stack(xs),
                                    *[np_tree(layer) for layer in val])
        else:
            out[key] = np_tree(val)
    return out


def _port_value_and_grad(api, master, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return value_and_grad(api, master, tb)


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype: str):
    """The reference's seeded f32 ``api.init``, and ``value_and_grad`` of
    its loss in ``dtype`` on ``_batch``: (batch, tree, loss, aux, grads),
    kept for the f32 and bf16 tests of one arch."""
    rcfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                               compute_dtype=DTYPES[dtype][1])
    batch = _batch(get_config(arch, smoke=True))
    rapi = ref_build_model(rcfg)
    tree = jax.jit(rapi.init)(jax.random.PRNGKey(0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, aux), grads = jax.jit(jax.value_and_grad(rapi.loss, has_aux=True))(
        tree, jb)
    return batch, tree, float(loss), aux, grads


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x, np.float32))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_reference_f32(arch):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=torch.float32)
    batch, tree, want, raux, rgrads = _reference(arch, "f32")
    master = load_reference_master(cfg, jax.tree.map(np.asarray, tree),
                                   device="cpu")
    assert all(t.dtype == torch.float32 for t in tree_leaves(master))
    api = build_model(cfg, device="cpu")
    (loss, aux), grads = _port_value_and_grad(api, master, batch)
    assert abs(float(loss) - want) <= 1e-5 * abs(want)
    assert sorted(aux) == sorted(raux)
    for key in aux:
        assert float(aux[key]) == pytest.approx(float(raux[key]), rel=1e-5,
                                                abs=1e-6)
    got = _leaves(_stack(cfg, grads))
    ref = _leaves(rgrads)
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (key, g), (_, w) in zip(got, ref):
        assert g.shape == w.shape, key
        err, top = np.abs(g - w).max(), np.abs(w).max()
        assert err <= 3e-4 * top, f"{arch} {key}: {err} > 3e-4 x {top}"


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_loss_and_grads_bf16_by_the_reference_rule(arch):
    """bf16 compute over the same f32 master: the loss no further from the
    reference's f32 loss than the reference's own bf16 loss is, plus 8e-2;
    the gradient tree within twice the reference's own bf16 error, plus
    8e-2 (relative)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=torch.bfloat16)
    batch, tree, want, _, g32 = _reference(arch, "f32")
    _, _, own_loss, _, g16 = _reference(arch, "bf16")
    master = load_reference_master(cfg, jax.tree.map(np.asarray, tree),
                                   device="cpu")
    api = build_model(cfg, device="cpu")
    (loss, _), grads = _port_value_and_grad(api, master, batch)
    own = abs(own_loss - want) / abs(want)
    assert abs(float(loss) - want) / abs(want) <= own + 8e-2
    got, ref32, ref16 = (np.concatenate([x.ravel() for _, x in _leaves(t)])
                         for t in (_stack(cfg, grads), g32, g16))
    assert all(g.dtype == torch.float32 for g in tree_leaves(grads))
    rel, ref_rel = _rel(got, ref32), _rel(ref16, ref32)
    assert rel <= 2 * ref_rel + 8e-2, (f"{arch}: relative error {rel} from "
                                       f"the f32 gradients; the reference's "
                                       f"bf16 {ref_rel}")


@pytest.mark.parametrize("layers", [8, 14])
def test_zero_patch_gradients_overflow_as_the_reference(layers):
    """With zero patch embeddings (the launcher's stub, as the
    reference's) the prefix positions' residual stays 0 at every layer,
    where rmsnorm's gradient is eps^-0.5: the gradient that reaches them
    grows with each layer until, past some depth, it overflows and turns
    the norms' gradients NaN.  f32 at the smoke width, the reference's
    weights carried across: the port's gradients are finite exactly where
    the reference's are (at 8 layers, not at 14)."""
    cfg = dataclasses.replace(get_config("paligemma-3b", smoke=True),
                              n_layers=layers, compute_dtype=torch.float32)
    rcfg = dataclasses.replace(ref_get_config("paligemma-3b", smoke=True),
                               n_layers=layers, compute_dtype=jnp.float32)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
             "prefix_embeds": np.zeros((B, cfg.frontend_len, cfg.d_model),
                                       np.float32)}
    rapi = ref_build_model(rcfg)
    tree = jax.jit(rapi.init)(jax.random.PRNGKey(0))
    _, rgrads = jax.jit(jax.value_and_grad(rapi.loss, has_aux=True))(
        tree, {k: jnp.asarray(v) for k, v in batch.items()})
    master = load_reference_master(cfg, jax.tree.map(np.asarray, tree),
                                   device="cpu")
    _, grads = _port_value_and_grad(build_model(cfg, device="cpu"), master,
                                    batch)
    want = all(np.isfinite(x).all() for _, x in _leaves(rgrads))
    got = all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
    assert got == want == (layers == 8)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-9b",
                                  "seamless-m4t-medium"])
def test_remat_policies_agree(arch):
    """``remat`` "none", "full" and "dots" give the same loss and gradients
    (f32): rematerialisation only trades memory for recomputation."""
    batch = _batch(get_config(arch, smoke=True), seed=2)
    results = []
    for policy in ("none", "full", "dots"):
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  compute_dtype=torch.float32, remat=policy)
        api = build_model(cfg, device="cpu")
        from repro_torch.models import master_params
        master = master_params(api.init(4))
        (loss, _), grads = _port_value_and_grad(api, master, batch)
        results.append((loss, tree_leaves(grads)))
    for loss, grads in results[1:]:
        assert torch.equal(loss, results[0][0])
        for a, b in zip(grads, results[0][1]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
