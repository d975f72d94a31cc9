"""The port's encoder-decoder (repro_torch/models/encdec.py), its layers
(``nn/module.py::layernorm``, ``embedding_lookup``, ``embedding_logits``;
``nn/attention.py::mha(kv_x=)``, ``precompute_cross_kv``,
``mha_decode(cross_kv=)``) and the flash wrapper's cross-attention shapes,
held against the JAX package on the CPU.

Mirrors tests/test_nn_layers.py::test_cross_attention_decode and
tests/test_arch_smoke.py::test_whisper_smoke and
::test_whisper_decode_matches_teacher_forced. The model is
``whisper_base.reduced()`` (2 + 2 layers, d 64, MHA 4/4 of 16, float32),
weights drawn by the JAX package and carried across with
``convert.params_from_jax``; frames and tokens come from numpy.
Tolerances: 1e-6 for the elementwise layers; 1e-4 through matmuls (XLA
and PyTorch sum in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_isolation import port_module_isolation  # noqa: F401
from repro import configs as jax_configs
from repro.models import encdec as jed
from repro.nn import attention as jatt
from repro.nn import module as jmod
from repro_torch import configs as torch_configs
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import encdec as ted
from repro_torch.nn import attention as tatt
from repro_torch.nn import module as tmod

TOL = dict(rtol=1e-4, atol=1e-4)
B, T, L = 2, 12, 8          # batch, encoder frames, decoder tokens


def to_torch(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


# -------------------------------------------------------------- layers ----

def test_layernorm_and_embeddings_match_jax():
    """``layernorm`` (float32, population variance, eps 1e-5) in float32
    and bf16 with a nonzero scale and bias; ``embedding_lookup`` and the
    tied ``embedding_logits`` (float32 sums of the table rounded to x's
    type) in both."""
    rs = np.random.RandomState(0)
    p = {"scale": rs.randn(24).astype(np.float32),
         "bias": rs.randn(24).astype(np.float32)}
    x = (3.0 * rs.randn(3, 5, 24) + 1.5).astype(np.float32)
    _close(tmod.layernorm(to_torch(p), torch.from_numpy(x)),
           jmod.layernorm(p, jnp.asarray(x)), rtol=1e-6, atol=1e-6)
    pj = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    xj = jnp.asarray(x, jnp.bfloat16)
    got = tmod.layernorm(to_torch(pj), torch.from_numpy(
        np.array(xj.astype(jnp.float32))).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got.float(), jmod.layernorm(pj, xj).astype(jnp.float32),
           rtol=1e-6, atol=1e-6)
    ej = jmod.embedding_init(jax.random.PRNGKey(1), 50, 24)
    et = to_torch(ej)
    ids = rs.randint(0, 50, (3, 5)).astype(np.int32)
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        look = tmod.embedding_lookup(et, torch.from_numpy(ids), td)
        assert look.dtype == td
        _close(look.float(), jmod.embedding_lookup(
            ej, jnp.asarray(ids), jd).astype(jnp.float32), rtol=0, atol=0)
        xs = jnp.asarray(x, jd)
        lt = tmod.embedding_logits(et, torch.from_numpy(
            np.array(xs.astype(jnp.float32))).to(td))
        assert lt.dtype == torch.float32
        _close(lt, jmod.embedding_logits(ej, xs), rtol=1e-6, atol=1e-5)


# ----------------------------------------------------------- attention ----

D, H, KV, HD = 16, 4, 2, 4


def _cross(qk_norm, seed=3):
    pj = jatt.attention_init(jax.random.PRNGKey(seed), D, H, KV, HD,
                             qk_norm=qk_norm)
    rs = np.random.RandomState(seed)
    return (pj, to_torch(pj), rs.randn(2, 5, D).astype(np.float32),
            rs.randn(2, 3, D).astype(np.float32))


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_matches_jax(qk_norm):
    """``mha(kv_x=)`` (no RoPE, no mask whatever ``causal`` says; GQA 4/2),
    ``precompute_cross_kv`` and ``mha_decode(cross_kv=)`` against the
    reference's, and the decode against the full-sequence cross-attention
    (test_nn_layers.py::test_cross_attention_decode). The self cache
    passed to a cross decode comes back untouched."""
    pj, pt, enc, x = _cross(qk_norm)
    kw = dict(n_heads=H, n_kv=KV, d_head=HD, qk_norm=qk_norm)
    full_j = jatt.mha(pj, jnp.asarray(x), kv_x=jnp.asarray(enc),
                      causal=True, **kw)
    full_t = tatt.mha(pt, torch.from_numpy(x), kv_x=torch.from_numpy(enc),
                      causal=True, **kw)
    _close(full_t, full_j)
    ckv_j = jatt.precompute_cross_kv(pj, jnp.asarray(enc), n_kv=KV,
                                     d_head=HD, qk_norm=qk_norm)
    ckv_t = tatt.precompute_cross_kv(pt, torch.from_numpy(enc), n_kv=KV,
                                     d_head=HD, qk_norm=qk_norm)
    for k in ("k", "v"):
        _close(ckv_t[k], ckv_j[k])
    cache = {"k": torch.zeros(2, 4, KV, HD)}
    for t in range(3):
        oj, _ = jatt.mha_decode(pj, jnp.asarray(x[:, t:t + 1]), {},
                                jnp.asarray(t), cross_kv=ckv_j, **kw)
        ot, back = tatt.mha_decode(pt, torch.from_numpy(x[:, t:t + 1]),
                                   cache, t, cross_kv=ckv_t, **kw)
        assert back is cache and not cache["k"].any()
        _close(ot, oj)
        _close(ot, full_t[:, t:t + 1].numpy(), rtol=1e-4, atol=1e-5)


def test_attention_ref_cross_lengths_match_reference_mha():
    """``attention_ref`` (the flash wrapper's CPU path) with Sq != Sk is
    the reference ``mha(kv_x=)``'s attention: with identity projections
    the reference's output is its attention itself."""
    rs = np.random.RandomState(4)
    eye = {"kernel": np.eye(H * HD, dtype=np.float32)}
    p = {"wq": eye, "wk": {"kernel": np.eye(H * HD, dtype=np.float32)
                           [:, :KV * HD]},
         "wv": {"kernel": np.eye(H * HD, dtype=np.float32)[:, :KV * HD]},
         "wo": eye}
    x = rs.randn(2, 5, H * HD).astype(np.float32)
    enc = rs.randn(2, 9, H * HD).astype(np.float32)
    ref = jatt.mha(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                   n_heads=H, n_kv=KV, d_head=HD, kv_x=jnp.asarray(enc))
    q = torch.from_numpy(x).reshape(2, 5, H, HD)
    kv = torch.from_numpy(enc[..., :KV * HD]).reshape(2, 9, KV, HD)
    for fn in (attention_ref, flash_attention):
        out = fn(q, kv, kv, causal=False)
        assert out.shape == (2, 5, H, HD)
        _close(out.reshape(2, 5, H * HD), ref, rtol=1e-5, atol=1e-6)


def test_flash_refuses_a_masked_cross_call():
    """A causal or windowed call with Sq != Sk has no meaning for the
    kernel; the wrapper raises before any plain version or launch."""
    q, k = torch.zeros(1, 4, 2, 16), torch.zeros(1, 6, 2, 16)
    for kw in (dict(causal=True), dict(causal=False, window=2)):
        with pytest.raises(ValueError, match="cross-attention"):
            flash_attention(q, k, k, **kw)


# --------------------------------------------------------------- model ----

@pytest.fixture(scope="module")
def whisper():
    cfg_j = jax_configs.get("whisper_base").reduced()
    cfg_t = torch_configs.get("whisper_base").reduced()
    pj = jax.jit(lambda k: jed.init_encdec(k, cfg_j))(jax.random.PRNGKey(0))
    rs = np.random.RandomState(1)
    frames = rs.randn(B, T, cfg_j.d_model).astype(np.float32)
    toks = rs.randint(0, cfg_j.vocab, (B, L)).astype(np.int32)
    return cfg_j, cfg_t, pj, to_torch(pj), frames, toks


def test_encode_and_decode_train_match_jax(whisper):
    cfg_j, cfg_t, pj, pt, frames, toks = whisper
    enc_j = jed.encode(pj, cfg_j, jnp.asarray(frames))
    enc_t = ted.encode(pt, cfg_t, torch.from_numpy(frames))
    _close(enc_t, enc_j)
    lj = jed.decode_train(pj, cfg_j, enc_j, jnp.asarray(toks))
    lt = ted.decode_train(pt, cfg_t, enc_t, torch.from_numpy(toks))
    assert lt.dtype == torch.float32 and lt.shape == (B, L, cfg_t.vocab)
    _close(lt, lj)


def test_encdec_loss_and_grads_match_jax(whisper):
    """``encdec_loss`` and its gradient with respect to every leaf, and
    the same under ``remat="full"`` and ``"dots"`` bit for bit."""
    cfg_j, cfg_t, pj, pt, frames, toks = whisper
    tgts = np.roll(toks, -1, 1)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: jed.encdec_loss(p, cfg_j, jnp.asarray(frames),
                                  jnp.asarray(toks), jnp.asarray(tgts)),
        has_aux=True))(pj)
    leaves, spec = jax.tree_util.tree_flatten(pt)
    out = {}
    for remat in ("none", "full", "dots"):
        live = [l.clone().requires_grad_() for l in leaves]
        lt, mt = ted.encdec_loss(jax.tree_util.tree_unflatten(spec, live),
                                 cfg_t, torch.from_numpy(frames),
                                 torch.from_numpy(toks),
                                 torch.from_numpy(tgts), remat=remat)
        out[remat] = (lt.detach(), torch.autograd.grad(lt, live))
    lt, grads = out["none"]
    _close(lt, lj, rtol=1e-5, atol=1e-5)
    _close(mt["ce"], mj["ce"], rtol=1e-5, atol=1e-5)
    gl = jax.tree_util.tree_leaves(gj)
    assert len(gl) == len(grads)
    for a, b in zip(grads, gl):
        _close(a, b, rtol=1e-4, atol=1e-5)
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], lt)
        assert all(torch.equal(a, b) for a, b in zip(out[remat][1], grads))


def test_decode_steps_match_jax_and_teacher_forcing(whisper):
    """``init_dec_cache`` (zeroed self caches, every layer's cross K/V) and
    five ``encdec_decode_step``s against the reference's, caches
    included; the steps' logits against the port's own teacher-forced
    ``decode_train`` (test_whisper_decode_matches_teacher_forced)."""
    cfg_j, cfg_t, pj, pt, frames, toks = whisper
    enc_j = jed.encode(pj, cfg_j, jnp.asarray(frames))
    enc_t = ted.encode(pt, cfg_t, torch.from_numpy(frames))
    cj = jed.init_dec_cache(pj, cfg_j, enc_j, B, L)
    ct = ted.init_dec_cache(pt, cfg_t, enc_t, B, L)
    for part in ("self", "cross"):
        for k in ("k", "v"):
            assert tuple(ct[part][k].shape) == cj[part][k].shape
            _close(ct[part][k], cj[part][k])
    steps = []
    for t in range(5):
        lj, cj = jed.encdec_decode_step(pj, cfg_j, jnp.asarray(toks[:, t]),
                                        cj, jnp.asarray(t))
        lt, ct = ted.encdec_decode_step(pt, cfg_t, torch.from_numpy(
            toks[:, t]), ct, t)
        _close(lt, lj)
        steps.append(lt)
    for k in ("k", "v"):
        _close(ct["self"][k], cj["self"][k])
    full = ted.decode_train(pt, cfg_t, enc_t, torch.from_numpy(toks[:, :5]))
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-5)
