"""Nemotron-4-340B's family in the port held against the JAX package on
the CPU, float32: ``nemotron_4_340b.reduced()`` (dense blocks, GQA 4/2,
the non-gated squared-ReLU FFN ``relu2``, an untied head, vocab 256) at
4 layers through ``lm_forward``, the drain engine and the cached greedy
decode; and the same config at the full model's head width 192
(``d_head=192``, 2 query heads over 1 KV head: RoPE, the projections and
the KV cache at that width, on the port's plain attention) through
``lm_forward`` and a decode step. Weights are drawn by the JAX package
and carried across with ``convert.params_from_jax``; tokens come from
numpy. Tolerance through matmuls: rtol = atol = 1e-4 (XLA and PyTorch
sum in different orders). The engine's probe tolerances keep every
request's (err/tol)^(1/q) at least 1e-3 from an integer (asserted), so
rounding cannot flip a K. Also: every registered config with attention
has a head width the flash kernel is instantiated for."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from port_isolation import port_module_isolation  # noqa: F401

from repro import configs as jax_configs
from repro.launch import engine as jeng
from repro.models import cdepth as jcd
from repro.models import lm as jlm
from repro_torch import configs as torch_configs
from repro_torch.convert import params_from_jax
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import engine as teng
from repro_torch.models import lm as tlm

ARCH = "nemotron_4_340b"
TOL = dict(rtol=1e-4, atol=1e-4)
N_LAYERS = 4
# solver -> (probe tolerance, probe order q) of the drain
TOLS = {"euler": (0.65, 1), "hyper_euler": (0.115, 1)}
BUCKETS = (2, 4, 8)
# the full model's attention shape at the reduced width: 2 heads of 192
# over 1 KV head
WIDE = dict(d_head=192, n_heads=2, n_kv=1)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


@functools.lru_cache(maxsize=None)
def model(wide=False):
    """(cfg_j, cfg_t, JAX params, the port's copy), drawn once."""
    kw = dict(n_layers=N_LAYERS, **(WIDE if wide else {}))
    cfg_j = dataclasses.replace(jax_configs.get(ARCH).reduced(), **kw)
    cfg_t = dataclasses.replace(torch_configs.get(ARCH).reduced(), **kw)
    pj = jlm.init_lm(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg_t, pj, params_from_jax(to_np(pj))


def tokens(cfg, shape, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab,
                                               shape).astype(np.int32)


@pytest.mark.parametrize("wide", [False, True])
def test_nemotron_tree_carries_the_plain_relu2_ffn(wide):
    """The reduced config keeps the family's FFN (squared ReLU, no gate)
    and untied head; every leaf of the reference's tree carries across
    bit for bit, with no ``wg`` kernel, and the port's own init draws
    the same tree."""
    cfg_j, cfg_t, pj, pt = model(wide)
    assert (cfg_t.act, cfg_t.gated_ffn, cfg_t.tie_embeddings) == \
        ("relu2", False, False)
    assert tlm.group_layout(cfg_t) == (("dense",), N_LAYERS, 0)
    assert sorted(pt["groups"]["b0"]["ffn"]) == ["wd", "wi"]
    assert pt["groups"]["b0"]["attn"]["wq"]["kernel"].shape == \
        (N_LAYERS, cfg_t.d_model, cfg_t.n_heads * cfg_t.d_head)
    flat_j = jax.tree_util.tree_flatten_with_path(pj)[0]
    assert len(flat_j) == len(jax.tree_util.tree_leaves(pt))
    for path, leaf in flat_j:
        node = pt
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    own = tlm.init_lm(torch.Generator().manual_seed(0), cfg_t)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, own)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0, pt))
    for a, b in zip(jax.tree_util.tree_leaves(own),
                    jax.tree_util.tree_leaves(pt)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("wide", [False, True])
def test_lm_forward_matches_jax(wide):
    cfg_j, cfg_t, pj, pt = model(wide)
    toks = tokens(cfg_j, (3, 12))
    lj, _ = jlm.lm_forward(pj, cfg_j, jnp.asarray(toks))
    lt, _ = tlm.lm_forward(pt, cfg_t, torch.from_numpy(toks))
    assert lt.dtype == torch.float32 and lt.shape == (3, 12, cfg_t.vocab)
    _close(lt, lj)


@pytest.mark.parametrize("wide", [False, True])
def test_prefill_and_decode_step_match_jax(wide):
    """The prefill's logits and caches, then one decode step's logits
    and caches (at head width 192 the cache rows are 192 wide)."""
    cfg_j, cfg_t, pj, pt = model(wide)
    prompt = tokens(cfg_j, (2, 9), seed=1)
    cj = jlm.init_lm_cache(cfg_j, 2, 12)
    ct = tlm.init_lm_cache(cfg_t, 2, 12)
    assert ct["groups"]["b0"]["k"].shape[-1] == cfg_t.d_head
    lj, cj = jlm.lm_prefill(pj, cfg_j, jnp.asarray(prompt), cj)
    lt, ct = tlm.lm_prefill(pt, cfg_t, torch.from_numpy(prompt), ct)
    _close(lt, lj)
    tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    lj, cj = jlm.lm_decode_step(pj, cfg_j, jnp.asarray(tok), cj,
                                jnp.asarray(9))
    lt, ct = tlm.lm_decode_step(pt, cfg_t, torch.from_numpy(tok), ct, 9)
    assert lt.shape == (2, cfg_t.vocab) and torch.isfinite(lt).all()
    _close(lt, lj)
    flat_j = jax.tree_util.tree_flatten_with_path(cj)[0]
    assert len(flat_j) == len(jax.tree_util.tree_leaves(ct))
    for path, leaf in flat_j:
        node = ct
        for k in path:
            node = node[k.key]
        _close(node, leaf, rtol=1e-4, atol=1e-5)
    assert not any(LAUNCHES.values())


def test_greedy_generate_matches_jax():
    """Tokens equal the reference's ``greedy_generate``; along that path
    the port's logits are within 1e-4 of the reference's (of each step's
    largest |logit|), and every step's top-2 gap on the JAX side exceeds
    that bound, so a rounding flip cannot decide a token."""
    cfg_j, cfg_t, pj, pt = model()
    prompt = tokens(cfg_j, (2, 12), seed=3)
    gen = 8
    ref = np.array(jeng.greedy_generate(pj, cfg_j, jnp.asarray(prompt), gen))
    out = teng.greedy_generate(pt, cfg_t, prompt, gen)
    assert out.dtype == torch.int32 and out.shape == (2, gen)
    np.testing.assert_array_equal(out.numpy(), ref)
    logits = {}
    for name, lm, params, cfg, tensor, index in (
            ("jax", jlm, pj, cfg_j, jnp.asarray, jnp.asarray),
            ("torch", tlm, pt, cfg_t, torch.from_numpy, int)):
        caches = lm.init_lm_cache(cfg, 2, 12 + gen)
        step, caches = lm.lm_prefill(params, cfg, tensor(prompt), caches)
        steps = [np.asarray(step)]
        for i, t in enumerate(range(12, 12 + gen - 1)):
            step, caches = lm.lm_decode_step(params, cfg, tensor(ref[:, i]),
                                              caches, index(t))
            steps.append(np.asarray(step))
        logits[name] = np.stack(steps, 1)
    lj, lt = logits["jax"], logits["torch"]
    np.testing.assert_array_equal(lj.argmax(-1), ref)
    tol = 1e-4 * np.abs(lj).max(-1, keepdims=True)
    assert (np.abs(lt - lj) <= tol).all(), np.abs(lt - lj).max()
    top2 = np.sort(lj, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0] > tol[..., 0]).all()
    assert not any(LAUNCHES.values())


@functools.lru_cache(maxsize=None)
def _g():
    cfg_j = model()[0]
    gj = jcd.lm_g_init(jax.random.PRNGKey(5), cfg_j, rank=8,
                       param_dtype=jnp.float32)
    gj = dict(gj, w_out=0.2 * jax.random.normal(jax.random.PRNGKey(6),
                                                gj["w_out"].shape))
    return gj, params_from_jax(to_np(gj))


def _ecfg(mod, solver, fused):
    return mod.EngineConfig(buckets=BUCKETS, tol=TOLS[solver][0],
                            max_batch=4, solver=solver, fused=fused)


@pytest.mark.parametrize("solver,fused", [("euler", True),
                                          ("euler", False),
                                          ("hyper_euler", True)])
def test_engine_drain_matches_jax(solver, fused):
    """8 prompts of 8 tokens drained through the multi-rate engine
    (buckets 2, 4, 8; packs of 4): per-request uid, K, nfe, status and
    completion order exact, outputs within 1e-4, K mixed."""
    cfg_j, cfg_t, pj, pt = model()
    gj, gt = _g() if solver.startswith("hyper_") else (None, None)
    toks = tokens(cfg_j, (8, 8))
    eng = jeng.MultiRateEngine(
        jeng.lm_depth_model(pj, cfg_j, solver=solver, g_params=gj),
        _ecfg(jeng, solver, fused))
    _, errs = eng.probe(toks)
    ref = eng.run(toks)
    tol, q = TOLS[solver]
    r = (np.asarray(errs, np.float64) / tol) ** (1.0 / q)
    assert np.abs(r - np.round(r)).min() > 1e-3, r

    out = teng.MultiRateEngine(
        teng.lm_depth_model(pt, cfg_t, solver=solver, g_params=gt),
        _ecfg(teng, solver, fused)).run(toks)
    assert len({c.K for c in out}) > 1, "K is not mixed"
    assert [c.uid for c in out] == [c.uid for c in ref]
    for a, b in zip(out, ref):
        assert (a.uid, a.K, a.nfe, a.status) == (b.uid, b.K, b.nfe, b.status)
        assert a.fused_kernel == b.fused_kernel == fused
        np.testing.assert_allclose(a.outputs, np.asarray(b.outputs), **TOL)
    assert not any(LAUNCHES.values())


@pytest.mark.parametrize("arch", torch_configs.ARCH_IDS)
def test_every_attention_config_has_a_flash_kernel_width(arch):
    """Every full-sequence attention on the card runs the flash kernel
    (there is no fallback), so every registered config with an
    attention block has a head width the kernel is instantiated for at
    its dtype; only RWKV6, whose blocks have no attention, is exempt."""
    from repro_torch.kernels.flash_attention.ops import (FP32_HEAD_DIMS,
                                                         HEAD_DIMS)
    cfg = torch_configs.get(arch)
    kinds = set(tlm.block_pattern(cfg))
    if not kinds & {"dense", "attn", "moe"}:
        assert kinds == {"rwkv"}, kinds
        return
    dims = FP32_HEAD_DIMS if cfg.dtype == "float32" else HEAD_DIMS
    assert cfg.d_head in dims, (arch, cfg.d_head, dims)
