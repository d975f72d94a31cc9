"""Mistral-NeMo-12B and Qwen3-8B in the port held against the JAX package
on the CPU, float32, at 4 layers: ``mistral_nemo_12b.reduced()`` with
``d_model=80``, so its attention (4 heads of 16, 64 wide) is narrower than
its residual stream as the full model's is (4,096 under 5,120: ``wq``
(d, 64), ``wo`` (64, d)), and ``qwen3_8b.reduced()`` (qk-norm, an untied
head, RoPE theta 1e6), each through ``lm_forward``, the prefill and a
decode step, the cached greedy decode, the drain engine (euler and
hyper_euler, fused and unfused) and the in-flight scheduler. Weights are
drawn by the JAX package and carried across with
``convert.params_from_jax``; tokens come from numpy. Tolerance through
matmuls: rtol = atol = 1e-4 (XLA and PyTorch sum in different orders).
The probe tolerances keep every request's (err/tol)^(1/q) at least 1e-3
from an integer (asserted), so rounding cannot flip a K. Also: every
registered config's attention width relative to its stream (narrower,
equal, wider) has a parity case in the port's tests."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from port_isolation import port_module_isolation  # noqa: F401
from test_torch_nemotron import WIDE

from repro import configs as jax_configs
from repro.launch import engine as jeng
from repro.launch import scheduler as jsch
from repro.launch import workload as jwl
from repro.models import cdepth as jcd
from repro.models import lm as jlm
from repro_torch import configs as torch_configs
from repro_torch.convert import params_from_jax
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import engine as teng
from repro_torch.launch import scheduler as tsch
from repro_torch.launch import workload as twl
from repro_torch.models import lm as tlm

TOL = dict(rtol=1e-4, atol=1e-4)
# arch -> what the reduced config changes: 4 layers; Mistral-NeMo's stream
# widened to 80 over its 4 heads of 16 (the full model's 5:4)
ARCHS = {"mistral_nemo_12b": dict(n_layers=4, d_model=80),
         "qwen3_8b": dict(n_layers=4)}
# solver -> (probe tolerance, probe order q) of the drain
TOLS = {"euler": (0.5, 1), "hyper_euler": (0.112, 1)}
BUCKETS = (2, 4, 8)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


def attention_relation(cfg) -> str:
    """Attention width (n_heads * d_head) against the residual stream."""
    width = cfg.n_heads * cfg.d_head
    return ("narrower" if width < cfg.d_model else
            "wider" if width > cfg.d_model else "equal")


@functools.lru_cache(maxsize=None)
def model(arch):
    """(cfg_j, cfg_t, JAX params, the port's copy), drawn once."""
    cfg_j = dataclasses.replace(jax_configs.get(arch).reduced(),
                                **ARCHS[arch])
    cfg_t = dataclasses.replace(torch_configs.get(arch).reduced(),
                                **ARCHS[arch])
    pj = jlm.init_lm(jax.random.PRNGKey(0), cfg_j)
    return cfg_j, cfg_t, pj, params_from_jax(to_np(pj))


def tokens(cfg, shape, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab,
                                               shape).astype(np.int32)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_tree_carries_the_attention_shapes(arch):
    """Mistral-NeMo's ``wq`` is (80, 64) and ``wo`` (64, 80) a layer;
    Qwen3-8B keeps qk-norm, an untied head and theta 1e6. Every leaf of
    the reference's tree carries across bit for bit, and the port's own
    init draws the same tree."""
    cfg_j, cfg_t, pj, pt = model(arch)
    attn = pt["groups"]["b0"]["attn"]
    L, d, width = cfg_t.n_layers, cfg_t.d_model, cfg_t.n_heads * cfg_t.d_head
    assert attn["wq"]["kernel"].shape == (L, d, width)
    assert attn["wo"]["kernel"].shape == (L, width, d)
    assert attn["wk"]["kernel"].shape == (L, d, cfg_t.n_kv * cfg_t.d_head)
    if arch == "mistral_nemo_12b":
        assert (d, width) == (80, 64)
        assert attention_relation(cfg_t) == "narrower"
        assert "q_norm" not in attn
    else:
        assert (cfg_t.qk_norm, cfg_t.tie_embeddings) == (True, False)
        assert attn["q_norm"]["scale"].shape == (L, cfg_t.d_head)
        assert pt["head"]["kernel"].shape == (d, cfg_t.vocab)
    assert cfg_t.rope_theta == 1e6
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


@pytest.mark.parametrize("arch", list(ARCHS))
def test_lm_forward_matches_jax(arch):
    cfg_j, cfg_t, pj, pt = model(arch)
    toks = tokens(cfg_j, (3, 12))
    lj, _ = jlm.lm_forward(pj, cfg_j, jnp.asarray(toks))
    lt, _ = tlm.lm_forward(pt, cfg_t, torch.from_numpy(toks))
    assert lt.dtype == torch.float32 and lt.shape == (3, 12, cfg_t.vocab)
    _close(lt, lj)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_decode_step_match_jax(arch):
    """The prefill's logits and caches, then one decode step's logits and
    caches (the cache rows are d_head wide, not d_model / n_heads)."""
    cfg_j, cfg_t, pj, pt = model(arch)
    prompt = tokens(cfg_j, (2, 9), seed=1)
    cj = jlm.init_lm_cache(cfg_j, 2, 12)
    ct = tlm.init_lm_cache(cfg_t, 2, 12)
    assert ct["groups"]["b0"]["k"].shape[-2:] == (cfg_t.n_kv, cfg_t.d_head)
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


@pytest.mark.parametrize("arch", list(ARCHS))
def test_greedy_generate_matches_jax(arch):
    """Tokens equal the reference's ``greedy_generate``; along that path
    the port's logits are within 1e-4 of the reference's (of each step's
    largest |logit|), and every step's top-2 gap on the JAX side exceeds
    that bound, so a rounding flip cannot decide a token."""
    cfg_j, cfg_t, pj, pt = model(arch)
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
def _g(arch):
    cfg_j = model(arch)[0]
    gj = jcd.lm_g_init(jax.random.PRNGKey(5), cfg_j, rank=8,
                       param_dtype=jnp.float32)
    gj = dict(gj, w_out=0.2 * jax.random.normal(jax.random.PRNGKey(6),
                                                gj["w_out"].shape))
    return gj, params_from_jax(to_np(gj))


def _ecfg(mod, solver, fused, max_batch=4):
    return mod.EngineConfig(buckets=BUCKETS, tol=TOLS[solver][0],
                            max_batch=max_batch, solver=solver, fused=fused)


def _assert_k_margin(errs, solver):
    tol, q = TOLS[solver]
    r = (np.asarray(errs, np.float64) / tol) ** (1.0 / q)
    assert np.abs(r - np.round(r)).min() > 1e-3, r


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("solver,fused", [("euler", True),
                                          ("euler", False),
                                          ("hyper_euler", True),
                                          ("hyper_euler", False)])
def test_engine_drain_matches_jax(arch, solver, fused):
    """8 prompts of 8 tokens drained through the multi-rate engine
    (buckets 2, 4, 8; packs of 4): per-request uid, K, nfe, status and
    completion order exact, outputs within 1e-4, K mixed."""
    cfg_j, cfg_t, pj, pt = model(arch)
    gj, gt = _g(arch) if solver.startswith("hyper_") else (None, None)
    toks = tokens(cfg_j, (8, 8))
    eng = jeng.MultiRateEngine(
        jeng.lm_depth_model(pj, cfg_j, solver=solver, g_params=gj),
        _ecfg(jeng, solver, fused))
    _assert_k_margin(eng.probe(toks)[1], solver)
    ref = eng.run(toks)

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


@pytest.mark.parametrize("arch", list(ARCHS))
def test_full_depth_drain_matches_jax(arch):
    """At the full model's depth (40 and 36 layers, reduced width), 8
    prompts of 16 tokens drained at a fixed K 8, euler, fused: outputs
    within 1e-4 of the reference's, and the argmax agreement of each
    package's drain with its own full-depth forward equal (8 steps over
    36-40 groups of random weights agree with the forward far less than
    at 4 layers, in both packages)."""
    cfg_j, cfg_t, _, _ = model(arch)
    n_layers = torch_configs.get(arch).n_layers
    cfg_j = dataclasses.replace(cfg_j, n_layers=n_layers)
    cfg_t = dataclasses.replace(cfg_t, n_layers=n_layers)
    pj = jlm.init_lm(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_jax(to_np(pj))
    toks = tokens(cfg_j, (8, 16), seed=1)
    agree = {}
    outs = {}
    for name, eng, lm, params, cfg, tensor in (
            ("jax", jeng, jlm, pj, cfg_j, jnp.asarray),
            ("torch", teng, tlm, pt, cfg_t, torch.from_numpy)):
        full = np.asarray(lm.lm_forward(params, cfg, tensor(toks))[0])
        out = eng.MultiRateEngine(
            eng.lm_depth_model(params, cfg),
            eng.EngineConfig(buckets=(8,), tol=1.0, max_batch=8,
                             solver="euler", fused=True, controller="fixed",
                             fixed_K=8)).run(toks)
        assert [(r.uid, r.K, r.status) for r in out] == \
            [(i + 1, 8, "ok") for i in range(8)]
        outs[name] = np.stack([np.asarray(r.outputs) for r in out])
        agree[name] = float(np.mean(outs[name].argmax(-1)
                                    == full.argmax(-1)))
    np.testing.assert_allclose(outs["torch"], outs["jax"], **TOL)
    assert agree["torch"] == agree["jax"], agree
    assert not any(LAUNCHES.values())


@pytest.mark.parametrize("arch", list(ARCHS))
def test_inflight_scheduler_matches_jax(arch):
    """8 prompts of 8 tokens served in flight on a Poisson trace (slots 4,
    seg 2, euler, multi-rate, fused) by the port's scheduler and the
    reference's: uid, K, nfe, status, completion order and virtual stamps
    exact, logits within 1e-4, K mixed."""
    cfg_j, cfg_t, pj, pt = model(arch)
    toks = tokens(cfg_j, (8, 8))
    _assert_k_margin(jeng.MultiRateEngine(
        jeng.lm_depth_model(pj, cfg_j), _ecfg(jeng, "euler", True, 8))
        .probe(toks)[1], "euler")
    ref = jwl.replay_scheduler(
        jsch.InflightScheduler(jeng.lm_depth_model(pj, cfg_j),
                               _ecfg(jeng, "euler", True, 8), slots=4,
                               seg=2),
        jwl.poisson_trace(toks, rate=0.25, seed=0))
    rep = twl.replay_scheduler(
        tsch.InflightScheduler(teng.lm_depth_model(pt, cfg_t),
                               _ecfg(teng, "euler", True, 8), slots=4,
                               seg=2),
        twl.poisson_trace(toks, rate=0.25, seed=0))
    key = lambda r: (r.uid, r.K, r.nfe, r.status, r.t_submit, r.t_admit,
                     r.t_done)
    assert len({r.K for r in rep.records}) > 1, "K is not mixed"
    assert all(r.status == "ok" for r in rep.records)
    assert [key(r) for r in rep.records] == [key(r) for r in ref.records]
    for a, b in zip(rep.records, ref.records):
        np.testing.assert_allclose(a.outputs, np.asarray(b.outputs), **TOL)
    assert not any(LAUNCHES.values())


def parity_relations():
    """The attention-to-stream relations the port's parity tests hold
    against the reference: this file's two models and Nemotron-4's
    head-width-192 variant (tests/test_torch_nemotron.py: 2 heads of 192
    over a stream of 64)."""
    cases = [model(arch)[1] for arch in ARCHS]
    cases.append(dataclasses.replace(
        torch_configs.get("nemotron_4_340b").reduced(), **WIDE))
    return {attention_relation(cfg) for cfg in cases}


@pytest.mark.parametrize("arch", torch_configs.ARCH_IDS)
def test_every_attention_width_relation_has_a_parity_case(arch):
    """A registered config's attention may be narrower than its residual
    stream (Mistral-NeMo), as wide (most) or wider (Qwen3-4B); the
    reduced configs are all as wide, so each relation some full config
    has needs a parity case of its own. RWKV6, with no attention block,
    is exempt."""
    cfg = torch_configs.get(arch)
    if not set(tlm.block_pattern(cfg)) & {"dense", "attn", "moe"}:
        assert set(tlm.block_pattern(cfg)) == {"rwkv"}
        return
    assert attention_relation(cfg) in parity_relations(), (
        arch, attention_relation(cfg))
