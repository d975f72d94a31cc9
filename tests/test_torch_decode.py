"""The port's cached decode path (repro_torch/nn/attention.py decode,
nn/rglru.py::rglru_decode_step, models/lm.py caches, ``lm_prefill``,
``lm_decode_step``, launch/engine.py::greedy_generate and the CLI's
default ``--solver discrete``) held against the JAX package's, float32,
on five reduced models: ``qwen3_4b`` at 2 layers (dense blocks, qk-norm,
GQA 4/2), ``recurrentgemma_2b`` at 8 layers (2 groups of rec, rec, attn
plus 2 tail rec layers, MQA, local window 8), ``rwkv6_1p6b`` at 3
layers (4 WKV heads of 16), ``olmoe_1b_7b`` at 2 layers (moe blocks,
top-2 of 4 experts) and ``llama4_maverick_400b_a17b`` at 4 layers (2
groups of dense, moe; top-1 of 4 and a shared expert). A decode step
routes its B tokens with the einsum dispatch at a capacity factor of at
least 2, and so does each position of the port's prefill (the
reference's prefill is a scan of decode steps); routed tokens clear
``MARGIN`` (asserted). Weights and caches are made by the JAX
package and carried across with ``convert.params_from_jax``; inputs come
from numpy. Tolerance through matmuls: rtol 1e-4, atol 1e-5 (XLA and
PyTorch sum in different orders; the port's prefill runs the
full-sequence forward, the reference scans decode steps). Decode
attention is plain ``jnp`` in the reference, so no Pallas kernel runs on
the JAX side. Under ``set_perf_options(kv_int8=True)`` (both packages,
switched off again after) the int8 caches' payloads are held within one
unit of the reference's and everything else to the same tolerance."""
import contextlib
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from port_isolation import port_module_isolation  # noqa: F401
from test_torch_moe import MARGIN, routing_margins

from repro import configs as jax_configs
from repro.launch import engine as jeng
from repro.models import lm as jlm
from repro.nn import attention as jatt
from repro.nn import rglru as jrg
from repro_torch import configs as torch_configs
from repro_torch.convert import params_from_jax
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import engine as teng
from repro_torch.launch import serve
from repro_torch.models import lm as tlm
from repro_torch.nn import attention as tatt
from repro_torch.nn import rglru as trg

TOL = dict(rtol=1e-4, atol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# arch -> layers of the reduced model under test
ARCHS = {"qwen3_4b": 2, "recurrentgemma_2b": 8, "rwkv6_1p6b": 3,
         "olmoe_1b_7b": 2, "llama4_maverick_400b_a17b": 4}
MOE_ARCHS = ["olmoe_1b_7b", "llama4_maverick_400b_a17b"]
# block kind -> the arch whose reduced model has it
KIND_ARCH = {"dense": "qwen3_4b", "rec": "recurrentgemma_2b",
             "attn": "recurrentgemma_2b", "rwkv": "rwkv6_1p6b",
             "moe": "olmoe_1b_7b"}


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_torch(tree):
    return params_from_jax(to_np(tree))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


def _close_tree(t_tree, j_tree, **tol):
    """Every leaf of the port's tree against the JAX tree's, with the same
    paths, shapes and dtypes."""
    flat_j = jax.tree_util.tree_flatten_with_path(j_tree)[0]
    assert len(flat_j) == len(jax.tree_util.tree_leaves(t_tree))
    for path, leaf in flat_j:
        node = t_tree
        for k in path:
            node = node[k.key]
        leaf = np.asarray(leaf)
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).replace("torch.", "") == leaf.dtype.name, path
        _close(node, leaf, **tol)


def _cfgs(arch):
    n = ARCHS[arch]
    return (dataclasses.replace(jax_configs.get(arch).reduced(), n_layers=n),
            dataclasses.replace(torch_configs.get(arch).reduced(),
                                n_layers=n))


_MODELS = {}


def model(arch):
    """(cfg_j, cfg_t, JAX params, the port's copy) of ``arch``, drawn once."""
    if arch not in _MODELS:
        cfg_j, cfg_t = _cfgs(arch)
        pj = jlm.init_lm(jax.random.PRNGKey(1), cfg_j)
        _MODELS[arch] = (cfg_j, cfg_t, pj, to_torch(pj))
    return _MODELS[arch]


def tokens(cfg, shape, seed=3):
    return np.random.RandomState(seed).randint(0, cfg.vocab,
                                               shape).astype(np.int32)


# ----------------------------------------------------------- attention ----

ATT = dict(n_heads=6, n_kv=2, d_head=4, qk_norm=True)


def _attention(seed=0):
    pj = jatt.attention_init(jax.random.PRNGKey(seed), 24, 6, 2, 4,
                             qk_norm=True)
    x = np.random.RandomState(seed).randn(2, 7, 24).astype(np.float32)
    return pj, to_torch(pj), x


@pytest.mark.parametrize("window", [None, 3])
def test_mha_decode_matches_jax(window):
    """Step by step, output and cache, with qk-norm and GQA 6/2, to 1e-5
    (one layer: no matmul chain to widen the rounding)."""
    pj, pt, x = _attention()
    cj = jatt.init_cache(2, 7, 2, 4, dtype=jnp.float32)
    ct = tatt.init_cache(2, 7, 2, 4, dtype=torch.float32)
    for t in range(7):
        oj, cj = jatt.mha_decode(pj, jnp.asarray(x[:, t:t + 1]), cj,
                                 jnp.asarray(t), window=window, **ATT)
        ot, ct = tatt.mha_decode(pt, torch.from_numpy(x[:, t:t + 1]), ct, t,
                                 window=window, **ATT)
        _close(ot, oj, rtol=1e-5, atol=1e-5)
        _close_tree(ct, cj, rtol=1e-5, atol=1e-5)


def test_mha_decode_matches_full_sequence():
    """The port's own decode reproduces its full-sequence ``mha`` (the
    bound of tests/test_nn_layers.py::test_decode_matches_prefill)."""
    _, pt, x = _attention()
    full = tatt.mha(pt, torch.from_numpy(x), **ATT)
    cache = tatt.init_cache(2, 7, 2, 4, dtype=torch.float32)
    dec = torch.cat([tatt.mha_decode(pt, torch.from_numpy(x[:, t:t + 1]),
                                     cache, t, **ATT)[0] for t in range(7)],
                    dim=1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_mha_return_kv_is_post_rope():
    """``mha(..., return_kv=True)`` hands back the k, v a decode writes."""
    _, pt, x = _attention()
    out, (k, v) = tatt.mha(pt, torch.from_numpy(x), return_kv=True, **ATT)
    assert torch.equal(out, tatt.mha(pt, torch.from_numpy(x), **ATT))
    for t in (0, 4):
        _, k1, v1 = tatt.decode_qkv(pt, torch.from_numpy(x[:, t:t + 1]), t,
                                    rope_theta=1e4, use_rope=True, **ATT)
        np.testing.assert_allclose(k[:, t:t + 1].numpy(), k1.numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(v[:, t:t + 1].numpy(), v1.numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_cross_kv_decode_names_its_roadmap_item():
    """Cross-KV decode (ROADMAP item 6, ported): each query row of x over
    an encoder's K/V from ``precompute_cross_kv``, with qk-norm (on q, and
    on k when the K/V are precomputed) and GQA 6/2, against the
    reference's ``mha_decode(cross_kv=)``; the self cache is returned as
    it was given."""
    pj, pt, x = _attention()
    enc = np.random.RandomState(9).randn(2, 11, 24).astype(np.float32)
    ckv_j = jatt.precompute_cross_kv(pj, jnp.asarray(enc), n_kv=2, d_head=4,
                                     qk_norm=True)
    ckv_t = tatt.precompute_cross_kv(pt, torch.from_numpy(enc), n_kv=2,
                                     d_head=4, qk_norm=True)
    _close_tree(ckv_t, ckv_j, rtol=1e-5, atol=1e-5)
    cache = tatt.init_cache(2, 7, 2, 4, dtype=torch.float32)
    for t in range(3):
        oj, _ = jatt.mha_decode(pj, jnp.asarray(x[:, t:t + 1]), {},
                                jnp.asarray(t), cross_kv=ckv_j, **ATT)
        ot, back = tatt.mha_decode(pt, torch.from_numpy(x[:, t:t + 1]),
                                   cache, t, cross_kv=ckv_t, **ATT)
        _close(ot, oj, rtol=1e-5, atol=1e-5)
        assert back is cache and not cache["k"].any()


def test_rglru_decode_step_matches_jax():
    pj = jrg.rglru_init(jax.random.PRNGKey(2), 32)
    pt = to_torch(pj)
    rs = np.random.RandomState(5)
    h = rs.randn(3, 32).astype(np.float32)
    for t in range(4):
        x = rs.randn(3, 32).astype(np.float32)
        yj, hj = jrg.rglru_decode_step(pj, jnp.asarray(x), jnp.asarray(h))
        yt, ht = trg.rglru_decode_step(pt, torch.from_numpy(x),
                                       torch.from_numpy(h))
        assert yt.dtype == torch.float32 and ht.dtype == torch.float32
        _close(yt, yj)
        _close(ht, hj)
        h = np.array(hj)


# -------------------------------------------------------------- blocks ----

@pytest.mark.parametrize("kind,steps", [("dense", 6), ("rec", 6),
                                        ("attn", 12), ("rwkv", 6),
                                        ("moe", 6)])
def test_block_decode_matches_jax(kind, steps):
    """Each step feeds the port the JAX-made cache of the step before;
    ``attn`` runs 12 steps against Griffin's window of 8, so its rotating
    buffer wraps."""
    cfg_j, cfg_t, pj, pt = model(KIND_ARCH[kind])
    i = jlm.block_pattern(cfg_j).index(kind)
    bj = jax.tree_util.tree_map(lambda l: l[0], pj["groups"][f"b{i}"])
    bt = to_torch(bj)
    cj = jlm.block_cache_init(cfg_j, kind, 2, 16, jnp.float32)
    if kind == "attn":
        assert cj["k"].shape[1] == cfg_j.local_window == 8 < steps
    rs = np.random.RandomState(9)
    for t in range(steps):
        h = rs.randn(2, 1, cfg_j.d_model).astype(np.float32)
        ct = to_torch(cj)
        hj, cj = jlm.block_decode(bj, cfg_j, kind, jnp.asarray(h), cj,
                                  jnp.asarray(t))
        ht, ct = tlm.block_decode(bt, cfg_t, kind, torch.from_numpy(h), ct,
                                  t)
        _close(ht, hj)
        _close_tree(ct, cj)


BF16_ULP = 2.0 ** -8


@pytest.mark.parametrize("kind,steps", [("dense", 4), ("rec", 4),
                                        ("attn", 12), ("rwkv", 4),
                                        ("moe", 4)])
def test_block_decode_bf16_matches_jax(kind, steps):
    """bf16 activations, as the full-width models run: the output and the
    cache leaves keep the reference's dtypes (KV, conv and token-shift
    rows in bf16; RG-LRU h and WKV S in float32). A bf16 tensor is within
    4 bf16 ulps of its largest |value| of JAX's (the frameworks round the
    projections' bf16 results an ulp apart; the largest reading is 1.9
    ulps, RWKV6's output), a float32 state within 1e-5 of its largest
    |value| (readings 3.1e-7 and 8.4e-8: a state rounded through bf16
    would miss it)."""
    cfg_j, cfg_t, pj, pt = model(KIND_ARCH[kind])
    cfg_j = dataclasses.replace(cfg_j, dtype="bfloat16")
    cfg_t = dataclasses.replace(cfg_t, dtype="bfloat16")
    i = jlm.block_pattern(cfg_j).index(kind)
    bj = jax.tree_util.tree_map(lambda l: l[0], pj["groups"][f"b{i}"])
    bt = to_torch(bj)
    cj = jlm.block_cache_init(cfg_j, kind, 2, 16, jnp.bfloat16)
    rs = np.random.RandomState(9)

    def close(t, j, what):
        rel = 4 * BF16_ULP if t.dtype == torch.bfloat16 else 1e-5
        j = np.asarray(jnp.asarray(j, jnp.float32))
        assert np.abs(t.float().numpy() - j).max() \
            <= rel * np.abs(j).max(), what

    for t in range(steps):
        h = rs.randn(2, 1, cfg_j.d_model).astype(np.float32)
        ct = to_torch(cj)
        hj, cj = jlm.block_decode(bj, cfg_j, kind,
                                  jnp.asarray(h, jnp.bfloat16), cj,
                                  jnp.asarray(t))
        ht, ct = tlm.block_decode(bt, cfg_t, kind,
                                  torch.from_numpy(h).to(torch.bfloat16),
                                  ct, t)
        assert ht.dtype == torch.bfloat16
        close(ht, hj, "out")
        assert set(ct) == set(cj)
        for name in cj:
            assert str(ct[name].dtype) == f"torch.{cj[name].dtype}", name
            close(ct[name], cj[name], name)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_lm_cache_matches_jax(arch):
    cfg_j, cfg_t, _, _ = model(arch)
    cj = jlm.init_lm_cache(cfg_j, 3, 20)
    ct = tlm.init_lm_cache(cfg_t, 3, 20)
    _close_tree(ct, cj)
    assert all(not l.any() for l in jax.tree_util.tree_leaves(ct))


# ------------------------------------------------------------- prefill ----

@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("P", [6, 12])
def test_lm_prefill_matches_jax(arch, P):
    """Logits and every cache leaf; 12 tokens wrap Griffin's window."""
    cfg_j, cfg_t, pj, pt = model(arch)
    toks = tokens(cfg_j, (2, P))
    lj, cj = jlm.lm_prefill(pj, cfg_j, jnp.asarray(toks),
                            jlm.init_lm_cache(cfg_j, 2, 16))
    lt, ct = tlm.lm_prefill(pt, cfg_t, torch.from_numpy(toks),
                            tlm.init_lm_cache(cfg_t, 2, 16))
    assert lt.shape == (2, cfg_t.vocab) and lt.dtype == torch.float32
    _close(lt, lj)
    _close_tree(ct, cj)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_prefill_logits_are_forward_last_position(arch, dtype):
    """From position 0 the prefill is the full-sequence forward: its
    logits are the readout of ``lm_forward``'s hidden states at the last
    position, bit for bit, and ``lm_forward``'s last position (a readout
    over every position) to the tolerance; in bf16 activations too, as
    the full-width models run. A MoE model's prefill routes each position
    as a decode step, so its forward is the block stack that fills the
    caches (``_blocks`` with a cache) and its readout over every
    position."""
    _, cfg_t, _, pt = model(arch)
    cfg_t = dataclasses.replace(cfg_t, dtype=dtype)
    toks = torch.from_numpy(tokens(cfg_t, (2, 12)))
    lt, _ = tlm.lm_prefill(pt, cfg_t, toks, tlm.init_lm_cache(cfg_t, 2, 16))
    caches = tlm.init_lm_cache(cfg_t, 2, 16) if cfg_t.n_experts else None
    h, _ = tlm._blocks(pt, cfg_t, tlm._embed(pt, cfg_t, toks), caches)
    assert torch.equal(lt, tlm._readout(pt, cfg_t, h[:, -1:])[:, 0])
    full = tlm._readout(pt, cfg_t, h) if cfg_t.n_experts \
        else tlm.lm_forward(pt, cfg_t, toks)[0]
    _close(lt, full[:, -1].numpy())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_matches_jax_where_decode_capacity_drops(arch):
    """Hazard of a MoE prefill: a decode step gives each expert C =
    ceil(k B 2 / E) slots, so with 8 prompts it drops slots that the
    full-sequence forward (C from all B P tokens at 1.25) keeps. The
    port's prefill routes each position as that decode step (OLMoE here
    with 8 experts, as at full width the decode capacity binds): its
    logits and caches equal the reference's scan of decode steps, with
    slots dropped (asserted), and differ from the forward's last
    position."""
    cfg_j, cfg_t, pj, pt = model(arch)
    if arch == "olmoe_1b_7b":
        cfg_j, cfg_t = (dataclasses.replace(c, n_experts=8)
                        for c in (cfg_j, cfg_t))
        pj = jlm.init_lm(jax.random.PRNGKey(1), cfg_j)
        pt = to_torch(pj)
    toks = tokens(cfg_j, (8, 10))
    lj, cj = jlm.lm_prefill(pj, cfg_j, jnp.asarray(toks),
                            jlm.init_lm_cache(cfg_j, 8, 12))
    dropped, orig = [], tlm.moe_apply

    def recorded(*args, **kw):
        out = orig(*args, **kw)
        dropped.append(float(out.fraction_dropped))
        return out

    tlm.moe_apply = recorded
    try:
        with routing_margins() as gaps:
            lt, ct = tlm.lm_prefill(pt, cfg_t, torch.from_numpy(toks),
                                    tlm.init_lm_cache(cfg_t, 8, 12))
    finally:
        tlm.moe_apply = orig
    assert min(gaps) > MARGIN
    assert max(dropped) > 0, dropped
    _close(lt, lj)
    _close_tree(ct, cj)
    full, _ = tlm.lm_forward(pt, cfg_t, torch.from_numpy(toks))
    assert (full[:, -1] - lt).abs().max() > 1e-2


@pytest.mark.parametrize("arch", list(ARCHS))
def test_lm_prefill_from_later_position_matches_jax(arch):
    """``start_index > 0`` onto a JAX-made cache: the reference's own
    algorithm, one decode step per position."""
    cfg_j, cfg_t, pj, pt = model(arch)
    first, second = tokens(cfg_j, (2, 5), seed=4), tokens(cfg_j, (2, 7))
    _, cj = jlm.lm_prefill(pj, cfg_j, jnp.asarray(first),
                           jlm.init_lm_cache(cfg_j, 2, 16))
    ct = to_torch(cj)
    lj, cj = jlm.lm_prefill(pj, cfg_j, jnp.asarray(second), cj,
                            start_index=5)
    lt, ct = tlm.lm_prefill(pt, cfg_t, torch.from_numpy(second), ct,
                            start_index=5)
    _close(lt, lj)
    _close_tree(ct, cj)


@contextlib.contextmanager
def kv_int8():
    """Both packages' ``kv_int8`` on while open, off again after."""
    jlm.set_perf_options(kv_int8=True)
    tlm.set_perf_options(kv_int8=True)
    try:
        yield
    finally:
        jlm.set_perf_options(kv_int8=False)
        tlm.set_perf_options(kv_int8=False)


def _int8_cache_close(t_tree, j_tree):
    """An int8 cache against the reference's: the same tree, payloads
    within one unit (k and v come from matmuls, so a value over its scale
    may round the other way), scales and float leaves to the tolerance."""
    flat_j = jax.tree_util.tree_flatten_with_path(j_tree)[0]
    assert len(flat_j) == len(jax.tree_util.tree_leaves(t_tree))
    for path, leaf in flat_j:
        node = t_tree
        for k in path:
            node = node[k.key]
        leaf = np.asarray(leaf)
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).replace("torch.", "") == leaf.dtype.name, path
        if leaf.dtype == np.int8:
            diff = np.abs(node.numpy().astype(np.int32) - leaf)
            assert diff.max() <= 1, (path, diff.max())
        else:
            _close(node, leaf)


@pytest.mark.parametrize("arch", ["qwen3_4b", "olmoe_1b_7b"])
def test_int8_cache_prefill_and_decode_match_jax(arch):
    """Under ``set_perf_options(kv_int8=True)`` on both sides: int8 caches
    (payloads int8, scales float32 (n_groups, B, S, KV)), a prefill of 6
    tokens from position 0 (the port: flash over the dequantized k and
    v; the reference: a scan of decode steps), 4 more from position 6,
    then 3 decode steps, logits and caches against the reference's at
    each stage; and the port's ``greedy_generate`` under the option
    equals the argmax chain of its own prefill and decode steps."""
    cfg_j, cfg_t, pj, pt = model(arch)
    first, second = tokens(cfg_j, (2, 6), seed=4), tokens(cfg_j, (2, 4))
    with kv_int8():
        cj, ct = jlm.init_lm_cache(cfg_j, 2, 16), tlm.init_lm_cache(
            cfg_t, 2, 16)
        g = ct["groups"]["b0"]
        assert g["k"].dtype == torch.int8 and g["k_scale"].dtype == \
            torch.float32 and g["k_scale"].shape == (
                tlm.group_layout(cfg_t)[1], 2, 16, cfg_t.n_kv)
        _int8_cache_close(ct, cj)
        lj, cj = jlm.lm_prefill(pj, cfg_j, jnp.asarray(first), cj)
        lt, ct = tlm.lm_prefill(pt, cfg_t, torch.from_numpy(first), ct)
        _close(lt, lj)
        _int8_cache_close(ct, cj)
        lj, cj = jlm.lm_prefill(pj, cfg_j, jnp.asarray(second), cj,
                                start_index=6)
        lt, ct = tlm.lm_prefill(pt, cfg_t, torch.from_numpy(second), ct,
                                start_index=6)
        _close(lt, lj)
        for t in range(10, 13):
            tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
            lj, cj = jlm.lm_decode_step(pj, cfg_j, jnp.asarray(tok), cj,
                                        jnp.asarray(t))
            lt, ct = tlm.lm_decode_step(pt, cfg_t, torch.from_numpy(tok), ct,
                                        t)
            _close(lt, lj)
        _int8_cache_close(ct, cj)
        prompt = np.concatenate([first, second], axis=1)
        out = teng.greedy_generate(pt, cfg_t, prompt, 4)
        caches = tlm.init_lm_cache(cfg_t, 2, 14)
        logits, caches = tlm.lm_prefill(pt, cfg_t, torch.from_numpy(prompt),
                                        caches)
        chain = [logits.argmax(-1)]
        for t in range(10, 13):
            logits, caches = tlm.lm_decode_step(pt, cfg_t, chain[-1], caches,
                                                t)
            chain.append(logits.argmax(-1))
    np.testing.assert_array_equal(out.numpy(), torch.stack(chain, 1).numpy())


def test_int8_cache_only_where_unwindowed():
    """``kv_int8`` leaves a windowed (rotating) cache in the activation
    type, as the reference's ``block_cache_init``: Griffin's local
    attention keeps float32 caches; the option off, Qwen3's are float32."""
    cfg_j, cfg_t, _, _ = model("recurrentgemma_2b")
    with kv_int8():
        ct, cj = tlm.init_lm_cache(cfg_t, 2, 20), jlm.init_lm_cache(
            cfg_j, 2, 20)
    _close_tree(ct, cj)
    assert all(l.dtype != torch.int8 for l in
               jax.tree_util.tree_leaves(ct))
    _, cfg_q, _, _ = model("qwen3_4b")
    assert tlm.init_lm_cache(cfg_q, 2, 8)["groups"]["b0"]["k"].dtype == \
        torch.float32


def test_prefill_longer_than_unwindowed_cache_raises():
    """An unwindowed KV cache holds every position: a longer prompt is
    refused, not clamped."""
    _, cfg_t, _, pt = model("qwen3_4b")
    toks = torch.from_numpy(tokens(cfg_t, (2, 9)))
    with pytest.raises(ValueError, match="prefill of 9 positions"):
        tlm.lm_prefill(pt, cfg_t, toks, tlm.init_lm_cache(cfg_t, 2, 8))


# -------------------------------------------------------------- decode ----

@pytest.mark.parametrize("arch", list(ARCHS))
def test_lm_decode_chain_matches_jax(arch):
    """Decode steps from an empty cache against JAX's, logits and caches
    (tests/test_arch_smoke.py::test_reduced_decode_step, 6 steps)."""
    cfg_j, cfg_t, pj, pt = model(arch)
    cj, ct = jlm.init_lm_cache(cfg_j, 2, 16), tlm.init_lm_cache(cfg_t, 2, 16)
    tok = np.zeros((2,), np.int32)
    for t in range(6):
        lj, cj = jlm.lm_decode_step(pj, cfg_j, jnp.asarray(tok), cj,
                                    jnp.asarray(t))
        lt, ct = tlm.lm_decode_step(pt, cfg_t, torch.from_numpy(tok), ct, t)
        assert lt.shape == (2, cfg_t.vocab) and torch.isfinite(lt).all()
        _close(lt, lj)
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    _close_tree(ct, cj)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_matches_forward(arch):
    """Token-by-token decode logits equal the teacher-forced forward's
    (tests/test_arch_smoke.py::test_decode_matches_forward, its bound; a
    MoE model's, whose decode and forward may drop different slots, agree
    by argmax at its bound 0.65), and the JAX decode's to the float32
    tolerance."""
    cfg_j, cfg_t, pj, pt = model(arch)
    toks = tokens(cfg_t, (1, 10))
    full, _ = tlm.lm_forward(pt, cfg_t, torch.from_numpy(toks))
    ct, cj = tlm.init_lm_cache(cfg_t, 1, 10), jlm.init_lm_cache(cfg_j, 1, 10)
    outs = []
    for t in range(10):
        lt, ct = tlm.lm_decode_step(pt, cfg_t, torch.from_numpy(toks[:, t]),
                                    ct, t)
        lj, cj = jlm.lm_decode_step(pj, cfg_j, jnp.asarray(toks[:, t]), cj,
                                    jnp.asarray(t))
        _close(lt, lj)
        outs.append(lt)
    dec = torch.stack(outs, 1)
    if cfg_t.n_experts:
        assert float((dec.argmax(-1) == full.argmax(-1)).float().mean()) \
            > 0.65
    else:
        np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=5e-3,
                                   atol=5e-4)


def test_readout_weight_keeps_logits_bit_for_bit():
    """A prebuilt float32 readout matrix gives the logits ``_readout``
    builds for itself, for tied (Qwen3) and untied (RWKV6) vocabularies."""
    for arch in ("qwen3_4b", "rwkv6_1p6b"):
        _, cfg_t, _, pt = model(arch)
        h = torch.from_numpy(np.random.RandomState(0).randn(
            2, 3, cfg_t.d_model).astype(np.float32))
        w = tlm.readout_weight(pt, cfg_t, torch.float32)
        assert w.shape == (cfg_t.d_model, cfg_t.vocab)
        assert torch.equal(tlm._readout(pt, cfg_t, h, w),
                           tlm._readout(pt, cfg_t, h))


# ------------------------------------------------------------ generate ----

def _greedy_logits(lm, params, cfg, prompt, toks, tensor, index):
    """One package's logits at every generated position, fed the tokens
    ``toks`` (B, gen) after the prompt (teacher-forced greedy path)."""
    B, P = prompt.shape
    gen = toks.shape[1]
    caches = lm.init_lm_cache(cfg, B, P + gen)
    logits, caches = lm.lm_prefill(params, cfg, tensor(prompt), caches)
    out = [np.asarray(logits)]
    for i, t in enumerate(range(P, P + gen - 1)):
        logits, caches = lm.lm_decode_step(params, cfg, tensor(toks[:, i]),
                                           caches, index(t))
        out.append(np.asarray(logits))
    return np.stack(out, 1)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_greedy_generate_matches_jax(arch):
    """Tokens equal the reference's ``greedy_generate``. Along that path the
    port's logits are held to 1e-5 of each step's largest |logit| (a logit
    is a d-term sum whose rounding scales with its terms), and every
    step's top-2 logit gap on the JAX side exceeds 100x that tolerance, so
    a rounding flip cannot decide a token (the guard fails loudly if it
    does not)."""
    cfg_j, cfg_t, pj, pt = model(arch)
    prompt = tokens(cfg_j, (2, 12))
    ref = np.array(jeng.greedy_generate(pj, cfg_j, jnp.asarray(prompt), 8))
    lj = _greedy_logits(jlm, pj, cfg_j, prompt, ref, jnp.asarray,
                        jnp.asarray)
    np.testing.assert_array_equal(lj.argmax(-1), ref)
    lt = _greedy_logits(tlm, pt, cfg_t, prompt, ref, torch.from_numpy, int)
    tol = 1e-5 * np.abs(lj).max(-1, keepdims=True)
    assert (np.abs(lt - lj) <= tol).all(), np.abs(lt - lj).max()
    top2 = np.sort(lj, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    assert (gap > 100 * tol[..., 0]).all(), (gap.min(), tol.max())
    out = teng.greedy_generate(pt, cfg_t, prompt, 8)
    assert out.dtype == torch.int32 and out.shape == (2, 8)
    np.testing.assert_array_equal(out.numpy(), ref)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert not any(LAUNCHES.values())


# ----------------------------------------------------------------- CLI ----

@pytest.mark.parametrize("arch", list(ARCHS))
def test_cli_default_serves_discrete_decode(capsys, arch):
    """No ``--solver``: the reference's default, the cached decode."""
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "8"])
    lines = capsys.readouterr().out.splitlines()
    n_groups = tlm.group_layout(out["cfg"])[1]
    assert lines[0].startswith("[discrete] 2x8 tokens in ")
    assert lines[0].endswith(f"tok/s), NFE/token = {n_groups} groups")
    assert lines[1].startswith("sample: [")
    toks = out["tokens"]
    assert toks.shape == (2, 8) and toks.dtype == np.int32
    assert ((0 <= toks) & (toks < out["cfg"].vocab)).all()
    assert out["seconds"] > 0 and out["prompt"].shape == (2, 8)
    ref = teng.greedy_generate(out["params"], out["cfg"], out["prompt"], 8)
    np.testing.assert_array_equal(toks, ref.numpy())


def test_cli_default_without_device_exits_nonzero_here():
    """Without ``--device cpu`` the default path asks for CUDA; with no
    card it exits non-zero and serves nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "rwkv6_1p6b", "--reduced", "--batch", "2", "--prompt-len", "8",
         "--gen", "8"], capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert "[discrete]" not in proc.stdout
