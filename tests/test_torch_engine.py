"""The port's drain engine (repro_torch/launch/engine.py) held against the
JAX package's ``MultiRateEngine`` on ``qwen3_4b.reduced()`` at 4 layers
(8 prompts of 8 tokens) and ``recurrentgemma_2b.reduced()`` at 14 layers
(4 groups of rec, rec, attn plus 2 tail rec layers; 8 prompts of 16
tokens, past the local window of 8) and ``rwkv6_1p6b.reduced()`` at 8
layers (8 rwkv groups; 8 prompts of 16 tokens): the same prompts through
euler, heun and hyper_euler (a nonzero g), fused and unfused, with mixed
K. Per-request uid, K, nfe and status are equal
exactly; outputs agree at fp32 rtol = atol = 1e-4. Also: a correction g
saved by the JAX ``CheckpointManager`` loads into the port.

The tolerances of the probe were picked so that no request's
(err/tol)^(1/q) lies within 1e-3 of an integer (asserted), so rounding
differences between the frameworks cannot flip a K."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get as jax_get
from repro.launch import engine as jeng
from repro.models.cdepth import lm_g_init as jax_g_init
from repro.models.lm import init_lm as jax_init_lm
from repro_torch.configs import get as torch_get
from repro_torch.convert import params_from_jax
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import engine as teng

# arch -> solver -> (probe tolerance, probe order q)
TOLS = {"qwen3_4b": {"euler": (0.5, 1), "heun": (0.13, 2),
                     "hyper_euler": (0.11, 1)},
        "recurrentgemma_2b": {"euler": (0.63, 1), "heun": (0.15, 2),
                              "hyper_euler": (0.132, 1)},
        "rwkv6_1p6b": {"euler": (0.7, 1), "heun": (0.7, 2),
                       "hyper_euler": (0.12, 1)}}
# arch -> (layers, prompt tokens) of the reduced model under test
ARCHS = {"qwen3_4b": (4, 8), "recurrentgemma_2b": (14, 16),
         "rwkv6_1p6b": (8, 16)}
BUCKETS = (2, 4, 8)


@functools.lru_cache(maxsize=None)
def _setup(arch="qwen3_4b"):
    n_layers, n_tok = ARCHS[arch]
    cfg_j = dataclasses.replace(jax_get(arch).reduced(), n_layers=n_layers)
    cfg_t = dataclasses.replace(torch_get(arch).reduced(), n_layers=n_layers)
    pj = jax_init_lm(jax.random.PRNGKey(0), cfg_j)
    gj = jax_g_init(jax.random.PRNGKey(5), cfg_j, rank=8,
                    param_dtype=jnp.float32)
    gj = dict(gj, w_out=0.2 * jax.random.normal(jax.random.PRNGKey(6),
                                                gj["w_out"].shape))
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    toks = np.random.RandomState(0).randint(0, cfg_j.vocab, (8, n_tok))
    return (cfg_j, cfg_t, pj, params_from_jax(to_np(pj)), gj,
            params_from_jax(to_np(gj)), toks.astype(np.int32))


def _ecfg(mod, arch, solver, fused):
    return mod.EngineConfig(buckets=BUCKETS, tol=TOLS[arch][solver][0],
                            max_batch=4, solver=solver, fused=fused)


@functools.lru_cache(maxsize=None)
def _jax_run(arch, solver, fused):
    cfg_j, _, pj, _, gj, _, toks = _setup(arch)
    g = gj if solver.startswith("hyper_") else None
    eng = jeng.MultiRateEngine(
        jeng.lm_depth_model(pj, cfg_j, solver=solver, g_params=g),
        _ecfg(jeng, arch, solver, fused))
    _, errs = eng.probe(toks)
    return eng.run(toks), errs


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("solver", ["euler", "heun", "hyper_euler"])
@pytest.mark.parametrize("fused", [False, True])
def test_engine_matches_jax(arch, solver, fused):
    _, cfg_t, _, pt, _, gt, toks = _setup(arch)
    ref, errs = _jax_run(arch, solver, fused)
    tol, q = TOLS[arch][solver]
    r = (errs.astype(np.float64) / tol) ** (1.0 / q)
    assert np.abs(r - np.round(r)).min() > 1e-3, r

    g = gt if solver.startswith("hyper_") else None
    models = [teng.lm_depth_model(pt, cfg_t, solver=solver, g_params=g)]
    if g is not None:   # the parametric (refinable) correction path too
        models.append(teng.lm_depth_model(pt, cfg_t, solver=solver,
                                          g_params=g, refinable=True))
    for model in models:
        out = teng.MultiRateEngine(
            model, _ecfg(teng, arch, solver, fused)).run(toks)
        assert len({c.K for c in out}) > 1, "K is not mixed"
        for a, b in zip(out, ref):
            assert (a.uid, a.K, a.nfe, a.status) == \
                (b.uid, b.K, b.nfe, b.status)
            assert a.fused_kernel == b.fused_kernel == fused
            np.testing.assert_allclose(a.err_probe, b.err_probe, rtol=1e-4)
            np.testing.assert_allclose(a.outputs, np.asarray(b.outputs),
                                       rtol=1e-4, atol=1e-4)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert not any(LAUNCHES.values())


def test_engine_admission_policies_match_jax():
    """Shed past a bounded queue and drop past a deadline, as the
    reference does (fixed controller: no probe)."""
    cfg_j, cfg_t, pj, pt, _, _, toks = _setup()
    runs = []
    for mod, params, cfg in [(jeng, pj, cfg_j), (teng, pt, cfg_t)]:
        eng = mod.MultiRateEngine(
            mod.lm_depth_model(params, cfg, solver="euler"),
            mod.EngineConfig(buckets=(2,), controller="fixed", fixed_K=2),
            queue_cap=3)
        for i, x in enumerate(toks[:5]):
            eng.submit(x, deadline=(0.5 if i == 1 else None))
        done = sorted(eng.step(now=1.0), key=lambda c: c.uid)
        runs.append([(c.uid, c.K, c.nfe, c.status) for c in done])
    assert runs[0] == runs[1]
    assert [r[3] for r in runs[1]] == ["ok", "deadline", "ok", "shed", "shed"]


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_load_g_params_reads_jax_checkpoint(tmp_path, codec):
    """A correction saved by the JAX CheckpointManager restores leaf for
    leaf (JAX stores dict leaves in sorted key order)."""
    if codec == "zstd":
        pytest.importorskip("zstandard")
    cfg_j, cfg_t, _, _, gj, _, _ = _setup()
    cm = JaxCheckpointManager(str(tmp_path), codec=codec)
    cm.save(3, gj)
    cm.save(7, jax.tree_util.tree_map(lambda x: 2 * x, gj))
    gt = teng.load_g_params(str(tmp_path), cfg_t, rank=8)
    assert sorted(gt) == sorted(gj)
    for k in gj:
        assert gt[k].dtype == torch.float32
        np.testing.assert_array_equal(gt[k].numpy(), 2 * np.asarray(gj[k]))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        teng.load_g_params(str(empty), cfg_t, rank=8)


def test_params_from_jax_keeps_bf16_bits():
    tree = {"a": {"kernel": jnp.asarray(np.random.RandomState(1).randn(5, 3),
                                        jnp.bfloat16)},
            "b": [jnp.arange(4, dtype=jnp.int32), None]}
    out = params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    assert out["a"]["kernel"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["a"]["kernel"].view(torch.int16).numpy(),
        np.asarray(tree["a"]["kernel"]).view(np.int16))
    assert out["b"][0].dtype == torch.int32 and out["b"][1] is None
