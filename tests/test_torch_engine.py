"""The port's drain engine (repro_torch/launch/engine.py) held against the
JAX package's ``MultiRateEngine`` on ``qwen3_4b.reduced()`` at 4 layers
(8 prompts of 8 tokens) and ``recurrentgemma_2b.reduced()`` at 14 layers
(4 groups of rec, rec, attn plus 2 tail rec layers; 8 prompts of 16
tokens, past the local window of 8), ``rwkv6_1p6b.reduced()`` at 8
layers (8 rwkv groups; 8 prompts of 16 tokens), ``olmoe_1b_7b.reduced()``
at 4 layers (4 moe groups; 8 prompts of 8 tokens) and
``llama4_maverick_400b_a17b.reduced()`` at 8 layers (4 groups of dense,
moe; 8 prompts of 8 tokens; the probe routes the batch in one dispatch,
a multi-rate step every row alone): the same prompts through
euler, heun and hyper_euler (a nonzero g), fused and unfused, with mixed
K. Per-request uid, K, nfe and status are equal
exactly; outputs agree at fp32 rtol = atol = 1e-4. Also: a correction g
saved by the JAX ``CheckpointManager`` loads into the port.

The tolerances of the probe were picked so that no request's
(err/tol)^(1/q) lies within 1e-3 of an integer (asserted), so rounding
differences between the frameworks cannot flip a K; every token the
port routes clears ``MARGIN`` (asserted)."""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from port_isolation import port_module_isolation  # noqa: F401
from test_torch_moe import MARGIN, routing_margins

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
                       "hyper_euler": (0.12, 1)},
        "olmoe_1b_7b": {"euler": (0.45, 1), "heun": (0.45, 2),
                        "hyper_euler": (0.106, 1)},
        "llama4_maverick_400b_a17b": {"euler": (0.75, 1),
                                      "heun": (0.75, 2),
                                      "hyper_euler": (0.125, 1)}}
# arch -> (layers, prompt tokens) of the reduced model under test
ARCHS = {"qwen3_4b": (4, 8), "recurrentgemma_2b": (14, 16),
         "rwkv6_1p6b": (8, 16), "olmoe_1b_7b": (4, 8),
         "llama4_maverick_400b_a17b": (8, 8)}
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
        with routing_margins() as gaps:
            out = teng.MultiRateEngine(
                model, _ecfg(teng, arch, solver, fused)).run(toks)
        assert not gaps or min(gaps) > MARGIN, min(gaps)
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


# ---------------------------------------------------- failure paths ----
# A toy servable model in both packages: a request x = (lam, z0...) runs
# z' = -lam * z from z0, and the field is NaN wherever |z| > 10, so a
# coarse Euler mesh that overshoots diverges while a finer one does not:
# lam 1 is finite at every bucket, lam 10 from |z0| 2.8 is NaN at K = 2
# (z1 = -4 z0) and finite at K = 4, lam 100 is NaN at every bucket.

TOY_D = 4


def _toy_jax():
    from repro.core import Integrator as JaxIntegrator
    from repro.core import get_tableau as jax_tableau

    def field_of(x):
        x = jnp.asarray(x)
        lam = x[:, :1]
        return lambda s, z: jnp.where(jnp.abs(z) > 10.0, jnp.nan, -lam * z)

    return jeng.DepthModel(
        embed=lambda x: jnp.asarray(x)[:, 1:] + 0.0, field_of=field_of,
        readout=lambda x, zT: zT,
        integ=JaxIntegrator(tableau=jax_tableau("euler")))


def _toy_torch():
    from repro_torch.core.integrate import Integrator
    from repro_torch.core.tableaus import get as torch_tableau

    def field_of(x):
        lam = torch.as_tensor(x)[:, :1]
        return lambda s, z: torch.where(z.abs() > 10.0, float("nan"),
                                        -lam * z)

    return teng.DepthModel(
        embed=lambda x: torch.as_tensor(x)[:, 1:] + 0.0, field_of=field_of,
        readout=lambda x, zT: zT,
        integ=Integrator(tableau=torch_tableau("euler")))


def _toy_requests(lams, z0=2.8):
    xs = np.full((len(lams), TOY_D), z0, np.float32)
    xs[:, 0] = lams
    return xs


@pytest.fixture(autouse=True)
def _rearm_port_warnings():
    """Re-arm the port's one-time warning latches per test, so a warning
    assertion does not depend on test order (tests/conftest.py re-arms
    the reference's)."""
    teng.reset_snap_overflow_warning()
    teng.reset_probe_nonfinite_warning()
    yield


def _drain(eng, xs, now=0.0):
    """Submit xs, step until empty; per-request (uid, K, nfe, status) in
    completion order, and each drain's report."""
    for x in xs:
        eng.submit(x)
    done, reports = [], []
    while len(eng):
        for c in eng.step(now=now):
            done.append((c.uid, c.K, c.nfe, c.status))
        reports.append(eng.last_report)
    return done, reports


def _both(ecfg_kw, xs, **engine_kw):
    """The same requests through the reference's engine and the port's."""
    runs = []
    for mod, toy in ((jeng, _toy_jax), (teng, _toy_torch)):
        eng = mod.MultiRateEngine(toy(), mod.EngineConfig(**ecfg_kw),
                                  **engine_kw)
        runs.append(_drain(eng, xs))
    return runs


def test_engine_retry_ladder_matches_jax():
    """Non-finite outputs requeue once at the next bucket: finite there is
    ``retried``, NaN again is ``diverged``; the failed attempt's NFE is
    charged (tests/test_faults.py::test_engine_overload_and_retry_paths)."""
    xs = _toy_requests([1.0, 10.0, 100.0, 1.0, 10.0])
    (ref, _), (out, reports) = _both(
        dict(buckets=(2, 4, 8), controller="fixed", fixed_K=2, max_batch=4),
        xs)
    assert out == ref
    assert out == [(1, 2, 2, "ok"), (4, 2, 2, "ok"), (2, 4, 6, "retried"),
                   (3, 4, 6, "diverged"), (5, 4, 6, "retried")]
    assert len(reports) == 2


def test_engine_nonfinite_probe_matches_jax():
    """A NaN request probes a non-finite error: ``screen_probe_errors``
    counts it and warns once, the controller sends it to k_max, and the
    retry at the same (top) bucket ends ``diverged``."""
    xs = _toy_requests([1.0, 1.0, 1.0], z0=0.5)
    xs[1, 1] = np.nan
    with pytest.warns(RuntimeWarning, match="non-finite probe error"):
        (ref, ref_reports), (out, reports) = _both(
            dict(buckets=(2, 4, 8), tol=1e-2, max_batch=4), xs)
    assert out == ref
    assert [c[3] for c in sorted(out)] == ["ok", "diverged", "ok"]
    assert dict((c[0], c[1]) for c in out)[2] == 8
    assert [r.probe_nonfinite for r in reports] == \
        [r.probe_nonfinite for r in ref_reports] == [1, 1]


def test_screen_probe_errors_matches_jax():
    errs = np.array([0.1, np.nan, np.inf, 0.2, -np.inf], np.float32)
    for mod in (jeng, teng):
        with pytest.warns(RuntimeWarning, match="non-finite probe error"):
            assert mod.screen_probe_errors(errs) == 3
    with warnings.catch_warnings():      # one-time: silent until re-armed
        warnings.simplefilter("error", RuntimeWarning)
        assert teng.screen_probe_errors(errs[:2]) == 1
        assert teng.screen_probe_errors(errs[[0, 3]]) == 0
    teng.reset_probe_nonfinite_warning()
    with pytest.warns(RuntimeWarning, match="non-finite probe error"):
        teng.screen_probe_errors(errs)


def test_snap_to_buckets_overflow_matches_jax():
    """K above the largest bucket clamps down to it with a one-time
    warning, re-armed by ``reset_snap_overflow_warning``
    (tests/test_engine.py::test_snap_to_buckets*)."""
    Ks = np.array([1, 2, 3, 4, 5, 8])
    for buckets in ((2, 4, 8), (16,)):
        np.testing.assert_array_equal(teng.snap_to_buckets(Ks, buckets),
                                      jeng.snap_to_buckets(Ks, buckets))
    with pytest.warns(RuntimeWarning, match="exceeds the largest"):
        out = teng.snap_to_buckets(np.array([3, 40]), (2, 4, 8))
    np.testing.assert_array_equal(out, [4, 8])
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        np.testing.assert_array_equal(
            teng.snap_to_buckets(np.array([99]), (2, 4, 8)), [8])
    teng.reset_snap_overflow_warning()
    with warnings.catch_warnings():      # in-range snapping never warns
        warnings.simplefilter("error", RuntimeWarning)
        teng.snap_to_buckets(np.array([1, 8]), (2, 4, 8))
    with pytest.warns(RuntimeWarning, match="exceeds the largest"):
        teng.snap_to_buckets(np.array([9]), (2, 4, 8))


def test_engine_degrade_policy_matches_jax():
    """Past the queue cap, ``degrade`` admits everything and serves one
    bucket coarser than the free run (tests/test_faults.py::
    test_overload_degrade_caps_k_under_pressure, for the drain engine)."""
    lams = np.linspace(0.5, 6.0, 8, dtype=np.float32)
    xs = _toy_requests(lams, z0=0.5)
    kw = dict(buckets=(2, 4, 8), tol=2e-2, max_batch=4)
    (free_ref, _), (free, _) = _both(kw, xs)
    (ref, _), (out, reports) = _both(kw, xs, queue_cap=2,
                                     overload_policy="degrade")
    assert free == free_ref and out == ref
    assert len({c[1] for c in free}) > 1, "K is not mixed"
    assert all(c[3] == "ok" for c in out) and len(out) == 8
    k_free = {c[0]: c[1] for c in free}
    assert any(c[1] < k_free[c[0]] for c in out)
    assert all(c[1] <= k_free[c[0]] for c in out)
    assert reports[0].waste_steps == \
        reports[0].total_steps - reports[0].useful_steps


def test_engine_block_policy_raises_queue_full():
    """``block`` raises the engine's own ``QueueFull`` at the cap, and
    ``can_submit`` gates it, as the reference's does."""
    xs = _toy_requests([1.0, 1.0, 1.0], z0=0.5)
    for mod, toy in ((jeng, _toy_jax), (teng, _toy_torch)):
        eng = mod.MultiRateEngine(
            toy(), mod.EngineConfig(buckets=(2,), controller="fixed",
                                    fixed_K=2),
            queue_cap=1, overload_policy="block")
        assert eng.can_submit()
        eng.submit(xs[0])
        assert not eng.can_submit()
        with pytest.raises(mod.QueueFull):
            eng.submit(xs[1])
        assert [c.status for c in eng.step()] == ["ok"]
        assert eng.can_submit()
        eng.submit(xs[1])
        assert [c.uid for c in eng.step()] == [2]


def test_step_report_waste_steps_matches_jax():
    """Masked sample-steps of a mixed-K drain: rows scanned past their own
    K, the reference's ``StepReport.waste_steps``."""
    lams = np.linspace(0.5, 6.0, 8, dtype=np.float32)
    xs = _toy_requests(lams, z0=0.5)
    (_, ref), (_, out) = _both(dict(buckets=(2, 4, 8), tol=2e-2,
                                    max_batch=8), xs)
    assert [(r.useful_steps, r.total_steps, r.waste_steps) for r in out] \
        == [(r.useful_steps, r.total_steps, r.waste_steps) for r in ref]
    assert out[0].waste_steps > 0
    assert teng.StepReport(useful_steps=3, total_steps=8).waste_steps == 5
