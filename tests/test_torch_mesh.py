"""The port's serving mesh (repro_torch/launch/mesh.py) and its sharded
paths (``Integrator.solve``/``solve_segment``/``segment_cell`` with
``mesh=``, ``InflightScheduler(mesh=)``, ``serve --inflight --mesh N``)
held against the JAX package on the CPU; the counterparts of
tests/test_mesh.py, the sharded solve of tests/test_runtime_eps.py and
the sharded slot pool of tests/test_scheduler.py.

The policy checks run on a stub mesh, as the reference's do. The sharded
paths run on a 4-entry CPU mesh (``make_serving_mesh(4, device="cpu")``,
the counterpart of the reference's forced host device count). The
reference's own sharded-pool test fails on this container's jax
(``jax.set_mesh``), so the port's sharded pool is held against the
reference's single-device pool, which the reference asserts its sharded
pool equals: uid, K, nfe, status, completion order and virtual stamps
exact, outputs at the scheduler parity tolerances (1e-6 toy state, 1e-5
toy heads, 1e-4 through an LM). Against the port's own unsharded pool
the sharded one is equal bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from port_isolation import port_module_isolation  # noqa: F401
from test_torch_faults import _injectors, _jsched, _sched
from test_torch_faults import _trace as fault_trace
from test_torch_flow import _JAX_TOY as FLOW_JAX_TOY
from test_torch_flow import MIX as FLOW_MIX
from test_torch_flow import _ecfg as flow_ecfg
from test_torch_flow import _toy as flow_toy
from test_torch_moe import MARGIN, routing_margins
from test_torch_scheduler import (G, G_JAX, LOOPS, _field, _field_jax, _key,
                                  _lm_setup, _toy, _toy_jax,
                                  assert_loops_equal, assert_records_match)

from repro.core import FixedGrid as JaxGrid
from repro.core import Integrator as JaxIntegrator
from repro.core import get_tableau as jax_tableau
from repro.core.controllers import \
    EmbeddedErrorController as JaxEmbeddedController
from repro.launch import engine as jeng
from repro.launch import refinery as jref
from repro.launch import scheduler as jsch
from repro.launch import workload as jwl
from repro_torch.configs import get as torch_get
from repro_torch.core import (FixedGrid, Integrator, get_tableau,
                              make_segment_carry)
from repro_torch.core.controllers import EmbeddedErrorController
from repro_torch.launch import engine as teng
from repro_torch.launch import scheduler as tsch
from repro_torch.launch import serve
from repro_torch.launch import workload as twl
from repro_torch.launch.mesh import (ServingMesh, batch_axes,
                                     make_serving_mesh, sharded_segment,
                                     sharded_segment_cell, sharded_solve)
from repro_torch.launch.refinery import ResidualLedger
from repro_torch.models.cdepth import lm_g_apply, lm_g_init

MESH = make_serving_mesh(4, device="cpu")


class _StubMesh:
    """Shape/axis metadata double for the pre-dispatch policy checks
    (they read nothing else before raising)."""

    def __init__(self, n_data=3):
        self.shape = {"data": n_data, "model": 2}
        self.axis_names = ("data", "model")


# --------------------------------------------------------- policy layer ----

def test_sharded_solve_rejects_indivisible_batch():
    integ = Integrator(get_tableau("euler"))
    with pytest.raises(ValueError, match="does not divide"):
        sharded_solve(integ, _field, torch.ones((8, 4)),
                      FixedGrid.over(0.0, 1.0, 2), mesh=_StubMesh(3))


def test_sharded_solve_rejects_indivisible_pytree_batch():
    integ = Integrator(get_tableau("euler"))
    z0 = (torch.ones((5, 3)), torch.ones((5, 2)))
    with pytest.raises(ValueError, match="does not divide"):
        sharded_solve(integ, lambda s, z: z, z0,
                      FixedGrid.over(0.0, 1.0, 2), mesh=_StubMesh(2))


def test_sharded_solve_rejects_bad_eps_rank():
    integ = Integrator(get_tableau("euler"))
    bad = FixedGrid(0.0, torch.ones((6, 2)), 2)
    with pytest.raises(ValueError, match="scalar or"):
        sharded_solve(integ, _field, torch.ones((6, 4)), bad,
                      mesh=_StubMesh(3))


def test_segment_paths_reject_indivisible_slot_count():
    """``solve_segment(mesh=)``, ``sharded_segment`` and
    ``InflightScheduler(mesh=)`` refuse a pool the axis cannot split, with
    the remedy, before any device work."""
    integ = Integrator(get_tableau("euler"))
    carry = make_segment_carry(torch.ones((8, 4)), [2] * 8, (0.0, 1.0))
    with pytest.raises(ValueError, match="does not divide"):
        integ.solve_segment(_field, carry, 2, mesh=_StubMesh(3))
    carry = make_segment_carry(torch.ones((5, 4)), [2] * 5, (0.0, 1.0))
    with pytest.raises(ValueError, match="does not divide"):
        sharded_segment(integ, lambda x: _field, torch.ones((5, 4)), carry,
                        2, mesh=_StubMesh(2))
    with pytest.raises(ValueError, match="does not divide"):
        tsch.InflightScheduler(_toy(), teng.EngineConfig(), slots=5, seg=2,
                               mesh=_StubMesh(3))


def test_make_serving_mesh_entries_and_oversubscription(monkeypatch):
    """CPU entries on request; on CUDA ``cuda:0 .. cuda:n-1``, and more
    than the visible cards is the reference's error with this package's
    remedy. A directly built mesh may repeat a device."""
    m = make_serving_mesh(3, device="cpu")
    assert m.devices == (torch.device("cpu"),) * 3
    assert m.shape == {"data": 3} and m.size == 3
    assert m.axis_names == ("data",) and batch_axes(m) == ("data",)
    assert ServingMesh(("cpu", "cpu")).devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match=">= 1"):
        make_serving_mesh(0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_serving_mesh(2).devices == (torch.device("cuda", 0),
                                            torch.device("cuda", 1))
    with pytest.raises(ValueError, match=r"visible \(2\).*--device cpu"):
        make_serving_mesh(3)


def test_batch_axes_policy():
    assert batch_axes(_StubMesh()) == ("data",)

    class _PodMesh(_StubMesh):
        def __init__(self):
            super().__init__()
            self.axis_names = ("pod", "data", "model")

    assert batch_axes(_PodMesh()) == ("pod", "data")


# ------------------------------------------------------- sharded solves ----

def _solve_field_jax(s, z):
    return -z * jax.numpy.tanh(jax.numpy.mean(z, -1, keepdims=True) + 2.0)


def _solve_field(s, z):
    return -z * torch.tanh(z.mean(-1, keepdim=True) + 2.0)


@pytest.mark.parametrize("case", ["plain", "batched_eps", "controller"])
def test_sharded_solve_equals_reference(case):
    """``sharded_solve`` on a 4-entry mesh equals the reference's
    single-device ``Integrator.solve`` (1e-6, as the reference's sharded
    test) and the port's own unsharded solve bit for bit."""
    z0 = np.random.RandomState(0).randn(8, 16).astype(np.float32)
    integ = Integrator(get_tableau("heun"), fused=True)
    jinteg = JaxIntegrator(jax_tableau("heun"), fused=True)
    zt = torch.from_numpy(z0)
    if case == "controller":
        kw = dict(return_traj=False,
                  controller=EmbeddedErrorController(tol=0.03, k_min=1,
                                                     k_max=8))
        (res, st) = integ.solve(_solve_field, zt, FixedGrid.over(0., 1., 8),
                                mesh=MESH, **kw)
        (one, st1) = integ.solve(_solve_field, zt,
                                 FixedGrid.over(0., 1., 8), **kw)
        jres, jst = jinteg.solve(
            _solve_field_jax, z0, JaxGrid.over(0.0, 1.0, 8),
            return_traj=False, controller=JaxEmbeddedController(
                tol=0.03, k_min=1, k_max=8))
        assert st.K.tolist() == np.asarray(jst.K).tolist() == st1.K.tolist()
        assert st.nfe.tolist() == np.asarray(jst.nfe).tolist()
        assert st.probe_nfe == jst.probe_nfe == st1.probe_nfe
        assert len(set(st.K.tolist())) > 1
        r = np.sqrt(st.err_probe.numpy().astype(np.float64) / 0.03)
        assert np.abs(r - np.round(r)).min() > 1e-3, r
    else:
        eps = np.linspace(0.1, 0.25, 8).astype(np.float32)
        grid = FixedGrid.over(0.0, 1.0, 4) if case == "plain" else \
            FixedGrid(0.0, torch.from_numpy(eps), 4)
        jgrid = JaxGrid.over(0.0, 1.0, 4) if case == "plain" else \
            JaxGrid(0.0, jax.numpy.asarray(eps), 4)
        res = sharded_solve(integ, _solve_field, zt, grid, mesh=MESH)
        one = integ.solve(_solve_field, zt, grid)
        jres = jinteg.solve(_solve_field_jax, z0, jgrid)
        assert tuple(res.shape) == (5, 8, 16)
    assert torch.equal(res, one)
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("with_g", [False, True])
def test_sharded_segments_equal_reference_multirate(with_g):
    """``solve_segment(mesh=)`` segment by segment on a 4-entry mesh
    equals the reference's ``solve_multirate`` (1e-6), with and without a
    correction, and ``sharded_segment`` (per-slot conditioning threaded
    with the carry) equals the unsharded segment bit for bit."""
    z0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (8, 17)))
    Ks = [1, 2, 5, 8, 3, 4, 8, 2]
    integ = Integrator(get_tableau("heun"), g=G if with_g else None,
                       fused=True)
    jinteg = JaxIntegrator(jax_tableau("heun"), g=G_JAX if with_g else None,
                           fused=True)
    zt = torch.from_numpy(z0)
    fs = _field(0.0, zt)
    ref = jinteg.solve_multirate(_field_jax, z0, (0.0, 1.0),
                                 jax.numpy.asarray(Ks, jax.numpy.int32), 8,
                                 first_stage=_field_jax(0.0, z0))
    carry = make_segment_carry(zt, Ks, (0.0, 1.0), first_stage=fs)
    for _ in range(4):
        carry, fin = integ.solve_segment(_field, carry, 2, mesh=MESH)
    assert bool(fin.all()) and carry.k.tolist() == Ks
    np.testing.assert_allclose(carry.z.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)

    xs = torch.from_numpy(np.random.RandomState(1).randn(8, 17)
                          .astype(np.float32))

    def field_of(x):
        k = torch.nn.functional.softplus(x.mean(dim=-1, keepdim=True))
        return lambda s, z: -z * k

    a = b = make_segment_carry(zt, Ks, (0.0, 1.0))
    for _ in range(3):
        a, fa = sharded_segment(integ, field_of, xs, a, 3, mesh=MESH)
        b, fb = integ.solve_segment(field_of(xs), b, 3)
    assert torch.equal(a.z, b.z) and torch.equal(a.k, b.k)
    assert torch.equal(fa, fb)


def test_sharded_segment_cell_equals_the_cell_in_place():
    """``sharded_segment_cell`` over a 4-entry mesh: each shard's ``z``
    written in place (the same tensors come back), ``fs`` untouched, and
    the gathered ``[k'; finished; nonfinite]`` meta and states bit for
    bit the unsharded cell's, with a parametric correction per shard."""
    rs = np.random.RandomState(2)
    xs = torch.from_numpy(rs.randn(8, 17).astype(np.float32))
    z0 = torch.from_numpy(rs.randn(8, 17).astype(np.float32))
    k = torch.tensor([0, 1, 0, 3, 2, 0, 5, 1], dtype=torch.int32)
    Ks = torch.tensor([2, 4, 8, 4, 2, 1, 8, 2], dtype=torch.int32)
    eps = 1.0 / Ks.to(torch.float32)
    fs = _field(0.0, z0)

    def field_of(x):
        a = torch.nn.functional.softplus(x.mean(dim=-1, keepdim=True))
        return lambda s, z: -z * a

    gp = {"w": torch.tensor(0.3)}
    g_apply = lambda p, e, s, z, dz: p["w"] * dz * e.reshape(-1, 1)
    integ = Integrator(get_tableau("heun"), fused=True)
    one = integ.segment_cell(field_of, 3, g_apply=g_apply)
    cell = sharded_segment_cell(integ, field_of, 3, mesh=MESH,
                                g_apply=g_apply)
    z_one = z0.clone()
    _, _, meta_one = one(xs, z_one, k, Ks, eps, fs, gp)
    z_sh, fs_sh = MESH.split(z0, copy=True), MESH.split(fs)
    leaves = [z.data_ptr() for z in z_sh]
    z_ret, fs_ret, meta = cell(MESH.split(xs), z_sh,
                               *(MESH.split(t) for t in (k, Ks, eps)), fs_sh,
                               MESH.replicas(gp))
    assert z_ret is z_sh and fs_ret is fs_sh
    assert [z.data_ptr() for z in z_ret] == leaves
    assert torch.equal(MESH.gather(z_sh), z_one)
    assert torch.equal(meta, meta_one) and meta.shape == (3, 8)
    assert int(meta[1].sum()) not in (0, 8)


# ------------------------------------------------------------ the pool ----

def _replay(model, ecfg, trace, mesh=None, **kw):
    return twl.replay_scheduler(tsch.InflightScheduler(
        model, ecfg, mesh=mesh, **kw), trace)


@LOOPS
def test_sharded_pool_equals_reference_and_unsharded_pool(overlap):
    """The toy model on a Poisson trace (slots 8 over 4 entries): the
    records equal the reference's single-device pool's (outputs 1e-6, the
    summary exactly) and the port's unsharded pool's bit for bit; sync
    and overlap alike."""
    kw = dict(buckets=(2, 4, 8, 16), tol=5e-3, max_batch=8, fused=True)
    xs = twl.heterogeneous_requests(24, 8, seed=2)
    rep = _replay(_toy(fused=True), teng.EngineConfig(**kw),
                  twl.poisson_trace(xs, rate=0.5, seed=4), MESH, slots=8,
                  seg=2, overlap=overlap)
    one = _replay(_toy(fused=True), teng.EngineConfig(**kw),
                  twl.poisson_trace(xs, rate=0.5, seed=4), slots=8, seg=2,
                  overlap=overlap)
    ref = jwl.replay_scheduler(jsch.InflightScheduler(
        _toy_jax(fused=True), jeng.EngineConfig(**kw), slots=8, seg=2),
        jwl.poisson_trace(xs, rate=0.5, seed=4))
    assert len(rep.records) == 24 and len({r.K for r in rep.records}) > 1
    assert_loops_equal(rep.records, one.records)
    assert_records_match(rep.records, ref.records, rtol=1e-6, atol=1e-6)
    assert twl.latency_stats(rep) == jwl.latency_stats(ref)


def test_one_segment_cell_per_shape_seg_and_mesh(monkeypatch):
    """Every refill pattern of a trace runs through ONE sharded segment
    call per (shape, seg, mesh): the pool builds it once."""
    built = []
    orig = Integrator.segment_cell

    def counted(self, *args, **kwargs):
        built.append(kwargs.get("mesh"))
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(Integrator, "segment_cell", counted)
    xs = twl.heterogeneous_requests(24, 8, seed=2)
    sched = tsch.InflightScheduler(
        _toy(fused=True), teng.EngineConfig(buckets=(2, 4, 8, 16), tol=5e-3,
                                            fused=True),
        slots=8, seg=2, mesh=MESH)
    rep = twl.replay_scheduler(sched, twl.poisson_trace(xs, rate=0.5,
                                                        seed=4))
    assert len(rep.records) == 24 and sched.dispatches > 3
    assert built == [MESH]


@LOOPS
def test_sharded_pool_under_faults_equals_reference(overlap):
    """A transient-poison schedule (quarantine, requeue, retry), dropped
    retire flags and stragglers under a deadline, keyed by global slot
    and dispatch sequence: the sharded pool's records equal the
    reference's single-device pool's and the port's unsharded pool's."""
    n = 14
    for mix in (dict(seed=1, nan_uid_frac=0.3, nan_transient=True),
                dict(seed=2, drop_flag_p=0.4),
                dict(seed=5, straggle_tick_frac=0.4, straggle_factor=8.0)):
        kw = {"deadline": 80.0} if "straggle_tick_frac" in mix else {}
        inj, jinj = _injectors(**mix)
        rep = twl.replay_scheduler(_sched(inj, overlap=overlap, mesh=MESH,
                                          **kw), fault_trace(twl, n))
        one = twl.replay_scheduler(_sched(_injectors(**mix)[0],
                                          overlap=overlap, **kw),
                                   fault_trace(twl, n))
        ref = jwl.replay_scheduler(_jsched(jinj, **kw), fault_trace(jwl, n))
        assert len(rep.records) == n
        assert_loops_equal(rep.records, one.records)
        assert_records_match(rep.records, ref.records, rtol=1e-5,
                             atol=1e-5)


@LOOPS
def test_sharded_pool_flow_tier_equals_reference(overlap):
    """The K=0 flow tier beside the ladder: flow rows hold no slot, the
    rest ride the sub-pools; records the reference's and the unsharded
    pool's."""
    xs = twl.heterogeneous_requests(16, 12, seed=3)
    rep = _replay(flow_toy(), flow_ecfg(teng, 0.5, **FLOW_MIX),
                  twl.poisson_trace(xs, rate=0.25, seed=7), MESH, slots=4,
                  seg=2, overlap=overlap)
    one = _replay(flow_toy(), flow_ecfg(teng, 0.5, **FLOW_MIX),
                  twl.poisson_trace(xs, rate=0.25, seed=7), slots=4, seg=2,
                  overlap=overlap)
    ref = jwl.replay_scheduler(jsch.InflightScheduler(
        FLOW_JAX_TOY, flow_ecfg(jeng, 0.5, **FLOW_MIX), slots=4, seg=2,
        overlap=overlap), jwl.poisson_trace(xs, rate=0.25, seed=7))
    Ks = {r.K for r in rep.records}
    assert 0 in Ks and len(Ks) > 1, Ks
    assert_loops_equal(rep.records, one.records)
    assert [_key(r) for r in rep.records] == [_key(r) for r in ref.records]
    for a, b in zip(rep.records, ref.records):
        np.testing.assert_allclose(a.outputs, np.asarray(b.outputs),
                                   rtol=1e-5, atol=1e-5)


def test_sharded_pool_ledger_and_hot_swap():
    """A ledger captures across sub-pools in global slot order: the same
    captures, reservoir and rows bit for bit as on the unsharded pool,
    and the reference's membership. A hot swap mid-flight reaches every
    sub-pool: the swapped sharded run equals the swapped unsharded run."""
    from test_torch_refinery import D as RD
    from test_torch_refinery import _ecfg as ref_ecfg
    from test_torch_refinery import _toy as ref_toy
    xs = twl.heterogeneous_requests(32, RD, seed=3)
    leds, reps = [], []
    for mesh in (MESH, None):
        led = ResidualLedger(ref_toy(), capacity=64, seed=0)
        reps.append(twl.replay_scheduler(tsch.InflightScheduler(
            ref_toy(), ref_ecfg(), slots=8, seg=1, mesh=mesh, ledger=led),
            twl.poisson_trace(xs, rate=1.0, seed=7)))
        leds.append(led)
    assert_loops_equal(reps[0].records, reps[1].records)
    a, b = leds
    assert a.fill > 0 and (a.seen, a.captures, a.fill, a.holdout_fill) == \
        (b.seen, b.captures, b.fill, b.holdout_fill)
    for x, y in zip(a._samples + a._holdout, b._samples + b._holdout):
        assert (x[0], x[1]) == (y[0], y[1])
        assert all(torch.equal(x[j], y[j]) for j in (2, 3, 4))
    jmodel = jwl.toy_refinable_classifier(d=RD)
    jled = jref.ResidualLedger(jmodel, capacity=64, seed=0)
    jwl.replay_scheduler(jsch.InflightScheduler(
        jmodel, ref_ecfg(jeng), slots=8, seg=1, ledger=jled),
        jwl.poisson_trace(xs, rate=1.0, seed=7))
    assert (a.seen, a.captures, a.fill) == (jled.seen, jled.captures,
                                            jled.fill)
    assert [(s[0], s[1]) for s in a._samples] == \
        [(s[0], s[1]) for s in jled._samples]

    new = {k: v + 0.5 for k, v in ref_toy().g_params.items()}
    outs = []
    for mesh in (MESH, None):
        def on_tick(s, done=[]):
            if s.dispatches >= 3 and not done:
                done.append(1)
                s.hot_swap_g(new)
        outs.append(twl.replay_scheduler(tsch.InflightScheduler(
            ref_toy(), ref_ecfg(), slots=8, seg=1, mesh=mesh),
            twl.poisson_trace(xs, rate=0.25, seed=23), on_tick=on_tick))
    assert_loops_equal(outs[0].records, outs[1].records)
    plain = twl.replay_scheduler(tsch.InflightScheduler(
        ref_toy(), ref_ecfg(), slots=8, seg=1, mesh=MESH),
        twl.poisson_trace(xs, rate=0.25, seed=23))
    assert any(not np.array_equal(p.outputs, q.outputs)
               for p, q in zip(plain.records, outs[0].records))


def test_mesh_of_several_devices_needs_replicas_and_a_parametric_g():
    """A mesh that spans another device rebuilds the model there
    (``DepthModel.replicate``); a model that cannot be rebuilt, or one
    whose correction is a closure over one device's params, is refused
    at construction."""
    spread = ServingMesh(("cpu", "meta"))
    ecfg = teng.EngineConfig(buckets=(2,), controller="fixed", fixed_K=2)
    with pytest.raises(ValueError, match="replicate"):
        tsch.InflightScheduler(_toy(), ecfg, slots=2, mesh=spread)
    closure = dataclasses.replace(_toy(g=G), replicate=lambda d: _toy(g=G))
    with pytest.raises(ValueError, match="parametric"):
        tsch.InflightScheduler(closure, ecfg, slots=2, mesh=spread)
    built = []
    ok = dataclasses.replace(
        _toy(), replicate=lambda d: built.append(d) or _toy())
    tsch.InflightScheduler(ok, ecfg, slots=4, mesh=ServingMesh(
        ("cpu", "meta", "meta", "cpu")))
    assert built == [torch.device("meta")]


# --------------------------------------------- what a second card serves ----
# A mesh of several devices serves each sub-pool with a replica of the
# model rebuilt on its device and a loaded correction on the parametric
# path (serve.py). This container has no second device, so these run the
# two on one: a replica rebuilt for the CPU, and the parametric path
# against the closure path it replaces.

def _lm_with_g(refinable):
    """Reduced float32 Qwen3 (the scheduler tests' weights) served with
    hyper_euler and a seeded nonzero g, at a tolerance its probe errors
    (0.109-0.121) straddle: K mixes 4 and 8."""
    cfg_t, pt, toks, kw, _ = _lm_setup("qwen3_4b")
    gen = torch.Generator().manual_seed(3)
    gp = lm_g_init(gen, cfg_t, rank=8, param_dtype=torch.float32)
    gp["w_out"] = 0.05 * torch.randn(gp["w_out"].shape, generator=gen)
    model = teng.lm_depth_model(pt, cfg_t, solver="hyper_euler",
                                g_params=gp, fused=True, refinable=refinable)
    return model, toks, dict(kw, solver="hyper_euler", tol=0.0292)


def test_lm_g_row_does_not_depend_on_its_batch():
    """The LM correction at a batched depth row: each row's output is bit
    for bit the same computed alone, two by two or with all eight (the
    sub-pool widths of a split pool)."""
    cfg = dataclasses.replace(torch_get("qwen3_4b").reduced(),
                              dtype="float32", param_dtype="float32")
    gen = torch.Generator().manual_seed(5)
    gp = lm_g_init(gen, cfg, rank=32, param_dtype=torch.float32)
    gp["w_out"] = 0.05 * torch.randn(gp["w_out"].shape, generator=gen)
    rs = np.random.RandomState(5)
    h, dh = (torch.from_numpy(rs.randn(8, 16, cfg.d_model)
                              .astype(np.float32)) for _ in range(2))
    s = torch.from_numpy(rs.rand(8).astype(np.float32))
    whole = lm_g_apply(gp, None, s, None, h, dh)
    for per in (1, 2):
        parts = torch.cat([lm_g_apply(gp, None, s[i:i + per], None,
                                      h[i:i + per], dh[i:i + per])
                           for i in range(0, 8, per)])
        assert torch.equal(parts, whole), per


def test_lm_replica_serves_what_the_model_serves():
    """``DepthModel.replicate`` rebuilds the served LM (its weights, the
    parametric g) on a device: the replica serves the original's records
    bit for bit, and its params are copies of the original's."""
    model, toks, kw = _lm_with_g(refinable=True)
    replica = model.replicate(torch.device("cpu"))
    assert replica.g_apply is not None and replica.integ.fused
    assert all(torch.equal(a, b) for a, b in zip(
        model.g_params.values(), replica.g_params.values()))
    reps = [_replay(m, teng.EngineConfig(**kw),
                    twl.poisson_trace(toks, rate=0.25, seed=0), slots=4,
                    seg=2) for m in (model, replica)]
    assert len({r.K for r in reps[0].records}) > 1
    assert_loops_equal(reps[0].records, reps[1].records)


@pytest.mark.parametrize("mesh", [None, MESH], ids=["one", "mesh4"])
def test_loaded_g_parametric_equals_closure(mesh):
    """serve.py serves a loaded g on the parametric path when the mesh
    spans several devices (each device gets its own copy of the params):
    its records equal the closure path's bit for bit, on one device and
    split over a 4-entry mesh, one row a sub-pool (a row's correction
    does not depend on how many rows share its call)."""
    reps = []
    for refinable in (False, True):
        model, toks, kw = _lm_with_g(refinable)
        assert (model.g_apply is not None) == refinable
        reps.append(_replay(model, teng.EngineConfig(**kw),
                            twl.poisson_trace(toks, rate=0.25, seed=0),
                            mesh if refinable else None, slots=4, seg=2))
    assert len({r.K for r in reps[0].records}) > 1
    assert_loops_equal(reps[0].records, reps[1].records)


# -------------------------------------------------------------- LM cases ----

@pytest.mark.parametrize("arch", ["qwen3_4b", "olmoe_1b_7b"])
def test_lm_sharded_pool_matches_reference(arch):
    """Reduced float32 Qwen3 and OLMoE (top-2 of 4) in flight on a
    Poisson trace, slots 4 over 4 entries (one row per sub-pool): the
    sync loop's records equal the reference's single-device pool's
    policy record for record, logits at 1e-4, and the port's unsharded
    pool's bit for bit; the overlap loop's equal the sync loop's bit for
    bit. Each sub-pool routes its MoE rows alone, so no result depends on
    the split; routed tokens clear ``MARGIN``."""
    cfg_t, pt, toks, kw, ref = _lm_setup(arch)
    reps = []
    with routing_margins() as gaps:
        for mesh, overlap in ((MESH, False), (MESH, True), (None, False)):
            reps.append(_replay(teng.lm_depth_model(pt, cfg_t),
                                teng.EngineConfig(**kw),
                                twl.poisson_trace(toks, rate=0.25, seed=0),
                                mesh, slots=4, seg=2, overlap=overlap))
    assert not gaps or min(gaps) > MARGIN, min(gaps)
    assert len({r.K for r in reps[0].records}) > 1
    assert_loops_equal(reps[0].records, reps[1].records)
    assert_loops_equal(reps[0].records, reps[2].records)
    assert_records_match(reps[0].records, ref.records, rtol=1e-4, atol=1e-4)
    assert twl.latency_stats(reps[0]) == jwl.latency_stats(ref)


# ------------------------------------------------------------------- CLI ----

def test_serve_inflight_mesh_on_cpu(capsys):
    """``--mesh 2`` serves through two CPU sub-pools what the unsharded
    pool serves; ``--mesh`` without ``--inflight`` exits with the
    reference's message, and a width the mesh cannot split raises."""
    argv = ["--arch", "qwen3_4b", "--reduced", "--device", "cpu", "--batch",
            "4", "--prompt-len", "8", "--solver", "euler", "--multirate",
            "--fused", "--inflight", "--arrival-trace", "poisson"]
    out = serve.main(argv + ["--mesh", "2"])
    text = capsys.readouterr().out
    assert "mesh of 2: cpu,cpu" in text and "[inflight poisson]" in text
    assert out["sched"].mesh.size == 2
    assert all(r.status == "ok" for r in out["results"])
    one = serve.main(argv)
    assert_loops_equal(out["results"], one["results"])
    with pytest.raises(SystemExit, match="--inflight"):
        serve.main(argv[:-3] + ["--mesh", "2"])
    with pytest.raises(ValueError, match="does not divide"):
        serve.main(argv + ["--mesh", "3"])
