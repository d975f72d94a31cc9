"""The port's in-flight scheduler (repro_torch/launch/scheduler.py), its
resumable segment solve (core/integrate.py::solve_segment,
``segment_cell``) and its workloads (launch/workload.py), held against
the JAX package's on the CPU; the counterparts of tests/test_scheduler.py.

Toy models are the reference tests' (a stiff decay whose rate is the
softplus of the request's mean) in both packages; the LM cases serve
reduced ``qwen3_4b`` (4 layers), ``recurrentgemma_2b`` (14 layers),
``rwkv6_1p6b`` (8 layers), ``olmoe_1b_7b`` (4 layers) and
``llama4_maverick_400b_a17b`` (8 layers) in float32 on a Poisson trace
through both schedulers, weights drawn by JAX and carried across.

Host-side policy is held exactly: uid, K, nfe, status, completion order
and the virtual-clock stamps. Outputs agree at fp32 rtol = atol = 1e-6
where only the update algebra runs (the toy state), 1e-5 through the toy
classifier's head and 1e-4 through an LM. Probe tolerances keep every
request's (err / tol)^(1/q) at least 1e-4 from an integer (asserted), so
rounding cannot flip a K. The port's sync and overlap loops are equal
bit for bit. On the roofline clock (``launch/oracle.py::RooflineOracle``
at the reference's TPU v5e record) both serving loops stamp what the
reference's stamp."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from port_isolation import port_module_isolation  # noqa: F401
from test_torch_moe import MARGIN, routing_margins

from repro.configs import get as jax_get
from repro.core import FixedGrid as JaxGrid
from repro.core import Integrator as JaxIntegrator
from repro.core import get_tableau as jax_tableau
from repro.core import make_segment_carry as jax_make_carry
from repro.launch import engine as jeng
from repro.launch import oracle as jor
from repro.launch import scheduler as jsch
from repro.launch import workload as jwl
from repro.models.lm import init_lm as jax_init_lm
from repro_torch.configs import get as torch_get
from repro_torch.convert import params_from_jax
from repro_torch.core import FixedGrid, Integrator, SegmentCarry, get_tableau
from repro_torch.core import make_segment_carry
from repro_torch.launch import engine as teng
from repro_torch.launch import oracle as tor
from repro_torch.launch import scheduler as tsch
from repro_torch.launch import workload as twl
from repro_torch.roofline.costmodel import TPU_V5E

LOOPS = pytest.mark.parametrize("overlap", [False, True],
                                ids=["sync", "overlap"])


def _field_jax(s, z):
    return -z * jax.nn.softplus(jnp.mean(z, axis=-1, keepdims=True))


def _field(s, z):
    return -z * torch.nn.functional.softplus(z.mean(dim=-1, keepdim=True))


G_JAX = lambda eps, s, z, dz: 0.25 * z + 0.1 * dz
G = lambda eps, s, z, dz: 0.25 * z + 0.1 * dz


def _toy_jax(fused=False, g=None):
    def field_of(x):
        k = jax.nn.softplus(jnp.mean(x, axis=-1, keepdims=True))
        return lambda s, z: -z * k

    return jeng.DepthModel(
        embed=lambda x: x + 0.0, field_of=field_of,
        readout=lambda x, zT: zT,
        integ=JaxIntegrator(tableau=jax_tableau("euler"), g=g, fused=fused))


def _toy(fused=False, g=None, readout=None):
    def field_of(x):
        k = torch.nn.functional.softplus(
            torch.as_tensor(x).mean(dim=-1, keepdim=True))
        return lambda s, z: -z * k

    return teng.DepthModel(
        embed=lambda x: torch.as_tensor(x) + 0.0, field_of=field_of,
        readout=readout or (lambda x, zT: zT),
        integ=Integrator(tableau=get_tableau("euler"), g=g, fused=fused))


def _assert_k_margin(model, ecfg, xs, q=1):
    """No request's (err / tol)^(1/q) lies within 1e-4 of an integer."""
    _, errs = teng.MultiRateEngine(model, ecfg).probe(xs)
    r = (errs[np.isfinite(errs)].astype(np.float64) / ecfg.tol) ** (1 / q)
    assert np.abs(r - np.round(r)).min() > 1e-4, r


def _key(r):
    return (r.uid, r.K, r.nfe, r.status, r.t_submit, r.t_admit, r.t_done)


def assert_records_match(port, ref, rtol, atol):
    """Equal policy record for record, in completion order; outputs
    allclose (NaN where the reference has NaN)."""
    assert [_key(r) for r in port] == [_key(r) for r in ref]
    for a, b in zip(port, ref):
        if b.outputs is None:
            assert a.outputs is None
        else:
            np.testing.assert_allclose(a.outputs, np.asarray(b.outputs),
                                       rtol=rtol, atol=atol, equal_nan=True)


def assert_loops_equal(a, b):
    """Two loops' records equal bit for bit (the sync/overlap contract)."""
    assert [_key(r) for r in a] == [_key(r) for r in b]
    for x, y in zip(a, b):
        assert (x.outputs is None) == (y.outputs is None)
        if x.outputs is not None:
            assert np.array_equal(x.outputs, y.outputs, equal_nan=True)


# ------------------------------------------------- solve_segment parity ----

@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("with_g", [False, True])
@pytest.mark.parametrize("seg", [1, 2, 3, 8])
def test_solve_segment_parity_with_solve_multirate(fused, with_g, seg):
    """A mixed-K batch driven to completion segment by segment equals one
    ``solve_multirate`` call (fp32 1e-6), in the port and against the
    reference's segment solve, with and without a correction, fused and
    unfused, for seg dividing and not dividing the mesh lengths."""
    z0_np = np.array(jax.random.normal(jax.random.PRNGKey(0), (5, 17)))
    Ks = [1, 2, 5, 8, 3]
    integ = Integrator(get_tableau("heun"), g=G if with_g else None,
                       fused=fused)
    z0 = torch.from_numpy(z0_np)
    fs = _field(0.0, z0)
    ref = integ.solve_multirate(_field, z0, (0.0, 1.0), Ks, 8,
                                first_stage=fs)
    carry = make_segment_carry(z0, Ks, (0.0, 1.0), first_stage=fs)
    fin = None
    for _ in range(-(-8 // seg)):
        carry, fin = integ.solve_segment(_field, carry, seg)
    assert bool(fin.all())
    np.testing.assert_allclose(carry.z.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)

    jinteg = JaxIntegrator(jax_tableau("heun"),
                           g=G_JAX if with_g else None, fused=fused)
    jz0 = jnp.asarray(z0_np)
    jcarry = jax_make_carry(jz0, jnp.asarray(Ks), (0.0, 1.0),
                            first_stage=_field_jax(0.0, jz0))
    for _ in range(-(-8 // seg)):
        jcarry, _ = jinteg.solve_segment(_field_jax, jcarry, seg)
    np.testing.assert_allclose(carry.z.numpy(), np.asarray(jcarry.z),
                               rtol=1e-6, atol=1e-6)
    assert carry.k.tolist() == np.asarray(jcarry.k).tolist() == Ks


def test_solve_segment_refill_midflight_matches_fresh_solve():
    """A slot retired and refilled mid-flight (new z row, k = 0, new K)
    integrates its own mesh as a fresh solve does — in the port and in
    the reference."""
    z0 = torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(1), (3, 9))))
    z_new = torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(2), (2, 9))))
    integ = Integrator(get_tableau("euler"), fused=True)
    carry = make_segment_carry(z0, [2, 6, 0], (0.0, 1.0))
    carry, fin = integ.solve_segment(_field, carry, 2)
    assert fin.tolist() == [True, False, True]
    idx = torch.tensor([0, 2])
    z = carry.z.clone()
    z[idx] = z_new
    k, Ks, eps = carry.k.clone(), carry.Ks.clone(), carry.eps.clone()
    k[idx] = 0
    Ks[idx] = torch.tensor([4, 3], dtype=torch.int32)
    eps[idx] = torch.tensor([0.25, 1.0 / 3.0])
    carry = SegmentCarry(z=z, k=k, Ks=Ks, eps=eps, first_stage=None)
    for _ in range(3):
        carry, fin = integ.solve_segment(_field, carry, 2)
    assert bool(fin.all())
    jinteg = JaxIntegrator(jax_tableau("euler"), fused=True)
    for j, (i, K) in enumerate(((0, 4), (2, 3))):
        ref = integ.solve(_field, z_new[j][None],
                          FixedGrid.over(0.0, 1.0, K), return_traj=False)
        np.testing.assert_allclose(carry.z[i].numpy(), ref[0].numpy(),
                                   rtol=1e-6, atol=1e-6)
        jref = jinteg.solve(_field_jax, jnp.asarray(z_new[j][None].numpy()),
                            JaxGrid.over(0.0, 1.0, K), return_traj=False)
        np.testing.assert_allclose(carry.z[i].numpy(), np.asarray(jref[0]),
                                   rtol=1e-6, atol=1e-6)


def test_make_segment_carry_empty_slots_stay_inert():
    """Ks == 0 marks an empty slot: frozen state, counter pinned at 0, a
    finite eps (1.0, as the reference's carry has)."""
    integ = Integrator(get_tableau("euler"), fused=True)
    carry = make_segment_carry(torch.ones((3, 4)), [2, 0, 3], (0.0, 1.0))
    jcarry = jax_make_carry(jnp.ones((3, 4)), jnp.asarray([2, 0, 3]),
                            (0.0, 1.0))
    np.testing.assert_array_equal(carry.eps.numpy(), np.asarray(jcarry.eps))
    assert carry.eps.dtype == torch.float32 and carry.k.dtype == torch.int32
    carry, fin = integ.solve_segment(_field, carry, 4)
    assert fin.tolist() == [True, True, True]
    np.testing.assert_array_equal(carry.z[1].numpy(), np.ones(4))
    assert carry.k.tolist() == [2, 0, 3]


def test_segment_cell_writes_carry_in_place():
    """The counterpart of the reference's donated carry: the cell writes
    z' into the pool's own z storage (the same tensor comes back), passes
    the probe rows through untouched, leaves the conditioning rows alone
    and returns the (3, B) int32 ``[k'; finished; nonfinite]`` meta."""
    m = _toy(fused=True)
    cell = m.integ.segment_cell(m.field_of, seg=2)
    B, d = 4, 16
    xs = torch.zeros((B, d))
    z = torch.ones((B, d))
    fs = torch.zeros((B, d))
    ptr_z, ptr_fs, ptr_xs = z.data_ptr(), fs.data_ptr(), xs.data_ptr()
    k = torch.zeros((B,), dtype=torch.int32)
    Ks = torch.full((B,), 4, dtype=torch.int32)
    eps = torch.full((B,), 0.25)
    z2, fs2, meta = cell(xs, z, k, Ks, eps, fs)
    assert z2 is z and z2.data_ptr() == ptr_z
    assert fs2 is fs and fs2.data_ptr() == ptr_fs
    assert xs.data_ptr() == ptr_xs and not xs.any()
    # one Euler step of dz/ds = -softplus(0) z at eps 0.25 (the k == 0
    # step takes the probe rows, zero here), then one from the field
    np.testing.assert_allclose(z.numpy(), 1.0 - 0.25 * np.log(2.0),
                               rtol=1e-6)
    assert meta.dtype == torch.int32 and tuple(meta.shape) == (3, B)
    assert meta.tolist() == [[2] * B, [0] * B, [0] * B]
    # a non-finite row is flagged by the third row
    z[1, 3] = float("nan")
    _, _, meta = cell(xs, z, meta[0], Ks, eps, fs)
    assert meta.tolist() == [[4] * B, [1] * B, [0, 1, 0, 0]]


# -------------------------------------------------- scheduler vs engine ----

def test_scheduler_outputs_and_nfe_match_engine():
    """Same controller and buckets through the drain engine and the
    scheduler: request for request equal K and NFE, matching outputs; and
    the port's scheduler equals the reference's."""
    xs = jwl.heterogeneous_requests(18, 8, seed=1)
    kw = dict(buckets=(2, 4, 8, 16), tol=5e-3, max_batch=6)
    ecfg = teng.EngineConfig(**kw)
    _assert_k_margin(_toy(), ecfg, xs)
    res_e = teng.MultiRateEngine(_toy(), ecfg).run(xs)
    res_s = tsch.InflightScheduler(_toy(), ecfg, slots=6, seg=2).run(xs)
    assert [r.uid for r in res_s] == [r.uid for r in res_e]
    for a, b in zip(res_e, res_s):
        assert (a.K, a.nfe) == (b.K, b.nfe)
        np.testing.assert_allclose(a.outputs, b.outputs, rtol=1e-6,
                                   atol=1e-6)
    ref = jsch.InflightScheduler(_toy_jax(), jeng.EngineConfig(**kw),
                                 slots=6, seg=2).run(xs)
    assert_records_match(res_s, ref, rtol=1e-6, atol=1e-6)


def test_scheduler_fixed_controller_and_hyper_solver_paths():
    xs = jwl.heterogeneous_requests(5, 6, seed=3)
    kw = dict(buckets=(4,), controller="fixed", fixed_K=4)
    res = tsch.InflightScheduler(_toy(), teng.EngineConfig(**kw), slots=3,
                                 seg=2).run(xs)
    assert all(r.K == 4 and r.nfe == 4 for r in res)
    ref = jsch.InflightScheduler(_toy_jax(), jeng.EngineConfig(**kw),
                                 slots=3, seg=2).run(xs)
    assert_records_match(res, ref, rtol=1e-6, atol=1e-6)

    xs = jwl.heterogeneous_requests(6, 6, seed=4)
    kw = dict(buckets=(2, 4, 8), tol=1e-1, solver="hyper_euler")
    g = lambda e, s, z, dz: 0.3 * z
    sched = tsch.InflightScheduler(_toy(g=g), teng.EngineConfig(**kw),
                                   slots=4, seg=2)
    res = sched.run(xs)
    assert type(sched.controller).__name__ == \
        "HypersolverResidualController"
    assert all(r.nfe == r.K for r in res)  # probe fully reused
    ref = jsch.InflightScheduler(_toy_jax(g=g), jeng.EngineConfig(**kw),
                                 slots=4, seg=2).run(xs)
    assert_records_match(res, ref, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tsch.InflightScheduler(_toy(), teng.EngineConfig(**kw))


@LOOPS
def test_easy_request_escapes_a_busy_pool_early(overlap):
    """A K=2 request admitted while a K=16 one is mid-flight leaves after
    its own segments; the drain engine, packing both, cannot. The stamps
    equal the reference scheduler's."""
    runs = []
    for sch, eng, toy in ((tsch, teng, _toy), (jsch, jeng, _toy_jax)):
        ecfg = eng.EngineConfig(buckets=(2, 16), tol=1e-2, max_batch=2)
        sched = sch.InflightScheduler(toy(), ecfg, slots=2, seg=2,
                                      overlap=overlap)
        uid_hard = sched.submit(np.full((6,), 3.0, np.float32))
        assert not sched.step()
        uid_easy = sched.submit(np.full((6,), -2.0, np.float32))
        finished = {}
        while sched.pending:
            for c in sched.step():
                finished[c.uid] = c
        runs.append([(c.uid, c.K, c.t_admit, c.t_done)
                     for c in finished.values()])
        assert finished[uid_hard].K == 16 and finished[uid_easy].K == 2
        assert finished[uid_easy].t_done < finished[uid_hard].t_done
    assert runs[0] == runs[1]
    eng = teng.MultiRateEngine(_toy(), teng.EngineConfig(
        buckets=(2, 16), tol=1e-2, max_batch=2))
    eng.submit(np.full((6,), 3.0, np.float32))
    eng.submit(np.full((6,), -2.0, np.float32))
    eng.step()
    assert eng.last_report.batches == 1
    assert eng.last_report.finish_offset[1] == eng.last_report.finish_offset[2]


def test_submit_future_t_refused_while_busy_allowed_when_idle():
    sched = tsch.InflightScheduler(
        _toy(), teng.EngineConfig(buckets=(2, 4), tol=1e-2), slots=2,
        seg=1)
    sched.submit(np.full((4,), 3.0, np.float32), t=5.0)
    assert sched.now == 5.0
    sched.step()
    assert sched.pending
    with pytest.raises(ValueError, match="misattribute"):
        sched.submit(np.full((4,), -2.0, np.float32), t=sched.now + 100.0)
    while sched.pending:
        sched.step()
    assert sched.now < 100.0


@LOOPS
def test_scheduler_handles_mixed_shapes_and_queue_overflow(overlap):
    """More requests than slots queue and drain FIFO per shape; a second
    shape gets its own pool; the records equal the reference's."""
    runs = []
    for sch, eng, toy in ((tsch, teng, _toy), (jsch, jeng, _toy_jax)):
        sched = sch.InflightScheduler(
            toy(), eng.EngineConfig(buckets=(2, 4), tol=1e-2), slots=2,
            seg=2, overlap=overlap)
        uids_a = [sched.submit(np.full((3,), -2.0, np.float32))
                  for _ in range(5)]
        uid_b = sched.submit(np.full((7,), -2.0, np.float32))
        results = []
        while sched.pending:
            results.extend(sched.step())
        by_uid = {c.uid: c for c in results}
        assert sorted(by_uid) == sorted(uids_a + [uid_b])
        assert by_uid[uid_b].outputs.shape == (7,)
        admits = [by_uid[u].t_admit for u in uids_a]
        assert admits == sorted(admits)
        runs.append(results)
    assert_records_match(runs[0], runs[1], rtol=1e-6, atol=1e-6)


def test_scheduler_same_shape_mixed_dtypes_get_separate_pools():
    """Same-shape requests of another dtype open their own pool instead
    of casting into the first admission's storage."""
    ecfg = teng.EngineConfig(buckets=(2, 4), tol=1e-2)
    sched = tsch.InflightScheduler(_toy(), ecfg, slots=2, seg=2)
    sched.submit(np.full((4,), -2.0, np.float32))
    u64 = sched.submit(np.full((4,), -2.25, np.float64))
    results = {}
    while sched.pending:
        for c in sched.step():
            results[c.uid] = c
    assert len(sched._pools) == 2
    assert results[u64].outputs.dtype == np.float64
    res_e = teng.MultiRateEngine(_toy(), ecfg).run(
        np.full((1, 4), -2.25, np.float64))
    np.testing.assert_allclose(results[u64].outputs, res_e[0].outputs,
                               rtol=1e-6, atol=1e-6)
    # the reference computes in float32 (x64 off): equal to its precision
    ref = jsch.InflightScheduler(
        _toy_jax(), jeng.EngineConfig(buckets=(2, 4), tol=1e-2), slots=2,
        seg=2).run(np.full((1, 4), -2.25, np.float64))
    assert ref[0].K == results[u64].K
    np.testing.assert_allclose(results[u64].outputs,
                               np.asarray(ref[0].outputs, np.float64),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------- workloads ----

def test_traces_and_requests_equal_the_reference():
    """The port's request mix and arrival traces are the reference's, bit
    for bit, from the same seeds."""
    xs = twl.heterogeneous_requests(12, 4, seed=0)
    np.testing.assert_array_equal(xs, jwl.heterogeneous_requests(12, 4,
                                                                 seed=0))
    for make in (lambda m, x: m.poisson_trace(x, rate=0.5, seed=7,
                                              deadline_slack=3.0),
                 lambda m, x: m.bursty_trace(x, burst=4, gap=10.0,
                                             within=1.0, seed=7)):
        a, b = make(twl, xs), make(jwl, xs)
        assert [(r.t, r.deadline) for r in a] == [(r.t, r.deadline)
                                                  for r in b]
        assert all(np.array_equal(r.x, q.x) for r, q in zip(a, b))
    with pytest.raises(ValueError):
        twl.poisson_trace(xs, rate=0.0)


def test_replay_accounting_invariants():
    """Both replays conserve requests with submit <= admit <= done and
    waste = total - useful >= 0; both equal the reference's replays,
    summaries included."""
    xs = twl.heterogeneous_requests(16, 6, seed=5)
    kw = dict(buckets=(2, 4, 8), tol=5e-3, max_batch=4)
    _assert_k_margin(_toy(), teng.EngineConfig(**kw), xs)
    trace = twl.poisson_trace(xs, rate=0.3, seed=6)
    rep_e = twl.replay_engine(
        teng.MultiRateEngine(_toy(), teng.EngineConfig(**kw)), trace)
    rep_s = twl.replay_scheduler(
        tsch.InflightScheduler(_toy(), teng.EngineConfig(**kw), slots=4,
                               seg=2), trace)
    for rep in (rep_e, rep_s):
        assert len(rep.records) == 16
        for r in rep.records:
            assert r.t_submit <= r.t_admit <= r.t_done
        assert rep.waste_steps >= 0
        assert rep.useful_steps == sum(r.K for r in rep.records)
        stats = twl.latency_stats(rep)
        assert stats["p50_latency"] <= stats["p99_latency"]
    out_e = {r.uid: r.outputs for r in rep_e.records}
    for r in rep_s.records:
        np.testing.assert_allclose(r.outputs, out_e[r.uid], rtol=1e-6,
                                   atol=1e-6)
    jtrace = jwl.poisson_trace(xs, rate=0.3, seed=6)
    ref_e = jwl.replay_engine(
        jeng.MultiRateEngine(_toy_jax(), jeng.EngineConfig(**kw)), jtrace)
    ref_s = jwl.replay_scheduler(
        jsch.InflightScheduler(_toy_jax(), jeng.EngineConfig(**kw),
                               slots=4, seg=2), jtrace)
    for rep, ref in ((rep_e, ref_e), (rep_s, ref_s)):
        assert_records_match(rep.records, ref.records, rtol=1e-6,
                             atol=1e-6)
        assert twl.latency_stats(rep) == jwl.latency_stats(ref)
        assert (rep.occupied_steps, rep.total_steps) == \
            (ref.occupied_steps, ref.total_steps)


def test_pool_completions_stamped_with_own_cost_only():
    """Pools are concurrent cells: a completion carries only its own
    pool's probe and segment cost, whatever the (shape, dtype) key order;
    the tick's ledger sums both pools."""
    for order in ((3, 5), (5, 3)):
        stamps = []
        for sch, eng, toy in ((tsch, teng, _toy), (jsch, jeng, _toy_jax)):
            sched = sch.InflightScheduler(
                toy(), eng.EngineConfig(buckets=(2,), controller="fixed",
                                        fixed_K=2), slots=2, seg=2)
            for d in order:
                sched.submit(np.full((d,), -2.0, np.float32))
            done = sched.step()
            assert len(done) == 2
            assert [c.t_done for c in done] == [2.0, 2.0], (order, done)
            assert sched.total_cost == 4.0
            stamps.append([(c.uid, c.t_done) for c in done])
        assert stamps[0] == stamps[1]


# ------------------------------------------------ overlap and readout ----

def test_overlap_replay_uid_for_uid_identical_to_sync():
    """The pipelined loop replays a seeded Poisson trace uid for uid
    identical to the synchronous loop (bit for bit, stamps and summary),
    and both equal the reference's."""
    kw = dict(buckets=(2, 4, 8, 16), tol=5e-3, max_batch=8, fused=True)
    xs = twl.heterogeneous_requests(24, 8, seed=2)
    _assert_k_margin(_toy(fused=True), teng.EngineConfig(**kw), xs)
    trace = twl.poisson_trace(xs, rate=0.3, seed=4)
    reps = [twl.replay_scheduler(tsch.InflightScheduler(
        _toy(fused=True), teng.EngineConfig(**kw), slots=4, seg=2,
        overlap=ov), trace) for ov in (False, True)]
    assert len(reps[1].records) == len(reps[0].records) == 24
    assert_loops_equal(reps[1].records, reps[0].records)
    assert twl.latency_stats(reps[1]) == twl.latency_stats(reps[0])
    ref = jwl.replay_scheduler(jsch.InflightScheduler(
        _toy_jax(fused=True), jeng.EngineConfig(**kw), slots=4, seg=2),
        jwl.poisson_trace(xs, rate=0.3, seed=4))
    assert_records_match(reps[0].records, ref.records, rtol=1e-6,
                         atol=1e-6)


def test_overlap_one_segment_retire_lag_and_cost_parity():
    """The overlap tick retires one segment late (completions of segment
    N surface from step N+1) with the sync loop's per-pool stamps."""
    sched = tsch.InflightScheduler(
        _toy(), teng.EngineConfig(buckets=(2,), controller="fixed",
                                  fixed_K=2), slots=2, seg=2, overlap=True)
    for d in (3, 5):
        sched.submit(np.full((d,), -2.0, np.float32))
    assert sched.step() == []
    done = sched.step()
    assert len(done) == 2
    assert [c.t_done for c in done] == [2.0, 2.0]
    assert sched.total_cost == 4.0
    assert not sched.pending


@LOOPS
def test_retire_readout_gated_to_finished_rows(overlap):
    """Retirement reads out only the retiring rows, the gather padded to a
    power of two no wider than the pool: a streaming trace retires
    stragglers at sub-pool widths, and the pool records exactly the
    widths the readout ran at."""
    widths = []

    def readout(x, zT):
        widths.append(zT.shape[0])
        return zT

    kw = dict(buckets=(2, 4, 8, 16), tol=5e-3, max_batch=8, fused=True)
    xs = twl.heterogeneous_requests(24, 8, seed=2)
    sched = tsch.InflightScheduler(_toy(fused=True, readout=readout),
                                   teng.EngineConfig(**kw), slots=8, seg=2,
                                   overlap=overlap)
    rep = twl.replay_scheduler(sched, twl.poisson_trace(xs, rate=0.5,
                                                        seed=4))
    assert len(rep.records) == 24
    pool = next(iter(sched._pools.values()))
    assert widths and set(widths) == pool._readout_widths
    assert min(widths) < sched.slots, widths
    assert all(w <= sched.slots and w & (w - 1) == 0 for w in widths)


def test_dropped_scheduler_frees_its_pools_without_the_collector():
    """No reference cycle between the scheduler and its pools: dropping
    the scheduler frees them (and the model, with its weights) at once,
    with the cyclic collector off."""
    import gc
    import weakref

    sched = tsch.InflightScheduler(
        _toy(), teng.EngineConfig(buckets=(2,), controller="fixed",
                                  fixed_K=2), slots=2, seg=2)
    sched.run(np.full((3, 4), -2.0, np.float32))
    refs = [weakref.ref(sched), weakref.ref(sched.model),
            weakref.ref(next(iter(sched._pools.values())).z[0])]
    enabled = gc.isenabled()
    gc.disable()
    try:
        del sched
        assert all(r() is None for r in refs)
    finally:
        if enabled:
            gc.enable()


def test_ledger_and_hot_swaps_are_ported():
    """The options that waited for the refinery and the flow tier now
    work: a ledger captures interior rows (without moving a completion),
    ``hot_swap_g`` replaces a parametric correction (refusing a closure
    model, as the reference does) and ``hot_swap_flow`` a flow head
    (refusing a model without one)."""
    from repro_torch.launch.refinery import ResidualLedger
    ecfg = teng.EngineConfig(buckets=(2,), controller="fixed", fixed_K=2)
    xs = np.full((3, 4), -2.0, np.float32)
    plain = tsch.InflightScheduler(_toy(), ecfg, seg=1).run(xs)
    led = ResidualLedger(_toy(), capacity=8)
    sched = tsch.InflightScheduler(_toy(), ecfg, seg=1, ledger=led)
    assert_loops_equal(sched.run(xs), plain)
    assert led.fill > 0 and led.captures > 0
    with pytest.raises(ValueError, match="parametric"):
        sched.hot_swap_g({})
    with pytest.raises(ValueError, match="flow head"):
        sched.hot_swap_flow({})
    gp = {"a": torch.tensor(0.25)}
    model = dataclasses.replace(
        _toy(), g_apply=lambda p, eps, s, z, dz: p["a"] * z, g_params=gp)
    psched = tsch.InflightScheduler(model, ecfg)
    assert psched.hot_swap_g({"a": torch.tensor(0.5)}) is gp
    assert float(psched.g_params["a"]) == 0.5


# ----------------------------------------------------- roofline clock ----

def test_roofline_oracle_prices_seg_and_width():
    """The reference's pin, on the port's oracle (H100 record): seg = 2s
    costs strictly more than seg = s for a busy pool, and pool width is
    priced sublinearly where the sequential clock gives it away."""
    o = tor.RooflineOracle(torch_get("qwen3_8b"), ctx=4096)
    shape = (32,)
    for s in (1, 2, 4):
        assert o.segment_cost(shape, 2 * s, 8, 1) \
            > o.segment_cost(shape, s, 8, 1)
    t8, t16 = o.step_time(8), o.step_time(16)
    assert t8 < t16 < 2 * t8
    assert o.probe_cost(shape, 8, 2) == 2 * t8
    seq = tor.SequentialEvalOracle()
    assert seq.segment_cost(shape, 2, 8, 1) \
        == seq.segment_cost(shape, 2, 9999, 1)


def test_roofline_oracle_replay_stamps_device_us():
    """The reference's end-to-end replay on the port: the same K per
    request as the sequential clock, the same step counts, costs in
    device_us."""
    o = tor.RooflineOracle(torch_get("qwen3_8b"), ctx=4096)
    ecfg = teng.EngineConfig(buckets=(2, 4, 8), tol=5e-3, max_batch=4)
    xs = twl.heterogeneous_requests(12, 6, seed=5)
    t_seq = twl.poisson_trace(xs, rate=0.3, seed=6)
    t_us = twl.poisson_trace(xs, rate=0.3 / o.step_time(4), seed=6)
    rep_seq = twl.replay_scheduler(
        tsch.InflightScheduler(_toy(), ecfg, slots=4, seg=2), t_seq)
    rep_us = twl.replay_scheduler(
        tsch.InflightScheduler(_toy(), ecfg, slots=4, seg=2, oracle=o),
        t_us)
    assert rep_us.cost_unit == "device_us"
    assert twl.latency_stats(rep_us)["cost_unit"] == "device_us"
    assert {r.uid: r.K for r in rep_us.records} == \
        {r.uid: r.K for r in rep_seq.records}
    assert rep_us.useful_steps == rep_seq.useful_steps
    assert rep_us.total_cost > rep_seq.total_cost


@pytest.mark.parametrize("loop", ["engine", "sync", "overlap"])
def test_roofline_replay_of_the_toy_classifier_equals_reference(loop):
    """The toy classifier (the reference's head) replayed on the roofline
    clock at the v5e record through the port's drain engine or scheduler
    equals the reference's on the same trace: records and their stamps,
    the ledger and ``latency_stats``; logits at 1e-6."""
    W = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (32, 10))
                   / np.sqrt(32))
    o = tor.RooflineOracle(torch_get("qwen3_8b"), ctx=4096, chip=TPU_V5E)
    jo = jor.RooflineOracle(jax_get("qwen3_8b"), ctx=4096)
    kw = dict(buckets=(2, 4, 8, 16), tol=5e-3, max_batch=8)
    xs = twl.heterogeneous_requests(24, 32, seed=3)
    _assert_k_margin(twl.toy_classifier(W, fused=False),
                     teng.EngineConfig(**kw), xs)
    rate = 1.0 / o.step_time(8)
    if loop == "engine":
        rep = twl.replay_engine(teng.MultiRateEngine(
            twl.toy_classifier(W, fused=False), teng.EngineConfig(**kw),
            oracle=o), twl.poisson_trace(xs, rate=rate, seed=103))
        ref = jwl.replay_engine(jeng.MultiRateEngine(
            jwl.toy_classifier(fused=False), jeng.EngineConfig(**kw),
            oracle=jo), jwl.poisson_trace(xs, rate=rate, seed=103))
    else:
        rep = twl.replay_scheduler(tsch.InflightScheduler(
            twl.toy_classifier(W, fused=False), teng.EngineConfig(**kw),
            slots=8, seg=2, oracle=o, overlap=loop == "overlap"),
            twl.poisson_trace(xs, rate=rate, seed=103))
        ref = jwl.replay_scheduler(jsch.InflightScheduler(
            jwl.toy_classifier(fused=False), jeng.EngineConfig(**kw),
            slots=8, seg=2, oracle=jo),
            jwl.poisson_trace(xs, rate=rate, seed=103))
    assert_records_match(rep.records, ref.records, rtol=1e-6, atol=1e-6)
    assert (rep.total_cost, rep.probe_cost, rep.useful_steps,
            rep.total_steps, rep.occupied_steps, rep.makespan) == \
        (ref.total_cost, ref.probe_cost, ref.useful_steps, ref.total_steps,
         ref.occupied_steps, ref.makespan)
    assert twl.latency_stats(rep) == jwl.latency_stats(ref)
    assert twl.latency_stats(rep)["cost_unit"] == "device_us"
    assert len({r.K for r in rep.records}) > 1


# ------------------------------------------------------------ LM cases ----
# arch -> (layers, prompt tokens, euler probe tolerance): the drain engine
# tests' reduced models and tolerances (tests/test_torch_engine.py)
LM = {"qwen3_4b": (4, 8, 0.5), "recurrentgemma_2b": (14, 16, 0.63),
      "rwkv6_1p6b": (8, 16, 0.7), "olmoe_1b_7b": (4, 8, 0.45),
      "llama4_maverick_400b_a17b": (8, 8, 0.75)}


@functools.lru_cache(maxsize=None)
def _lm_setup(arch):
    n_layers, n_tok, tol = LM[arch]
    cfg_j = dataclasses.replace(jax_get(arch).reduced(), n_layers=n_layers,
                                dtype="float32", param_dtype="float32")
    cfg_t = dataclasses.replace(torch_get(arch).reduced(),
                                n_layers=n_layers, dtype="float32",
                                param_dtype="float32")
    pj = jax_init_lm(jax.random.PRNGKey(0), cfg_j)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    toks = np.random.RandomState(0).randint(0, cfg_j.vocab, (8, n_tok))
    toks = toks.astype(np.int32)
    kw = dict(buckets=(2, 4, 8), tol=tol, max_batch=8, solver="euler",
              fused=True)
    _, errs = jeng.MultiRateEngine(jeng.lm_depth_model(pj, cfg_j),
                                   jeng.EngineConfig(**kw)).probe(toks)
    r = errs.astype(np.float64) / tol
    assert np.abs(r - np.round(r)).min() > 1e-3, r
    ref = jwl.replay_scheduler(
        jsch.InflightScheduler(jeng.lm_depth_model(pj, cfg_j),
                               jeng.EngineConfig(**kw), slots=4, seg=2),
        jwl.poisson_trace(toks, rate=0.25, seed=0))
    return cfg_t, pt, toks, kw, ref


@pytest.mark.parametrize("arch", list(LM))
@LOOPS
def test_lm_scheduler_matches_jax(arch, overlap):
    """A reduced LM of each architecture, float32, served in flight on a
    Poisson trace (slots 4, seg 2, euler, multi-rate, fused) by the
    port's scheduler and the reference's: equal policy record for
    record, logits at 1e-4, K mixed. On a MoE model the padded probe
    routes the pool in one dispatch and every segment step routes each
    slot's row alone, as the reference's ``vmap``; routed tokens clear
    ``MARGIN``."""
    cfg_t, pt, toks, kw, ref = _lm_setup(arch)
    with routing_margins() as gaps:
        rep = twl.replay_scheduler(
            tsch.InflightScheduler(teng.lm_depth_model(pt, cfg_t),
                                   teng.EngineConfig(**kw), slots=4, seg=2,
                                   overlap=overlap),
            twl.poisson_trace(toks, rate=0.25, seed=0))
    assert not gaps or min(gaps) > MARGIN, min(gaps)
    assert len({r.K for r in rep.records}) > 1, "K is not mixed"
    assert all(r.status == "ok" for r in rep.records)
    assert_records_match(rep.records, ref.records, rtol=1e-4, atol=1e-4)
    assert twl.latency_stats(rep) == jwl.latency_stats(ref)
