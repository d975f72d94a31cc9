"""Request hardening of the port's in-flight scheduler — non-finite
quarantine, the bounded retry ladder, deadlines, overload policies and the
seeded fault injector (repro_torch/distributed/fault.py) — held against
the JAX package's on the CPU; the counterparts of tests/test_faults.py.

Both packages serve the reference's toy classifier (d = 10; the head W
drawn by JAX from PRNGKey(7) and carried across) on the same seeded
traces under the same fault schedules: ``FaultInjector`` decisions hash
their keys exactly as the reference's do, so the schedules are the same
draw. Host-side policy is held exactly (uid, K, nfe, status, completion
order, virtual stamps); outputs at fp32 rtol = atol = 1e-5 through the
head, NaN where the reference has NaN. Every probe error of the traces
lies at least 1e-4 from a K edge (asserted). The port's sync and overlap
loops are held equal bit for bit."""
import jax
import numpy as np
import pytest

from port_isolation import port_module_isolation  # noqa: F401
from repro.distributed import fault as jfault
from repro.launch import engine as jeng
from repro.launch import scheduler as jsch
from repro.launch import workload as jwl
from repro_torch.distributed import fault as tfault
from repro_torch.launch import engine as teng
from repro_torch.launch import scheduler as tsch
from repro_torch.launch import workload as twl

D = 10
W = np.array(jax.random.normal(jax.random.PRNGKey(7), (D, 10))) / np.sqrt(D)
KW = dict(buckets=(2, 4, 8, 16), tol=5e-3, max_batch=8, solver="euler",
          fused=True)
LOOPS = pytest.mark.parametrize("overlap", [False, True],
                                ids=["sync", "overlap"])
RTOL = ATOL = 1e-5


@pytest.fixture(autouse=True)
def _rearm_port_warnings():
    teng.reset_snap_overflow_warning()
    teng.reset_probe_nonfinite_warning()
    yield


def _sched(inj=None, overlap=False, **kw):
    return tsch.InflightScheduler(twl.toy_classifier(W), teng.EngineConfig(
        **KW), slots=4, seg=2, overlap=overlap, fault_injector=inj, **kw)


def _jsched(inj=None, overlap=False, **kw):
    return jsch.InflightScheduler(jwl.toy_classifier(d=D), jeng.EngineConfig(
        **KW), slots=4, seg=2, overlap=overlap, fault_injector=inj, **kw)


def _injectors(**kw):
    """The same fault schedule in both packages."""
    return tfault.FaultInjector(**kw), jfault.FaultInjector(**kw)


def _retry(**kw):
    return tfault.RetryPolicy(**kw), jfault.RetryPolicy(**kw)


def _trace(mod, n=16, seed=3, rate=0.05, **kw):
    xs = mod.heterogeneous_requests(n, D, seed=seed)
    return mod.poisson_trace(xs, rate=rate, seed=seed + 100, **kw)


def test_toy_probe_errors_clear_every_k_edge():
    """The premise of exact K parity: on every trace these tests replay,
    no request's err / tol lies within 1e-4 of an integer."""
    eng = teng.MultiRateEngine(twl.toy_classifier(W), teng.EngineConfig(**KW))
    for n, seed in ((16, 3), (12, 3), (14, 3), (10, 0), (6, 0), (4, 0),
                    (3, 0)):
        _, errs = eng.probe(twl.heterogeneous_requests(n, D, seed=seed))
        r = errs.astype(np.float64) / KW["tol"]
        assert np.abs(r - np.round(r)).min() > 1e-4, (n, seed, r)


def _key(r):
    return (r.uid, r.K, r.nfe, r.status, r.t_submit, r.t_admit, r.t_done)


def _match(port, ref):
    """Equal policy record for record in completion order; outputs
    allclose, NaN where the reference has NaN, None where it has None."""
    assert [_key(r) for r in port] == [_key(r) for r in ref]
    for a, b in zip(port, ref):
        if b.outputs is None:
            assert a.outputs is None
        else:
            np.testing.assert_allclose(a.outputs, np.asarray(b.outputs),
                                       rtol=RTOL, atol=ATOL, equal_nan=True)


def _loops_equal(a, b):
    assert [_key(r) for r in a] == [_key(r) for r in b]
    for x, y in zip(a, b):
        assert (x.outputs is None) == (y.outputs is None)
        if x.outputs is not None:
            assert np.array_equal(x.outputs, y.outputs, equal_nan=True)


def _zero_hang(rep, n):
    uids = [r.uid for r in rep.records]
    assert len(uids) == n and len(set(uids)) == n


def _drive(sched, xs):
    """Submit xs at once and step until nothing is pending; records in
    completion order."""
    for x in xs:
        sched.submit(x)
    done = []
    guard = 0
    while sched.pending:
        guard += 1
        assert guard < 200, "scheduler stopped making progress"
        done.extend(sched.step())
    return done


# ------------------------------------------------------- the injector ----

def test_fault_injector_decisions_are_call_order_free():
    """Every decision re-draws identically for the same keys, in any call
    order, and equals the reference injector's decision."""
    inj, jinj = _injectors(seed=7, nan_uid_frac=0.5, drop_flag_p=0.5,
                           straggle_tick_frac=0.5)
    x = np.ones((4,), np.float32)
    a = [np.isnan(inj.corrupt_admission(u, 0, x)).any() for u in range(20)]
    b = [np.isnan(inj.corrupt_admission(u, 0, x)).any()
         for u in reversed(range(20))]
    assert a == b[::-1] and any(a) and not all(a)
    assert a == [np.isnan(jinj.corrupt_admission(u, 0, x)).any()
                 for u in range(20)]
    poisoned = [u for u in range(20) if a[u]]
    assert not np.isnan(inj.corrupt_admission(poisoned[0], 1, x)).any()
    costs = [inj.inflate_segment_cost(t, 1.0) for t in range(20)]
    assert costs == [inj.inflate_segment_cost(t, 1.0) for t in range(20)]
    assert costs == [jinj.inflate_segment_cost(t, 1.0) for t in range(20)]
    assert any(c > 1.0 for c in costs) and not all(c > 1.0 for c in costs)
    uids, segs, fin = np.arange(6), np.zeros(6, np.int32), np.ones(6, bool)
    out1 = inj.drop_retire_flags(uids, segs, fin)
    assert (out1 == inj.drop_retire_flags(uids, segs, fin)).all()
    assert (out1 == jinj.drop_retire_flags(uids, segs, fin)).all()
    later = inj.drop_retire_flags(uids, segs + 1, fin)
    assert not (out1 == later).all() or out1.all()
    for u in range(50):
        assert tfault._hash01(3, "nan", u) == jfault._hash01(3, "nan", u)


# --------------------------------------------------- quarantine + retry ----

@LOOPS
def test_scheduler_quarantine_retries_then_diverges(overlap):
    """Transient poison: one quarantine, a requeue at a higher K floor and
    a clean re-run that retires ``retried`` with the failed attempt
    billed. Persistent poison: best-effort ``diverged`` with the
    non-finite partial readout. Records equal the reference's."""
    n = 12
    inj, jinj = _injectors(seed=1, nan_uid_frac=0.3, nan_transient=True)
    rep = twl.replay_scheduler(_sched(inj, overlap=overlap), _trace(twl, n))
    _zero_hang(rep, n)
    counts = twl.status_counts(rep)
    assert counts["retried"] >= 1 and counts["diverged"] == 0
    assert set(counts) == set(teng.STATUSES)
    clean = {r.uid: r for r in twl.replay_scheduler(
        _sched(None, overlap=overlap), _trace(twl, n)).records}
    for r in rep.records:
        if r.status == "retried":
            assert np.isfinite(r.outputs).all()
            assert r.nfe > clean[r.uid].nfe
        else:
            assert r.status == "ok" and r.nfe == clean[r.uid].nfe
            np.testing.assert_allclose(r.outputs, clean[r.uid].outputs,
                                       rtol=1e-5, atol=1e-6)
    _match(rep.records, jwl.replay_scheduler(
        _jsched(jinj, overlap=overlap), _trace(jwl, n)).records)

    inj, jinj = _injectors(seed=1, nan_uid_frac=0.3, nan_transient=False)
    rep = twl.replay_scheduler(_sched(inj, overlap=overlap), _trace(twl, n))
    _zero_hang(rep, n)
    diverged = [r for r in rep.records if r.status == "diverged"]
    assert diverged
    for r in diverged:
        assert r.outputs is not None and not np.isfinite(r.outputs).all()
    assert len(twl.ok_records(rep).records) == n - len(diverged)
    _match(rep.records, jwl.replay_scheduler(
        _jsched(jinj, overlap=overlap), _trace(jwl, n)).records)


@LOOPS
def test_scheduler_dropped_retire_flags_still_terminate(overlap):
    """A lost completion signal is re-drawn next segment: every request
    still ends ``ok``, later, and the records equal the reference's."""
    n = 12
    inj, jinj = _injectors(seed=2, drop_flag_p=0.5)
    rep = twl.replay_scheduler(_sched(inj, overlap=overlap), _trace(twl, n))
    _zero_hang(rep, n)
    assert all(r.status == "ok" for r in rep.records)
    clean = twl.replay_scheduler(_sched(None, overlap=overlap),
                                 _trace(twl, n))
    assert rep.total_cost >= clean.total_cost
    _match(rep.records, jwl.replay_scheduler(
        _jsched(jinj, overlap=overlap), _trace(jwl, n)).records)


# -------------------------------------------------------------- deadlines ----

@LOOPS
def test_deadline_eviction_and_queue_drop(overlap):
    """Stragglers push requests past their deadline: in-slot rows evict
    with the partial readout, queued rows drop without outputs, each uid
    exactly once; the records equal the reference's."""
    n = 16
    inj, jinj = _injectors(seed=5, straggle_tick_frac=0.4,
                           straggle_factor=8.0)
    rep = twl.replay_scheduler(_sched(inj, overlap=overlap),
                               _trace(twl, n, deadline_slack=60.0))
    _zero_hang(rep, n)
    counts = twl.status_counts(rep)
    assert counts["deadline"] >= 1, counts
    for r in rep.records:
        assert r.status in ("ok", "retried", "deadline")
        assert r.t_done - r.t_submit >= 0
    assert all(r.outputs is not None for r in rep.records
               if r.status == "ok")
    _match(rep.records, jwl.replay_scheduler(
        _jsched(jinj, overlap=overlap),
        _trace(jwl, n, deadline_slack=60.0)).records)


def test_deadline_expired_in_queue_drops_without_probe():
    xs = twl.heterogeneous_requests(6, D, seed=0)
    runs = []
    for make in (_sched, _jsched):
        sched = make(None)
        for x in xs[:4]:
            sched.submit(x)
        late = sched.submit(xs[4], deadline=sched.now + 1e-9)
        done = []
        while sched.pending:
            done.extend(sched.step())
        by_uid = {c.uid: c for c in done}
        assert by_uid[late].status == "deadline"
        assert by_uid[late].outputs is None and by_uid[late].segments == 0
        assert all(c.status == "ok" for u, c in by_uid.items() if u != late)
        runs.append(done)
    _match(*runs)


def test_deadline_retry_opt_in():
    """Deadline evictions opted into the ladder stay bounded: every uid
    still terminates, as in the reference."""
    n = 12
    inj, jinj = _injectors(seed=5, straggle_tick_frac=0.4,
                           straggle_factor=8.0)
    retry, jretry = _retry(retry_statuses=("diverged", "deadline"))
    rep = twl.replay_scheduler(_sched(inj, retry=retry),
                               _trace(twl, n, deadline_slack=60.0))
    _zero_hang(rep, n)
    _match(rep.records, jwl.replay_scheduler(
        _jsched(jinj, retry=jretry),
        _trace(jwl, n, deadline_slack=60.0)).records)


# --------------------------------------------------------------- overload ----

@LOOPS
def test_overload_shed_refuses_terminally(overlap):
    xs = twl.heterogeneous_requests(10, D, seed=0)
    runs = []
    for make in (_sched, _jsched):
        sched = make(None, overlap=overlap, queue_cap=2,
                     overload_policy="shed")
        done = _drive(sched, xs)
        counts = {}
        for c in done:
            counts[c.status] = counts.get(c.status, 0) + 1
        # 2 queue, 8 shed at submit time (slots fill at the next tick)
        assert counts == {"ok": 2, "shed": 8}, counts
        assert all(c.outputs is None for c in done if c.status == "shed")
        runs.append(done)
    _match(*runs)


@LOOPS
def test_overload_block_raises_and_can_submit_gates(overlap):
    xs = twl.heterogeneous_requests(3, D, seed=0)
    for make, QueueFull in ((_sched, teng.QueueFull),
                            (_jsched, jeng.QueueFull)):
        sched = make(None, overlap=overlap, queue_cap=1,
                     overload_policy="block")
        assert sched.can_submit()
        sched.submit(xs[0])
        assert not sched.can_submit()
        with pytest.raises(QueueFull):
            sched.submit(xs[1])
        sched.step()                  # admits into slots, the queue frees
        assert sched.can_submit()
        sched.submit(xs[1])
        while sched.pending:
            sched.step()
    assert tsch.QueueFull is teng.QueueFull


@LOOPS
def test_overload_degrade_caps_k_under_pressure(overlap):
    """Over-pressure admissions serve one bucket coarser; nothing is
    refused; the records equal the reference's."""
    xs = np.full((10, D), 3.0, np.float32)   # hard rows -> fine buckets
    burst = [twl.Arrival(t=0.0, x=x) for x in xs]
    jburst = [jwl.Arrival(t=0.0, x=x) for x in xs]
    rep_free = twl.replay_scheduler(_sched(None, overlap=overlap), burst)
    rep = twl.replay_scheduler(_sched(None, overlap=overlap, queue_cap=2,
                                      overload_policy="degrade"), burst)
    _zero_hang(rep, 10)
    assert all(r.status == "ok" for r in rep.records)
    k_free = {r.uid: r.K for r in rep_free.records}
    assert any(r.K < k_free[r.uid] for r in rep.records)
    _match(rep.records, jwl.replay_scheduler(
        _jsched(None, overlap=overlap, queue_cap=2,
                overload_policy="degrade"), jburst).records)


# -------------------------------------------------------- pool exhaustion ----

@LOOPS
def test_pool_survives_total_quarantine(overlap):
    """Every slot quarantined in one tick: the pool frees all rows, the
    ladder requeues them, the next tick re-admits; with retries used up
    everything ends ``diverged``. Records equal the reference's."""
    xs = twl.heterogeneous_requests(4, D, seed=0)   # exactly the pool width
    inj, jinj = _injectors(seed=0, nan_uid_frac=1.0, nan_transient=True)
    done = _drive(_sched(inj, overlap=overlap), xs)
    assert len(done) == 4 and all(c.status == "retried" for c in done)
    _match(done, _drive(_jsched(jinj, overlap=overlap), xs))
    inj, jinj = _injectors(seed=0, nan_uid_frac=1.0, nan_transient=False)
    retry, jretry = _retry(max_retries=0)
    done = _drive(_sched(inj, overlap=overlap, retry=retry), xs)
    assert len(done) == 4 and all(c.status == "diverged" for c in done)
    _match(done, _drive(_jsched(jinj, overlap=overlap, retry=jretry), xs))


def test_probe_nonfinite_counter_reaches_both_reports():
    """A NaN-poisoned admission surfaces in the drain engine's
    ``StepReport.probe_nonfinite`` and the scheduler's
    ``TickReport.probe_nonfinite``, as in the reference."""
    inj, _ = _injectors(seed=1, nan_uid_frac=1.0, nan_transient=False)
    retry, _ = _retry(max_retries=0)
    xs = twl.heterogeneous_requests(3, D, seed=0)
    eng = teng.MultiRateEngine(twl.toy_classifier(W), teng.EngineConfig(**KW),
                               fault_injector=inj, retry=retry)
    for x in xs:
        eng.submit(x)
    with pytest.warns(RuntimeWarning, match="non-finite probe error"):
        done = eng.step()
    assert eng.last_report.probe_nonfinite == 3
    assert all(c.status == "diverged" for c in done)
    sched = _sched(inj, retry=retry)
    for x in xs:
        sched.submit(x)
    sched.step()
    assert sched.last_report.probe_nonfinite == 3


# ---------------------------------------------- sync/overlap fault parity ----

def test_overlap_parity_under_faults():
    """The pipelined loop resolves the same fault schedule to the same
    records bit for bit (statuses, stamps, nfe, outputs), and both equal
    the reference's sync loop."""
    n = 14
    mixes = [dict(seed=1, nan_uid_frac=0.3, nan_transient=True),
             dict(seed=2, drop_flag_p=0.4),
             dict(seed=5, straggle_tick_frac=0.4, straggle_factor=8.0)]
    for mix in mixes:
        inj, jinj = _injectors(**mix)
        kw = {"deadline": 80.0} if mix.get("straggle_tick_frac") else {}
        a = twl.replay_scheduler(_sched(inj, **kw), _trace(twl, n))
        b = twl.replay_scheduler(_sched(inj, overlap=True, **kw),
                                 _trace(twl, n))
        _zero_hang(a, n)
        _loops_equal(a.records, b.records)
        _match(a.records, jwl.replay_scheduler(_jsched(jinj, **kw),
                                               _trace(jwl, n)).records)


# --------------------------------------------- status-key frozen contract ----

def test_status_counts_and_latency_stats_frozen_keys():
    """``status_counts`` keys on every status of ``engine.STATUSES``;
    ``latency_stats`` keeps the reference's frozen key set, also for an
    empty replay; ``ok_records`` keeps the requests with real outputs."""
    assert teng.STATUSES == jeng.STATUSES
    n = 10
    inj, jinj = _injectors(seed=1, nan_uid_frac=0.4, nan_transient=True)
    rep = twl.replay_scheduler(_sched(inj), _trace(twl, n))
    counts = twl.status_counts(rep)
    assert set(counts) == set(teng.STATUSES)
    assert sum(counts.values()) == n and counts["retried"] >= 1
    ref = jwl.replay_scheduler(_jsched(jinj), _trace(jwl, n))
    assert counts == jwl.status_counts(ref)
    frozen = {"requests", "p50_latency", "p99_latency", "mean_latency",
              "p50_queue_wait", "p99_queue_wait", "mean_nfe",
              "throughput", "total_cost", "probe_cost", "useful_steps",
              "waste_steps", "waste_frac", "occupancy", "cost_unit"}
    assert set(twl.latency_stats(rep)) == frozen
    assert twl.latency_stats(rep) == jwl.latency_stats(ref)
    empty = twl.replay_scheduler(_sched(None), [])
    assert twl.latency_stats(empty) == jwl.latency_stats(
        jwl.replay_scheduler(_jsched(None), []))
    kept = twl.ok_records(rep)
    assert {r.status for r in kept.records} <= {"ok", "retried"}
    assert any(r.status == "retried" for r in kept.records)
