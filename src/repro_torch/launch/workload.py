"""Arrival traces and latency accounting for the serving loops — the port
of ``repro/launch/workload.py``.

Seeded, reproducible streaming workloads (Poisson and bursty arrivals
over a heterogeneous difficulty mix) and replay functions that run the same
trace through the drain engine (``launch/engine.py``) and the in-flight
scheduler (``launch/scheduler.py``) on the same virtual clock, producing
comparable per-request records:

    queue wait  = arrival -> the solve that serves it starts
    latency     = arrival -> outputs ready
    waste       = slot/sample depth-steps computed for frozen or empty rows

Traces are drawn with numpy's ``RandomState`` exactly as the reference
draws them, so the same seed gives the same trace in both packages. The
toy servables take the seeded weights the reference draws from
``jax.random`` as arguments (the tests carry the reference's across).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------- traces ----

@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request arrival: time on the virtual clock + its input.
    ``deadline`` is ABSOLUTE on the same clock (the trace functions stamp
    ``t + deadline_slack``); None = no deadline."""

    t: float
    x: np.ndarray
    deadline: Optional[float] = None


def heterogeneous_requests(n: int, d: int, *, easy_frac: float = 0.5,
                           easy_loc: float = -2.0, hard_loc: float = 3.0,
                           scale: float = 0.05, seed: int = 0,
                           interleave: bool = True) -> np.ndarray:
    """The repo's standard toy difficulty mix: request rows whose mean
    drives a softplus stiffness, so `easy_loc` rows integrate in the
    smallest buckets and `hard_loc` rows need the finest mesh (the same
    construction tests/test_engine.py uses). ``interleave`` shuffles the
    two classes together so arrival order carries a realistic mix."""
    rng = np.random.RandomState(seed)
    n_easy = int(round(n * easy_frac))
    xs = np.concatenate([
        rng.randn(n_easy, d) * scale + easy_loc,
        rng.randn(n - n_easy, d) * scale + hard_loc,
    ]).astype(np.float32)
    if interleave:
        rng.shuffle(xs)
    return xs


def drifting_requests(n: int, d: int, *, phases: int = 3, seed: int = 0,
                      easy_frac0: float = 0.8, easy_frac1: float = 0.2,
                      hard_loc0: float = 2.0, hard_loc1: float = 3.5,
                      scale: float = 0.05) -> np.ndarray:
    """A non-stationary difficulty mix: ``phases`` contiguous blocks whose
    easy fraction slides from ``easy_frac0`` to ``easy_frac1`` and whose
    hard-class location from ``hard_loc0`` to ``hard_loc1`` — the drift
    the online refinery exists for."""
    rng = np.random.RandomState(seed)
    blocks = []
    edges = np.linspace(0, n, phases + 1).astype(int)
    for p in range(phases):
        m = int(edges[p + 1] - edges[p])
        if m == 0:
            continue
        u = p / max(phases - 1, 1)
        blocks.append(heterogeneous_requests(
            m, d,
            easy_frac=float(easy_frac0 + (easy_frac1 - easy_frac0) * u),
            hard_loc=float(hard_loc0 + (hard_loc1 - hard_loc0) * u),
            scale=scale, seed=int(rng.randint(1 << 30)), interleave=True))
    return np.concatenate(blocks).astype(np.float32)


def poisson_trace(xs: np.ndarray, rate: float, *, seed: int = 0,
                  t0: float = 0.0,
                  deadline_slack: Optional[float] = None) -> List[Arrival]:
    """Poisson arrival process: exponential inter-arrival gaps at ``rate``
    requests per virtual cost unit, one arrival per row of ``xs``.
    ``deadline_slack`` stamps each arrival's absolute deadline at
    ``t + slack`` (None = no deadlines)."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(1.0 / rate, size=len(xs))
    ts = t0 + np.cumsum(gaps)
    return [Arrival(t=float(t), x=np.asarray(x),
                    deadline=None if deadline_slack is None
                    else float(t) + deadline_slack)
            for t, x in zip(ts, xs)]


def bursty_trace(xs: np.ndarray, *, burst: int = 4, gap: float = 20.0,
                 within: float = 0.0, seed: int = 0, t0: float = 0.0,
                 deadline_slack: Optional[float] = None) -> List[Arrival]:
    """Bursty arrivals: groups of ``burst`` requests landing (near-)
    simultaneously, bursts separated by ``gap`` cost units (+- 25%
    jitter). ``within`` spreads a burst's members by that many units;
    ``deadline_slack`` stamps absolute deadlines at ``t + slack``."""
    rng = np.random.RandomState(seed)
    arrivals: List[Arrival] = []
    t = t0
    for lo in range(0, len(xs), burst):
        chunk = xs[lo:lo + burst]
        offs = np.sort(rng.uniform(0.0, within, size=len(chunk))) \
            if within > 0 else np.zeros(len(chunk))
        for off, x in zip(offs, chunk):
            arrivals.append(Arrival(
                t=float(t + off), x=np.asarray(x),
                deadline=None if deadline_slack is None
                else float(t + off) + deadline_slack))
        t += gap * float(rng.uniform(0.75, 1.25))
    return arrivals


# ------------------------------------------------------------- accounting ----

@dataclasses.dataclass(frozen=True)
class RequestRecord:
    """Loop-agnostic per-request ledger entry (both replay functions emit
    these, so the comparison is apples-to-apples)."""

    uid: int
    t_submit: float
    t_admit: float           # when the solve serving it started
    t_done: float
    K: int
    nfe: int
    outputs: np.ndarray      # None for shed / queue-expired requests
    status: str = "ok"       # terminal status (engine.STATUSES)

    @property
    def queue_wait(self) -> float:
        return self.t_admit - self.t_submit

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit


@dataclasses.dataclass(frozen=True)
class TraceReport:
    """One trace replay: per-request records + aggregate work accounting.

    ``occupied_steps`` counts slot/sample-steps that belonged to an
    admitted request at segment start (the in-flight scheduler's pool
    utilization; for the drain engine every scanned row was admitted, so
    it equals ``total_steps``). ``cost_unit`` names the clock that priced
    ``total_cost``/``probe_cost`` and every timestamp in ``records`` —
    step COUNTS (useful/total/occupied) are clock-independent."""

    records: Tuple[RequestRecord, ...]
    total_cost: float        # oracle units spent, arrivals -> drained
    probe_cost: float
    useful_steps: int        # sample-steps that advanced a live request
    total_steps: int         # sample-steps computed (incl. frozen/empty)
    makespan: float          # first arrival -> last completion
    # slot-steps owned by an admitted request; None = "built without
    # in-flight slot accounting", i.e. drain semantics: every scanned row
    # was an admitted request, so occupancy derives to 1.0 (the old
    # default of 0 silently reported 0.0 for such reports — bug fixed in
    # the cost-oracle PR, pinned by tests/test_scheduler.py)
    occupied_steps: Optional[int] = None
    cost_unit: str = "sequential_evals"

    @property
    def waste_steps(self) -> int:
        return self.total_steps - self.useful_steps

    @property
    def occupancy(self) -> float:
        """Fraction of computed slot-steps owned by an admitted request;
        1.0 by construction for drain reports (``occupied_steps=None``)."""
        occ = (self.total_steps if self.occupied_steps is None
               else self.occupied_steps)
        return occ / self.total_steps if self.total_steps else 0.0


def latency_stats(report: TraceReport) -> Dict[str, float]:
    """The summary row both serving loops report: latency/queue-wait
    percentiles, throughput, and masked-step waste. An empty replay
    (zero-request trace) yields a zero summary, not a crash."""
    if not report.records:
        return {"requests": 0, "p50_latency": 0.0, "p99_latency": 0.0,
                "mean_latency": 0.0, "p50_queue_wait": 0.0,
                "p99_queue_wait": 0.0, "mean_nfe": 0.0, "throughput": 0.0,
                "total_cost": round(report.total_cost, 1),
                "probe_cost": round(report.probe_cost, 1),
                "useful_steps": 0, "waste_steps": 0, "waste_frac": 0.0,
                "occupancy": 0.0, "cost_unit": report.cost_unit}
    lat = np.asarray([r.latency for r in report.records])
    wait = np.asarray([r.queue_wait for r in report.records])
    nfe = np.asarray([r.nfe for r in report.records])
    n = len(report.records)
    waste_frac = (report.waste_steps / report.total_steps
                  if report.total_steps else 0.0)
    return {
        "requests": n,
        "p50_latency": round(float(np.percentile(lat, 50)), 3),
        "p99_latency": round(float(np.percentile(lat, 99)), 3),
        "mean_latency": round(float(lat.mean()), 3),
        "p50_queue_wait": round(float(np.percentile(wait, 50)), 3),
        "p99_queue_wait": round(float(np.percentile(wait, 99)), 3),
        "mean_nfe": round(float(nfe.mean()), 3),
        "throughput": round(n / report.makespan, 4) if report.makespan
        else float("inf"),
        "total_cost": round(report.total_cost, 1),
        "probe_cost": round(report.probe_cost, 1),
        "useful_steps": int(report.useful_steps),
        "waste_steps": int(report.waste_steps),
        "waste_frac": round(waste_frac, 4),
        "occupancy": round(report.occupancy, 4),
        "cost_unit": report.cost_unit,
    }


def status_counts(report: TraceReport) -> Dict[str, int]:
    """Terminal-status histogram over a replay's records — the chaos
    bench's accounting row. Keyed by the live ``engine.STATUSES`` enum
    (every key present, zero or not), NOT folded into ``latency_stats``:
    that summary's keys are pinned by committed BENCH artifacts."""
    from repro_torch.launch.engine import STATUSES

    counts = {s: 0 for s in STATUSES}
    for r in report.records:
        counts[r.status] += 1
    return counts


def ok_records(report: TraceReport) -> TraceReport:
    """The report restricted to requests that produced real outputs
    (``ok``/``retried``/``escalated`` — an escalated request completed
    on the K-bucket ladder after its flow eval failed, so its outputs
    are as real as a retried one's) — latency percentiles over shed or
    evicted requests (t_done == t_submit, or a truncated solve) would
    flatter the very loop that failed them."""
    keep = tuple(r for r in report.records
                 if r.status in ("ok", "retried", "escalated"))
    return dataclasses.replace(report, records=keep)


# ---------------------------------------------------------------- replays ----

def replay_engine(engine, trace: Sequence[Arrival], *,
                  on_tick=None, should_admit=None) -> TraceReport:
    """Drive a ``MultiRateEngine`` through an arrival trace with drain
    semantics: whenever the loop turns and work is queued, ``step()``
    serves EVERYTHING queued to completion (new arrivals wait out the
    drain). Request i's service start is the drain start; its completion
    lands at the drain's per-batch finish offset (engine.StepReport).

    ``on_tick(engine)``, if given, runs after every drain step — the
    cooperative slot the online refinery trains in
    (``launch/refinery.py::Refinery.tick``); it must not touch the
    engine's queue or pools (the loops own those). ``should_admit()``
    returning False stops admission for good: remaining arrivals are
    dropped unsubmitted, already-queued work drains to completion — the
    graceful-shutdown contract (serve.py SIGTERM/SIGINT)."""
    trace = sorted(trace, key=lambda a: a.t)
    now = 0.0
    i = 0
    t_submit: Dict[int, float] = {}
    records: List[RequestRecord] = []
    total_cost = probe_cost = 0.0
    useful = total = 0
    while i < len(trace) or len(engine):
        if should_admit is not None and not should_admit():
            i = len(trace)          # drain what's in; admit nothing more
            if not len(engine):
                break
        if not len(engine):
            now = max(now, trace[i].t)          # idle-jump to next arrival
        while i < len(trace) and trace[i].t <= now \
                and engine.can_submit():
            uid = engine.submit(trace[i].x, deadline=trace[i].deadline)
            t_submit[uid] = trace[i].t
            i += 1
        t_drain = now
        done = engine.step(now=now)
        rep = engine.last_report
        now += rep.cost
        total_cost += rep.cost
        probe_cost += rep.probe_cost
        useful += rep.useful_steps
        total += rep.total_steps
        for c in done:
            records.append(RequestRecord(
                uid=c.uid, t_submit=t_submit.pop(c.uid), t_admit=t_drain,
                t_done=t_drain + rep.finish_offset[c.uid], K=c.K, nfe=c.nfe,
                outputs=c.outputs, status=c.status))
        if on_tick is not None:
            on_tick(engine)
    t0 = trace[0].t if trace else 0.0
    t_end = max((r.t_done for r in records), default=t0)
    # every scanned row of a drain was an admitted request, so the
    # engine's occupancy is total_steps by construction
    return TraceReport(records=tuple(records), total_cost=total_cost,
                       probe_cost=probe_cost, useful_steps=useful,
                       total_steps=total, makespan=t_end - t0,
                       occupied_steps=total,
                       cost_unit=getattr(getattr(engine, "oracle", None),
                                         "unit", "sequential_evals"))


def replay_scheduler(sched, trace: Sequence[Arrival], *,
                     on_tick=None, should_admit=None) -> TraceReport:
    """Drive an ``InflightScheduler`` through the same arrival trace:
    arrivals are submitted the moment the virtual clock passes them, and
    each ``step()`` admits + advances one segment — requests overlap
    in-flight instead of waiting out a drain.

    ``on_tick(sched)``, if given, runs BETWEEN scheduler ticks — after a
    segment retires, before the next admission. This is where the online
    refinery trains and (between segments) hot-swaps g
    (``launch/refinery.py``): cooperative, same thread, never inside the
    compiled path. It must not submit or retire requests itself.
    ``should_admit()`` returning False stops admission for good:
    remaining arrivals are dropped unsubmitted and the in-flight slots
    flush to completion — the graceful-shutdown contract (serve.py
    SIGTERM/SIGINT)."""
    trace = sorted(trace, key=lambda a: a.t)
    i = 0
    records: List[RequestRecord] = []
    while i < len(trace) or sched.pending:
        if should_admit is not None and not should_admit():
            i = len(trace)          # drain what's in; admit nothing more
            if not sched.pending:
                break
        while i < len(trace) and trace[i].t <= sched.now \
                and sched.can_submit():
            sched.submit(trace[i].x, t=trace[i].t,
                         deadline=trace[i].deadline)
            i += 1
        if not sched.pending:
            sched.advance_to(trace[i].t)
            continue
        for c in sched.step():
            records.append(RequestRecord(
                uid=c.uid, t_submit=c.t_submit, t_admit=c.t_admit,
                t_done=c.t_done, K=c.K, nfe=c.nfe, outputs=c.outputs,
                status=c.status))
        if on_tick is not None:
            on_tick(sched)
    t0 = trace[0].t if trace else 0.0
    t_end = max((r.t_done for r in records), default=t0)
    return TraceReport(
        records=tuple(records), total_cost=sched.total_cost,
        probe_cost=sched.total_probe_cost,
        useful_steps=sched.total_useful_steps,
        total_steps=sched.total_slot_steps, makespan=t_end - t0,
        occupied_steps=sched.total_occupied_steps,
        cost_unit=getattr(getattr(sched, "oracle", None), "unit",
                          "sequential_evals"))


# ------------------------------------------------------------ toy servable ----

def toy_classifier(W: np.ndarray, solver: str = "euler", fused: bool = True):
    """The reference's deterministic toy servable classifier: stiffness
    (difficulty) driven by the input mean through a softplus, readout a
    fixed linear head ``W`` of shape ``(d, n_classes)``, on the CPU. The
    reference draws ``W`` from ``jax.random.PRNGKey(7)``, which this
    package cannot draw, so the caller passes it (the tests carry the
    reference's across)."""
    import torch

    from repro_torch.core import Integrator, get_tableau
    from repro_torch.launch.engine import DepthModel

    W_t = torch.from_numpy(np.array(W, copy=True))

    def field_of(x):
        k = torch.nn.functional.softplus(
            torch.as_tensor(x).mean(dim=-1, keepdim=True))
        return lambda s, z: -z * k

    g = None
    if solver.startswith("hyper_"):
        g = lambda eps, s, z, dz: 0.3 * z + 0.1 * dz
    base = solver[len("hyper_"):] if solver.startswith("hyper_") else solver
    return DepthModel(
        embed=lambda x: torch.as_tensor(x) + 0.0,
        field_of=field_of,
        readout=lambda x, zT: zT @ W_t.to(zT.dtype),
        integ=Integrator(tableau=get_tableau(base), g=g, fused=fused),
    )


def _toy_mlp(z, dz, s, eps, p):
    """The toy nets' element-wise MLP over ``[z, dz, s, eps]``: ``s`` and
    ``eps`` (scalars or per-row ``(B,)``) broadcast up to ``z``."""
    import torch

    def up(a):
        a = torch.as_tensor(a, dtype=z.dtype, device=z.device)
        return a.reshape(tuple(a.shape) + (1,) * (z.ndim - a.ndim)) \
            .expand(z.shape)

    feats = torch.stack([z, dz, up(s), up(eps)], dim=-1)
    h = torch.tanh(feats @ p["w1"] + p["b1"])
    return (h @ p["w2"])[..., 0] + p["b2"][0]


def _mlp_params(w1: np.ndarray):
    """Zero-readout MLP params around a seeded first layer ``w1`` (4, H)."""
    import torch
    hidden = w1.shape[1]
    return {"w1": torch.from_numpy(np.array(w1, np.float32, copy=True)),
            "b1": torch.zeros((hidden,)),
            "w2": torch.zeros((hidden, 1)),
            "b2": torch.zeros((1,))}


def toy_refinable_classifier(W: np.ndarray, w1: np.ndarray,
                             base: str = "euler", fused: bool = True):
    """``toy_classifier``'s parametric twin, the model the refinery tests
    train, score and swap: an anisotropic stiff decay (a per-feature
    profile ``linspace(0.4, 1.6, d)`` scales each row's softplus rate, so
    integration error moves the argmax), the linear head ``W`` (d,
    n_classes), and an element-wise MLP correction ``g_apply(gp, eps, s,
    z, dz)`` over ``[z, dz, s, eps]`` whose zero readout makes g vanish
    exactly. The reference draws ``W`` from ``PRNGKey(7)`` and ``w1``
    (4, hidden) from ``PRNGKey(11)``; the caller passes both."""
    import torch

    from repro_torch.core import Integrator, get_tableau
    from repro_torch.launch.engine import DepthModel

    W_t = torch.from_numpy(np.array(W, copy=True))
    d = W_t.shape[0]
    w_feat = torch.from_numpy(np.linspace(0.4, 1.6, d).astype(np.float32))

    def field_of(x):
        k = torch.nn.functional.softplus(
            torch.as_tensor(x).mean(dim=-1, keepdim=True))
        return lambda s, z: -z * (k * w_feat)

    return DepthModel(
        embed=lambda x: torch.as_tensor(x) + 0.0,
        field_of=field_of,
        readout=lambda x, zT: zT @ W_t.to(zT.dtype),
        integ=Integrator(tableau=get_tableau(base), fused=fused),
        g_apply=lambda gp, eps, s, z, dz: _toy_mlp(z, dz, s, eps, gp),
        g_params=_mlp_params(w1),
    )


def toy_flow_classifier(W: np.ndarray, w1: np.ndarray, flow_w1: np.ndarray,
                        base: str = "euler", fused: bool = True):
    """``toy_refinable_classifier`` plus a K=0 flow head: a second
    zero-readout MLP wrapped by ``core.flowhead.make_flow_apply`` (so a
    cold flow is exactly one full-span Euler step). The reference draws
    ``flow_w1`` from ``PRNGKey(23)``; the caller passes it."""
    from repro_torch.core.flowhead import make_flow_apply

    model = toy_refinable_classifier(W, w1, base, fused)
    return dataclasses.replace(
        model,
        flow_apply=make_flow_apply(
            lambda fp, eps, s, z, dz: _toy_mlp(z, dz, s, eps, fp),
            order=model.integ.order),
        flow_params=_mlp_params(flow_w1),
    )
