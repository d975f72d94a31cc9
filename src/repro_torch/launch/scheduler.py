"""In-flight depth-continuous batching — the port of
``repro/launch/scheduler.py`` (see its docstring for the design).

Where ``MultiRateEngine.step()`` drains the queue and solves each packed
batch to completion, ``InflightScheduler`` keeps a fixed slot pool per
request (shape, dtype) and advances it ``seg`` depth steps at a time
(``Integrator.segment_cell``): between segments, finished slots retire
(readout -> completion record) and free slots refill from the queue
(probe on admission, padded to the pool width). A K=2 request admitted
next to a half-done K=16 one leaves after its own segments.

Policy on the host matches the reference exactly: request-to-slot
assignment, K, nfe (probe and failed attempts included), status,
completion order, and the virtual-clock stamps (``launch/oracle.py``;
each pool's completions carry only that pool's probe and segment cost).

PyTorch terms for the reference's JAX mechanisms:

  * a jit cell per ``(shape, seg)`` is one eager ``segment_cell`` per
    pool; the donated carry is the pool's own ``z`` buffer, which the
    cell writes in place;
  * async dispatch is the CUDA stream: host rows go up through pinned
    buffers with non-blocking copies, and the ``(3, B)`` meta row and the
    readout rows come back the same way, each behind a CUDA event that
    ``retire_pending`` / ``finalize_retired`` wait on (a record's
    outputs are a view of its pinned buffer, which returns to PyTorch's
    pinned cache when the record is dropped). The overlap loop
    (``overlap=True``) launches segment N+1 before it reads segment N's
    meta. The depth field splits a batch by group index on the host
    (``models/cdepth.py``), which waits for the device at every field
    evaluation of a mixed pool, so on the card the overlap loop is
    correct but overlaps little.

The K=0 flow tier (``EngineConfig.flow_threshold > 0`` on a model with
a flow head): probe-easy rows never take a slot; their flow eval and
readout are staged at admission like a retiring batch and materialise in
``finalize_retired``, where a non-finite row escalates to the front of
the queue with ``K_floor`` at the coarsest bucket. A ``ResidualLedger``
(``ledger=``, launch/refinery.py) captures interior healthy rows at each
retire, from the pool's ``z`` after the segment and before the next one
is launched (stream order keeps the capture's reads ahead of the next
in-place write, and the rows reach the host through a blocking copy of
a gathered snapshot). ``hot_swap_g``/``hot_swap_flow`` replace the params
dict between segments; the next launch reads the new one, a segment
already queued keeps the tensors it was launched with (one stream), and
no resident tensor is written in place.

Multi-device slot pools (``mesh=``, a ``launch/mesh.py::ServingMesh``):
``slots`` is the global pool width, split row-wise into one sub-pool of
``slots / n`` rows per mesh entry, each with its own carry on its own
device (entry i holds rows ``[i*slots/n, (i+1)*slots/n)``). Admission
stays one FIFO queue and one pool-width probe on the mesh's first device;
admitted rows are scattered to their owners. The host rows (uid, k, Ks,
eps, stamps) stay global, so retire, refill, quarantine, deadline
eviction, the retry ladder, the flow tier and the ledger work on them
exactly as on one device: the segment's ``[k'; finished; nonfinite]``
meta is gathered in global slot order on the first device, and retiring
rows (and a ledger capture's rows) are gathered there too before the
readout, which runs on the first device as on one. Each mesh device gets
its own replica of the model (``DepthModel.replicate``, one per distinct
device: a repeated entry shares it) and of the correction's params. On
the virtual clock a segment of the global pool costs what it costs on
one device, once per pool and tick. Without ``mesh=`` a pool's mesh is
the one device its model probes on, with one sub-pool: both run the
same code.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.controllers import FixedController, TierRouter
from repro_torch.distributed.fault import FaultInjector, RetryPolicy
from repro_torch.launch.engine import (
    STATUSES, DepthModel, EngineConfig, QueueFull, Request, bound_integrator,
    make_controller, next_bucket_above, prepare_model, probe_net_nfe,
    screen_probe_errors, snap_to_buckets, swap_params, take_rows,
)
from repro_torch.launch.mesh import ServingMesh
from repro_torch.launch.oracle import SequentialEvalOracle

__all__ = ["InflightScheduler", "InflightCompleted", "TickReport",
           "STATUSES", "QueueFull", "RetryPolicy", "FaultInjector"]

def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host row on ``device``: on a card through a pinned buffer and a
    non-blocking copy (no wait for the device), on the CPU a copy."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)


class _Readback:
    """A device-to-host copy in flight: on a card a non-blocking copy into
    a pinned buffer behind a CUDA event, waited on by ``numpy()``; on the
    CPU the tensor itself. ``numpy()`` returns a view of the host buffer
    (which it keeps alive), not a copy."""

    __slots__ = ("host", "event")

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host = t

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


@dataclasses.dataclass(frozen=True)
class InflightCompleted:
    """Per-request terminal record: queue wait (submit -> last admission)
    and service (admission -> retirement) on the virtual clock.
    ``ok``/``retried`` carry real outputs, ``diverged``/``deadline`` the
    best-effort partial readout (None if the request expired queued),
    ``shed`` None."""

    uid: int
    outputs: Optional[np.ndarray]
    K: int                        # snapped mesh length actually integrated
    nfe: int                      # probe (net of reuse) + stages * steps,
    #                               summed over every attempt
    err_probe: float
    fused_kernel: bool
    t_submit: float
    t_admit: float
    t_done: float
    segments: int                 # pool segments this request rode
    status: str = "ok"            # terminal status (engine.STATUSES)

    @property
    def queue_wait(self) -> float:
        return self.t_admit - self.t_submit

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit


@dataclasses.dataclass(frozen=True)
class TickReport:
    """One scheduling round: admissions + at most one segment per pool."""

    cost: float = 0.0             # virtual cost of this tick
    probe_cost: float = 0.0
    admitted: int = 0
    retired: int = 0              # terminal records surfaced this tick
    useful_steps: int = 0         # slot-steps that advanced a live request
    total_steps: int = 0          # slots * seg over pools that ran
    occupied_steps: int = 0       # occupied-slot-steps (live at segment start)
    quarantined: int = 0          # slots force-retired non-finite this tick
    deadline_evicted: int = 0     # slots/queued requests evicted past deadline
    requeued: int = 0             # failed slots re-queued by the retry ladder
    shed: int = 0                 # admission refusals surfaced this tick
    probe_nonfinite: int = 0      # non-finite probe errors seen at admission
    flow_served: int = 0          # requests completed on the K=0 flow tier
    escalated: int = 0            # flow failures requeued to the K ladder

    @property
    def waste_steps(self) -> int:
        """Slot-steps computed for frozen or empty rows."""
        return self.total_steps - self.useful_steps


@dataclasses.dataclass
class _PendingSegment:
    """A segment in flight: its ``[k'; finished; nonfinite]`` meta on its
    way to the host, and the host snapshots that account it."""

    meta: _Readback
    k_old: np.ndarray             # k rows at launch
    occ: np.ndarray               # occupancy at launch (bool row)
    t_done: float                 # virtual completion stamp for retires


@dataclasses.dataclass
class _FlowBatch:
    """K=0 flow-tier rows staged at admission: ``outs`` on its way to the
    host until ``finalize_retired``; the host rows snapshot the admitted
    requests (flow rows hold no slot). ``xs`` keeps the original inputs,
    never the fault injector's poisoned copies, so an escalation
    requeues clean data."""

    n: int                        # real rows (outs may be pow2-padded)
    outs: _Readback
    t_done: float                 # admission probe + flow eval, this pool
    uid: np.ndarray
    err: np.ndarray
    t_submit: np.ndarray
    t_admit: float
    deadline: np.ndarray          # np.inf = none
    attempts: np.ndarray
    xs: np.ndarray


@dataclasses.dataclass
class _RetireBatch:
    """Retiring rows staged for materialization: ``outs`` is still on its
    way to the host; the host rows are snapshots, because admission may
    refill the slots before ``finalize_retired``."""

    idx: np.ndarray
    outs: _Readback
    t_done: float
    fused: bool
    uid: np.ndarray
    K: np.ndarray
    k_done: np.ndarray            # depth steps actually taken (== K for ok)
    err: np.ndarray
    t_submit: np.ndarray
    t_admit: np.ndarray
    segments: np.ndarray
    status: List[str]             # terminal status per row


@dataclasses.dataclass(frozen=True)
class _RetireStats:
    """Per-pool retirement accounting for one segment."""

    retired: int = 0              # rows staged terminal (any status)
    useful: int = 0
    occupied: int = 0
    quarantined: int = 0
    deadline_evicted: int = 0
    requeued: int = 0


class _SlotPool:
    """Fixed-width slot pool for one request (shape, dtype): the carry
    (``z`` and ``fs`` pytrees, allocated at the first admission and
    written in place from then on) and the host rows (k, Ks, eps, uid,
    timestamps). The carry and the device mirror of ``xs`` are tuples
    with one sub-pool's rows per entry of the pool's mesh, each on its
    entry's device; without a scheduler mesh the pool's mesh is the one
    device the model probes on, and its one sub-pool is the whole pool.
    ``device`` is the first entry's."""

    def __init__(self, sched: "InflightScheduler", shape: Tuple[int, ...],
                 dtype: np.dtype):
        # a proxy, not a reference: the scheduler owns its pools, and a
        # cycle would keep the model's weights on the card after the
        # caller drops the scheduler, until a cyclic collection ran
        self.sched = weakref.proxy(sched)
        self.shape = shape
        n = sched.slots
        self.uid = np.full((n,), -1, np.int64)        # -1 = empty slot
        self.k = np.zeros((n,), np.int32)
        self.Ks = np.zeros((n,), np.int32)
        self.eps = np.ones((n,), np.float32)
        self.err = np.zeros((n,), np.float32)
        self.t_submit = np.zeros((n,), np.float64)
        self.t_admit = np.zeros((n,), np.float64)
        self.segments = np.zeros((n,), np.int32)
        self.deadline = np.full((n,), np.inf, np.float64)
        self.attempts = np.zeros((n,), np.int32)
        self.escalated = np.zeros((n,), bool)   # flow-escalation provenance
        self.xs = np.zeros((n,) + shape, dtype)
        self.device: Optional[torch.device] = None    # set on first admit
        self.mesh: Optional[ServingMesh] = sched.mesh  # set on first admit
        self._xs_dev = None     # device mirror of xs, refreshed on admit
        self.z: Any = None                      # per-sub-pool pytrees
        self.fs: Any = None                     # probe dz rows or None
        self._pending: Optional[_PendingSegment] = None
        self._staged: List[_RetireBatch] = []
        self._staged_flow: List[_FlowBatch] = []
        self.flow_retired_last = 0   # flow terminals in the last finalize
        self._readout_widths: set = set()   # pow2 readout widths used
        self._segment_fn = None

    # ----------------------------------------------------------- cells ----
    def _probe(self, xs):
        m, sched = self.sched.model, self.sched
        z0 = m.embed(xs)
        p = sched.controller.select(bound_integrator(m, sched.g_params),
                                    m.field_of(xs), z0, m.span)
        return p.K, p.err, z0, p.dz0

    def _segment(self):
        """The pool's segment call (``Integrator.segment_cell``): one per
        (shape, seg), built at the first launch."""
        if self._segment_fn is None:
            m, sched = self.sched.model, self.sched
            # the served field over a sub-pool's conditioning rows, built
            # by the model on their device (the cell holds no reference
            # to the scheduler: no cycle through its pools)
            models = sched._replicas
            self._segment_fn = m.integ.segment_cell(
                lambda xs: models.get(xs.device, m).field_of(xs), sched.seg,
                s0=m.span[0], g_apply=m.g_apply, mesh=self.mesh)
        return self._segment_fn

    # ------------------------------------------------------- sub-pools ----
    def _up(self, a: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """A host row array split into the sub-pools' rows, each on its
        entry's device."""
        return tuple(_upload(b, d) for b, d in
                     zip(np.split(a, self.mesh.size), self.mesh.devices))

    def _rows(self, shards, rows: np.ndarray):
        """Rows ``rows`` (global slot indices, in that order) of
        per-sub-pool trees, on the first device."""
        parts, at = [], []
        for i, pos, loc in self.mesh.owners(rows, self.sched.slots):
            j = _upload(loc.astype(np.int64), self.mesh.devices[i])
            parts.append(pytree.tree_map(lambda leaf: leaf[j], shards[i]))
            at.append(pos)
        out = self.mesh.gather(parts)
        if len(parts) == 1:   # one owner: already in the order asked
            return out
        back = _upload(np.argsort(np.concatenate(at)), self.device)
        return pytree.tree_map(lambda leaf: leaf[back], out)

    def gathered(self):
        """``(xs, z)`` of every slot on the first device, in slot order:
        the pool's own buffers with one sub-pool, a gathered copy with
        several (a ledger capture reads it)."""
        return self.mesh.gather(self._xs_dev), self.mesh.gather(self.z)

    # ------------------------------------------------------- occupancy ----
    @property
    def free(self) -> np.ndarray:
        return np.flatnonzero(self.uid < 0)

    @property
    def occupied(self) -> np.ndarray:
        return self.uid >= 0

    def busy(self) -> bool:
        return bool((self.uid >= 0).any())

    # ------------------------------------------------------- admission ----
    def admit(self, reqs: List[Request], submit_t: Dict[int, float],
              now: float, degrade: bool = False) -> Tuple[float, int]:
        """Probe ``reqs`` (padded to pool width with copies of the first
        row) and scatter them into free slots. Returns (probe cost,
        non-finite probe count). ``degrade`` caps every admission one
        bucket coarser (the overload policy's pressure response)."""
        sched = self.sched
        idx = self.free[:len(reqs)]
        assert len(idx) == len(reqs), "caller admits at most `free` requests"
        n_pad = sched.slots - len(reqs)
        rows = [r.x for r in reqs]
        if sched.fault_injector is not None:
            # poisoned rows feed the probe and the device mirror; self.xs
            # keeps the original input, so a retry re-admits clean data
            rows = [sched.fault_injector.corrupt_admission(
                r.uid, r.attempts, x) for r, x in zip(reqs, rows)]
        xs_new = np.stack(rows)
        assert xs_new.dtype == self.xs.dtype, (xs_new.dtype, self.xs.dtype)
        xs_pad = np.concatenate(
            [xs_new, np.repeat(xs_new[:1], n_pad, axis=0)]) \
            if n_pad else xs_new
        xs_in = xs_pad if self.device is None \
            else _upload(xs_pad, self.device)

        fixed = isinstance(sched.controller, FixedController)
        probe_nonfinite = 0
        if fixed:
            z0 = sched.model.embed(xs_in)
            dz0 = None
            Ks_raw = np.full((len(reqs),), sched.controller.K, np.int32)
            errs = np.zeros((len(reqs),), np.float32)
            probe_cost = 0.0
        else:
            Ks_dev, err_dev, z0, dz0 = self._probe(xs_in)
            Ks_raw = Ks_dev.cpu().numpy()[:len(reqs)]
            errs = err_dev.cpu().numpy()[:len(reqs)]
            probe_nonfinite = screen_probe_errors(errs)
            # the probe runs at pool width, so the oracle prices a
            # pool-width program however many rows refilled
            probe_cost = sched.oracle.probe_cost(
                self.shape, sched.slots,
                getattr(sched.controller, "probe_nfe", 0))
        Ks = snap_to_buckets(Ks_raw, sched.ecfg.buckets)
        if degrade:
            b = np.asarray(sorted(sched.ecfg.buckets), np.int32)
            Ks = b[np.maximum(np.searchsorted(b, Ks) - 1, 0)]
        # retry ladder: a re-queued request never serves below its floor
        floors = np.asarray([r.K_floor for r in reqs], np.int32)
        Ks = np.maximum(Ks, floors)

        # K=0 flow tier: probe-easy rows never take a slot. The kept rows
        # (and the padded probe outputs) are subset so everything below
        # runs as if only they had been admitted; with the router off
        # this block never runs
        if sched.router is not None and not fixed:
            flow_sel = sched.router.flow_mask(errs, sched.ecfg.tol, floors)
            if flow_sel.any():
                flow_cost = sched.oracle.flow_cost(
                    self.shape, int(flow_sel.sum()))
                sched._flow_cost_tick += flow_cost
                self._stage_flow(reqs, flow_sel, xs_new, z0, dz0, errs,
                                 submit_t, now,
                                 t_done=now + probe_cost + flow_cost)
                keep = np.flatnonzero(~flow_sel)
                reqs = [reqs[i] for i in keep]
                xs_new = xs_new[keep]
                Ks, errs = Ks[keep], errs[keep]
                idx = idx[:len(reqs)]
                if not len(reqs):
                    return probe_cost, probe_nonfinite
                # rows 0..len(reqs)-1 of the padded probe outputs become
                # the kept rows (the scatter below reads that layout)
                pad_pos = np.concatenate(
                    [keep, np.full(sched.slots - len(keep), keep[0])])
                z0 = take_rows(z0, pad_pos)
                dz0 = take_rows(dz0, pad_pos)

        # scatter: host rows directly, device leaves in place. On the
        # pool's first admission the padded probe output becomes the
        # pool's own buffers.
        if self.z is None:
            self._own(z0, dz0)
        else:
            self._scatter(idx, z0, dz0, xs_new)
        span = sched.model.span
        for j, i in enumerate(idx):
            r = reqs[j]
            self.uid[i] = r.uid
            self.k[i] = 0
            self.Ks[i] = int(Ks[j])
            self.eps[i] = (span[1] - span[0]) / float(Ks[j])
            self.err[i] = float(errs[j])
            self.t_submit[i] = submit_t.pop(r.uid)
            self.t_admit[i] = now
            self.segments[i] = 0
            self.deadline[i] = np.inf if r.deadline is None else r.deadline
            self.attempts[i] = r.attempts
            self.escalated[i] = r.escalated
            self.xs[i] = r.x
        # device mirror of xs: only the refilled rows go up after the
        # first admission
        if self._xs_dev is None:
            self._xs_dev = self._up(self.xs)
        return probe_cost, probe_nonfinite

    def _own(self, z0, dz0) -> None:
        """The first admission: the padded probe output is split into the
        sub-pools' own buffers, each on its entry's device (the one
        sub-pool's a copy of it, without a scheduler mesh)."""
        self.device = pytree.tree_leaves(z0)[0].device
        if self.mesh is None:
            self.mesh = ServingMesh((self.device,))
        elif self.device != self.mesh.devices[0]:
            raise ValueError(
                f"the model probes on {self.device}, but the mesh's first "
                f"entry is {self.mesh.devices[0]}: build the model on the "
                "mesh's first device")
        self.z = tuple(self.mesh.split(z0, copy=True))
        self.fs = None if dz0 is None else tuple(
            self.mesh.split(dz0, copy=True))

    def _scatter(self, idx: np.ndarray, z0, dz0, xs_new) -> None:
        """A refill: admitted row j (probe row j, on the first device)
        goes to slot ``idx[j]`` of the sub-pool that owns it, with its
        conditioning row. ``idx`` ascends (free slots in order), so each
        sub-pool's rows are one run of the probe's rows."""
        for i, at, loc in self.mesh.owners(idx, self.sched.slots):
            d = self.mesh.devices[i]
            run = slice(int(at[0]), int(at[-1]) + 1)
            assert run.stop - run.start == len(at), idx
            jloc = _upload(loc.astype(np.int64), d)
            for own, new in ((self.z[i], z0),) + (
                    () if self.fs is None else ((self.fs[i], dz0),)):
                for o, nl in zip(pytree.tree_leaves(own),
                                 pytree.tree_leaves(new)):
                    o[jloc] = nl[run].to(d, non_blocking=True)
            self._xs_dev[i][jloc] = _upload(xs_new[at], d)

    def _stage_flow(self, reqs: List[Request], flow_sel: np.ndarray,
                    xs_new: np.ndarray, z0, dz0, errs: np.ndarray,
                    submit_t: Dict[int, float], now: float,
                    t_done: float) -> None:
        """Launch the flow rows' K=0 eval (a gather of the padded probe
        outputs, pow2-padded like ``_readout_finished``), start its rows
        on their way to the host, and stage the batch for
        ``finalize_retired``: no extra probe, no slot."""
        sched = self.sched
        m = sched.model
        fidx = np.flatnonzero(flow_sel)
        w = min(1 << (len(fidx) - 1).bit_length(), sched.slots)
        pad = fidx if w == len(fidx) else np.concatenate(
            [fidx, np.repeat(fidx[:1], w - len(fidx))])
        dev = pytree.tree_leaves(z0)[0].device
        outs = m.readout(_upload(xs_new[pad], dev), m.flow_apply(
            sched.flow_params, m.span[1] - m.span[0], m.span[0],
            take_rows(z0, pad), take_rows(dz0, pad)))
        rs = [reqs[i] for i in fidx]
        self._staged_flow.append(_FlowBatch(
            n=len(fidx), outs=_Readback(outs), t_done=t_done,
            uid=np.asarray([r.uid for r in rs], np.int64),
            err=errs[fidx].copy(),
            t_submit=np.asarray([submit_t.pop(r.uid) for r in rs],
                                np.float64),
            t_admit=now,
            deadline=np.asarray(
                [np.inf if r.deadline is None else r.deadline
                 for r in rs], np.float64),
            attempts=np.asarray([r.attempts for r in rs], np.int32),
            xs=np.stack([r.x for r in rs])))

    # --------------------------------------------------------- segment ----
    def launch_segment(self, t_done: float) -> None:
        """Enqueue one ``seg``-step advance of the pool and start its meta
        on its way to the host, reading nothing back: the rows go up
        through pinned buffers, and the wait for the meta is
        ``retire_pending``'s. Reads of the old state (readout gathers,
        refill scatters) were enqueued before, so stream order keeps them
        ahead of the in-place write."""
        assert self._pending is None, "one in-flight segment per pool"
        assert self._xs_dev is not None  # a busy pool has admitted
        k_old = self.k.copy()
        occ = self.occupied.copy()
        z, fs, meta = self._segment()(
            self._xs_dev, self.z, self._up(self.k), self._up(self.Ks),
            self._up(self.eps), self.fs, *self.sched._g_args(self.mesh))
        self.z, self.fs = z, fs
        self._pending = _PendingSegment(meta=_Readback(meta), k_old=k_old,
                                        occ=occ, t_done=t_done)

    def retire_pending(self) -> _RetireStats:
        """Wait for the pending segment's ``[k'; finished; nonfinite]``
        meta (one transfer per segment), stage terminal rows (their
        readout enqueued), requeue retryable failures and free their
        slots. Precedence: quarantine beats finished (a non-finite row's
        flag is meaningless), finished beats deadline (a request that
        finished completes ``ok`` even if its stamp lands late)."""
        p = self._pending
        assert p is not None, "retire_pending without a pending segment"
        self._pending = None
        sched = self.sched
        meta = p.meta.numpy()
        self.k = meta[0].copy()
        occ = p.occ
        self.segments[occ] += 1
        useful = int((self.k - p.k_old)[occ].sum())
        fin_row = meta[1] != 0
        if sched.fault_injector is not None:
            # lost completion signals, keyed per (uid, segment count): a
            # dropped flag is re-drawn next segment
            fin_row = sched.fault_injector.drop_retire_flags(
                self.uid, self.segments, fin_row)
        nonfin = occ & (meta[2] != 0)
        finished = occ & fin_row & ~nonfin
        expired = occ & ~nonfin & ~finished & (self.deadline < p.t_done)

        if sched.ledger is not None:
            # residual capture of interior healthy rows (quarantined,
            # evicted and finished rows excluded): a read of the pool's
            # state after this segment, before the next launch
            live = occ & ~nonfin & ~fin_row & ~expired \
                & (self.k < self.Ks)
            sched.ledger.capture_pool(self, np.flatnonzero(live))

        idx: List[int] = [int(i) for i in np.flatnonzero(finished)]
        status = ["ok" if self.attempts[i] == 0 else
                  ("escalated" if self.escalated[i] else "retried")
                  for i in idx]
        requeued = 0
        for i in np.flatnonzero(nonfin | expired):
            st = "diverged" if nonfin[i] else "deadline"
            # one bucket finer; at the top bucket the same bucket again
            nxt = next_bucket_above(int(self.Ks[i]), sched.ecfg.buckets) \
                or int(self.Ks[i])
            if sched.retry.should_retry(st, int(self.attempts[i])):
                self._requeue_slot(int(i), nxt)
                requeued += 1
            else:
                idx.append(int(i))
                status.append(st)
        retired = 0
        if idx:
            retired = self._stage_retire(np.asarray(idx, np.int64),
                                         p.t_done, status)
        return _RetireStats(
            retired=retired, useful=useful, occupied=int(occ.sum()),
            quarantined=int(nonfin.sum()),
            deadline_evicted=int(expired.sum()), requeued=requeued)

    def _requeue_slot(self, i: int, K_floor: int) -> None:
        """Send slot ``i`` back to the FRONT of the queue (both loops admit
        it at the next ``_admit_tick``) with its floor raised, the failed
        attempt's work charged to ``_nfe_extra``; free the slot without a
        readout."""
        sched = self.sched
        uid = int(self.uid[i])
        sched._nfe_extra[uid] = sched._nfe_extra.get(uid, 0) \
            + sched.probe_nfe + sched.stages * int(self.k[i])
        sched._submit_t[uid] = float(self.t_submit[i])
        deadline = float(self.deadline[i])
        sched._queue.appendleft(Request(
            uid=uid, x=self.xs[i].copy(),
            deadline=deadline if np.isfinite(deadline) else None,
            attempts=int(self.attempts[i]) + 1, K_floor=K_floor,
            escalated=bool(self.escalated[i])))
        self.uid[i] = -1
        self.Ks[i] = 0
        self.eps[i] = 1.0
        self.k[i] = 0
        self.deadline[i] = np.inf

    def _stage_retire(self, idx: np.ndarray, t_done: float,
                      status: List[str]) -> int:
        """Retire the slots ``idx``: enqueue their readout (a force-retired
        row's partial state is its best-effort answer), snapshot their
        host rows, and free them."""
        outs = self._readout_finished(idx)
        self._staged.append(_RetireBatch(
            idx=idx, outs=outs, t_done=t_done,
            fused=self.sched.model.integ.fused_available(z=self.z),
            uid=self.uid[idx].copy(), K=self.Ks[idx].copy(),
            k_done=self.k[idx].copy(),
            err=self.err[idx].copy(), t_submit=self.t_submit[idx].copy(),
            t_admit=self.t_admit[idx].copy(),
            segments=self.segments[idx].copy(), status=list(status)))
        self.uid[idx] = -1            # retire: slot becomes refillable
        self.Ks[idx] = 0              # Ks == 0 keeps the row frozen
        self.eps[idx] = 1.0
        self.k[idx] = 0
        self.deadline[idx] = np.inf
        return len(idx)

    def _readout_finished(self, idx: np.ndarray) -> _Readback:
        """Readout of only the retiring rows, the gather padded to the next
        power of two (capped at the pool width) as the reference's readout
        cells are; starts the rows on their way to the host."""
        w = min(1 << (len(idx) - 1).bit_length(), self.sched.slots)
        pad = idx if w == len(idx) else np.concatenate(
            [idx, np.repeat(idx[:1], w - len(idx))])
        self._readout_widths.add(int(w))
        return _Readback(self.sched.model.readout(
            self._rows(self._xs_dev, pad), self._rows(self.z, pad)))

    def finalize_retired(self) -> List[InflightCompleted]:
        """Materialize staged completions — the only place readout rows
        reach the host. The overlap loop calls it after launching the
        next segments; the sync loop at once."""
        sched = self.sched
        done: List[InflightCompleted] = []
        self.flow_retired_last = 0
        for fb in self._staged_flow:
            outs = fb.outs.numpy()
            for j in range(fb.n):
                uid = int(fb.uid[j])
                attempts = int(fb.attempts[j])
                row = outs[j]
                if sched.fault_injector is not None:
                    row = sched.fault_injector.corrupt_flow_eval(
                        uid, attempts, row)
                if np.isfinite(row).all():
                    # flow_mask bars K_floor > 0, so attempts == 0 here
                    self.flow_retired_last += 1
                    sched._flow_tick += 1
                    sched.total_flow_served += 1
                    done.append(InflightCompleted(
                        uid=uid, outputs=row, K=0,
                        nfe=sched.nfe_flow + sched._nfe_extra.pop(uid, 0),
                        err_probe=float(fb.err[j]), fused_kernel=False,
                        t_submit=float(fb.t_submit[j]),
                        t_admit=fb.t_admit, t_done=fb.t_done,
                        segments=0, status="ok"))
                    continue
                if sched.retry.should_retry("diverged", attempts):
                    # escalation: bill the flow attempt, requeue at the
                    # FRONT of the queue (both loops admit it next) at the
                    # coarsest bucket
                    sched._nfe_extra[uid] = \
                        sched._nfe_extra.get(uid, 0) + sched.nfe_flow
                    sched._submit_t[uid] = float(fb.t_submit[j])
                    dl = float(fb.deadline[j])
                    sched._queue.appendleft(Request(
                        uid=uid, x=fb.xs[j].copy(),
                        deadline=dl if np.isfinite(dl) else None,
                        attempts=attempts + 1,
                        K_floor=min(sched.ecfg.buckets), escalated=True))
                    sched._esc_tick += 1
                    sched.total_escalated += 1
                    continue
                self.flow_retired_last += 1
                done.append(InflightCompleted(
                    uid=uid, outputs=row, K=0,
                    nfe=sched.nfe_flow + sched._nfe_extra.pop(uid, 0),
                    err_probe=float(fb.err[j]), fused_kernel=False,
                    t_submit=float(fb.t_submit[j]), t_admit=fb.t_admit,
                    t_done=fb.t_done, segments=0, status="diverged"))
        self._staged_flow = []
        for b in self._staged:
            outs = b.outs.numpy()
            for j in range(len(b.idx)):
                uid = int(b.uid[j])
                # nfe bills the depth steps actually taken plus every
                # failed attempt's probe and steps
                done.append(InflightCompleted(
                    uid=uid, outputs=outs[j], K=int(b.K[j]),
                    nfe=sched.probe_nfe + sched.stages * int(b.k_done[j])
                    + sched._nfe_extra.pop(uid, 0),
                    err_probe=float(b.err[j]), fused_kernel=b.fused,
                    t_submit=float(b.t_submit[j]),
                    t_admit=float(b.t_admit[j]), t_done=b.t_done,
                    segments=int(b.segments[j]), status=b.status[j]))
        self._staged = []
        return done

    def run_segment(self, now_done: float) -> Tuple[List[InflightCompleted],
                                                    _RetireStats]:
        """The synchronous segment: ``launch_segment`` + ``retire_pending``
        + ``finalize_retired`` with no lag (the overlap loop runs the same
        three one segment apart)."""
        self.launch_segment(now_done)
        stats = self.retire_pending()
        return self.finalize_retired(), stats


class InflightScheduler:
    """Continuous-batching serving loop: ``submit`` as traffic arrives,
    ``step()`` repeatedly; each step admits into free slots and advances
    every busy pool one segment. ``overlap=True`` swaps the synchronous
    tick for the pipelined one (segment N+1 launched before segment N's
    meta is read); completions, virtual stamps and totals are identical
    to the synchronous loop, the oracle it is pinned against.

    ``mesh`` (a ``launch/mesh.py::ServingMesh``) grows the pool past one
    device: ``slots`` is the global width, split row-wise into one
    sub-pool per mesh entry, and must be a multiple of the axis size.
    The model must live on the mesh's first device; another device gets
    a replica (``DepthModel.replicate``)."""

    def __init__(self, model: DepthModel,
                 engine_cfg: Optional[EngineConfig] = None,
                 *, slots: int = 4, seg: int = 2, mesh=None,
                 oracle=None, overlap: bool = False,
                 queue_cap: Optional[int] = None,
                 overload_policy: str = "shed",
                 deadline: Optional[float] = None,
                 retry: Optional[RetryPolicy] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 ledger=None):
        engine_cfg = engine_cfg or EngineConfig()
        if overload_policy not in ("shed", "degrade", "block"):
            raise ValueError(
                f"overload_policy={overload_policy!r}: expected 'shed' "
                "(refuse with status='shed'), 'degrade' (admit one "
                "bucket coarser under pressure), or 'block' (raise "
                "QueueFull; caller backs off)")
        if queue_cap is not None and queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {queue_cap} "
                             "(a zero-width queue can never admit)")
        model = prepare_model(model, engine_cfg)
        if seg < 1:
            raise ValueError(f"seg must be >= 1, got {seg}")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if mesh is not None:
            n = mesh.shape["data"]
            if slots % n:
                raise ValueError(
                    f"slots={slots} does not divide the 'data' mesh axis "
                    f"({n}); the pool shards row-wise — size slots as a "
                    "multiple of the axis (e.g. "
                    f"slots={n * max(1, slots // n)})")
        self.mesh = mesh
        self.model = model
        # the served model on every other device of the mesh (the first
        # device serves ``model`` itself), and the correction's params
        # per pool mesh (dropped at each hot_swap_g)
        self._replicas: Dict[torch.device, DepthModel] = {}
        self._g_replicas: Dict[ServingMesh, Tuple] = {}
        if mesh is not None:
            for d in mesh.devices[1:]:
                if d == mesh.devices[0] or d in self._replicas:
                    continue
                if model.replicate is None:
                    raise ValueError(
                        f"the mesh spans {d}, but the model cannot be "
                        "rebuilt there: give the DepthModel a replicate "
                        "(launch/engine.py lm_depth_model and "
                        "node_depth_model do)")
                if model.integ.g is not None:
                    raise ValueError(
                        "a closure correction (integ.g) binds its params "
                        "on one device; serve a mesh of several devices "
                        "with a parametric one (DepthModel g_apply/"
                        "g_params)")
                self._replicas[d] = prepare_model(model.replicate(d),
                                                  engine_cfg)
        self.ecfg = engine_cfg
        self.slots = int(slots)
        self.seg = int(seg)
        self.controller = make_controller(bound_integrator(model),
                                          engine_cfg)
        self.g_params = None if model.g_apply is None else model.g_params
        # the K=0 tier's swappable params and router (None when off)
        self.flow_params = None if model.flow_apply is None \
            else model.flow_params
        self.router = TierRouter(flow_threshold=engine_cfg.flow_threshold) \
            if engine_cfg.flow_threshold > 0 else None
        self.ledger = ledger   # optional ResidualLedger (launch/refinery)
        self.overlap = bool(overlap)
        self.oracle = oracle or SequentialEvalOracle()
        self.stages = model.integ.tableau.stages
        self.now = 0.0
        self.ticks = 0
        self.dispatches = 0
        self.total_cost = 0.0
        self.total_probe_cost = 0.0
        self.total_useful_steps = 0
        self.total_slot_steps = 0
        self.total_occupied_steps = 0
        self.total_quarantined = 0
        self.total_deadline_evicted = 0
        self.total_requeued = 0
        self.total_shed = 0
        self.total_flow_served = 0
        self.total_escalated = 0
        # per-tick flow accounting, accrued inside pool.admit / finalize
        self._flow_tick = 0
        self._esc_tick = 0
        self._flow_cost_tick = 0.0
        self.last_report = TickReport()
        self.queue_cap = None if queue_cap is None else int(queue_cap)
        self.overload_policy = overload_policy
        self.default_deadline = deadline  # relative slack, applied at submit
        self.retry = retry or RetryPolicy()
        self.fault_injector = fault_injector
        self._queue: deque = deque()
        self._submit_t: Dict[int, float] = {}
        self._uid = 0
        self._pools: Dict[Tuple, _SlotPool] = {}
        self._shed: List[InflightCompleted] = []   # terminal, pre-admission
        self._nfe_extra: Dict[int, int] = {}       # failed attempts' work

    # ----------------------------------------------------------- queue ----
    @property
    def probe_nfe(self) -> int:
        """Per-request probe cost net of the reused first stage."""
        return probe_net_nfe(self.controller)

    @property
    def nfe_flow(self) -> int:
        """NFE billed to a flow-tier completion: the probe's raw evals
        (the reused stage feeds the flow combine), zero solver steps."""
        return self.probe_nfe + 1

    def _g_args(self, mesh: ServingMesh) -> Tuple:
        """Trailing segment-call operand of a parametric correction, read
        at launch time: one params tree per sub-pool of a pool on
        ``mesh``, on its device (copied once per swap)."""
        if self.model.g_apply is None:
            return ()
        if mesh not in self._g_replicas:
            self._g_replicas[mesh] = mesh.replicas(self.g_params)
        return (self._g_replicas[mesh],)

    def hot_swap_g(self, gp):
        """Install new correction params between segments: every segment
        launched after this call (refills of old admissions included)
        runs the new g; under ``overlap`` the one segment in flight
        finishes on the params it was launched with. Returns the previous
        params, the refinery's rollback handle."""
        if self.model.g_apply is None:
            raise ValueError(
                "hot_swap_g on a non-parametric model: build the "
                "DepthModel with g_apply/g_params (params-are-inputs) "
                "to make the correction swappable")
        old, self.g_params = self.g_params, swap_params(self.g_params, gp,
                                                        "hot_swap_g")
        self._g_replicas = {}
        return old

    def hot_swap_flow(self, fp):
        """Install new flow-head params between ticks (``hot_swap_g``'s
        contract); the next admission's flow eval reads them. Returns the
        previous params."""
        if self.model.flow_apply is None:
            raise ValueError(
                "hot_swap_flow on a model without a flow head: build "
                "the DepthModel with flow_apply/flow_params to make the "
                "K=0 tier swappable")
        old, self.flow_params = self.flow_params, swap_params(
            self.flow_params, fp, "hot_swap_flow")
        return old

    def can_submit(self) -> bool:
        """False exactly when the next ``submit`` would raise QueueFull."""
        return not (self.queue_cap is not None
                    and self.overload_policy == "block"
                    and len(self._queue) >= self.queue_cap)

    def submit(self, x, t: Optional[float] = None,
               deadline: Optional[float] = None) -> int:
        """Queue a request arriving at ``t`` on the virtual clock (default
        now; a future ``t`` idle-jumps the clock, and is refused while
        work is pending). ``deadline`` is absolute (default ``t`` plus
        the scheduler's slack). Over a full bounded queue ``shed``
        returns a uid whose ``status="shed"`` record surfaces from the
        next ``step()``, ``block`` raises ``QueueFull``."""
        t = self.now if t is None else float(t)
        if t > self.now:
            if self.pending:
                raise ValueError(
                    f"submit at t={t} > now={self.now} with "
                    f"{self.pending} requests pending: advancing the "
                    "clock mid-flight would misattribute latency; "
                    "step() until now >= t, then submit")
            self.advance_to(t)
        if deadline is None and self.default_deadline is not None:
            deadline = t + float(self.default_deadline)
        at_cap = self.queue_cap is not None \
            and len(self._queue) >= self.queue_cap
        if at_cap and self.overload_policy == "block":
            raise QueueFull(
                f"admission queue at cap ({self.queue_cap}) under "
                "overload_policy='block'; back off and resubmit "
                "(can_submit() is the non-raising probe)")
        self._uid += 1
        if at_cap and self.overload_policy == "shed":
            self._shed.append(InflightCompleted(
                uid=self._uid, outputs=None, K=0, nfe=0, err_probe=0.0,
                fused_kernel=False, t_submit=t, t_admit=t, t_done=t,
                segments=0, status="shed"))
            return self._uid
        self._queue.append(Request(uid=self._uid, x=np.asarray(x),
                                   deadline=deadline))
        self._submit_t[self._uid] = t
        return self._uid

    def advance_to(self, t: float) -> None:
        """Idle-jump the virtual clock forward (never backward); refused
        while work is pending."""
        if float(t) > self.now and self.pending:
            raise ValueError(
                f"advance_to(t={t}) > now={self.now} with {self.pending} "
                "requests pending: the clock only idle-jumps; step() "
                "until now >= t instead")
        self.now = max(self.now, float(t))

    @property
    def pending(self) -> int:
        """Requests not yet surfaced: queued + in flight + shed records."""
        inflight = sum(int(p.occupied.sum()) for p in self._pools.values())
        return len(self._queue) + inflight + len(self._shed)

    def __len__(self) -> int:
        return len(self._queue)

    # ------------------------------------------------------------ tick ----
    def step(self) -> List[InflightCompleted]:
        """One scheduling round, synchronous or pipelined (``overlap``);
        both admit identical request-to-slot assignments and stamp
        identical virtual times."""
        with torch.no_grad():
            return self._step_overlap() if self.overlap \
                else self._step_sync()

    def _admit_tick(self) -> Tuple[float, int, Dict[Tuple, float],
                                   List[InflightCompleted], int]:
        """Refill free slots from the FIFO queue (probe on admission),
        shared by both ticks. Requests already past their deadline drop
        here, terminal, without a probe. Returns (probe cost, admitted,
        per-pool probe cost, dropped records, non-finite probe count)."""
        probe_cost = 0.0
        admitted = 0
        probe_nonfinite = 0
        pool_probe: Dict[Tuple, float] = {}
        dropped: List[InflightCompleted] = []
        # degrade pressure is measured once, at tick start
        degrade = (self.overload_policy == "degrade"
                   and self.queue_cap is not None
                   and len(self._queue) > self.queue_cap)
        if self._queue:
            batches: Dict[Tuple, List[Request]] = {}
            budget: Dict[Tuple, int] = {}
            leftover: deque = deque()
            while self._queue:
                r = self._queue.popleft()
                if r.deadline is not None and r.deadline < self.now:
                    dropped.append(InflightCompleted(
                        uid=r.uid, outputs=None, K=0,
                        nfe=self._nfe_extra.pop(r.uid, 0), err_probe=0.0,
                        fused_kernel=False,
                        t_submit=self._submit_t.pop(r.uid),
                        t_admit=self.now, t_done=self.now,
                        segments=0, status="deadline"))
                    continue
                # pools key on (shape, dtype): a request never casts into
                # another dtype's pool
                key = (r.x.shape, r.x.dtype.str)
                if key not in self._pools:
                    self._pools[key] = _SlotPool(self, r.x.shape,
                                                 r.x.dtype)
                if key not in budget:
                    budget[key] = len(self._pools[key].free)
                if budget[key] > 0:
                    budget[key] -= 1
                    batches.setdefault(key, []).append(r)
                else:
                    leftover.append(r)
            self._queue = leftover
            for key, batch in batches.items():
                # pools are concurrent cells: each probe starts at tick start
                pc, n_bad = self._pools[key].admit(
                    batch, self._submit_t, self.now, degrade=degrade)
                pool_probe[key] = pc
                probe_cost += pc
                probe_nonfinite += n_bad
                admitted += len(batch)
        return probe_cost, admitted, pool_probe, dropped, probe_nonfinite

    def _segment_cost(self, pool: _SlotPool) -> float:
        """One segment's virtual cost; a straggler fault is keyed on the
        dispatch sequence, which both loops share."""
        cost = self.oracle.segment_cost(pool.shape, self.seg, self.slots,
                                        self.stages)
        if self.fault_injector is not None:
            cost = self.fault_injector.inflate_segment_cost(
                self.dispatches, cost)
        self.dispatches += 1
        return cost

    def _finish_tick(self, *, cost, probe_cost, admitted, retired,
                     useful, total, occupied, quarantined=0,
                     deadline_evicted=0, requeued=0, shed=0,
                     probe_nonfinite=0, flow_served=0,
                     escalated=0) -> None:
        """Advance the virtual clock and the totals (both ticks)."""
        self.now += cost
        self.ticks += 1
        self.total_cost += cost
        self.total_probe_cost += probe_cost
        self.total_useful_steps += useful
        self.total_slot_steps += total
        self.total_occupied_steps += occupied
        self.total_quarantined += quarantined
        self.total_deadline_evicted += deadline_evicted
        self.total_requeued += requeued
        self.total_shed += shed
        self.last_report = TickReport(
            cost=cost, probe_cost=probe_cost, admitted=admitted,
            retired=retired, useful_steps=useful, total_steps=total,
            occupied_steps=occupied, quarantined=quarantined,
            deadline_evicted=deadline_evicted, requeued=requeued,
            shed=shed, probe_nonfinite=probe_nonfinite,
            flow_served=flow_served, escalated=escalated)

    def _step_sync(self) -> List[InflightCompleted]:
        """Admit, advance every busy pool one segment, retire. The clock
        advances by the tick's summed cost; completions are stamped at
        tick end with only their own pool's probe and segment cost."""
        done: List[InflightCompleted] = list(self._shed)
        shed = len(done)
        self._shed = []
        self._flow_tick = self._esc_tick = 0
        self._flow_cost_tick = 0.0
        probe_cost, admitted, pool_probe, dropped, probe_nonfinite = \
            self._admit_tick()
        done.extend(dropped)
        cost = probe_cost + self._flow_cost_tick
        useful = total = occupied = retired = 0
        quarantined = evicted = requeued = 0
        for key, pool in self._pools.items():
            if not pool.busy():
                continue
            seg_cost = self._segment_cost(pool)
            cost += seg_cost
            d, st = pool.run_segment(
                self.now + pool_probe.get(key, 0.0) + seg_cost)
            done.extend(d)
            retired += len(d)
            useful += st.useful
            total += self.slots * self.seg
            occupied += st.occupied * self.seg
            quarantined += st.quarantined
            evicted += st.deadline_evicted
            requeued += st.requeued
        # flow-only admissions leave their pool idle (flow rows hold no
        # slot), so no segment finalized them: drain them here
        for pool in self._pools.values():
            if pool._staged_flow:
                d = pool.finalize_retired()
                done.extend(d)
                retired += len(d)
        self._finish_tick(cost=cost, probe_cost=probe_cost,
                          admitted=admitted,
                          retired=retired + shed + len(dropped),
                          useful=useful, total=total, occupied=occupied,
                          quarantined=quarantined,
                          deadline_evicted=evicted + len(dropped),
                          requeued=requeued, shed=shed,
                          probe_nonfinite=probe_nonfinite,
                          flow_served=self._flow_tick,
                          escalated=self._esc_tick)
        return done

    def _step_overlap(self) -> List[InflightCompleted]:
        """The pipelined tick: (1) retire every pool's pending segment
        (launched last tick), (2) admit into the freed slots, (3) launch
        the next segment of every busy pool, (4) materialize the staged
        completions. A segment's step counts and retires land one tick
        later in ``TickReport``; per-request records and totals equal the
        synchronous loop's."""
        done: List[InflightCompleted] = list(self._shed)
        shed = len(done)
        self._shed = []
        self._flow_tick = self._esc_tick = 0
        self._flow_cost_tick = 0.0
        useful = total = occupied = retired = 0
        quarantined = evicted = requeued = 0
        for pool in self._pools.values():
            if pool._pending is not None:
                st = pool.retire_pending()
                retired += st.retired
                useful += st.useful
                total += self.slots * self.seg
                occupied += st.occupied * self.seg
                quarantined += st.quarantined
                evicted += st.deadline_evicted
                requeued += st.requeued
        probe_cost, admitted, pool_probe, dropped, probe_nonfinite = \
            self._admit_tick()
        done.extend(dropped)
        cost = probe_cost + self._flow_cost_tick
        for key, pool in self._pools.items():
            if not pool.busy():
                continue
            seg_cost = self._segment_cost(pool)
            cost += seg_cost
            pool.launch_segment(self.now + pool_probe.get(key, 0.0)
                                + seg_cost)
        for pool in self._pools.values():
            done.extend(pool.finalize_retired())
            # flow rows retire straight out of finalize
            retired += pool.flow_retired_last
        self._finish_tick(cost=cost, probe_cost=probe_cost,
                          admitted=admitted,
                          retired=retired + shed + len(dropped),
                          useful=useful, total=total, occupied=occupied,
                          quarantined=quarantined,
                          deadline_evicted=evicted + len(dropped),
                          requeued=requeued, shed=shed,
                          probe_nonfinite=probe_nonfinite,
                          flow_served=self._flow_tick,
                          escalated=self._esc_tick)
        return done

    # ----------------------------------------------------- convenience ----
    def run(self, xs) -> List[InflightCompleted]:
        """Submit a batch at the current instant and drive to completion;
        results in submission order."""
        uids = [self.submit(x) for x in np.asarray(xs)]
        results: Dict[int, InflightCompleted] = {}
        while self.pending:
            for c in self.step():
                results[c.uid] = c
        return [results[u] for u in uids]
