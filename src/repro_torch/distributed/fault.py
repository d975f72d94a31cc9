"""Fault tolerance — the port of ``repro/distributed/fault.py``: the
training watchdog and failure injection (``StepFailure``,
``WatchdogConfig``, ``StepWatchdog``, ``FailureInjector``; reference
lines 38–100 and 224–234) and the serving side (``RetryPolicy``,
``FaultInjector``).

``StepWatchdog.run`` guards a training step (``launch/train.py``): a
walltime deadline, the NaN screen and the restart budget. A request
whose solve diverged is retried at most ``max_retries`` times
(at the next-finer mesh bucket) before the caller gets the best-effort
answer. ``FaultInjector`` is the seeded serving-chaos source: every
decision is a pure function of its keys through ``_hash01`` (the
reference's blake2b of the key tuple's ``repr``), so the sync and overlap
loops — and the reference's loops, given the same seed — draw the same
fault schedule.
"""
from __future__ import annotations

import dataclasses
import hashlib
import logging
import math
import time
from typing import Callable, Optional, Tuple

import numpy as np

log = logging.getLogger("repro_torch.fault")


class StepFailure(RuntimeError):
    """A training step failed (device loss, NaN blow-up, injected fault)."""


@dataclasses.dataclass
class WatchdogConfig:
    step_deadline_s: float = 600.0     # straggler threshold
    max_restarts: int = 3              # per incident window
    nan_is_failure: bool = True
    # close the incident window on the first clean step after a failure:
    # the budget then bounds consecutive failures instead of the run's
    # total (the default, which the reference's tests pin)
    reset_on_success: bool = False


class StepWatchdog:
    """Wraps step execution: walltime deadline, NaN screen and restart
    accounting.

    ``run(fn, *args, loss_of=...)`` times the call, warns past the
    deadline, then screens ``loss_of(out)``: when ``cfg.nan_is_failure``
    and it is not finite, ``StepFailure`` is raised here. The order is the
    reference's (time the call, then screen). On a CUDA device the call
    only enqueues work, so the time recorded in ``step_times`` is the
    host's dispatch of the step (and any sync the step itself makes, such
    as a host read inside it); the screen's ``float(loss)`` is the step's
    first full sync and falls outside the timed span. A caller that wants
    the synced step time syncs before and after ``run`` itself."""

    def __init__(self, cfg: WatchdogConfig):
        self.cfg = cfg
        self.restarts = 0
        self.step_times: list = []

    def run(self, fn: Callable, *args, loss_of: Optional[Callable] = None):
        t0 = time.time()
        out = fn(*args)
        dt = time.time() - t0
        self.step_times.append(dt)
        if dt > self.cfg.step_deadline_s:
            log.warning("step exceeded deadline: %.1fs > %.1fs (straggler?)",
                        dt, self.cfg.step_deadline_s)
        if loss_of is not None and self.cfg.nan_is_failure:
            loss = float(loss_of(out))
            if not math.isfinite(loss):
                raise StepFailure(f"non-finite loss: {loss}")
        if self.cfg.reset_on_success and self.restarts:
            log.info("clean step after %d restart(s): incident window "
                     "closed", self.restarts)
            self.restarts = 0
        return out

    def record_failure(self) -> bool:
        """Spends one restart; True if the budget allows it."""
        self.restarts += 1
        if self.restarts > self.cfg.max_restarts:
            log.error("restart budget exhausted (%d)", self.restarts)
            return False
        log.warning("restart %d/%d", self.restarts, self.cfg.max_restarts)
        return True


class FailureInjector:
    """Deterministic failure injection for tests: raise at given steps,
    once each."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise StepFailure(f"injected failure at step {step}")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded per-request retry ladder for the serving loops. Deadline
    evictions are not retried unless ``"deadline"`` is added to
    ``retry_statuses``."""

    max_retries: int = 1
    retry_statuses: Tuple[str, ...] = ("diverged",)

    def should_retry(self, status: str, attempts: int) -> bool:
        return status in self.retry_statuses and attempts < self.max_retries


def _hash01(*keys) -> float:
    """Deterministic [0, 1) hash of the key tuple, stable across processes
    and call order: blake2b (8 bytes) of ``repr(keys)``, the reference's
    function bit for bit."""
    digest = hashlib.blake2b(repr(keys).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big") / 2.0 ** 64


@dataclasses.dataclass
class FaultInjector:
    """Seeded serving-chaos source with four host-side fault sites:

      * ``corrupt_admission`` — NaN-poison the inputs of a fraction of
        uids at admission (only attempt 0 when ``nan_transient``), so
        their solve diverges and the quarantine flag retires them;
      * ``drop_retire_flags`` — lose a finished flag with probability
        ``drop_flag_p`` per (uid, segment count); re-drawn next segment,
        so every request still terminates for ``p < 1``;
      * ``inflate_segment_cost`` — multiply a fraction of dispatched
        segments' virtual cost by ``straggle_factor``, keyed on the
        scheduler's dispatch sequence (identical in both loops);
      * ``corrupt_flow_eval`` — NaN-poison the K=0 flow-tier output row
        of a fraction ``flow_nan_frac`` of uids (only attempt 0 when
        ``nan_transient``), so the loops escalate them into the K-bucket
        ladder (terminal ``escalated``).
    """

    seed: int = 0
    nan_uid_frac: float = 0.0
    nan_transient: bool = True
    drop_flag_p: float = 0.0
    straggle_tick_frac: float = 0.0
    straggle_factor: float = 4.0
    flow_nan_frac: float = 0.0

    def corrupt_admission(self, uid: int, attempts: int,
                          x: np.ndarray) -> np.ndarray:
        if self.nan_uid_frac <= 0.0:
            return x
        if self.nan_transient and attempts > 0:
            return x
        if _hash01(self.seed, "nan", int(uid)) < self.nan_uid_frac:
            x = np.array(x, copy=True)
            x.reshape(-1)[0] = np.nan
        return x

    def corrupt_flow_eval(self, uid: int, attempts: int,
                          out_row: np.ndarray) -> np.ndarray:
        if self.flow_nan_frac <= 0.0:
            return out_row
        if self.nan_transient and attempts > 0:
            return out_row
        if _hash01(self.seed, "flow", int(uid)) < self.flow_nan_frac:
            out_row = np.array(out_row, copy=True)
            out_row.reshape(-1)[0] = np.nan
        return out_row

    def drop_retire_flags(self, uids: np.ndarray, segments: np.ndarray,
                          finished: np.ndarray) -> np.ndarray:
        if self.drop_flag_p <= 0.0:
            return finished
        out = finished.copy()
        for i in np.flatnonzero(finished):
            if _hash01(self.seed, "flag", int(uids[i]),
                       int(segments[i])) < self.drop_flag_p:
                out[i] = False
        return out

    def inflate_segment_cost(self, seq: int, cost: float) -> float:
        if self.straggle_tick_frac <= 0.0:
            return cost
        if _hash01(self.seed, "straggle", int(seq)) \
                < self.straggle_tick_frac:
            return cost * self.straggle_factor
        return cost
