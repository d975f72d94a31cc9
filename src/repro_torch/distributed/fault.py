"""Serving fault tolerance — the ``RetryPolicy`` and ``FaultInjector`` of
``repro/distributed/fault.py``.

A request whose solve diverged is retried at most ``max_retries`` times
(at the next-finer mesh bucket) before the caller gets the best-effort
answer. ``FaultInjector`` is the seeded serving-chaos source: every
decision is a pure function of its keys through ``_hash01`` (the
reference's blake2b of the key tuple's ``repr``), so the sync and overlap
loops — and the reference's loops, given the same seed — draw the same
fault schedule. The training watchdog and ``FailureInjector`` wait for
ROADMAP.md queue 1 item 12.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Tuple

import numpy as np


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
