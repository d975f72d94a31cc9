"""Serving retry policy — the ``RetryPolicy`` of ``repro/distributed/fault.py``.

A request whose solve diverged is retried at most ``max_retries`` times
(at the next-finer mesh bucket) before the caller gets the best-effort
answer. The fault injector and the training watchdog wait for the
in-flight scheduler slice (ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded per-request retry ladder for the serving loops."""

    max_retries: int = 1
    retry_statuses: Tuple[str, ...] = ("diverged",)

    def should_retry(self, status: str, attempts: int) -> bool:
        return status in self.retry_statuses and attempts < self.max_retries
