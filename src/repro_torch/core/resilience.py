"""Retry and circuit-breaking primitives for the distributed data plane.

DESIGN.md §12.  The peer transport in :mod:`repro_torch.core.dstore` fails the
way real cluster fabrics fail — slow peers, dropped connections, hosts
that die between a lease read and the send — and a single socket error
must not surface to the client stack when the shared PFS tier still
holds a durable copy.  Two small, dependency-free pieces:

* :class:`RetryPolicy` — bounded exponential backoff with deterministic
  (seedable) jitter and a per-request deadline.  Idempotency-awareness
  lives in the *caller*: reads retry freely; forwarded puts re-resolve
  the owner lease before every retry so fencing still rejects
  double-owners (the policy only shapes the schedule).
* :class:`CircuitBreaker` — per-peer failure accounting.  After
  ``failure_threshold`` consecutive failures the circuit opens and
  requests short-circuit (the caller degrades: reads fall back to the
  ``PFS_BYPASS`` cold path, writes re-resolve toward
  claim-or-next-live-owner) instead of stacking timeouts on a dead
  socket.  After ``reset_s`` one half-open probe is admitted; success
  closes the circuit, failure re-opens it.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable

__all__ = ["RetryPolicy", "CircuitBreaker", "CircuitOpen"]


class CircuitOpen(Exception):
    """A request was refused without touching the wire: the peer's
    circuit breaker is open (or its half-open probe slot is taken)."""


@dataclasses.dataclass
class RetryPolicy:
    """Bounded exponential backoff + jitter + deadline.

    ``backoff(attempt)`` (1-based failure count) returns the next sleep;
    ``run(fn)`` drives the loop for simple callables.  Jitter comes from
    a seeded RNG so test schedules replay exactly.
    """

    max_attempts: int = 4
    base_delay_s: float = 0.02
    max_delay_s: float = 0.5
    multiplier: float = 2.0
    jitter: float = 0.5  # ± fraction of the computed delay
    deadline_s: float = 4.0
    seed: int | None = None

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()

    def backoff(self, attempt: int) -> float:
        base = min(self.max_delay_s, self.base_delay_s * self.multiplier ** max(0, attempt - 1))
        if not self.jitter:
            return base
        with self._lock:
            j = self._rng.uniform(-self.jitter, self.jitter)
        return max(0.0, base * (1.0 + j))

    def give_up(self, attempt: int, t0: float, next_delay: float = 0.0) -> bool:
        """True when the schedule is exhausted: attempts spent, or the
        next retry would land past the deadline."""
        if attempt >= self.max_attempts:
            return True
        return time.monotonic() - t0 + next_delay > self.deadline_s

    def run(
        self,
        fn: Callable[[int], object],
        retry_on: tuple = (Exception,),
        on_retry: Callable[[int, BaseException], None] | None = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        """Call ``fn(attempt_index)`` until it returns, retrying on
        ``retry_on`` within the attempt/deadline budget."""
        t0 = time.monotonic()
        attempt = 0
        while True:
            try:
                return fn(attempt)
            except retry_on as exc:
                attempt += 1
                delay = self.backoff(attempt)
                if self.give_up(attempt, t0, delay):
                    raise
                if on_retry is not None:
                    on_retry(attempt, exc)
                sleep(delay)


class CircuitBreaker:
    """Per-peer three-state breaker: closed → open → half-open.

    ``allow()`` answers "may this request touch the wire?"; callers
    report outcomes via ``record_success``/``record_failure``.  While
    open, everything short-circuits until ``reset_s`` has elapsed; then
    exactly one probe is admitted at a time (half-open) — its success
    closes the circuit, its failure re-opens the full window.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(
        self,
        failure_threshold: int = 3,
        reset_s: float = 2.0,
        name: str = "",
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.reset_s = reset_s
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self.opened_count = 0  # lifetime open transitions (stats)

    @property
    def state(self) -> str:
        with self._lock:
            if self._state == self.OPEN and self._clock() - self._opened_at >= self.reset_s:
                return self.HALF_OPEN
            return self._state

    def allow(self) -> bool:
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() - self._opened_at < self.reset_s:
                    return False
                self._state = self.HALF_OPEN
                self._probing = True
                return True
            # HALF_OPEN: one probe in flight at a time
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._state = self.CLOSED
            self._failures = 0
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._probing = False
            self._failures += 1
            trip = self._state == self.HALF_OPEN or self._failures >= self.failure_threshold
            if trip and self._state != self.OPEN:
                self.opened_count += 1
            if trip:
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._failures = 0
