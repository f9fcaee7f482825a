"""Replica health: the per-replica circuit breaker (DESIGN.md §14; port of
``repro.serving.health``, copied rather than imported).

A fleet replica whose ``infer_fn`` starts raising — device loss, a poisoned
hot-swap, a wedged runtime — fails every batch routed to it; a router that
keeps scoring it by queue depth alone will keep feeding it forever (its
queue drains instantly, by failing). The circuit breaker is the standard
fix, specialized for the fleet's determinism contract:

* **closed** — healthy. Every engine-reported failure (inference exception,
  or a deadline *blowout*: latency over ``blowout_factor ×`` the request's
  deadline — an ordinary miss under load is congestion, not sickness) bumps
  a consecutive-failure counter; any success resets it. At
  ``failure_threshold`` consecutive failures the breaker trips **open**.
* **open** — the router skips the replica, ``live_version()`` excludes it
  (a dead replica's stale version must not pin the fleet-wide min the
  result cache keys on), and nothing is routed to it until a backoff
  expires: ``backoff_ms · factor^(trips−1)`` capped at ``max_backoff_ms``,
  plus a deterministic jitter drawn from the seeded counter hash
  (``repro_torch.reliability.faults.counter_uniform``) so N replicas tripped by one
  cause don't re-probe in lockstep.
* **half-open** — the backoff expired; exactly ONE request is admitted as a
  recovery probe. Success closes the breaker (and resets the backoff
  ladder); failure re-opens it with the next-longer backoff. A probe whose
  completion never arrives (the replica wedged mid-batch) is timed out
  after ``probe_timeout_ms`` so the breaker can issue another instead of
  waiting forever on a dead future.

All transitions run on the injectable clock, so the fake-clock chaos tests
walk the state machine deterministically.

Concurrency contract (checked by the repo's concurrency analyzer): the whole
state machine lives under ``_lock``; every public method is one short
critical section with no calls out, so breakers can be consulted by
submitter threads while engine callback threads record outcomes.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from repro_torch.reliability.faults import counter_uniform

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Consecutive-failure circuit breaker with jittered-backoff recovery."""

    # submitters read (allow) while engine callback threads write
    # (record_success/record_failure) — every field is shared
    _GUARDED_BY = {
        "_state": "_lock", "_failures": "_lock", "_trips": "_lock",
        "_open_until": "_lock", "_probe_at": "_lock",
        "_n_failures": "_lock", "_n_successes": "_lock",
        "_n_probes": "_lock",
    }

    def __init__(self, *, failure_threshold: int = 3,
                 backoff_ms: float = 200.0,
                 backoff_factor: float = 2.0,
                 max_backoff_ms: float = 5000.0,
                 jitter: float = 0.2,
                 probe_timeout_ms: float = 2000.0,
                 blowout_factor: float = 3.0,
                 clock: Callable[[], float] = time.monotonic,
                 seed: int = 0):
        if failure_threshold <= 0:
            raise ValueError("failure_threshold must be > 0")
        if backoff_factor < 1.0:
            raise ValueError("backoff_factor must be >= 1")
        if not 0.0 <= jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        self.failure_threshold = int(failure_threshold)
        self.backoff_ms = float(backoff_ms)
        self.backoff_factor = float(backoff_factor)
        self.max_backoff_ms = float(max_backoff_ms)
        self.jitter = float(jitter)
        self.probe_timeout_ms = float(probe_timeout_ms)
        self.blowout_factor = float(blowout_factor)
        self.seed = int(seed)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0          # consecutive, while closed
        self._trips = 0             # lifetime open transitions (backoff rung)
        self._open_until = 0.0      # clock seconds; half-open eligible after
        self._probe_at: Optional[float] = None  # outstanding probe sent at
        self._n_failures = 0
        self._n_successes = 0
        self._n_probes = 0

    # ------------------------------------------------------------- queries --

    def state(self) -> str:
        """Current state, with the open→half-open clock edge applied (an
        expired backoff reads as half-open even before a probe is taken)."""
        with self._lock:
            if self._state == OPEN and self._clock() >= self._open_until:
                return HALF_OPEN
            return self._state

    def allow(self) -> bool:
        """May a request be routed to this replica right now?

        Closed: yes. Open: no, until the backoff expires — the expiry edge
        transitions to half-open and admits exactly one probe. Half-open:
        only if no probe is outstanding (or the last one timed out)."""
        with self._lock:
            now = self._clock()
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if now < self._open_until:
                    return False
                self._state = HALF_OPEN
                self._probe_at = now
                self._n_probes += 1
                return True
            # HALF_OPEN: one probe at a time; a probe whose outcome never
            # arrived (replica wedged mid-batch) times out and re-admits
            if self._probe_at is None or \
                    (now - self._probe_at) * 1e3 >= self.probe_timeout_ms:
                self._probe_at = now
                self._n_probes += 1
                return True
            return False

    # ------------------------------------------------------------ outcomes --

    def record_success(self) -> None:
        with self._lock:
            self._n_successes += 1
            self._failures = 0
            if self._state != CLOSED:
                # recovery proven (the half-open probe, or a straggler
                # success from before the trip): close and reset the ladder
                self._state = CLOSED
                self._trips = 0
                self._probe_at = None

    def record_failure(self) -> None:
        with self._lock:
            self._n_failures += 1
            now = self._clock()
            if self._state == CLOSED:
                self._failures += 1
                if self._failures >= self.failure_threshold:
                    self._trip(now)
            elif self._state == HALF_OPEN:
                self._trip(now)     # probe failed: next rung of the ladder
            # OPEN: late failures from requests admitted pre-trip carry no
            # new information — the backoff clock keeps running

    def record_response(self, latency_ms: float,
                        deadline_ms: Optional[float]) -> None:
        """Classify a completed response: a deadline *blowout* (latency over
        ``blowout_factor×`` the deadline) counts as a failure — the replica
        is sick, not merely congested; anything else is a success."""
        if deadline_ms is not None and \
                latency_ms > self.blowout_factor * deadline_ms:
            self.record_failure()
        else:
            self.record_success()

    # ------------------------------------------------------------ plumbing --

    def _trip(self, now: float) -> None:  # requires: _lock
        self._trips += 1
        self._state = OPEN
        self._failures = 0
        self._probe_at = None
        rung = min(self._trips - 1, 30)   # cap the exponent, not just the ms
        backoff = min(self.backoff_ms * self.backoff_factor ** rung,
                      self.max_backoff_ms)
        backoff *= 1.0 + self.jitter * counter_uniform(self.seed,
                                                       self._trips)
        self._open_until = now + backoff / 1e3

    def snapshot(self) -> dict:
        """Stats view (``FleetStats.breakers``)."""
        with self._lock:
            state = self._state
            if state == OPEN and self._clock() >= self._open_until:
                state = HALF_OPEN
            return {
                "state": state,
                "trips": self._trips,
                "failures": self._n_failures,
                "successes": self._n_successes,
                "probes": self._n_probes,
                "reopen_at": self._open_until,   # clock s; 0.0 if never open
            }
