"""Typed serving protocol: ``Request`` in, ``Response`` out, ``EngineStats`` aside
(port of ``repro.serving.protocol``, copied rather than imported).

Peacock's backend inference servers (§3.2, Fig. 5A) sit between a query
front-end and the RT-LDA programs; the contract at that boundary is small and
worth making explicit instead of the ad-hoc result dicts the first
``BatchingServer`` returned:

  * ``Request`` — the token ids plus the two things the batcher needs to
    schedule it: when it arrived (engine clock) and how much deadline it has.
  * ``Response`` — P(k|d), the Eq.-5 topic features, and the *serving
    metadata* industrial callers act on: which shape bucket ran it, whether
    the tail of an over-long query was dropped (``truncated`` — never silent),
    measured latency, and whether its deadline was missed.
  * ``EngineStats`` — the counters a load balancer or autoscaler reads:
    QPS, p50/p99 latency, mean batch occupancy, deadline-miss rate.

Everything here is plain data (numpy, not tensors) so responses can cross
thread/process boundaries without touching the device runtime.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    """One query as the engine queues it.

    ``deadline_ms`` is total latency budget from arrival; ``None`` means
    best-effort (the engine still caps batching delay at its configured
    ``max_delay_ms``). ``arrival_s`` is on the engine's injectable clock.
    """

    tokens: np.ndarray          # [n] int32 word ids
    request_id: int
    arrival_s: float
    deadline_ms: Optional[float] = None

    @property
    def n_tokens(self) -> int:
        return int(self.tokens.shape[0])

    def deadline_s(self) -> Optional[float]:
        """Absolute completion deadline on the engine clock, if any."""
        if self.deadline_ms is None:
            return None
        return self.arrival_s + self.deadline_ms / 1e3


@dataclasses.dataclass
class Response:
    """Inference result + serving metadata for one request."""

    request_id: int
    pkd: np.ndarray             # [K] f32 — P(k|d), normalized
    feature_ids: np.ndarray     # [top_n] int32 — Eq.-5 word ids
    feature_weights: np.ndarray  # [top_n] f32 — Eq.-5 weights, descending
    bucket: int                 # padded query length the request ran at
    truncated: bool             # tokens beyond the largest bucket were dropped
    latency_ms: float           # arrival → completion, engine clock
    deadline_missed: bool       # latency_ms > deadline_ms (False if no deadline)
    model_version: Optional[int] = None  # version of the model that ran the
    # batch — every response in one flush carries the same value (the engine
    # reads its (model, version) reference exactly once per batch); a folded
    # long-query response whose chunks straddled a hot-swap carries None
    cached: bool = False        # served from the fleet's result cache (the
    # model_version is the version the cached entry was computed under — a
    # hit is only legal while that version is still live fleet-wide)
    attempts: int = 1           # engine submissions this response consumed:
    # 1 normally, 2 when the fleet hedged (predicted-miss or breaker probe)
    # or retried a failed attempt on a different replica
    hedged: bool = False        # a second attempt ran in parallel (hedge),
    # as opposed to sequentially after a failure (retry)

    def as_dict(self) -> dict:
        """Legacy ``BatchingServer.infer`` result-dict view."""
        return {
            "pkd": self.pkd,
            "feature_ids": self.feature_ids,
            "feature_weights": self.feature_weights,
            "truncated": self.truncated,
        }


@dataclasses.dataclass
class EngineStats:
    """Aggregate serving counters since engine start (windowed percentiles)."""

    submitted: int
    completed: int
    truncated: int
    deadline_missed: int
    qps: float                  # completed / wall seconds since start
    p50_ms: float               # over the recent-latency window
    p99_ms: float
    mean_batch_occupancy: float  # real rows / padded rows, recent flushes
    deadline_miss_rate: float   # missed / completed-with-deadline
    per_bucket: Dict[int, int]  # completed requests per shape bucket
    model_version: Optional[int] = None  # label of the live model (hot-swap)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["per_bucket"] = {str(k): v for k, v in self.per_bucket.items()}
        return d


@dataclasses.dataclass(frozen=True)
class ShedResponse:
    """Typed fast-reject: admission control refused the request.

    When the fleet's p99 slack goes negative, queueing one more request can
    only convert its deadline into a miss *and* push everyone behind it
    later — so the fleet resolves the future immediately with this instead.
    Callers distinguish it from a :class:`Response` by type (or the ``shed``
    marker after ``as_dict``) and should back off ``retry_after_ms``.
    """

    request_id: int
    reason: str                 # e.g. "p99-slack"
    p99_est_ms: float           # the estimate that tripped admission control
    deadline_ms: Optional[float]  # the request's budget (None = fleet default)
    retry_after_ms: float       # back-off hint: estimated time for slack > 0
    shed: bool = True

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class FleetStats:
    """Aggregate fleet counters: the autoscaler/dashboard view of N replicas
    plus the result cache and admission control."""

    submitted: int              # fleet-level requests (cached hits included)
    completed: int              # engine-served completions observed
    shed: int                   # fast-rejected by admission control
    cache_hits: int
    cache_misses: int           # submits that went to an engine (cacheable)
    qps: float                  # completed+hits / wall seconds
    p50_ms: float               # engine-served latency window (hits are ~0)
    p99_ms: float
    p99_est_ms: float           # admission control's live p99 estimate
    hit_rate: float             # hits / (hits + misses)
    shed_rate: float            # shed / submitted
    shedding: bool              # admission control currently rejecting
    model_version: Optional[int]  # fleet-wide live version (min over
    # replicas; None while any replica's version is unknown)
    routed: Tuple[int, ...]     # engine-served requests per replica
    per_replica: Tuple[EngineStats, ...]
    cache: Optional[dict] = None  # ResultCache.stats() when a cache is on
    failed: int = 0             # requests resolved with an exception (after
    # the bounded retry was exhausted or impossible)
    probes: int = 0             # fleet-synthesized shed probes (non-paying;
    # breaker recovery probes are paying requests hedged for safety and
    # are counted per-breaker in ``breakers[i]["probes"]``)
    hedges: int = 0             # requests that ran a parallel second attempt
    retries: int = 0            # failed attempts re-dispatched sequentially
    unhealthy_shed: int = 0     # sheds with every replica's breaker open
    breakers: Tuple[dict, ...] = ()  # CircuitBreaker.snapshot() per replica

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["routed"] = list(self.routed)
        d["per_replica"] = [s.as_dict() for s in self.per_replica]
        d["breakers"] = [dict(b) for b in self.breakers]
        return d


def percentiles(lat_ms, qs: Tuple[float, ...] = (0.5, 0.99)):
    """(p50, p99, ...) of a latency window; zeros when the window is empty."""
    if len(lat_ms) == 0:
        return tuple(0.0 for _ in qs)
    arr = np.asarray(lat_ms, np.float64)
    return tuple(float(np.quantile(arr, q)) for q in qs)
