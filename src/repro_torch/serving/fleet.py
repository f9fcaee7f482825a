"""``TopicFleet`` — routed, cached, load-shedding, self-healing serving (port
of ``repro.serving.fleet``).

Peacock serves hundreds of millions of users from fleets of backend
inference servers (§3.2, Fig. 5A); one :class:`TopicEngine` behind one
:class:`SnapshotWatcher` is a single replica of that story. The fleet front
owns N engine replicas and exposes the *same* ``submit(tokens, deadline_ms)
-> Future`` surface as one engine, with four mechanisms between the caller
and the devices:

* **Routing** — occupancy- and deadline-aware replica selection, not
  round-robin, over a **cached routing view**: per-replica (queue depth,
  EWMA service estimate) snapshots refreshed on completions (each completion
  re-reads its replica's :meth:`TopicEngine.route_state`), bumped
  optimistically on every dispatch, and re-read on a staleness TTL — so a
  submit costs O(1) lock hops, not one ``route_state`` (engine-lock hop)
  per replica per request. The router scores every replica's *predicted
  completion* for the request's shape bucket — full batches already queued
  ahead cost whole service quanta, a forming partial batch is a discount —
  and picks the minimum, deterministically (lowest index wins ties).
* **Admission control / load shedding** — the fleet tracks a live p99
  estimate over engine-served completions. When p99 slack (deadline budget −
  p99 estimate) goes negative the fleet flips to *shedding* and resolves
  new submissions immediately with a typed :class:`ShedResponse` instead of
  queueing them into guaranteed misses. Hysteresis prevents flap, and every
  ``probe_every``-th shed triggers a fleet-synthesized **probe** submission
  (explicitly non-paying — a duplicate of the rejected tokens, counted in
  ``FleetStats.probes``, never cached, never user-visible) so the estimate
  can observe recovery without ever using paying traffic as the guinea pig.
* **Self-healing** (DESIGN.md §14) — one :class:`CircuitBreaker` per
  replica classifies completions (exceptions and deadline *blowouts* are
  failures); a tripped replica is skipped by the router and excluded from
  the ``live_version()`` min (a dead replica's stale version must not pin
  the cache's notion of "live"). After a jittered exponential backoff the
  breaker admits exactly one request as a recovery probe — and the fleet
  hedges that request to the best healthy replica in parallel, so paying
  traffic is never sacrificed to probe a suspect replica. A **failed
  attempt gets one bounded retry** on a different healthy replica within
  the remaining deadline budget; a **predicted-miss** primary gets one
  parallel hedge. Either way at most 2 engine submissions per request,
  stamped on ``Response.attempts``/``hedged``. All replicas open → typed
  ``ShedResponse(reason="unhealthy")``.
* **Hot-query result cache** — query traffic is power-law, so a
  :class:`ResultCache` (segmented LRU, byte-budgeted) serves the repeating
  head while the engines batch the long tail. Entries are keyed on
  ``(token bytes, bucket)`` and version-tagged: a hit is only legal while
  the entry's ``model_version`` equals the *fleet-wide live version*, so a
  cached result can never cross a snapshot hot-swap.

Snapshot fan-out: :meth:`attach_watchers` gives every replica its own
:class:`SnapshotWatcher` on the shared snapshot directory, so a publish
rolls across the fleet within one poll interval with zero dropped requests;
the watcher's ``on_swap`` hook eagerly drops newly-stale cache entries.

Concurrency contract (checked by the repo's concurrency analyzer): all fleet
counters, the shed state machine, the routing view and the health map live
under ``_lock``; the fleet never holds ``_lock`` while calling into an
engine, a watcher, a breaker or the cache (each has its own lock — no
nesting, no fleet edge in the lock-order graph), and completion bookkeeping
runs in the engines' callback threads through the same guarded paths as
submitters. Per-request attempt state lives in a small per-submission dict
with its own lock (innermost, no calls out while held).
"""
from __future__ import annotations

import collections
import functools
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import features
from repro_torch.core.rtlda import DEFAULT_BUCKETS, RTLDAModel, select_bucket
from repro_torch.serving import health
from repro_torch.serving.cache import ResultCache
from repro_torch.serving.engine import TopicEngine
from repro_torch.serving.health import CircuitBreaker
from repro_torch.serving.protocol import (FleetStats, Response, ShedResponse,
                                          percentiles)
from repro_torch.serving.watcher import SnapshotWatcher

_LAT_WINDOW = 2048    # fleet-level latency window (p50/p99 + shed estimate)
_P99_EVERY = 32       # recompute the shed p99 estimate every N completions
_MAX_ATTEMPTS = 2     # per request: primary + (one hedge OR one retry)
_MISS_PENALTY = 1e6   # score marker: predicted past the deadline


class TopicFleet:
    """N ``TopicEngine`` replicas behind one ``submit`` — routing, admission
    control, circuit breakers, hedged retries and a hot-query cache."""

    # concurrency contract: every mutable fleet field is written from both
    # submitter threads and the engines' completion-callback threads
    _GUARDED_BY = {
        "_n_submitted": "_lock", "_n_completed": "_lock",
        "_n_failed": "_lock", "_n_shed": "_lock",
        "_n_cache_hits": "_lock", "_n_cache_misses": "_lock",
        "_n_hedges": "_lock", "_n_retries": "_lock", "_n_probes": "_lock",
        "_n_unhealthy_shed": "_lock",
        "_lat_ms": "_lock", "_p99_est_ms": "_lock", "_shedding": "_lock",
        "_since_probe": "_lock", "_since_p99": "_lock",
        "_routed": "_lock", "_next_id": "_lock", "_t0": "_lock",
        "_closed": "_lock",
        "_view": "_lock", "_view_at": "_lock", "_unhealthy": "_lock",
    }

    def __init__(self, model: Optional[RTLDAModel] = None,
                 n_replicas: int = 4, *,
                 engines: Optional[Sequence[TopicEngine]] = None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_batch: int = 256,
                 n_iters: int = 5, n_trials: int = 2, top_n: int = 30,
                 max_delay_ms: float = 5.0,
                 service_estimate_ms: float = 2.0,
                 cache_mb: float = 64.0,
                 cache: Optional[ResultCache] = None,
                 shed: bool = True,
                 deadline_budget_ms: float = 50.0,
                 shed_hysteresis: float = 0.25,
                 probe_every: int = 8,
                 hedge: bool = True,
                 view_ttl_ms: float = 250.0,
                 breaker_threshold: int = 3,
                 breaker_backoff_ms: float = 200.0,
                 breaker_max_backoff_ms: float = 5000.0,
                 blowout_factor: float = 3.0,
                 probe_timeout_ms: float = 2000.0,
                 seed: int = 0,
                 clock=time.monotonic,
                 start: bool = True):
        if engines is not None:
            if not engines:
                raise ValueError("need at least one engine replica")
            self.engines: Tuple[TopicEngine, ...] = tuple(engines)
        else:
            if model is None:
                raise ValueError("TopicFleet needs a model or engines=")
            if n_replicas <= 0:
                raise ValueError("n_replicas must be > 0")
            # ONE shared serving function and ONE model object: the fleet
            # holds one copy of P̂ (13.1 GB at K = 10⁵, V = 32,768) on the
            # model's device, whatever the replica count
            infer_fn = features.make_serving_fn(
                n_iters=n_iters, n_trials=n_trials, top_n=top_n,
                device=model.pvk.device)
            self.engines = tuple(
                TopicEngine(model, buckets=buckets, max_batch=max_batch,
                            max_delay_ms=max_delay_ms,
                            service_estimate_ms=service_estimate_ms,
                            infer_fn=infer_fn, clock=clock,
                            name=f"replica{i}", start=start)
                for i in range(n_replicas))
        self.buckets = self.engines[0].buckets
        self.max_batch = self.engines[0].max_batch
        self.shed = bool(shed)
        self.hedge = bool(hedge)
        self.view_ttl_ms = float(view_ttl_ms)
        self.deadline_budget_ms = float(deadline_budget_ms)
        if not 0.0 < shed_hysteresis < 1.0:
            raise ValueError("shed_hysteresis must be in (0, 1)")
        self.shed_hysteresis = float(shed_hysteresis)
        self.probe_every = max(2, int(probe_every))
        if cache is not None:
            self.cache: Optional[ResultCache] = cache
        else:
            self.cache = ResultCache(capacity_mb=cache_mb) \
                if cache_mb > 0 else None
        self._clock = clock
        self._watchers: List[SnapshotWatcher] = []
        # one breaker per replica; decorrelated jitter seeds so replicas
        # tripped by one cause don't re-probe in lockstep
        self.breakers: Tuple[CircuitBreaker, ...] = tuple(
            CircuitBreaker(failure_threshold=breaker_threshold,
                           backoff_ms=breaker_backoff_ms,
                           max_backoff_ms=breaker_max_backoff_ms,
                           blowout_factor=blowout_factor,
                           probe_timeout_ms=probe_timeout_ms,
                           clock=clock, seed=seed * 1009 + i)
            for i in range(len(self.engines)))

        self._lock = threading.Lock()
        self._t0 = clock()
        self._next_id = 0
        self._n_submitted = 0
        self._n_completed = 0
        self._n_failed = 0
        self._n_shed = 0
        self._n_cache_hits = 0
        self._n_cache_misses = 0
        self._n_hedges = 0
        self._n_retries = 0
        self._n_probes = 0
        self._n_unhealthy_shed = 0
        self._lat_ms = collections.deque(maxlen=_LAT_WINDOW)
        self._p99_est_ms = 0.0
        self._since_p99 = 0
        self._shedding = False
        self._since_probe = 0
        self._routed = [0] * len(self.engines)
        self._closed = False
        # cached routing view: per-replica {bucket: (qlen, est_ms)} + the
        # clock time it was read; refreshed on completions / TTL, bumped
        # optimistically on dispatch (submit never takes an engine lock
        # just to score replicas)
        self._view: List[Dict[int, Tuple[int, float]]] = [
            dict(eng.route_state()) for eng in self.engines]
        self._view_at: List[float] = [clock()] * len(self.engines)
        # replica -> breaker reopen time (clock s); presence = skip in
        # routing and exclude from the live_version() min
        self._unhealthy: Dict[int, float] = {}

    # ----------------------------------------------------------------- API

    def submit(self, tokens, deadline_ms: Optional[float] = None) -> Future:
        """Same contract as ``TopicEngine.submit``: resolves to a
        :class:`Response` — or, when admission control is shedding (or every
        healthy replica's breaker is open), to a :class:`ShedResponse`
        immediately (reject-fast, never queue-to-miss).
        """
        toks = np.asarray(tokens, np.int32).reshape(-1)
        now = self._clock()
        bucket, _ = select_bucket(len(toks), self.buckets)
        # over-widest queries are chunk-folded by the engine and may blend
        # model versions across a swap — they bypass the cache entirely
        cacheable = self.cache is not None and len(toks) <= self.buckets[-1]
        key = (toks.tobytes(), bucket) if cacheable else None
        live = self.live_version()

        if key is not None:
            entry = self.cache.get(key, live)
            if entry is not None:
                with self._lock:
                    if self._closed:
                        raise RuntimeError("TopicFleet is closed")
                    self._n_submitted += 1
                    self._n_cache_hits += 1
                    rid = self._next_id
                    self._next_id += 1
                fut: Future = Future()
                fut.set_result(Response(
                    request_id=rid, pkd=entry.pkd,
                    feature_ids=entry.feature_ids,
                    feature_weights=entry.feature_weights,
                    bucket=bucket, truncated=False,
                    latency_ms=(self._clock() - now) * 1e3,
                    deadline_missed=False,
                    model_version=entry.version, cached=True))
                return fut

        budget = deadline_ms if deadline_ms is not None \
            else self.deadline_budget_ms
        with self._lock:
            if self._closed:
                raise RuntimeError("TopicFleet is closed")
            self._n_submitted += 1
            if key is not None:
                self._n_cache_misses += 1
            rid = self._next_id
            self._next_id += 1
            shed_now = spawn_probe = False
            if self.shed and self._shedding:
                # shed EVERY paying request while shedding; recovery is
                # observed through synthesized probes (every probe_every-th
                # shed), never by sacrificing a paying request
                shed_now = True
                self._since_probe += 1
                spawn_probe = self._since_probe % self.probe_every == 0
            if shed_now:
                self._n_shed += 1
                p99 = self._p99_est_ms
        if shed_now:
            if spawn_probe:
                self._spawn_probe(toks, bucket)
            fut = Future()
            fut.set_result(ShedResponse(
                request_id=rid, reason="p99-slack", p99_est_ms=p99,
                deadline_ms=deadline_ms,
                retry_after_ms=max(0.0, p99 - budget)))
            return fut

        routed = self._route(bucket, deadline_ms, now)
        if routed is None:
            # every replica's breaker is open: reject-fast with the time
            # until the soonest breaker re-probes as the back-off hint
            with self._lock:
                self._n_shed += 1
                self._n_unhealthy_shed += 1
                p99 = self._p99_est_ms
                reopen = min(self._unhealthy.values(), default=now)
            fut = Future()
            fut.set_result(ShedResponse(
                request_id=rid, reason="unhealthy", p99_est_ms=p99,
                deadline_ms=deadline_ms,
                retry_after_ms=max(0.0, (reopen - now) * 1e3)))
            return fut

        primary, hedge_idx = routed
        outer: Future = Future()
        ctx = {
            "lock": threading.Lock(), "outer": outer, "key": key,
            "toks": toks, "bucket": bucket, "deadline_ms": deadline_ms,
            "arrival": now, "tried": [primary], "attempts": 1,
            "pending": 1, "resolved": False, "hedged": False,
        }
        if hedge_idx is not None:
            with ctx["lock"]:
                ctx["attempts"] = 2
                ctx["pending"] = 2
                ctx["tried"].append(hedge_idx)
                ctx["hedged"] = True
            with self._lock:
                self._n_hedges += 1
        self._dispatch(ctx, primary)
        if hedge_idx is not None:
            self._dispatch(ctx, hedge_idx)
        return outer

    def infer(self, requests: Sequence,
              deadline_ms: Optional[float] = None) -> List[Response]:
        """Sync convenience: submit all, drain every replica, return in
        order (mirrors ``TopicEngine.infer``). Flushes once per possible
        attempt: a failed attempt's retry lands after the first drain."""
        futs = [self.submit(r, deadline_ms) for r in requests]
        for _ in range(_MAX_ATTEMPTS + 1):
            self.flush_all()
            if all(f.done() for f in futs):
                break
        return [f.result() for f in futs]

    def swap_model(self, model: RTLDAModel, version=None) -> None:
        """Broadcast a new model to every replica (manual path; production
        uses :meth:`attach_watchers`). The cache drops stale entries once
        the fleet-wide version converges."""
        for eng in self.engines:
            eng.swap_model(model, version=version)
        live = self.live_version()
        if self.cache is not None and live is not None:
            self.cache.drop_stale(live)

    def attach_watchers(self, snapshot_dir: str, poll_s: float = 0.5,
                        start: bool = True) -> List[SnapshotWatcher]:
        """Per-replica snapshot fan-out: one ``SnapshotWatcher`` per engine
        on the shared snapshot dir. Returns the watchers (also kept for
        :meth:`close`)."""
        ws = []
        for eng in self.engines:
            w = SnapshotWatcher(snapshot_dir, eng, poll_s=poll_s,
                                on_swap=self._on_swap)
            if start:
                w.start()
            ws.append(w)
        self._watchers.extend(ws)
        return ws

    def wait_for_version(self, version: int, timeout_s: float = 30.0) -> bool:
        """Block until every replica's watcher has ``version`` (or newer)."""
        return all(w.wait_for_version(version, timeout_s)
                   for w in self._watchers)

    def stats(self) -> FleetStats:
        per = tuple(eng.stats() for eng in self.engines)   # outside _lock
        cache_stats = self.cache.stats() if self.cache is not None else None
        breakers = tuple(b.snapshot() for b in self.breakers)
        live = self.live_version()
        with self._lock:
            now = self._clock()
            p50, p99 = percentiles(self._lat_ms)
            elapsed = max(now - self._t0, 1e-9)
            served = self._n_completed + self._n_cache_hits
            lookups = self._n_cache_hits + self._n_cache_misses
            return FleetStats(
                submitted=self._n_submitted,
                completed=self._n_completed,
                shed=self._n_shed,
                cache_hits=self._n_cache_hits,
                cache_misses=self._n_cache_misses,
                qps=served / elapsed,
                p50_ms=p50, p99_ms=p99,
                p99_est_ms=self._p99_est_ms,
                hit_rate=self._n_cache_hits / lookups if lookups else 0.0,
                shed_rate=(self._n_shed / self._n_submitted
                           if self._n_submitted else 0.0),
                shedding=self._shedding,
                model_version=live,
                routed=tuple(self._routed),
                per_replica=per,
                cache=cache_stats,
                failed=self._n_failed,
                probes=self._n_probes,
                hedges=self._n_hedges,
                retries=self._n_retries,
                unhealthy_shed=self._n_unhealthy_shed,
                breakers=breakers)

    def reset_stats(self) -> None:
        """Zero fleet counters/windows (after warmup); the shed state
        machine, breaker states and the cache contents are kept — they are
        operating state."""
        for eng in self.engines:
            eng.reset_stats()
        with self._lock:
            self._t0 = self._clock()
            self._n_submitted = self._n_completed = self._n_failed = 0
            self._n_shed = self._n_cache_hits = self._n_cache_misses = 0
            self._n_hedges = self._n_retries = self._n_probes = 0
            self._n_unhealthy_shed = 0
            self._lat_ms.clear()
            self._routed = [0] * len(self.engines)

    def live_version(self) -> Optional[int]:
        """Fleet-wide live model version: the min over *healthy* replicas'
        lock-free version reads. None when any healthy replica's label is
        non-integral (or no replica is healthy) — mid-rollout the min is
        the *oldest still-serving* version, which is exactly the only
        version a cache hit is safe against. A tripped replica is excluded:
        its stale version must not pin the fleet's notion of "live" while
        nothing is routed to it anyway."""
        with self._lock:
            skip = set(self._unhealthy)
        versions = [eng.model_version
                    for i, eng in enumerate(self.engines) if i not in skip]
        if not versions or any(not isinstance(v, int) for v in versions):
            return None
        return min(versions)

    def refresh_routing(self, replica: Optional[int] = None) -> None:
        """Re-read ``route_state`` truth into the cached routing view for
        one replica (or all). Called from completion callbacks and the TTL
        path; public so tests/operators can force a coherent view."""
        idxs = range(len(self.engines)) if replica is None else (replica,)
        states = [(i, dict(self.engines[i].route_state())) for i in idxs]
        now = self._clock()
        with self._lock:
            for i, st in states:
                self._view[i] = st
                self._view_at[i] = now

    def pump(self, force: bool = False) -> int:
        """Manual drive (fake-clock tests): pump every replica."""
        return sum(eng.pump(force) for eng in self.engines)

    def flush_all(self) -> int:
        return sum(eng.flush_all() for eng in self.engines)

    def close(self) -> None:
        """Stop watchers first (no new swaps), then close every replica
        (each drains its queue)."""
        with self._lock:
            self._closed = True
        for w in self._watchers:
            w.stop()
        for eng in self.engines:
            eng.close()

    def __enter__(self) -> "TopicFleet":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # ------------------------------------------------------------- routing

    def _score(self, i: int, bucket: int,  # requires: _lock
               deadline_ms: Optional[float]) -> float:
        """Predicted-completion score for replica ``i`` from the cached
        view. Score (ms) = est · (1 + full batches queued ahead), minus a
        top-off discount when a partial batch is forming (the request rides
        a flush that is already coming), plus a small whole-replica
        pressure term so ties break toward the least busy replica. A score
        past the deadline carries ``_MISS_PENALTY`` (still selectable:
        someone must serve the request or admission control sheds it)."""
        qlen, est = self._view[i][bucket]
        total_queued = sum(q for q, _ in self._view[i].values())
        batches_ahead = qlen // self.max_batch
        score = est * (1.0 + batches_ahead)
        if 0 < qlen % self.max_batch:
            score -= 0.25 * est              # top off the forming batch
        score += 1e-3 * est * total_queued
        if deadline_ms is not None and score > deadline_ms:
            score += _MISS_PENALTY           # predicted miss: last resort
        return score

    def _route(self, bucket: int, deadline_ms: Optional[float],
               now: float) -> Optional[Tuple[int, Optional[int]]]:
        """Pick ``(primary, hedge)`` replicas for one request.

        * Views staler than ``view_ttl_ms`` are re-read first (the fallback
          when completions are rare; steady-state traffic refreshes views
          via completion callbacks at zero cost here).
        * A tripped replica whose backoff has expired claims this request
          as its breaker's recovery probe (at most one in flight — the
          breaker's ``allow`` gate) — and the request is simultaneously
          hedged to the best healthy replica, so the caller never pays for
          probing a suspect replica.
        * Otherwise: best healthy score wins (lowest index on ties); when
          the best is predicted past the deadline, the second-best healthy
          replica rides along as a parallel hedge.
        * No healthy replica and no probe-eligible one → ``None`` (the
          caller sheds with ``reason="unhealthy"``).
        """
        n = len(self.engines)
        with self._lock:
            unhealthy = dict(self._unhealthy)
            stale = [i for i in range(n)
                     if (now - self._view_at[i]) * 1e3 > self.view_ttl_ms]
        for i in stale:
            self.refresh_routing(i)
        # breaker recovery probe: first expired-backoff replica (index
        # order — deterministic) whose breaker admits a probe
        probe_idx = None
        for i in sorted(unhealthy):
            if now >= unhealthy[i] and self.breakers[i].allow():
                probe_idx = i
                break
        with self._lock:
            best = second = None
            best_score = second_score = 0.0
            for i in range(n):
                if i in unhealthy:
                    continue
                score = self._score(i, bucket, deadline_ms)
                if best is None or score < best_score:
                    second, second_score = best, best_score
                    best, best_score = i, score
                elif second is None or score < second_score:
                    second, second_score = i, score
            if probe_idx is not None:
                primary, hedge = probe_idx, best if self.hedge else None
            elif best is None:
                return None
            else:
                primary = best
                hedge = None
                if self.hedge and second is not None \
                        and deadline_ms is not None \
                        and best_score >= _MISS_PENALTY:
                    hedge = second
            # optimistic view bump: the dispatches below land in these
            # queues; the next submit must see them without an engine read
            for i in (primary, hedge):
                if i is not None:
                    qlen, est = self._view[i][bucket]
                    self._view[i][bucket] = (qlen + 1, est)
            return primary, hedge

    def _pick_retry(self, ctx: dict) -> Optional[int]:
        """Best healthy replica not yet tried for this request (retry
        placement); None when every healthy replica was already tried."""
        with ctx["lock"]:
            tried = set(ctx["tried"])
        with self._lock:
            unhealthy = set(self._unhealthy)
            best, best_score = None, 0.0
            for i in range(len(self.engines)):
                if i in unhealthy or i in tried:
                    continue
                score = self._score(i, ctx["bucket"], ctx["deadline_ms"])
                if best is None or score < best_score:
                    best, best_score = i, score
            if best is not None:
                qlen, est = self._view[best][ctx["bucket"]]
                self._view[best][ctx["bucket"]] = (qlen + 1, est)
        return best

    # ---------------------------------------------------------- dispatching

    def _dispatch(self, ctx: dict, idx: int) -> None:
        """Submit one attempt to replica ``idx``. A retry's deadline is the
        *remaining* budget — the engine schedules it against time the
        request has left, not a fresh allowance."""
        deadline_ms = ctx["deadline_ms"]
        if deadline_ms is not None:
            elapsed_ms = (self._clock() - ctx["arrival"]) * 1e3
            deadline_ms = max(1e-3, deadline_ms - elapsed_ms)
        with self._lock:
            self._routed[idx] += 1
        try:
            efut = self.engines[idx].submit(ctx["toks"], deadline_ms)
        except RuntimeError as exc:      # replica closed underneath us
            self._attempt_failed(ctx, idx, exc, breaker=False)
            return
        efut.add_done_callback(
            functools.partial(self._on_attempt_done, ctx, idx))

    def _spawn_probe(self, toks: np.ndarray, bucket: int) -> None:
        """Fleet-synthesized shed probe: a NON-paying duplicate of a shed
        request, submitted to the best healthy replica so the p99 estimate
        can observe recovery. Never cached, never user-visible; counted in
        ``FleetStats.probes``."""
        now = self._clock()
        routed = self._route(bucket, None, now)
        if routed is None:
            return
        idx = routed[0]
        with self._lock:
            self._n_probes += 1
            self._routed[idx] += 1
        try:
            efut = self.engines[idx].submit(np.array(toks, copy=True), None)
        except RuntimeError:
            return
        efut.add_done_callback(
            functools.partial(self._on_probe_done, idx))

    # ----------------------------------------------------------- completion

    def _on_attempt_done(self, ctx: dict, idx: int, fut: Future) -> None:
        """Runs in the completing engine's thread: breaker + latency
        bookkeeping, the shed state machine, hedge/retry resolution and
        cache admission. Never raises."""
        self.refresh_routing(idx)
        if fut.cancelled():
            self._attempt_failed(ctx, idx,
                                 RuntimeError("attempt cancelled"),
                                 breaker=False)
            return
        exc = fut.exception()
        if exc is not None:
            self._attempt_failed(ctx, idx, exc, breaker=True)
            return
        resp = fut.result()
        self.breakers[idx].record_response(resp.latency_ms,
                                           ctx["deadline_ms"])
        self._sync_health(idx)
        with self._lock:
            self._n_completed += 1
            self._lat_ms.append(resp.latency_ms)
            self._since_p99 += 1
            if self._since_p99 >= _P99_EVERY or self._shedding:
                self._since_p99 = 0
                _, p99 = percentiles(self._lat_ms)
                self._p99_est_ms = p99
                if self.shed:
                    self._update_shed_state(p99)
        with ctx["lock"]:
            ctx["pending"] -= 1
            won = not ctx["resolved"]
            if won:
                ctx["resolved"] = True
            attempts = ctx["attempts"]
            hedged = ctx["hedged"]
        if not won:
            return      # hedge loser: bookkeeping above was the point
        resp.attempts = attempts
        resp.hedged = hedged
        if attempts > 1:
            # user-perceived latency spans ALL attempts, measured from the
            # original fleet arrival (a retry's engine-side latency alone
            # would understate it)
            resp.latency_ms = (self._clock() - ctx["arrival"]) * 1e3
            if ctx["deadline_ms"] is not None:
                resp.deadline_missed = \
                    resp.latency_ms > ctx["deadline_ms"]
        key = ctx["key"]
        if key is not None and resp.model_version is not None \
                and resp.model_version == self.live_version():
            # admit only results still current fleet-wide: an entry
            # computed on a replica that already swapped ahead (or behind)
            # must not be served while the fleet's live version differs
            self.cache.put(key, resp.model_version, resp.pkd,
                           resp.feature_ids, resp.feature_weights,
                           resp.bucket)
        ctx["outer"].set_result(resp)

    def _attempt_failed(self, ctx: dict, idx: int, exc: BaseException,
                        breaker: bool) -> None:
        """One attempt failed: record it, then either retry on a different
        healthy replica (once, within remaining budget), wait for a still-
        pending hedge partner, or resolve the caller's future with the
        exception."""
        if breaker:
            self.breakers[idx].record_failure()
            self._sync_health(idx)
        want_retry = False
        with ctx["lock"]:
            ctx["pending"] -= 1
            if ctx["resolved"] or ctx["pending"] > 0:
                return      # hedge partner won already / may still win
            if ctx["attempts"] < _MAX_ATTEMPTS:
                remaining = True
                if ctx["deadline_ms"] is not None:
                    elapsed_ms = (self._clock() - ctx["arrival"]) * 1e3
                    remaining = elapsed_ms < ctx["deadline_ms"]
                want_retry = bool(remaining)
        if want_retry:
            retry_idx = self._pick_retry(ctx)
            if retry_idx is not None:
                with ctx["lock"]:
                    ctx["attempts"] += 1
                    ctx["pending"] += 1
                    ctx["tried"].append(retry_idx)
                with self._lock:
                    self._n_retries += 1
                self._dispatch(ctx, retry_idx)
                return
        with ctx["lock"]:
            if ctx["resolved"]:
                return
            ctx["resolved"] = True
        with self._lock:
            self._n_failed += 1
        ctx["outer"].set_exception(exc)

    def _on_probe_done(self, idx: int, fut: Future) -> None:
        """Shed-probe completion: feed the breaker and the p99 estimator —
        the whole point of the probe is observing recovery."""
        self.refresh_routing(idx)
        if fut.cancelled():
            return
        exc = fut.exception()
        if exc is not None:
            self.breakers[idx].record_failure()
            self._sync_health(idx)
            return
        resp = fut.result()
        self.breakers[idx].record_response(resp.latency_ms, None)
        self._sync_health(idx)
        with self._lock:
            self._lat_ms.append(resp.latency_ms)
            self._since_p99 += 1
            if self._since_p99 >= _P99_EVERY or self._shedding:
                self._since_p99 = 0
                _, p99 = percentiles(self._lat_ms)
                self._p99_est_ms = p99
                if self.shed:
                    self._update_shed_state(p99)

    def _sync_health(self, idx: int) -> None:
        """Mirror replica ``idx``'s breaker state into the ``_unhealthy``
        map the router and ``live_version`` read — one breaker-lock hop
        here (a completion) buys lock-free health checks on every submit."""
        snap = self.breakers[idx].snapshot()
        with self._lock:
            if snap["state"] == health.CLOSED:
                self._unhealthy.pop(idx, None)
            else:
                self._unhealthy[idx] = snap["reopen_at"]

    def _update_shed_state(self, p99: float) -> None:  # requires: _lock
        """Hysteresis band: enter shedding when p99 exceeds the budget
        (slack < 0), exit only below budget · (1 − hysteresis) — inside the
        band the current state holds, so the fleet cannot flap on noise."""
        if not self._shedding and p99 > self.deadline_budget_ms:
            self._shedding = True
            self._since_probe = 0
        elif self._shedding and \
                p99 < self.deadline_budget_ms * (1.0 - self.shed_hysteresis):
            self._shedding = False

    def _on_swap(self, version: int, meta: dict) -> None:
        """Watcher hook (runs in watcher threads): once the fleet-wide live
        version converges past a swap, eagerly reclaim stale cache bytes.
        Correctness never depends on this — ``get`` re-checks versions."""
        live = self.live_version()
        if self.cache is not None and live is not None:
            self.cache.drop_stale(live)
