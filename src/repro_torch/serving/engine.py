"""``TopicEngine`` — the async, deadline-aware RT-LDA serving front (port of
``repro.serving.engine``).

Peacock answers unseen queries "in milliseconds" from backend inference
servers (§3.2, Fig. 5A). The tail-latency story has three parts, and each is
a concrete mechanism here:

  queue → bucketer → eager batches on the engine's stream → futures

* **submit() → Future** — callers enqueue and move on; a background batching
  loop owns the device. One Python thread is enough: PyTorch releases the
  GIL while the batch's results copy to the host, so submission and
  inference overlap.
* **Deadline-aware flushing** — a batch launches when it *fills*, or when the
  oldest queued request's slack expires: ``arrival + (deadline − service
  estimate)`` for deadlined requests (the service estimate is a per-bucket
  EWMA of measured batch latency), ``arrival + max_delay_ms`` for
  best-effort ones. Waiting longer than that can only convert met deadlines
  into missed ones.
* **Shape buckets** — one batch shape per (row-bucket, length-bucket). A
  3-token query pays 8-token padding instead of 64, long queries route to
  wider buckets instead of being silently truncated, and partial flushes pad
  rows to the next power of two, as in the JAX engine, so the shapes stay
  O(len(buckets) · log max_batch). The port runs each batch eagerly, with no
  CUDA graph: a capture would freeze the batch seed (a Python int) and would
  keep reading a swapped-out model by address.
* **Device and stream** — the engine serves on its model's device
  (``model.pvk.device``; a CUDA model with no card raises, nothing moves to
  the CPU). On CUDA each engine runs its batches on a ``torch.cuda.Stream`` of
  its own, so replicas sharing one card overlap; results reach the host with
  ``.cpu().numpy()`` on that stream.
* **Lock-free model hot-swap** — ``swap_model`` publishes a new
  :class:`RTLDAModel` with one reference assignment; each flush reads the
  reference once, so every batch runs against exactly one model (no torn
  batches) and the train→aggregate loop can push fresh Φ mid-traffic. A CUDA
  model is published with an event recorded on the caller's current stream;
  the engine's stream waits on it before the batch reads the model, and marks
  the model's tensors as used on its stream (``record_stream``), so a model
  built or loaded on another stream is complete when read, and a swapped-out
  model is not freed under a batch that still reads it.
* **stats()** — QPS, p50/p99 latency, batch occupancy, deadline-miss rate.

The clock is injectable (``clock=...``) and the loop can be driven manually
(``start=False`` + ``pump()``), which is how the deadline logic is unit
tested without sleeping.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import features
from repro_torch.core.rtlda import DEFAULT_BUCKETS, RTLDAModel, select_bucket
from repro_torch.reliability import faults
from repro_torch.serving.protocol import EngineStats, Request, Response, percentiles

_LAT_WINDOW = 4096   # recent completions kept for p50/p99
_OCC_WINDOW = 512    # recent flushes kept for occupancy


def _row_bucket(n: int, max_batch: int) -> int:
    """Next power of two ≥ n, capped at max_batch (bounded executable count)."""
    b = 1
    while b < n and b < max_batch:
        b <<= 1
    return min(b, max_batch)


def _ready_event(model) -> Optional[torch.cuda.Event]:
    """An event recorded on the caller's current stream when a CUDA model is
    published: work queued there (the model's build, or its load from a
    snapshot) is done when the event is. None for a CPU model, and for an
    object that is not a model: that batch then fails, as in the JAX engine."""
    pvk = getattr(model, "pvk", None)
    if not isinstance(pvk, torch.Tensor) or pvk.device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(pvk.device))
    return event


class TopicEngine:
    """Async batched RT-LDA inference with deadlines, buckets and hot-swap."""

    # concurrency contract (checked by the repo's concurrency analyzer): every
    # field below is touched by both the batching thread and public callers,
    # and must only be accessed inside `with self._cv:`
    _GUARDED_BY = {
        "_pending": "_cv", "_est_ms": "_cv", "_next_id": "_cv",
        "_seed": "_cv", "_stop": "_cv", "_t0": "_cv",
        "_n_submitted": "_cv", "_n_completed": "_cv", "_n_truncated": "_cv",
        "_n_missed": "_cv", "_n_deadlined": "_cv", "_per_bucket": "_cv",
        "_lat_ms": "_cv", "_occupancy": "_cv",
    }

    def __init__(self, model: RTLDAModel, *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_batch: int = 256,
                 n_iters: int = 5, n_trials: int = 2, top_n: int = 30,
                 max_delay_ms: float = 5.0,
                 service_estimate_ms: float = 2.0,
                 infer_fn=None,
                 chunk_long: bool = True,
                 clock=time.monotonic,
                 name: Optional[str] = None,
                 start: bool = True):
        if not buckets:
            raise ValueError("need at least one shape bucket")
        # the engine's fault-seam key: chaos tests target one replica of a
        # fleet by name ("replica0", ...) without touching the others
        self.name = name
        self.buckets: Tuple[int, ...] = tuple(sorted(int(b) for b in buckets))
        self.max_batch = int(max_batch)
        self.max_delay_ms = float(max_delay_ms)
        self.chunk_long = bool(chunk_long)
        # (model, version, ready event) live in ONE reference so a single
        # unlocked read yields a consistent triple — separate fields could
        # tear between a flush reading the model and stamping the version
        self._model_ref = (model, 0, _ready_event(model))  # atomic: single-reference publish; flush + stats snapshot the (model, version, event) triple with one read, swap_model replaces the whole tuple under _cv
        # the engine serves where its model lives; make_serving_fn raises for
        # a CUDA device when there is no card
        self.device: torch.device = model.pvk.device
        # ``infer_fn`` lets a fleet of replicas share ONE serving function
        self._infer = infer_fn if infer_fn is not None else \
            features.make_serving_fn(
                n_iters=n_iters, n_trials=n_trials, top_n=top_n,
                device=self.device)
        # the batching thread's stream (set here, read-only after): batches
        # of replicas that share a card overlap; None on the CPU
        self._stream = torch.cuda.Stream(device=self.device) \
            if self.device.type == "cuda" else None
        self._clock = clock

        self._cv = threading.Condition()
        # per-bucket FIFO of (Request, Future, flush_by_s, truncated)
        self._pending: Dict[int, collections.deque] = {
            b: collections.deque() for b in self.buckets}
        self._est_ms: Dict[int, float] = {
            b: float(service_estimate_ms) for b in self.buckets}
        self._next_id = 0
        self._seed = 0
        self._stop = False

        self._t0 = clock()
        self._n_submitted = 0
        self._n_completed = 0
        self._n_truncated = 0
        self._n_missed = 0
        self._n_deadlined = 0
        self._per_bucket: Dict[int, int] = {b: 0 for b in self.buckets}
        self._lat_ms = collections.deque(maxlen=_LAT_WINDOW)
        self._occupancy = collections.deque(maxlen=_OCC_WINDOW)

        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._run, name="topic-engine", daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------ API

    def submit(self, tokens, deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one query; resolves to a :class:`Response`.

        Queries longer than the widest bucket are **continuously batched**
        (``chunk_long``, default on): split into widest-bucket chunks that
        ride the normal batching path as sub-batches, with the results
        folded back into ONE response — no token is ever silently dropped
        and ``truncated`` stays False. Engine counters count the chunks
        (they are what the device actually ran); the folded parent is the
        caller-visible unit.
        """
        toks = np.asarray(tokens, np.int32).reshape(-1)
        if self.chunk_long and len(toks) > self.buckets[-1]:
            return self._submit_chunked(toks, deadline_ms)
        now = self._clock()
        bucket, truncated = select_bucket(len(toks), self.buckets)
        with self._cv:
            if self._stop:
                raise RuntimeError("TopicEngine is closed")
            req = Request(tokens=toks, request_id=self._next_id,
                          arrival_s=now, deadline_ms=deadline_ms)
            self._next_id += 1
            self._n_submitted += 1
            if deadline_ms is None:
                slack_ms = self.max_delay_ms
            else:
                slack_ms = max(0.0, deadline_ms - self._est_ms[bucket])
            fut: Future = Future()
            self._pending[bucket].append(
                (req, fut, now + slack_ms / 1e3, truncated))
            self._cv.notify()
        return fut

    def _submit_chunked(self, toks: np.ndarray,
                        deadline_ms: Optional[float]) -> Future:
        """Continuous batching for over-long queries: widest-bucket chunks
        submitted as ordinary sub-batches, folded into one Response when the
        last chunk lands. The parent future resolves with the fold (or the
        first chunk failure); cancelling the parent abandons the fold but
        never the chunks (they still count in engine stats)."""
        widest = self.buckets[-1]
        chunks = [toks[i:i + widest] for i in range(0, len(toks), widest)]
        arrival = self._clock()
        parent: Future = Future()
        fold_lock = threading.Lock()   # guards the fold state below only
        state = {"left": len(chunks), "parts": [None] * len(chunks),
                 "failed": False}

        def on_chunk_done(i: int, fut: Future) -> None:
            # fut is done — result()/exception() below never block
            exc = fut.exception() if not fut.cancelled() else \
                RuntimeError("sub-batch cancelled")
            if exc is not None:
                with fold_lock:
                    first = not state["failed"]
                    state["failed"] = True
                if first and parent.set_running_or_notify_cancel():
                    parent.set_exception(exc)
                return
            with fold_lock:
                state["parts"][i] = fut.result()
                state["left"] -= 1
                ready = state["left"] == 0 and not state["failed"]
            if ready:
                resp = self._fold_chunks(state["parts"], toks, arrival,
                                         deadline_ms)
                if parent.set_running_or_notify_cancel():
                    parent.set_result(resp)

        futs = [self.submit(c, deadline_ms) for c in chunks]
        for i, f in enumerate(futs):
            f.add_done_callback(functools.partial(on_chunk_done, i))
        return parent

    def _fold_chunks(self, parts: List[Response], toks: np.ndarray,
                     arrival: float,
                     deadline_ms: Optional[float]) -> Response:
        """Fold chunk responses into one: P(k|d) is the token-count-weighted
        mixture (renormalized), Eq.-5 features merge by summing each id's
        weight across chunks and re-taking the top-n."""
        lengths = np.asarray(self._chunk_lengths(len(toks)), np.float64)
        w_chunk = lengths / lengths.sum()
        pkd = np.zeros_like(np.asarray(parts[0].pkd, np.float64))
        for wc, p in zip(w_chunk, parts):
            pkd = pkd + wc * np.asarray(p.pkd, np.float64)
        s = pkd.sum()
        if s > 0:
            pkd = pkd / s
        top_n = int(parts[0].feature_ids.shape[0])
        merged: Dict[int, float] = {}
        for wc, p in zip(w_chunk, parts):
            for fid, fw in zip(np.asarray(p.feature_ids),
                               np.asarray(p.feature_weights)):
                if fid >= 0:
                    merged[int(fid)] = merged.get(int(fid), 0.0) \
                        + float(wc) * float(fw)
        ranked = sorted(merged.items(), key=lambda kv: (-kv[1], kv[0]))
        ids = np.full((top_n,), -1, np.int32)
        ws = np.zeros((top_n,), np.float32)
        for j, (fid, fw) in enumerate(ranked[:top_n]):
            ids[j], ws[j] = fid, fw
        latency_ms = (self._clock() - arrival) * 1e3
        versions = {p.model_version for p in parts}
        # chunks that straddled a hot-swap ran on mixed models: the fold has
        # no single version (None) — a result cache must not admit it
        model_version = versions.pop() if len(versions) == 1 else None
        return Response(
            request_id=parts[0].request_id,
            pkd=pkd.astype(np.float32), feature_ids=ids, feature_weights=ws,
            bucket=int(self.buckets[-1]), truncated=False,
            latency_ms=latency_ms,
            deadline_missed=(deadline_ms is not None
                             and latency_ms > deadline_ms),
            model_version=model_version)

    def _chunk_lengths(self, n: int) -> List[int]:
        widest = self.buckets[-1]
        return [min(widest, n - i) for i in range(0, n, widest)]

    def infer(self, requests: Sequence, deadline_ms: Optional[float] = None
              ) -> List[Response]:
        """Sync convenience: submit all, force a drain, return in order."""
        futs = [self.submit(r, deadline_ms) for r in requests]
        self.flush_all()
        return [f.result() for f in futs]

    def swap_model(self, model: RTLDAModel, version=None) -> None:
        """Atomically publish a new serving model (one reference store; each
        flush reads it once, so no batch ever sees a half-swapped model).

        ``version`` labels the model for observability (``stats()`` reports
        it; the SnapshotWatcher passes the snapshot version). ``None``
        auto-increments, so every swap is visible even unlabeled.

        A CUDA model may still be in flight on the caller's current stream:
        the event recorded here makes the engine's stream wait for it."""
        ready = _ready_event(model)
        with self._cv:
            # the lock serializes concurrent swaps (the auto-increment is a
            # read-modify-write); readers never take it — they snapshot
            # _model_ref once, lock-free
            if version is None:
                prev = self._model_ref[1]
                version = (prev + 1) if isinstance(prev, int) else 0
            self._model_ref = (model, version, ready)

    @property
    def model_version(self):
        """Version label of the live model — ONE lock-free read of the
        published ``(model, version, event)`` reference, cheap enough for a router
        to consult on every request."""
        return self._model_ref[1]

    def route_state(self) -> Dict[int, Tuple[int, float]]:
        """Cheap routing snapshot for a fleet front: per shape bucket, the
        queue depth and the EWMA service estimate (ms). One short critical
        section — no percentile math, unlike :meth:`stats`."""
        with self._cv:
            return {b: (len(self._pending[b]), self._est_ms[b])
                    for b in self.buckets}

    def stats(self) -> EngineStats:
        with self._cv:
            now = self._clock()
            p50, p99 = percentiles(self._lat_ms)
            elapsed = max(now - self._t0, 1e-9)
            occ = (float(np.mean(self._occupancy))
                   if self._occupancy else 0.0)
            miss_rate = (self._n_missed / self._n_deadlined
                         if self._n_deadlined else 0.0)
            return EngineStats(
                submitted=self._n_submitted,
                completed=self._n_completed,
                truncated=self._n_truncated,
                deadline_missed=self._n_missed,
                qps=self._n_completed / elapsed,
                p50_ms=p50, p99_ms=p99,
                mean_batch_occupancy=occ,
                deadline_miss_rate=miss_rate,
                per_bucket=dict(self._per_bucket),
                model_version=self._model_ref[1],
            )

    def reset_stats(self) -> None:
        """Zero the counters/windows (e.g. after a warm-up pass).
        The EWMA service estimates are kept — they are scheduling state."""
        with self._cv:
            self._t0 = self._clock()
            self._n_submitted = self._n_completed = 0
            self._n_truncated = self._n_missed = self._n_deadlined = 0
            self._per_bucket = {b: 0 for b in self.buckets}
            self._lat_ms.clear()
            self._occupancy.clear()

    def close(self) -> None:
        """Stop the loop; drains anything still queued first."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self.flush_all()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------ batching loop

    def pump(self, force: bool = False) -> int:
        """Flush every due bucket (all non-empty ones when ``force``).

        The background thread calls this on wakeup; tests and the sync
        adapter call it directly — with an injected fake clock this is the
        whole deadline path, no sleeping. Returns batches flushed.
        """
        flushed = 0
        while True:
            now = self._clock()
            batch = self._pop_batch(now, force)
            if batch is None:
                return flushed
            self._run_batch(*batch)
            flushed += 1

    def flush_all(self) -> int:
        return self.pump(force=True)

    def _pop_batch(self, now: float, force: bool):
        """Under the lock, pop the most urgent due batch (or None)."""
        with self._cv:
            due: List[Tuple[float, int]] = []
            for b, q in self._pending.items():
                if not q:
                    continue
                # min over the queue, not the head: a tight-deadline request
                # queued behind a best-effort one must still flush on time
                flush_by = min(e[2] for e in q)
                if force or len(q) >= self.max_batch or now >= flush_by:
                    due.append((flush_by, b))
            if not due:
                return None
            _, bucket = min(due)   # oldest slack first
            q = self._pending[bucket]
            entries = [q.popleft() for _ in range(min(len(q), self.max_batch))]
            self._seed += 1
            return bucket, entries, self._seed

    def _run_batch(self, bucket: int, entries, seed: int) -> None:
        """Pad, run the batch on the engine's stream, resolve futures.

        Never raises: an inference failure (e.g. a hot-swapped model with
        incompatible shapes) resolves every popped future with the exception
        instead of killing the batching thread with futures stranded, and
        futures the caller already cancelled are dropped, not re-resolved.
        """
        # claim each future; drop the ones cancelled while they were queued
        entries = [e for e in entries if e[1].set_running_or_notify_cancel()]
        if not entries:
            return
        # ONE read: the hot-swap atomicity point — the whole batch runs
        # against this model and is stamped with this version
        model, model_version, ready = self._model_ref
        rows = _row_bucket(len(entries), self.max_batch)
        q = np.full((rows, bucket), -1, np.int32)
        for i, (req, _, _, _) in enumerate(entries):
            toks = req.tokens[:bucket]
            q[i, :len(toks)] = toks
        t_launch = self._clock()
        try:
            # fault seams (DESIGN.md §14): a hit is a no-op unless a chaos
            # test installed a plane; an injected failure takes the SAME
            # except-path a real inference exception would
            if faults._PLANE is not None:
                faults.hit("replica.wedge", key=self.name)
                faults.hit("replica.slow", key=self.name)
                faults.hit("engine.infer", key=self.name)
            with self._on_stream(model, ready):
                pkd, ids, w = self._infer(model, q, seed)
                # the copy runs on the engine's stream and waits for the batch
                pkd, ids, w = (t.cpu().numpy() for t in (pkd, ids, w))
        except Exception as exc:     # noqa: BLE001 — forwarded to callers
            for _, fut, _, _ in entries:
                fut.set_exception(exc)
            return
        now = self._clock()
        service_ms = (now - t_launch) * 1e3

        responses = []
        for i, (req, fut, _, truncated) in enumerate(entries):
            latency_ms = (now - req.arrival_s) * 1e3
            missed = (req.deadline_ms is not None
                      and latency_ms > req.deadline_ms)
            responses.append((fut, req.deadline_ms is not None, Response(
                request_id=req.request_id,
                pkd=pkd[i], feature_ids=ids[i], feature_weights=w[i],
                bucket=bucket, truncated=truncated,
                latency_ms=latency_ms, deadline_missed=missed,
                model_version=model_version)))

        with self._cv:
            # EWMA service estimate drives future requests' flush slack
            self._est_ms[bucket] = 0.8 * self._est_ms[bucket] + 0.2 * service_ms
            self._occupancy.append(len(entries) / rows)
            for _, had_deadline, resp in responses:
                self._n_completed += 1
                self._per_bucket[bucket] += 1
                self._lat_ms.append(resp.latency_ms)
                if resp.truncated:
                    self._n_truncated += 1
                if had_deadline:
                    self._n_deadlined += 1
                    if resp.deadline_missed:
                        self._n_missed += 1
        for fut, _, resp in responses:
            fut.set_result(resp)

    @contextlib.contextmanager
    def _on_stream(self, model, ready):
        """Run the body on the engine's stream (nothing to do on the CPU):
        wait for the model's publish event, and mark its tensors as used on
        this stream, so the allocator does not reuse their memory while
        work queued here may still read them."""
        if self._stream is None:
            yield
            return
        with torch.cuda.stream(self._stream):
            if ready is not None:
                self._stream.wait_event(ready)
            for t in (model.pvk, model.alpha, model.r_topic, model.r_value):
                t.record_stream(self._stream)
            yield

    def _run(self) -> None:
        while True:
            with self._cv:
                if self._stop:
                    return
                timeout = self._wait_timeout(self._clock())
                if timeout is None or timeout > 0:
                    self._cv.wait(timeout if timeout is not None else 0.05)
                if self._stop:
                    return
            self.pump()

    def _wait_timeout(self, now: float) -> Optional[float]:  # requires: _cv
        """Seconds until the next flush deadline; 0 if a flush is already
        due; None when nothing is queued (idle — poll slowly)."""
        soonest = None
        for q in self._pending.values():
            if not q:
                continue
            if len(q) >= self.max_batch:
                return 0.0
            flush_by = min(e[2] for e in q)
            soonest = flush_by if soonest is None else min(soonest, flush_by)
        if soonest is None:
            return None
        return max(0.0, soonest - now)
