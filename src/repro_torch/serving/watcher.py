"""``SnapshotWatcher`` — the serving side of the publish pipeline (port of
``repro.serving.watcher``).

Polls a snapshot directory (``checkpoint.snapshots`` layout, written by
either package's ``ModelPublisher``) and hot-swaps every new complete version
into a live :class:`TopicEngine` via its lock-free ``swap_model``. Each
version is loaded onto the device of the engine it feeds (``engine.device``);
the engine's swap makes its stream wait for the load. In-flight
requests are untouched: each engine flush reads the model reference once, so
a swap between flushes is invisible to queued work — the train→serve refresh
drops zero requests by construction.

Use it manually (``poll()`` per tick — how the tests drive it) or as a
background thread (``start()`` / context manager):

    with TopicEngine(model) as engine, \
         SnapshotWatcher(snap_dir, engine, poll_s=0.5) as watcher:
        ...   # traffic; every publish shows up within one poll interval

Concurrency contract (checked by the repo's concurrency analyzer): the
public counters (``version``/``swaps``/``poll_failures``/``last_error``)
and the thread handle live under ``_lock``; the slow work — snapshot IO,
``engine.swap_model`` (which takes the engine's own condition) and
``Thread.join`` — always happens *outside* it, so the watcher's lock never
nests into the engine's and a wedged filesystem can't wedge ``stats()``
readers with it.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from repro_torch.checkpoint import io, snapshots
from repro_torch.reliability import faults


class SnapshotWatcher:
    # every field here is read by operator threads (stats scraping,
    # wait_for_version) while the poller thread writes it
    _GUARDED_BY = {
        "version": "_lock", "swaps": "_lock", "poll_failures": "_lock",
        "last_error": "_lock", "quarantined": "_lock", "_thread": "_lock",
    }

    def __init__(self, snapshot_dir: str, engine, poll_s: float = 0.5,
                 on_swap: Optional[Callable[[int, dict], None]] = None,
                 max_backoff_s: float = 30.0):
        self.snapshot_dir = snapshot_dir
        self.engine = engine
        self.device = engine.device        # where snapshots are loaded
        self.poll_s = float(poll_s)
        self.max_backoff_s = float(max_backoff_s)
        self.on_swap = on_swap
        self._lock = threading.Lock()
        self.version: Optional[int] = None     # last version swapped in
        self.swaps = 0
        self.poll_failures = 0                 # consecutive failed reads
        self.last_error: Optional[BaseException] = None
        self.quarantined = 0                   # corrupt versions retired
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -------------------------------------------------------------- poll ---

    def poll(self) -> Optional[int]:
        """One tick: if a newer complete version exists, load + swap it.
        Returns the swapped version, or None. A version rotated away between
        listing and reading is skipped; the next tick re-resolves latest.

        Last-good fallback (DESIGN.md §14): candidates newer than the live
        version are tried NEWEST FIRST; one whose payload fails the SHA-256
        check (:class:`io.IntegrityError` — torn write, bit rot) is
        quarantined on disk and the walk falls back to the next-newest,
        so one bad publish costs nothing but staleness until the publisher
        ships a good version. A *transient* read failure (rotation race,
        dead mount) aborts the tick instead — the streak is visible as
        ``poll_failures``/``last_error`` and drives the background thread's
        exponential backoff, so a broken publish dir is not hammered at
        full poll cadence.

        IO and the engine swap run without ``_lock`` held — only the
        snapshot of ``version`` before and the counter updates after take
        it. Concurrent polls (manual tick racing the background thread) are
        safe: the final update is monotonic-max on ``version``, so a stale
        poll can neither double-count a swap nor roll the version back.
        """
        with self._lock:
            known = self.version
        try:
            if faults._PLANE is not None:
                faults.hit("watcher.poll")
            versions = snapshots.snapshot_versions(self.snapshot_dir)
        except OSError as exc:
            with self._lock:
                self.poll_failures += 1
                self.last_error = exc
            return None
        candidates = [v for v in versions if known is None or v > known]
        for latest in reversed(candidates):     # newest first
            try:
                model, meta = snapshots.load_snapshot(
                    self.snapshot_dir, latest, device=self.device)
            except io.IntegrityError as exc:
                # corrupt — never servable: retire it (the rename makes it
                # invisible to every future listing, fleet-wide) and fall
                # back to the next-newest candidate
                bad = exc.version if exc.version is not None else latest
                snapshots.quarantine_snapshot(self.snapshot_dir, bad)
                with self._lock:
                    self.quarantined += 1
                    self.last_error = exc
                continue
            except OSError as exc:
                # rotated/incomplete mid-read: retry next tick. A PERSISTENT
                # failure (permissions, dead mount) is visible to operators
                # as a growing ``poll_failures`` streak + ``last_error`` —
                # the model going stale must not be silent.
                with self._lock:
                    self.poll_failures += 1
                    self.last_error = exc
                return None
            # swap outside _lock: swap_model takes the engine's condition,
            # and nesting watcher._lock -> engine._cv would put this lock
            # above the engine's in the global order for no benefit
            self.engine.swap_model(model, version=latest)
            with self._lock:
                self.poll_failures = 0
                self.last_error = None
                if self.version is None or latest > self.version:
                    self.version = latest
                    self.swaps += 1
            if self.on_swap is not None:
                self.on_swap(latest, meta)
            return latest
        return None

    # --------------------------------------------------------- background --

    def start(self) -> "SnapshotWatcher":
        """Idempotent: a live poller is kept, a dead handle (stopped, or
        previously wedged and since exited) is replaced — ``stop()`` then
        ``start()`` always yields a running poller."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            t = threading.Thread(target=self._run,
                                 name="snapshot-watcher", daemon=True)
            self._thread = t
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t = self._thread
        if t is not None:
            # join OUTSIDE _lock: a wedged poller (hung filesystem inside
            # poll) must not hold up every stats()/wait_for_version reader
            # for the whole join timeout
            t.join(timeout=10)
            with self._lock:
                # keep a wedged handle: start() would otherwise spawn a
                # duplicate poller while the old one still runs; the wedged
                # thread exits at its next tick because _stop stays set,
                # after which start() sees a dead handle and respawns
                if not t.is_alive() and self._thread is t:
                    self._thread = None

    def backoff_s(self) -> float:
        """Next poll interval: ``poll_s`` while healthy, doubling per
        consecutive transient failure up to ``max_backoff_s`` — a dead
        publish dir is probed at a decaying cadence, not hammered."""
        with self._lock:
            streak = self.poll_failures
        return min(self.poll_s * (2.0 ** min(streak, 20)), self.max_backoff_s)

    def _run(self) -> None:
        while not self._stop.is_set():
            self.poll()
            self._stop.wait(self.backoff_s())

    def wait_for_version(self, version: int, timeout_s: float = 30.0) -> bool:
        """Block until ``version`` (or newer) is live on the engine. Polls
        inline when the background thread isn't running."""
        deadline = timeout_s + time.monotonic()
        while time.monotonic() < deadline:
            with self._lock:
                current, t = self.version, self._thread
            if current is not None and current >= version:
                return True
            if t is None:
                self.poll()
                with self._lock:
                    current = self.version
                if current is not None and current >= version:
                    return True
            self._stop.wait(min(self.poll_s, 0.05))
        return False

    def __enter__(self) -> "SnapshotWatcher":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
