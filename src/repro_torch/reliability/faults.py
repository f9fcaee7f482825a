"""``FaultPlane`` — deterministic, seeded fault injection seams (port of
``repro.reliability.faults``, pure Python, copied rather than imported).

A fault-tolerance claim that cannot be *tested* is a comment, not a feature.
This module gives the port the JAX package's failure model:

* **Seams** — named points in the real hot paths where a fault can be
  injected. Each seam is one ``faults.hit(seam, key)`` call at the exact
  line where the production failure would surface (a snapshot payload read,
  a disk segment read; the serving seams come with the serving port), so an
  injected failure exercises the identical except-path a real one would.
  The registry is closed: hitting or arming an unknown seam is a
  programming error, not a silent no-op.
* **Schedules** — when a hit actually fails. ``nth=`` fails one exact hit
  (fail-Nth), ``after=`` fails every hit from the N-th on, ``rate=`` flips
  a deterministic coin per hit from a murmur3-style counter hash of
  ``(seed, hit_index)`` — the same counter-PRNG contract as ``core.prng``:
  identical decisions for identical seeds, regardless of thread
  interleaving *per key* (each (seam, key) pair counts its own hits).
* **Actions** — ``fail`` raises :class:`FaultInjected` (an ``OSError``
  subclass, so every existing transient-IO except-path handles it without
  special cases); ``slow`` injects latency through an injectable ``sleep``;
  ``wedge`` blocks the hit until the plane is cleared/uninstalled or a
  deadline passes (bounded so a test can never hang).

Zero overhead when disabled: the module-level plane is ``None`` by default
and every call site guards with one attribute load + ``is None`` check.
Install a plane only in chaos tests / drills:

    plane = FaultPlane(seed=7)
    plane.fail("disk.segment_read", key="3", nth=1)
    plane.fail("snapshot.load", nth=1)
    with faults.injected(plane):
        ...   # failures land deterministically

Concurrency contract (checked by the repo's concurrency analyzer): hit
counters and armed rules live under ``_lock``; ``hit`` computes its verdict
under the lock but sleeps/raises outside it, so a wedged seam never blocks
other seams' bookkeeping.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

# The closed seam registry, the JAX package's: adding a seam = add it here +
# one guarded ``faults.hit`` call at the production line it models. The
# serving seams stay registered for the serving port.
SEAMS = (
    "engine.infer",        # inference launch fails (bad model, device loss)
    "watcher.poll",        # snapshot dir listing fails (dead mount, perms)
    "snapshot.load",       # snapshot payload read fails / corrupt
    "disk.segment_read",   # corpus segment .npy read fails mid-epoch
    "replica.wedge",       # replica hangs inside inference (stuck device)
    "replica.slow",        # replica serves, but slowly (straggler)
)

_FMIX_C1 = 0x85EB_CA6B
_FMIX_C2 = 0xC2B2_AE35
_GOLDEN = 0x9E37_79B9
_MASK = 0xFFFF_FFFF


def _fmix32(h: int) -> int:
    """murmur3 32-bit finalizer (host-side twin of ``core.prng.fmix32``)."""
    h &= _MASK
    h ^= h >> 16
    h = (h * _FMIX_C1) & _MASK
    h ^= h >> 13
    h = (h * _FMIX_C2) & _MASK
    h ^= h >> 16
    return h


def counter_uniform(seed: int, counter: int, salt: int = 0) -> float:
    """Deterministic uniform in (0, 1) from (seed, counter, salt) — the
    schedule coin. Stateless: the N-th hit of a seam draws the same value
    in every run with the same seed, independent of thread interleaving."""
    h = _fmix32(seed ^ _GOLDEN)
    h = _fmix32(h ^ ((counter * _FMIX_C1 + _GOLDEN) & _MASK))
    h = _fmix32(h ^ ((salt * _FMIX_C2 + _GOLDEN) & _MASK))
    return ((h >> 8) + 0.5) / float(1 << 24)


class FaultInjected(OSError):
    """An injected fault. Subclasses ``OSError`` so every transient-IO
    except-path (watcher poll, snapshot load, segment read) handles an
    injected failure exactly like a real one — the seams prove the *real*
    recovery code, not a parallel test-only path."""

    def __init__(self, seam: str, key: Optional[str], hit_index: int):
        super().__init__(
            f"injected fault at seam {seam!r}"
            + (f" key={key!r}" if key is not None else "")
            + f" (hit #{hit_index})")
        self.seam = seam
        self.key = key
        self.hit_index = hit_index


@dataclasses.dataclass(frozen=True)
class _Rule:
    """One armed schedule on a (seam, key) selector."""

    action: str                      # "fail" | "slow" | "wedge"
    key: Optional[str]               # None = every key
    nth: Optional[int]               # fire on exactly the nth hit (1-based)
    after: Optional[int]             # fire on every hit >= after (1-based)
    rate: Optional[float]            # deterministic coin per hit
    salt: int                        # decorrelates multiple rate rules
    latency_ms: float                # for "slow"
    timeout_s: float                 # for "wedge": hard bound, never hangs

    def fires(self, hit_index: int, seed: int) -> bool:
        if self.nth is not None and hit_index != self.nth:
            return False
        if self.after is not None and hit_index < self.after:
            return False
        if self.rate is not None:
            return counter_uniform(seed, hit_index, self.salt) < self.rate
        return self.nth is not None or self.after is not None


class FaultPlane:
    """Registry of armed fault rules + per-(seam, key) hit counters.

    Deterministic by ``seed``: with the same arming calls and the same
    per-key hit sequence, the same hits fail in every run. Thread-safe —
    engines hit seams from N batching threads concurrently.
    """

    # counters and rules are written by arm/clear (test thread) and read +
    # bumped by hit() (every engine/watcher/stream thread)
    _GUARDED_BY = {
        "_rules": "_lock", "_hits": "_lock", "_injected": "_lock",
        "_released": "_lock",
    }

    def __init__(self, seed: int = 0, *,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Optional[Callable[[float], None]] = None):
        self.seed = int(seed)
        self._clock = clock
        # injectable so a fake-clock test "sleeps" by advancing its clock —
        # injected latency then costs zero wall time
        self._sleep = sleep if sleep is not None else time.sleep
        self._lock = threading.Lock()
        self._rules: Dict[str, List[_Rule]] = {s: [] for s in SEAMS}
        self._hits: Dict[Tuple[str, Optional[str]], int] = {}
        self._injected: Dict[Tuple[str, Optional[str]], int] = {}
        self._released = False      # wedge release latch (uninstall/clear)

    # ------------------------------------------------------------- arming --

    def _arm(self, seam: str, action: str, key: Optional[str],
             nth: Optional[int], after: Optional[int],
             rate: Optional[float], latency_ms: float,
             timeout_s: float) -> "FaultPlane":
        if seam not in SEAMS:
            raise ValueError(f"unknown fault seam {seam!r}; seams: {SEAMS}")
        if nth is None and after is None and rate is None:
            after = 1               # unconditional: every hit fires
        if rate is not None and not 0.0 <= rate <= 1.0:
            raise ValueError("rate must be in [0, 1]")
        with self._lock:
            salt = len(self._rules[seam])
            self._rules[seam].append(_Rule(
                action=action, key=key, nth=nth, after=after, rate=rate,
                salt=salt, latency_ms=float(latency_ms),
                timeout_s=float(timeout_s)))
        return self

    def fail(self, seam: str, *, key: Optional[str] = None,
             nth: Optional[int] = None, after: Optional[int] = None,
             rate: Optional[float] = None) -> "FaultPlane":
        """Arm a failure: the selected hits raise :class:`FaultInjected`."""
        return self._arm(seam, "fail", key, nth, after, rate, 0.0, 0.0)

    def slow(self, seam: str, latency_ms: float, *,
             key: Optional[str] = None, nth: Optional[int] = None,
             after: Optional[int] = None,
             rate: Optional[float] = None) -> "FaultPlane":
        """Arm injected latency: the selected hits sleep ``latency_ms``
        through the plane's (injectable) sleep before proceeding."""
        return self._arm(seam, "slow", key, nth, after, rate,
                         latency_ms, 0.0)

    def wedge(self, seam: str, *, key: Optional[str] = None,
              nth: Optional[int] = None, after: Optional[int] = None,
              timeout_s: float = 30.0) -> "FaultPlane":
        """Arm a wedge: the selected hits block until :meth:`release` (or
        ``timeout_s``, so a chaos test can never hang), then raise."""
        return self._arm(seam, "wedge", key, nth, after, None, 0.0,
                         timeout_s)

    def clear(self, seam: Optional[str] = None) -> None:
        """Disarm one seam (or all); wedged hits unblock and raise."""
        with self._lock:
            for s in ([seam] if seam is not None else list(SEAMS)):
                self._rules[s] = []
            if seam is None:
                self._released = True

    def release(self) -> None:
        """Unblock every wedged hit (they raise FaultInjected on release)."""
        with self._lock:
            self._released = True

    # ----------------------------------------------------------- observing --

    def hits(self, seam: str, key: Optional[str] = None) -> int:
        """Times the seam was reached (whether or not a rule fired)."""
        with self._lock:
            if key is None:
                return sum(n for (s, _), n in self._hits.items() if s == seam)
            return self._hits.get((seam, key), 0)

    def injected(self, seam: str, key: Optional[str] = None) -> int:
        """Times a rule actually fired at the seam."""
        with self._lock:
            if key is None:
                return sum(n for (s, _), n in self._injected.items()
                           if s == seam)
            return self._injected.get((seam, key), 0)

    # ---------------------------------------------------------------- hit --

    def hit(self, seam: str, key: Optional[str] = None) -> None:
        """One pass through a seam. Raises / sleeps / blocks per the armed
        rules; a no-rule hit costs one lock hop and a dict bump."""
        if seam not in SEAMS:
            raise ValueError(f"unknown fault seam {seam!r}; seams: {SEAMS}")
        with self._lock:
            k = (seam, key)
            idx = self._hits.get(k, 0) + 1
            self._hits[k] = idx
            fired: Optional[_Rule] = None
            for rule in self._rules[seam]:
                if rule.key is not None and rule.key != key:
                    continue
                if rule.fires(idx, self.seed):
                    fired = rule
                    break
            if fired is not None:
                self._injected[k] = self._injected.get(k, 0) + 1
        if fired is None:
            return
        # act OUTSIDE the lock: a slow/wedged seam must not block other
        # seams' (or other keys') bookkeeping
        if fired.action == "slow":
            self._sleep(fired.latency_ms / 1e3)
            return
        if fired.action == "wedge":
            deadline = self._clock() + fired.timeout_s
            while self._clock() < deadline:
                with self._lock:
                    released = self._released
                if released:
                    break
                self._sleep(0.01)
        raise FaultInjected(seam, key, idx)


# -------------------------------------------------------- global install ---

# the one global the hot paths check; None = fault plane disabled (the
# default, and the only state production code ever sees)
_PLANE: Optional[FaultPlane] = None


def install(plane: FaultPlane) -> FaultPlane:
    """Make ``plane`` the active fault plane (chaos tests / drills only)."""
    global _PLANE
    _PLANE = plane
    return plane


def uninstall() -> None:
    global _PLANE
    if _PLANE is not None:
        _PLANE.release()        # unblock anything wedged before detaching
    _PLANE = None


def get_plane() -> Optional[FaultPlane]:
    return _PLANE


def hit(seam: str, key: Optional[str] = None) -> None:
    """Seam call-site helper: no-op (one ``is None`` check) when disabled."""
    plane = _PLANE
    if plane is not None:
        plane.hit(seam, key)


@contextlib.contextmanager
def injected(plane: FaultPlane):
    """``with faults.injected(plane): ...`` — install for the block, always
    uninstall after (a failed chaos assertion must not leak faults into the
    next test)."""
    install(plane)
    try:
        yield plane
    finally:
        uninstall()
