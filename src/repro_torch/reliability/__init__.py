"""``repro_torch.reliability`` — deterministic fault injection (port of
``repro.reliability``).

The fault plane (:mod:`repro_torch.reliability.faults`) is the failure model
the data and checkpoint defenses are proven against: named injection seams
wired into the hot paths (``snapshot.load``, ``disk.segment_read``), driven
by deterministic schedules (fail-Nth, counter-PRNG fail-rate, injected
latency, bounded wedges) so a chaos test reproduces bit for bit by seed.
Disabled by default with one ``is None`` check of overhead.

The defenses live where the state they protect lives: ``checkpoint.io`` /
``checkpoint.snapshots`` (SHA-256 payload integrity) and
``data.sources.DiskSource`` (verify-once, retry-transient segment reads).
"""
from repro_torch.reliability.faults import (FaultInjected, FaultPlane, get_plane,
                                            hit, injected, install, uninstall)

__all__ = [
    "FaultInjected",
    "FaultPlane",
    "get_plane",
    "hit",
    "injected",
    "install",
    "uninstall",
]
