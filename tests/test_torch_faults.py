"""The port's fault plane (``repro_torch.reliability.faults``) against the JAX
package's: the same arming calls and hit sequences make the same decisions
(fail-Nth, after, rate by seed, keyed rules, slow with an injectable sleep,
wedge with a deadline and release), and the ``snapshot.load`` seam fires
where the JAX loader's does. The module is pure Python in both packages, so
every decision must be equal, hit for hit."""
import os
import threading

import numpy as np
import pytest

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro.checkpoint import snapshots as jsnapshots
from repro.reliability import faults as jfaults
from repro_torch.checkpoint import snapshots as tsnapshots
from repro_torch.reliability import faults as tfaults

pytestmark = pytest.mark.port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": jfaults, "port": tfaults}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance_ms(self, ms):
        self.t += ms / 1e3


def _outcomes(faults, arm, hits, seed=0):
    """Arm a fresh plane with ``arm(plane)``, run ``hits`` [(seam, key)]
    through it; returns (per-hit outcome, hit counts, injected counts)."""
    plane = faults.FaultPlane(seed=seed)
    arm(plane)
    out = []
    for seam, key in hits:
        try:
            plane.hit(seam, key)
            out.append(None)
        except faults.FaultInjected as exc:
            assert isinstance(exc, OSError)
            out.append((exc.seam, exc.key, exc.hit_index))
    seams = sorted({s for s, _ in hits})
    counts = [(plane.hits(s), plane.injected(s),
               [(plane.hits(s, k), plane.injected(s, k)) for k in ("0", "1", "2", None)])
              for s in seams]
    return out, counts


def test_seams_and_counter_uniform_are_the_same():
    assert tfaults.SEAMS == jfaults.SEAMS
    for seed in (0, 1, 7, 2 ** 32 - 1, 12345678901):
        for counter in (0, 1, 2, 999, 2 ** 31):
            for salt in (0, 1, 5):
                assert (tfaults.counter_uniform(seed, counter, salt)
                        == jfaults.counter_uniform(seed, counter, salt))


SCHEDULES = {
    "fail nth": lambda p: p.fail("engine.infer", nth=3),
    "fail after": lambda p: p.fail("disk.segment_read", key="2", after=3),
    "unconditional": lambda p: p.fail("watcher.poll"),
    "rate": lambda p: p.fail("snapshot.load", rate=0.3),
    "two rates": lambda p: p.fail("snapshot.load", rate=0.2).fail("snapshot.load",
                                                                  key="1", rate=0.5),
    "keyed nth and rate": lambda p: p.fail("disk.segment_read", key="0", nth=2)
                                     .fail("disk.segment_read", rate=0.4),
}


@pytest.mark.parametrize("seed", [0, 11, 12])
@pytest.mark.parametrize("name", list(SCHEDULES))
def test_fault_plane_schedules_match_jax(name, seed):
    rng = np.random.default_rng(seed)
    seams = ["engine.infer", "disk.segment_read", "watcher.poll", "snapshot.load"]
    hits = [(seams[int(rng.integers(4))], [None, "0", "1", "2"][int(rng.integers(4))])
            for _ in range(300)]
    got = _outcomes(tfaults, SCHEDULES[name], hits, seed)
    want = _outcomes(jfaults, SCHEDULES[name], hits, seed)
    assert got == want
    assert any(o is not None for o in got[0]), "the schedule never fired"


def test_fault_plane_refusals_match_jax():
    for faults in PKGS.values():
        plane = faults.FaultPlane()
        with pytest.raises(ValueError):
            plane.fail("engine.inferr")
        with pytest.raises(ValueError):
            plane.hit("no.such.seam")
        with pytest.raises(ValueError):
            plane.fail("snapshot.load", rate=1.5)


def test_fault_plane_slow_uses_injectable_sleep():
    slept = {}
    for name, faults in PKGS.items():
        sleeps = slept[name] = []
        plane = faults.FaultPlane(sleep=sleeps.append)
        plane.slow("replica.slow", 250.0, nth=2)
        plane.slow("disk.segment_read", 40.0, rate=0.5)
        for _ in range(3):
            plane.hit("replica.slow")
        for i in range(40):
            plane.hit("disk.segment_read", key=str(i % 3))
        assert plane.injected("replica.slow") == 1
    assert slept["port"] == slept["jax"] and slept["port"][0] == 0.25


def test_fault_plane_wedge_is_deadline_bounded():
    waited = {}
    for name, faults in PKGS.items():
        clock = FakeClock()
        plane = faults.FaultPlane(clock=clock, sleep=lambda s: clock.advance_ms(s * 1e3))
        plane.wedge("replica.wedge", timeout_s=2.0)
        with pytest.raises(faults.FaultInjected):
            plane.hit("replica.wedge")
        waited[name] = clock()
    assert waited["port"] == waited["jax"] >= 2.0


def test_fault_plane_wedge_release_unblocks():
    plane = tfaults.FaultPlane()
    plane.wedge("replica.wedge", timeout_s=30.0)
    raised = threading.Event()

    def _worker():
        try:
            plane.hit("replica.wedge")
        except tfaults.FaultInjected:
            raised.set()

    t = threading.Thread(target=_worker, daemon=True)
    t.start()
    plane.release()
    t.join(timeout=5)
    assert raised.is_set(), "released wedge must raise, not hang"


def test_injected_context_manager_installs_and_always_uninstalls():
    assert tfaults.get_plane() is None
    tfaults.hit("engine.infer")       # disabled: a no-op, never raises
    plane = tfaults.FaultPlane().fail("engine.infer")
    with pytest.raises(tfaults.FaultInjected):
        with tfaults.injected(plane):
            assert tfaults.get_plane() is plane
            assert jfaults.get_plane() is None      # the two planes are separate
            tfaults.hit("engine.infer")
    assert tfaults.get_plane() is None, "uninstalled even on raise"
    tfaults.hit("engine.infer")


def _publish_chain(root):
    """A full snapshot v1 and a delta v2 on top of it, written by the port."""
    import torch

    from repro_torch.core import rtlda

    rng = np.random.default_rng(3)
    phi = torch.from_numpy(rng.integers(0, 20, (40, 6)).astype(np.int32))
    m1 = rtlda.build_model(phi, torch.tensor(0.01), torch.full((6,), 0.5), device="cpu")
    phi2 = phi.clone()
    phi2[5] += 3
    m2 = rtlda.build_model(phi2, torch.tensor(0.01), torch.full((6,), 0.5), device="cpu")
    tsnapshots.save_snapshot(root, 1, m1)
    tsnapshots.save_delta_snapshot(root, 2, m2, base_version=1, base_pvk=m1.pvk)


def test_snapshot_load_seam_fires_where_jax_does(tmp_path):
    root = str(tmp_path / "snaps")
    _publish_chain(root)
    loads = {"jax": lambda v: jsnapshots.load_snapshot(root, v),
             "port": lambda v: tsnapshots.load_snapshot(root, v, device="cpu")}
    counts = {}
    for name, faults in PKGS.items():
        plane = faults.FaultPlane()
        with faults.injected(plane):
            loads[name](2)             # the delta walks to its base: two hits
            loads[name](None)          # the latest (2) again
            loads[name](1)
        counts[name] = [plane.hits("snapshot.load", k) for k in ("1", "2")]
        # a failing first read surfaces as the OSError subclass, then recovers
        plane = faults.FaultPlane().fail("snapshot.load", key="1", nth=1)
        with faults.injected(plane):
            with pytest.raises(faults.FaultInjected):
                loads[name](2)
            model, meta = loads[name](2)
            assert meta["version"] == 2
            assert plane.injected("snapshot.load") == 1
    assert counts["port"] == counts["jax"] == [3, 2]


@pytest.mark.parametrize("path", ["src/repro_torch/reliability/faults.py",
                                  "src/repro_torch/data/stream.py"])
def test_concurrency_analyzer_accepts_the_ported_modules(path):
    from repro.analysis import concurrency as cc, report

    with open(os.path.join(REPO, path)) as f:
        src = f.read()
    errs = [f for f in cc.analyze_source(src, os.path.basename(path))
            if f.severity == report.ERROR]
    assert errs == [], [f.message for f in errs]
    if path.endswith("faults.py"):
        # and still catches a racy write to a guarded field
        mutated = src.replace(
            "    def release(self) -> None:",
            "    def _racy(self) -> None:\n"
            "        self._released = True\n\n"
            "    def release(self) -> None:")
        errs = [f for f in cc.analyze_source(mutated, "faults.py")
                if f.severity == report.ERROR]
        assert errs and any("_released" in f.message for f in errs)
