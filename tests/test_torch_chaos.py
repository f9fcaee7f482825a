"""Port conformance of the self-healing fleet under injected faults, and of
the circuit breaker and the snapshot watcher, against ``repro.serving`` (the
scenarios of ``tests/test_chaos.py`` and the breaker and watcher cases of
``tests/test_reliability.py``).

Each side gets its own package's ``FaultPlane`` with the same schedule, the
same fake clock and the same submits; breakers, routing, retries, hedges,
probes and the deterministic storm's counts must come out equal. Injected
failures are compared by exception name (the packages' ``FaultInjected``
classes differ).
"""
import os
import tempfile
import threading

import numpy as np
import pytest

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from test_torch_serving import JAX, PORT, V, FakeClock, both, outcome, same

pytestmark = [pytest.mark.port, pytest.mark.chaos]


def _fleet(S, clock=None, n=2, model=None, **kw):
    """Named fake-clock replicas (seam keys = engine names)."""
    clock = clock or FakeClock()
    model = model if model is not None else S.model(0)
    engines = [S.serving.TopicEngine(model, buckets=(4, 8, 16), max_batch=4,
                                     n_iters=2, n_trials=1, top_n=3, clock=clock,
                                     start=False, name=f"replica{i}")
               for i in range(n)]
    kw.setdefault("cache_mb", 0.0)
    kw.setdefault("shed", False)
    kw.setdefault("breaker_backoff_ms", 200.0)
    return S.serving.TopicFleet(engines=engines, clock=clock, **kw)


def _q(rng, n=3):
    return rng.integers(0, V, size=n).astype(np.int32)


def _drain(fleet, futs, rounds=4):
    for _ in range(rounds):
        fleet.flush_all()
        if all(f.done() for f in futs):
            return
    raise AssertionError("futures still pending after bounded drain")


def _corrupt(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        block = f.read(8)
        f.seek(-len(block), os.SEEK_CUR)
        f.write(bytes(b ^ 0xFF for b in block))


# --------------------------------------------------------- hedged retries --

def sc_retry_elsewhere(S):
    fleet = _fleet(S, FakeClock(), breaker_threshold=3)
    rng = np.random.default_rng(0)
    plane = S.faults.FaultPlane().fail("engine.infer", key="replica0", nth=1)
    with S.faults.injected(plane):
        fut = fleet.submit(_q(rng))
        _drain(fleet, [fut])
    r = fut.result()
    assert r.attempts == 2 and not r.hedged
    st = fleet.stats()
    assert st.retries == 1 and st.failed == 0 and st.routed == (1, 1)
    fleet.close()
    return r, st


def sc_breaker_skips_sick(S):
    fleet = _fleet(S, FakeClock(), breaker_threshold=1)
    rng = np.random.default_rng(1)
    plane = S.faults.FaultPlane().fail("engine.infer", key="replica0")
    with S.faults.injected(plane):
        fut = fleet.submit(_q(rng))
        _drain(fleet, [fut])
        assert fut.result().attempts == 2
        assert fleet.stats().breakers[0]["state"] == S.health.OPEN
        futs = [fleet.submit(_q(rng)) for _ in range(6)]
        _drain(fleet, futs)
    assert all(f.result().attempts == 1 for f in futs)
    assert fleet.stats().routed == (1, 7)
    fleet.close()
    return fut.result(), [f.result() for f in futs], fleet.stats()


def sc_all_open_then_recover(S):
    clock = FakeClock()
    fleet = _fleet(S, clock, breaker_threshold=1)
    rng = np.random.default_rng(2)
    plane = S.faults.FaultPlane().fail("engine.infer")
    with S.faults.injected(plane):
        fut = fleet.submit(_q(rng))
        _drain(fleet, [fut])
        failed = outcome(fut)
        assert failed == "FaultInjected"
        st = fleet.stats()
        assert st.failed == 1 and all(b["state"] == S.health.OPEN for b in st.breakers)
        shed = fleet.submit(_q(rng)).result()
        assert shed.reason == "unhealthy" and shed.retry_after_ms > 0
        plane.clear()
        clock.advance_ms(300.0)
        fut2 = fleet.submit(_q(rng))
        _drain(fleet, [fut2])
    assert fleet.stats().breakers[0]["state"] == S.health.CLOSED
    fleet.close()
    return failed, st, shed, fut2.result(), fleet.stats()


def sc_probe_hedged(S):
    clock = FakeClock()
    fleet = _fleet(S, clock, breaker_threshold=1)
    rng = np.random.default_rng(3)
    plane = S.faults.FaultPlane().fail("engine.infer", key="replica0")
    with S.faults.injected(plane):
        fut = fleet.submit(_q(rng))
        _drain(fleet, [fut])
        plane.clear()
        clock.advance_ms(300.0)
        fut2 = fleet.submit(_q(rng))
        _drain(fleet, [fut2])
    r = fut2.result()
    assert r.attempts == 2 and r.hedged
    fut3 = fleet.submit(_q(rng))
    _drain(fleet, [fut3])
    assert fleet.stats().routed[0] >= 2
    fleet.close()
    return fut.result(), r, fut3.result(), fleet.stats()


def sc_live_version_excludes_tripped(S):
    clock = FakeClock()
    fleet = _fleet(S, clock, breaker_threshold=1, cache_mb=1.0)
    rng = np.random.default_rng(4)
    plane = S.faults.FaultPlane().fail("engine.infer", key="replica0")
    with S.faults.injected(plane):
        fut = fleet.submit(_q(rng))
        _drain(fleet, [fut])
        assert 0 in fleet._unhealthy
        fleet.engines[1].swap_model(S.model(9), version=1)
        live = [fleet.live_version()]
        plane.clear()
        clock.advance_ms(300.0)
        fut2 = fleet.submit(_q(rng))
        _drain(fleet, [fut2])
    live.append(fleet.live_version())
    assert live == [1, 0] and 0 not in fleet._unhealthy
    fleet.close()
    return live, fut.result(), fut2.result(), fleet.stats()


@pytest.mark.parametrize("scenario", [sc_retry_elsewhere, sc_breaker_skips_sick,
                                      sc_all_open_then_recover, sc_probe_hedged,
                                      sc_live_version_excludes_tripped],
                         ids=lambda f: f.__name__[3:])
def test_self_healing_fleet(scenario):
    same(*both(scenario))


# ------------------------------------------------------- routing hot path --

def sc_zero_route_state_hops(S):
    fleet = _fleet(S, FakeClock(), n=16)
    calls = {"n": 0}
    for eng in fleet.engines:
        orig = eng.route_state

        def counted(orig=orig):
            calls["n"] += 1
            return orig()

        eng.route_state = counted
    rng = np.random.default_rng(5)
    futs = [fleet.submit(_q(rng)) for _ in range(32)]
    at_submit = calls["n"]
    _drain(fleet, futs)
    assert at_submit == 0 and calls["n"] > 0
    fleet.close()
    return at_submit, calls["n"], [f.result() for f in futs], fleet.stats()


def test_submit_costs_zero_route_state_hops_with_fresh_views():
    same(*both(sc_zero_route_state_hops))


def sc_swap_racing_half_open(S):
    clock = FakeClock()
    fleet = _fleet(S, clock, breaker_threshold=1, cache_mb=1.0)
    b0 = fleet.breakers[0]
    b0.record_failure()
    fleet._sync_health(0)
    clock.advance_ms(300.0)
    fleet.swap_model(S.model(9), version=1)
    seen = [fleet.live_version(), b0.allow()]
    fleet._sync_health(0)
    seen.append(fleet.live_version())
    b0.record_success()
    fleet._sync_health(0)
    seen += [0 in fleet._unhealthy, fleet.live_version()]
    assert seen == [1, True, 1, False, 1]
    for round_no in range(2, 22):             # true-thread race
        b0.record_failure()
        fleet._sync_health(0)
        clock.advance_ms(500.0)
        barrier = threading.Barrier(2)

        def _swap(v=round_no):
            barrier.wait(timeout=10)
            fleet.swap_model(S.model(9), version=v)

        def _recover():
            barrier.wait(timeout=10)
            b0.allow()
            b0.record_success()
            fleet._sync_health(0)

        ts = [threading.Thread(target=_swap), threading.Thread(target=_recover)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in ts)
        assert b0.snapshot()["state"] == S.health.CLOSED
        assert 0 not in fleet._unhealthy and fleet.live_version() == round_no
    fleet.close()
    return seen, b0.snapshot()["state"], fleet.live_version()


def test_hot_swap_racing_open_to_half_open_transition():
    same(*both(sc_swap_racing_half_open))


# --------------------------------------------------- the acceptance storm --

def _storm(S, seed):
    """Fleet of 4, Zipf load, replica1 dies mid-run, a torn-write snapshot
    lands mid-rollout (``tests/test_chaos.py::_storm``)."""
    clock = FakeClock()
    model0 = S.model(0)
    rng = np.random.default_rng(seed)
    pool = [_q(rng, int(n)) for n in rng.integers(2, 11, size=160)]
    weights = 1.0 / np.arange(1, len(pool) + 1)
    weights /= weights.sum()
    with tempfile.TemporaryDirectory() as snap_dir:
        S.snapshots.save_snapshot(snap_dir, 0, model0, {"epoch": 1})
        engines = [S.serving.TopicEngine(model0, buckets=(4, 8, 16), max_batch=4,
                                         n_iters=2, n_trials=1, top_n=3, clock=clock,
                                         start=False, name=f"replica{i}")
                   for i in range(4)]
        fleet = S.serving.TopicFleet(engines=engines, clock=clock, cache_mb=1.0,
                                     shed=True, deadline_budget_ms=200.0,
                                     breaker_threshold=3, seed=seed)
        ws = fleet.attach_watchers(snap_dir, start=False)
        assert [w.poll() for w in ws] == [0] * 4
        plane = S.faults.FaultPlane(seed=seed)
        plane.fail("engine.infer", key="replica1", after=3)
        responses, rejects, errors = [], [], []
        with S.faults.injected(plane):
            for group in range(10):
                futs = [fleet.submit(pool[rng.choice(len(pool), p=weights)],
                                     deadline_ms=200.0) for _ in range(12)]
                _drain(fleet, futs)
                for f in futs:
                    r = outcome(f)
                    if isinstance(r, str):
                        errors.append(r)
                    elif isinstance(r, S.serving.ShedResponse):
                        rejects.append(r)
                    else:
                        responses.append(r)
                if group == 5:
                    p = S.snapshots.save_snapshot(snap_dir, 1, S.model(5), {"epoch": 2})
                    _corrupt(os.path.join(p, S.io.PAYLOAD))
                    for w in ws:
                        w.poll()
                    assert fleet.live_version() == 0
                if group == 7:
                    S.snapshots.save_snapshot(snap_dir, 2, S.model(6), {"epoch": 3})
                    for w in ws:
                        w.poll()
        st = fleet.stats()
        assert len(responses) + len(rejects) + len(errors) == 120
        assert len(responses) >= 0.75 * 120 and errors == []
        assert all(r.model_version in (0, 2) for r in responses)
        assert any(r.attempts == 2 for r in responses)
        assert st.breakers[1]["trips"] >= 1
        assert sum(w.quarantined for w in ws) == 1
        assert S.snapshots.snapshot_versions(snap_dir) == [0, 2]
        assert os.path.isdir(S.snapshots.snapshot_path(snap_dir, 1) + ".corrupt")
        assert all(eng.model_version == 2 for eng in fleet.engines)
        summary = (len(responses), len(rejects), st.retries, st.hedges, st.failed,
                   tuple(st.routed), st.breakers[1]["trips"],
                   tuple(sorted({r.model_version for r in responses})))
        fleet.close()
        return summary, responses, rejects, st


def test_chaos_storm_matches_jax_and_is_deterministic():
    """The storm's counts (and every response) equal JAX's, and the port
    takes the identical path twice with one seed."""
    j, t = both(_storm, 7)
    same(j, t)
    assert _storm(PORT, 7)[0] == t[0]


# ------------------------------------------------- breaker (reliability) --

def _breaker(S, clock, **kw):
    kw.setdefault("failure_threshold", 3)
    kw.setdefault("backoff_ms", 200.0)
    kw.setdefault("probe_timeout_ms", 1000.0)
    return S.health.CircuitBreaker(clock=clock, **kw)


def sc_trips_on_consecutive(S):
    b = _breaker(S, FakeClock())
    for ok in (False, False, True, False, False):
        b.record_success() if ok else b.record_failure()
    seen = [b.state(), b.allow()]
    b.record_failure()
    seen += [b.state(), b.allow(), b.snapshot()]
    assert seen[:4] == [S.health.CLOSED, True, S.health.OPEN, False]
    return seen


def sc_jittered_backoff(S):
    def reopen(seed):
        b = _breaker(S, FakeClock(), seed=seed)
        for _ in range(3):
            b.record_failure()
        return b.snapshot()["reopen_at"]

    got = [reopen(5), reopen(5), reopen(6)]
    assert got[0] == got[1] != got[2] and 0.200 <= got[0] < 0.240
    return got


def sc_half_open_one_probe(S):
    clock = FakeClock()
    b = _breaker(S, clock)
    for _ in range(3):
        b.record_failure()
    seen = [b.allow()]
    clock.advance_ms(300.0)
    seen += [b.state(), b.allow(), b.allow()]
    clock.advance_ms(1000.0)
    seen += [b.allow(), b.snapshot()]
    assert seen[:5] == [False, S.health.HALF_OPEN, True, False, True]
    return seen


def sc_ladder(S):
    clock = FakeClock()
    b = _breaker(S, clock, jitter=0.0)
    for _ in range(3):
        b.record_failure()
    d1 = b.snapshot()["reopen_at"] - clock()
    clock.advance_ms(d1 * 1e3 + 1.0)
    assert b.allow()
    b.record_failure()
    d2 = b.snapshot()["reopen_at"] - clock()
    clock.advance_ms(d2 * 1e3 + 1.0)
    assert b.allow()
    b.record_success()
    closed = b.snapshot()
    for _ in range(3):
        b.record_failure()
    d3 = b.snapshot()["reopen_at"] - clock()
    assert d2 == pytest.approx(2 * d1) and d3 == pytest.approx(d1)
    return d1, d2, closed, d3


def sc_blowouts(S):
    b = _breaker(S, FakeClock(), failure_threshold=1, blowout_factor=3.0)
    seen = []
    for latency, deadline in ((120.0, 50.0), (400.0, None), (151.0, 50.0)):
        b.record_response(latency, deadline)
        seen.append(b.state())
    assert seen == [S.health.CLOSED, S.health.CLOSED, S.health.OPEN]
    return seen


@pytest.mark.parametrize("scenario", [sc_trips_on_consecutive, sc_jittered_backoff,
                                      sc_half_open_one_probe, sc_ladder, sc_blowouts],
                         ids=lambda f: f.__name__[3:])
def test_circuit_breaker(scenario):
    same(*both(scenario))


# ------------------------------------------------ watcher (reliability) --

class _EngineStub:
    """Just enough engine for a SnapshotWatcher: records swaps."""

    device = "cpu"               # where the port's watcher loads snapshots

    def __init__(self):
        self.model_version = None
        self.swaps = []

    def swap_model(self, model, version=None):
        self.model_version = version
        self.swaps.append(version)


def sc_watcher_quarantine(S, d):
    S.snapshots.save_snapshot(d, 0, S.model(0))
    S.snapshots.save_snapshot(d, 1, S.model(1))
    _corrupt(os.path.join(S.snapshots.snapshot_path(d, 1), S.io.PAYLOAD))
    eng = _EngineStub()
    w = S.serving.SnapshotWatcher(d, eng, poll_s=0.01)
    seen = [w.poll(), eng.model_version, w.quarantined,
            S.snapshots.snapshot_versions(d),
            os.path.isdir(S.snapshots.snapshot_path(d, 1) + ".corrupt")]
    S.snapshots.save_snapshot(d, 2, S.model(2))
    seen += [w.poll(), eng.model_version, w.poll_failures, w.quarantined, eng.swaps]
    assert seen == [0, 0, 1, [0], True, 2, 2, 0, 1, [0, 2]]
    return seen


def sc_watcher_backoff(S, d):
    S.snapshots.save_snapshot(d, 0, S.model(0))
    w = S.serving.SnapshotWatcher(d, _EngineStub(), poll_s=0.5, max_backoff_s=4.0)
    seen = [w.backoff_s()]
    with S.faults.injected(S.faults.FaultPlane().fail("watcher.poll")):
        for _ in range(4):
            seen += [w.poll(), w.backoff_s()]
        seen += [w.poll_failures, type(w.last_error).__name__]
    seen += [w.poll(), w.poll_failures, w.backoff_s()]
    assert seen == [0.5, None, 1.0, None, 2.0, None, 4.0, None, 4.0, 4,
                    "FaultInjected", 0, 0, 0.5]
    return seen


@pytest.mark.parametrize("scenario", [sc_watcher_quarantine, sc_watcher_backoff],
                         ids=lambda f: f.__name__[3:])
def test_snapshot_watcher(scenario, tmp_path):
    same(scenario(JAX, str(tmp_path / "jax")), scenario(PORT, str(tmp_path / "port")))


def test_watcher_loads_onto_the_engines_device(tmp_path, monkeypatch):
    """The port's watcher asks for its engine's device, never a default."""
    from repro_torch.serving import watcher as twatcher

    d = str(tmp_path)
    PORT.snapshots.save_snapshot(d, 0, PORT.model(0))
    seen = []
    real = twatcher.snapshots.load_snapshot

    def spy(root, version=None, device="cuda"):
        seen.append(device)
        return real(root, version, device=device)

    monkeypatch.setattr(twatcher.snapshots, "load_snapshot", spy)
    eng = PORT.serving.TopicEngine(PORT.model(0), buckets=(4,), start=False)
    assert PORT.serving.SnapshotWatcher(d, eng).poll() == 0
    assert [str(x) for x in seen] == ["cpu"]
