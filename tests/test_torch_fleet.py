"""Port conformance of ``repro_torch.serving``'s fleet, result cache and
snapshot fan-out against ``repro.serving`` (the scenarios of
``tests/test_fleet.py``).

Each scenario runs on both packages with the same fake clock, replicas built
``start=False`` and driven by ``pump()``/``flush_all()``, so every routing,
shedding and cache decision is the same; the observations (responses, shed
responses, ``FleetStats`` with every counter, cache stats) are held together
by ``test_torch_serving.same``. The watcher fan-out uses real threads and
compares versions and counts. The analyzer cases strip a real guard from the
port's own ``fleet.py`` and ``cache.py``.
"""
import os
import tempfile
import textwrap

import numpy as np
import pytest

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro.analysis import concurrency as cc
from repro.analysis import report
from test_torch_serving import K, V, FakeClock, both, same

pytestmark = [pytest.mark.port, pytest.mark.fleet]

SERVING = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "src", "repro_torch", "serving")


def _fleet(S, clock=None, n=2, model=None, **kw):
    clock = clock or FakeClock()
    model = model if model is not None else S.model(0)
    engines = [S.serving.TopicEngine(model, buckets=(4, 8, 16), max_batch=4,
                                     n_iters=2, n_trials=1, top_n=3,
                                     clock=clock, start=False)
               for _ in range(n)]
    kw.setdefault("cache_mb", 1.0)
    kw.setdefault("deadline_budget_ms", 50.0)
    return S.serving.TopicFleet(engines=engines, clock=clock, **kw)


def _q(rng, n=3):
    return rng.integers(0, V, size=n).astype(np.int32)


# ------------------------------------------------------------------ routing

def sc_top_off_then_spill(S):
    fleet = _fleet(S, cache_mb=0.0, shed=False)
    rng = np.random.default_rng(0)
    futs = [fleet.submit(_q(rng)) for _ in range(8)]
    seen = [fleet.stats().routed,
            tuple(e.route_state()[4][0] for e in fleet.engines)]
    futs.append(fleet.submit(_q(rng)))
    seen.append(fleet.stats().routed)
    assert seen == [(4, 4), (4, 4), (5, 4)]
    fleet.flush_all()
    out = [f.result(timeout=10) for f in futs]
    fleet.close()
    return seen, out, fleet.stats()


def sc_emptier_replica(S):
    fleet = _fleet(S, cache_mb=0.0, shed=False)
    rng = np.random.default_rng(1)
    for _ in range(8):
        fleet.engines[0].submit(_q(rng))
    fleet.refresh_routing()
    f = fleet.submit(_q(rng))
    assert fleet.stats().routed == (0, 1)
    fleet.flush_all()
    out = f.result(timeout=10)
    fleet.close()
    return out, fleet.stats()


@pytest.mark.parametrize("scenario", [sc_top_off_then_spill, sc_emptier_replica],
                         ids=lambda f: f.__name__[3:])
def test_routing(scenario):
    same(*both(scenario))


# -------------------------------------------------------- admission control

def sc_shed_with_probes(S):
    clock = FakeClock()
    fleet = _fleet(S, clock, cache_mb=0.0, deadline_budget_ms=50.0, probe_every=4)
    rng = np.random.default_rng(2)
    futs = [fleet.submit(_q(rng)) for _ in range(32)]
    clock.advance_ms(100.0)
    fleet.flush_all()
    served = [f.result(timeout=10) for f in futs]
    st = fleet.stats()
    assert st.shedding and st.p99_est_ms > 50.0
    sheds = []
    for _ in range(8):
        fut = fleet.submit(_q(rng))
        assert fut.done()
        sheds.append(fut.result())
    assert fleet.stats().probes == 2
    last = fleet.submit(_q(rng)).result()
    assert last.reason == "p99-slack" and last.retry_after_ms > 0
    out = (served, st, sheds, last, fleet.stats())
    fleet.close()
    return out


def sc_hysteresis(S):
    fleet = _fleet(S, cache_mb=0.0, deadline_budget_ms=50.0, shed_hysteresis=0.25)
    states = []
    with fleet._lock:
        for p99 in (49.0, 51.0, 45.0, 49.0, 37.0):
            fleet._update_shed_state(p99)
            states.append(fleet._shedding)
    assert states == [False, True, True, True, False]
    fleet.close()
    return states


def sc_shed_recovery(S):
    clock = FakeClock()
    fleet = _fleet(S, clock, cache_mb=0.0, deadline_budget_ms=50.0, probe_every=2)
    rng = np.random.default_rng(3)
    futs = [fleet.submit(_q(rng)) for _ in range(32)]
    clock.advance_ms(100.0)
    fleet.flush_all()
    for f in futs:
        f.result(timeout=10)
    assert fleet.stats().shedding
    fleet.reset_stats()
    seen = []
    for _ in range(6):
        fut = fleet.submit(_q(rng))
        fleet.flush_all()
        seen.append(fut.result(timeout=10))
    st = fleet.stats()
    assert not st.shedding and st.probes >= 1
    fut = fleet.submit(_q(rng))
    assert not fut.done()
    fleet.flush_all()
    seen.append(fut.result(timeout=10))
    fleet.close()
    return seen, st, fleet.stats()


@pytest.mark.parametrize("scenario", [sc_shed_with_probes, sc_hysteresis,
                                      sc_shed_recovery],
                         ids=lambda f: f.__name__[3:])
def test_admission_control(scenario):
    same(*both(scenario))


def sc_breakers_trip_while_shedding(S):
    """A shedding fleet whose replicas answer at 4× the 50 ms deadline
    (each response a blowout, over blowout_factor 3 × the deadline): both
    breakers trip open while the fleet sheds, read half open once their
    backoff ends, and the first recovery probe closes one of them; the
    other is still half open when the trace ends, the fleet still
    shedding. No request fails and none is retried."""
    clock = FakeClock()
    fleet = _fleet(S, clock, cache_mb=0.0, deadline_budget_ms=50.0, probe_every=4)
    rng = np.random.default_rng(6)
    futs = [fleet.submit(_q(rng), deadline_ms=50.0) for _ in range(32)]
    clock.advance_ms(200.0)
    fleet.flush_all()
    served = [f.result(timeout=10) for f in futs]
    tripped = fleet.stats()
    assert tripped.shedding and tripped.p99_est_ms == 200.0
    assert [(b["state"], b["trips"]) for b in tripped.breakers] == [("open", 1)] * 2
    clock.advance_ms(100.0)
    shed = [fleet.submit(_q(rng), deadline_ms=50.0).result() for _ in range(4)]
    assert all(r.reason == "p99-slack" for r in shed)
    clock.advance_ms(300.0)                  # past each breaker's jittered backoff
    expired = fleet.stats()
    assert [b["state"] for b in expired.breakers] == ["half_open"] * 2
    later = []
    for _ in range(6):
        fut = fleet.submit(_q(rng), deadline_ms=50.0)
        fleet.flush_all()
        later.append(fut.result(timeout=10))
    end = fleet.stats()
    assert end.shedding and end.probes == 1
    assert [b["state"] for b in end.breakers] == ["closed", "half_open"]
    assert end.failed == 0 and end.retries == 0
    fleet.close()
    return served, tripped, shed, expired, later, end


def test_shedding_fleet_breakers_trip_on_blowouts():
    """JAX's breaker semantics (``serving/health.py``): a response slower
    than blowout_factor × its deadline counts as a failure and three in a
    row trip the breaker, shedding or not; so a shedding fleet can end a
    run with a breaker half open, as the port's fleet did on the card with
    its p99 at 216.9–259.5 ms against a 50 ms deadline. The port's fleet
    walks the same states on the same trace."""
    same(*both(sc_breakers_trip_while_shedding))


# ------------------------------------------------------------------- cache

def sc_cache_hit(S):
    fleet = _fleet(S, shed=False)
    q = _q(np.random.default_rng(4))
    f1 = fleet.submit(q)
    fleet.flush_all()
    r1 = f1.result(timeout=10)
    f2 = fleet.submit(q)
    assert f2.done() and f2.result().cached and not r1.cached
    np.testing.assert_array_equal(f2.result().pkd, r1.pkd)
    fleet.close()
    return r1, f2.result(), fleet.stats()


def sc_cache_invalidated(S):
    fleet = _fleet(S, shed=False)
    q = _q(np.random.default_rng(5))
    f1 = fleet.submit(q)
    fleet.flush_all()
    fleet.swap_model(S.model(9), version=1)
    assert fleet.live_version() == 1
    f2 = fleet.submit(q)
    assert not f2.done()
    fleet.flush_all()
    assert fleet.cache.stats()["stale_drops"] >= 1
    fleet.close()
    return f1.result(timeout=10), f2.result(timeout=10), fleet.stats()


def sc_cache_diverging_replicas(S):
    fleet = _fleet(S, shed=False)
    rng = np.random.default_rng(6)
    q, q2 = _q(rng), _q(rng, 5)
    seen = []
    f1 = fleet.submit(q)
    fleet.flush_all()
    seen.append(f1.result(timeout=10))
    fleet.engines[0].swap_model(S.model(9), version=1)
    assert fleet.live_version() == 0
    f2 = fleet.submit(q)
    assert f2.done()
    seen.append(f2.result())
    f3 = fleet.submit(q2)
    fleet.flush_all()
    seen.append(f3.result(timeout=10))
    if seen[-1].model_version == 1:
        f3b = fleet.submit(q2)
        assert not f3b.done()
        fleet.flush_all()
        seen.append(f3b.result(timeout=10))
    fleet.engines[1].swap_model(S.model(9), version=1)
    f4 = fleet.submit(q)
    assert not f4.done()
    fleet.flush_all()
    seen.append(f4.result(timeout=10))
    f5 = fleet.submit(q)
    assert f5.done() and f5.result().cached
    seen.append(f5.result())
    fleet.close()
    return seen, fleet.stats()


def sc_slru(S):
    cache = S.serving.ResultCache(capacity_mb=0.01, protected_frac=0.5)
    pkd = np.full((K,), 1.0 / K, np.float32)
    ids, w = np.arange(3, dtype=np.int32), np.ones(3, np.float32)
    cache.put((b"hot", 4), 0, pkd, ids, w, 4)
    hits = [cache.get((b"hot", 4), 0) is not None]
    for i in range(200):
        cache.put((f"scan{i}".encode(), 4), 0, pkd, ids, w, 4)
    hits.append(cache.get((b"hot", 4), 0) is not None)
    assert hits == [True, True]
    return hits, cache.stats()


def sc_unknown_version(S):
    cache = S.serving.ResultCache(capacity_mb=1.0)
    pkd = np.full((K,), 1.0 / K, np.float32)
    ids, w = np.arange(3, dtype=np.int32), np.ones(3, np.float32)
    admitted = [cache.put((b"x", 4), None, pkd, ids, w, 4),
                cache.put((b"x", 4), 3, pkd, ids, w, 4)]
    got = [cache.get((b"x", 4), None), cache.get((b"x", 4), 3)]
    assert admitted == [False, True] and got == [None, None]
    return admitted, cache.stats()


@pytest.mark.parametrize("scenario", [sc_cache_hit, sc_cache_invalidated,
                                      sc_cache_diverging_replicas, sc_slru,
                                      sc_unknown_version],
                         ids=lambda f: f.__name__[3:])
def test_result_cache(scenario):
    same(*both(scenario))


# ------------------------------------------------- swap racing flush (fleet)

def sc_swap_racing_flush(S):
    fleet = _fleet(S, shed=False)
    rng = np.random.default_rng(7)
    qs = [_q(rng, n) for n in (2, 3, 5, 9)]
    futs = [fleet.submit(q) for q in qs]
    fleet.swap_model(S.model(9), version=1)
    fleet.flush_all()
    out = [f.result(timeout=10) for f in futs]
    assert all(r.model_version == 1 for r in out)
    f = fleet.submit(qs[0])
    assert f.done() and f.result().model_version == 1
    fleet.close()
    return out, f.result(), fleet.stats()


def test_swap_racing_flush_at_fleet_scope():
    same(*both(sc_swap_racing_flush))


def sc_watcher_fanout(S):
    """Real threads: per-replica watchers on one snapshot directory."""
    with tempfile.TemporaryDirectory() as snap_dir:
        S.snapshots.save_snapshot(snap_dir, 0, S.model(0), {"epoch": 1})
        fleet = S.serving.TopicFleet(S.model(0), n_replicas=2, buckets=(4, 8, 16),
                                     max_batch=4, n_iters=2, n_trials=1, top_n=3,
                                     cache_mb=1.0, shed=False)
        try:
            fleet.attach_watchers(snap_dir, poll_s=0.05)
            assert fleet.wait_for_version(0, timeout_s=10)
            rng = np.random.default_rng(8)
            out0 = fleet.infer([_q(rng) for _ in range(8)])
            S.snapshots.save_snapshot(snap_dir, 1, S.model(9), {"epoch": 2})
            assert fleet.wait_for_version(1, timeout_s=10)
            out1 = fleet.infer([_q(rng) for _ in range(8)])
            st = fleet.stats()
        finally:
            fleet.close()
    return ([r.model_version for r in out0], [r.model_version for r in out1],
            st.completed, fleet.live_version())


def test_watcher_fanout_hot_swap_over_live_fleet():
    j, t = both(sc_watcher_fanout)
    assert t == j == ([0] * 8, [1] * 8, 16, 1)


# ----------------------------------------------------- delta snapshot path

def sc_delta_roundtrip(S):
    with tempfile.TemporaryDirectory() as d:
        m0 = S.model(0)
        S.snapshots.save_snapshot(d, 0, m0, {"epoch": 1})
        pvk1 = S.pvk(m0).copy()
        pvk1[[2, 7]] += 1
        S.snapshots.save_delta_snapshot(d, 1, S.with_pvk(m0, pvk1), 0, m0.pvk,
                                        {"epoch": 2})
        meta = S.snapshots.read_meta(d, 1)
        loaded, _ = S.snapshots.load_snapshot(d, 1, **_device(S))
        np.testing.assert_array_equal(S.pvk(loaded), pvk1)
        dropped = S.snapshots.rotate_snapshots(d, 1)
        versions = S.snapshots.snapshot_versions(d)
        with pytest.raises(ValueError):
            S.snapshots.save_delta_snapshot(
                d, 2, S.with_pvk(m0, np.zeros((V, K + 1), np.float32)), 1, pvk1)
    return meta, dropped, versions


def sc_watcher_delta(S):
    with tempfile.TemporaryDirectory() as d:
        m0 = S.model(0)
        S.snapshots.save_snapshot(d, 0, m0, {"epoch": 1})
        pvk1 = S.pvk(m0).copy()
        pvk1[[1, 3]] += 2
        eng = S.serving.TopicEngine(m0, buckets=(4, 8, 16), max_batch=4, n_iters=2,
                                    n_trials=1, top_n=3, clock=FakeClock(),
                                    start=False)
        w = S.serving.SnapshotWatcher(d, eng, poll_s=0.01)
        polls = [w.poll()]
        S.snapshots.save_delta_snapshot(d, 1, S.with_pvk(m0, pvk1), 0, m0.pvk,
                                        {"epoch": 2})
        polls.append(w.poll())
        assert polls == [0, 1] and eng.model_version == 1
        np.testing.assert_array_equal(S.pvk(eng._model_ref[0]), pvk1)
        return polls, eng.infer([[1, 2, 3], [4, 5]])


def _device(S):
    return {} if S.name == "jax" else {"device": "cpu"}


@pytest.mark.parametrize("scenario", [sc_delta_roundtrip, sc_watcher_delta],
                         ids=lambda f: f.__name__[3:])
def test_delta_snapshots(scenario):
    same(*both(scenario))


# -------------------------------------------- concurrency contract mutation

def test_analyzer_catches_unguarded_fleet_counter_in_the_port():
    with open(os.path.join(SERVING, "fleet.py")) as f:
        src = f.read()
    guarded = "with self._lock:\n            self._routed[idx] += 1"
    assert guarded in src, "fleet.py routing counter changed; update test"
    assert [f for f in cc.analyze_source(src, "fleet.py")
            if f.severity == report.ERROR] == []
    errs = [f for f in cc.analyze_source(src.replace(guarded, "self._routed[idx] += 1"),
                                         "fleet.py") if f.severity == report.ERROR]
    assert any("_routed" in f.message for f in errs)


def test_analyzer_catches_unguarded_cache_counter_in_the_port():
    with open(os.path.join(SERVING, "cache.py")) as f:
        src = f.read()
    mutated = src.replace(
        "    def clear(self) -> None:",
        "    def _racy_bump(self) -> None:\n        self._hits += 1\n\n"
        "    def clear(self) -> None:")
    assert mutated != src
    errs = [f for f in cc.analyze_source(mutated, "cache.py")
            if f.severity == report.ERROR]
    assert any("_hits" in f.message for f in errs)


def test_analyzer_catches_an_unguarded_engine_field_in_the_port():
    """The port engine as shipped is clean; a batching-thread field written
    outside ``_cv`` is refused."""
    with open(os.path.join(SERVING, "engine.py")) as f:
        src = f.read()
    assert [f for f in cc.analyze_source(src, "engine.py")
            if f.severity == report.ERROR] == []
    mutated = src.replace(
        "    def flush_all(self) -> int:",
        textwrap.indent(textwrap.dedent('''\
            def _racy_seed(self) -> None:
                self._seed += 1

            '''), "    ") + "    def flush_all(self) -> int:")
    assert mutated != src
    errs = [f for f in cc.analyze_source(mutated, "engine.py")
            if f.severity == report.ERROR]
    assert any("_seed" in f.message for f in errs)
