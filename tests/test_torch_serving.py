"""Port conformance of ``repro_torch.serving``'s engine and sync server against
``repro.serving`` (the scenarios of ``tests/test_engine.py`` and
``tests/test_server.py``), and of ``python -m repro_torch.launch.serve``.

Every scenario runs twice on the same numpy inputs: on the JAX package's
classes and on the port's. The port's model comes from the JAX model's leaves
through ``repro_torch.convert``; both sides get the same fake clock script,
the same submits and pumps, the same seeds. The observations are compared by
:func:`same`:

- ``pkd`` within rtol 1e-6, atol 1e-7 (the RT-LDA hill climb is exact; the
  final row sum runs in another order);
- feature ids equal except at tied weights, weights within rtol 1e-5 (the
  Eq. 5 product is an f32 GEMM in another order);
- ``bucket``, ``truncated``, ``model_version``, ``deadline_missed``,
  latencies and every ``stats()`` counter equal.

The other serving test files import these helpers. The card case (engine vs
``make_serving_fn`` bit for bit, the stream and the swap) is in
``tests/test_torch_serving_card.py``, which imports no jax.
"""
import dataclasses
import functools
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro import serving as jserving
from repro.checkpoint import io as jio, snapshots as jsnapshots
from repro.core import rtlda as jrtlda
from repro.launch import serve as jlaunch
from repro.reliability import faults as jfaults
from repro.serving import health as jhealth
from repro_torch import convert, serving as tserving
from repro_torch.checkpoint import io as tio, snapshots as tsnapshots
from repro_torch.core import rtlda as trtlda
from repro_torch.launch import serve as tlaunch
from repro_torch.reliability import faults as tfaults
from repro_torch.serving import health as thealth

pytestmark = [pytest.mark.port, pytest.mark.serve]

K, V = 6, 40


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance_ms(self, ms):
        self.t += ms / 1e3


def _phi(seed):
    return np.random.default_rng(seed).integers(0, 20, (V, K)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_model(seed):
    return jrtlda.build_model(jnp.asarray(_phi(seed)), jnp.float32(0.01),
                              jnp.full((K,), 0.5, jnp.float32))


@functools.lru_cache(maxsize=None)
def _port_model(seed):
    jm = _jax_model(seed)
    return convert.rtlda_model_from_numpy(*(np.asarray(x) for x in (
        jm.pvk, jm.alpha, jm.r_topic, jm.r_value)), device="cpu")


@dataclasses.dataclass(frozen=True)
class Side:
    """One package's serving stack, under the names the scenarios use."""

    name: str
    serving: object
    snapshots: object
    io: object
    faults: object
    health: object
    rtlda: object
    model: object            # seed -> RTLDAModel

    def with_pvk(self, model, pvk):
        """``model`` with its P̂ replaced by the numpy ``pvk``."""
        if self.name == "jax":
            return dataclasses.replace(model, pvk=jnp.asarray(pvk))
        return dataclasses.replace(model, pvk=torch.from_numpy(np.array(pvk)))

    def pvk(self, model):
        return np.asarray(model.pvk) if self.name == "jax" else model.pvk.numpy()


JAX = Side("jax", jserving, jsnapshots, jio, jfaults, jhealth, jrtlda, _jax_model)
PORT = Side("port", tserving, tsnapshots, tio, tfaults, thealth, trtlda, _port_model)


def both(scenario, *args, **kw):
    """``scenario(side, ...)`` on the JAX side, then on the port's."""
    return scenario(JAX, *args, **kw), scenario(PORT, *args, **kw)


def features_match(j_ids, j_w, t_ids, t_w, where):
    """Weights within rtol 1e-5; ids equal except where the JAX weight of the
    port's id (or, past the top-n, the last kept weight) ties the JAX weight
    at that position."""
    np.testing.assert_allclose(t_w, j_w, rtol=1e-5, atol=1e-7, err_msg=where)
    j_at = dict(zip(np.asarray(j_ids).tolist(), np.asarray(j_w).tolist()))
    for i in np.flatnonzero(np.asarray(j_ids) != np.asarray(t_ids)):
        ref = j_at.get(int(t_ids[i]), float(j_w[-1]))
        assert np.isclose(j_w[i], ref, rtol=1e-5, atol=1e-7), \
            f"{where}: id {t_ids[i]} at {i} (JAX {j_ids[i]}) is no tie"


_RESPONSE_EXACT = ("request_id", "bucket", "truncated", "latency_ms",
                   "deadline_missed", "model_version", "cached", "attempts",
                   "hedged")


def same(j, t, where="result"):
    """Hold the port's observation ``t`` against the JAX side's ``j``."""
    if isinstance(j, jserving.Response):
        assert isinstance(t, tserving.Response), f"{where}: {type(t)}"
        for f in _RESPONSE_EXACT:
            assert getattr(j, f) == getattr(t, f), \
                f"{where}.{f}: {getattr(j, f)} != {getattr(t, f)}"
        assert isinstance(t.pkd, np.ndarray) and t.pkd.dtype == np.float32
        np.testing.assert_allclose(t.pkd, np.asarray(j.pkd), rtol=1e-6,
                                   atol=1e-7, err_msg=where)
        features_match(j.feature_ids, j.feature_weights, t.feature_ids,
                       t.feature_weights, where)
    elif dataclasses.is_dataclass(j) and not isinstance(j, type):
        assert type(j).__name__ == type(t).__name__, f"{where}: {type(t)}"
        same(dataclasses.asdict(j), dataclasses.asdict(t), where)
    elif isinstance(j, dict):
        assert j.keys() == t.keys(), f"{where}: keys {j.keys()} != {t.keys()}"
        for k in j:
            same(j[k], t[k], f"{where}[{k!r}]")
    elif isinstance(j, (list, tuple)):
        assert len(j) == len(t), f"{where}: length {len(j)} != {len(t)}"
        for i, (a, b) in enumerate(zip(j, t)):
            same(a, b, f"{where}[{i}]")
    elif isinstance(j, np.ndarray) or hasattr(j, "__array__"):
        np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=1e-6,
                                   atol=1e-7, err_msg=where)
    else:
        assert j == t, f"{where}: {j!r} != {t!r}"


def counters(stats):
    """``stats`` without the fields a real clock sets (rates, percentiles)."""
    if stats is None:
        return None
    d = dataclasses.asdict(stats)
    for f in ("qps", "p50_ms", "p99_ms"):
        d.pop(f, None)
    return d


def outcome(fut):
    """A future's result, or the name of its exception (the two packages'
    exception classes differ; their names must not)."""
    exc = fut.exception(timeout=10)
    return type(exc).__name__ if exc is not None else fut.result()


def _engine(S, clock=None, **kw):
    kw.setdefault("buckets", (4, 8, 16))
    kw.setdefault("max_batch", 4)
    kw.setdefault("n_iters", 2)
    kw.setdefault("n_trials", 1)
    kw.setdefault("top_n", 3)
    return S.serving.TopicEngine(S.model(0), clock=clock or FakeClock(),
                                 start=False, **kw)


def _queries(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, size=n) for n in lengths]


# ------------------------------------------------------- bucket selection

def sc_bucket_selection(S):
    assert S.rtlda.select_bucket(3, (4, 8, 16)) == (4, False)
    assert S.rtlda.select_bucket(17, (4, 8, 16)) == (16, True)
    eng = _engine(S)
    out = eng.infer(_queries(0, [1, 4, 5, 9, 16, 30]))
    assert [r.bucket for r in out] == [4, 4, 8, 16, 16, 16]
    assert [r.truncated for r in out] == [False] * 6
    eng2 = _engine(S, chunk_long=False)
    (r30,) = eng2.infer(_queries(1, [30]))
    assert r30.bucket == 16 and r30.truncated
    return out, r30, eng.stats(), eng2.stats()


def test_bucket_selection_no_silent_truncation():
    same(*both(sc_bucket_selection))


# ------------------------------------------------- deadline-aware flushing

def sc_partial_flush(S):
    clock = FakeClock()
    eng = _engine(S, clock, max_delay_ms=5.0)
    f1, f2 = eng.submit([1, 2]), eng.submit([3])
    pumps = [eng.pump()]
    clock.advance_ms(4.9)
    pumps.append(eng.pump())
    clock.advance_ms(0.2)
    pumps.append(eng.pump())
    assert pumps == [0, 0, 1]
    return pumps, f1.result(), f2.result(), eng.stats()


def sc_full_batch(S):
    eng = _engine(S, FakeClock(), max_delay_ms=1e6)
    futs = [eng.submit([i]) for i in range(4)]
    assert eng.pump() == 1
    return [f.result() for f in futs], eng.stats()


def sc_service_estimate(S):
    clock = FakeClock()
    eng = _engine(S, clock, service_estimate_ms=2.0)
    f = eng.submit([1, 2, 3], deadline_ms=10.0)
    clock.advance_ms(7.5)
    pumps = [eng.pump()]
    clock.advance_ms(1.0)
    pumps.append(eng.pump())
    assert pumps == [0, 1]
    return f.result(), eng.stats()


def sc_miss_accounting(S):
    clock = FakeClock()
    eng = _engine(S, clock)
    f_late = eng.submit([1, 2], deadline_ms=10.0)
    clock.advance_ms(50.0)
    f_fresh = eng.submit([3, 4], deadline_ms=1000.0)
    assert eng.pump() == 1
    assert f_late.result().deadline_missed and not f_fresh.result().deadline_missed
    s = eng.stats()
    assert s.deadline_missed == 1 and s.deadline_miss_rate == pytest.approx(0.5)
    return f_late.result(), f_fresh.result(), s


def sc_tight_behind_best_effort(S):
    clock = FakeClock()
    eng = _engine(S, clock, max_delay_ms=50.0, service_estimate_ms=1.0)
    f_slow = eng.submit([1, 2])
    clock.advance_ms(1.0)
    f_tight = eng.submit([3], deadline_ms=5.0)
    clock.advance_ms(3.0)
    pumps = [eng.pump()]
    clock.advance_ms(1.5)
    pumps.append(eng.pump())
    assert pumps == [0, 1] and not f_tight.result().deadline_missed
    return f_slow.result(), f_tight.result(), eng.stats()


@pytest.mark.parametrize("scenario", [sc_partial_flush, sc_full_batch,
                                      sc_service_estimate, sc_miss_accounting,
                                      sc_tight_behind_best_effort],
                         ids=lambda f: f.__name__[3:])
def test_deadline_aware_flushing(scenario):
    same(*both(scenario))


def sc_cancelled(S):
    eng = _engine(S, FakeClock())
    f_cancel, f_keep = eng.submit([1, 2]), eng.submit([3, 4])
    assert f_cancel.cancel()
    eng.flush_all()
    assert f_cancel.cancelled()
    return f_keep.result(timeout=5), eng.stats()


def test_cancelled_future_does_not_strand_batchmates():
    same(*both(sc_cancelled))


def sc_closed(S):
    eng = S.serving.TopicEngine(S.model(0), buckets=(4,), max_batch=2,
                                n_iters=1, n_trials=1, top_n=3)
    (r,) = eng.infer([[1, 2]])
    eng.close()
    with pytest.raises(RuntimeError):
        eng.submit([1])
    return r.pkd, r.feature_ids, r.model_version


def test_submit_after_close_raises():
    j, t = both(sc_closed)
    np.testing.assert_allclose(t[0], j[0], rtol=1e-6, atol=1e-7)
    assert (t[1] == j[1]).all() and t[2] == j[2]


def sc_poison(S):
    eng = _engine(S, FakeClock())
    f = eng.submit([1, 2])
    eng.swap_model("not a model")                # poison: next flush raises
    eng.flush_all()
    assert f.exception(timeout=5) is not None    # surfaced, not stranded
    eng.swap_model(S.model(0))                   # the engine recovers
    return eng.infer([[1, 2, 3]]), eng.stats()


def test_inference_error_resolves_futures_with_exception():
    same(*both(sc_poison))


# ------------------------------------------------------------- hot swap

def sc_swap_atomic(S):
    clock = FakeClock()
    eng = _engine(S, clock)
    futs = [eng.submit([1, 2, 3]), eng.submit([4, 5])]
    eng.swap_model(S.model(9))
    eng.flush_all()
    ref_b = _engine(S, clock)
    ref_b.swap_model(S.model(9))
    ref_b = ref_b.infer([[1, 2, 3], [4, 5]])
    ref_a = _engine(S, clock).infer([[1, 2, 3], [4, 5]])
    for f, rb, ra in zip(futs, ref_b, ref_a):
        np.testing.assert_array_equal(f.result().pkd, rb.pkd)
        assert not np.allclose(f.result().pkd, ra.pkd)
    return [f.result() for f in futs], ref_a, eng.stats()


def test_hot_swap_is_atomic_per_batch():
    same(*both(sc_swap_atomic))


def sc_swap_concurrent(S):
    eng = S.serving.TopicEngine(S.model(0), buckets=(4, 8), max_batch=8,
                                n_iters=2, n_trials=1, top_n=3,
                                max_delay_ms=1.0)
    rng = np.random.default_rng(2)
    futs, stop = [], threading.Event()

    def swapper():
        # yields the GIL after each swap: a spinning swapper would hold it for
        # a whole switch interval (5 ms) each time the port's eager batch
        # releases it, which times the interpreter, not the engine
        flip = False
        while not stop.is_set():
            eng.swap_model(S.model(9) if flip else S.model(0))
            flip = not flip
            time.sleep(0)

    th = threading.Thread(target=swapper)
    th.start()
    try:
        for _ in range(200):
            futs.append(eng.submit(rng.integers(0, V, size=int(rng.integers(1, 8)))))
        results = [f.result(timeout=60) for f in futs]
    finally:
        stop.set()
        th.join(timeout=30)
        eng.close()
    assert not th.is_alive()
    for r in results:
        assert np.isfinite(r.pkd).all()
        np.testing.assert_allclose(r.pkd.sum(), 1.0, rtol=1e-5)
        assert (np.diff(r.feature_weights) <= 1e-7).all()
    return len(results), eng.stats().completed


def test_hot_swap_under_concurrent_submits():
    same(*both(sc_swap_concurrent))       # real threads: counts, not timings


def sc_swap_mid_flush(S):
    eng = _engine(S, FakeClock())
    eng.swap_model(S.model(0), version=100)
    real_infer = eng._infer

    def swapping_infer(model, q, seed):
        eng.swap_model(S.model(9), version=200)  # after the flush took its model
        return real_infer(model, q, seed)

    eng._infer = swapping_infer
    futs = [eng.submit([1, 2, 3]), eng.submit([4, 5])]
    eng.flush_all()
    assert {f.result(timeout=5).model_version for f in futs} == {100}
    eng._infer = real_infer
    out = eng.infer([[1, 2]])
    assert out[0].model_version == 200 and eng.stats().model_version == 200
    return [f.result() for f in futs], out


@pytest.mark.concurrency
def test_swap_mid_flush_keeps_batch_on_one_version():
    same(*both(sc_swap_mid_flush))


def sc_close_inflight(S):
    entered, release = threading.Event(), threading.Event()
    eng = S.serving.TopicEngine(S.model(0), buckets=(4,), max_batch=2,
                                n_iters=1, n_trials=1, top_n=3, max_delay_ms=0.0)
    real_infer = eng._infer

    def gated(model, q, seed):
        entered.set()
        assert release.wait(timeout=30)
        return real_infer(model, q, seed)

    eng._infer = gated
    f1, f2 = eng.submit([1, 2]), eng.submit([3, 4])
    assert entered.wait(timeout=30)
    f3 = eng.submit([5, 6])
    closer = threading.Thread(target=eng.close)
    closer.start()
    release.set()
    closer.join(timeout=30)
    assert not closer.is_alive()
    out = [f.result(timeout=10) for f in (f1, f2, f3)]
    return [(r.pkd, r.feature_ids, r.model_version, r.bucket) for r in out]


@pytest.mark.concurrency
def test_close_during_inflight_flush_resolves_all_futures():
    same(*both(sc_close_inflight))


# ---------------------------------------------------------------- stats

def sc_stats(S):
    eng = _engine(S, FakeClock())
    out = eng.infer(_queries(1, (2, 6, 30, 3)))
    s = eng.stats()
    assert s.submitted == s.completed == 5 and s.per_bucket[16] == 2
    eng.reset_stats()
    return out, s, eng.stats()


def test_stats_counters_and_reset():
    same(*both(sc_stats))


# ------------------------------------------------- legacy adapter contract

def sc_server_ladder(S):
    srv = S.serving.BatchingServer(S.model(0), batch=4, query_len=4,
                                   n_trials=1, n_iters=2, top_n=3)
    out = srv.infer(_queries(3, (3, 20, 40)))
    assert [d["truncated"] for d in out] == [False] * 3
    return out, srv.engine.stats()


def sc_server_multi_chunk(S):
    srv = S.serving.BatchingServer(S.model(0), batch=4, query_len=6,
                                   n_trials=2, n_iters=3, top_n=5)
    rng = np.random.default_rng(1)
    out = srv.infer([rng.integers(0, V, size=int(n))
                     for n in rng.integers(1, 10, size=11)])
    for r in out:
        assert r["pkd"].shape == (K,) and (r["feature_ids"] < V).all()
        assert (np.diff(r["feature_weights"]) <= 1e-7).all()
    return out, srv.engine.stats()


def sc_server_deterministic(S):
    requests = [np.array([1, 2, 3]), np.array([4, 5]), np.array([7])]
    a = S.serving.BatchingServer(S.model(0), batch=2, query_len=4).infer(requests)
    b = S.serving.BatchingServer(S.model(0), batch=2, query_len=4).infer(requests)
    same(a, b, f"{S.name} rerun")
    return a, None


@pytest.mark.parametrize("scenario", [sc_server_ladder, sc_server_multi_chunk,
                                      sc_server_deterministic],
                         ids=lambda f: f.__name__[3:])
def test_batching_server(scenario):
    (j, j_stats), (t, t_stats) = both(scenario)
    same(counters(j_stats), counters(t_stats))    # the server's clock is real
    assert len(j) == len(t)
    for i, (a, b) in enumerate(zip(j, t)):       # the legacy result dicts
        assert a.keys() == b.keys() and a["truncated"] == b["truncated"]
        np.testing.assert_allclose(b["pkd"], a["pkd"], rtol=1e-6, atol=1e-7)
        features_match(a["feature_ids"], a["feature_weights"], b["feature_ids"],
                       b["feature_weights"], f"row {i}")


def test_package_exports_match_jax():
    assert sorted(tserving.__all__) == sorted(jserving.__all__)
    for name in jserving.__all__:
        assert getattr(tserving, name).__module__.startswith("repro_torch.serving")


# -------------------------------------------------------------- launch.serve

_LAUNCH = ["--topics", "8", "--vocab", "60", "--train-iters", "3",
           "--batch", "4", "--buckets", "4,8", "--qps", "200",
           "--duration", "0.3", "--deadline-ms", "200"]


@pytest.mark.parametrize("mode", [[], ["--replicas", "2", "--cache-mb", "1",
                                       "--shed", "--zipf-pool", "16"]],
                         ids=["engine", "fleet"])
def test_launch_serve_main_on_cpu(mode, capsys):
    """``repro_torch.launch.serve.main`` with ``--device cpu``: the JAX
    module's record (every key, the same request count and swap), plus the
    port's device fields and response checks."""
    j = jlaunch.main(_LAUNCH + mode)
    t = tlaunch.main(_LAUNCH + mode + ["--device", "cpu"])
    assert set(j) <= set(t)
    for k in ("bench", "offered_qps", "n_requests", "deadline_ms", "buckets",
              "swap_mid", "n_trials", "topics", "zipf_pool"):
        assert t[k] == j[k], k
    assert t["device"] == "cpu" and t["card"] is None and t["peak_gib"] is None
    assert t["pkd_sum_err_max"] < 1e-5 and t["ids_in_range"]
    assert t["truncated"] == 0 and t["swap_mid"]
    assert sum(t["versions_after_swap"].values()) > 0
    assert set(t["versions_after_swap"]) == {"1"}
    if mode:
        assert t["failed"] == 0 and t["retries"] == 0
        assert t["breakers"] == ["closed", "closed"]
    assert "achieved" in capsys.readouterr().out


def test_launch_serve_warms_a_fleet_through_its_front_as_jax_does(monkeypatch):
    """Both drivers warm a fleet through its front, once, and clear its cache
    before the run (the fleet keeps its shed state across ``reset_stats``:
    ROADMAP §3)."""
    warmed = {"jax": [], "port": []}

    def spy(mod, key):
        real = mod.warm_shape_grid

        def warm(target, *a, **kw):
            warmed[key].append(type(target).__name__)
            return real(target, *a, **kw)
        monkeypatch.setattr(mod, "warm_shape_grid", warm)

    spy(jlaunch, "jax")
    spy(tlaunch, "port")
    fleet = ["--replicas", "2", "--cache-mb", "1", "--zipf-pool", "16"]
    j = jlaunch.main(_LAUNCH + fleet)
    t = tlaunch.main(_LAUNCH + fleet + ["--device", "cpu"])
    assert warmed == {"jax": ["TopicFleet"], "port": ["TopicFleet"]}
    assert t["replicas"] == j["replicas"] == 2


def test_launch_serve_refuses_preflight_and_a_missing_card(monkeypatch, capsys):
    """--preflight is the serving gate: concurrency + lint over the port and
    the fleet's classes in the inventory, exit 0 before any engine is
    built; without it a missing card raises."""
    with pytest.raises(SystemExit) as exc:
        tlaunch.main(["--preflight"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert "[preflight] OK" in out and "missing from the concurrency inventory" not in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(_LAUNCH)                      # --device defaults to cuda
