"""The port's concurrency analyzer (``repro_torch.analysis.concurrency``, its
own copy: the port imports nothing of the JAX package) gives JAX's findings
(``repro.analysis.concurrency``) on the same in-memory modules, one or more
for each of the four passes, and on the same trees."""
import os
import textwrap

import pytest

from repro.analysis import concurrency as jcc
from repro_torch.analysis import concurrency as tcc

pytestmark = [pytest.mark.port, pytest.mark.concurrency]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SNIPPETS = {
    "clean": """
        import threading

        class C:
            _GUARDED_BY = {"_count": "_lock"}

            def __init__(self):
                self._lock = threading.Lock()
                self._count = 0
                self._t = threading.Thread(target=self._run)
                self._t.start()

            def _run(self):
                while not self.stopped():
                    with self._lock:
                        self._count += 1

            def close(self):
                self._t.join()
    """,
    "guards: unguarded write": """
        import threading

        class C:
            _GUARDED_BY = {"_count": "_lock"}

            def __init__(self):
                self._lock = threading.Lock()
                self._count = 0
                self._t = threading.Thread(target=self._run)
                self._t.start()

            def _run(self):
                while not self.stopped():
                    with self._lock:
                        self._count += 1

            def bump(self):
                self._count += 1

            def close(self):
                self._t.join()
    """,
    "guards: undeclared shared field": """
        import threading

        class C:
            _GUARDED_BY = {}

            def __init__(self):
                self._stuff = []
                self._t = threading.Thread(target=self._run)
                self._t.start()

            def _run(self):
                while not self.closed():
                    self._stuff.append(1)

            def drain(self):
                out = list(self._stuff)
                self._stuff.clear()
                return out

            def close(self):
                self._t.join()
    """,
    "guards: atomic without rationale": """
        import threading

        class C:
            _GUARDED_BY = {"_x": "_missing"}

            def __init__(self):
                self._ref = None  # atomic:
    """,
    "lockorder: cross-class cycle": """
        import threading

        class A:
            _GUARDED_BY = {}

            def __init__(self):
                self._la = threading.Lock()

            def ping(self, other):
                with self._la:
                    other.pong_b(self)

            def pong_a(self, other):
                with self._la:
                    pass

        class B:
            _GUARDED_BY = {}

            def __init__(self):
                self._lb = threading.Lock()

            def pong_b(self, other):
                with self._lb:
                    other.pong_a(self)
    """,
    "lockorder: blocking while locked": """
        import threading
        import queue

        class C:
            _GUARDED_BY = {}

            def __init__(self):
                self._lock = threading.Lock()
                self._q = queue.Queue(maxsize=1)

            def a(self, fut):
                with self._lock:
                    return fut.result()

            def b(self, item):
                with self._lock:
                    with self._lock:
                        self._q.put(item)
    """,
    "lifecycle: joinless, unstoppable, double start": """
        import threading

        class C:
            _GUARDED_BY = {}

            def __init__(self):
                self._t = None
                self._u = threading.Thread(target=self._spin)
                self._u.start()

            def start(self):
                self._t = threading.Thread(target=self._run)
                self._t.start()

            def _run(self):
                while not self.stopped():
                    pass

            def _spin(self):
                while True:
                    self.tick()

            def tick(self):
                pass
    """,
    "waitnotify: wait outside a loop, notify unlocked, event retry": """
        import threading

        class C:
            _GUARDED_BY = {}

            def __init__(self):
                self._cv = threading.Condition()
                self._ev = threading.Event()

            def poke(self):
                with self._cv:
                    self._cv.wait()

            def bad(self):
                while self.pending():
                    self._cv.wait(0.1)

            def ring(self):
                self._cv.notify_all()

            def retry(self):
                while self.pending():
                    self._ev.wait(timeout=0.5)
    """,
}


def _findings(mod, src):
    return [f.to_dict() for f in mod.analyze_source(textwrap.dedent(src), "seeded.py")]


@pytest.mark.parametrize("name", list(SNIPPETS))
def test_analyze_source_matches_jax(name):
    port, jax_ = _findings(tcc, SNIPPETS[name]), _findings(jcc, SNIPPETS[name])
    assert port == jax_
    errors = [f["check"] for f in port if f["severity"] == "error"]
    if name == "clean":
        assert errors == []
    else:
        assert errors, name
        assert all(c.startswith("concurrency.") for c in errors)


@pytest.mark.parametrize("subdir", ["src/repro_torch", "src/repro", "src"])
def test_run_matches_jax_over_the_trees(subdir):
    port = [f.to_dict() for f in tcc.run(ROOT, (subdir,))]
    jax_ = [f.to_dict() for f in jcc.run(ROOT, (subdir,))]
    assert port == jax_
    assert not [f for f in port if f["severity"] == "error"]
    inventory = next(f for f in port if f["check"] == "concurrency.inventory")
    if subdir != "src/repro":
        for cls in ("TopicFleet", "ResultCache", "TopicEngine", "SnapshotWatcher",
                    "CircuitBreaker", "FaultPlane", "SegmentStream", "CheckpointManager"):
            assert cls in inventory["message"]
