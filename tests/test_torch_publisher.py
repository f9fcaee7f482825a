"""Publish → serve across the two packages.

A snapshot directory written by one package's publisher (full and delta
versions) feeds the other package's ``SnapshotWatcher``, and the two engines
then serve the same responses from it (held by ``test_torch_serving.same``).
A corrupt payload, whichever package wrote it, is quarantined by either
watcher, which falls back to the last good version.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro import training as jtraining
from repro_torch import convert, training as ttraining
from test_torch_chaos import _corrupt
from test_torch_serving import JAX, PORT, FakeClock, same

pytestmark = [pytest.mark.port, pytest.mark.trainer]

SESSION = dict(n_docs=120, vocab_size=60, n_topics=8, true_topics=5, n_epochs=4,
               alpha_opt_from=99)


def _publish(writer, snap):
    """One training session publishing v0 (full) and row-diff deltas."""
    pkg = jtraining if writer is JAX else ttraining
    cfg = dict(SESSION, **({} if writer is JAX else {"device": "cpu"}))
    pub = pkg.ModelPublisher(snap, every=1, at_start=True, at_end=False, keep=10,
                             delta=True, full_every=3)
    tr = pkg.Trainer(pkg.TrainerConfig(**cfg),
                     callbacks=[pub, pkg.Metrics(printer=lambda m: None)])
    tr.log = lambda msg: None
    tr.setup()
    tr.fit()
    versions = writer.snapshots.snapshot_versions(snap)
    kinds = ["delta" in writer.snapshots.read_meta(snap, v) for v in versions]
    assert kinds[0] is False and any(kinds), kinds
    return versions, kinds


def _serve_every_version(S, snap, versions, queries):
    """A fake-clock engine fed by a watcher: poll each version in turn (the
    newest-first walk takes the newest, so older ones are made visible one
    by one by hiding the newer directories), serve the queries on each."""
    m0 = S.model(0)
    eng = S.serving.TopicEngine(m0, buckets=(4, 8, 16), max_batch=8, n_iters=3,
                                n_trials=2, top_n=5, clock=FakeClock(), start=False)
    w = S.serving.SnapshotWatcher(snap, eng, poll_s=0.01)
    out = []
    hidden = [S.snapshots.snapshot_path(snap, v) for v in versions[1:]]
    for p in hidden:
        os.rename(p, p + ".hidden")
    for i, v in enumerate(versions):
        if i:
            os.rename(hidden[i - 1] + ".hidden", hidden[i - 1])
        assert w.poll() == v and eng.model_version == v
        out.append(eng.infer(queries))
    return out, eng.stats()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_published_snapshots_serve_alike_in_both_packages(tmp_path, writer):
    writer = JAX if writer == "jax" else PORT
    snap = str(tmp_path / "snaps")
    versions, _ = _publish(writer, snap)
    rng = np.random.default_rng(3)
    queries = [rng.integers(0, SESSION["vocab_size"], size=int(n)).astype(np.int32)
               for n in rng.integers(1, 20, size=12)]
    j = _serve_every_version(_shaped(JAX), snap, versions, queries)
    t = _serve_every_version(_shaped(PORT), snap, versions, queries)
    same(j, t)


def _shaped(S):
    """``S`` with a start model of the session's shape (V = 60, K = 8)."""
    V, K = SESSION["vocab_size"], SESSION["n_topics"]
    phi = np.random.default_rng(0).integers(0, 20, (V, K)).astype(np.int32)
    jm = JAX.rtlda.build_model(jnp.asarray(phi), jnp.float32(0.01),
                               jnp.full((K,), 0.5, jnp.float32))
    if S is JAX:
        return dataclasses.replace(S, model=lambda seed: jm)
    tm = convert.rtlda_model_from_numpy(*(np.asarray(x) for x in (
        jm.pvk, jm.alpha, jm.r_topic, jm.r_value)), device="cpu")
    return dataclasses.replace(S, model=lambda seed: tm)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_corrupt_publish_is_quarantined_by_the_other_package(tmp_path, writer, reader):
    writer = JAX if writer == "jax" else PORT
    reader = _shaped(JAX if reader == "jax" else PORT)
    snap = str(tmp_path / "snaps")
    versions, _ = _publish(writer, snap)
    newest = versions[-1]
    _corrupt(os.path.join(writer.snapshots.snapshot_path(snap, newest),
                          writer.io.PAYLOAD))
    eng = reader.serving.TopicEngine(reader.model(0), buckets=(4, 8), start=False,
                                     clock=FakeClock())
    w = reader.serving.SnapshotWatcher(snap, eng, poll_s=0.01)
    got = w.poll()
    # the newest is retired on disk; the walk falls back to the newest good
    # version in the same tick (a delta whose chain is intact)
    assert w.quarantined == 1 and got == versions[-2] == eng.model_version
    assert writer.snapshots.snapshot_versions(snap) == versions[:-1]
    assert os.path.isdir(writer.snapshots.snapshot_path(snap, newest) + ".corrupt")
