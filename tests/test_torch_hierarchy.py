"""The port's coordinator loop ``run_hierarchical`` against the JAX package's,
driving each package's dense ring on one device: the ``on_epoch_end`` α
replacement, a toy ``agg_fn`` at ``agg_every = 2`` with its refs, seeds
and ``on_aggregate`` events, and the streamed schedule (``segments=``, each
package's ``SegmentStream``) with its segment events and a mid-epoch
resume. The states must be equal bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro.core import distributed as jdist, hierarchy as jhier
from repro.data import corpus as jcorpus, synthetic as jsynthetic
from repro_torch.core import distributed as tdist, hierarchy as thier

pytestmark = pytest.mark.port

V, K, EPOCHS, SEED0 = 200, 16, 5, 11


@pytest.fixture(scope="module")
def ring():
    c, _ = jsynthetic.lda_corpus(seed=1, n_docs=250, n_topics=8, vocab_size=V,
                                 doc_len_mean=6)
    sc = jcorpus.shard_corpus(c, 1, 1, K, seed=1)
    cap = sc.word_local.shape[2]
    kw = dict(n_topics=K, vocab_size=V, rows_per_shard=sc.rows_per_shard,
              docs_per_shard=sc.docs_per_shard, cap=cap, package_len=cap, n_rounds=1)
    return sc, kw


def _run(ring, side, with_agg):
    """One run_hierarchical on ``side`` ("jax" or "port"); returns the final
    state as numpy and the log of events."""
    sc, kw = ring
    events = []
    if side == "jax":
        mesh = jax.make_mesh((1, 1), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        inner = jdist.make_ring_epoch(mesh, jdist.RingConfig(**kw))
        state = jdist.device_arrays(sc, K)
        alpha, beta = jnp.full((K,), 50.0 / K, jnp.float32), jnp.float32(0.01)
        run, xp = jhier.run_hierarchical, jnp
    else:
        inner = tdist.build_epoch_body(tdist.RingConfig(**kw))
        state = tdist.device_arrays(sc, K, device="cpu")
        alpha, beta = torch.full((K,), 50.0 / K), torch.tensor(0.01)
        run, xp = thier.run_hierarchical, torch

    def epoch(*args):
        events.append(("epoch", int(args[8])))
        return inner(*args)

    def agg(phi, psi, phi_ref, psi_ref, seed):
        # a toy merge that reads both the live state and the refs
        events.append(("agg", int(seed), int(phi_ref.sum()), int(psi_ref.sum())))
        return xp.maximum(phi, phi_ref), xp.maximum(psi, psi_ref)

    def on_aggregate(ep, st):
        events.append(("on_aggregate", ep, int(st[0].sum())))

    def on_epoch_end(ep, st, a):
        events.append(("on_epoch_end", ep, float(a.sum())))
        return a * 1.25 if ep in (1, 3) else None

    out = run(epoch, agg if with_agg else None, state, alpha, beta, EPOCHS,
              agg_every=2, seed0=SEED0, on_epoch_end=on_epoch_end,
              on_aggregate=on_aggregate)
    return [np.asarray(x) for x in out], events


@pytest.mark.parametrize("with_agg", [False, True], ids=["no agg_fn", "toy agg_fn"])
def test_run_hierarchical_matches_jax(ring, with_agg):
    js, jev = _run(ring, "jax", with_agg)
    ts, tev = _run(ring, "port", with_agg)
    assert tev == jev
    assert [e[1] for e in tev if e[0] == "epoch"] == [SEED0 + ep for ep in range(EPOCHS)]
    assert sum(e[0] == "agg" for e in tev) == (EPOCHS // 2 if with_agg else 0)
    for name, i in (("phi", 0), ("psi", 1), ("z", 5)):
        np.testing.assert_array_equal(ts[i], js[i], err_msg=name)


def test_run_hierarchical_seeds_resume_and_refusals():
    seen = []

    def epoch(phi, psi, wl, dl, uid, z, alpha, beta, seed, *aux):
        seen.append((seed, aux))
        return phi + 1, psi, wl, dl, uid, z

    st = tuple(torch.zeros(2, dtype=torch.int32) for _ in range(6))
    out = thier.run_hierarchical(epoch, None, st, torch.ones(2), torch.tensor(0.01), 4, 2,
                                 seed0=2 ** 32 - 2, start_epoch=1,
                                 epoch_aux=lambda: ("tables",))
    # (seed0 + ep) mod 2³², from the resumed epoch on
    assert seen == [(2 ** 32 - 1, ("tables",)), (0, ("tables",)), (1, ("tables",))]
    assert out[0].tolist() == [3, 3]
    # refs given on resume are the merge's baseline; the boundary clones them
    got = []
    thier.run_hierarchical(epoch, lambda p, s, pr, sr, seed: (got.append(int(pr[0])) or (p, s)),
                           st, torch.ones(2), torch.tensor(0.01), 4, 2, start_epoch=1,
                           refs=(torch.full((2,), 7, dtype=torch.int32), st[1]))
    assert got == [7, 1]
    # streaming drives a single configuration: an agg_fn is refused
    with pytest.raises(ValueError, match="agg_fn must be None"):
        thier.run_hierarchical(epoch, lambda *a, **k: a[:2], st[:2], torch.ones(2),
                               torch.tensor(0.01), 1, 1, segments=object())


# ------------------------------ the streamed schedule (segments=) ----------

@pytest.fixture(scope="module")
def segmented():
    from repro.data import sources as jsources

    c, _ = jsynthetic.lda_corpus(seed=4, n_docs=240, n_topics=8, vocab_size=V,
                                 doc_len_mean=6)
    src = jsources.InMemorySource(c, 3, 1, 1, K, seed=2)
    sc = src.segment(0)
    cap = sc.word_local.shape[2]
    kw = dict(n_topics=K, vocab_size=V, rows_per_shard=sc.rows_per_shard,
              docs_per_shard=sc.docs_per_shard, cap=cap, package_len=cap // 2
              if cap % 2 == 0 else cap, n_rounds=1)
    return src, kw


def _run_streamed(segmented, side, prefetch, start_epoch=0, start_segment=0):
    """run_hierarchical(segments=) on ``side``; returns (phi, psi), the global
    z store and the event log."""
    from repro.data import sources as jsources, stream as jstream
    from repro_torch.data import stream as tstream

    src, kw = segmented
    events = []
    z = jsources.initial_z(src)
    if side == "jax":
        mesh = jax.make_mesh((1, 1), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        inner = jdist.make_ring_epoch(mesh, jdist.RingConfig(**kw))
        phi = psi = None
        for g in range(src.n_segments):
            phi, psi = jdist.host_counts(src.segment(g), K, phi, psi)
        state = (jnp.asarray(phi.astype(np.int32)), jnp.asarray(psi.astype(np.int32)))
        alpha, beta = jnp.full((K,), 50.0 / K, jnp.float32), jnp.float32(0.01)
        stream = jstream.SegmentStream(src, z, prefetch=prefetch)
    else:
        inner = tdist.build_epoch_body(tdist.RingConfig(**kw))
        phi = psi = None
        for g in range(src.n_segments):
            phi, psi = tdist.device_counts(src.segment(g), K, "cpu", phi, psi)
        state = (phi, psi)
        alpha, beta = torch.full((K,), 50.0 / K), torch.tensor(0.01)
        stream = tstream.SegmentStream(src, z, prefetch=prefetch, device="cpu")

    def epoch(*args):
        events.append(("epoch", int(args[8])))
        return inner(*args)

    def on_segment_end(ep, seg, st):
        events.append(("segment", ep, seg.pos, seg.gid, int(st[1].sum())))

    def on_epoch_end(ep, st, a):
        assert len(st) == 2
        events.append(("on_epoch_end", ep, float(a.sum())))
        return a * 1.25 if ep == 1 else None

    out = thier.run_hierarchical if side == "port" else jhier.run_hierarchical
    phi, psi = out(epoch, None, state, alpha, beta, EPOCHS, agg_every=2, seed0=SEED0,
                   on_epoch_end=on_epoch_end, segments=stream, start_epoch=start_epoch,
                   start_segment=start_segment, on_segment_end=on_segment_end)
    return np.asarray(phi), np.asarray(psi), z, events


@pytest.mark.parametrize("prefetch", [False, True], ids=["no prefetch", "prefetch"])
def test_run_hierarchical_segments_matches_jax(segmented, prefetch):
    jphi, jpsi, jz, jev = _run_streamed(segmented, "jax", False)
    tphi, tpsi, tz, tev = _run_streamed(segmented, "port", prefetch)
    assert tev == jev
    n_seg = segmented[0].n_segments
    # every segment of an epoch shares the epoch's seed
    assert [e[1] for e in tev if e[0] == "epoch"] == [
        SEED0 + ep for ep in range(EPOCHS) for _ in range(n_seg)]
    np.testing.assert_array_equal(tphi, jphi)
    np.testing.assert_array_equal(tpsi, jpsi)
    np.testing.assert_array_equal(tz, jz)


def test_run_hierarchical_segments_resumes_mid_epoch_like_jax(segmented):
    """``start_segment`` applies to the first replayed epoch only: the visit
    order is regenerated and the loop starts at that position."""
    _, _, _, jev = _run_streamed(segmented, "jax", False, start_epoch=2, start_segment=2)
    _, _, _, tev = _run_streamed(segmented, "port", True, start_epoch=2, start_segment=2)
    assert tev == jev
    seg_events = [e for e in tev if e[0] == "segment"]
    assert [e[2] for e in seg_events if e[1] == 2] == [2]
    assert [e[2] for e in seg_events if e[1] == 3] == [0, 1, 2]
