"""The port's ``SegmentStream`` (LoadShard/SaveShard) against the JAX
package's: the same segments in the same order with the same stacks, prefetch
invisible bit for bit, SaveShard scattering by uid, a LoadShard failure
reaching the consumer, and (on a CUDA card) the side-stream copies.

The JAX package is imported inside the tests that compare with it, so the
card test runs where there is no jax."""
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro_torch.data import sources as tsources, stream as tstream, synthetic as tsynthetic
from repro_torch.reliability import faults as tfaults

pytestmark = pytest.mark.port


def _jax():
    from repro.data import corpus as jcorpus, sources as jsources, stream as jstream

    return jcorpus, jsources, jstream


@pytest.fixture(scope="module")
def corpus():
    c, _ = tsynthetic.lda_corpus(seed=1, n_docs=140, n_topics=6, vocab_size=90,
                                 doc_len_mean=9)
    return c


def _port_source(corpus, n_segments=3, seed=4):
    return tsources.InMemorySource(corpus, n_segments, 1, 1, 8, seed=seed)


def _sources(corpus, n_segments=3, seed=4):
    jcorpus, jsources, _ = _jax()
    jc = jcorpus.Corpus(corpus.word_ids, corpus.doc_ids, corpus.n_docs, corpus.vocab_size)
    return (_port_source(corpus, n_segments, seed),
            jsources.InMemorySource(jc, n_segments, 1, 1, 8, seed=seed))


def _loads(stream, epoch, start=0):
    return [(s.pos, s.gid, np.asarray(s.wl), np.asarray(s.dl), np.asarray(s.uid),
             np.asarray(s.z), s.host_valid.copy()) for s in stream.epoch(epoch, start)]


@pytest.mark.parametrize("start", [0, 1])
@pytest.mark.parametrize("prefetch", [False, True], ids=["no prefetch", "prefetch"])
def test_segment_stream_loads_what_jax_loads(corpus, prefetch, start):
    _, jsources, jstream = _jax()
    tsrc, jsrc = _sources(corpus)
    for epoch in (0, 1, 5):
        t = _loads(tstream.SegmentStream(tsrc, tsources.initial_z(tsrc), prefetch=prefetch,
                                         device="cpu"), epoch, start)
        j = _loads(jstream.SegmentStream(jsrc, jsources.initial_z(jsrc), prefetch=False),
                   epoch, start)
        assert [x[:2] for x in t] == [x[:2] for x in j]
        assert len(t) == tsrc.n_segments - start
        for a, b in zip(t, j):
            for x, y in zip(a[2:], b[2:]):
                np.testing.assert_array_equal(x, y.astype(x.dtype))
            assert (a[2].dtype, a[3].dtype, a[4].dtype, a[5].dtype) == (
                np.int32, np.int32, np.int64, np.int32)


def test_segment_stream_prefetch_bitwise_invisible(corpus):
    tsrc = _port_source(corpus, seed=5)
    for epoch in (0, 1):
        a = _loads(tstream.SegmentStream(tsrc, tsources.initial_z(tsrc), prefetch=False,
                                         device="cpu"), epoch)
        b = _loads(tstream.SegmentStream(tsrc, tsources.initial_z(tsrc), prefetch=True,
                                         device="cpu"), epoch)
        assert [x[:2] for x in a] == [x[:2] for x in b]
        for x, y in zip(a, b):
            for u, v in zip(x[2:], y[2:]):
                np.testing.assert_array_equal(u, v)


def test_segment_stream_commit_scatters_by_uid(corpus):
    _, jsources, jstream = _jax()
    tsrc, jsrc = _sources(corpus, n_segments=2, seed=5)
    zs = {}
    for name, src, stream_mod, kw in (("port", tsrc, tstream, dict(device="cpu")),
                                      ("jax", jsrc, jstream, {})):
        z = zs[name] = jsources.initial_z(jsrc)
        stream = stream_mod.SegmentStream(src, z, prefetch=False, **kw)
        segs = list(stream.epoch(0))
        seg = segs[0]
        marked = np.full(np.asarray(seg.z).shape, 7, np.int32)
        stream.commit(seg, torch.from_numpy(marked) if name == "port" else marked)
        # every valid token of THIS segment now reads 7; the other segment's
        # tokens are untouched (disjoint documents → disjoint uids)
        assert (z[seg.host_uid[seg.host_valid]] == 7).all()
        other = segs[1]
        np.testing.assert_array_equal(
            z[other.host_uid[other.host_valid]],
            np.asarray(src.segment(other.gid).z0)[other.host_valid])
    np.testing.assert_array_equal(zs["port"], zs["jax"])


def test_segment_stream_records_host_times(corpus):
    tsrc = _port_source(corpus)
    stream = tstream.SegmentStream(tsrc, tsources.initial_z(tsrc), prefetch=True, device="cpu")
    for seg in stream.epoch(0):
        assert seg.load_s > 0 and seg.wait_s >= 0 and seg.ready is None and seg.pinned == ()
        stream.commit(seg, seg.z)
        assert seg.commit_s > 0


@pytest.mark.parametrize("prefetch", [False, True], ids=["no prefetch", "prefetch"])
def test_segment_stream_forwards_a_load_failure(corpus, tmp_path, prefetch):
    """A segment read that keeps failing reaches the consumer as the error
    itself, from the prefetch thread too, after DiskSource's retries."""
    tsrc = _port_source(corpus)
    d = str(tmp_path / "segs")
    tsources.save_segments(tsrc, d)
    disk = tsources.open_segments(d)
    stream = tstream.SegmentStream(disk, tsources.initial_z(disk), prefetch=prefetch,
                                   device="cpu")
    plane = tfaults.FaultPlane().fail("disk.segment_read", key="2")
    got = []
    with tfaults.injected(plane):
        with pytest.raises(tfaults.FaultInjected):
            for seg in stream.epoch(0):
                got.append(seg.gid)
    assert 2 not in got
    assert plane.hits("disk.segment_read", key="2") == disk.retries + 1


@pytest.mark.kernels
@pytest.mark.parametrize("prefetch", [False, True], ids=["no prefetch", "prefetch"])
def test_segment_stream_on_the_card(corpus, prefetch):
    """On a CUDA card: pinned host buffers, copies on the side stream, the
    consumer's stream waiting on their event; the stacks equal the CPU
    stream's, and commits between loads land in the z store. (A pad slot's
    z reads z[0], which an earlier commit may have moved: only valid slots
    of z are compared.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tsrc = _port_source(corpus)
    cpu = _loads(tstream.SegmentStream(tsrc, tsources.initial_z(tsrc), prefetch=False,
                                       device="cpu"), 1)
    z = tsources.initial_z(tsrc)
    stream = tstream.SegmentStream(tsrc, z, prefetch=prefetch, device="cuda")
    for (pos, gid, *arrays), seg in zip(cpu, stream.epoch(1)):
        assert (seg.pos, seg.gid) == (pos, gid) and seg.ready is not None
        assert all(p.is_pinned() for p in seg.pinned)
        valid = arrays[4]
        for x, t in zip(arrays[:4], (seg.wl, seg.dl, seg.uid, seg.z)):
            assert t.is_cuda
            np.testing.assert_array_equal(t.cpu().numpy()[valid], x[valid])
        np.testing.assert_array_equal(seg.wl.cpu().numpy(), arrays[0])
        seg.z.add_(1)                   # work on the consumer's stream
        stream.commit(seg, seg.z)
        assert seg.pinned == ()
        np.testing.assert_array_equal(z[seg.host_uid[seg.host_valid]],
                                      arrays[3][seg.host_valid] + 1)
