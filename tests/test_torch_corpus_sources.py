"""The port's corpus preprocessing, segment layout and corpus sources against
the JAX package's, bit for bit (all of it is host numpy on both sides), and
the on-disk segment directory: ``save_segments`` writes the JAX package's
files, either package's ``DiskSource`` opens either directory, and the
integrity and retry defenses behave as the JAX package's do."""
import json
import os

import numpy as np
import pytest

from repro.data import corpus as jcorpus, sources as jsources, synthetic as jsynthetic
from repro.reliability import faults as jfaults
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.data import corpus as tcorpus, sources as tsources
from repro_torch.reliability import faults as tfaults

pytestmark = pytest.mark.port

SHARD_FIELDS = ("word_local", "doc_local", "uid", "z0", "shard_of_word", "local_of_word")
SHARD_SIZES = ("rows_per_shard", "docs_per_shard", "n_data_shards", "n_vocab_shards",
               "vocab_size", "n_real_tokens")


def _same_shards(b, a):
    for f in SHARD_FIELDS:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
        assert getattr(b, f).dtype == getattr(a, f).dtype, f
    for f in SHARD_SIZES:
        assert getattr(b, f) == getattr(a, f), f


def _docs(seed, n_docs=300, vocab=120):
    rng = np.random.default_rng(seed)
    docs = [rng.zipf(1.6, rng.integers(1, 9)).astype(np.int64) % vocab for _ in range(n_docs)]
    docs += [docs[3].copy(), docs[7].copy()]              # duplicates to drop
    return docs


@pytest.fixture(scope="module")
def corpus():
    c, _ = jsynthetic.lda_corpus(seed=2, n_docs=240, n_topics=8, vocab_size=150,
                                 doc_len_mean=7)
    return c


def _tcorpus(c):
    return tcorpus.Corpus(c.word_ids, c.doc_ids, c.n_docs, c.vocab_size)


@pytest.mark.parametrize("kw", [{}, dict(min_word_freq=3, max_word_fraction=0.05),
                                dict(drop_single_word_docs=False, dedup_docs=False)])
def test_preprocess_is_the_same(kw):
    docs = _docs(5)
    jc, jremap = jcorpus.preprocess(docs, 120, **kw)
    tc, tremap = tcorpus.preprocess(docs, 120, **kw)
    np.testing.assert_array_equal(tremap, jremap)
    np.testing.assert_array_equal(tc.word_ids, jc.word_ids)
    np.testing.assert_array_equal(tc.doc_ids, jc.doc_ids)
    assert (tc.n_docs, tc.vocab_size) == (jc.n_docs, jc.vocab_size)
    assert tc.word_ids.dtype == jc.word_ids.dtype


@pytest.mark.parametrize("n_docs,n_segments,seed", [(10, 3, 0), (240, 4, 7), (5, 1, 2)])
def test_assign_segments_is_the_same(n_docs, n_segments, seed):
    a = jcorpus.assign_segments(n_docs, n_segments, seed)
    b = tcorpus.assign_segments(n_docs, n_segments, seed)
    np.testing.assert_array_equal(b, a)
    assert b.dtype == a.dtype


@pytest.mark.parametrize("n_segments,S", [(1, 1), (3, 1), (3, 2)])
def test_segment_corpus_is_the_same(corpus, n_segments, S):
    a = jcorpus.segment_corpus(corpus, n_segments, S, S, 16, seed=4)
    b = tcorpus.segment_corpus(_tcorpus(corpus), n_segments, S, S, 16, seed=4)
    assert len(b) == len(a) == n_segments
    for sb, sa in zip(b, a):
        _same_shards(sb, sa)


def test_shard_corpus_options_are_the_same(corpus):
    freq = np.bincount(corpus.word_ids, minlength=corpus.vocab_size)
    placement = jcorpus.vocab_placement(freq, 2)
    uids = np.arange(corpus.n_tokens, dtype=np.uint32)[::-1].copy()
    kw = dict(placement=placement, min_cap=400, min_docs_per_shard=150, uids=uids)
    _same_shards(tcorpus.shard_corpus(_tcorpus(corpus), 2, 2, 16, 3, **kw),
                 jcorpus.shard_corpus(corpus, 2, 2, 16, 3, **kw))
    assert (tcorpus.shard_corpus(_tcorpus(corpus), 2, 2, 16, 3, probe_only=True)
            == jcorpus.shard_corpus(corpus, 2, 2, 16, 3, probe_only=True))


@pytest.mark.parametrize("n_segments", [1, 3])
def test_sources_are_the_same(corpus, n_segments):
    pairs = [(tsources.InMemorySource(_tcorpus(corpus), n_segments, 1, 1, 16, seed=1),
              jsources.InMemorySource(corpus, n_segments, 1, 1, 16, seed=1)),
             (tsources.SyntheticSource(120, 90, 6, 5, gen_seed=3, n_segments=n_segments,
                                       n_data_shards=1, n_vocab_shards=1, n_topics=16,
                                       seed=2),
              jsources.SyntheticSource(120, 90, 6, 5, gen_seed=3, n_segments=n_segments,
                                       n_data_shards=1, n_vocab_shards=1, n_topics=16,
                                       seed=2))]
    for t, j in pairs:
        assert t.describe() == j.describe()
        np.testing.assert_array_equal(t.word_freq(), j.word_freq())
        np.testing.assert_array_equal(t.doc_lengths(), j.doc_lengths())
        for (tg, ts), (jg, js) in zip(t.iter_segments(epoch=5), j.iter_segments(epoch=5)):
            assert tg == jg
            _same_shards(ts, js)
        np.testing.assert_array_equal(tsources.initial_z(t), jsources.initial_z(j))
        for ep in range(3):
            np.testing.assert_array_equal(tsources.segment_order(n_segments, ep, 9),
                                          jsources.segment_order(n_segments, ep, 9))


# ------------------------------ the on-disk segment directory --------------

def _segments(corpus, n_segments=3, S=1):
    return (tsources.InMemorySource(_tcorpus(corpus), n_segments, S, S, 16, seed=2),
            jsources.InMemorySource(corpus, n_segments, S, S, 16, seed=2))


def _dir_files(d):
    out = {}
    for base, _, files in os.walk(d):
        for f in files:
            p = os.path.join(base, f)
            out[os.path.relpath(p, d)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("S", [1, 2])
def test_save_segments_writes_the_jax_directory(corpus, tmp_path, S):
    """Both packages write the same files, byte for byte (meta.json with its
    SHA-256s included), and each package's DiskSource opens either directory
    with equal memory-mapped arrays."""
    tsrc, jsrc = _segments(corpus, S=S)
    td, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tsources.save_segments(tsrc, td) == td
    jsources.save_segments(jsrc, jd)
    tf, jf = _dir_files(td), _dir_files(jd)
    assert sorted(tf) == sorted(jf)
    for name in sorted(tf):
        if name.endswith(".npz"):      # zip members carry timestamps
            a, b = np.load(os.path.join(td, name)), np.load(os.path.join(jd, name))
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
                assert a[k].dtype == b[k].dtype, k
        else:
            assert tf[name] == jf[name], name
    assert json.loads(tf["meta.json"]) == json.loads(jf["meta.json"])
    for d in (td, jd):
        t, j = tsources.open_segments(d), jsources.open_segments(d)
        assert t.describe() == j.describe() == tsrc.describe().replace("InMemory", "Disk")
        np.testing.assert_array_equal(t.word_freq(), j.word_freq())
        np.testing.assert_array_equal(t.doc_lengths(), j.doc_lengths())
        for (tg, ts), (jg, js) in zip(t.iter_segments(epoch=3), j.iter_segments(epoch=3)):
            assert tg == jg
            _same_shards(ts, js)
            _same_shards(ts, tsrc.segment(tg))
            for name in tsources.SEGMENT_ARRAYS:
                assert isinstance(getattr(ts, name), np.memmap), \
                    "disk stacks must be memory-mapped (out-of-core residency)"
        np.testing.assert_array_equal(tsources.initial_z(t), jsources.initial_z(j))


def test_open_segments_rejects_non_corpus_dir(tmp_path):
    with pytest.raises(FileNotFoundError, match="save_segments"):
        tsources.open_segments(str(tmp_path))


def test_interrupted_resave_is_not_openable(corpus, tmp_path):
    """Re-saving over a corpus directory drops the old completeness marker
    FIRST: a crash mid-rewrite must not leave a directory that opens as the
    previous corpus with mixed contents."""
    d = str(tmp_path / "segs")
    tsources.save_segments(_segments(corpus, 2)[0], d)
    assert tsources.open_segments(d).n_segments == 2

    class Boom(RuntimeError):
        pass

    class FailingSource(tsources.InMemorySource):
        def segment(self, g):
            if g == 1:
                raise Boom("disk died mid-save")
            return super().segment(g)

    bad = FailingSource(_tcorpus(corpus), 2, 1, 1, 8, seed=1)
    with pytest.raises(Boom):
        tsources.save_segments(bad, d)
    for pkg in (tsources, jsources):
        with pytest.raises(FileNotFoundError):
            pkg.open_segments(d)


def _corrupt(path):
    """Flip a few payload bytes in place (torn write / bit rot)."""
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        block = f.read(8)
        f.seek(-len(block), os.SEEK_CUR)
        f.write(bytes(b ^ 0xFF for b in block))


def test_disk_source_verifies_once_and_rot_is_never_retried(corpus, tmp_path):
    d = str(tmp_path / "segs")
    tsources.save_segments(_segments(corpus, 2)[0], d)
    src = tsources.DiskSource(d)
    src.segment(0)                   # verifies on first touch
    assert src._verified == {0}
    _corrupt(os.path.join(d, "segment_00001", "word_local.npy"))
    with pytest.raises(ckpt_io.IntegrityError) as ei:
        src.segment(1)
    assert "word_local" in ei.value.path and isinstance(ei.value, OSError)
    plane = tfaults.FaultPlane()
    with tfaults.injected(plane):
        with pytest.raises(ckpt_io.IntegrityError):
            src.segment(1)
        assert plane.hits("disk.segment_read", key="1") == 1   # no retry of rot
        src.segment(0)               # memoized: verified segments read as before
    # opting out reads the (corrupt) bytes without the check
    tsources.DiskSource(d, verify=False).segment(1)


def test_disk_source_retries_transient_errors_like_jax(corpus, tmp_path):
    """An injected ``disk.segment_read`` failure is retried ``retries`` times,
    then surfaces; the port's seam is hit where JAX's is, as often."""
    d = str(tmp_path / "segs")
    tsources.save_segments(_segments(corpus, 2)[0], d)
    counts = {}
    for name, (sources, faults) in {"port": (tsources, tfaults),
                                    "jax": (jsources, jfaults)}.items():
        src = sources.DiskSource(d, retries=2)
        plane = faults.FaultPlane().fail("disk.segment_read", key="0", nth=1)
        with faults.injected(plane):
            sc = src.segment(0)          # first read fails, the retry succeeds
            assert sc.n_real_tokens > 0
        plane2 = faults.FaultPlane().fail("disk.segment_read", key="1")
        with faults.injected(plane2):
            with pytest.raises(faults.FaultInjected):
                src.segment(1)           # persistent: surfaces after the retries
        plane3 = faults.FaultPlane(seed=5).fail("disk.segment_read", rate=0.5)
        outcomes = []
        with faults.injected(plane3):
            for ep in range(6):
                for g in sources.segment_order(2, ep, 2):
                    try:
                        src.segment(int(g))
                        outcomes.append(int(g))
                    except faults.FaultInjected:
                        outcomes.append(-1)
        counts[name] = (plane.hits("disk.segment_read", key="0"),
                        plane2.hits("disk.segment_read", key="1"),
                        plane3.hits("disk.segment_read"), outcomes)
    assert counts["port"] == counts["jax"]
    assert counts["port"][:2] == (2, 3)


def test_disk_source_opens_the_word_sharded_layout(corpus, tmp_path):
    """A word-sharded (P = 2) directory: both packages write the same files,
    either package's ``DiskSource`` opens either one, and each segment
    (stacks, ``n_model_shards``, ``rows_coarse``) equals JAX's
    ``DiskSource.segment``. The blocks ``segment_block`` hands the ranks of a
    2×2 mesh partition every segment's tokens."""
    from repro_torch.dist.sharding import RankLayout

    tsrc = tsources.InMemorySource(_tcorpus(corpus), 3, 2, 2, 16, seed=2, n_model_shards=2)
    jsrc = jsources.InMemorySource(corpus, 3, 2, 2, 16, seed=2, n_model_shards=2)
    td, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    tsources.save_segments(tsrc, td)
    jsources.save_segments(jsrc, jd)
    tf, jf = _dir_files(td), _dir_files(jd)
    assert sorted(tf) == sorted(jf)
    assert all(tf[n] == jf[n] for n in tf if not n.endswith(".npz"))
    for d in (td, jd):
        t, j = tsources.open_segments(d), jsources.open_segments(d)
        assert (t.n_model_shards, t.rows_coarse) == (j.n_model_shards, j.rows_coarse)
        assert t.n_model_shards == 2
        for g in range(t.n_segments):
            ts, js = t.segment(g), j.segment(g)
            _same_shards(ts, js)
            assert (ts.n_model_shards, ts.rows_coarse) == (js.n_model_shards, js.rows_coarse)
            wl = np.asarray(ts.word_local)
            seen = np.zeros(t.n_tokens, np.int64)
            for r in range(4):
                bwl, _, buid, _ = tsources.segment_block(ts, RankLayout(1, 2, 2, rank=r))
                assert bwl.shape == (1, wl.shape[1], wl.shape[2] // 2)
                np.add.at(seen, np.asarray(buid)[bwl >= 0], 1)
            uid = np.asarray(ts.uid)[wl >= 0]
            assert (seen[uid] == 1).all() and seen.sum() == uid.size
