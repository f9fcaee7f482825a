"""The port's corpus preprocessing, segment layout and corpus sources against
the JAX package's, bit for bit (all of it is host numpy on both sides)."""
import numpy as np
import pytest

from repro.data import corpus as jcorpus, sources as jsources, synthetic as jsynthetic
from repro_torch.data import corpus as tcorpus, sources as tsources

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
