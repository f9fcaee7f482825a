"""``CorpusSource`` — the typed corpus API behind the ``Trainer`` (port of
the resident part of ``repro.data.sources``).

A source describes a corpus as global statistics plus ring-sharded
**segments**. Ported here: the protocol, :class:`InMemorySource` (a resident
:class:`Corpus`), :class:`SyntheticSource` (the explicit, logged synthetic
fallback), the per-epoch visit order :func:`segment_order` and the global
initial assignment :func:`initial_z`. The on-disk ``DiskSource`` with
``save_segments``/``open_segments`` comes with the streaming pipeline
(``data/stream.py``, ROADMAP queue 1).

Invariants every source guarantees, as in the JAX package: one stable vocab
placement across segments, one common static shape, global token uids, and a
deterministic per-epoch visit order drawn from a seeded permutation.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from repro_torch.data.corpus import Corpus, ShardedCorpus, segment_corpus


def segment_order(n_segments: int, epoch: int, seed: int) -> np.ndarray:
    """Deterministic per-epoch segment visit order (seeded permutation).

    Stable given (n_segments, epoch, seed): a resume regenerates the
    identical order to continue from a recorded segment boundary.
    """
    if n_segments == 1:
        return np.zeros(1, np.int64)
    return np.random.default_rng([int(seed) & 0x7FFFFFFF, int(epoch)]).permutation(n_segments)


class CorpusSource:
    """Protocol base: global corpus statistics + an iterator of segments.

    Attributes (all set by concrete sources): ``n_docs``, ``n_tokens``,
    ``vocab_size``, ``n_topics``, ``n_segments``, ``n_data_shards``,
    ``n_vocab_shards``, ``seed``, and ``corpus`` (the resident
    :class:`Corpus`, or ``None`` for out-of-core sources).
    """

    corpus: Optional[Corpus] = None
    n_docs: int
    n_tokens: int
    vocab_size: int
    n_topics: int
    n_segments: int
    n_data_shards: int
    n_vocab_shards: int
    n_model_shards: int = 1     # word-sharded layouts are not ported
    seed: int

    def word_freq(self) -> np.ndarray:
        """Global [V] token frequencies (drives the stable vocab placement)."""
        raise NotImplementedError

    def doc_lengths(self) -> np.ndarray:
        """[n_docs] token counts (the α-optimizer's doc-length histogram)."""
        raise NotImplementedError

    def segment(self, g: int) -> ShardedCorpus:
        """Segment ``g`` in its ring-sharded layout (host arrays)."""
        raise NotImplementedError

    def iter_segments(self, epoch: int) -> Iterator[Tuple[int, ShardedCorpus]]:
        """Yield ``(segment_id, sharded_segment)`` in this epoch's visit order."""
        for g in segment_order(self.n_segments, epoch, self.seed):
            g = int(g)
            yield g, self.segment(g)

    def describe(self) -> str:
        return (f"{type(self).__name__}: {self.n_docs} docs / "
                f"{self.n_tokens} tokens / V={self.vocab_size} / "
                f"{self.n_segments} segment(s) on a "
                f"{self.n_data_shards}x{self.n_vocab_shards} ring")


class InMemorySource(CorpusSource):
    """A resident :class:`Corpus`, segmented and sharded on first access."""

    def __init__(self, corpus: Corpus, n_segments: int, n_data_shards: int,
                 n_vocab_shards: int, n_topics: int, seed: int = 0):
        self.corpus = corpus
        self.n_docs = int(corpus.n_docs)
        self.n_tokens = int(corpus.n_tokens)
        self.vocab_size = int(corpus.vocab_size)
        self.n_topics = int(n_topics)
        self.n_segments = int(n_segments)
        self.n_data_shards = int(n_data_shards)
        self.n_vocab_shards = int(n_vocab_shards)
        self.seed = int(seed)
        self._segments = None

    def word_freq(self) -> np.ndarray:
        return np.bincount(self.corpus.word_ids, minlength=self.vocab_size)

    def doc_lengths(self) -> np.ndarray:
        return self.corpus.doc_lengths()

    def segment(self, g: int) -> ShardedCorpus:
        if self._segments is None:
            self._segments = segment_corpus(
                self.corpus, self.n_segments, self.n_data_shards,
                self.n_vocab_shards, self.n_topics, seed=self.seed).segments
        return self._segments[g]


class SyntheticSource(InMemorySource):
    """Known-ground-truth LDA corpus (``synthetic.lda_corpus``) as a source.

    The Trainer routes ``corpus=None`` here explicitly and logs it. ``gen_seed``
    seeds the generator; ``seed`` the segmentation.
    """

    def __init__(self, n_docs: int, vocab_size: int, true_topics: int,
                 doc_len_mean: float, gen_seed: int, n_segments: int,
                 n_data_shards: int, n_vocab_shards: int, n_topics: int,
                 seed: int = 0):
        from repro_torch.data import synthetic

        corpus, truth = synthetic.lda_corpus(
            seed=gen_seed, n_docs=n_docs, n_topics=true_topics,
            vocab_size=vocab_size, doc_len_mean=doc_len_mean)
        self.truth = truth
        self.gen_seed = int(gen_seed)
        super().__init__(corpus, n_segments, n_data_shards, n_vocab_shards,
                         n_topics, seed=seed)


def initial_z(source: CorpusSource) -> np.ndarray:
    """The global [n_tokens] initial topic assignment, scattered by uid."""
    z = np.zeros(source.n_tokens, np.int32)
    for g in range(source.n_segments):
        sc = source.segment(g)
        valid = np.asarray(sc.word_local) >= 0
        z[np.asarray(sc.uid)[valid]] = np.asarray(sc.z0)[valid]
    return z
