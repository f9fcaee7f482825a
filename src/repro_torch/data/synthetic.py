"""Synthetic corpora with known ground truth, copied from ``repro.data.synthetic``.

Documents are drawn from a true LDA generative process with Zipf-distributed
topic-word distributions. The same seed gives the same arrays as the JAX
package's generator (same numpy calls in the same order).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.data.corpus import Corpus, corpus_from_docs


@dataclasses.dataclass
class LDAGroundTruth:
    topic_word: np.ndarray   # [K, V] true P(v|k)
    doc_topic: np.ndarray    # [D, K] true P(k|d)


def zipf_topics(rng, n_topics: int, vocab_size: int, words_per_topic: int = 20,
                skew: float = 1.1) -> np.ndarray:
    """Each topic = a Zipf bump over its own word set (long-tail by design:
    later topics get rarer word sets, mimicking long-tail semantics)."""
    tw = np.full((n_topics, vocab_size), 1e-8)
    ranks = np.arange(1, words_per_topic + 1, dtype=np.float64) ** (-skew)
    for k in range(n_topics):
        words = rng.choice(vocab_size, size=words_per_topic, replace=False)
        tw[k, words] += rng.permutation(ranks)
    return tw / tw.sum(axis=1, keepdims=True)


def lda_corpus(
    seed: int,
    n_docs: int,
    n_topics: int,
    vocab_size: int,
    doc_len_mean: float = 8.0,
    alpha: float = 0.3,
    query_like: bool = False,
    stopword_frac: float = 0.0,
    n_stopwords: int = 0,
) -> Tuple[Corpus, LDAGroundTruth]:
    """Generate a corpus from the LDA generative process.

    ``query_like=True`` uses the paper's SOSO statistics (short docs, mean 4.5
    tokens, min 2). ``stopword_frac`` mixes a shared high-frequency word
    distribution into every topic (the "common words dominate topics" effect
    behind the duplicate topics of paper §3.3).
    """
    rng = np.random.default_rng(seed)
    tw = zipf_topics(rng, n_topics, vocab_size)
    if stopword_frac > 0:
        n_sw = n_stopwords or max(5, vocab_size // 50)
        sw = np.zeros(vocab_size)
        sw[:n_sw] = rng.zipf(1.3, n_sw) + 1.0
        sw = sw / sw.sum()
        tw = (1 - stopword_frac) * tw + stopword_frac * sw[None, :]
    if query_like:
        doc_len_mean = 4.5
    dt = rng.dirichlet(np.full(n_topics, alpha), size=n_docs)
    docs: List[np.ndarray] = []
    for d in range(n_docs):
        n = max(2, int(rng.poisson(doc_len_mean)))
        ks = rng.choice(n_topics, size=n, p=dt[d])
        ws = np.array([rng.choice(vocab_size, p=tw[k]) for k in ks], np.int32)
        docs.append(ws)
    return corpus_from_docs(docs, vocab_size), LDAGroundTruth(tw, dt)
