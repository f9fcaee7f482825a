"""Synthetic corpora with known ground truth, click logs and relevance sets,
copied from ``repro.data.synthetic``.

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
def click_log(
    seed: int,
    corpus: Corpus,
    truth: LDAGroundTruth,
    n_impressions: int,
    n_ad_features: int = 200,
    topic_signal: float = 2.0,
):
    """Synthetic ad-impression log whose CTR depends on (ad, query-topic) affinity.

    Each impression: a query document d, an ad a with sparse features; the label
    is Bernoulli(sigmoid(bias + w_ad + topic_signal * <topic(d), ad_affinity_a>)).
    Because the true CTR depends on the *topic* of the query, a pCTR model gains
    AUC only insofar as its topic features resolve the query's topics — the
    mechanism behind the paper's Fig. 8.
    """
    rng = np.random.default_rng(seed)
    K = truth.doc_topic.shape[1]
    n_ads = max(20, n_ad_features // 4)
    ad_affinity = rng.dirichlet(np.full(K, 0.2), size=n_ads)      # [A, K]
    ad_bias = rng.normal(-2.0, 0.5, size=n_ads)
    ad_feat = rng.integers(0, n_ad_features, size=(n_ads, 3))     # 3 sparse feats/ad
    # global topic click-propensity: some query intents convert regardless of
    # the ad (the component a log-linear model can capture from P(k|d) alone)
    topic_prop = rng.normal(0.0, 1.0, size=K)

    doc_idx = rng.integers(0, truth.doc_topic.shape[0], size=n_impressions)
    ad_idx = rng.integers(0, n_ads, size=n_impressions)
    affinity = np.einsum("ik,ik->i", truth.doc_topic[doc_idx], ad_affinity[ad_idx])
    propensity = truth.doc_topic[doc_idx] @ topic_prop
    logit = (ad_bias[ad_idx]
             + topic_signal * propensity
             + topic_signal * (affinity - affinity.mean()) * 5.0)
    label = (rng.uniform(size=n_impressions) < 1.0 / (1.0 + np.exp(-logit))).astype(np.int32)
    return {
        "doc_idx": doc_idx.astype(np.int32),
        "ad_idx": ad_idx.astype(np.int32),
        "ad_feat": ad_feat,          # [A, 3] feature ids
        "n_ad_features": n_ad_features,
        "label": label,
    }


def relevance_judgments(
    seed: int,
    corpus: Corpus,
    truth: LDAGroundTruth,
    n_queries: int = 50,
    n_urls_per_query: int = 40,
):
    """Synthetic query–URL relevance set for the Fig. 7 MAP benchmark.

    URLs are other documents; the human "rating" is thresholded cosine of the
    TRUE topic mixtures, so retrieval quality improves exactly when inferred
    topic features approximate the truth.
    """
    rng = np.random.default_rng(seed)
    D = truth.doc_topic.shape[0]
    queries = rng.choice(D, size=min(n_queries, D // 2), replace=False)
    urls = []
    labels = []
    dt = truth.doc_topic / np.linalg.norm(truth.doc_topic, axis=1, keepdims=True)
    for q in queries:
        cand = rng.choice(D, size=n_urls_per_query, replace=False)
        sim = dt[cand] @ dt[q]
        urls.append(cand)
        labels.append((sim > np.quantile(sim, 0.8)).astype(np.int32))
    return queries, np.array(urls), np.array(labels)
