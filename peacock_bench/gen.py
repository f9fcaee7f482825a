"""Inputs made from ``--seed``: the training corpus, the serving model's
counts, the served queries and their arrival times.

The generator is the LDA process of ``repro_torch/data/synthetic.py``
(``zipf_topics``, ``lda_corpus(query_like=True)``): each topic a Zipf(1.1)
bump over 20 words of its own with a 1e-8 floor over the whole vocabulary,
each document a Dirichlet(0.3) mixture of topics, query lengths
max(2, Poisson(4.5)). It is restated here vectorised: the per-document loop
there takes seconds for 4,096 queries and minutes for 163,840. A document's
topics are drawn as the Dirichlet-multinomial urn, which has the same law as
a Dirichlet draw followed by multinomial draws.

Work is the same for every seed. The training corpus is drawn once for its
shapes from a fixed stream, and a seed relabels its words (a permutation of
the vocabulary) and reorders its documents: every seed has the same number
of distinct words, the same word counts and the same document lengths, on
which the samplers' table rows and pair rows depend. Served queries take
their lengths from a fixed multiset that each seed permutes, and a cell's
arrival times are a fixed count of uniform points. A seed changes which
words, topics and queries, and their order.
"""
from __future__ import annotations

import numpy as np

WORDS_PER_TOPIC = 20
ZIPF_SKEW = 1.1
WORD_FLOOR = 1e-8          # synthetic.zipf_topics' floor on every word
DOC_ALPHA = 0.3            # synthetic.lda_corpus' Dirichlet concentration
MIN_LEN = 2
_MULTISET_SEED = 0x5EED_0001
_CORPUS_SEED = 0x5EED_0002


def _ranks() -> np.ndarray:
    return np.arange(1, WORDS_PER_TOPIC + 1, dtype=np.float64) ** (-ZIPF_SKEW)


def floor_share(vocab: int) -> float:
    """Probability that a token is the floor's uniform word rather than one
    of its topic's 20."""
    floor = vocab * WORD_FLOOR
    return floor / (float(_ranks().sum()) + floor)


def lengths(n: int, mean: float, long_share: float = 0.0, long_range=(9, 64)) -> np.ndarray:
    """The fixed multiset of ``n`` lengths: max(2, Poisson(mean)), with
    ``long_share`` of them log-uniform over ``long_range`` (inclusive)."""
    rng = np.random.default_rng(_MULTISET_SEED)
    n_long = int(round(n * long_share))
    short = np.maximum(MIN_LEN, rng.poisson(mean, n - n_long))
    lo, hi = long_range
    long = np.floor(np.exp(rng.uniform(np.log(lo), np.log(hi + 1), n_long))).astype(np.int64)
    return np.concatenate([short, np.clip(long, lo, hi)]).astype(np.int64)


def zipf_topics(rng: np.random.Generator, n_topics: int, vocab: int):
    """(words [T, 20] int64, weights [T, 20] f64): each topic's word set,
    distinct words, and the Zipf weights in a random order over them."""
    words = np.stack([rng.choice(vocab, WORDS_PER_TOPIC, replace=False)
                      for _ in range(n_topics)])
    weights = rng.permuted(np.tile(_ranks(), (n_topics, 1)), axis=1)
    return words, weights


def _urn_topics(rng, doc_len: np.ndarray, n_topics: int, concentration: float):
    """Topics of every token, document by document, as the Dirichlet-
    multinomial urn with total concentration ``concentration`` over
    ``n_topics`` symmetric topics: a document's p-th token copies the topic
    of one of its p earlier tokens with probability p / (p + concentration),
    else draws a topic uniformly."""
    n = int(doc_len.sum())
    doc = np.repeat(np.arange(doc_len.shape[0]), doc_len)
    start = np.cumsum(doc_len) - doc_len
    pos = np.arange(n) - start[doc]
    u, pick = rng.random(n), rng.random(n)
    fresh = rng.integers(0, n_topics, n)
    topic = np.empty(n, np.int64)
    for p in range(int(doc_len.max()) if n else 0):
        at = np.nonzero(pos == p)[0]
        copy = u[at] < p / (p + concentration)
        src = start[doc[at]] + np.minimum((pick[at] * p).astype(np.int64), max(p - 1, 0))
        topic[at] = np.where(copy, topic[src] if p else 0, fresh[at])
    return doc, topic


def _words_of(rng, topic, words, weights, vocab: int) -> np.ndarray:
    """One word for each token: its topic's word by Zipf weight, or, with
    the floor's share, a uniform word."""
    n = topic.shape[0]
    cdf = np.cumsum(weights, axis=1)
    r = rng.random(n) * cdf[topic, -1]
    j = np.minimum((cdf[topic] < r[:, None]).sum(axis=1), WORDS_PER_TOPIC - 1)
    out = words[topic, j]
    noise = rng.random(n) < floor_share(vocab)
    out[noise] = rng.integers(0, vocab, int(noise.sum()))
    return out


def lda_corpus(seed, n_docs: int, n_topics: int, vocab: int, mean_len: float):
    """A query-like corpus: (word_ids [N] int32, doc_ids [N] int32, sorted).
    The corpus of these shapes from the fixed stream, its words relabelled
    and its documents reordered by the seed."""
    fixed = np.random.default_rng([_CORPUS_SEED, n_docs, n_topics, vocab])
    words, weights = zipf_topics(fixed, n_topics, vocab)
    doc_len = fixed.permutation(lengths(n_docs, mean_len))
    doc, topic = _urn_topics(fixed, doc_len, n_topics, DOC_ALPHA * n_topics)
    word = _words_of(fixed, topic, words, weights, vocab)
    rng = np.random.default_rng(seed)
    word = rng.permutation(vocab)[word]
    doc = rng.permutation(n_docs)[doc]
    order = np.argsort(doc, kind="stable")
    return word[order].astype(np.int32), doc[order].astype(np.int32)


def serving_counts(seed: int, n_topics: int, vocab: int, tokens_per_topic: int, device):
    """The serving model's Φ [V, K] int32, made on ``device`` from the seed in
    a few large calls: the counts of a corpus drawn from the generator with
    ``tokens_per_topic`` tokens a topic on average. Each topic's 20 words
    (with replacement: a repeat adds to one word) take Poisson counts of
    their Zipf share; floor words take Poisson(floor share · n_k) uniform
    words, at most 32 a topic. Returns (phi, words [K, 20], weights [K, 20])
    with the last two on the host, for the queries."""
    import torch

    g = torch.Generator(device=device).manual_seed(int(seed) & (2 ** 63 - 1))
    K, V = n_topics, vocab
    words = torch.randint(0, V, (K, WORDS_PER_TOPIC), generator=g, device=device)
    order = torch.argsort(torch.rand((K, WORDS_PER_TOPIC), generator=g, device=device), dim=1)
    ranks = torch.as_tensor(_ranks(), dtype=torch.float64, device=device)
    weights = ranks[order]
    n_k = torch.poisson(torch.full((K,), float(tokens_per_topic), dtype=torch.float64,
                                   device=device), generator=g)
    rate = n_k[:, None] * weights / (weights.sum(dim=1, keepdim=True) * (1 + floor_share(V)))
    counts = torch.poisson(rate, generator=g).to(torch.int32)
    phi = torch.zeros((V, K), dtype=torch.int32, device=device)
    cols = torch.arange(K, device=device)[:, None]
    phi.index_put_((words, cols.expand_as(words)), counts, accumulate=True)
    n_floor = torch.poisson(n_k * floor_share(V), generator=g).clamp(max=32).to(torch.int64)
    fw = torch.randint(0, V, (K, 32), generator=g, device=device)
    live = torch.arange(32, device=device)[None, :] < n_floor[:, None]
    phi.index_put_((fw[live], cols.expand_as(fw)[live]),
                   torch.ones((), dtype=torch.int32, device=device), accumulate=True)
    return phi, words.cpu().numpy(), weights.cpu().numpy()


def queries(seed: int, n: int, words, weights, vocab: int, mean_len: float,
            long_share: float, concentration: float):
    """``n`` distinct queries (int32 arrays) drawn from the model's topics:
    lengths from the fixed multiset, permuted; topics by the urn with total
    concentration ``concentration`` over all topics; words as the
    generator's. A repeat is drawn again."""
    rng = np.random.default_rng(seed)
    n_topics = words.shape[0]
    q_len = rng.permutation(lengths(n, mean_len, long_share))
    out, seen = [None] * n, set()
    todo = np.arange(n)
    while todo.size:
        doc, topic = _urn_topics(rng, q_len[todo], n_topics, concentration)
        toks = _words_of(rng, topic, words, weights, vocab).astype(np.int32)
        parts = np.split(toks, np.cumsum(q_len[todo])[:-1])
        again = []
        for i, q in zip(todo, parts):
            key = q.tobytes()
            if key in seen:
                again.append(i)
            else:
                seen.add(key)
                out[i] = q
        todo = np.asarray(again, np.int64)
    return out


def arrivals(seed: int, rate: float, seconds: float) -> np.ndarray:
    """round(rate · seconds) due times in [0, seconds), sorted: a Poisson
    process conditioned on its count, so every seed offers the same number
    of requests."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.uniform(0.0, seconds, int(round(rate * seconds))))


def zipf_picks(seed: int, n: int, pool: int, s: float = 1.0) -> np.ndarray:
    """``n`` draws of pool ranks under Zipf(s): rank r with probability
    ∝ 1/r^s (``launch/serve.py:make_zipf_traffic``)."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, pool + 1, dtype=np.float64) ** s
    return rng.choice(pool, size=n, p=w / w.sum())
