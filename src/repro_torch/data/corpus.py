"""Corpus containers and the Peacock shard layout (host-side numpy), copied
from ``repro.data.corpus``.

What the port's slices need: ``Corpus``, ``corpus_from_docs``, ``pad_corpus``,
and the ring layout ``vocab_placement``, ``ShardedCorpus``, ``shard_corpus``
(the same seed gives the same arrays). The port keeps its own
copy so that it never imports ``repro`` (whose ``data`` package loads jax).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class Corpus:
    """Token-level corpus. Tokens of one document are contiguous."""

    word_ids: np.ndarray   # [N] int32
    doc_ids: np.ndarray    # [N] int32, sorted ascending
    n_docs: int
    vocab_size: int

    @property
    def n_tokens(self) -> int:
        return int(self.word_ids.shape[0])

    def doc_lengths(self) -> np.ndarray:
        return np.bincount(self.doc_ids, minlength=self.n_docs)


def corpus_from_docs(docs: Sequence[np.ndarray], vocab_size: int) -> Corpus:
    word_ids = np.concatenate([np.asarray(d, np.int32) for d in docs]) if docs else np.zeros(0, np.int32)
    doc_ids = np.concatenate(
        [np.full(len(d), i, np.int32) for i, d in enumerate(docs)]
    ) if docs else np.zeros(0, np.int32)
    return Corpus(word_ids, doc_ids, len(docs), vocab_size)


def pad_corpus(word_ids: np.ndarray, doc_ids: np.ndarray, multiple: int):
    """Pad flat token arrays with word_id=-1 sentinels to a block multiple."""
    pad = (-len(word_ids)) % multiple
    return (
        np.pad(word_ids, (0, pad), constant_values=-1).astype(np.int32),
        np.pad(doc_ids, (0, pad), constant_values=0).astype(np.int32),
    )


def vocab_placement(word_freq: np.ndarray, n_shards: int):
    """Weighted round-robin word→shard placement (paper §3.1.3, PLDA+ [17]).

    Returns (shard_of_word [V], local_row_of_word [V], rows_per_shard).
    Guarantees near-equal total token frequency per shard, which is what makes
    the ring sub-blocks (and therefore the static capacity) balanced.
    """
    V = word_freq.shape[0]
    order = np.argsort(-word_freq, kind="stable")
    shard_of = np.zeros(V, np.int32)
    local_of = np.zeros(V, np.int32)
    load = np.zeros(n_shards, np.int64)
    fill = np.zeros(n_shards, np.int32)
    for w in order:
        s = int(np.argmin(load))
        shard_of[w] = s
        local_of[w] = fill[s]
        fill[s] += 1
        load[s] += int(word_freq[w]) + 1  # +1 keeps zero-freq words spread too
    return shard_of, local_of, int(fill.max())


@dataclasses.dataclass
class ShardedCorpus:
    """Static-shape ring layout: [n_data_shards, n_vocab_shards, cap] arrays.

    ``word_local`` holds the row index within the owning vocab shard (-1 = pad);
    ``doc_local`` the document index within the data shard; ``uid`` a globally
    unique uint32 token id (the counter-based RNG key, stable across layouts).
    """

    word_local: np.ndarray   # [S, M, cap] int32, -1 padding
    doc_local: np.ndarray    # [S, M, cap] int32
    uid: np.ndarray          # [S, M, cap] uint32
    z0: np.ndarray           # [S, M, cap] int32 initial assignments (pad: 0)
    shard_of_word: np.ndarray    # [V] int32
    local_of_word: np.ndarray    # [V] int32
    rows_per_shard: int
    docs_per_shard: int
    n_data_shards: int
    n_vocab_shards: int
    vocab_size: int
    n_real_tokens: int


def shard_corpus(
    corpus: Corpus,
    n_data_shards: int,
    n_vocab_shards: int,
    n_topics: int,
    seed: int = 0,
    cap_multiple: int = 8,
) -> ShardedCorpus:
    """Shuffle docs (paper: randomize to balance blocks), round-robin them to data
    shards, split each shard's tokens by vocab shard, pad to one capacity.

    The layout of ``repro.data.corpus.shard_corpus`` at its defaults (one
    corpus, token uids ``arange``, no word-sharded model slices): the same
    seed gives the same arrays.
    """
    rng = np.random.default_rng(seed)
    freq = np.bincount(corpus.word_ids, minlength=corpus.vocab_size)
    shard_of, local_of, rows = vocab_placement(freq, n_vocab_shards)

    doc_perm = rng.permutation(corpus.n_docs)
    data_shard_of_doc = np.empty(corpus.n_docs, np.int32)
    doc_local_of_doc = np.empty(corpus.n_docs, np.int32)
    for pos, d in enumerate(doc_perm):
        data_shard_of_doc[d] = pos % n_data_shards
        doc_local_of_doc[d] = pos // n_data_shards
    docs_per_shard = max(int(np.ceil(corpus.n_docs / n_data_shards)), 1)

    tok_data_shard = data_shard_of_doc[corpus.doc_ids]
    tok_vocab_shard = shard_of[corpus.word_ids]

    counts = np.zeros((n_data_shards, n_vocab_shards), np.int64)
    np.add.at(counts, (tok_data_shard, tok_vocab_shard), 1)
    cap = ((int(counts.max()) + cap_multiple - 1) // cap_multiple) * cap_multiple
    cap = max(cap, cap_multiple)

    S, M = n_data_shards, n_vocab_shards
    word_local = np.full((S, M, cap), -1, np.int32)
    doc_local = np.zeros((S, M, cap), np.int32)
    uid = np.zeros((S, M, cap), np.uint32)
    z0 = np.zeros((S, M, cap), np.int32)

    fill = np.zeros((S, M), np.int64)
    z_init = rng.integers(0, n_topics, corpus.n_tokens).astype(np.int32)
    uids = np.arange(corpus.n_tokens, dtype=np.uint32)
    for t in range(corpus.n_tokens):
        s = tok_data_shard[t]
        m = tok_vocab_shard[t]
        p = fill[s, m]
        word_local[s, m, p] = local_of[corpus.word_ids[t]]
        doc_local[s, m, p] = doc_local_of_doc[corpus.doc_ids[t]]
        uid[s, m, p] = uids[t]
        z0[s, m, p] = z_init[t]
        fill[s, m] += 1

    return ShardedCorpus(
        word_local=word_local, doc_local=doc_local, uid=uid, z0=z0,
        shard_of_word=shard_of, local_of_word=local_of,
        rows_per_shard=rows, docs_per_shard=docs_per_shard,
        n_data_shards=S, n_vocab_shards=M, vocab_size=corpus.vocab_size,
        n_real_tokens=corpus.n_tokens,
    )
