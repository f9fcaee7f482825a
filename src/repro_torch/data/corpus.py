"""Corpus containers, §4.1 preprocessing and the Peacock shard/segment
layout (host-side numpy), copied from ``repro.data.corpus``.

``Corpus``, ``corpus_from_docs``, ``preprocess``, ``pad_corpus``, the ring
layout ``vocab_placement``, ``ShardedCorpus``, ``shard_corpus`` (with the
word-sharded layout of ``n_model_shards > 1``: slice-major rows padded to
``P·ceil(rows/P)`` and bucket-major capacity), the pod partition
``shard_corpus_pods``, and the outer segmentation ``Segments``,
``assign_segments``, ``segment_corpus``: the same inputs and seeds give the
same arrays as the JAX package's. The port keeps its own copy so that it
never imports ``repro`` (whose ``data`` package loads jax).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence

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


def preprocess(
    docs: List[np.ndarray],
    vocab_size: int,
    min_word_freq: int = 2,
    max_word_fraction: float = 0.2,
    drop_single_word_docs: bool = True,
    dedup_docs: bool = True,
):
    """Paper §4.1 — the five preprocessing steps, in order:

    1. tokenize + count word frequencies (input is already token ids),
    2. remove low-frequency words (likely typos),
    3. remove very-high-frequency words (common words dominate topics [23]),
    4. de-duplicate identical documents (keep one appearance),
    5. drop single-word documents (no co-occurrence signal).

    Returns (Corpus with a compacted vocabulary, old→new vocab id map).
    """
    freq = np.zeros(vocab_size, np.int64)
    for d in docs:
        np.add.at(freq, d, 1)
    total = freq.sum()
    keep = (freq >= min_word_freq) & (freq <= max_word_fraction * max(total, 1))
    remap = np.full(vocab_size, -1, np.int64)
    remap[keep] = np.arange(int(keep.sum()))

    seen = set()
    out_docs = []
    for d in docs:
        nd = remap[d]
        nd = nd[nd >= 0].astype(np.int32)
        if drop_single_word_docs and len(nd) < 2:
            continue
        if dedup_docs:
            key = nd.tobytes()
            if key in seen:
                continue
            seen.add(key)
        out_docs.append(nd)
    return corpus_from_docs(out_docs, int(keep.sum())), remap


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

    Under word-sharded model parallelism (``n_model_shards = P > 1``,
    DESIGN.md §10) each vocab shard's rows are further split into P model
    slices: ``local_of_word``/``word_local`` already carry the slice-major row
    permutation (coarse row r → slice ``r % P`` at in-slice position
    ``r // P``), ``rows_per_shard`` is padded to ``P · ceil(rows_coarse / P)``
    and each sub-block's ``cap`` positions are bucket-major — positions
    ``[j·cap/P, (j+1)·cap/P)`` hold exactly the tokens whose words live in
    slice j, so slicing the cap dim over the "model" mesh axis hands every
    device precisely the tokens it owns Φ rows for. ``rows_coarse`` keeps the
    pre-padding coarse row count (the resharding loader's pivot).
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
    n_model_shards: int = 1
    rows_coarse: int = 0         # coarse rows before slice padding (0 → same
                                 # as rows_per_shard; set by shard_corpus)


def shard_corpus(
    corpus: Corpus,
    n_data_shards: int,
    n_vocab_shards: int,
    n_topics: int,
    seed: int = 0,
    cap_multiple: int = 8,
    placement=None,
    min_cap: int = 0,
    min_docs_per_shard: int = 0,
    uids=None,
    probe_only: bool = False,
    n_model_shards: int = 1,
) -> ShardedCorpus:
    """Shuffle docs (paper: randomize to balance blocks), round-robin them to data
    shards, split each shard's tokens by vocab shard, pad to one capacity.

    ``placement`` — optional shared (shard_of, local_of, rows) so that multiple
    segments / pod partitions agree on one vocabulary layout (phi shards must be
    stable across them); it is always the COARSE placement — the model-slice
    permutation below is applied on top of it. ``min_cap``/
    ``min_docs_per_shard`` force common static shapes across partitions.
    ``uids`` — optional [n_tokens] global token ids (default ``arange``): a
    segment/pod sub-corpus must pass the ids of its tokens in the FULL corpus,
    or tokens in different partitions would share counter-based RNG keys.
    ``probe_only=True`` returns just ``(cap, docs_per_shard)`` — the static
    shapes — after the vectorized counting, skipping the per-token stack build
    (the slow pure-Python pass); the common-shape two-pass builders use it so
    they never shard twice.

    ``n_model_shards = P > 1`` builds the word-sharded layout (DESIGN.md §10):
    coarse row r moves to slice ``r % P`` (round-robin by frequency rank keeps
    slices token-balanced, like the shards themselves), rows pad to
    ``P · ceil(rows / P)``, and each sub-block's cap positions are bucket-major
    (bucket j = slice-j tokens, padded per bucket to ``cap / P``).
    """
    rng = np.random.default_rng(seed)
    if placement is None:
        freq = np.bincount(corpus.word_ids, minlength=corpus.vocab_size)
        shard_of, local_of, rows = vocab_placement(freq, n_vocab_shards)
    else:
        shard_of, local_of, rows = placement
    P_ = max(1, int(n_model_shards))
    rpm = (rows + P_ - 1) // P_              # rows per model slice
    rows_total = P_ * rpm
    # fold the slice permutation into the local row ids: with P_ = 1 this is
    # the identity, so the replicated layout stays bit-for-bit what it was
    local_eff = (local_of % P_) * rpm + local_of // P_

    doc_perm = rng.permutation(corpus.n_docs)
    data_shard_of_doc = np.empty(corpus.n_docs, np.int32)
    doc_local_of_doc = np.empty(corpus.n_docs, np.int32)
    for pos, d in enumerate(doc_perm):
        data_shard_of_doc[d] = pos % n_data_shards
        doc_local_of_doc[d] = pos // n_data_shards
    docs_per_shard = max(int(np.ceil(corpus.n_docs / n_data_shards)), min_docs_per_shard, 1)

    tok_data_shard = data_shard_of_doc[corpus.doc_ids]
    tok_vocab_shard = shard_of[corpus.word_ids]
    tok_slice = local_of[corpus.word_ids] % P_

    counts = np.zeros((n_data_shards, n_vocab_shards, P_), np.int64)
    np.add.at(counts, (tok_data_shard, tok_vocab_shard, tok_slice), 1)
    capb = max(int(counts.max()), -(-min_cap // P_))
    capb = ((capb + cap_multiple - 1) // cap_multiple) * cap_multiple
    capb = max(capb, cap_multiple)
    cap = P_ * capb
    if probe_only:
        return cap, docs_per_shard

    S, M = n_data_shards, n_vocab_shards
    word_local = np.full((S, M, cap), -1, np.int32)
    doc_local = np.zeros((S, M, cap), np.int32)
    uid = np.zeros((S, M, cap), np.uint32)
    z0 = np.zeros((S, M, cap), np.int32)

    fill = np.zeros((S, M, P_), np.int64)
    z_init = rng.integers(0, n_topics, corpus.n_tokens).astype(np.int32)
    if uids is None:
        uids = np.arange(corpus.n_tokens, dtype=np.uint32)
    for t in range(corpus.n_tokens):
        s = tok_data_shard[t]
        m = tok_vocab_shard[t]
        j = tok_slice[t]
        p = j * capb + fill[s, m, j]
        word_local[s, m, p] = local_eff[corpus.word_ids[t]]
        doc_local[s, m, p] = doc_local_of_doc[corpus.doc_ids[t]]
        uid[s, m, p] = uids[t]
        z0[s, m, p] = z_init[t]
        fill[s, m, j] += 1

    return ShardedCorpus(
        word_local=word_local, doc_local=doc_local, uid=uid, z0=z0,
        shard_of_word=shard_of, local_of_word=local_eff,
        rows_per_shard=rows_total, docs_per_shard=docs_per_shard,
        n_data_shards=S, n_vocab_shards=M, vocab_size=corpus.vocab_size,
        n_real_tokens=corpus.n_tokens,
        n_model_shards=P_, rows_coarse=rows,
    )


def pad_corpus(word_ids: np.ndarray, doc_ids: np.ndarray, multiple: int):
    """Pad flat token arrays with word_id=-1 sentinels to a block multiple."""
    pad = (-len(word_ids)) % multiple
    return (
        np.pad(word_ids, (0, pad), constant_values=-1).astype(np.int32),
        np.pad(doc_ids, (0, pad), constant_values=0).astype(np.int32),
    )


@dataclasses.dataclass
class Segments:
    """Outer segmentation for bigger-than-device-memory corpora.

    Mirrors Fig. 3/4: the epoch driver iterates segments, loading each segment's
    sharded arrays to device (LoadShard), running the ring epoch, and writing the
    updated z back to host (SaveShard). Segment boundaries are document-aligned.
    """

    segments: List[ShardedCorpus]

    def __iter__(self) -> Iterator[ShardedCorpus]:
        return iter(self.segments)

    def __len__(self) -> int:
        return len(self.segments)


def assign_segments(n_docs: int, n_segments: int, seed: int = 0) -> np.ndarray:
    """Document→segment assignment from a seeded permutation.

    Returns ``seg_of_doc`` [n_docs] int32. Deterministic given (n_docs,
    n_segments, seed), balanced to within one document per segment, and —
    unlike ``doc_id % n_segments`` — decorrelated from any ordering the
    corpus arrived in (adjacent/near-duplicate documents spread across
    segments, which is what keeps per-segment token counts, and therefore
    the shared static capacity, balanced).
    """
    perm = np.random.default_rng(seed).permutation(n_docs)
    seg_of = np.empty(n_docs, np.int32)
    seg_of[perm] = np.arange(n_docs, dtype=np.int32) % n_segments
    return seg_of


def segment_corpus(
    corpus: Corpus, n_segments: int, n_data_shards: int, n_vocab_shards: int,
    n_topics: int, seed: int = 0, n_model_shards: int = 1,
) -> Segments:
    """Split documents into segments (seeded permutation), shard each segment.

    All segments share one global vocab placement so that phi shards are stable
    across segments (re-derived from the full-corpus frequency), and one common
    static shape (cap, docs_per_shard): the ring epoch is compiled once and
    every segment swap reuses it — segment count is a memory knob, never a
    recompile.
    """
    if n_segments == 1:
        return Segments([shard_corpus(corpus, n_data_shards, n_vocab_shards,
                                      n_topics, seed,
                                      n_model_shards=n_model_shards)])
    # one global vocab placement for every segment (phi shards must be stable)
    freq = np.bincount(corpus.word_ids, minlength=corpus.vocab_size)
    placement = vocab_placement(freq, n_vocab_shards)
    seg_of = assign_segments(corpus.n_docs, n_segments, seed)
    subs = []
    guids = []
    for g in range(n_segments):
        mask = seg_of[corpus.doc_ids] == g
        w = corpus.word_ids[mask]
        d = corpus.doc_ids[mask]
        # compact doc ids within the segment; uids stay GLOBAL token ids
        uniq, inv = np.unique(d, return_inverse=True)
        subs.append(Corpus(w, inv.astype(np.int32), len(uniq), corpus.vocab_size))
        guids.append(np.nonzero(mask)[0].astype(np.uint32))
    # shape probe (vectorized counting only), then ONE build per segment
    probe = [
        shard_corpus(s, n_data_shards, n_vocab_shards, n_topics, seed + g,
                     placement=placement, probe_only=True,
                     n_model_shards=n_model_shards)
        for g, s in enumerate(subs)
    ]
    cap = max(c for c, _ in probe)
    dps = max(d for _, d in probe)
    return Segments([
        shard_corpus(s, n_data_shards, n_vocab_shards, n_topics, seed + g,
                     placement=placement, min_cap=cap, min_docs_per_shard=dps,
                     uids=u, n_model_shards=n_model_shards)
        for g, (s, u) in enumerate(zip(subs, guids))
    ])


def shard_corpus_pods(
    corpus: Corpus,
    n_pods: int,
    n_data_shards: int,
    n_vocab_shards: int,
    n_topics: int,
    seed: int = 0,
    n_model_shards: int = 1,
) -> List[ShardedCorpus]:
    """Partition documents across Peacock configurations (pods), with one shared
    vocab placement and common static shapes (cap, docs_per_shard) across pods."""
    freq = np.bincount(corpus.word_ids, minlength=corpus.vocab_size)
    placement = vocab_placement(freq, n_vocab_shards)
    subs = []
    guids = []
    for p in range(n_pods):
        mask = (corpus.doc_ids % n_pods) == p
        w = corpus.word_ids[mask]
        d = corpus.doc_ids[mask]
        uniq, inv = np.unique(d, return_inverse=True)
        subs.append(Corpus(w, inv.astype(np.int32), len(uniq), corpus.vocab_size))
        guids.append(np.nonzero(mask)[0].astype(np.uint32))
    # shape probe (vectorized counting only), then ONE build per pod
    probe = [
        shard_corpus(s, n_data_shards, n_vocab_shards, n_topics, seed + p,
                     placement=placement, probe_only=True,
                     n_model_shards=n_model_shards)
        for p, s in enumerate(subs)
    ]
    cap = max(c for c, _ in probe)
    dps = max(d for _, d in probe)
    return [
        shard_corpus(s, n_data_shards, n_vocab_shards, n_topics, seed + p,
                     placement=placement, min_cap=cap, min_docs_per_shard=dps,
                     uids=u, n_model_shards=n_model_shards)
        for p, (s, u) in enumerate(zip(subs, guids))
    ]
