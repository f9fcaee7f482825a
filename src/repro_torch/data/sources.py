"""``CorpusSource`` — the typed corpus API behind the ``Trainer`` (port of
``repro.data.sources``).

The paper trains 10⁵-topic LDA from 10⁹ search queries; that corpus is never
resident. A source describes a corpus as global statistics plus ring-sharded
**segments**, and the trainer streams segments through one ring epoch with
Φ/Ψ carried across the swaps (Fig. 3/4's LoadShard/SaveShard).

  * :class:`InMemorySource`  — a resident :class:`Corpus` (the 1-segment
    case is the resident path).
  * :class:`DiskSource`      — segments saved by :func:`save_segments` as
    per-segment ``.npy`` files plus one ``placement.npz`` + ``meta.json``;
    opened memory-mapped so only the active segment's tokens are read.
  * :class:`SyntheticSource` — the explicit, logged synthetic fallback.

The on-disk layout is the JAX package's, file for file (``placement.npz``,
``segment_<g:05d>/<array>.npy``, ``meta.json`` written last with each file's
SHA-256), so a directory written by either package opens in the other.

Invariants every source guarantees, as in the JAX package: one stable vocab
placement across segments, one common static shape, global token uids, and a
deterministic per-epoch visit order drawn from a seeded permutation.
"""
from __future__ import annotations

import json
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.data.corpus import Corpus, ShardedCorpus, segment_corpus
from repro_torch.reliability import faults

META = "meta.json"
PLACEMENT = "placement.npz"
SEGMENT_ARRAYS = ("word_local", "doc_local", "uid", "z0")


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
    n_model_shards: int = 1     # word-sharded layout (P > 1)
    seed: int

    def word_freq(self) -> np.ndarray:
        """Global [V] token frequencies (drives the stable vocab placement)."""
        raise NotImplementedError

    def doc_lengths(self) -> np.ndarray:
        """[n_docs] token counts (the α-optimizer's doc-length histogram)."""
        raise NotImplementedError

    def segment(self, g: int) -> ShardedCorpus:
        """Segment ``g`` in its ring-sharded layout (host arrays; a
        :class:`DiskSource` returns memory-mapped views)."""
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
                 n_vocab_shards: int, n_topics: int, seed: int = 0,
                 n_model_shards: int = 1):
        self.corpus = corpus
        self.n_docs = int(corpus.n_docs)
        self.n_tokens = int(corpus.n_tokens)
        self.vocab_size = int(corpus.vocab_size)
        self.n_topics = int(n_topics)
        self.n_segments = int(n_segments)
        self.n_data_shards = int(n_data_shards)
        self.n_vocab_shards = int(n_vocab_shards)
        self.seed = int(seed)
        self.n_model_shards = int(n_model_shards)
        self._segments = None

    def word_freq(self) -> np.ndarray:
        return np.bincount(self.corpus.word_ids, minlength=self.vocab_size)

    def doc_lengths(self) -> np.ndarray:
        return self.corpus.doc_lengths()

    def segment(self, g: int) -> ShardedCorpus:
        if self._segments is None:
            self._segments = segment_corpus(
                self.corpus, self.n_segments, self.n_data_shards,
                self.n_vocab_shards, self.n_topics, seed=self.seed,
                n_model_shards=self.n_model_shards).segments
        return self._segments[g]


class SyntheticSource(InMemorySource):
    """Known-ground-truth LDA corpus (``synthetic.lda_corpus``) as a source.

    The Trainer routes ``corpus=None`` here explicitly and logs it. ``gen_seed``
    seeds the generator; ``seed`` the segmentation.
    """

    def __init__(self, n_docs: int, vocab_size: int, true_topics: int,
                 doc_len_mean: float, gen_seed: int, n_segments: int,
                 n_data_shards: int, n_vocab_shards: int, n_topics: int,
                 seed: int = 0, n_model_shards: int = 1):
        from repro_torch.data import synthetic

        corpus, truth = synthetic.lda_corpus(
            seed=gen_seed, n_docs=n_docs, n_topics=true_topics,
            vocab_size=vocab_size, doc_len_mean=doc_len_mean)
        self.truth = truth
        self.gen_seed = int(gen_seed)
        super().__init__(corpus, n_segments, n_data_shards, n_vocab_shards,
                         n_topics, seed=seed, n_model_shards=n_model_shards)


def save_segments(source: CorpusSource, directory: str) -> str:
    """Write a source's segments as a :class:`DiskSource` directory.

    Layout (the JAX package's)::

        <dir>/placement.npz        — shard_of_word, local_of_word,
                                     word_freq, doc_lengths (small, resident)
        <dir>/segment_<g>/<a>.npy  — word_local / doc_local / uid / z0
                                     (the big stacks; mmap'd on open)
        <dir>/meta.json            — geometry + per-segment stats and each
                                     file's SHA-256; written LAST — its
                                     presence marks completeness

    Returns ``directory``.
    """
    os.makedirs(directory, exist_ok=True)
    # drop any previous save's completeness marker FIRST: while this save
    # rewrites arrays, a stale meta.json would make an interrupted re-save
    # open as a complete (but mixed old/new) corpus
    meta_path = os.path.join(directory, META)
    if os.path.exists(meta_path):
        os.remove(meta_path)
    sc0 = source.segment(0)
    np.savez(os.path.join(directory, PLACEMENT),
             shard_of_word=np.asarray(sc0.shard_of_word),
             local_of_word=np.asarray(sc0.local_of_word),
             word_freq=np.asarray(source.word_freq(), np.int64),
             doc_lengths=np.asarray(source.doc_lengths(), np.int64))
    seg_meta = []
    for g in range(source.n_segments):
        sc = source.segment(g)
        seg_dir = os.path.join(directory, f"segment_{g:05d}")
        os.makedirs(seg_dir, exist_ok=True)
        digests = {}
        for name in SEGMENT_ARRAYS:
            fpath = os.path.join(seg_dir, f"{name}.npy")
            np.save(fpath, np.asarray(getattr(sc, name)))
            digests[name] = ckpt_io.sha256_file(fpath)
        seg_meta.append({"n_real_tokens": int(sc.n_real_tokens),
                         "sha256": digests})
    meta = {
        "version": 1,
        "n_docs": int(source.n_docs),
        "n_tokens": int(source.n_tokens),
        "vocab_size": int(source.vocab_size),
        "n_topics": int(source.n_topics),
        "n_segments": int(source.n_segments),
        "n_data_shards": int(source.n_data_shards),
        "n_vocab_shards": int(source.n_vocab_shards),
        "rows_per_shard": int(sc0.rows_per_shard),
        "docs_per_shard": int(sc0.docs_per_shard),
        "cap": int(sc0.word_local.shape[-1]),
        "n_model_shards": int(getattr(sc0, "n_model_shards", 1)),
        "rows_coarse": int(getattr(sc0, "rows_coarse", 0)
                           or sc0.rows_per_shard),
        "seed": int(source.seed),
        "segments": seg_meta,
    }
    tmp = os.path.join(directory, META + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(directory, META))
    return directory


class DiskSource(CorpusSource):
    """Out-of-core source over a :func:`save_segments` directory.

    ``segment(g)`` returns memory-mapped stack views: the OS pages in only
    what LoadShard touches, so the resident set is about one segment (plus
    the small placement arrays), whatever the corpus size.

    Robust reads: when ``meta.json`` carries per-file SHA-256 digests, each
    segment's arrays are verified ONCE per process on first access
    (``verify=False`` opts out); a truncated or bit-flipped file raises
    :class:`repro_torch.checkpoint.io.IntegrityError` naming the file.
    Transient read errors (``OSError``, an injected ``disk.segment_read``
    fault among them) are retried ``retries`` times before surfacing;
    corruption is never retried (rot does not heal).

    Directories of the word-sharded layout (``n_model_shards > 1`` in the
    meta) open like any other; their segments carry ``n_model_shards`` and
    ``rows_coarse``. On a ring of several ranks each rank opens the directory
    itself and reads only its block of each stack (:func:`segment_block`),
    but the SHA-256 check reads whole files: on M ranks every segment is read
    M times more in the first epoch (once per rank, then never again).
    """

    corpus = None

    def __init__(self, directory: str, *, verify: bool = True,
                 retries: int = 2):
        meta_path = os.path.join(directory, META)
        if not os.path.isfile(meta_path):
            raise FileNotFoundError(
                f"{directory!r} is not a segment directory (no {META}; "
                f"write one with repro_torch.data.save_segments)")
        with open(meta_path) as f:
            meta = json.load(f)
        self.directory = directory
        self._meta = meta
        for k in ("n_docs", "n_tokens", "vocab_size", "n_topics",
                  "n_segments", "n_data_shards", "n_vocab_shards", "seed"):
            setattr(self, k, int(meta[k]))
        self.rows_per_shard = int(meta["rows_per_shard"])
        self.docs_per_shard = int(meta["docs_per_shard"])
        self.cap = int(meta["cap"])
        # directories without the layout keys hold the replicated layout
        self.n_model_shards = int(meta.get("n_model_shards", 1))
        self.rows_coarse = int(meta.get("rows_coarse", meta["rows_per_shard"]))
        self.verify = bool(verify)
        self.retries = int(retries)
        self._verified: set = set()    # segment ids verified this process
        pl = np.load(os.path.join(directory, PLACEMENT))
        self._shard_of = pl["shard_of_word"]
        self._local_of = pl["local_of_word"]
        self._word_freq = pl["word_freq"]
        self._doc_lengths = pl["doc_lengths"]

    def word_freq(self) -> np.ndarray:
        return self._word_freq

    def doc_lengths(self) -> np.ndarray:
        return self._doc_lengths

    def _verify_segment(self, g: int, seg_dir: str) -> None:
        """First-touch SHA-256 check of segment ``g``'s arrays (memoized by
        the caller). Directories without digests in meta verify nothing."""
        digests = self._meta["segments"][g].get("sha256")
        if not digests:
            return
        for name, want in digests.items():
            fpath = os.path.join(seg_dir, f"{name}.npy")
            got = ckpt_io.sha256_file(fpath)
            if got != want:
                raise ckpt_io.IntegrityError(
                    f"corpus segment file {fpath} is corrupt: sha256 "
                    f"{got[:12]}… != meta {want[:12]}… — re-run "
                    f"save_segments for this directory", path=fpath)

    def segment(self, g: int) -> ShardedCorpus:
        if not (0 <= g < self.n_segments):
            raise IndexError(f"segment {g} out of range [0, {self.n_segments})")
        seg_dir = os.path.join(self.directory, f"segment_{g:05d}")
        last_exc: Optional[OSError] = None
        for _attempt in range(self.retries + 1):
            try:
                if faults._PLANE is not None:
                    faults.hit("disk.segment_read", key=str(g))
                if self.verify and g not in self._verified:
                    self._verify_segment(g, seg_dir)
                    self._verified.add(g)
                arrs = {name: np.load(os.path.join(seg_dir, f"{name}.npy"),
                                      mmap_mode="r")
                        for name in SEGMENT_ARRAYS}
                break
            except ckpt_io.IntegrityError:
                raise          # corruption is permanent; retrying re-reads rot
            except OSError as exc:
                last_exc = exc # transient (NFS hiccup, injected): retry
        else:
            assert last_exc is not None
            raise last_exc
        return ShardedCorpus(
            word_local=arrs["word_local"], doc_local=arrs["doc_local"],
            uid=arrs["uid"], z0=arrs["z0"],
            shard_of_word=self._shard_of, local_of_word=self._local_of,
            rows_per_shard=self.rows_per_shard,
            docs_per_shard=self.docs_per_shard,
            n_data_shards=self.n_data_shards,
            n_vocab_shards=self.n_vocab_shards,
            vocab_size=self.vocab_size,
            n_real_tokens=int(self._meta["segments"][g]["n_real_tokens"]),
            n_model_shards=self.n_model_shards,
            rows_coarse=self.rows_coarse,
        )


def segment_block(sc: ShardedCorpus, layout=None) -> Tuple[np.ndarray, ...]:
    """(word_local, doc_local, uid, z0) of segment ``sc`` as this rank holds
    them: the block of each [S, M, cap] stack that ``layout`` (a single-pod
    :class:`repro_torch.dist.sharding.RankLayout`) hands the rank under
    ``sharding.stack_spec``, or the whole stacks when ``layout`` is ``None``.
    Views: on a :class:`DiskSource` segment only the block is read from the
    memory-mapped files."""
    arrs = tuple(np.asarray(getattr(sc, name)) for name in SEGMENT_ARRAYS)
    if layout is None:
        return arrs
    from repro_torch.dist import sharding as shd

    spec = shd.stack_spec(int(getattr(sc, "n_model_shards", 1)))
    return tuple(shd.local_view(a, spec, layout) for a in arrs)


def open_segments(directory: str) -> DiskSource:
    """Open a :func:`save_segments` directory as a :class:`DiskSource`."""
    return DiskSource(directory)


def initial_z(source: CorpusSource) -> np.ndarray:
    """The global [n_tokens] initial topic assignment, scattered by uid: the
    trainer's z store for streamed training (LoadShard gathers ``z[uid]``,
    SaveShard scatters the sampled z back)."""
    z = np.zeros(source.n_tokens, np.int32)
    for g in range(source.n_segments):
        sc = source.segment(g)
        valid = np.asarray(sc.word_local) >= 0
        z[np.asarray(sc.uid)[valid]] = np.asarray(sc.z0)[valid]
    return z
