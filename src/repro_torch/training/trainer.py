"""``Trainer`` — the typed training driver that owns the train side of the
loop (port of ``repro.training.trainer``).

Corpus sharding, state init on the session's device, the epoch/aggregation
loop, and the event protocol through which checkpointing, α optimization,
liveness, metrics and model publication plug in (``training/callbacks.py``).
The loop itself is ``hierarchy.run_hierarchical``: the Trainer supplies timed
epoch/aggregate fns and adapts the loop's hooks into the callback events.

    cfg = TrainerConfig(n_docs=3000, n_topics=32, ckpt_dir="/tmp/ck", device="cuda")
    tr = Trainer(cfg, callbacks=[Checkpointing(), AlphaOptimizer(),
                                 Metrics(), ModelPublisher("/tmp/snaps")])
    result = tr.fit()
    model, info = tr.export_model()        # dedup + merge → RT-LDA

A session trains a resident corpus or a streamed one: with more than one
segment, or a source with no resident corpus (a ``corpus_dir``), (phi, psi)
stay on the device across segment swaps while the token stacks ride through
a double-buffered ``SegmentStream``.

A session of several ranks (``n_pods × data_shards × model_shards > 1``)
runs one ``Trainer`` per rank, each built with the rank's
:class:`repro_torch.dist.sharding.RankLayout` (``launch.mesh``; ``python -m
repro_torch.launch.train`` starts the ranks itself). Every rank holds its
views of the JAX package's global state and runs the same loop; the rings
rotate within each pod and the pods merge at the aggregation boundaries.
What needs the whole model is a collective that every rank calls: the word
LL (each rank's rows, summed over the pod's ring), the α statistics (pod
0's stacks), ``gather_phi``/``export_model`` and ``checkpoint_tree`` (rank 0
assembles, the others get ``None``). Only rank 0 logs and writes metrics,
checkpoints and snapshots; every rank reads a checkpoint itself and keeps
its views. Checkpoints hold the JAX package's global layout, so they cross
packages both ways.

A streamed session of several ranks (single-pod, P = 1 or word-sharded)
runs one ``SegmentStream`` per rank: every rank visits the segments in the
same order and loads only its block of each; its Φ rows and the full Ψ row
are counted from one pass over the segments (``distributed.rank_counts``),
so no rank ever holds the whole Φ. Each rank's z store is exact only for
the uids it owns; a checkpoint sums the ranks' changes to the store over
the ring. Streaming on several pods raises ``ValueError``, as in the JAX
package; nothing falls back.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.dist.sharding import RankLayout
from repro_torch.training.callbacks import (AlphaOptimizer, ElasticLiveness,
                                            TrainerCallback)
from repro_torch.training.config import TrainerConfig

# the JAX package's refusal of a streaming source on several pods, word for
# word (the config refuses n_segments > 1 or a corpus_dir there already)
_SINGLE_CONFIG = ("segment streaming is single-configuration (got a multi-pod "
                  "session with a streaming source)")


@dataclasses.dataclass
class TrainResult:
    """What ``fit()`` hands back: final device state + session metrics."""

    state: Tuple[Any, ...]       # (phi, psi, wl, dl, uid, z); streamed
                                 # sessions carry only (phi, psi) — the
                                 # stacks live in the SegmentStream/z store
    alpha: Any                   # [K] f32 — final asymmetric prior
    epochs_run: int              # epochs executed by THIS fit (excl. resume)
    start_epoch: int             # where the run began (0 unless resumed)
    metrics: Dict[str, list]


class Trainer:
    """Owns source/state and drives the epoch loop through callbacks.

    Data enters through a :class:`repro_torch.data.sources.CorpusSource`:
    pass one via ``source=``, a resident :class:`Corpus` via ``corpus=``
    (wrapped in an ``InMemorySource``), set ``config.corpus_dir`` (opened as
    a ``DiskSource``), or pass nothing — the synthetic fallback is an
    explicit ``SyntheticSource``, and ``setup()`` logs which source the
    session trains on. A session of several ranks passes this rank's
    ``layout`` (its mesh shape must be the config's (n_pods, data_shards,
    model_shards)).
    """

    def __init__(self, config: TrainerConfig,
                 callbacks: Sequence[TrainerCallback] = (),
                 corpus=None, source=None, layout: Optional[RankLayout] = None):
        self.config = config
        self.layout = layout if layout is not None and layout.world_size > 1 else None
        self.callbacks = list(callbacks)
        self.metrics: Dict[str, list] = collections.defaultdict(list)
        self.epoch = 0               # completed epochs (resume fast-forwards)
        self.segment = 0             # segments completed in the current epoch
        self.corpus = corpus         # resident corpus (None for DiskSource)
        self.source = source         # CorpusSource (built in setup if None)
        self.state: Optional[Tuple[Any, ...]] = None
        self.alpha = None
        self.beta = None
        self.device = None
        self.sc0 = None              # pod-0 / single-pod / segment-0 shards
        self.ring_cfg = None
        self._scs = None             # per-pod shards (multi-pod)
        self._epoch_fn = None
        self._agg_fn = None
        self._refs = None            # (phi_ref, psi_ref) of the last boundary
        self._doc_len_hist = None
        self._z = None               # global [n_tokens] z store (streaming)
        self._z_base = None          # a rank's store where it owns no uid
                                     # (None: zeros; a restored global z)
        self._tables = None          # alias sampler proposal tables (§9)
        self._tables_built_at = -1   # epoch of the last word-table rebuild
        self._tables_alpha = None    # the α the current α table was built from
        self._streaming = False
        self._ep_time = 0.0          # per-epoch accumulator (streaming)
        self._omega_from = None      # first epoch that folds Ω incrementally
        self._omega_parts = {}       # segment id → this epoch's Ω part
        self._built = False

    # ------------------------------------------------------------ build ----

    @property
    def is_writer(self) -> bool:
        """Whether this rank logs and writes (rank 0; the one device)."""
        return self.layout is None or self.layout.is_writer

    @property
    def _pod_axis(self) -> bool:
        return self.config.multi_pod

    def log(self, msg: str) -> None:
        if self.is_writer:
            print(msg, flush=True)

    def barrier(self) -> None:
        """Wait for every rank of the session (nothing on one device)."""
        if self.layout is not None:
            import torch.distributed as dist

            dist.barrier()

    def notify(self, event: str, *args) -> None:
        """Fire one event on every callback, in list order."""
        for cb in self.callbacks:
            getattr(cb, event)(self, *args)

    def _build_source(self):
        """Resolve the session's CorpusSource (explicit > corpus_dir >
        corpus= > synthetic) and validate its geometry against the config."""
        from repro_torch.data import sources as data_sources

        cfg = self.config
        K, M = cfg.n_topics, cfg.ring_size
        if self.source is None:
            if cfg.corpus_dir is not None:
                self.source = data_sources.open_segments(cfg.corpus_dir)
            elif self.corpus is not None:
                self.source = data_sources.InMemorySource(
                    self.corpus, cfg.n_segments, M, M, K, seed=cfg.shard_seed,
                    n_model_shards=cfg.n_model_shards)
            else:
                self.source = data_sources.SyntheticSource(
                    n_docs=cfg.n_docs, vocab_size=cfg.vocab_size,
                    true_topics=cfg.true_topics,
                    doc_len_mean=cfg.doc_len_mean, gen_seed=cfg.seed,
                    n_segments=cfg.n_segments, n_data_shards=M,
                    n_vocab_shards=M, n_topics=K, seed=cfg.shard_seed,
                    n_model_shards=cfg.n_model_shards)
        src = self.source
        self.corpus = src.corpus
        if src.n_data_shards != M or src.n_vocab_shards != M:
            raise ValueError(
                f"source ring geometry {src.n_data_shards}x"
                f"{src.n_vocab_shards} does not match the session's "
                f"{M}x{M} (data_shards*model_shards)")
        if src.n_topics != K:
            raise ValueError(f"source was sharded for K={src.n_topics}, "
                             f"session has n_topics={K}")
        if getattr(src, "n_model_shards", 1) != cfg.n_model_shards:
            raise ValueError(
                f"source was bucketed for n_model_shards="
                f"{getattr(src, 'n_model_shards', 1)} but the session has "
                f"n_model_shards={cfg.n_model_shards} (re-save the segments "
                f"or match the config)")
        if cfg.corpus_dir and cfg.n_segments not in (1, src.n_segments):
            raise ValueError(
                f"config n_segments={cfg.n_segments} but {cfg.corpus_dir!r} "
                f"holds {src.n_segments} segments")
        self.log(f"[data] {src.describe()}")
        return src

    @property
    def n_segments(self) -> int:
        """Segments per epoch (1 on the resident and multi-pod paths)."""
        return self.source.n_segments if self._streaming else 1

    def setup(self) -> "Trainer":
        """Build source and device state and the epoch (and aggregate) fns.
        Idempotent; ``fit()`` calls it automatically."""
        if self._built:
            return self
        from repro_torch.core import distributed as dist, hierarchy

        cfg = self.config
        lay = self.layout
        src = self.source
        if cfg.multi_pod and src is not None and (src.n_segments > 1 or src.corpus is None):
            raise ValueError(_SINGLE_CONFIG)
        if cfg.n_devices > 1 and lay is None:
            raise ValueError(
                f"n_pods*data_shards*model_shards={cfg.n_devices}: a session of several "
                "ranks needs each rank's RankLayout (repro_torch.launch.mesh; python -m "
                "repro_torch.launch.train starts the ranks itself)")
        if lay is not None and lay.shape != (cfg.n_pods, cfg.data_shards, cfg.model_shards):
            raise ValueError(f"the layout's mesh {lay.shape} is not the config's "
                             f"{(cfg.n_pods, cfg.data_shards, cfg.model_shards)}")
        elastic = any(isinstance(cb, ElasticLiveness) for cb in self.callbacks)
        if elastic and not cfg.multi_pod:
            raise ValueError(
                "ElasticLiveness requires aggregation boundaries "
                "(n_pods > 1); a single-pod session would silently "
                "never consult the probe")
        self.device = resolve_device(cfg.device if lay is None else lay.device)
        if lay is not None and torch.device(cfg.device).type != self.device.type:
            raise ValueError(f"the layout's device {lay.device} is not the config's "
                             f"{cfg.device}")
        K = cfg.n_topics
        src = self._build_source()
        # streaming = any session whose stacks are not resident device state:
        # more than one segment, or an out-of-core (corpus-less) source
        self._streaming = src.n_segments > 1 or src.corpus is None
        if cfg.multi_pod:
            from repro_torch.data import corpus as corpus_mod

            M = cfg.ring_size
            self._scs = corpus_mod.shard_corpus_pods(
                self.corpus, cfg.n_pods, M, M, K, seed=cfg.shard_seed,
                n_model_shards=cfg.n_model_shards)
            self.sc0 = self._scs[0]
            self.state = hierarchy.init_pod_state(self._scs, K, lay, device=self.device)
        else:
            self.sc0 = src.segment(0)
            if self._streaming:
                # (phi, psi) + the global z store materialize lazily in fit():
                # a resume restores all three from the checkpoint, and the
                # init pass over every segment would be thrown away
                self.state = None
                self._z = None
            elif lay is not None:
                self.state = dist.rank_arrays([self.sc0], K, lay, device=self.device)
            else:
                self.state = dist.device_arrays(self.sc0, K, device=self.device)
        doc_cap = 0
        if cfg.sampler == "alias":
            from repro_torch.core import sparse

            doc_cap = sparse.suggest_cap(src.doc_lengths(), K)
        cap = self.sc0.word_local.shape[-1]
        self.ring_cfg = dist.RingConfig(
            n_topics=K, vocab_size=src.vocab_size,
            rows_per_shard=self.sc0.rows_per_shard,
            docs_per_shard=self.sc0.docs_per_shard,
            cap=cap, package_len=cfg.package_len or cap, n_rounds=cfg.ring_size,
            sampler=cfg.sampler, n_mh=cfg.n_mh, doc_topic_cap=doc_cap,
            model_shards=cfg.n_model_shards)
        if cfg.multi_pod:
            self._epoch_fn = hierarchy.make_pod_ring_epoch(self.ring_cfg, lay)
            self._agg_fn = (hierarchy.make_elastic_aggregate(lay) if elastic
                            else hierarchy.make_aggregate(lay))
            # every pod starts from the same global replica: the initial
            # state is its own aggregation ref (cloned: epochs run in place)
            self._refs = (torch.clone(self.state[0]), torch.clone(self.state[1]))
        else:
            self._epoch_fn = dist.build_epoch_body(self.ring_cfg, lay)
            self._agg_fn = None
        self.alpha = torch.full((K,), cfg.alpha0 / K, dtype=torch.float32,
                                device=self.device)
        self.beta = torch.tensor(cfg.beta, dtype=torch.float32, device=self.device)
        if self._streaming:
            # fold the α-optimizer's Ω histogram during the epoch (at each
            # segment's SaveShard) instead of re-reading every segment at
            # epoch end — only when an AlphaOptimizer will consume it
            starts = [cfg.alpha_opt_from if cb.from_epoch is None
                      else cb.from_epoch
                      for cb in self.callbacks
                      if isinstance(cb, AlphaOptimizer)]
            self._omega_from = min(starts) if starts else None
        self._built = True
        return self

    def _materialize_stream_state(self) -> None:
        """ONE pass over the segments building the initial (phi, psi) on the
        session's device and the global z store (z0 scattered by uid).
        Skipped when a checkpoint restore already supplied both.

        On a ring of several ranks the pass counts only this rank's Φ rows
        [1, rows/P, K] (and the full Ψ row), and the store gets the z0 of the
        uids the rank owns (its blocks); the rest stay 0."""
        from repro_torch.core import distributed as dist
        from repro_torch.data.sources import segment_block

        src, lay = self.source, self.layout
        K = self.config.n_topics
        z = np.zeros(src.n_tokens, np.int32)
        if lay is not None:
            scs = [src.segment(g) for g in range(src.n_segments)]
            phi, psi = dist.rank_counts([(sc.word_local, sc.z0) for sc in scs], K,
                                        self.sc0.rows_per_shard, self.config.n_model_shards,
                                        lay, self.device)
            for sc in scs:
                wl, _, uid, z0 = segment_block(sc, lay)
                valid = wl >= 0
                z[uid[valid]] = z0[valid]
            self.state, self._z, self._z_base = (phi[None], psi), z, None
            return
        phi = psi = None
        for g in range(src.n_segments):
            sc = src.segment(g)
            phi, psi = dist.device_counts(sc, K, self.device, phi, psi)
            valid = np.asarray(sc.word_local) >= 0
            z[np.asarray(sc.uid)[valid]] = np.asarray(sc.z0)[valid]
        self.state = (phi, psi)
        self._z = z

    # -------------------------------------------------------------- fit ----

    def fit(self) -> TrainResult:
        """Run the session: ``on_train_start`` (restore happens here), the
        epoch loop with events, then ``on_train_end``. A ``KillSwitch`` (or
        any callback) aborting with an exception skips ``on_train_end`` —
        exactly the crash the resume path recovers from."""
        from repro_torch.core import hierarchy

        self.setup()
        cfg = self.config
        self.notify("on_train_start")
        start_epoch = self.epoch
        if start_epoch >= cfg.n_epochs:
            self.log(f"[train] nothing to do: resumed at epoch {start_epoch} "
                     f"of {cfg.n_epochs}")
        liveness = None
        for cb in self.callbacks:
            if isinstance(cb, ElasticLiveness):
                liveness = cb.probe
        stream = None
        if self._streaming:
            from repro_torch.data.stream import SegmentStream

            if self.state is None:      # fresh run (no checkpoint restored)
                self._materialize_stream_state()
            self._omega_parts.clear()
            stream = SegmentStream(self.source, self._z, prefetch=cfg.prefetch,
                                   device=self.device, layout=self.layout)
        if self._alias and self._tables is None:
            # fresh run: build from the (phi, psi, α) the session starts from
            self._rebuild_tables()
            self._tables_built_at = self.epoch
        state = hierarchy.run_hierarchical(
            self._timed_epoch, self._timed_agg if self._agg_fn else None,
            self.state, self.alpha, self.beta, cfg.n_epochs, cfg.agg_every,
            seed0=cfg.seed * 131 + 7, liveness=liveness,
            start_epoch=start_epoch, on_epoch_end=self._hook_epoch_end,
            on_aggregate=self._hook_aggregate, refs=self._refs,
            segments=stream, start_segment=self.segment,
            on_segment_end=self._hook_segment_end if stream else None,
            epoch_aux=self._epoch_tables if self._alias else None,
        )
        self.state = tuple(state)
        if stream is not None and self.layout is not None:
            self._gather_stream_stats()
        self.notify("on_train_end")
        return TrainResult(state=self.state, alpha=self.alpha,
                           epochs_run=max(0, cfg.n_epochs - start_epoch),
                           start_epoch=start_epoch,
                           metrics={k: list(v) for k, v in self.metrics.items()})

    # loop plumbing: the timed epoch fn + hook→event adaptation --------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed_epoch(self, *args):
        t0 = time.perf_counter()
        out = self._epoch_fn(*args)
        self._sync()
        dt = time.perf_counter() - t0
        if self._streaming:
            # per-segment sampler time; _hook_epoch_end folds the epoch total
            self.metrics["segment_s"].append(dt)
            self._ep_time += dt
        else:
            self.metrics["epoch_s"].append(dt)
        return out

    def _timed_agg(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self._agg_fn(*args, **kwargs)
        self._sync()
        self.metrics["agg_s"].append(time.perf_counter() - t0)
        return out

    def _hook_aggregate(self, ep: int, state) -> None:
        self.state = tuple(state)
        # the merged state is the new ref; a clone survives the next epochs'
        # in-place updates, so mid-window checkpoints carry the exact refs a
        # resume must replay against
        self._refs = (torch.clone(state[0]), torch.clone(state[1]))
        if self._alias:
            # word tables refresh from the just-merged Φ, before notify, so
            # boundary checkpoints capture the tables the next epoch uses
            self._rebuild_tables()
            self._tables_built_at = ep + 1
        self.notify("on_aggregate", ep)

    def _hook_segment_end(self, ep: int, seg, state) -> None:
        self.state = tuple(state)
        self.epoch = ep
        self.segment = seg.pos + 1
        # the stream's host times of this segment: LoadShard, the consumer's
        # wait for it (≈ 0 when prefetch hides the load), SaveShard
        self.metrics["load_shard_s"].append(seg.load_s)
        self.metrics["load_wait_s"].append(seg.wait_s)
        self.metrics["save_shard_s"].append(seg.commit_s)
        if self._omega_from is not None and ep >= self._omega_from:
            self._fold_segment_omega(seg)
        self.notify("on_segment_end", ep, seg.pos + 1)

    def _segment_omega(self, dl, z, valid):
        """Ω_kn histogram of one segment's (doc_local, z, valid) stacks —
        the ONE histogram call shared by the incremental fold and the
        full-scan fallback."""
        from repro_torch.core import dedup

        return dedup.topic_count_histogram(
            dl.reshape(-1), z.reshape(-1), valid.reshape(-1),
            self.ring_cfg.docs_per_shard * self.config.ring_size,
            self.config.n_topics)

    def _stream_omega(self, dl, z, valid):
        """Ω_kn part of one streamed segment from its (doc_local, z, valid)
        device stacks (on a rank, its block).

        doc_local counts within a data shard, so the JAX package's histogram
        over the whole segment lumps together the docs of one local index
        across the data shards: a doc row's counts need every rank's tokens.
        On a ring of several ranks each rank all-gathers the segment's (doc,
        z) over the ring and histograms only its share of the doc rows; the
        shares' sum over the ring (``alpha_statistics``) is the JAX
        package's Ω exactly."""
        if self.layout is None:
            return self._segment_omega(dl, z, valid)
        from repro_torch.core import dedup
        from repro_torch.dist import collectives as coll, sharding as shd

        lay = self.layout
        dz = torch.stack([torch.where(valid, dl, -1).reshape(-1), z.reshape(-1)])
        dz = coll.all_gather(dz, lay, "ring")                      # [R, 2, n]
        d, zz = dz[:, 0].reshape(-1), dz[:, 1].reshape(-1)
        n, R, i = self.ring_cfg.docs_per_shard, shd.ring_size(lay), shd.flat_ring_index(lay)
        lo, hi = n * i // R, n * (i + 1) // R
        mine = (d >= lo) & (d < hi)
        return dedup.topic_count_histogram(torch.where(mine, d - lo, 0), zz, mine, hi - lo,
                                           self.config.n_topics)

    def _fold_segment_omega(self, seg) -> None:
        """Ω_kn part for one just-committed segment (its z is final for this
        epoch), from the segment's device stacks — no re-read. Pad slots add
        nothing (their valid flag is 0), so this equals the JAX package's
        fold over the host views."""
        self._omega_parts[seg.gid] = self._stream_omega(seg.dl, seg.z, seg.wl >= 0)

    def _hook_epoch_end(self, ep: int, state, alpha):
        self.state = tuple(state)
        self.alpha = alpha
        self.epoch = ep + 1
        self.segment = 0
        if self._streaming:
            self.metrics["epoch_s"].append(self._ep_time)
            self._ep_time = 0.0
        self.notify("on_epoch_end", ep)
        self._omega_parts.clear()     # next epoch folds fresh parts
        return self.alpha       # callbacks may have replaced it

    # --------------------------------------------- state views / helpers ---

    @property
    def _alias(self) -> bool:
        return self.config.sampler == "alias"

    def _rebuild_tables(self, word: bool = True) -> None:
        """Refresh the alias sampler's stale proposal state from the current
        (phi, psi, α). ``word=False`` refreshes only the (cheap) α table."""
        from repro_torch.core import sparse

        phi, psi = self.state[0], self.state[1]
        if word or self._tables is None:
            self._tables = None                 # the old tables go first
            wq, wp, wa = sparse.make_word_tables(
                phi, psi, self.beta, self.ring_cfg.vocab_size)
        else:
            wq, wp, wa = self._tables.wq, self._tables.wp, self._tables.wa
        ap, aa = sparse.make_alpha_table(self.alpha)
        self._tables = sparse.AliasTables(wq, wp, wa, ap, aa)
        self._tables_alpha = self.alpha

    def _epoch_tables(self) -> tuple:
        """``run_hierarchical``'s ``epoch_aux``: hand the loop the proposal
        tables, refreshing them lazily at epoch start, so a checkpoint always
        holds the tables its epoch sampled with and a resumed run re-derives
        any due rebuild from the restored state. Word tables rebuild on the
        ``agg_every`` cadence; the α table whenever α moved (the MH
        correction assumes the drawn proposal and the q ratio share one α).
        """
        ep = self.epoch
        if (not self.has_aggregation and ep > 0 and ep % self.config.agg_every == 0
                and self._tables_built_at != ep):
            self._rebuild_tables()
            self._tables_built_at = ep
        elif self._tables_alpha is not self.alpha:
            self._rebuild_tables(word=False)
        return tuple(self._tables)

    @property
    def has_aggregation(self) -> bool:
        """Whether this session has aggregation boundaries (multi-pod)."""
        return self._agg_fn is not None

    @property
    def agg_fn(self):
        """The boundary-merge callable (None in single-pod sessions)."""
        return self._agg_fn

    def local_model(self):
        """(phi, psi) of this rank's pod, without the pod dim: the shards
        [M, rows, K] on one device, this rank's view [1, rows/P, K] on a
        rank."""
        phi, psi = self.state[0], self.state[1]
        if self.config.multi_pod:
            return phi[0], psi[0]
        return phi, psi

    def gather_phi(self) -> Optional[torch.Tensor]:
        """Reassembled global [V, K] topic-count matrix (pod 0's), on the
        session's device. On several ranks a collective: rank 0 gets it, the
        others ``None``."""
        from repro_torch.core import distributed as dist

        if self.layout is not None:
            return dist.gather_phi_ranks(self.state[0], self.sc0, self.layout,
                                         pod_axis=self._pod_axis)
        phi0, _ = self.local_model()
        return dist.gather_phi(phi0, self.sc0)

    def log_likelihood(self) -> float:
        """The word LL of this rank's pod (a collective over the pod's ring
        on several ranks)."""
        from repro_torch.core import distributed as dist, lda

        phi0, psi0 = self.local_model()
        if self.layout is not None:
            return dist.ring_word_log_likelihood(phi0, psi0, self.beta, self.sc0,
                                                 self.layout)
        return float(lda.word_log_likelihood(self.gather_phi(), psi0, self.beta))

    def alpha_statistics(self):
        """Coordinator stats for the Minka fixed point: (Ω_kn histogram,
        doc-length histogram) — two small arrays, never per-document state.
        Streamed sessions sum the parts folded at each segment's SaveShard;
        outside that window (or in a partially replayed resume epoch) they
        fold the histogram over every segment (z gathered from the global
        store, stacks re-read from the source — mmap'd, so this stays
        out-of-core too; a rank re-reads only its blocks). On a ring of
        several ranks the ranks' parts are summed with one integer
        ``all_reduce`` over the ring (exact)."""
        from repro_torch.core import dedup
        from repro_torch.data.sources import segment_block

        if self._streaming:
            n = self.source.n_segments
            if len(self._omega_parts) == n:
                omega = sum(self._omega_parts[g] for g in range(n))
            else:
                omega = None
                dev = self.device
                for g in range(n):
                    wl, dl, uid, _ = segment_block(self.source.segment(g), self.layout)
                    o = self._stream_omega(torch.from_numpy(np.array(dl, np.int32)).to(dev),
                                           torch.from_numpy(self._z[uid]).to(dev),
                                           torch.from_numpy(wl >= 0).to(dev))
                    omega = o if omega is None else omega + o
            if self.layout is not None:
                from repro_torch.dist import collectives as coll

                coll.all_reduce_(omega, self.layout, "ring")
        elif self.layout is not None:
            wl, dl, z = self._pod0_stacks()
            omega = self._segment_omega(dl, z, wl >= 0)
        else:
            wl, dl, z = self.state[2], self.state[3], self.state[5]
            omega = self._segment_omega(dl, z, wl >= 0)
        if self._doc_len_hist is None:
            self._doc_len_hist = dedup.doc_length_histogram(
                torch.from_numpy(self.source.doc_lengths()).to(self.device))
        return omega, self._doc_len_hist

    def _pod0_stacks(self):
        """Pod 0's global (wl, dl, z) stacks on every rank (the JAX package's
        Ω reads pod 0's), all-gathered from the ranks' views."""
        from repro_torch.core import distributed as dist
        from repro_torch.dist import collectives as coll, sharding as shd

        lay = self.layout
        spec = dist.specs(self.ring_cfg.model_shards)["stack"]
        lead = 2 if self._pod_axis else 1
        ring = lay.data * lay.model
        out = []
        for i in (2, 3, 5):
            views = coll.all_gather(self.state[i], lay, "world")[:ring].cpu().numpy()
            views = [v.reshape(v.shape[lead - 1:]) for v in views]
            out.append(torch.from_numpy(shd.assemble(views, spec, dist.pod_layout(lay)))
                       .to(self.device))
        return out

    # ------------------------------------------------- checkpoint plumbing -

    def _leaf_specs(self) -> dict:
        """The JAX package's layout of each checkpoint leaf, by key."""
        from repro_torch.core import distributed as dist

        sp = dist.specs(self.ring_cfg.model_shards, self._pod_axis)
        return {"state": (sp["phi"], sp["psi"]) + (sp["stack"],) * 4,
                "tables": (sp["tables"],) * 3 + ((), ()),
                "refs": (sp["phi"], sp["psi"])}

    def checkpoint_tree(self) -> Optional[dict]:
        """The session's state in the JAX package's global layout: uid as
        uint32; leaves numbered in sorted-key order (alpha, refs, state,
        tables, z). On several ranks a collective that assembles the tree on
        rank 0 (the other ranks get ``None``)."""
        state = list(self.state)
        tree = {"state": tuple(state), "alpha": self.alpha}
        if self._alias and self._tables is not None:
            # the stale proposal tables are part of the sampler's state: a
            # resume must replay against the same staleness
            tree["tables"] = tuple(self._tables)
        if self._streaming:
            # streamed sessions checkpoint (phi, psi) + the GLOBAL z store:
            # the stacks are reproducible from the source, z is not — and a
            # resume must land bit for bit on the recorded (epoch, segment)
            tree["z"] = np.array(self.global_z())
        if self.config.multi_pod:
            # the refs of the last boundary: a resume from a mid-window
            # checkpoint must replay against them (re-deriving them from the
            # per-pod states would break the pods-agree invariant)
            tree["refs"] = tuple(self._refs)
        if self.layout is not None:
            tree = self._assemble_tree(tree)
        if tree is not None and len(tree["state"]) == 6:
            st = list(tree["state"])
            st[4] = np.asarray(st[4].cpu().numpy() if isinstance(st[4], torch.Tensor)
                               else st[4]).astype(np.uint32)
            tree["state"] = tuple(st)
        return tree

    def global_z(self) -> Optional[np.ndarray]:
        """The streamed session's global [n_tokens] z store (``None`` for a
        resident session). On a ring of several ranks a collective over the
        ring that gives it to every rank: a rank's store differs from the
        common base (zeros, or the z a checkpoint restored) only at the uids
        it owns, so the base plus the ranks' changes summed over the ring
        takes each uid's z from its owner (an elementwise sum or max of the
        stores would not)."""
        from repro_torch.dist import collectives as coll

        if not self._streaming or self._z is None:
            return None
        if self.layout is None:
            return self._z
        base = self._z_base
        part = self._z if base is None else self._z - base
        t = torch.from_numpy(np.array(part, np.int32))
        if self.layout.backend == "nccl":
            t = t.to(self.device)
        coll.all_reduce_(t, self.layout, "ring")
        out = t.cpu().numpy()
        return out if base is None else out + base

    def _gather_stream_stats(self) -> None:
        """Each rank's mean stream host times (ms a segment) into every
        rank's ``metrics["stream_by_rank"]``, in rank order (a collective;
        ``fit`` calls it on a streamed ring of several ranks)."""
        import torch.distributed as tdist

        m = self.metrics
        mine = {f"{k[:-2]}_ms": 1e3 * float(np.mean(m[k])) if m.get(k) else None
                for k in ("load_shard_s", "load_wait_s", "save_shard_s")}
        group, ranks = self.layout.group("world")
        got = [None] * len(ranks)
        tdist.all_gather_object(got, mine, group=group)
        m["stream_by_rank"] = got

    def _assemble_tree(self, tree: dict) -> Optional[dict]:
        """Every rank's views → the global tree on rank 0 (a collective)."""
        from repro_torch.core import distributed as dist
        from repro_torch.dist import sharding as shd

        out = {}
        for key, leaves in tree.items():
            if key not in ("state", "tables", "refs"):
                out[key] = leaves.cpu().numpy() if isinstance(leaves, torch.Tensor) else leaves
                continue
            parts = []
            for x, spec in zip(leaves, self._leaf_specs()[key]):
                if spec == ():
                    parts.append(x.cpu().numpy())
                    continue
                views = dist.gather_views(x, self.layout)
                parts.append(None if views is None else shd.assemble(views, spec, self.layout))
            out[key] = tuple(parts)
        return out if self.is_writer else None

    def _tables_like(self, phi_shape) -> tuple:
        """Structure-only stand-in for the alias tables (wq, wp, wa, ap, aa)."""
        K = self.config.n_topics
        return (np.zeros(phi_shape, np.float32),
                np.zeros(phi_shape, np.float32),
                np.zeros(phi_shape, np.int32),
                np.zeros((K,), np.float32),
                np.zeros((K,), np.int32))

    def checkpoint_like(self) -> dict:
        """The structure of ``checkpoint_tree()`` (leaf count and order) for
        a restore; no collective."""
        self.setup()
        cfg = self.config
        K = cfg.n_topics
        if self._streaming and self.state is None:
            # restore template before the lazy init pass: the loader only
            # needs the tree STRUCTURE (leaf count + order), not values
            phi_shape = (cfg.ring_size, self.sc0.rows_per_shard, K)
            like = {"state": (np.zeros(phi_shape, np.int32),
                              np.zeros((K,), np.int32)),
                    "alpha": np.zeros((K,), np.float32),
                    "z": np.zeros(self.source.n_tokens, np.int32)}
            if self._alias:
                like["tables"] = self._tables_like(phi_shape)
            return like
        phi_shape = tuple(self.state[0].shape)
        like = {"state": tuple(np.zeros((0,)) for _ in self.state),
                "alpha": np.zeros((K,), np.float32)}
        if self._alias:
            like["tables"] = self._tables_like(phi_shape)
        if self._streaming:
            like["z"] = np.zeros(self.source.n_tokens, np.int32)
        if cfg.multi_pod:
            like["refs"] = (np.zeros((0,)), np.zeros((0,)))
        return like

    def load_checkpoint(self, tree: dict, meta: dict) -> None:
        """Restore from a checkpoint tree in the JAX package's global layout
        (numpy leaves), resharded first when it was written under another
        ``n_model_shards``; each rank keeps its views."""
        from repro_torch.dist import sharding as shd

        ck_p = int(meta.get("n_model_shards", 1))
        if ck_p != self.config.n_model_shards:
            # another word-shard layout: permute Φ/tables/refs rows through
            # the coarse vocabulary ids and rebuild the stacks from this
            # session's sharding
            from repro_torch.training import reshard

            scs = self._scs if self.config.multi_pod else [self.sc0]
            tree = reshard.reshard_checkpoint(tree, ck_p, self.config.n_model_shards, scs)
            self.log(f"[ckpt] resharded checkpoint n_model_shards={ck_p} -> "
                     f"{self.config.n_model_shards}")
        dev = self.device
        specs = self._leaf_specs() if self.layout is not None else {}

        def leaves(key):
            out = []
            for i, x in enumerate(tree[key]):
                x = np.asarray(x)
                if key in specs and specs[key][i] != ():
                    x = shd.local_view(x, specs[key][i], self.layout)
                if key == "state" and i == 4:
                    x = x.astype(np.int64)
                out.append(torch.from_numpy(np.array(x)).to(dev))
            return tuple(out)

        self.state = leaves("state")
        self.alpha = torch.from_numpy(np.array(tree["alpha"])).to(dev)
        if "z" in tree:
            self._z = np.array(tree["z"], np.int32)
            # every rank holds the whole restored store: the base its
            # changes are taken against
            self._z_base = self._z.copy() if self.layout is not None else None
        if "refs" in tree:
            self._refs = leaves("refs")
        self.epoch = int(meta.get("epoch", meta["step"]))
        self.segment = int(meta.get("segment", 0))
        if "tables" in tree:
            from repro_torch.core import sparse

            self._tables = sparse.AliasTables(*leaves("tables"))
            # mid-epoch (segment) checkpoints already carry this epoch's
            # tables; an epoch-boundary one lets _epoch_tables re-derive a due
            # rebuild from the restored state; the α table is rebuilt at the
            # next epoch start from the restored α
            self._tables_built_at = self.epoch if self.segment > 0 else -1
            self._tables_alpha = None
        else:
            self._tables = None

    # --------------------------------------------------- train→serve export

    def export_model(self, merge_l1: Optional[float] = None,
                     dup_l1: Optional[float] = None):
        """Dedup + merge + RT-LDA build (paper §3.3 → §3.2 handoff).

        One shared ``pairwise_l1`` distance pass (host numpy, O(K²V)) feeds
        the duplicate-fraction diagnostic and the cluster merge; merged
        counts + merged α become the serving model on the session's device.
        Returns ``(RTLDAModel, info)`` with ``info = {duplicate_fraction,
        n_topics, n_topics_raw}``; on several ranks a collective (pod 0's
        model, on rank 0; the other ranks get ``(None, None)``).
        """
        from repro_torch.core import dedup, rtlda

        cfg = self.config
        merge_l1 = cfg.dedup_merge_l1 if merge_l1 is None else merge_l1
        dup_l1 = cfg.dedup_dup_l1 if dup_l1 is None else dup_l1
        _, psi0 = self.local_model()
        phi_full = self.gather_phi()
        if phi_full is None:
            return None, None
        psi0 = psi0.reshape(-1)
        d_l1 = dedup.pairwise_l1(phi_full, self.beta)
        frac = dedup.duplicate_fraction(phi_full, self.beta, dup_l1, dist=d_l1)
        cl, ncl = dedup.cluster_topics(phi_full, self.beta,
                                       l1_threshold=merge_l1, dist=d_l1)
        phi_m, psi_m, alpha_m = dedup.merge_topics(phi_full, psi0, self.alpha,
                                                   cl, ncl)
        model = rtlda.build_model(phi_m, self.beta, alpha_m, device=self.device)
        info = {"duplicate_fraction": float(frac), "n_topics": int(ncl),
                "n_topics_raw": int(cfg.n_topics)}
        return model, info

    # ------------------------------------------------------------- bench ---

    def bench_record(self) -> dict:
        """Machine-readable training bench record (BENCH_train.json)."""
        cfg = self.config
        ep_s = self.metrics.get("epoch_s", [])
        seg_s = self.metrics.get("segment_s", [])
        agg_s = self.metrics.get("agg_s", [])
        pub_s = self.metrics.get("publish_s", [])
        ll = self.metrics.get("ll", [])
        src = self.source
        tokens = int(src.n_tokens) if src is not None else (
            int(self.corpus.n_tokens) if self.corpus is not None else 0)
        mean = lambda xs: float(np.mean(xs)) if xs else None
        dev = self.device
        # a streamed session of several ranks adds each rank's stream times
        per_rank = ({"stream_by_rank": self.metrics.get("stream_by_rank")}
                    if self.layout is not None and self._streaming else {})
        return {
            "bench": "train",
            "device": (torch.cuda.get_device_name(dev) if dev is not None
                       and dev.type == "cuda" else "cpu"),
            "n_docs": int(src.n_docs) if src else cfg.n_docs,
            "n_tokens": tokens,
            "n_topics": cfg.n_topics,
            "mesh": {"pods": cfg.n_pods, "data": cfg.data_shards,
                     "model": cfg.model_shards},
            "sampler": cfg.sampler,
            "n_mh": cfg.n_mh if cfg.sampler == "alias" else None,
            "source": type(src).__name__ if src else None,
            "n_segments": src.n_segments if src else 1,
            "prefetch": bool(cfg.prefetch) if self._streaming else None,
            "n_epochs": cfg.n_epochs,
            "epochs_timed": len(ep_s),
            "epoch_s_mean": mean(ep_s),
            "epoch_s_last": ep_s[-1] if ep_s else None,
            "tokens_per_s": (tokens / mean(ep_s)) if ep_s else None,
            "segment_s_mean": mean(seg_s),
            "agg_s_mean": mean(agg_s),
            "n_aggregates": len(agg_s),
            "publish_s_mean": mean(pub_s),
            "n_publishes": len(pub_s),
            "ll_final": ll[-1] if ll else None,
            **per_rank,
        }
