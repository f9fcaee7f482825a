"""``Trainer`` — the typed training driver that owns the train side of the
loop (port of ``repro.training.trainer`` for a ring of one device).

Corpus sharding, state init on the session's device, the epoch loop, and the
event protocol through which checkpointing, α optimization, metrics and model
publication plug in (``training/callbacks.py``). The loop itself is
``hierarchy.run_hierarchical``: the Trainer supplies a timed epoch fn and
adapts the loop's epoch hook into the callback events.

    cfg = TrainerConfig(n_docs=3000, n_topics=32, ckpt_dir="/tmp/ck", device="cuda")
    tr = Trainer(cfg, callbacks=[Checkpointing(), AlphaOptimizer(),
                                 Metrics(), ModelPublisher("/tmp/snaps")])
    result = tr.fit()
    model, info = tr.export_model()        # dedup + merge → RT-LDA

What one device serves: one pod, a ring of one device
(``data_shards = model_shards = 1``), a resident corpus or a streamed one.
With more than one segment, or a source with no resident corpus (a
``corpus_dir``), the epoch loop streams: (phi, psi) stay on the device across
segment swaps while the token stacks ride through a double-buffered
``SegmentStream`` (pinned host memory, a side CUDA stream) and the global z
store lives on the host. Pods, a ring of several devices, word-sharded model
slices and resharded checkpoints (ROADMAP queue 1, item 11) raise
``NotImplementedError`` naming what is missing; nothing falls back.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.training.callbacks import (AlphaOptimizer, ElasticLiveness,
                                            TrainerCallback)
from repro_torch.training.config import TrainerConfig

_MULTI_GPU = "ROADMAP queue 1, item 11 (multi-GPU)"


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


def refuse_unported(cfg: TrainerConfig) -> None:
    """Raise ``NotImplementedError`` for a session one device cannot serve yet."""
    if cfg.n_pods > 1:
        raise NotImplementedError(f"n_pods={cfg.n_pods}: pods are not ported ({_MULTI_GPU})")
    if cfg.data_shards * cfg.model_shards > 1:
        raise NotImplementedError(
            f"data_shards*model_shards={cfg.data_shards * cfg.model_shards}: only a ring "
            f"of one device is ported ({_MULTI_GPU})")
    if cfg.n_model_shards > 1:
        raise NotImplementedError(
            f"n_model_shards={cfg.n_model_shards}: word-sharded model slices are not "
            f"ported ({_MULTI_GPU})")


class Trainer:
    """Owns source/state and drives the epoch loop through callbacks.

    Data enters through a :class:`repro_torch.data.sources.CorpusSource`:
    pass one via ``source=``, a resident :class:`Corpus` via ``corpus=``
    (wrapped in an ``InMemorySource``), set ``config.corpus_dir`` (opened as
    a ``DiskSource``), or pass nothing — the synthetic fallback is an
    explicit ``SyntheticSource``, and ``setup()`` logs which source the
    session trains on.
    """

    def __init__(self, config: TrainerConfig,
                 callbacks: Sequence[TrainerCallback] = (),
                 corpus=None, source=None):
        self.config = config
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
        self.sc0 = None              # segment 0's shards (the placement)
        self.ring_cfg = None
        self._epoch_fn = None
        self._doc_len_hist = None
        self._z = None               # global [n_tokens] z store (streaming)
        self._tables = None          # alias sampler proposal tables (§9)
        self._tables_built_at = -1   # epoch of the last word-table rebuild
        self._tables_alpha = None    # the α the current α table was built from
        self._streaming = False
        self._ep_time = 0.0          # per-epoch accumulator (streaming)
        self._omega_from = None      # first epoch that folds Ω incrementally
        self._omega_parts = {}       # segment id → this epoch's Ω part
        self._built = False

    # ------------------------------------------------------------ build ----

    def log(self, msg: str) -> None:
        print(msg, flush=True)

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
                    self.corpus, cfg.n_segments, M, M, K, seed=cfg.shard_seed)
            else:
                self.source = data_sources.SyntheticSource(
                    n_docs=cfg.n_docs, vocab_size=cfg.vocab_size,
                    true_topics=cfg.true_topics,
                    doc_len_mean=cfg.doc_len_mean, gen_seed=cfg.seed,
                    n_segments=cfg.n_segments, n_data_shards=M,
                    n_vocab_shards=M, n_topics=K, seed=cfg.shard_seed)
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
        if cfg.corpus_dir and cfg.n_segments not in (1, src.n_segments):
            raise ValueError(
                f"config n_segments={cfg.n_segments} but {cfg.corpus_dir!r} "
                f"holds {src.n_segments} segments")
        self.log(f"[data] {src.describe()}")
        return src

    @property
    def n_segments(self) -> int:
        """Segments per epoch (1 on the resident path)."""
        return self.source.n_segments if self._streaming else 1

    def setup(self) -> "Trainer":
        """Build source and device state and the epoch fn. Idempotent;
        ``fit()`` calls it automatically."""
        if self._built:
            return self
        from repro_torch.core import distributed as dist

        cfg = self.config
        refuse_unported(cfg)
        if any(isinstance(cb, ElasticLiveness) for cb in self.callbacks):
            raise ValueError(
                "ElasticLiveness requires aggregation boundaries "
                "(n_pods > 1); a single-pod session would silently "
                "never consult the probe")
        self.device = resolve_device(cfg.device)
        K = cfg.n_topics
        src = self._build_source()
        # streaming = any session whose stacks are not resident device state:
        # more than one segment, or an out-of-core (corpus-less) source
        self._streaming = src.n_segments > 1 or src.corpus is None
        self.sc0 = src.segment(0)
        if self._streaming:
            # (phi, psi) + the global z store materialize lazily in fit(): a
            # resume restores all three from the checkpoint, and the init
            # pass over every segment would be thrown away
            self.state = None
            self._z = None
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
        self._epoch_fn = dist.build_epoch_body(self.ring_cfg)
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
        Skipped when a checkpoint restore already supplied both."""
        from repro_torch.core import distributed as dist

        src = self.source
        K = self.config.n_topics
        phi = psi = None
        z = np.zeros(src.n_tokens, np.int32)
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
        stream = None
        if self._streaming:
            from repro_torch.data.stream import SegmentStream

            if self.state is None:      # fresh run (no checkpoint restored)
                self._materialize_stream_state()
            self._omega_parts.clear()
            stream = SegmentStream(self.source, self._z, prefetch=cfg.prefetch,
                                   device=self.device)
        if self._alias and self._tables is None:
            # fresh run: build from the (phi, psi, α) the session starts from
            self._rebuild_tables()
            self._tables_built_at = self.epoch
        state = hierarchy.run_hierarchical(
            self._timed_epoch, None, self.state, self.alpha, self.beta,
            cfg.n_epochs, cfg.agg_every, seed0=cfg.seed * 131 + 7,
            start_epoch=start_epoch, on_epoch_end=self._hook_epoch_end,
            segments=stream, start_segment=self.segment,
            on_segment_end=self._hook_segment_end if stream else None,
            epoch_aux=self._epoch_tables if self._alias else None,
        )
        self.state = tuple(state)
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

    def _fold_segment_omega(self, seg) -> None:
        """Ω_kn part for one just-committed segment (its z is final for this
        epoch), from the segment's device stacks — no re-read. Pad slots add
        nothing (their valid flag is 0), so this equals the JAX package's
        fold over the host views."""
        self._omega_parts[seg.gid] = self._segment_omega(seg.dl, seg.z, seg.wl >= 0)

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
        if ep > 0 and ep % self.config.agg_every == 0 and self._tables_built_at != ep:
            self._rebuild_tables()
            self._tables_built_at = ep
        elif self._tables_alpha is not self.alpha:
            self._rebuild_tables(word=False)
        return tuple(self._tables)

    @property
    def has_aggregation(self) -> bool:
        """Whether this session has aggregation boundaries (multi-pod: never
        on one device)."""
        return False

    @property
    def agg_fn(self):
        """The boundary-merge callable (None: a single-pod session)."""
        return None

    def local_model(self):
        """(phi_shards, psi) of the single pod."""
        return self.state[0], self.state[1]

    def gather_phi(self) -> torch.Tensor:
        """Reassembled global [V, K] topic-count matrix, on the session's device."""
        from repro_torch.core import distributed as dist

        phi0, _ = self.local_model()
        return dist.gather_phi(phi0, self.sc0)

    def log_likelihood(self) -> float:
        from repro_torch.core import lda

        _, psi0 = self.local_model()
        return float(lda.word_log_likelihood(self.gather_phi(), psi0, self.beta))

    def alpha_statistics(self):
        """Coordinator stats for the Minka fixed point: (Ω_kn histogram,
        doc-length histogram) — two small arrays, never per-document state.
        Streamed sessions sum the parts folded at each segment's SaveShard;
        outside that window (or in a partially replayed resume epoch) they
        fold the histogram over every segment (z gathered from the global
        store, stacks re-read from the source — mmap'd, so this stays
        out-of-core too)."""
        from repro_torch.core import dedup

        if self._streaming:
            n = self.source.n_segments
            if len(self._omega_parts) == n:
                omega = sum(self._omega_parts[g] for g in range(n))
            else:
                omega = None
                dev = self.device
                for g in range(n):
                    sc = self.source.segment(g)
                    o = self._segment_omega(
                        torch.from_numpy(np.array(sc.doc_local, np.int32)).to(dev),
                        torch.from_numpy(self._z[np.asarray(sc.uid)]).to(dev),
                        torch.from_numpy(np.asarray(sc.word_local) >= 0).to(dev))
                    omega = o if omega is None else omega + o
        else:
            wl, dl, z = self.state[2], self.state[3], self.state[5]
            omega = self._segment_omega(dl, z, wl >= 0)
        if self._doc_len_hist is None:
            self._doc_len_hist = dedup.doc_length_histogram(
                torch.from_numpy(self.source.doc_lengths()).to(self.device))
        return omega, self._doc_len_hist

    # ------------------------------------------------- checkpoint plumbing -

    def checkpoint_tree(self) -> dict:
        """The session's state as the JAX package lays it out: uid as uint32;
        leaves numbered in sorted-key order (alpha, state, tables, z)."""
        state = list(self.state)
        if len(state) == 6:
            state[4] = state[4].cpu().numpy().astype(np.uint32)
        tree = {"state": tuple(state), "alpha": self.alpha}
        if self._alias and self._tables is not None:
            # the stale proposal tables are part of the sampler's state: a
            # resume must replay against the same staleness
            tree["tables"] = tuple(self._tables)
        if self._streaming:
            # streamed sessions checkpoint (phi, psi) + the GLOBAL z store:
            # the stacks are reproducible from the source, z is not — and a
            # resume must land bit for bit on the recorded (epoch, segment)
            tree["z"] = np.array(self._z)
        return tree

    def _tables_like(self, phi_shape) -> tuple:
        """Structure-only stand-in for the alias tables (wq, wp, wa, ap, aa)."""
        K = self.config.n_topics
        return (np.zeros(phi_shape, np.float32),
                np.zeros(phi_shape, np.float32),
                np.zeros(phi_shape, np.int32),
                np.zeros((K,), np.float32),
                np.zeros((K,), np.int32))

    def checkpoint_like(self) -> dict:
        self.setup()
        if self._streaming and self.state is None:
            # restore template before the lazy init pass: the loader only
            # needs the tree STRUCTURE (leaf count + order), not values
            cfg = self.config
            K, M = cfg.n_topics, cfg.ring_size
            phi_shape = (M, self.sc0.rows_per_shard, K)
            like = {"state": (np.zeros(phi_shape, np.int32),
                              np.zeros((K,), np.int32)),
                    "alpha": np.zeros((K,), np.float32),
                    "z": np.zeros(self.source.n_tokens, np.int32)}
            if self._alias:
                like["tables"] = self._tables_like(phi_shape)
            return like
        tree = self.checkpoint_tree()
        if self._alias and "tables" not in tree:
            # restore runs before fit()'s lazy table build — synthesize the
            # template from the phi shape (values never reach the loader)
            tree["tables"] = self._tables_like(tuple(self.state[0].shape))
        return tree

    def load_checkpoint(self, tree: dict, meta: dict) -> None:
        ck_p = int(meta.get("n_model_shards", 1))
        if ck_p != self.config.n_model_shards:
            raise NotImplementedError(
                f"the checkpoint was written with n_model_shards={ck_p}; resharding "
                f"(training/reshard.py) is not ported ({_MULTI_GPU})")
        dev = self.device
        leaf = lambda x: torch.from_numpy(np.array(x)).to(dev)
        state = [leaf(x) for x in tree["state"]]
        if len(state) == 6:
            state[4] = leaf(np.asarray(tree["state"][4]).astype(np.int64))
        self.state = tuple(state)
        self.alpha = leaf(tree["alpha"])
        if "z" in tree:
            self._z = np.array(tree["z"], np.int32)
        self.epoch = int(meta.get("epoch", meta["step"]))
        self.segment = int(meta.get("segment", 0))
        if "tables" in tree:
            from repro_torch.core import sparse

            self._tables = sparse.AliasTables(*(leaf(x) for x in tree["tables"]))
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
        n_topics, n_topics_raw}``.
        """
        from repro_torch.core import dedup, rtlda

        cfg = self.config
        merge_l1 = cfg.dedup_merge_l1 if merge_l1 is None else merge_l1
        dup_l1 = cfg.dedup_dup_l1 if dup_l1 is None else dup_l1
        _, psi0 = self.local_model()
        phi_full = self.gather_phi()
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
        pub_s = self.metrics.get("publish_s", [])
        ll = self.metrics.get("ll", [])
        src = self.source
        tokens = int(src.n_tokens) if src is not None else (
            int(self.corpus.n_tokens) if self.corpus is not None else 0)
        mean = lambda xs: float(np.mean(xs)) if xs else None
        dev = self.device
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
            "agg_s_mean": None,
            "n_aggregates": 0,
            "publish_s_mean": mean(pub_s),
            "n_publishes": len(pub_s),
            "ll_final": ll[-1] if ll else None,
        }
