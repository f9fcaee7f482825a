"""The Trainer's callback/event protocol and the built-in callbacks (port of
``repro.training.callbacks``).

Everything the monolithic ``launch/train.py`` used to do with inline ``if``
blocks — periodic checkpoints, Minka α optimization, failure simulation,
metrics/bench emission, elastic liveness — is a :class:`TrainerCallback`
here. The Trainer fires events in callback-list order:

    on_train_start                       (once, before the epoch loop;
                                          checkpoint restore happens here)
    on_segment_end(epoch, segments_done) (streamed sessions: after each
                                          segment's SaveShard swap)
    on_epoch_end(epoch)                  (after every epoch, post-merge at
                                          aggregation boundaries)
    on_aggregate(epoch)                  (after each ΔΦ/ΔΨ boundary merge)
    on_checkpoint(epoch, path)           (after a checkpoint lands)
    on_publish(epoch, version, path)     (after a model snapshot lands)
    on_train_end                         (once, after a *completed* run)

Callbacks read and mutate the trainer: ``trainer.alpha = ...`` inside
``on_epoch_end`` feeds the next epoch (the coordinator's hyperparameter
redistribution), and ``trainer.metrics`` is the shared scratchpad the bench
record is assembled from. Peacock §3.1.4 fault recovery is literally
``Checkpointing`` restoring in ``on_train_start`` + deterministic replay of
the epochs after ``meta["step"]`` — no trainer code knows about it.

In a session of several ranks every rank runs the same callbacks on its own
``Trainer``, so the collectives they reach (the word LL, the α statistics,
the checkpoint assembly, the export) line up; only rank 0 writes.
"""
from __future__ import annotations

import json
import time
from typing import Optional


class TrainerCallback:
    """Base class: every hook is a no-op; override what you need."""

    def on_train_start(self, trainer) -> None:
        pass

    def on_segment_end(self, trainer, epoch: int, segments_done: int) -> None:
        pass

    def on_epoch_end(self, trainer, epoch: int) -> None:
        pass

    def on_aggregate(self, trainer, epoch: int) -> None:
        pass

    def on_checkpoint(self, trainer, epoch: int, path: str) -> None:
        pass

    def on_publish(self, trainer, epoch: int, version: int, path: str) -> None:
        pass

    def on_train_end(self, trainer) -> None:
        pass


class Checkpointing(TrainerCallback):
    """Periodic checkpoints + the §3.1.4 restore path.

    Saves ``trainer.checkpoint_tree()`` through a :class:`CheckpointManager`
    with rotation, on up to three cadences:

    * ``every`` — every N epochs (defaults to ``config.ckpt_every``);
    * ``every_boundaries`` — every N *aggregation boundaries* (the per-pod
      cadence of §3.1.4: the merged state is the coherent thing to persist).
      The save runs at the boundary epoch's ``on_epoch_end`` — after the
      merge AND after any ``AlphaOptimizer`` listed earlier — never
      mid-window, so a resume replays from a pods-agree point. Setting it
      disables the epoch cadence unless ``every`` is also given explicitly.
    * ``every_segments`` — streamed sessions: every N segment swaps within
      an epoch. Checkpoints record ``(epoch, segment)`` so a kill→resume
      lands bitwise on the exact segment boundary. A due save at the LAST
      segment of an epoch is deferred to that epoch's end — same state,
      but post-α — so it is never silently dropped.

    When ``config.resume`` is set, ``on_train_start`` restores the latest
    complete checkpoint and fast-forwards the trainer to its
    ``(epoch, segment)`` — deterministic counter-based seeding replays the
    gap bit-for-bit.
    """

    def __init__(self, directory: Optional[str] = None,
                 every: Optional[int] = None, keep: Optional[int] = None,
                 async_save: Optional[bool] = None, pod: Optional[int] = None,
                 every_boundaries: Optional[int] = None,
                 every_segments: Optional[int] = None):
        self.directory = directory
        self.every = every
        self.keep = keep
        self.async_save = async_save
        self.pod = pod
        self.every_boundaries = every_boundaries
        self.every_segments = every_segments
        self.manager = None
        self._boundary_epoch = None  # epoch of the most recent boundary

    def _ensure_manager(self, trainer):
        if self.manager is None:
            from repro_torch.checkpoint.manager import CheckpointManager

            cfg = trainer.config
            directory = self.directory or cfg.ckpt_dir
            if directory is None:
                raise ValueError("Checkpointing needs a directory "
                                 "(or TrainerConfig.ckpt_dir)")
            if self.every is None:
                # a pure boundary cadence replaces the epoch cadence
                self.every = (0 if self.every_boundaries is not None
                              else cfg.ckpt_every)
            keep = cfg.ckpt_keep if self.keep is None else self.keep
            async_save = (cfg.ckpt_async if self.async_save is None
                          else self.async_save)
            self.manager = CheckpointManager(directory, keep=keep,
                                             async_save=async_save)
        return self.manager

    def on_train_start(self, trainer) -> None:
        # cadences that can never fire are silent data loss — refuse loudly
        # (same class as a single-pod ElasticLiveness / unreachable
        # KillSwitch.at_segment)
        if self.every_boundaries:
            cfg = trainer.config
            n_boundaries = (cfg.n_epochs // cfg.agg_every
                            if trainer.has_aggregation else 0)
            if n_boundaries < self.every_boundaries:
                raise ValueError(
                    f"Checkpointing(every_boundaries="
                    f"{self.every_boundaries}) can never fire: this "
                    f"session reaches {n_boundaries} aggregation "
                    f"boundary(ies) (n_pods > 1 and agg_every <= n_epochs "
                    f"required), so no checkpoint would ever be written")
        if self.every_segments and not (
                1 < trainer.n_segments
                and self.every_segments <= trainer.n_segments):
            raise ValueError(
                f"Checkpointing(every_segments={self.every_segments}) "
                f"can never fire: the session streams "
                f"{trainer.n_segments} segment(s) per epoch, so no "
                f"segment boundary the cadence could save at is reached")
        mgr = self._ensure_manager(trainer)
        if trainer.config.resume:
            restored = mgr.restore_latest(trainer.checkpoint_like(),
                                          pod=self.pod)
            if restored is not None:
                tree, meta = restored
                trainer.load_checkpoint(tree, meta)
                at = (f" (+{trainer.segment} segments)"
                      if trainer.segment else "")
                trainer.log(f"[recovery] resumed from epoch {trainer.epoch}"
                            f"{at} (deterministic replay covers the gap)")

    # steps must stay monotonic across mixed epoch/segment saves: the global
    # step of (epoch, segments_done) is epoch * n_segments + segments_done
    # (n_segments == 1 keeps the historical step == epoch numbering)
    def _save(self, trainer, epoch: int, segments_done: int) -> str:
        n = trainer.n_segments
        step = epoch * n + segments_done
        tree = trainer.checkpoint_tree()        # a collective on several ranks
        if tree is not None:                    # rank 0 (or the one device)
            self.manager.save(step, tree,
                              meta={"epoch": epoch, "segment": segments_done,
                                    "n_model_shards":
                                        trainer.config.n_model_shards},
                              pod=self.pod)
        return self.manager.step_dir(step, self.pod)

    def on_segment_end(self, trainer, epoch: int, segments_done: int) -> None:
        if not self.every_segments or segments_done % self.every_segments:
            return
        if segments_done >= trainer.n_segments:
            return              # epoch-end save covers the last boundary
        path = self._save(trainer, epoch, segments_done)
        trainer.log(f"[ckpt] epoch {epoch} +{segments_done}/"
                    f"{trainer.n_segments} segments saved")
        trainer.notify("on_checkpoint", epoch, path)

    def on_aggregate(self, trainer, epoch: int) -> None:
        self._boundary_epoch = epoch

    def on_epoch_end(self, trainer, epoch: int) -> None:
        due = self.every and (epoch + 1) % self.every == 0
        if self.every_boundaries and self._boundary_epoch == epoch:
            # boundary ordinal derived from the epoch, not a session-local
            # counter — a resumed run keeps the uninterrupted run's cadence
            n_boundary = (epoch + 1) // trainer.config.agg_every
            if n_boundary % self.every_boundaries == 0:
                due = True
        if (self.every_segments and trainer.n_segments > 1
                and trainer.n_segments % self.every_segments == 0):
            # the segment cadence's save at the last boundary of the epoch,
            # deferred here so it lands post-α (on_segment_end skips it)
            due = True
        if not due:
            return
        path = self._save(trainer, epoch + 1, 0)
        trainer.log(f"[ckpt] epoch {epoch + 1} saved")
        trainer.notify("on_checkpoint", epoch, path)

    def on_train_end(self, trainer) -> None:
        if self.manager is not None:
            self.manager.wait()


class AlphaOptimizer(TrainerCallback):
    """Coordinator-side Minka fixed point on (Ω_kn, doc-length) histograms
    (paper Fig. 3 line 4 / [23]): from ``from_epoch`` on, re-derives the
    asymmetric α after every epoch and feeds it to the next one."""

    def __init__(self, from_epoch: Optional[int] = None,
                 n_iters: Optional[int] = None):
        self.from_epoch = from_epoch
        self.n_iters = n_iters

    def on_epoch_end(self, trainer, epoch: int) -> None:
        from repro_torch.core import dedup

        cfg = trainer.config
        start = cfg.alpha_opt_from if self.from_epoch is None else self.from_epoch
        if epoch < start:
            return
        omega, hist = trainer.alpha_statistics()
        n_iters = cfg.alpha_opt_iters if self.n_iters is None else self.n_iters
        trainer.alpha = dedup.optimize_alpha(trainer.alpha, omega, hist,
                                             n_iters=n_iters)


class KillSwitch(TrainerCallback):
    """Failure simulation: exit mid-run after ``at_epoch`` epochs (post
    checkpoint), so the ``--resume`` recovery path can be demonstrated and
    tested. Mirrors the old ``--kill-at`` inline block, exit code included.

    ``at_segment`` moves the failure INSIDE the ``at_epoch``-th epoch of a
    streamed session: the run dies after ``at_segment`` segment swaps of
    epoch index ``at_epoch - 1`` (the epoch that would have been the
    ``at_epoch``-th to complete), i.e. at a segment boundary — the exact
    point a segment-cadence checkpoint covers.
    """

    def __init__(self, at_epoch: int, exit_code: int = 17,
                 at_segment: Optional[int] = None):
        self.at_epoch = at_epoch
        self.exit_code = exit_code
        self.at_segment = at_segment

    def on_train_start(self, trainer) -> None:
        # a segment kill that can never fire is a failure-sim that silently
        # tests nothing (same class of bug as a single-pod ElasticLiveness)
        if self.at_segment is None:
            return
        if trainer.n_segments <= 1:
            raise ValueError("KillSwitch(at_segment=) requires a streamed "
                             "session (n_segments > 1); this session fires "
                             "no segment events")
        if not (1 <= self.at_segment <= trainer.n_segments):
            raise ValueError(f"KillSwitch.at_segment={self.at_segment} can "
                             f"never fire: the session has "
                             f"{trainer.n_segments} segments per epoch")

    def on_segment_end(self, trainer, epoch: int, segments_done: int) -> None:
        if self.at_segment is None:
            return
        if epoch == self.at_epoch - 1 and segments_done == self.at_segment:
            trainer.log(f"[failure-sim] killing run after segment "
                        f"{segments_done} of epoch {epoch}; restart with "
                        f"--resume")
            self._exit(trainer)

    def _exit(self, trainer) -> None:
        # every rank dies together, after rank 0's checkpoint has landed
        for cb in trainer.callbacks:
            if isinstance(cb, Checkpointing) and cb.manager is not None:
                cb.manager.wait()
        trainer.barrier()
        raise SystemExit(self.exit_code)

    def on_epoch_end(self, trainer, epoch: int) -> None:
        if self.at_segment is not None:
            return
        if epoch + 1 == self.at_epoch:
            trainer.log(f"[failure-sim] killing run after epoch {epoch + 1}; "
                        f"restart with --resume")
            self._exit(trainer)


class ElasticLiveness(TrainerCallback):
    """Wires §3.1.4 elastic aggregation: ``probe(epoch) -> [n_pods]`` flags.

    Its presence makes the Trainer build ``make_elastic_aggregate`` (merge
    over live pods only) instead of the all-live aggregate; the probe is
    consulted at every boundary, on every rank (it must give every rank the
    same flags). ``last_n_live`` records the live count of the most recent
    boundary. A single-pod session refuses it in ``Trainer.setup``.
    """

    def __init__(self, probe):
        self.probe = probe
        self.last_n_live: Optional[int] = None

    def on_aggregate(self, trainer, epoch: int) -> None:
        self.last_n_live = getattr(trainer.agg_fn, "last_n_live", None)


class Metrics(TrainerCallback):
    """Per-epoch likelihood logging + the ``BENCH_train.json`` record.

    Reads the shared ``trainer.metrics`` scratchpad (epoch/aggregate/publish
    wall times, recorded by the trainer and publisher) and adds the model
    log-likelihood; ``on_train_end`` assembles the machine-readable bench
    record so the perf trajectory has a training line next to
    ``BENCH_serve.json``.
    """

    def __init__(self, log_every: int = 1, bench_out: Optional[str] = None,
                 printer=None):
        self.log_every = log_every
        self.bench_out = bench_out
        self.printer = printer
        self._t0 = None

    def on_train_start(self, trainer) -> None:
        self._t0 = time.time()

    def on_epoch_end(self, trainer, epoch: int) -> None:
        if (epoch + 1) % self.log_every != 0:
            return
        ll = trainer.log_likelihood()
        trainer.metrics["ll"].append(ll)
        trainer.metrics["ll_epoch"].append(epoch + 1)
        elapsed = time.time() - (self._t0 or time.time())
        msg = (f"epoch {epoch + 1:3d}/{trainer.config.n_epochs}  "
               f"LL {ll:,.0f}  ({elapsed:.1f}s)")
        (self.printer or trainer.log)(msg)

    def on_train_end(self, trainer) -> None:
        out = self.bench_out or trainer.config.bench_out
        if not out or not getattr(trainer, "is_writer", True):
            return
        record = trainer.bench_record()
        with open(out, "w") as f:
            json.dump(record, f, indent=2)
        trainer.log(f"[bench] wrote {out}")
