"""The Trainer's callback/event protocol and the built-in callbacks (port of
``repro.training.callbacks``).

Everything the monolithic ``launch/train.py`` used to do with inline ``if``
blocks — periodic checkpoints, Minka α optimization, failure simulation,
metrics/bench emission, elastic liveness — is a :class:`TrainerCallback`
here. The Trainer fires events in callback-list order:

    on_train_start                   (once, before the epoch loop;
                                      checkpoint restore happens here)
    on_epoch_end(epoch)              (after every epoch, post-merge at
                                      aggregation boundaries)
    on_aggregate(epoch)              (after each ΔΦ/ΔΨ boundary merge)
    on_checkpoint(epoch, path)       (after a checkpoint lands)
    on_publish(epoch, version, path) (after a model snapshot lands)
    on_train_end                     (once, after a *completed* run)

The streamed session's ``on_segment_end`` event, the segment checkpoint
cadence and ``KillSwitch(at_segment=)`` come with segment streaming (ROADMAP
queue 1, the data/stream.py item): the port trains one resident segment.

Callbacks read and mutate the trainer: ``trainer.alpha = ...`` inside
``on_epoch_end`` feeds the next epoch (the coordinator's hyperparameter
redistribution), and ``trainer.metrics`` is the shared scratchpad the bench
record is assembled from. Peacock §3.1.4 fault recovery is literally
``Checkpointing`` restoring in ``on_train_start`` + deterministic replay of
the epochs after ``meta["step"]`` — no trainer code knows about it.
"""
from __future__ import annotations

import json
import time
from typing import Optional


class TrainerCallback:
    """Base class: every hook is a no-op; override what you need."""

    def on_train_start(self, trainer) -> None:
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
    with rotation, on up to two cadences:

    * ``every`` — every N epochs (defaults to ``config.ckpt_every``);
    * ``every_boundaries`` — every N *aggregation boundaries* (the per-pod
      cadence of §3.1.4: the merged state is the coherent thing to persist).
      The save runs at the boundary epoch's ``on_epoch_end`` — after the
      merge AND after any ``AlphaOptimizer`` listed earlier — never
      mid-window, so a resume replays from a pods-agree point. Setting it
      disables the epoch cadence unless ``every`` is also given explicitly.

    Checkpoints record ``(epoch, segment)`` with segment 0, the JAX
    package's meta. When ``config.resume`` is set, ``on_train_start``
    restores the latest complete checkpoint and fast-forwards the trainer to
    its epoch — deterministic counter-based seeding replays the gap
    bit-for-bit.
    """

    def __init__(self, directory: Optional[str] = None,
                 every: Optional[int] = None, keep: Optional[int] = None,
                 async_save: Optional[bool] = None, pod: Optional[int] = None,
                 every_boundaries: Optional[int] = None):
        self.directory = directory
        self.every = every
        self.keep = keep
        self.async_save = async_save
        self.pod = pod
        self.every_boundaries = every_boundaries
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
        # (same class as a single-pod ElasticLiveness)
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

    # one segment an epoch: the step is the epoch, as in the JAX package's
    # numbering (epoch * n_segments + segments_done)
    def _save(self, trainer, epoch: int) -> str:
        self.manager.save(epoch, trainer.checkpoint_tree(),
                          meta={"epoch": epoch, "segment": 0,
                                "n_model_shards":
                                    trainer.config.n_model_shards},
                          pod=self.pod)
        return self.manager.step_dir(epoch, self.pod)

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
        if not due:
            return
        path = self._save(trainer, epoch + 1)
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
    """

    def __init__(self, at_epoch: int, exit_code: int = 17):
        self.at_epoch = at_epoch
        self.exit_code = exit_code

    def on_epoch_end(self, trainer, epoch: int) -> None:
        if epoch + 1 == self.at_epoch:
            trainer.log(f"[failure-sim] killing run after epoch {epoch + 1}; "
                        f"restart with --resume")
            raise SystemExit(self.exit_code)


class ElasticLiveness(TrainerCallback):
    """Wires §3.1.4 elastic aggregation: ``probe(epoch) -> [n_pods]`` flags.

    Its presence asks for a merge over live pods only at every aggregation
    boundary. The port runs no pods yet (ROADMAP queue 1, item 11): a
    single-pod session refuses it in ``Trainer.setup``, as the JAX package's
    does, since its probe would never be consulted.
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
        if not out:
            return
        record = trainer.bench_record()
        with open(out, "w") as f:
            json.dump(record, f, indent=2)
        trainer.log(f"[bench] wrote {out}")
