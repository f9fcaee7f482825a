"""``ModelPublisher`` — the callback that closes the train→publish→serve loop
(port of ``repro.training.publisher``).

Peacock's industrial value is that configurations train *continuously* and
fresh RT-LDA models flow to online serving (§3.1–§3.3). The engine side has
had lock-free ``swap_model`` since the TopicEngine landed; this is the side
that produces something to swap: every N publish boundaries (aggregation
boundaries in a multi-pod run — the points where the merged model is
coherent across configurations — or epochs in a single-pod run) the
publisher runs the trainer's shared dedup-distance pass + cluster merge,
builds an :class:`RTLDAModel`, and writes a versioned snapshot

    <snapshot_dir>/v_<n>/{arrays.npz, manifest.json}

through ``checkpoint.snapshots`` (atomic tmp+rename ⇒ readers never see a
torn model; manifest presence is the completeness marker; old versions
rotate away like checkpoints). The layout is the JAX package's, so its
serving fleet's ``SnapshotWatcher`` can hot-swap what the port publishes.
"""
from __future__ import annotations

import time
from typing import Optional

from repro_torch.checkpoint import io, snapshots
from repro_torch.training.callbacks import TrainerCallback


class ModelPublisher(TrainerCallback):
    """Publish versioned RT-LDA snapshots on a boundary cadence.

    Args:
      snapshot_dir: root of the versioned snapshot tree.
      every: publish every N-th boundary (aggregations when the trainer has
        an aggregate fn, epochs otherwise).
      keep: versions retained (rotation, like checkpoints).
      at_start: also publish v0 *before* the first epoch, so a serving fleet
        has a model the moment the session starts. Events fire in
        callback-list order — in a resumable session put ``Checkpointing``
        BEFORE this publisher, or the at-start publish ships the random
        init instead of the restored model.
      at_end: publish the final model on ``on_train_end``.
      merge_l1 / dup_l1: dedup thresholds forwarded to
        ``Trainer.export_model`` (default: the TrainerConfig values).
      delta: publish row-diffs against the previous published Φ instead of
        full payloads (``snapshots.save_delta_snapshot``) — at K=10⁵ a full
        V×K serialization per boundary would stall the fleet's refresh
        cadence, while one epoch touches only the rows its shard saw.
        Readers reconstruct transparently via the manifest's base pointer.
      full_every: with ``delta``, still write a full snapshot every M-th
        publish (bounds the reconstruction chain and caps what rotation
        must keep alive). A Φ shape change (dedup moved K) also forces a
        full snapshot.
    """

    def __init__(self, snapshot_dir: str, every: int = 1, keep: int = 3,
                 at_start: bool = False, at_end: bool = True,
                 merge_l1: Optional[float] = None,
                 dup_l1: Optional[float] = None,
                 delta: bool = False, full_every: int = 8):
        if every <= 0:
            raise ValueError("ModelPublisher.every must be > 0")
        if full_every <= 1:
            raise ValueError("ModelPublisher.full_every must be > 1")
        self.snapshot_dir = snapshot_dir
        self.every = every
        self.keep = keep
        self.at_start = at_start
        self.at_end = at_end
        self.merge_l1 = merge_l1
        self.dup_l1 = dup_l1
        self.delta = bool(delta)
        self.full_every = int(full_every)
        self._boundaries = 0
        self._last_publish_epoch: Optional[int] = None
        self._base_pvk = None               # Φ of the last published version
        self._base_version: Optional[int] = None
        self._since_full = 0                # deltas since the last full
        self.last_version: Optional[int] = None
        self.last_path: Optional[str] = None

    # ------------------------------------------------------------ events ---

    def on_train_start(self, trainer) -> None:
        if self.at_start:
            self.publish(trainer, epoch=trainer.epoch - 1)

    def on_aggregate(self, trainer, epoch: int) -> None:
        self._boundaries += 1
        if self._boundaries % self.every == 0:
            self.publish(trainer, epoch)

    def on_epoch_end(self, trainer, epoch: int) -> None:
        if trainer.has_aggregation:
            return          # multi-pod: publish at aggregation boundaries
        self._boundaries += 1
        if self._boundaries % self.every == 0:
            self.publish(trainer, epoch)

    def on_train_end(self, trainer) -> None:
        # final model, unless a boundary publish already covered this epoch
        if self.at_end and self._last_publish_epoch != trainer.epoch:
            self.publish(trainer, epoch=trainer.epoch - 1)

    # ----------------------------------------------------------- publish ---

    def publish(self, trainer, epoch: int) -> int:
        """Export + write one snapshot now; returns the new version."""
        t0 = time.perf_counter()
        model, info = trainer.export_model(merge_l1=self.merge_l1,
                                           dup_l1=self.dup_l1)
        self._last_publish_epoch = epoch + 1
        if model is None:
            # a rank of a multi-rank session that does not write: it took
            # part in the export's gather; rank 0 publishes
            return -1
        latest = snapshots.latest_version(self.snapshot_dir)
        version = 0 if latest is None else latest + 1
        meta = {"epoch": epoch + 1, **info}
        pvk = io.to_numpy(model.pvk)
        as_delta = (self.delta and self._base_pvk is not None
                    and self._since_full < self.full_every - 1
                    and pvk.shape == self._base_pvk.shape)
        if as_delta:
            path = snapshots.save_delta_snapshot(
                self.snapshot_dir, version, model,
                self._base_version, self._base_pvk, meta)
            self._since_full += 1
        else:
            path = snapshots.save_snapshot(
                self.snapshot_dir, version, model, meta)
            self._since_full = 0
        # next publish diffs against THIS payload (delta-over-delta chains
        # are fine: the loader walks bases, full_every bounds the depth)
        self._base_pvk, self._base_version = pvk.copy(), version
        snapshots.rotate_snapshots(self.snapshot_dir, self.keep)
        latency = time.perf_counter() - t0
        trainer.metrics["publish_s"].append(latency)
        self.last_version, self.last_path = version, path
        if as_delta:
            d = snapshots.read_meta(self.snapshot_dir, version)["delta"]
            kind = f"delta {d['n_rows']}/{d['n_rows_total']} rows"
        else:
            kind = "full"
        trainer.log(f"[publish] v_{version:06d} @ epoch {epoch + 1} ({kind}): "
                    f"K {info['n_topics_raw']} → {info['n_topics']} "
                    f"(dup {info['duplicate_fraction']:.2f}) "
                    f"in {latency * 1e3:.0f} ms")
        trainer.notify("on_publish", epoch, version, path)
        return version
