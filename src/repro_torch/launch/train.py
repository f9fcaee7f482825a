"""Training driver of the port for peacock-lda (twin of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --docs 3000 --topics 32 \
        --epochs 20 [--device cpu]

Thin adapter: argparse → :class:`repro_torch.training.TrainerConfig` → a
:class:`repro_torch.training.Trainer` with the standard callback stack (α
optimization, checkpoints, failure simulation, metrics), the same flags as
the JAX driver plus ``--device`` (``cuda`` by default; ``cpu`` on request).

Supports --resume (restores the latest complete checkpoint, fault-recovery
path §3.1.4) and --kill-at (simulates a mid-run failure for the recovery
demo, exit 17). ``--publish-dir`` adds a :class:`ModelPublisher`, and
``--bench-out`` writes the machine-readable BENCH_train.json record.

Out-of-core training (the ``repro_torch.data`` streaming pipeline):
``--corpus-dir`` points at a ``save_segments()`` directory — segments are
memory-mapped and streamed through a double-buffered ``SegmentStream``
(``--no-prefetch`` disables the overlap), ``--n-segments`` segments a
synthetic corpus the same way, ``--ckpt-segments N`` adds segment-boundary
checkpoints, and ``--kill-at E --kill-at-segment S`` kills at an intra-epoch
segment boundary; ``--resume`` then lands bit for bit on the recorded
(epoch, segment).

The port trains on one device. Flags it cannot serve yet are refused with an
error naming the ROADMAP item: ``--pods``, ``--data-shards`` or
``--model-shards`` above 1 and ``--sharded-model`` (queue 1, item 11,
multi-GPU), and ``--preflight`` (queue 1, item 13: the static analysis
passes have no torch counterpart yet).
"""
import argparse
import os
import tempfile


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=3000)
    ap.add_argument("--vocab", type=int, default=800)
    ap.add_argument("--topics", type=int, default=32)
    ap.add_argument("--true-topics", type=int, default=20)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--n-segments", "--segments", dest="n_segments",
                    type=int, default=1,
                    help="out-of-core segments per epoch (Fig. 3/4 swaps)")
    ap.add_argument("--corpus-dir", default=None,
                    help="train from a repro_torch.data.save_segments() "
                         "directory (DiskSource, memory-mapped) instead of "
                         "synthetic")
    ap.add_argument("--prefetch", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="double-buffer segment loads on a background thread")
    ap.add_argument("--data-shards", type=int, default=1)
    ap.add_argument("--model-shards", type=int, default=1)
    ap.add_argument("--sharded-model", action="store_true",
                    help="word-sharded model parallelism (not ported)")
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--agg-every", type=int, default=3)
    ap.add_argument("--alpha-opt-from", type=int, default=10)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "peacock_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--ckpt-segments", type=int, default=0,
                    help="also checkpoint every N segment swaps (0 = off)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--kill-at", type=int, default=-1,
                    help="simulate a failure after this epoch (exit 17)")
    ap.add_argument("--kill-at-segment", type=int, default=-1,
                    help="with --kill-at E: die after this many segment "
                         "swaps of the E-th epoch (segment boundary)")
    ap.add_argument("--package-len", type=int, default=0)
    ap.add_argument("--sampler", choices=("dense", "alias"), default="dense",
                    help="inner-loop family: exact dense plane scan, or "
                         "sparsity-aware alias-table MH")
    ap.add_argument("--n-mh", type=int, default=4,
                    help="MH steps per token for --sampler alias")
    ap.add_argument("--publish-dir", default=None,
                    help="publish versioned RT-LDA snapshots here")
    ap.add_argument("--publish-every", type=int, default=1,
                    help="publish every N boundaries (needs --publish-dir)")
    ap.add_argument("--bench-out", default="BENCH_train.json",
                    help="machine-readable bench record ('' disables)")
    ap.add_argument("--preflight", action="store_true",
                    help="static contract checks (not ported)")
    ap.add_argument("--preflight-json", action="store_true",
                    help="with --preflight: machine-readable report")
    ap.add_argument("--device", default="cuda",
                    help="where the session runs: cuda (default) or cpu")
    return ap


def config_from_args(args) -> "TrainerConfig":
    """The argparse→TrainerConfig mapping (the JAX driver's, plus ``device``)."""
    from repro_torch.training import TrainerConfig

    return TrainerConfig(
        n_docs=args.docs, vocab_size=args.vocab, n_topics=args.topics,
        true_topics=args.true_topics, doc_len_mean=8,
        n_segments=args.n_segments, corpus_dir=args.corpus_dir,
        prefetch=args.prefetch,
        n_pods=args.pods, data_shards=args.data_shards,
        model_shards=args.model_shards,
        n_model_shards=args.model_shards if getattr(args, "sharded_model",
                                                    False) else 1,
        n_epochs=args.epochs, agg_every=args.agg_every,
        alpha_opt_from=args.alpha_opt_from, package_len=args.package_len,
        sampler=args.sampler, n_mh=args.n_mh, device=args.device,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        resume=args.resume,
        bench_out=args.bench_out or None,
    )


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.preflight:
        ap.error("--preflight: the static analysis passes are not ported "
                 "(ROADMAP queue 1, item 13)")
    if args.sharded_model:
        ap.error("--sharded-model: word-sharded model slices are not ported "
                 "(ROADMAP queue 1, item 11 (multi-GPU))")
    if args.kill_at_segment > 0 and args.kill_at <= 0:
        ap.error("--kill-at-segment requires --kill-at (the epoch to die "
                 "in); without it no KillSwitch is armed and the failure "
                 "simulation would silently never fire")

    from repro_torch.training import (AlphaOptimizer, Checkpointing, KillSwitch,
                                      Metrics, ModelPublisher, Trainer)
    from repro_torch.training.trainer import refuse_unported

    cfg = config_from_args(args)
    try:
        refuse_unported(cfg)
    except NotImplementedError as exc:
        ap.error(str(exc))
    # the JAX driver's order: α-opt → checkpoint → kill → publish → metrics
    callbacks = [AlphaOptimizer(),
                 Checkpointing(every_segments=args.ckpt_segments or None)]
    if args.kill_at > 0:
        at_seg = args.kill_at_segment if args.kill_at_segment > 0 else None
        callbacks.append(KillSwitch(args.kill_at, at_segment=at_seg))
    if args.publish_dir:
        callbacks.append(ModelPublisher(args.publish_dir,
                                        every=args.publish_every))
    callbacks.append(Metrics())

    # setup() logs the data source (type / docs / tokens / segments)
    trainer = Trainer(cfg, callbacks=callbacks).setup()

    trainer.fit()

    # ----------------------- dedup + serving export -------------------------
    model, info = trainer.export_model()
    print(f"[dedup] duplicate fraction {info['duplicate_fraction']:.2f}; "
          f"{info['n_topics_raw']} → {info['n_topics']} topics")
    print(f"[export] RT-LDA model ready: V={model.pvk.shape[0]} "
          f"K={model.pvk.shape[1]}")
    return trainer


if __name__ == "__main__":
    main()
