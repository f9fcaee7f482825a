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

Several ranks: ``--pods``, ``--data-shards``, ``--model-shards`` and
``--sharded-model`` shape the (pods, data, model) mesh, one process per
rank. Under a launcher that sets ``WORLD_SIZE`` (torchrun) this process is
one rank; otherwise the driver starts the whole world itself on this host
(the counterpart of the JAX driver's XLA host-device flag), so one command
still trains. ``--backend`` names the process-group backend (gloo by
default; NCCL with one rank per card) and ``--ranks-per-device`` lets
several ranks share one card (gloo only), e.g. on one H100::

    python -m repro_torch.launch.train --pods 2 --data-shards 2 \
        --ranks-per-device 4 --docs 1500 --vocab 400 --topics 16 --epochs 6

The streamed flags work across the ranks of one pod: each rank streams its
block of every segment, from memory or from a ``--corpus-dir`` (plain or
``--sharded-model`` layout), e.g. on one H100::

    python -m repro_torch.launch.train --data-shards 2 --model-shards 2 \
        --ranks-per-device 4 --n-segments 3 --ckpt-segments 1 --docs 1500 \
        --vocab 400 --topics 16 --epochs 4

Rank 0 prints, checkpoints and publishes; a started world returns each
rank's :func:`rank_summary`. Refused: a streamed corpus with ``--pods`` > 1
(as the JAX driver refuses it: segments are single-configuration).

``--preflight [--preflight-json]`` runs the launch gate
(``repro_torch.analysis.preflight.verify_trainer_config``) on the session
the flags describe and exits 0 or 1 before any rank starts; its own epoch
runs on gloo ranks on the CPU at a shrunk corpus and K.
"""
import argparse
import os
import sys
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
                    help="word-sharded model parallelism: the model axis holds "
                         "resident V/P slices of Φ and the alias tables instead "
                         "of extending the flattened ring")
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
                    help="run the launch gate (repro_torch.analysis: sharding "
                         "contract, sm_90 launch budgets, determinism, thread "
                         "contracts, repo lint) on this session's geometry and "
                         "exit 0 iff every check passes; no Trainer is built and "
                         "no rank of the session starts")
    ap.add_argument("--preflight-json", action="store_true",
                    help="with --preflight: machine-readable report")
    ap.add_argument("--device", default="cuda",
                    help="where the session runs: cuda (default) or cpu")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo",
                    help="process-group backend of a session of several ranks")
    ap.add_argument("--ranks-per-device", type=int, default=1,
                    help="ranks sharing one card (gloo only)")
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


def _train(args, layout=None):
    """Build the callback stack and the Trainer of this rank, fit, export."""
    from repro_torch.training import (AlphaOptimizer, Checkpointing, KillSwitch,
                                      Metrics, ModelPublisher, Trainer)

    cfg = config_from_args(args)
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
    trainer = Trainer(cfg, callbacks=callbacks, layout=layout).setup()

    trainer.fit()

    # ----------------------- dedup + serving export -------------------------
    model, info = trainer.export_model()
    if model is not None:
        print(f"[dedup] duplicate fraction {info['duplicate_fraction']:.2f}; "
              f"{info['n_topics_raw']} → {info['n_topics']} topics")
        print(f"[export] RT-LDA model ready: V={model.pvk.shape[0]} "
              f"K={model.pvk.shape[1]}")
    return trainer


def rank_summary(trainer) -> dict:
    """What a started rank hands back: its views of the state, α, the
    global z store of a streamed session (``None`` otherwise), the epoch
    reached, its metrics, its publisher's last version and its process's
    kernel launch counts. A collective on a streamed ring (the z store)."""
    from repro_torch.kernels.alias import ops as alias_ops
    from repro_torch.kernels.gibbs import ops as gibbs_ops
    from repro_torch.training import ModelPublisher

    pubs = [cb for cb in trainer.callbacks if isinstance(cb, ModelPublisher)]
    return {"rank": trainer.layout.rank if trainer.layout is not None else 0,
            "state": [x.cpu().numpy() for x in trainer.state],
            "alpha": trainer.alpha.cpu().numpy(), "z": trainer.global_z(),
            "epoch": trainer.epoch,
            "metrics": {k: list(v) for k, v in trainer.metrics.items()},
            "last_version": pubs[0].last_version if pubs else None,
            "launches": {"gibbs_argmax": gibbs_ops.launches,
                         "alias_build": alias_ops.build_launches,
                         "mh_resample": alias_ops.mh_launches}}


def _rank_main(layout, argv):
    return rank_summary(_train(build_parser().parse_args(argv), layout))


def main(argv=None):
    ap = build_parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    if args.kill_at_segment > 0 and args.kill_at <= 0:
        ap.error("--kill-at-segment requires --kill-at (the epoch to die "
                 "in); without it no KillSwitch is armed and the failure "
                 "simulation would silently never fire")
    if args.preflight:
        # the launch gate: verify the session's contracts (sharding layout,
        # sm_90 launch budgets, determinism, repo invariants) before any of
        # its ranks starts; no Trainer is built, nothing is allocated on the card
        from repro_torch.analysis import preflight as pf

        try:
            cfg = config_from_args(args)
        except ValueError as exc:
            ap.error(str(exc))
        report = pf.verify_trainer_config(cfg)
        print(report.to_json(indent=2) if args.preflight_json else report.render())
        raise SystemExit(0 if report.ok else 1)

    from repro_torch.launch import mesh

    try:
        cfg = config_from_args(args)         # refuses segments on several pods
        if cfg.n_devices > 1:
            mesh.check_world(cfg.n_devices, args.device, args.backend,
                             args.ranks_per_device)
    except (RuntimeError, ValueError) as exc:
        ap.error(str(exc))
    if cfg.n_devices == 1:
        return _train(args)
    shape = dict(pods=cfg.n_pods, data=cfg.data_shards, model=cfg.model_shards,
                 backend=args.backend, device=args.device,
                 ranks_per_device=args.ranks_per_device)
    if "WORLD_SIZE" in os.environ:              # a launcher started this rank
        return _train(args, mesh.init_ranks(**shape))
    import torch.multiprocessing as mp

    try:
        return mesh.spawn(_rank_main, **shape, args=(argv,))
    except mp.ProcessExitedException as exc:    # a KillSwitch (exit 17), or a crash
        raise SystemExit(exc.exit_code) from None


if __name__ == "__main__":
    main()
