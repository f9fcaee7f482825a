"""Live train→publish→serve refresh on the PyTorch port: the loop Peacock
runs in production.

    PYTHONPATH=src python examples/live_refresh_torch.py               # on the card
    PYTHONPATH=src python examples/live_refresh_torch.py --device cpu

Twin of ``examples/live_refresh.py``. The paper's industrial deployment
(§3.1–§3.3) trains continuously and feeds fresh RT-LDA models to online
serving. This example runs that loop on one host:

  1. a ``Trainer`` publishes version 0 of the model before the first epoch
     (``ModelPublisher``: gather Φ → shared dedup distance pass → merge →
     RT-LDA build → atomic versioned snapshot);
  2. a ``TopicEngine`` starts serving from snapshot v0 while a background
     ``SnapshotWatcher`` polls the snapshot directory;
  3. training continues; every publish boundary ships a new version, which
     the watcher hot-swaps into the engine — mid-traffic, zero dropped
     requests (a background client submits queries the whole time);
  4. the engine's ``stats().model_version`` shows the refresh happening.
"""
import argparse
import json
import shutil
import tempfile
import threading
import time

import numpy as np


def main(device="cuda"):
    from repro_torch import kernels, resolve_device
    from repro_torch.checkpoint import snapshots
    from repro_torch.serving import SnapshotWatcher, TopicEngine
    from repro_torch.training import Metrics, ModelPublisher, Trainer, TrainerConfig

    dev = resolve_device(device)
    kernels.reset_launch_counts()
    snap_dir = tempfile.mkdtemp(prefix="peacock_snapshots_")
    try:
        cfg = TrainerConfig(n_docs=1200, vocab_size=400, n_topics=24,
                            true_topics=16, doc_len_mean=9, n_epochs=10,
                            alpha_opt_from=4, device=dev.type)
        publisher = ModelPublisher(snap_dir, every=3)
        trainer = Trainer(cfg, callbacks=[publisher, Metrics()]).setup()

        # publish v0 before fit() so the engine can come up first, the way a
        # serving fleet outlives any one training session (ModelPublisher's
        # ``at_start=True`` does the same from inside the session)
        publisher.publish(trainer, epoch=-1)
        model0, meta0 = snapshots.load_snapshot(snap_dir, device=dev)
        print(f"[serve] booting engine from snapshot v{meta0['version']} "
              f"(K={model0.alpha.shape[0]}) on {dev}")

        rng = np.random.default_rng(7)
        queries = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
                   for n in rng.integers(2, 12, size=2000)]

        with TopicEngine(model0, buckets=(4, 8, 16), max_batch=64,
                         max_delay_ms=2.0) as engine:
            engine.swap_model(model0, version=int(meta0["version"]))
            with SnapshotWatcher(snap_dir, engine, poll_s=0.2) as watcher:
                pre = engine.infer(queries[:32])
                v_pre = engine.stats().model_version
                print(f"[serve] {len(pre)} queries answered on model v{v_pre}")

                # background client: open-loop traffic THROUGH the entire
                # training run — every future must resolve across all hot-swaps
                futures, stop = [], threading.Event()

                def client():
                    i = 32
                    while not stop.is_set():
                        futures.append(engine.submit(queries[i % len(queries)]))
                        i += 1
                        time.sleep(0.005)

                t = threading.Thread(target=client, daemon=True)
                t.start()
                try:
                    trainer.fit()    # publishes every 3rd epoch + the final model
                    assert publisher.last_version is not None
                    assert watcher.wait_for_version(publisher.last_version, timeout_s=10)
                finally:
                    stop.set()
                    t.join(timeout=30)
                assert not t.is_alive()

                post = engine.infer(queries[:32])
                s = engine.stats()
                for f in futures:
                    f.result(timeout=60)
                resolved = sum(f.done() for f in futures)
                print(f"[serve] model v{v_pre} → v{s.model_version} "
                      f"({watcher.swaps} hot-swap(s) observed)")
                print(f"[serve] {len(futures)} in-flight queries during "
                      f"training: {resolved} resolved, "
                      f"{len(futures) - resolved} dropped")
                print(f"[serve] p50 {s.p50_ms:.1f} ms  p99 {s.p99_ms:.1f} ms | "
                      f"completed {s.completed}")
                assert resolved == len(futures), "requests dropped across swaps!"
                assert s.model_version == publisher.last_version
                # fresh model, same queries: distributions come from the new Φ
                # (comparable only when dedup kept K unchanged between versions)
                diffs = [np.abs(a.pkd - b.pkd).sum() for a, b in zip(pre, post)
                         if a.pkd.shape == b.pkd.shape]
                if diffs:
                    print(f"[serve] mean L1 drift pre→post refresh: "
                          f"{float(np.mean(diffs)):.3f}")

        versions = snapshots.snapshot_versions(snap_dir)
        print(f"[done] versions on disk: {versions} (rotation keep={publisher.keep})")
    finally:
        shutil.rmtree(snap_dir, ignore_errors=True)
    launches = kernels.launch_counts()
    print(f"[launches] {json.dumps(launches)}")
    return dict(in_flight=len(futures), resolved=resolved, swaps=watcher.swaps,
                version=s.model_version, last_version=publisher.last_version,
                versions=versions, launches=launches)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
