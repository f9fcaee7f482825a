"""Serving fleet demo on the PyTorch port: 4 routed replicas, 2 hot-swaps,
zero dropped requests.

    PYTHONPATH=src python examples/fleet_demo_torch.py               # on the card
    PYTHONPATH=src python examples/fleet_demo_torch.py --device cpu

Twin of ``examples/fleet_demo.py``. Peacock's online serving (§3.2, Fig. 5A)
is a fleet of inference backends behind routing, admission control and a
hot-query cache; this example runs the fleet surface (DESIGN.md §13) end
to end on one host:

  1. a ``TopicFleet`` of 4 replicas boots from snapshot v0, with the
     segmented-LRU result cache in front (Zipf traffic: the power-law head
     hits the cache, the tail exercises routing + batching);
  2. per-replica ``SnapshotWatcher`` fan-out polls the snapshot directory;
  3. while a background client keeps open-loop traffic in flight, two new
     versions are published — v1 as a full snapshot, v2 as a *delta*
     snapshot (row-diff Φ against v1, the ``ModelPublisher(delta=True)``
     wire format) — and roll across all 4 replicas;
  4. every in-flight future resolves across both swaps (the assertion this
     demo exists for), no cached result crosses a version boundary (a
     request sent after version v reached every replica gets no cache hit
     of an older version), and the final stats show routing spread + hit
     rate.
"""
import argparse
import json
import shutil
import tempfile
import threading
import time

import numpy as np

BUCKETS = (4, 8, 16)
REPLICAS = 4


def main(device="cuda"):
    from repro_torch import kernels, resolve_device
    from repro_torch.checkpoint import snapshots
    from repro_torch.core import rtlda
    from repro_torch.launch.serve import build_model, make_zipf_traffic, warm_shape_grid
    from repro_torch.serving import TopicFleet

    dev = resolve_device(device)
    kernels.reset_launch_counts()
    snap_dir = tempfile.mkdtemp(prefix="peacock_fleet_snapshots_")
    try:
        model0, state = build_model(topics=12, vocab=200, train_iters=10, device=dev)
        snapshots.save_snapshot(snap_dir, 0, model0, {"note": "fleet demo v0"})

        # two refreshed models to roll out mid-traffic: v1 ships full (new Φ
        # counts are dense in the column-normalized P̂(v|k)), v2 is an α-only
        # re-optimization — P̂(v|k) is unchanged, so the row-diff delta ships
        # ZERO Φ rows (the format's best case, and a real publish pattern)
        model1 = rtlda.build_model(state.phi + 1, state.beta, state.alpha, device=dev)
        model2 = rtlda.build_model(state.phi + 1, state.beta, state.alpha * 1.25,
                                   device=dev)

        boot, meta0 = snapshots.load_snapshot(snap_dir, device=dev)
        print(f"[fleet] booting {REPLICAS} replicas from snapshot "
              f"v{meta0['version']} (K={boot.alpha.shape[0]}) on {dev}")

        traffic = make_zipf_traffic(4000, pool=256, vocab=200, buckets=BUCKETS, seed=7)

        with TopicFleet(boot, n_replicas=REPLICAS, buckets=BUCKETS, max_batch=32,
                        max_delay_ms=2.0, cache_mb=4.0, shed=False) as fleet:
            fleet.swap_model(boot, version=int(meta0["version"]))
            fleet.attach_watchers(snap_dir, poll_s=0.1)
            warm_shape_grid(fleet, BUCKETS, 32, 200)
            v_pre = fleet.stats().model_version
            print(f"[fleet] warm on model v{v_pre}, traffic flowing")

            # background client: open-loop Zipf traffic THROUGH both rollouts —
            # every future must resolve across every per-replica hot-swap
            futures, stop = [], threading.Event()
            rolled = {}              # version → requests sent before it was everywhere

            def client():
                i = 64
                while not stop.is_set():
                    futures.append(fleet.submit(traffic[i % len(traffic)]))
                    i += 1
                    time.sleep(0.002)

            t = threading.Thread(target=client, daemon=True)
            t.start()
            try:
                time.sleep(0.3)
                snapshots.save_snapshot(snap_dir, 1, model1, {"note": "refresh"})
                assert fleet.wait_for_version(1, timeout_s=10)
                rolled[1] = len(futures)
                print("[fleet] hot-swap #1: v0 → v1 rolled across all "
                      f"{REPLICAS} replicas (full snapshot)")
                time.sleep(0.6)          # let v1 actually serve before the next roll

                snapshots.save_delta_snapshot(snap_dir, 2, model2, base_version=1,
                                              base_pvk=model1.pvk,
                                              meta={"note": "delta refresh"})
                d = snapshots.read_meta(snap_dir, 2)["delta"]
                assert fleet.wait_for_version(2, timeout_s=10)
                rolled[2] = len(futures)
                print(f"[fleet] hot-swap #2: v1 → v2 rolled as a delta "
                      f"({d['n_rows']}/{d['n_rows_total']} Φ rows shipped)")
                time.sleep(0.3)
            finally:
                stop.set()
                t.join(timeout=30)
            assert not t.is_alive()
            fleet.flush_all()
            results = [f.result(timeout=30) for f in futures]

            s = fleet.stats()
            shed = sum(getattr(r, "shed", False) for r in results)
            versions = sorted({r.model_version for r in results
                               if not getattr(r, "shed", False)})
            print(f"[fleet] {len(futures)} in-flight requests across 2 "
                  f"hot-swaps: {len(results)} resolved, 0 dropped, {shed} shed")
            print(f"[fleet] responses carried model versions {versions} "
                  f"(monotonic rollout, live v{s.model_version})")
            print(f"[fleet] routed per replica: {list(s.routed)} | cache hit "
                  f"rate {s.hit_rate:.1%} | p50 {s.p50_ms:.1f} ms "
                  f"p99 {s.p99_ms:.1f} ms")
            assert len(results) == len(futures), "requests dropped across swaps!"
            assert s.model_version == 2
            assert sum(s.routed) > 0 and s.hit_rate > 0.0
            # no cached result across a version: a request sent after version
            # v reached every replica is answered from the cache only under v
            # or later
            hits = [(i, r) for i, r in enumerate(results) if getattr(r, "cached", False)]
            for i, r in hits:
                for v, sent_before in rolled.items():
                    if i >= sent_before:
                        assert r.model_version >= v, (i, r.model_version, v)
            print(f"[fleet] {len(hits)} cache hits, none of a version older than the "
                  "one every replica served when its request was sent")

        print(f"[done] versions on disk: {snapshots.snapshot_versions(snap_dir)}")
    finally:
        shutil.rmtree(snap_dir, ignore_errors=True)
    launches = kernels.launch_counts()
    print(f"[launches] {json.dumps(launches)}")
    return dict(in_flight=len(futures), resolved=len(results), versions=versions,
                version=s.model_version, hits=len(hits),
                routed=list(s.routed), launches=launches)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
