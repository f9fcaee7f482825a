"""Open-loop serving load generator of the port (twin of ``repro.launch.serve``):
tail latency vs offered load (§3.2, Fig. 5A).

    PYTHONPATH=src python -m repro_torch.launch.serve --qps 500 --duration 3 \
        --bench-out BENCH_serve.json [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --replicas 4 \
        --cache-mb 64 --shed --zipf-pool 512 --bench-out BENCH_fleet.json

Trains a quick model (``repro_torch.data.fixtures.quick_train``: the dense
Gibbs sampler, so ``gibbs_argmax`` on the card), stands up a
:class:`TopicEngine` — or, with ``--replicas``/``--cache-mb``/``--shed``, a
:class:`TopicFleet` front over N replicas that share one model — then replays
a **Poisson arrival process** against it at the offered ``--qps``. Open loop
means arrivals do not wait for completions: a closed loop caps the offered
load at the system's own speed and hides queueing collapse.

``--zipf-pool N`` switches traffic to a Zipf(1.0) mix over a pool of N
distinct queries (the head the fleet's result cache exists for); the default
mixed-length traffic is all-distinct. Mid-run the model is hot-swapped
(``--swap-mid``, on by default) to the one built from Φ + 1.

The same flags as ``repro.launch.serve``, plus ``--device`` (``cuda`` by default;
``cpu`` on request; a missing card raises). ``--preflight`` runs the serving
gate (the ``concurrency`` and ``lint`` passes of ``repro_torch.analysis``,
and the check that the fleet's thread classes are in the analyzer's
inventory) and exits 0 or 1 before anything is built.

``--bench-out`` writes ``repro.launch.serve``'s record plus the device, the card's
name and power limit (``nvidia-smi``), the peak device memory and what the
served responses were checked for (row sums, id range, versions after the
swap).
"""
import argparse
import collections
import json
import subprocess
import time


def build_model(topics: int, vocab: int, train_iters: int = 25, device="cuda"):
    """Quick synthetic train → RT-LDA serving model (R cache, Eq. 3), on
    ``device``. Returns ``(model, state)``."""
    from repro_torch.core import rtlda
    from repro_torch.data.fixtures import quick_train

    _, state = quick_train(topics, vocab, train_iters, device=device)
    return rtlda.build_model(state.phi, state.beta, state.alpha,
                             device=device), state


def make_traffic(n: int, vocab: int, buckets, seed: int = 1):
    """Mixed-length queries spanning every shape bucket (plus over-long
    tails that must route to the widest bucket with ``truncated`` set)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    max_b = max(buckets)
    lengths = rng.choice(
        [2, 4, max(1, min(buckets) - 1)] + [b - 1 for b in buckets]
        + [max_b + 4],
        size=n, p=None)
    return [rng.integers(0, vocab, size=int(L)).astype(np.int32)
            for L in lengths]


def make_zipf_traffic(n: int, pool: int, vocab: int, buckets, seed: int = 1,
                      s: float = 1.0):
    """Zipf(s) traffic over a pool of ``pool`` distinct queries: rank-r
    probability ∝ 1/r^s. The power-law head repeats constantly (cacheable),
    the tail is near-unique — the §3.2 serving mix."""
    import numpy as np

    rng = np.random.default_rng(seed)
    max_b = max(buckets)
    queries = [rng.integers(0, vocab,
                            size=int(rng.integers(2, max_b + 1))
                            ).astype(np.int32)
               for _ in range(pool)]
    weights = 1.0 / np.arange(1, pool + 1, dtype=np.float64) ** s
    weights /= weights.sum()
    idx = rng.choice(pool, size=n, p=weights)
    return [queries[i] for i in idx]


def warm_shape_grid(target, buckets, batch: int, vocab: int):
    """Run every (row-bucket, length-bucket) shape once, so the run measures
    serving and not first-call costs (allocator growth, library handles).
    Rows are DISTINCT random queries — identical payloads would short-circuit
    into a fleet's result cache and leave the engine shapes cold."""
    import numpy as np

    rng = np.random.default_rng(0)
    for b in buckets:
        rows = 1
        while rows < batch:
            target.infer([rng.integers(0, vocab, size=b).astype(np.int32)
                          for _ in range(rows)])
            rows *= 2
        # full batches run at rows=batch even when it isn't a power of two
        target.infer([rng.integers(0, vocab, size=b).astype(np.int32)
                      for _ in range(batch)])
    target.reset_stats()


def card_line(dev) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    import torch

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=60,
            check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--qps", type=float, default=500.0,
                    help="offered load (Poisson arrival rate)")
    ap.add_argument("--duration", type=float, default=3.0,
                    help="seconds of open-loop traffic")
    ap.add_argument("--deadline-ms", type=float, default=50.0)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--buckets", type=str, default="8,16,32,64")
    ap.add_argument("--topics", type=int, default=32)
    ap.add_argument("--vocab", type=int, default=600)
    ap.add_argument("--n-trials", type=int, default=2)
    ap.add_argument("--train-iters", type=int, default=25)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through a TopicFleet of N engine replicas "
                         "(DESIGN.md §13) instead of one bare engine")
    ap.add_argument("--cache-mb", type=float, default=0.0,
                    help="fleet hot-query result cache budget (0 = off; "
                         "implies fleet mode)")
    ap.add_argument("--shed", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="fleet admission control: reject-fast with a typed "
                         "ShedResponse when p99 slack goes negative")
    ap.add_argument("--zipf-pool", type=int, default=0,
                    help="draw traffic Zipf(1.0) from a pool of N distinct "
                         "queries (0 = all-distinct mixed-length traffic)")
    ap.add_argument("--swap-mid", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="hot-swap the model halfway through the run")
    ap.add_argument("--bench-out", type=str, default=None,
                    help="write a machine-readable JSON record here")
    ap.add_argument("--preflight", action="store_true",
                    help="run the serving-side static contract checks "
                         "(repro_torch.analysis: concurrency thread contracts + "
                         "repo lint) and exit before building any engine: pure "
                         "AST, no model trained, no thread started; exit 0 iff "
                         "every check passes")
    ap.add_argument("--preflight-json", action="store_true",
                    help="with --preflight: machine-readable report")
    ap.add_argument("--device", default="cuda",
                    help="where the model and the engines live: cuda "
                         "(default) or cpu")
    return ap


# the thread-bearing serving classes the gate must find in the analyzer's
# inventory (discovery skipping one would certify a contract it never read)
SERVING_CLASSES = ("TopicFleet", "ResultCache", "TopicEngine", "SnapshotWatcher",
                   "CircuitBreaker", "FaultPlane")


def preflight_gate(as_json: bool = False) -> int:
    """The static serving gate: the concurrency and lint passes over the
    port, and every class of ``SERVING_CLASSES`` in the concurrency
    inventory. Prints the report; returns the exit code (0 iff it holds)."""
    from repro_torch.analysis import preflight as pf

    report = pf.run_preflight(pf.SessionSpec(), passes=("concurrency", "lint"))
    inventory = next((f for r in report.results for f in r.findings
                      if f.check == "concurrency.inventory"), None)
    missing = [c for c in SERVING_CLASSES if inventory is None or c not in inventory.message]
    print(report.to_json(indent=2) if as_json else report.render())
    if missing:
        print("[preflight] serving classes missing from the concurrency inventory: "
              + ", ".join(missing))
    return 0 if report.ok and not missing else 1


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.preflight:
        raise SystemExit(preflight_gate(args.preflight_json))

    import numpy as np
    import torch

    from repro_torch import resolve_device
    from repro_torch.core import rtlda
    from repro_torch.serving import ShedResponse, TopicEngine, TopicFleet

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    model, state = build_model(args.topics, args.vocab, args.train_iters,
                               device=dev)
    phi, beta, alpha = state.phi, state.beta, state.alpha
    del state
    # the mid-run swap target: same shapes, rebuilt Φ (a later aggregate).
    # Φ + 1 in place, so no second [V, K] Φ exists beside it (13.1 GB at
    # K = 10⁵, V = 32,768), and Φ goes as soon as the model is built
    phi += 1
    model_b = rtlda.build_model(phi, beta, alpha, device=dev)
    del phi

    fleet_mode = (args.replicas > 1 or args.cache_mb > 0 or args.shed)
    if fleet_mode:
        target = TopicFleet(model, n_replicas=max(1, args.replicas),
                            buckets=buckets, max_batch=args.batch,
                            n_trials=args.n_trials,
                            max_delay_ms=args.max_delay_ms,
                            cache_mb=args.cache_mb, shed=args.shed,
                            deadline_budget_ms=args.deadline_ms)
    else:
        target = TopicEngine(model, buckets=buckets, max_batch=args.batch,
                             n_trials=args.n_trials,
                             max_delay_ms=args.max_delay_ms)

    warm_shape_grid(target, buckets, args.batch, args.vocab)
    if fleet_mode and target.cache is not None:
        target.cache.clear()     # warmup queries must not seed the run

    n = max(1, int(args.qps * args.duration))
    if args.zipf_pool > 0:
        traffic = make_zipf_traffic(n, args.zipf_pool, args.vocab, buckets)
    else:
        traffic = make_traffic(n, args.vocab, buckets)
    rng = np.random.default_rng(7)
    gaps = rng.exponential(1.0 / args.qps, size=n)
    arrivals = np.cumsum(gaps)

    futs = []
    swapped_at = None
    first_after_swap = None      # index into futs of the first post-swap one
    n_backed_off = 0
    backoff_until = 0.0
    t0 = time.monotonic()
    for i, (req, at) in enumerate(zip(traffic, arrivals)):
        lag = t0 + at - time.monotonic()
        if lag > 0:
            time.sleep(lag)          # open loop: schedule is the clock's, not ours
        if args.swap_mid and swapped_at is None and i >= n // 2:
            target.swap_model(model_b, version=1)
            swapped_at = i
            first_after_swap = len(futs)
        if time.monotonic() < backoff_until:
            # a well-behaved client honors ShedResponse.retry_after_ms:
            # arrivals inside the back-off window are dropped client-side
            # instead of re-offered into guaranteed rejects
            n_backed_off += 1
            continue
        fut = target.submit(req, deadline_ms=args.deadline_ms)
        futs.append(fut)
        if fut.done():
            r = fut.result()
            if isinstance(r, ShedResponse) and r.retry_after_ms > 0:
                backoff_until = max(
                    backoff_until,
                    time.monotonic() + r.retry_after_ms / 1e3)
    results = [f.result(timeout=60) for f in futs]
    wall = time.monotonic() - t0
    target.close()

    responses = [r for r in results if not isinstance(r, ShedResponse)]
    n_shed = len(results) - len(responses)
    lat = np.array([r.latency_ms for r in responses])
    if not all(np.isfinite(r.pkd).all() for r in responses):
        raise RuntimeError("a served pkd row has non-finite values")
    after = [r for r in results[first_after_swap or len(results):]
             if not isinstance(r, ShedResponse)]
    n_trunc = sum(r.truncated for r in responses)
    n_missed = sum(r.deadline_missed for r in responses)
    record = {
        "bench": "fleet_open_loop" if fleet_mode else "serve_open_loop",
        "offered_qps": args.qps,
        "achieved_qps": len(responses) / wall,
        "duration_s": wall,
        "n_requests": len(results),
        "p50_ms": float(np.quantile(lat, 0.5)) if len(lat) else 0.0,
        "p99_ms": float(np.quantile(lat, 0.99)) if len(lat) else 0.0,
        "mean_ms": float(lat.mean()) if len(lat) else 0.0,
        "max_ms": float(lat.max()) if len(lat) else 0.0,
        "deadline_ms": args.deadline_ms,
        "buckets": list(buckets),
        "truncated": n_trunc,
        "swap_mid": swapped_at is not None,
        "n_trials": args.n_trials,
        "topics": args.topics,
        "zipf_pool": args.zipf_pool,
        "backed_off": n_backed_off,
        # the port's additions: where it ran, and what was checked
        "device": str(dev),
        "card": card_line(dev) if dev.type == "cuda" else None,
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                     if dev.type == "cuda" else None),
        "vocab": args.vocab,
        "pkd_sum_err_max": max((abs(float(r.pkd.sum(dtype=np.float64)) - 1.0)
                                for r in responses), default=0.0),
        "ids_in_range": all(bool(((r.feature_ids >= 0)
                                  & (r.feature_ids < args.vocab)).all())
                            for r in responses),
        "versions_after_swap": dict(collections.Counter(
            str(r.model_version) for r in after)),
    }
    if fleet_mode:
        fstats = target.stats()
        occ = [s.mean_batch_occupancy for s in fstats.per_replica]
        record.update({
            "replicas": len(target.engines),
            "cache_mb": args.cache_mb,
            "cache_hit_rate": fstats.hit_rate,
            "shed_enabled": args.shed,
            "shed": n_shed,
            "shed_rate": fstats.shed_rate,
            "routed": list(fstats.routed),
            "deadline_miss_rate": (n_missed / len(responses)
                                   if responses else 0.0),
            "mean_batch_occupancy": float(np.mean(occ)) if occ else 0.0,
            "per_bucket": {},
            "probes": fstats.probes,
            "hedges": fstats.hedges,
            "retries": fstats.retries,
            "failed": fstats.failed,
            "breakers": [b["state"] for b in fstats.breakers],
            "breaker_trips": [b["trips"] for b in fstats.breakers],
        })
        print(f"offered {args.qps:,.0f} QPS → achieved "
              f"{record['achieved_qps']:,.0f} QPS over {wall:.1f}s | "
              f"{record['replicas']} replicas routed {record['routed']} | "
              f"p50 {record['p50_ms']:.1f} ms  p99 {record['p99_ms']:.1f} ms"
              f" | miss {record['deadline_miss_rate']:.1%} @ "
              f"{args.deadline_ms:.0f} ms | cache hit "
              f"{record['cache_hit_rate']:.1%} | shed {n_shed}"
              + (f" | hot-swap at req {swapped_at}"
                 if swapped_at is not None else ""))
    else:
        stats = target.stats()
        record.update({
            "deadline_miss_rate": stats.deadline_miss_rate,
            "mean_batch_occupancy": stats.mean_batch_occupancy,
            "per_bucket": {str(k): v for k, v in stats.per_bucket.items()},
        })
        print(f"offered {args.qps:,.0f} QPS → achieved "
              f"{record['achieved_qps']:,.0f} QPS over {wall:.1f}s | "
              f"p50 {record['p50_ms']:.1f} ms  p99 {record['p99_ms']:.1f} ms"
              f" | miss rate {stats.deadline_miss_rate:.1%} @ "
              f"{args.deadline_ms:.0f} ms | occupancy "
              f"{stats.mean_batch_occupancy:.2f} | buckets "
              f"{record['per_bucket']}"
              + (f" | hot-swap at req {swapped_at}"
                 if swapped_at is not None else ""))
    if args.bench_out:
        with open(args.bench_out, "w") as f:
            json.dump(record, f, indent=2)
        print(f"[bench] wrote {args.bench_out}")
    return record


if __name__ == "__main__":
    main()
