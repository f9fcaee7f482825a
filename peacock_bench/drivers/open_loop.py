"""Serving traffic: an open loop of arrivals at a fixed rate into the port's
``TopicEngine`` or ``TopicFleet``.

Set-up makes the model from the seed (Φ counted on the card from the
generator's topics, then ``rtlda.build_model``), builds the front, runs every
(rows, bucket) shape of the engine once on each replica, and for a fleet
serves the Zipf pool once, tail first, so its cache starts the window as it
would run. The window offers round(rate · seconds) requests at uniform
random times (a Poisson process conditioned on its count). Each request is
timed from the time it was due, not from its submit, to its future
resolving; the generator's lateness (submit − due) is kept beside it.

Set-up also wraps, on each engine, the inference call (``_infer``: the
batch's padded queries and seed, and the call's host times), and in a traced
run ``submit`` (the time each engine-level future resolves). The first gives
the reference the seed and the place each request was served at, which the
hill climb's restarts draw from; both give ``serve_batch_ms``. An untraced
run leaves ``submit`` as it is, so that the harness adds no object a request
to the process's collector beyond its own callback.
"""
from __future__ import annotations

import functools
import gc
import threading
import time

import numpy as np


def _warm(eng, buckets, max_batch: int, vocab: int, rng) -> None:
    """Every (rows, bucket) shape the engine can run, once, with distinct
    queries (``launch/serve.py:warm_shape_grid``)."""
    for b in buckets:
        rows = 1
        while True:
            eng.infer([rng.integers(0, vocab, size=b).astype(np.int32) for _ in range(rows)])
            if rows >= max_batch:
                break
            rows = min(rows * 2, max_batch)


def run(ctx) -> dict:
    import torch

    from repro_torch.core import rtlda
    from repro_torch.serving import Response, TopicEngine, TopicFleet

    import gen
    import stats
    from reference import rtlda as ref

    cfg, s, p = ctx.config, ctx.config["serve"], ctx.params
    K, V = cfg["n_topics"], cfg["vocab_size"]
    dev = torch.device(ctx.device)
    spans, trace = ctx.spans, ctx.trace
    rate = ctx.rate or p["rate"]
    perf = time.perf_counter
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    phi, topic_words, topic_weights = gen.serving_counts(ctx.seed, K, V, s["tokens_per_topic"],
                                                         dev)
    beta = cfg["beta"]
    alpha = torch.full((K,), cfg["alpha0"] / K, dtype=torch.float32, device=dev)
    model = rtlda.build_model(phi, torch.tensor(beta, dtype=torch.float32), alpha, device=dev)
    kw = dict(buckets=tuple(s["buckets"]), max_batch=s["max_batch"], n_iters=s["n_iters"],
              n_trials=s["n_trials"], top_n=s["top_n"])
    fleet = p["front"] == "fleet"
    if fleet:
        front = TopicFleet(model, n_replicas=p["replicas"], cache_mb=p["cache_mb"], shed=False,
                           deadline_budget_ms=s["deadline_ms"], **kw)
        engines = front.engines
    else:
        front = TopicEngine(model, **kw)
        engines = (front,)

    batches = []                        # (engine, t_call, t_return, seed, padded queries)
    resolved = [[] for _ in engines]   # per engine: (query bytes, resolve time)

    def wrap(i, eng):
        real_infer, real_submit = eng._infer, eng.submit

        def infer(m, q, seed):
            t = perf()
            out = real_infer(m, q, seed)
            t2 = perf()
            batches.append((i, t, t2, int(seed), q.copy()))
            spans.add("inference_call", t, t2)
            return out

        def submit(tokens, deadline_ms=None):
            fut = real_submit(tokens, deadline_ms)
            key = np.asarray(tokens, np.int32).tobytes()
            fut.add_done_callback(lambda f: resolved[i].append((key, perf())))
            return fut
        eng._infer = infer
        if trace.on:
            eng.submit = submit

    for i, eng in enumerate(engines):
        wrap(i, eng)
    if ctx.mode.startswith("fault:"):
        import faults
        for eng in engines:
            faults.plant(ctx.mode[6:], eng)
    warm_rng = np.random.default_rng([ctx.seed, 9])
    for eng in engines:
        _warm(eng, kw["buckets"], kw["max_batch"], V, warm_rng)
    n = int(round(rate * ctx.seconds))
    due = gen.arrivals([ctx.seed, 2], rate, ctx.seconds)
    q_kw = dict(vocab=V, mean_len=cfg["tokens_per_doc"], long_share=s["long_share"],
                concentration=s["query_concentration"])
    if fleet:
        pool = gen.queries([ctx.seed, 3], p["zipf_pool"], topic_words, topic_weights, **q_kw)
        qs = [pool[j] for j in gen.zipf_picks([ctx.seed, 4], n, p["zipf_pool"])]
        front.cache.clear()
        front.infer(pool[::-1])
        front.reset_stats()
    else:
        qs = gen.queries([ctx.seed, 3], n, topic_words, topic_weights, **q_kw)
        front.reset_stats()
    trace.prepare()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    # the reference judges a sample drawn from the seed, with the longest
    # queries in it; only the sampled responses are kept, so the harness
    # holds no long-lived object a request: a client in its own process
    # would not, and each would add to the work of the collector
    rng = np.random.default_rng([ctx.seed, 5])
    longest = np.argsort([-len(q) for q in qs], kind="stable")[:p["sample_longest"]]
    pick = sorted(set(longest.tolist()) | set(rng.choice(n, min(p["sample"], n),
                                                        replace=False).tolist()))
    picked = set(pick)
    # status: 0 never resolved, 1 served, 2 refused (a ShedResponse: every
    # replica's breaker open), 3 an error in place of an answer
    kept, status = {}, np.zeros(n, np.int8)
    cached = np.zeros(n, bool)
    sub, done = np.zeros(n), np.full(n, np.nan)
    left, all_done = [n], threading.Event()
    lock = threading.Lock()

    def resolved_cb(f, i):
        done[i] = perf()
        r = None if f.cancelled() or f.exception() is not None else f.result()
        ok = isinstance(r, Response)
        status[i] = 1 if ok else (3 if r is None else 2)
        cached[i] = ok and r.cached
        if ok and i in picked:
            kept[i] = r
        with lock:
            left[0] -= 1
            if left[0] == 0:
                all_done.set()

    pauses = []                         # (generation, start, end) of each collection
    gc_t = {}

    def on_gc(phase, info):
        if phase == "start":
            gc_t["t"] = perf()
        else:
            pauses.append((info["generation"], gc_t.get("t", perf()), perf()))
    gc.callbacks.append(on_gc)

    # ---- the window ---------------------------------------------------------
    trace.start()
    t0 = perf()
    for i in range(n):
        now = perf()
        if t0 + due[i] > now:
            time.sleep(t0 + due[i] - now)
            spans.add("generator", now, perf())
        sub[i] = perf()
        f = front.submit(qs[i], deadline_ms=s["deadline_ms"])
        spans.add("submit", sub[i], perf())
        f.add_done_callback(functools.partial(resolved_cb, i=i))
        del f
    t_close = t0 + ctx.seconds
    all_done.wait(timeout=max(1.0, t_close + 60.0 - perf()))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_end = max(t_close, float(np.nanmax(done)) if np.isfinite(done).any() else t_close)
    trace.stop()
    gc.callbacks.remove(on_gc)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    fleet_stats = front.stats() if fleet else None
    front.close()

    served = np.nonzero(status == 1)[0]
    failed = n - len(served)
    # a refused request counts as missing every latency limit: it enters
    # the percentiles at the longest a request is waited for
    lat = np.where(status == 1, (done - t0 - due) * 1e3, (ctx.seconds + 60.0) * 1e3)
    lag = (sub - t0 - due) * 1e3
    e2e = {"serve_p99_ms": stats.percentile(lat, 99), "serve_p50_ms": stats.percentile(lat, 50),
           "serve_qps": float(np.sum((done[served] >= t0) & (done[served] <= t_close)))
           / ctx.seconds,
           "setup_s": t0 - ctx.t_start}

    # ---- the record the per-layer metrics read -------------------------------
    in_window = [b for b in batches if t0 <= b[1] <= t_end]
    batch_ms, batch_rows, batch_flops = [], [], []
    at = [{} for _ in engines]
    for e, pairs in enumerate(resolved):
        for key, t in pairs:
            at[e].setdefault(key, []).append(t)
    for e, t_call, t_ret, _, q in in_window:
        real = q[(q >= 0).any(axis=1)]
        ends = []
        for row in real:
            key = row[row >= 0].astype(np.int32).tobytes()
            after = [t for t in at[e].get(key, []) if t >= t_call]
            if after:
                ends.append(min(after))
        if ends:
            spans.add("result_wait", t_ret, max(ends))
            batch_ms.append((max(ends) - t_call) * 1e3)
            batch_rows.append(len(real))
            batch_flops.append((len(real), q.shape[1]))
    record = {"cell": ctx.cell, "K": K, "V": V, "rate": rate, "requests": n,
              "batch_ms": batch_ms, "batch_rows": batch_rows, "batch_shapes": batch_flops,
              "n_trials": s["n_trials"], "n_iters": s["n_iters"],
              "gen_lag_ms": lag.tolist(), "latency_ms": lat[served].tolist(),
              "gc_pause_ms": [((b - a) * 1e3, g) for g, a, b in pauses if t0 <= a <= t_end],
              "cache_hits": int(cached[served].sum()), "cache_lookups": len(served) if fleet else 0,
              "fleet_stats": (fleet_stats.cache_hits, fleet_stats.cache_misses)
              if fleet else None,
              "trace": trace.reduce(t0, t_end, spans, ("inference_call", "result_wait",
                                                       "submit", "generator"))}

    # ---- the comparison --------------------------------------------------------
    control = ctx.mode == "control"
    low = torch.bfloat16
    pvk_prog, rt_prog, rv_prog = model.pvk, model.r_topic, model.r_value
    del model, front, engines
    pvk_ref = ref.phi_hat(phi, beta)
    rt_ref, rv_ref = ref.r_cache_blocks(pvk_ref, alpha)
    # a refusal is an answer the front gave; a request with no answer, or an
    # error in place of one, is for correct
    checks = {"unanswered": float(np.sum((status == 0) | (status == 3)))}
    pvk_c = ref.phi_hat(phi, beta, dtype=low) if control else None
    if control:
        rt_c, rv_c = ref.r_cache_blocks(pvk_c, alpha)
        checks["pvk_rel_err"] = ref.pvk_error(pvk_c, phi, beta)
        checks["r_cache_gap"] = ref.r_cache_gap(pvk_ref, alpha, rt_c, rv_c.float())
    else:
        checks["pvk_rel_err"] = ref.pvk_error(pvk_prog, phi, beta)
        checks["r_cache_gap"] = ref.r_cache_gap(pvk_ref, alpha, rt_prog, rv_prog)
    pick = [i for i in pick if i in kept]
    want = {qs[i].tobytes() for i in pick}
    where = {}                  # query bytes -> [(seed, row, padded query)]
    for _, _, _, seed, q in batches:
        for r, row in enumerate(q):
            key = row[row >= 0].astype(np.int32).tobytes()
            if key in want:
                where.setdefault(key, []).append((seed, r, row))
    # each distinct (batch seed, row, padded query) the judged requests were
    # served at, worked out once, a chunk of rows at a time
    uniq, links = {}, []
    for i in pick:
        links.append([uniq.setdefault((c[0], c[1], c[2].tobytes()), (len(uniq), c))[0]
                      for c in where.get(qs[i].tobytes(), [])])
    out_ref, out_c = {}, {}
    by_len = {}
    for cid, c in uniq.values():
        by_len.setdefault(len(c[2]), []).append((cid, c))
    for group in by_len.values():
        for lo in range(0, len(group), 128):
            part = group[lo:lo + 128]
            wt = torch.from_numpy(np.stack([c[2] for _, c in part])).to(dev)
            row = torch.tensor([c[1] for _, c in part], device=dev)
            sd = torch.tensor([c[0] for _, c in part], device=dev)
            args = (wt, row, sd, s["n_iters"], s["n_trials"])
            out = ref.infer(pvk_ref, alpha, rt_ref, rv_ref, *args)
            outc = ref.infer(pvk_c, alpha, rt_c, rv_c, *args) if control else None
            for g, (cid, _) in enumerate(part):
                out_ref[cid] = out[g]
                if control:
                    out_c[cid] = outc[g]
    pkd_ref = {j: [(out_ref[cid], out_c.get(cid)) for cid in cids]
               for j, cids in enumerate(links)}
    # got_pkd[j]: the served P(k|d); own_pkd[j]: the reference's own, where
    # the served one departs from it by no topic's flip
    got_pkd, own_pkd, ids, wts, flipped = [], [], [], [], []
    for j, i in enumerate(pick):
        refs = pkd_ref.get(j, [])
        if control:
            pk = refs[0][1][None, :] if refs else None
        else:
            resp = kept[i]
            pk = torch.from_numpy(np.array(resp.pkd, np.float32))[None, :].to(dev)
            ids.append(resp.feature_ids)
            wts.append(resp.feature_weights)
        if pk is None:
            flipped.append(True)
            continue
        ntok = torch.tensor([float(len(qs[i]))], device=dev)
        flip = [bool(ref.flips(pk, r[0][None, :], ntok, cfg["alpha0"])[0]) for r in refs]
        flipped.append(all(flip) if refs else True)
        got_pkd.append(pk[0].float())
        own_pkd.append(next((r[0] for r, f in zip(refs, flip) if not f), None))
    checks["pkd_flip_share"] = float(np.mean(flipped)) if flipped else 1.0
    pk = torch.stack(got_pkd)
    if control:
        _, ids_t, w_t = ref.features(pvk_c, pk.to(low), s["top_n"])
    else:
        ids_t = torch.from_numpy(np.stack(ids)).to(dev)
        w_t = torch.from_numpy(np.stack(wts)).to(dev)
    # Eq. 5 in float64 on the served P(k|d), and on the reference's own
    # P(k|d) of the rows that did not flip, in one pass over P̂
    own = [j for j, o in enumerate(own_pkd) if o is not None]
    pvd_ref = ref.features_exact(phi, beta, torch.cat(
        [pk] + ([torch.stack([own_pkd[j] for j in own]).float()] if own else [])))
    n_got, top_n, w_t = pk.shape[0], s["top_n"], w_t.float()
    checks["eq5_rel_gap"] = float(ref.feature_gaps(pvd_ref[:n_got], ids_t, w_t, top_n).max())
    checks["eq5_ref_gap"] = (float(ref.feature_gaps(pvd_ref[n_got:], ids_t[own], w_t[own],
                                                    top_n).max()) if own else 1.0)
    limits = ctx.workload["limits"]
    return {"attempted": n, "failed": failed, "e2e": e2e, "record": record,
            "memory_peak_bytes": peak, "notes": {"fleet_stats": record["fleet_stats"]},
            "checks": {k: (v, limits[k]) for k, v in checks.items()}}
