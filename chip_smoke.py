#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (Hopper, sm_90a) and ``nvcc``. It builds every kernel of
the port from ``src/repro_torch/csrc`` (one ``nvcc`` per source, all started
together), holds each against its plain PyTorch version on the card, then
drives the port's two paths at the full width of peacock-lda — K = 100,000
topics, V = 32,768 words (cut from 210,000 so that Φ and P̂ fit one 80 GB
card whole):

- the dense path: a 4,096-query segment shard through train (3 Gibbs
  epochs) → α re-estimation → RT-LDA export → 4 served batches of 1,024;
- the alias-MH path: that shard tiled 40× (163,840 docs, ~747,000 tokens)
  laid out as a ring of one device, 6 epochs with the stale alias tables
  rebuilt at epochs 0 and 3, α re-estimation from the sparse pairs, the α
  table refreshed, RT-LDA export and 2 served batches of 1,024.

Small phases at quickstart scale run the O(K²V) de-duplication and hold the
card's whole dense loop and alias loop against the same loops on the CPU.

Then the recsys serving path at full width: dlrm-mlperf (the 187,767,552 ×
128 bf16 embedding table of the MLPerf Criteo-1TB config, nothing cut) with
the ``embedding_bag`` kernel checked at the bulk batch's gather, 200 timed
serve_p99 batches of 512 (p50/p99), 3 serve_bulk batches of 262,144
(samples/s), xdeepfm, din and autoint one serve_p99 batch each, and
retrieval_scores over 10⁶ candidates; a small loop holds the four small
recsys configs on the card against the CPU.

Prints a ``kernels`` JSON line, the card's name and power limit, and as its
last line ``{"ok": true, "device": {...}}``. Exits nonzero on any failure,
and when there is no CUDA card.
"""
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and f32 outside
# the tensor cores. A card below its 700 W limit runs slower than these.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations of gibbs_argmax per (token, topic) element, each logf counted as
# one: 3 adds for the log arguments, 5 logf, 2 to combine the three terms,
# 6 for the uniform and Gumbel transform, τ·g and its add, 1 compare (18
# float), and 12 integer ops of the murmur3 hash.
GIBBS_OPS_PER_ELEMENT = 30

# Operations of one Walker-sweep step (compares, selects, the two float
# subtractions, cursor increments), per (row, slot).
SWEEP_OPS_PER_SLOT = 20

FULL = dict(n_topics=100_000, vocab=32_768, n_docs=4096, gen_topics=1024,
            block=8192, epochs=3, batches=4, batch=1024, bucket=8)
SMALL = dict(n_topics=16, vocab=400, n_docs=1500, gen_topics=12, epochs=25)
# the alias-MH cell: FULL's shard tiled into fresh docs, one package per epoch
ALIAS = dict(tiles=40, epochs=6, agg_every=3, n_mh=4, batches=2, batch=1024, bucket=8)
ALIAS_SMALL = dict(epochs=6, agg_every=3, n_mh=4)
# the recsys serving cells: batch shapes of repro/configs/base.py RECSYS_SHAPES
RECSYS = dict(seed=0, p99_batch=512, p99_warmup=20, p99_batches=200, bulk_batch=262_144,
              bulk_batches=3, n_candidates=1_000_000)


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def timed_ms(fn, reps, warmup=2):
    """Median device time of ``fn()`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ---------------------------------------------------------------- kernel phase
def gibbs_inputs(T, K, psi_row, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=g, device="cuda",
                                              dtype=torch.float32)
    phi, theta = rnd(0, 50, (T, K)), rnd(0, 10, (T, K))
    psi = rnd(1, 500, (K,) if psi_row else (T, K))
    alpha = torch.rand(K, generator=g, device="cuda") * 0.99 + 0.01
    uid = torch.arange(T, dtype=torch.int64, device="cuda") + 31
    return phi, psi, theta, alpha, torch.tensor(0.01, device="cuda"), uid


def kernel_phase():
    from repro_torch.kernels.gibbs import ops
    from repro_torch.kernels.gibbs.kernel import gibbs_argmax_cuda
    from repro_torch.kernels.gibbs.ref import gibbs_argmax_ref, gibbs_scores

    seed, V = 42, FULL["vocab"]
    max_err, total_bad = 0.0, 0
    for (T, K) in [(8192, FULL["n_topics"]), (257, 513), (31, 1000)]:
        for psi_row in (False, True):
            args = gibbs_inputs(T, K, psi_row, seed=T + K)
            for tau in (1.0, 0.0):
                zk = ops.gibbs_argmax(*args, seed, V, tau)
                zp = gibbs_argmax_ref(*args, seed, V, tau)
                torch.cuda.synchronize()
                if not bool(((zk >= 0) & (zk < K)).all()):
                    raise AssertionError(f"kernel index out of range at T={T} K={K}")
                scores = gibbs_scores(*args, seed, V, tau)    # the plain version's
                sk = scores.gather(1, zk.long()[:, None])[:, 0]
                sp = scores.gather(1, zp.long()[:, None])[:, 0]
                del scores
                gap = (sp - sk).abs()
                ulp = torch.nextafter(torch.maximum(sp.abs(), sk.abs()),
                                      torch.tensor(float("inf"), device="cuda"))
                ulp = ulp - torch.maximum(sp.abs(), sk.abs())
                mism = zk != zp
                bad = int((mism & ~(gap <= 4 * ulp)).sum())
                max_err = max(max_err, float(gap.max()))
                total_bad += bad
                log(f"[kernel] T={T} K={K} psi={'row' if psi_row else 'plane'} tau={tau}: "
                    f"{int(mism.sum())} mismatches, {bad} not near-ties (>4 ulp)")
            del args
    if total_bad:
        raise AssertionError(f"{total_bad} kernel/plain mismatches beyond a near-tie")

    T, K = 8192, FULL["n_topics"]
    args = gibbs_inputs(T, K, False, seed=1)
    kernel_ms = timed_ms(lambda: gibbs_argmax_cuda(*args, seed, V, 1.0), reps=25)
    plain_ms = timed_ms(lambda: gibbs_argmax_ref(*args, seed, V, 1.0), reps=5, warmup=1)
    bytes_moved = 3 * T * K * 4 + K * 4 + 4 + T * 8 + T * 4
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = GIBBS_OPS_PER_ELEMENT * T * K / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"[kernel] gibbs_argmax T={T} K={K} psi=plane tau=1: kernel_ms={kernel_ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} (bytes {bytes_ms:.4f}, "
        f"ops {ops_ms:.4f}) share_of_bound={bound_ms / kernel_ms:.4f}")
    del args
    torch.cuda.empty_cache()
    return dict(max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


# ------------------------------------------------------------ full-width phase
def device_breakdown(label, fn, top=8):
    """Device time by kernel over one run of ``fn`` (torch.profiler), and the
    device's busy share of that window; returns the rows (ms, launches,
    kernel name), all of them. Auxiliary: a profiler that cannot trace the
    card is reported, ``fn`` runs untraced and no rows come back; a failure
    of ``fn`` itself is fatal."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        with profile(activities=activities):     # the tracer's start-up stays out
            torch.ones(1, device="cuda").add_(1)   # of the measured window
            torch.cuda.synchronize()
    except Exception as exc:    # noqa: BLE001 — the breakdown is optional
        log(f"[profile] {label}: not available ({exc!r})")
        fn()
        torch.cuda.synchronize()
        return []
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[profile] {label}: window {wall_ms:.3f} ms (profiled), device busy {busy:.3f} ms "
        f"= {busy / wall_ms:.3f} of it, idle {1 - busy / wall_ms:.3f}")
    for ms, n, name in rows[:top]:
        log(f"[profile]   {ms:10.3f} ms {n:5d}x {100 * ms / busy:5.1f}%  {name[:80]}")
    return rows


def query_batch(corpus, lo, n, bucket):
    from repro_torch.core.rtlda import select_bucket
    starts = np.concatenate([[0], np.cumsum(corpus.doc_lengths())])
    q = np.full((n, bucket), -1, np.int32)
    cut = 0
    for i in range(n):
        d = (lo + i) % corpus.n_docs
        toks = corpus.word_ids[starts[d]:starts[d + 1]]
        b, truncated = select_bucket(len(toks), (bucket,))
        cut += truncated
        q[i, :min(len(toks), b)] = toks[:b]
    return q, cut


def full_corpus():
    """The full-width cell's corpus: one 4,096-query segment shard."""
    from repro_torch.data import synthetic
    t0 = time.perf_counter()
    corpus, _ = synthetic.lda_corpus(seed=0, n_docs=FULL["n_docs"],
                                     n_topics=FULL["gen_topics"], vocab_size=FULL["vocab"],
                                     query_like=True)
    log(f"[full] corpus: {corpus.n_docs} docs, {corpus.n_tokens} tokens "
        f"({time.perf_counter() - t0:.1f} s on the host)")
    return corpus


def full_width_phase(corpus):
    from repro_torch.core import dedup, gibbs, lda, rtlda
    from repro_torch.core.features import make_serving_fn
    from repro_torch.data import corpus as corpus_mod
    from repro_torch.kernels.gibbs import ops

    K, V, D = FULL["n_topics"], FULL["vocab"], FULL["n_docs"]
    wi, di = corpus_mod.pad_corpus(corpus.word_ids, corpus.doc_ids, FULL["block"])
    log(f"[full] padded to {len(wi)} tokens")
    dev = torch.device("cuda")
    wi_t, di_t = torch.from_numpy(wi).to(dev), torch.from_numpy(di).to(dev)
    valid = wi_t >= 0
    torch.cuda.reset_peak_memory_stats()

    state = lda.init_state(wi_t[valid], K, V, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(0))
    z = torch.zeros(len(wi), dtype=torch.int32, device=dev)
    z[valid] = state.z
    state = lda.LDAState(state.phi, state.psi, z, state.alpha, state.beta)
    torch.cuda.synchronize()

    # ---- the main path: counts from 0, train → export → serve ----
    ops.launches = 0
    n_blocks = len(wi) // FULL["block"]
    for e in range(FULL["epochs"]):
        t0 = time.perf_counter()
        state = gibbs.gibbs_epoch(state, wi_t, di_t, D, V, seed=e * 31 + 7,
                                  block_size=FULL["block"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"[full] epoch {e}: {dt:.4f} s, {corpus.n_tokens / dt:.1f} tokens/s "
            f"({n_blocks} blocks of {FULL['block']})")
    lda.check_invariants(lda.LDAState(state.phi, state.psi, state.z[valid], state.alpha,
                                      state.beta), wi_t[valid])

    t0 = time.perf_counter()
    omega = dedup.topic_count_histogram(di_t, state.z, valid, D, K)
    lengths = torch.from_numpy(corpus.doc_lengths()).to(dev)
    alpha = dedup.optimize_alpha(state.alpha, omega, dedup.doc_length_histogram(lengths),
                                 n_iters=5)
    if not bool(torch.isfinite(alpha).all() & (alpha > 0).all()):
        raise AssertionError("optimize_alpha gave a non-finite or non-positive α")
    model = rtlda.build_model(state.phi, state.beta, alpha, device=dev)
    del omega
    torch.cuda.synchronize()
    log(f"[full] α + build_model: {time.perf_counter() - t0:.4f} s; "
        f"α sum {float(alpha.sum()):.4f} (was 50.0)")

    serve = make_serving_fn(n_iters=5, n_trials=2, top_n=30, device=dev)
    times, n_cut = [], 0
    for b in range(FULL["batches"]):
        q, cut = query_batch(corpus, b * FULL["batch"], FULL["batch"], FULL["bucket"])
        n_cut += cut
        t0 = time.perf_counter()
        pkd, ids, w = serve(model, q, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if pkd.shape != (FULL["batch"], K) or not bool(torch.isfinite(pkd).all()):
            raise AssertionError("pkd has the wrong shape or non-finite values")
        if float((pkd.sum(dim=1) - 1).abs().max()) > 1e-5:
            raise AssertionError("a pkd row does not sum to 1 within 1e-5")
        if not bool(((ids >= 0) & (ids < V)).all()) or ids.shape != (FULL["batch"], 30):
            raise AssertionError("feature ids out of [0, V)")
    launches = ops.launches
    # ---- end of the main path ----

    expected = FULL["epochs"] * n_blocks
    if launches != expected:
        raise AssertionError(f"gibbs_argmax launched {launches} times, expected {expected}")
    qps = [FULL["batch"] / t for t in times]
    log(f"[full] serve: {FULL['batches']} batches of {FULL['batch']} x bucket "
        f"{FULL['bucket']} ({n_cut} queries cut to the bucket); batch s "
        f"{[round(t, 4) for t in times]}; queries/s per batch {[round(x, 1) for x in qps]}; "
        f"queries/s after the first {sum(FULL['batch'] for _ in times[1:]) / sum(times[1:]):.1f}")
    log(f"[full] launches gibbs_argmax={launches} (expected {expected}); "
        f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # where the time goes: one more epoch and one more batch, under the profiler
    device_breakdown("epoch", lambda: gibbs.gibbs_epoch(
        state, wi_t, di_t, D, V, seed=99, block_size=FULL["block"]))
    q, _ = query_batch(corpus, 0, FULL["batch"], FULL["bucket"])
    device_breakdown("serve batch", lambda: serve(model, q, 7))
    del model, state
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------- small phase
def small_phase():
    """Quickstart scale: the O(K²V) de-duplication, and the card's whole loop
    held against the same loop on the CPU (plain version)."""
    from repro_torch.core import dedup, gibbs, lda, rtlda
    from repro_torch.core.features import make_serving_fn
    from repro_torch.data import corpus as corpus_mod, synthetic

    K, V = SMALL["n_topics"], SMALL["vocab"]
    corpus, _ = synthetic.lda_corpus(seed=0, n_docs=SMALL["n_docs"],
                                     n_topics=SMALL["gen_topics"], vocab_size=V,
                                     doc_len_mean=9)
    wi, di = corpus_mod.pad_corpus(corpus.word_ids, corpus.doc_ids, 512)
    valid = wi >= 0
    z0 = np.zeros(len(wi), np.int32)
    z0[valid] = np.random.default_rng(0).integers(0, K, int(valid.sum()))
    states, models = {}, {}
    for name in ("cuda", "cpu"):
        st = lda.init_state(wi[valid], K, V, z0=z0[valid], device=name)
        st = lda.LDAState(st.phi, st.psi, torch.from_numpy(z0).to(name), st.alpha, st.beta)
        w_t, d_t = torch.from_numpy(wi).to(name), torch.from_numpy(di).to(name)
        for e in range(SMALL["epochs"]):
            st = gibbs.gibbs_epoch(st, w_t, d_t, corpus.n_docs, V, seed=e * 31 + 7,
                                   block_size=512)
        states[name] = st
        models[name] = rtlda.build_model(st.phi, st.beta, st.alpha, device=name)
    q, _ = query_batch(corpus, 0, 256, 8)
    pkd = {n: make_serving_fn(device=n)(models[n], q, 3)[0].cpu() for n in models}
    for f in ("z", "phi", "psi"):
        a, b = getattr(states["cuda"], f).cpu(), getattr(states["cpu"], f)
        if not torch.equal(a, b):
            raise AssertionError(f"small loop: card and CPU {f} differ at "
                                 f"{int((a != b).sum())} entries")
    err = float((pkd["cuda"] - pkd["cpu"]).abs().max())
    if err > 1e-5:
        raise AssertionError(f"small loop: served pkd differs by {err}")
    st = states["cuda"]
    frac = dedup.duplicate_fraction(st.phi, st.beta, 0.5)
    _, n_clusters = dedup.cluster_topics(st.phi, st.beta, l1_threshold=0.3)
    log(f"[small] K={K} V={V}, {SMALL['epochs']} epochs: card == CPU for z, Φ, Ψ; "
        f"served pkd max |card − CPU| = {err:.3g}; duplicate fraction {frac:.3f}; "
        f"{K} topics → {n_clusters} after L1 merge")


# ------------------------------------------------------------ alias kernels
def events_ms(fn):
    """Device time of one run of ``fn()`` by CUDA events (for the slow plain
    versions, which run once)."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), out


def bound(bytes_moved, ops):
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def word_weights(R, K, seed):
    """Rows shaped like the cell's word proposal weights (φ+β)/(ψ+Vβ): sparse
    counts over a spread of topic totals."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    counts = torch.randint(1, 50, (R, K), generator=g, device="cuda", dtype=torch.int32)
    counts *= torch.rand((R, K), generator=g, device="cuda") < 0.002
    psi = torch.randint(1, 500, (K,), generator=g, device="cuda").to(torch.float32)
    return (counts.to(torch.float32) + 0.01) / (psi + FULL["vocab"] * 0.01)


def check_build(wn, order, ns, label):
    """alias_build kernel against the plain sweep on the same (wn, order, ns);
    returns the plain version's device ms and the largest |kernel − plain|."""
    from repro_torch.kernels.alias.kernel import alias_build_cuda
    from repro_torch.kernels.alias.ref import build_alias_ref
    pk, ak = alias_build_cuda(wn, order, ns)
    plain_ms, (pp, ap) = events_ms(lambda: build_alias_ref(wn, order, ns))
    torch.cuda.synchronize()
    bad = int((pk != pp).sum()) + int((ak != ap).sum())
    err = max(float((pk - pp).abs().max()), float((ak - ap).abs().max()))
    log(f"[alias-kernel] alias_build {label}: {bad} entries differ from the plain sweep")
    if bad:
        raise AssertionError(f"alias_build differs from its plain version at {label}")
    return plain_ms, err


def mh_case(T, K, V, D, n_mh):
    """Consistent counts, pairs (round-robin docs, ⌈T/D⌉ tokens each), α and
    kernel-built tables on the card: the tensor arguments of
    ``ops.mh_resample`` (phi … uid), and the pair cap."""
    from repro_torch.core import sparse
    g = torch.Generator(device="cuda").manual_seed(T + K + n_mh)
    w = torch.randint(0, V, (T,), generator=g, device="cuda", dtype=torch.int32)
    d = (torch.arange(T, device="cuda") % D).to(torch.int32)
    z = torch.randint(0, K, (T,), generator=g, device="cuda", dtype=torch.int32)
    phi = torch.zeros((V, K), dtype=torch.int32, device="cuda")
    phi.index_put_((w.long(), z.long()), torch.ones_like(z), accumulate=True)
    psi = torch.bincount(z.long(), minlength=K).to(torch.int32)
    cap = min(K, -(-T // D))
    tp, ct = sparse.pairs_from_assignments(d, z, torch.ones(T, dtype=torch.bool,
                                                            device="cuda"), D, cap)
    alpha = torch.full((K,), 50.0 / K, device="cuda")
    tabs = sparse.make_tables(phi, psi, alpha, 0.01, V)
    uid = torch.arange(T, dtype=torch.int64, device="cuda") * 7 + 3
    return (phi, psi, tp, ct, *tabs[:3], alpha, *tabs[3:], w, d, z, uid), cap


def check_mh(args, seed, n_mh, V, label):
    """mh_resample kernel (through the by-word dispatch) against the plain
    version on the card; returns the plain version's device ms and the
    largest |kernel − plain| (in topic ids)."""
    from repro_torch.kernels.alias import ops
    from repro_torch.kernels.alias.ref import mh_resample_ref
    zk = ops.mh_resample(*args, seed, 0.01, V, n_mh)
    beta = torch.tensor(0.01, device="cuda")
    plain_ms, zp = events_ms(lambda: mh_resample_ref(
        *args, ops.mh_seed(seed), beta, args[7].sum(dtype=torch.float32), V, n_mh))
    torch.cuda.synchronize()
    bad = int((zk != zp).sum())
    log(f"[alias-kernel] mh_resample {label}: {bad} of {zk.shape[0]} draws differ "
        f"from the plain version")
    if bad:
        raise AssertionError(f"mh_resample differs from its plain version at {label}")
    return plain_ms, float((zk - zp).abs().max())


def alias_kernel_phase():
    """Both alias kernels against their plain versions, bit for bit, at small
    shapes and at full K; the full-cell timings come from ``alias_phase``."""
    from repro_torch.core import sparse
    from repro_torch.kernels.alias import ops
    from repro_torch.kernels.alias.kernel import alias_build_cuda

    K = FULL["n_topics"]
    rng = np.random.default_rng(11)
    errs = []
    for R, k in [(1, 8), (5, 37), (16, 128), (3, 513), (64, 4096)]:
        w = torch.from_numpy(rng.gamma(0.3, 1.0, (R, k)).astype(np.float32) + 1e-3)
        errs.append(check_build(*ops._prepare(w.cuda()), f"R={R} K={k}")[1])
    special = torch.ones((3, 64), device="cuda")
    special[0] = 0.0
    special[0, 3] = 5.0                       # one-hot; row 1 all equal
    special[2, 32:] = 0.0                     # a zero-weight tail
    errs.append(check_build(*ops._prepare(special),
                            "one-hot / all-equal / zero-tail rows R=3 K=64")[1])

    # the row chunk of a table build, and the α table's one row after it: the
    # two shapes the main path builds, held against one plain sweep
    R = sparse.TABLE_ROWS
    alpha = torch.full((1, K), 50.0 / K, device="cuda")
    prepared = ops._prepare(word_weights(R, K, seed=5)), ops._prepare(alpha)
    wn, order, ns = (torch.cat(parts) for parts in zip(*prepared))
    plain_ms, err = check_build(wn, order, ns, f"R={R}+1 K={K} (a table chunk and the α row)")
    errs.append(err)
    wn, order, ns = prepared[0]
    out = (torch.empty_like(wn), torch.empty_like(order))
    ms = timed_ms(lambda: alias_build_cuda(wn, order, ns, out=out), reps=5, warmup=1)
    bound_ms, bound_by = bound(16 * R * K, SWEEP_OPS_PER_SLOT * R * K)
    log(f"[alias-kernel] alias_build R={R} K={K}: kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} (R={R}+1) bound_ms={bound_ms:.4f} ({bound_by}) "
        f"share_of_bound={bound_ms / ms:.5f}")
    a_ms = timed_ms(lambda: alias_build_cuda(*ops._prepare(alpha)), reps=5, warmup=1)
    log(f"[alias-kernel] alias_build R=1 K={K} (the α table, with _prepare): {a_ms:.4f} ms")
    del wn, order, ns, out, prepared
    build = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 max_abs_err=max(errs))

    mh_errs = []
    # the last case: 262,144 tokens over R = 2,048 words at full K, 16 tokens
    # to a doc, so (nearly) every pair row is full
    for T, k, V, D, n_mh in [(37, 16, 20, 8, 1), (300, 16, 20, 8, 5), (64, 130, 20, 8, 4),
                             (4000, 512, 20, 200, 4), (128 * R, K, R, 8 * R, 5)]:
        args, cap = mh_case(T, k, V, D, n_mh)
        for seed in (0, 0xFFFF_FFFF):
            mh_errs.append(check_mh(args, seed, n_mh, V,
                                    f"T={T} K={k} cap={cap} n_mh={n_mh} seed={seed}")[1])
        del args
    torch.cuda.empty_cache()
    return build, max(mh_errs)


# --------------------------------------------------------------- alias phase
def tile_corpus(corpus, n):
    """``n`` copies of ``corpus``, each copy new docs (and so new token uids)."""
    from repro_torch.data.corpus import Corpus
    offs = np.repeat(np.arange(n, dtype=np.int32) * corpus.n_docs, corpus.n_tokens)
    return Corpus(np.tile(corpus.word_ids, n), np.tile(corpus.doc_ids, n) + offs,
                  corpus.n_docs * n, corpus.vocab_size)


def mh_bytes(w, uid, wp, seed2, n_mh, n_docs, cap_p):
    """Bytes the MH probe must move for the tokens (w, uid), each input byte
    read once and the output written once. Per token: w, d, z, out (4 B) and
    uid (8 B), and each scattered gather into a [rows, K] table as one
    32-byte sector: φ_ws for p(z0) and φ_wt for each step's p(t), and per word
    step wp_jk, wq_s and wq_t, plus wa_jk where the coin rejects wp_jk (known
    from the token's uniforms before the chain runs). Once each: the pair
    table (n_docs · cap_p topics and counts) and the [K] vectors ψ, α, ap,
    aa."""
    from repro_torch.core import prng
    T, K = w.shape[0], wp.shape[1]
    key, row = uid.to(torch.int64), w.long()
    sectors = T * (1 + n_mh)
    for step in range(1, n_mh, 2):
        u_draw = prng.uniform01(seed2, key, 4 * step + 1)
        u_coin = prng.uniform01(seed2, key, 4 * step + 2)
        jk = (u_draw * K).to(torch.int64).clamp(max=K - 1)
        sectors += 3 * T + int((u_coin >= wp[row, jk]).sum())
    return T * 24 + 32 * sectors + n_docs * cap_p * 8 + 4 * K * 4


def mh_ops(T, cap, n_mh):
    """Scalar operations of the MH probe for T tokens: per step 4 uniforms of
    ~14 integer ops, up to 3 pair-row lookups or the walk (2 per slot), and
    ~30 for the proposal, the posterior and the ratio."""
    return T * (2 * cap + n_mh * (4 * 14 + 3 * 2 * cap + 30))


def alias_phase(base):
    from repro_torch.core import dedup, distributed as dist, lda, rtlda, sparse
    from repro_torch.core.features import make_serving_fn
    from repro_torch.data import corpus as corpus_mod
    from repro_torch.kernels.alias import ops
    from repro_torch.kernels.alias.kernel import mh_resample_cuda

    K, V = FULL["n_topics"], FULL["vocab"]
    corpus = tile_corpus(base, ALIAS["tiles"])
    t0 = time.perf_counter()
    sc = corpus_mod.shard_corpus(corpus, 1, 1, K, seed=0)
    cap = sc.word_local.shape[2]
    cap_p = sparse.suggest_cap(corpus.doc_lengths(), K)
    D = sc.docs_per_shard
    log(f"[alias] corpus: {corpus.n_docs} docs, {corpus.n_tokens} tokens; ring of one "
        f"device: rows {sc.rows_per_shard}, cap {cap}, pair cap {cap_p} "
        f"(shard_corpus {time.perf_counter() - t0:.1f} s on the host)")
    cfg = dist.RingConfig(n_topics=K, vocab_size=V, rows_per_shard=sc.rows_per_shard,
                          docs_per_shard=D, cap=cap, package_len=cap, n_rounds=1,
                          sampler="alias", n_mh=ALIAS["n_mh"], doc_topic_cap=cap_p)
    epoch = dist.build_epoch_body(cfg)
    torch.cuda.reset_peak_memory_stats()
    state = dist.device_arrays(sc, K, device="cuda")
    phi, psi, wl, dl, uid, z = state
    alpha = torch.full((K,), 50.0 / K, device="cuda")
    beta = torch.tensor(0.01, device="cuda")
    ll0 = float(lda.word_log_likelihood(phi[0], psi, beta))
    lengths = torch.from_numpy(corpus.doc_lengths()).cuda()
    torch.cuda.synchronize()

    # ---- the main path: counts from 0, train → α → export → serve ----
    ops.build_launches = ops.mh_launches = 0
    tables, build_s, epoch_s = None, [], []
    for e in range(ALIAS["epochs"]):
        if e % ALIAS["agg_every"] == 0:           # the aggregation-boundary rebuild
            tables = None
            t0 = time.perf_counter()
            tables = sparse.make_tables(phi, psi, alpha, beta, V)
            torch.cuda.synchronize()
            build_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        epoch(*state, alpha, beta, e * 977 + 3, *tables)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
    valid = wl.reshape(-1) >= 0
    tp, ct = sparse.pairs_from_assignments(dl.reshape(-1), z.reshape(-1), valid, D, cap_p)
    omega = sparse.pairs_topic_histogram(tp, ct, K)
    alpha2 = dedup.optimize_alpha(alpha, omega, dedup.doc_length_histogram(lengths),
                                  n_iters=5)
    if not bool(torch.isfinite(alpha2).all() & (alpha2 > 0).all()):
        raise AssertionError("optimize_alpha gave a non-finite or non-positive α")
    ap, aa = sparse.make_alpha_table(alpha2)             # α moved: refresh its table
    torch.cuda.synchronize()
    del tables, ap, aa
    ll1 = float(lda.word_log_likelihood(phi[0], psi, beta))
    phi_full = dist.gather_phi(phi, sc)
    model = rtlda.build_model(phi_full, beta, alpha2, device="cuda")
    del phi_full
    serve = make_serving_fn(n_iters=5, n_trials=2, top_n=30, device="cuda")
    times = []
    for b in range(ALIAS["batches"]):
        q, _ = query_batch(corpus, b * ALIAS["batch"], ALIAS["batch"], ALIAS["bucket"])
        t0 = time.perf_counter()
        pkd, ids, _ = serve(model, q, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if pkd.shape != (ALIAS["batch"], K) or not bool(torch.isfinite(pkd).all()):
            raise AssertionError("alias pkd has the wrong shape or non-finite values")
        if float((pkd.sum(dim=1) - 1).abs().max()) > 1e-5:
            raise AssertionError("an alias pkd row does not sum to 1 within 1e-5")
        if not bool(((ids >= 0) & (ids < V)).all()):
            raise AssertionError("alias feature ids out of [0, V)")
    launches = dict(alias_build=ops.build_launches, mh_resample=ops.mh_launches)
    # ---- end of the main path ----

    n_builds = -(-ALIAS["epochs"] // ALIAS["agg_every"])
    chunks = -(-sc.rows_per_shard // sparse.TABLE_ROWS)
    expected = dict(alias_build=n_builds * (chunks + 1) + 1,
                    mh_resample=ALIAS["epochs"] * (cap // cfg.package_len))
    peak = torch.cuda.max_memory_allocated() / 2**30
    train_s = sum(epoch_s) + sum(build_s)
    log(f"[alias] table build s {[round(t, 4) for t in build_s]}; tokens/s per epoch "
        f"{[round(corpus.n_tokens / t, 1) for t in epoch_s]}; serve batch s "
        f"{[round(t, 4) for t in times]}")
    log(f"[alias] training window: {ALIAS['epochs']} epochs x {corpus.n_tokens} tokens in "
        f"{train_s:.4f} s, table builds included ({sum(build_s):.4f} s of it): "
        f"{ALIAS['epochs'] * corpus.n_tokens / train_s:.1f} tokens/s")
    log(f"[alias] word LL {ll0:.6e} -> {ll1:.6e}; α sum {float(alpha2.sum()):.4f} (was 50.0); "
        f"launches {launches} (expected {expected}); max_memory_allocated={peak:.2f} GiB")
    if launches != expected:
        raise AssertionError(f"alias launches {launches}, expected {expected}")
    if not ll1 > ll0:
        raise AssertionError(f"alias training did not raise the word LL: {ll0} -> {ll1}")
    counts, _ = lda.build_counts(wl[wl >= 0], z[wl >= 0], K, sc.rows_per_shard)
    if not torch.equal(counts, phi[0]):
        raise AssertionError("Φ disagrees with the travelling z")
    del counts
    if int(psi.sum()) != corpus.n_tokens or not torch.equal(phi.sum(dim=(0, 1)), psi):
        raise AssertionError("Σψ is not the token count, or Φ's column sums are not Ψ")
    del model
    torch.cuda.empty_cache()

    # where the time goes: one more table build and one more epoch, profiled
    holder = []
    device_breakdown("alias table build", lambda: holder.append(
        sparse.make_tables(phi, psi, alpha2, beta, V)))
    tables = holder.pop()
    device_breakdown("alias epoch", lambda: epoch(*state, alpha2, beta, 99, *tables))

    # the MH kernel at the cell's shape: this epoch's one package
    pairs = sparse.pairs_from_assignments(dl.reshape(-1), z.reshape(-1), valid, D, cap_p)
    w0, d0, z0 = (torch.where(wl[0, 0] >= 0, x[0, 0], 0) for x in (wl, dl, z))
    args = (phi[0], psi, *pairs, *(t[0] for t in tables[:3]), alpha2, *tables[3:], w0, d0,
            z0, uid[0, 0])
    plain_ms, err = check_mh(args, 7, ALIAS["n_mh"], V,
                             f"full cell T={cap} cap={cap_p} n_mh=4")
    order = torch.sort(w0, stable=True).indices
    srt = [x[order].contiguous() for x in (w0, d0, z0, uid[0, 0])]
    asum = alpha2.sum(dtype=torch.float32)
    ms = timed_ms(lambda: mh_resample_cuda(*args[:10], *srt, ops.mh_seed(7), beta, asum,
                                           V, ALIAS["n_mh"]), reps=10)
    bound_ms, bound_by = bound(mh_bytes(w0, uid[0, 0], tables[1][0], ops.mh_seed(7),
                                        ALIAS["n_mh"], D, cap_p),
                               mh_ops(cap, cap_p, ALIAS["n_mh"]))
    log(f"[alias-kernel] mh_resample T={cap} cap={cap_p} n_mh=4 (words sorted): "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
        f"share_of_bound={bound_ms / ms:.5f}")
    del args, tables, state, phi, psi, wl, dl, uid, z, pairs
    torch.cuda.empty_cache()
    return launches, dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err=err)


def alias_small_phase():
    """Quickstart scale: the card's alias loop against the same loop on the
    CPU. The tables are built once, on the CPU, and carried to the card, so
    both sample against the same proposals (α is 50/16 per topic, so its sum
    is exact on either device)."""
    from repro_torch.core import distributed as dist, sparse
    from repro_torch.data import corpus as corpus_mod, synthetic

    K, V = SMALL["n_topics"], SMALL["vocab"]
    corpus, _ = synthetic.lda_corpus(seed=0, n_docs=SMALL["n_docs"],
                                     n_topics=SMALL["gen_topics"], vocab_size=V,
                                     doc_len_mean=9)
    sc = corpus_mod.shard_corpus(corpus, 1, 1, K, seed=1)
    cap = sc.word_local.shape[2]
    cap_p = sparse.suggest_cap(corpus.doc_lengths(), K)
    cfg = dist.RingConfig(n_topics=K, vocab_size=V, rows_per_shard=sc.rows_per_shard,
                          docs_per_shard=sc.docs_per_shard, cap=cap, package_len=cap // 2,
                          n_rounds=1, sampler="alias", n_mh=ALIAS_SMALL["n_mh"],
                          doc_topic_cap=cap_p)
    epoch = dist.build_epoch_body(cfg)
    states = {dev: dist.device_arrays(sc, K, device=dev) for dev in ("cuda", "cpu")}
    alpha = {dev: torch.full((K,), 50.0 / K, device=dev) for dev in states}
    beta = {dev: torch.tensor(0.01, device=dev) for dev in states}
    for e in range(ALIAS_SMALL["epochs"]):
        if e % ALIAS_SMALL["agg_every"] == 0:
            cpu = states["cpu"]
            tabs = sparse.make_tables(cpu[0], cpu[1], alpha["cpu"], beta["cpu"], V)
        for dev, st in states.items():
            epoch(*st, alpha[dev], beta[dev], e * 977 + 3, *(t.to(dev) for t in tabs))
    for i, name in ((0, "phi"), (1, "psi"), (5, "z")):
        a, b = states["cuda"][i].cpu(), states["cpu"][i]
        if not torch.equal(a, b):
            raise AssertionError(f"small alias loop: card and CPU {name} differ at "
                                 f"{int((a != b).sum())} entries")
    pairs = {}
    for dev, (_, _, wl, dl, _, z) in states.items():
        pairs[dev] = sparse.pairs_from_assignments(dl.reshape(-1), z.reshape(-1),
                                                   wl.reshape(-1) >= 0, sc.docs_per_shard,
                                                   cap_p)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(pairs["cuda"], pairs["cpu"])):
        raise AssertionError("small alias loop: card and CPU pairs differ")
    log(f"[alias-small] K={K} V={V}, {ALIAS_SMALL['epochs']} epochs in packages of "
        f"{cfg.package_len}: card == CPU for z, Φ, Ψ and the pairs")


# ------------------------------------------------------- embedding_bag kernel
BAG_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def check_bag(table, ids, w, combiner, label):
    """embedding_bag kernel against its plain version on the card; returns the
    largest |kernel − plain|. A bag of one row with weight 1 must be equal bit
    for bit; otherwise within 1e-5 (f32) or 2e-2 (bf16), the JAX kernel
    test's limits. The bf16 plain version rounds the weights to bf16 and the
    kernel keeps them in f32, so weighted bf16 bags are held (a) against the
    plain version with weights that are bf16 values, within 2e-2, and (b)
    with the raw weights against the plain version in f32 on the same row
    values, within the kernel's one rounding to bf16 (2⁻⁸ relative) + 1e-5."""
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_padded_ref
    bf16 = table.dtype == torch.bfloat16
    w_plain = w.to(torch.bfloat16).float() if (w is not None and bf16) else w
    out = embedding_bag_cuda(table, ids, w_plain, combiner)
    plain = embedding_bag_padded_ref(table, ids, w_plain, combiner)
    err = float((out.float() - plain.float()).abs().max()) if out.numel() else 0.0
    if ids.shape[1] == 1 and w is None:
        if not torch.equal(out, plain):
            raise AssertionError(f"embedding_bag {label}: a bag of one is not the row "
                                 f"bit for bit ({int((out != plain).sum())} entries)")
    else:
        tol = BAG_TOL[table.dtype]
        if not torch.allclose(out.float(), plain.float(), rtol=tol, atol=tol):
            raise AssertionError(f"embedding_bag {label}: |kernel − plain| {err} beyond "
                                 f"rtol = atol = {tol}")
    if w is not None and bf16:
        B, F = ids.shape
        rows = table[ids.reshape(-1).long()].float()            # the row values, in f32
        local = torch.arange(B * F, device=ids.device, dtype=torch.int32).reshape(B, F)
        exact = embedding_bag_padded_ref(rows, local, w, combiner)
        out = embedding_bag_cuda(table, ids, w, combiner).float()
        if not torch.allclose(out, exact, rtol=2 ** -8 + 1e-5, atol=1e-5):
            raise AssertionError(f"embedding_bag {label}: raw weights off the f32 sum by "
                                 f"{float((out - exact).abs().max())}")
    return err


def bag_kernel_phase():
    """embedding_bag at random shapes (D the model's and the tests' widths,
    F 1 / 3 / 26, f32 and bf16, sum and mean, weights and none, zero-weight
    padding) against its plain version; the full-width DLRM gather is checked
    in ``recsys_phase``, on the model's own table."""
    g = torch.Generator(device="cuda").manual_seed(13)
    errs, n = [], 0
    for D in (8, 10, 16, 18, 128, 512):
        for F in (1, 3, 26):
            for dtype in (torch.float32, torch.bfloat16):
                B = int(torch.randint(1, 300, (1,), generator=g, device="cuda"))
                V = int(torch.randint(50, 100_000, (1,), generator=g, device="cuda"))
                table = torch.randn((V, D), generator=g, device="cuda").to(dtype)
                ids = torch.randint(0, V, (B, F), generator=g, device="cuda",
                                    dtype=torch.int32)
                w = torch.rand((B, F), generator=g, device="cuda") * 1.9 + 0.1
                w[::2, -1] = 0.0                                   # zero-weight padding
                w[torch.rand((B, F), generator=g, device="cuda") < 0.1] = 0.0
                for combiner in ("sum", "mean"):
                    for weights in (None, w):
                        errs.append(check_bag(table, ids, weights, combiner,
                                              f"B={B} F={F} V={V} D={D} {dtype} {combiner} "
                                              f"{'weighted' if weights is not None else 'ones'}"))
                        n += 1
    log(f"[bag-kernel] {n} random cases (D 8…512, F 1/3/26, f32/bf16, sum/mean, weights "
        f"and none): bags of one bit for bit, the rest within the limits; max |kernel − "
        f"plain| {max(errs):.6g}")
    return max(errs)


def bag_full_width(table, spec, ids):
    """The kernel at the DLRM serving shape on the full table: the bulk
    batch's 262,144 × 26 ids as bags of one (``lookup``) and as one weighted
    bag per row (``multi_hot_lookup``), checked and timed beside the plain
    version and PyTorch's own call (a yardstick, never on the path)."""
    import torch.nn.functional as nnf
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_padded_ref
    from repro_torch.models.recsys import _flat_ids

    flat = _flat_ids(spec, ids)                                # [B, F] global rows
    B, F = flat.shape
    D = table.shape[1]
    one = flat.reshape(-1, 1)
    g = torch.Generator(device="cuda").manual_seed(17)
    w = torch.rand((B, F), generator=g, device="cuda")
    e1 = check_bag(table, one, None, "sum", f"full width, {B * F} bags of one, V={table.shape[0]}")
    e2 = check_bag(table, flat, w, "sum", f"full width, {B} bags of {F}, weighted")
    e3 = check_bag(table, flat, None, "sum", f"full width, {B} bags of {F}, ones")
    esz = table.element_size()
    res = {}
    w_lib = w.to(table.dtype)                  # PyTorch's call takes the table's dtype
    cases = (("lookup", one, None, lambda: nnf.embedding(one[:, 0], table),
              2 * B * F * D * esz + B * F * 4),
             ("multi_hot", flat, w,
              lambda: nnf.embedding_bag(flat, table, mode="sum", per_sample_weights=w_lib),
              B * F * D * esz + B * D * esz + 2 * B * F * 4))
    for label, i, ww, library, nbytes in cases:
        ms = timed_ms(lambda: embedding_bag_cuda(table, i, ww), reps=20)
        plain_ms = timed_ms(lambda: embedding_bag_padded_ref(table, i, ww), reps=5, warmup=1)
        library_ms = timed_ms(library, reps=20)
        bound_ms, bound_by = bound(nbytes, 2 * B * F * D)
        log(f"[bag-kernel] full width {label} ({B} × {F} ids, D={D}, {table.dtype}): "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) share_of_bound={bound_ms / ms:.4f}")
        res[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
    # the serve_p99 batch's gather: 512 × 26 bags of one, most of the path's launches
    small = one[:RECSYS["p99_batch"] * F].contiguous()
    ms = timed_ms(lambda: embedding_bag_cuda(table, small), reps=50)
    bound_ms, bound_by = bound(2 * small.numel() * D * esz + small.numel() * 4,
                               2 * small.numel() * D)
    log(f"[bag-kernel] serve_p99 lookup ({RECSYS['p99_batch']} × {F} ids): kernel_ms={ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by})")
    return max(e1, e2, e3), res


# ------------------------------------------------------------ recsys phase
def recsys_inputs(arch, cfg, B, g):
    """Seeded serving inputs of ``arch`` on the card: ids uniform per field
    in [0, vocab_f), dense features N(0, 1); DIN histories -1-padded."""
    def field_ids(sizes):
        u = torch.rand((B, len(sizes)), generator=g, device="cuda", dtype=torch.float64)
        v = torch.tensor(sizes, dtype=torch.float64, device="cuda")
        return (u * v).floor().to(torch.int32)
    if arch == "din":
        S = cfg.seq_len
        hist = torch.randint(0, cfg.n_items, (B, S), generator=g, device="cuda",
                             dtype=torch.int32)
        length = torch.randint(1, S + 1, (B, 1), generator=g, device="cuda")
        hist[torch.arange(S, device="cuda")[None, :] >= length] = -1
        return (torch.randint(0, cfg.n_items, (B,), generator=g, device="cuda",
                              dtype=torch.int32), hist,
                torch.randint(0, cfg.context_vocab, (B, cfg.n_context), generator=g,
                              device="cuda", dtype=torch.int32))
    ids = field_ids(cfg.embedding.vocab_sizes)
    if arch == "dlrm-mlperf":
        return torch.randn((B, cfg.n_dense), generator=g, device="cuda"), ids
    return (ids,)


def serve_check(out, B, label):
    if out.shape != (B,) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label}: output of shape {tuple(out.shape)}, or not finite")


def recsys_phase():
    """dlrm-mlperf at full width (the 187,767,552 × 128 bf16 table, nothing
    cut) serving serve_p99 and serve_bulk batches; xdeepfm, din and autoint
    at full width one serve_p99 batch each; retrieval_scores at
    retrieval_cand."""
    from repro_torch.configs import recsys_archs as ra
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.models import recsys as rec

    R = RECSYS
    torch.cuda.reset_peak_memory_stats()
    cfg = ra.DLRM
    t0 = time.perf_counter()
    params = rec.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda",
                             torch.bfloat16)
    torch.cuda.synchronize()
    table = params["table"]
    log(f"[recsys] dlrm-mlperf params: table {tuple(table.shape)} {table.dtype} "
        f"({table.numel() * table.element_size() / 1e9:.2f} GB), drawn in "
        f"{time.perf_counter() - t0:.2f} s; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    g = torch.Generator(device="cuda").manual_seed(R["seed"])
    p99_in = [recsys_inputs("dlrm-mlperf", cfg, R["p99_batch"], g)
              for _ in range(R["p99_warmup"] + R["p99_batches"])]
    bulk_in = [recsys_inputs("dlrm-mlperf", cfg, R["bulk_batch"], g)
               for _ in range(1 + R["bulk_batches"])]
    bag_err, bag = bag_full_width(table, cfg.embedding, bulk_in[0][1])
    torch.cuda.empty_cache()

    others = {}
    for arch, ocfg in (("xdeepfm", ra.XDEEPFM), ("din", ra.DIN), ("autoint", ra.AUTOINT)):
        op = rec.init_params(ocfg, torch.Generator(device="cuda").manual_seed(1), "cuda",
                             torch.bfloat16)
        others[arch] = (ocfg, op, [recsys_inputs(arch, ocfg, R["p99_batch"], g)
                                   for _ in range(2)])
    cand = torch.randn((R["n_candidates"], cfg.embedding.dim), generator=g, device="cuda")
    query = torch.randn((1, cfg.embedding.dim), generator=g, device="cuda")
    forwards = {"xdeepfm": rec.xdeepfm_forward, "din": rec.din_forward,
                "autoint": rec.autoint_forward}
    torch.cuda.synchronize()
    setup_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts from 0, serve p99 → serve bulk → other archs → retrieval ----
    ops.launches = 0
    p99 = []
    for i, (dense, sparse) in enumerate(p99_in):
        t0 = time.perf_counter()
        out = rec.dlrm_forward(cfg, params, dense, sparse)
        torch.cuda.synchronize()
        if i >= R["p99_warmup"]:
            p99.append((time.perf_counter() - t0) * 1e3)
        serve_check(out, R["p99_batch"], "dlrm serve_p99")
    bulk = []
    for i, (dense, sparse) in enumerate(bulk_in):
        t0 = time.perf_counter()
        out = rec.dlrm_forward(cfg, params, dense, sparse)
        torch.cuda.synchronize()
        if i:
            bulk.append(time.perf_counter() - t0)
        serve_check(out, R["bulk_batch"], "dlrm serve_bulk")
    del out
    other_ms = {}
    for arch, (ocfg, op, batches) in others.items():
        for i, args in enumerate(batches):              # a warm-up batch, then the timed one
            t0 = time.perf_counter()
            out = forwards[arch](ocfg, op, *args)
            torch.cuda.synchronize()
            other_ms[arch] = (time.perf_counter() - t0) * 1e3
            serve_check(out, R["p99_batch"], f"{arch} serve_p99")
    t0 = time.perf_counter()
    top_s, top_i = rec.retrieval_scores(query, cand, top_k=100)
    torch.cuda.synchronize()
    retrieval_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launches
    # ---- end of the main path ----

    peak = torch.cuda.max_memory_allocated() / 2**30
    n_forward = len(p99_in) + len(bulk_in) + 2 * 2        # xdeepfm, autoint; din has no bag
    if launches != n_forward:
        raise AssertionError(f"embedding_bag launched {launches} times, expected {n_forward}")
    p50, p99v = np.percentile(p99, 50), np.percentile(p99, 99)
    bulk_rate = R["bulk_batch"] * len(bulk) / sum(bulk)
    log(f"[recsys] dlrm-mlperf serve_p99: {len(p99)} batches of {R['p99_batch']} after "
        f"{R['p99_warmup']} warm-up: p50 {p50:.4f} ms, p99 {p99v:.4f} ms, max {max(p99):.4f} ms "
        f"per batch (host clock + synchronize)")
    log(f"[recsys] dlrm-mlperf serve_bulk: {len(bulk)} batches of {R['bulk_batch']}: s "
        f"{[round(t, 5) for t in bulk]}; {bulk_rate:.1f} samples/s; "
        f"{ra._dlrm_flops(R['bulk_batch']) / np.median(bulk) / 1e12:.3f} TFLOP/s "
        f"of model FLOPs")
    flops = {"xdeepfm": ra._xdeepfm_flops, "din": ra._din_flops,
             "autoint": ra._autoint_flops}
    log(f"[recsys] full width, one serve_p99 batch after a warm-up: "
        + ", ".join(f"{a} {ms:.4f} ms ({flops[a](R['p99_batch']) / ms / 1e9:.4f} TFLOP/s "
                    f"of model FLOPs)" for a, ms in other_ms.items())
        + f"; retrieval_cand (1 × {R['n_candidates']} candidates, top-100) {retrieval_ms:.4f} ms")
    log(f"[recsys] launches embedding_bag={launches} (expected {n_forward}); "
        f"max_memory_allocated={peak:.2f} GiB on the main path, {setup_peak:.2f} GiB in "
        f"the set-up (params drawn chunk by chunk, the full-width kernel checks)")

    # what comes out is right: at each shape the main path gives the kernel
    # (the bulk gather is checked in ``bag_full_width``) the kernel equals its
    # plain version bit for bit, and each forward with the plain lookup (a
    # gather) gives the same logits bit for bit; the streamed top-k is the
    # top-k of the whole score plane
    gather = lambda t, s, i: t[rec._flat_ids(s, i).long()]
    dense, sparse = p99_in[0]
    bag_err = max(bag_err, check_bag(table, rec._flat_ids(cfg.embedding, sparse).reshape(-1, 1),
                                     None, "sum", "dlrm serve_p99 gather"))
    if not torch.equal(rec.dlrm_forward(cfg, params, dense, sparse, table_lookup=gather),
                       rec.dlrm_forward(cfg, params, dense, sparse)):
        raise AssertionError("dlrm forward: kernel lookup and plain gather disagree")
    for arch in ("xdeepfm", "autoint"):
        ocfg, op, batches = others[arch]
        ids = batches[-1][0]                                 # the timed batch
        bag_err = max(bag_err, check_bag(op["table"],
                                         rec._flat_ids(ocfg.embedding, ids).reshape(-1, 1),
                                         None, "sum", f"{arch} serve_p99 gather"))
        if not torch.equal(forwards[arch](ocfg, op, ids, table_lookup=gather),
                           forwards[arch](ocfg, op, ids)):
            raise AssertionError(f"{arch} forward: kernel lookup and plain gather disagree")
    full = (query @ cand.T)[0]
    ref_s, ref_i = torch.sort(full, descending=True, stable=True)
    ref_s, ref_i = ref_s[:100], ref_i[:100]
    # an id may differ from the whole plane's only at a near-tie of scores
    ids_ok = (top_i[0] == ref_i) | torch.isclose(full[top_i[0].long()], ref_s, rtol=1e-5)
    if not torch.allclose(top_s[0], ref_s, rtol=1e-5, atol=1e-5) or not bool(ids_ok.all()):
        raise AssertionError("retrieval_scores is not the top-100 of the score plane")
    log(f"[recsys] checks: the kernel equals its plain version bit for bit on the gathers "
        f"of dlrm serve_p99 (512 × 26, D=128), xdeepfm (512 × 39, D=10) and autoint "
        f"(512 × 39, D=16); the kernel-lookup forward equals the plain-gather forward bit "
        f"for bit for all three; retrieval top-100 equals the full plane's (max score "
        f"{float(top_s[0, 0]):.4f})")

    device_breakdown("recsys bulk batch", lambda: rec.dlrm_forward(cfg, params, *bulk_in[0]))
    rows = device_breakdown("recsys serve_p99 batch",
                            lambda: rec.dlrm_forward(cfg, params, *p99_in[1]))
    bag_rows = [(ms, n) for ms, n, name in rows if "embedding_bag_kernel" in name]
    if bag_rows:
        bag["serve_p99_device_ms"] = sum(r[0] for r in bag_rows) / sum(r[1] for r in bag_rows)
        log(f"[recsys] embedding_bag at the serve_p99 gather (512 × 26 bags of one): "
            f"{bag['serve_p99_device_ms']:.4f} ms of device time per launch (profiler)")
    log(f"[recsys] max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(main path, checks and profile)")
    del params, table, others, cand, p99_in, bulk_in
    torch.cuda.empty_cache()
    return launches, bag_err, bag


def recsys_small_phase():
    """The four small_recsys() configs: the card's forwards (kernel lookups)
    against the same forwards on the CPU (plain lookups) with the same
    parameters and inputs, f32 and bf16 tables, within rtol = atol = 1e-5
    (the f32 products summed in another order on each side)."""
    from repro_torch.configs import recsys_archs as ra
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.models import recsys as rec

    forwards = {"dlrm-mlperf": rec.dlrm_forward, "xdeepfm": rec.xdeepfm_forward,
                "din": rec.din_forward, "autoint": rec.autoint_forward}
    worst = 0.0
    before = ops.launches
    for arch, cfg in ra.small_recsys().items():
        for dtype in (torch.float32, torch.bfloat16):
            params = rec.init_params(cfg, torch.Generator().manual_seed(5), "cpu", dtype)
            g = torch.Generator(device="cuda").manual_seed(6)
            args = [a.cpu() for a in recsys_inputs(arch, cfg, 64, g)]
            out = {dev: forwards[arch](cfg, {k: v.to(dev) for k, v in params.items()},
                                       *(a.to(dev) for a in args)).cpu()
                   for dev in ("cuda", "cpu")}
            if not torch.allclose(out["cuda"], out["cpu"], rtol=1e-5, atol=1e-5):
                raise AssertionError(f"small {arch} {dtype}: card and CPU differ by "
                                     f"{float((out['cuda'] - out['cpu']).abs().max())}")
            worst = max(worst, float((out["cuda"] - out["cpu"]).abs().max()))
    log(f"[recsys-small] 4 archs × f32/bf16 tables: card == CPU within 1e-5 (max |card − CPU| "
        f"{worst:.3g}); {ops.launches - before} kernel lookups on the card")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False   # Eq. 5 product stays f32
    card = card_line()
    log(f"[setup] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build_logs = kernels.build()
    log(f"[setup] built {sorted(build_logs)} in {time.perf_counter() - t0:.2f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[setup] {name}: {line.strip()}")

    kernel = kernel_phase()
    alias_build, mh_small_err = alias_kernel_phase()
    bag_small_err = bag_kernel_phase()
    corpus = full_corpus()
    launches = full_width_phase(corpus)
    alias_launches, mh = alias_phase(corpus)
    mh["max_abs_err"] = max(mh["max_abs_err"], mh_small_err)
    small_phase()
    alias_small_phase()
    gc.collect()                       # the LDA phases' tensors go before the 48 GB table
    torch.cuda.empty_cache()
    bag_launches, bag_full_err, bag = recsys_phase()
    recsys_small_phase()

    log(json.dumps({"kernels": [
        dict(name="gibbs_argmax", route="cuda", source="src/repro_torch/csrc/gibbs_argmax.cu",
             replaces="src/repro/kernels/gibbs/kernel.py:92", launches=launches,
             max_abs_err=kernel["max_abs_err"], ms=kernel["ms"], plain_ms=kernel["plain_ms"],
             bound_ms=kernel["bound_ms"], bound_by=kernel["bound_by"], library_ms=None),
        dict(name="alias_build", route="cuda", source="src/repro_torch/csrc/alias_build.cu",
             replaces="src/repro/kernels/alias/kernel.py:125",
             launches=alias_launches["alias_build"], library_ms=None, **alias_build),
        dict(name="mh_resample", route="cuda", source="src/repro_torch/csrc/mh_resample.cu",
             replaces="src/repro/kernels/alias/kernel.py:249",
             launches=alias_launches["mh_resample"], library_ms=None, **mh),
        dict(name="embedding_bag", route="cuda", source="src/repro_torch/csrc/embedding_bag.cu",
             replaces="src/repro/kernels/embedding_bag/kernel.py:81", launches=bag_launches,
             max_abs_err=max(bag_small_err, bag_full_err), **bag["lookup"])]}))
    log(f"card: {card_line()}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
