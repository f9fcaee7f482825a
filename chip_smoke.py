#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (Hopper, sm_90a) and ``nvcc``. It builds every kernel of
the port from ``src/repro_torch/csrc``, holds each against its plain PyTorch
version on the card, then drives the peacock-lda main path once at full
width — K = 100,000 topics, V = 32,768 words (cut from 210,000 so that Φ and
P̂ fit one 80 GB card whole), a 4,096-query segment shard — through train
(3 Gibbs epochs) → α re-estimation → RT-LDA export → 4 served batches of
1,024 queries, and checks the result. A small phase at quickstart scale runs
the O(K²V) de-duplication and holds the card's whole loop against the same
loop on the CPU.

Prints a ``kernels`` JSON line, the card's name and power limit, and as its
last line ``{"ok": true, "device": {...}}``. Exits nonzero on any failure,
and when there is no CUDA card.
"""
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

FULL = dict(n_topics=100_000, vocab=32_768, n_docs=4096, gen_topics=1024,
            block=8192, epochs=3, batches=4, batch=1024, bucket=8)
SMALL = dict(n_topics=16, vocab=400, n_docs=1500, gen_topics=12, epochs=25)


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
    device's busy share of that window. Auxiliary: a profiler that cannot
    trace the card is reported and ``fn`` runs untraced; a failure of ``fn``
    itself is fatal."""
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
        return
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


def full_width_phase():
    from repro_torch.core import dedup, gibbs, lda, rtlda
    from repro_torch.core.features import make_serving_fn
    from repro_torch.data import corpus as corpus_mod, synthetic
    from repro_torch.kernels.gibbs import ops

    K, V, D = FULL["n_topics"], FULL["vocab"], FULL["n_docs"]
    t0 = time.perf_counter()
    corpus, _ = synthetic.lda_corpus(seed=0, n_docs=D, n_topics=FULL["gen_topics"],
                                     vocab_size=V, query_like=True)
    wi, di = corpus_mod.pad_corpus(corpus.word_ids, corpus.doc_ids, FULL["block"])
    log(f"[full] corpus: {corpus.n_docs} docs, {corpus.n_tokens} tokens, padded to "
        f"{len(wi)} ({time.perf_counter() - t0:.1f} s on the host)")
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
    launches = full_width_phase()
    small_phase()

    log(json.dumps({"kernels": [dict(
        name="gibbs_argmax", route="cuda", source="src/repro_torch/csrc/gibbs_argmax.cu",
        replaces="src/repro/kernels/gibbs/kernel.py:92", launches=launches,
        max_abs_err=kernel["max_abs_err"], ms=kernel["ms"], plain_ms=kernel["plain_ms"],
        bound_ms=kernel["bound_ms"], bound_by=kernel["bound_by"], library_ms=None)]}))
    log(f"card: {card_line()}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
